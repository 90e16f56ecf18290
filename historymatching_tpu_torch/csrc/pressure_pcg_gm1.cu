// Kernel P-gm1: kernel P (pressure_pcg.cu) for any grid with a hierarchy,
// one thread block a member, its arrays split by a plan between the block's
// shared memory and a device workspace, and the coarsest inverse streamed
// through a ring of bulk asynchronous copies. It takes the grids P-gm
// (pressure_pcg_gm.cu) has no plan for and the batches past P-gm's and
// P-cl/d's limits.
//
// Replaces: historymatching_tpu/ops/pressure_pallas.py,
//   pressure_solve_pallas (pressure_pcg_kernel), and its multi-member
//   layouts _batched and _packed, at the grids where the TPU kernel keeps
//   its hierarchy in VMEM with vmem_limit_bytes raised (pressure_pallas.py
//   :163-166), no cluster of P-cl holds the layout and P-gm's bands do not
//   fit (ops/pressure.py `gm_plan` None: e.g. 32x1088, whose band of 8 rows
//   of 1,088 cells exceeds one block's shared memory), or the batch is past
//   `route`'s limits; anywhere with force="gm1".
//
// It computes what P computes: the restarted MG-preconditioned CG of
// ops/cg.py `pcg` on the Jacobi-scaled (UNIT) or unscaled TPFA system, with
// the V-cycle of ops/multigrid.py `vcycle_apply` (nu = 2 damped-Jacobi
// sweeps of omega 0.7, or the degree-2 Chebyshev smoother; 2x2 block-sum
// restriction; prolongation by injection times omega_c = 1.4; a dense
// coarsest solve), the 100x blow-up guard, the patience stop and the best
// iterate. Each sweep does P's float32 operations in P's order; the block
// reductions and the coarse product sum in another order, so the two agree
// to rounding (ops/pressure.py holds both to the plain version).
//
// One thread block a member. The grid is a run-time argument (the kernel's
// parameters, read in place as a __grid_constant__), so one library serves
// every grid. The plan (ops/pressure.py `gm1_plan`, passed as a table)
// places a member's arrays by reads a V-cycle per byte: the coarsest
// level's right-hand side and correction, then the coarser levels' whole
// sets, coarsest first, then the fine faces TX and TY, then the fine
// diagonal and its reciprocal on the unscaled system, each in the block's
// dynamic shared memory while it fits beside the ring; the rest (the fine
// vectors, the CG vectors x, p, z and A p, and what did not fit) in a
// device workspace that the wrapper allocates. An array's offset in the
// table says where: >= 0 a float of the workspace, < 0 the float -1 - o of
// shared memory. A plan takes at most ~160 KB, so that the SM keeps ~92 KB
// of L1 for the passes over the levels in the workspace, whose gathers
// read each cell's neighbours. Threads walk a level's 2x2 tiles in
// grid-stride loops; a thread owns the same tiles in every pass, so a pass
// that reads only its own cells needs no barrier, and the barriers are P's.
//
// The coarsest inverse (row-major, as the plain version multiplies by it)
// is the largest read of a V-cycle: 1.56 MB a member at 100x100, 2.72 MB at
// 60x220 and 120x440. It streams through a ring of `stages` slots in shared
// memory, few and large (two of ~50 KB: each stage's copy and barriers
// cost more than its bytes): one thread copies a stage with one
// cp.async.bulk that completes
// on the slot's "full" mbarrier; every warp arrives on the slot's "empty"
// mbarrier once it has read the slot, and the slot is refilled at once with
// the stage one ring further on, which is the next V-cycle's (the inverse
// is the same in every V-cycle). So the ring is full when a V-cycle's
// coarse solve starts, and the stream overlaps the up-sweep, the CG vector
// passes and the next down-sweep. A member's inverse starts on a 16-byte
// boundary only where its index is a multiple of 4 (625^2 and 825^2 are 1
// more than a multiple of 4): its stream starts at the 16-byte boundary at
// or below it, the bulk copies take the aligned middle, and at most three
// floats at each end, read once by plain loads and kept in shared memory,
// are written into their stage by the copying thread; nothing is read
// outside the member's inverse. The product keeps P-gm1's order of summation: a
// row a warp, each lane its columns lane, lane + 32, ... in order, then
// `warp_sum`; a row cut by a stage boundary carries its partial sums to
// the next stage.
//
// What bounds it on the H100: device memory. Each V-cycle reads a member's
// whole inverse once (132 members in flight overflow the 50 MB L2), and
// the fine vectors in the workspace are streamed by every pass. The copying
// thread refills the slot its warps left before it starts the next
// stage's product, so a copy waits for no product.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "pcg_tile.cuh"

namespace {

// Threads a block at most; the ring's fewest and most stages; shared memory
// a block may opt into (ops/pressure.py GM1_MAX_THREADS, GM1_MIN_STAGES,
// GM1_MAX_STAGES, _build.SMEM_LIMIT).
constexpr int kMaxThreads = 512;
constexpr int kMinStages = 2, kMaxStages = 4;
constexpr int kSmemLimit = 232448;

// A level: its sides and the offsets of its arrays, in the order of
// ops/pressure.py LEVEL_KEYS (>= 0 in the workspace, < 0 in shared memory).
struct Level {
  int n, m, tx, ty, d, rd, b, x, t;
};

struct Args {
  int L;                       // levels; L - 1 is the coarsest
  int floats;                  // a member's workspace
  int smem, threads;           // dynamic shared bytes and threads a block
  int stages, stage;           // the ring's slots and floats a slot
  int ring, bars, red, ends;   // shared floats: the ring, its 2 x kMaxStages
                               // barriers, the reduction slots, the inverse's ends
  int xv, pv, zv, apv;         // the CG vectors x, p, z, A p
  Level lv[kMaxLevels];
  const float* tx[kMaxLevels];  // the member-major inputs, per level
  const float* ty[kMaxLevels];
  const float* d[kMaxLevels];
  const float* ainv;  // (B, nc, nc)
};

__device__ __forceinline__ float* at(float* ws, float* sh, int o) {
  return o >= 0 ? ws + o : sh + (-1 - o);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void wait_bar(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void own(const float* v, int m, int I, int J, float out[4]) {
  const int o = 2 * I * m + 2 * J;
  const float2 a = ld2(v + o), b = ld2(v + o + m);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

__device__ __forceinline__ void put(float* v, int m, int I, int J, const float x[4]) {
  const int o = 2 * I * m + 2 * J;
  *reinterpret_cast<float2*>(v + o) = make_float2(x[0], x[1]);
  *reinterpret_cast<float2*>(v + o + m) = make_float2(x[2], x[3]);
}

__device__ __forceinline__ Tile gather(const float* v, int n, int m, int I, int J) {
  const int o = 2 * I * m + 2 * J;
  Tile t;
  own(v, m, I, J, t.v);
  const float2 z2 = make_float2(0.0f, 0.0f);
  const float2 u = I > 0 ? ld2(v + o - m) : z2;
  const float2 d = I < n / 2 - 1 ? ld2(v + o + 2 * m) : z2;
  t.v[U0] = u.x;
  t.v[U1] = u.y;
  t.v[D0] = d.x;
  t.v[D1] = d.y;
  t.v[L0] = J > 0 ? v[o - 1] : 0.0f;
  t.v[L1] = J > 0 ? v[o + m - 1] : 0.0f;
  t.v[R0] = J < m / 2 - 1 ? v[o + 2] : 0.0f;
  t.v[R1] = J < m / 2 - 1 ? v[o + m + 2] : 0.0f;
  return t;
}

// (A v) on the tile's four cells in P's term order (pressure_pcg.cu
// `stencil`); D is read unless the level is the unit fine level.
__device__ __forceinline__ void stencil(const float* TX, const float* TY, const float* D,
                                        bool unit, int n, int m, int I, int J, const Tile& t,
                                        float out[4]) {
  const int o = 2 * I * m + 2 * J;
  const float2 z2 = make_float2(0.0f, 0.0f);
  const float2 xu = I > 0 ? ld2(TX + o - m) : z2;
  const float2 xc = ld2(TX + o);
  const float2 xd = I < n / 2 - 1 ? ld2(TX + o + m) : z2;
  const float2 y0 = ld2(TY + o), y1 = ld2(TY + o + m);
  const float yl0 = J > 0 ? TY[o - 1] : 0.0f;
  const float yl1 = J > 0 ? TY[o + m - 1] : 0.0f;
  float d[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  if (!unit) own(D, m, I, J, d);
  tile_stencil(d, xu, xc, xd, y0, y1, yl0, yl1, t, out);
}

// f(I, J) for each tile of an n x m level that this thread owns: tiles
// tid, tid + T, ... row-major over the (n/2, m/2) tile grid.
template <class F>
__device__ __forceinline__ void tiles(int n, int m, F f) {
  const int TJ = m / 2, NT = (n / 2) * TJ;
  for (int T = threadIdx.x; T < NT; T += blockDim.x) {
    const int I = T / TJ;
    f(I, T - I * TJ);
  }
}

// The view of level l of one member's arrays.
template <bool CHEB, bool UNIT>
struct View {
  float* ws;
  float* sh;
  const Level* lv;
  int l;
  __device__ const Level& g() const { return lv[l]; }
  __device__ bool unit() const { return UNIT && l == 0; }
  __device__ float* TX() const { return at(ws, sh, g().tx); }
  __device__ float* TY() const { return at(ws, sh, g().ty); }
  __device__ float* D() const { return at(ws, sh, g().d); }
  __device__ float* RD() const { return at(ws, sh, g().rd); }
  __device__ float* B() const { return at(ws, sh, g().b); }
  __device__ float* X() const { return at(ws, sh, g().x); }
  __device__ float* T() const { return at(ws, sh, g().t); }
  __device__ void own_rd(int I, int J, float rd[4]) const {
    if (unit()) {
      rd[0] = rd[1] = rd[2] = rd[3] = 1.0f;
    } else {
      own(RD(), g().m, I, J, rd);
    }
  }
};

// A member's inverse as the ring streams it, once a V-cycle: stream float i
// is the inverse's float i - phase, from the 16-byte boundary at or below
// the inverse's start (`src`). The bulk copies take [he, be); the head [phase,
// he) and the tail [be, phase + n2), at most three floats each, are kept in
// shared memory (`ends`: head at 0, tail at 4). The stream, rounded up to
// whole 16-byte units, is cut into K stages of the plan's size.
struct Stream {
  const float* src;
  int phase, n2, he, be, K;
};

__device__ __forceinline__ Stream stream_of(const Args& a, int b) {
  const Level& c = a.lv[a.L - 1];
  Stream s;
  s.n2 = (c.n * c.m) * (c.n * c.m);
  const float* inv = a.ainv + (size_t)b * s.n2;
  s.phase = (int)((reinterpret_cast<size_t>(inv) >> 2) & 3);
  s.src = inv - s.phase;
  const int lead = (4 - s.phase) & 3;
  s.he = s.phase + (lead < s.n2 ? lead : s.n2);
  const int end = (s.phase + s.n2) & ~3;
  s.be = end > s.he ? end : s.he;
  s.K = (r4(s.phase + s.n2) + a.stage - 1) / a.stage;
  return s;
}

// The full and empty barriers of slot k (8 bytes each, full ones first).
__device__ __forceinline__ unsigned full_bar(const Args& a, float* sh, int k) {
  return smem_addr(sh + a.bars) + 8u * (unsigned)k;
}
__device__ __forceinline__ unsigned empty_bar(const Args& a, float* sh, int k) {
  return smem_addr(sh + a.bars) + 8u * (unsigned)(kMaxStages + k);
}

// Stage `gg` of the endless stream (stage gg % K of a V-cycle) into slot gg
// % stages, by the copying thread: the stage's ends from `ends`, its
// aligned middle by one bulk copy completing on the slot's full barrier.
__device__ void fill(const Args& a, float* sh, const Stream& s, int gg) {
  const int slot = gg % a.stages, lo = (gg % s.K) * a.stage, hi = lo + a.stage;
  float* dst = sh + a.ring + slot * a.stage;
  const float* ends = sh + a.ends;
  bool plain = false;
  for (int i = s.phase; i < s.he; ++i) {
    if (i >= lo && i < hi) {
      dst[i - lo] = ends[i - s.phase];
      plain = true;
    }
  }
  for (int i = s.be; i < s.phase + s.n2; ++i) {
    if (i >= lo && i < hi) {
      dst[i - lo] = ends[4 + i - s.be];
      plain = true;
    }
  }
  // the plain floats before any later bulk copy into the slot
  if (plain) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  const int b0 = lo > s.he ? lo : s.he, b1 = hi < s.be ? hi : s.be;
  const unsigned bytes = b1 > b0 ? 4u * (unsigned)(b1 - b0) : 0u, bar = full_bar(a, sh, slot);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  if (bytes > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"(smem_addr(dst + (b0 - lo))),
        "l"(s.src + b0), "r"(bytes), "r"(bar)
        : "memory");
}

// The copying thread waits until every warp has read stage gg, then fills
// its slot with stage gg + stages.
__device__ __forceinline__ void refill(const Args& a, float* sh, const Stream& s, int gg) {
  wait_bar(empty_bar(a, sh, gg % a.stages), (unsigned)((gg / a.stages) & 1));
  fill(a, sh, s, gg + a.stages);
}

// Coarsest level: x = inverse @ b, a row a warp, the lanes along the row,
// stage by stage through the ring; `g` counts the stages read so far.
__device__ void coarse_solve(const Args& a, float* sh, int member, const float* b, float* x,
                             int nc, int& g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#ifdef HM_GM1_LOADS
  // The ring's control, built only to time the ring against it
  // (bench_routes.py --kernel gm1): the same product in the same order of
  // summation, its rows read by plain loads from device memory. The ring
  // is filled once at the start, never read, and drained at the end.
  const float* inv = a.ainv + (size_t)member * nc * nc;
  for (int r = warp; r < nc; r += warps) {
    float acc = 0.0f;
    for (int c = lane; c < nc; c += 32) acc += inv[(size_t)r * nc + c] * b[c];
    const float v = warp_sum(acc);
    if (lane == 0) x[r] = v;
  }
  return;
#endif
  const Stream s = stream_of(a, member);
  float acc = 0.0f;
  for (int k = 0; k < s.K; ++k) {
    const int gg = g + k, slot = gg % a.stages;
    wait_bar(full_bar(a, sh, slot), (unsigned)((gg / a.stages) & 1));
    // the previous stage's slot refilled before this stage's product, so
    // the copy does not wait for it
    if (threadIdx.x == 0 && k > 0) refill(a, sh, s, gg - 1);
    const float* st = sh + a.ring + slot * a.stage;
    const int base = k * a.stage - s.phase;  // the inverse's float at the stage's first
    const int p0 = base > 0 ? base : 0, p1 = base + a.stage < s.n2 ? base + a.stage : s.n2;
    if (p0 < p1) {
      const int r0 = p0 / nc, r1 = (p1 - 1) / nc;
      for (int r = r0 + (warp - r0 % warps + warps) % warps; r <= r1; r += warps) {
        const int c0 = p0 - r * nc > 0 ? p0 - r * nc : 0;
        const int c1 = p1 - r * nc < nc ? p1 - r * nc : nc;
        if (c0 == 0) acc = 0.0f;  // a row starts; else the row cut by the stage's start
        const float* row = st + (r * nc - base);
#pragma unroll 4
        for (int c = c0 + ((lane - c0) & 31); c < c1; c += 32) acc += row[c] * b[c];
        if (c1 == nc) {
          const float v = warp_sum(acc);
          if (lane == 0) x[r] = v;
        }
      }
    }
    __syncwarp();
    if (lane == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(empty_bar(a, sh, slot))
                   : "memory");
  }
  if (threadIdx.x == 0) refill(a, sh, s, g + s.K - 1);
  g += s.K;
}

// Pre-smoothing from x = 0, the first sweep folded into the second one's
// reads (pressure_pcg.cu `smooth_down`).
template <bool CHEB, bool UNIT>
__device__ void smooth_down(const View<CHEB, UNIT>& V) {
  const int n = V.g().n, m = V.g().m;
  tiles(n, m, [&](int I, int J) {
    const Tile b = gather(V.B(), n, m, I, J);
    Tile t;
    if (V.unit()) {
      t = first_sweep<CHEB, true>(b, b);
    } else {
      t = first_sweep<CHEB, false>(b, gather(V.RD(), n, m, I, J));
    }
    float At[4], rd[4], x[4];
    stencil(V.TX(), V.TY(), V.D(), V.unit(), n, m, I, J, t, At);
    V.own_rd(I, J, rd);
    second_sweep_down<CHEB>(t, b, At, rd, x);
    put(V.X(), m, I, J, x);
  });
}

// Residual b - A x of a level, restricted by 2x2 block sums into the
// next level's right-hand side Bc.
template <bool CHEB, bool UNIT>
__device__ void restrict_residual(const View<CHEB, UNIT>& V, float* Bc) {
  const int n = V.g().n, m = V.g().m;
  tiles(n, m, [&](int I, int J) {
    const Tile x = gather(V.X(), n, m, I, J);
    float Ax[4], b[4];
    stencil(V.TX(), V.TY(), V.D(), V.unit(), n, m, I, J, x, Ax);
    own(V.B(), m, I, J, b);
    Bc[I * (m / 2) + J] = restrict_tile(b, Ax);
  });
}

// First post-smoothing sweep after the coarse correction E (the next
// level's iterate): prolongation folded into the reads, the result to the
// level's temporary (pressure_pcg.cu `smooth_up_first`).
template <bool CHEB, bool UNIT>
__device__ void smooth_up_first(const View<CHEB, UNIT>& V, const float* E) {
  const int n = V.g().n, m = V.g().m, mc = m / 2;
  tiles(n, m, [&](int I, int J) {
    Tile x = gather(V.X(), n, m, I, J);
    prolong(x, [&](int dI, int dJ) { return E[(I + dI) * mc + J + dJ]; }, I > 0,
            I < n / 2 - 1, J > 0, J < mc - 1);
    float Ax[4], b[4], rd[4], t[4];
    stencil(V.TX(), V.TY(), V.D(), V.unit(), n, m, I, J, x, Ax);
    own(V.B(), m, I, J, b);
    V.own_rd(I, J, rd);
    first_sweep_up<CHEB>(x, b, Ax, rd, t);
    put(V.T(), m, I, J, t);
  });
}

// Second post-smoothing sweep, into `out` (the level's iterate, or z on
// the fine level); the Chebyshev step forms its start x + omega_c e again
// on the thread's own cells (pressure_pcg.cu `smooth_up_second`).
template <bool CHEB, bool UNIT>
__device__ void smooth_up_second(const View<CHEB, UNIT>& V, const float* E, float* out) {
  const int n = V.g().n, m = V.g().m;
  tiles(n, m, [&](int I, int J) {
    const Tile t = gather(V.T(), n, m, I, J);
    float At[4], b[4], rd[4], x[4];
    stencil(V.TX(), V.TY(), V.D(), V.unit(), n, m, I, J, t, At);
    own(V.B(), m, I, J, b);
    V.own_rd(I, J, rd);
    float x0[4], e = 0.0f;
    if (CHEB) {
      own(V.X(), m, I, J, x0);
      e = E[I * (m / 2) + J];
    }
    second_sweep_up<CHEB>(t, b, At, rd, x0, e, x);
    put(out, m, I, J, x);
  });
}

// z = V-cycle(r) from a zero initial guess; r is the fine B (R) vector, z
// goes to `z`. Clobbers the levels' X and T vectors; `g` is the ring's
// count of stages read.
template <bool CHEB, bool UNIT>
__device__ void vcycle(float* ws, float* sh, const Args& a, int member, float* z, int& g) {
  const int LC = a.L - 1;
  for (int l = 0; l < LC; ++l) {
    const View<CHEB, UNIT> V{ws, sh, a.lv, l};
    smooth_down(V);
    __syncthreads();
    restrict_residual(V, at(ws, sh, a.lv[l + 1].b));
    __syncthreads();
  }
  const Level& c = a.lv[LC];
  coarse_solve(a, sh, member, at(ws, sh, c.b), at(ws, sh, c.x), c.n * c.m, g);
  __syncthreads();
  for (int l = LC - 1; l >= 0; --l) {
    const View<CHEB, UNIT> V{ws, sh, a.lv, l};
    const float* E = at(ws, sh, a.lv[l + 1].x);
    smooth_up_first(V, E);
    __syncthreads();
    smooth_up_second(V, E, l == 0 ? z : V.X());
    if (l > 0) __syncthreads();
  }
}

// Block sums of two values with one barrier, alternating two slots
// (pressure_pcg.cu `Reducer`).
struct Reducer {
  float2* buf;
  int slot;
  __device__ __forceinline__ float2 sum(float a, float b) {
    a = warp_sum(a);
    b = warp_sum(b);
    const int warps = blockDim.x >> 5;
    float2* s = buf + slot * (kMaxThreads / 32);
    slot ^= 1;
    if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = make_float2(a, b);
    __syncthreads();
    float2 t = s[0];
    for (int k = 1; k < warps; ++k) {
      const float2 u = s[k];
      t.x += u.x;
      t.y += u.y;
    }
    return t;
  }
};

// Member b's hierarchy into its places: TY padded to m wide, the diagonals
// with their reciprocals (not on the unit fine level).
template <bool UNIT>
__device__ void load_levels(float* ws, float* sh, const Args& a, int b) {
  for (int l = 0; l < a.L - 1; ++l) {
    const Level& g = a.lv[l];
    const int n = g.n, m = g.m;
    const float* tx = a.tx[l] + (size_t)b * (n - 1) * m;
    float* TX = at(ws, sh, g.tx);
    for (int k = threadIdx.x; k < (n - 1) * m; k += blockDim.x) TX[k] = tx[k];
    const float* ty = a.ty[l] + (size_t)b * n * (m - 1);
    float* TY = at(ws, sh, g.ty);
    for (int k = threadIdx.x; k < n * m; k += blockDim.x) {
      const int i = k / m, j = k - i * m;
      TY[k] = j < m - 1 ? ty[i * (m - 1) + j] : 0.0f;
    }
    if (l > 0 || !UNIT) {
      const float* d = a.d[l] + (size_t)b * n * m;
      float* D = at(ws, sh, g.d);
      float* RD = at(ws, sh, g.rd);
      for (int k = threadIdx.x; k < n * m; k += blockDim.x) {
        const float v = d[k];
        D[k] = v;
        RD[k] = 1.0f / v;
      }
    }
  }
}

template <bool CHEB, bool UNIT>
__global__ void __launch_bounds__(kMaxThreads)
pressure_pcg_gm1_kernel(const __grid_constant__ Args a, const float* __restrict__ q_g,
                       const float* __restrict__ p0_g, const float* __restrict__ w_g,
                       float* __restrict__ p_out, int* __restrict__ it_out,
                       float* __restrict__ rel_out, float* ws_g, float tol, int maxiter,
                       int restart_every, int patience) {
  extern __shared__ float4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  const Level& F = a.lv[0];
  const int NX = F.n, NY = F.m, b = blockIdx.x;
  const size_t off = (size_t)b * NX * NY;
  float* ws = ws_g + (size_t)b * a.floats;

  // The ring's barriers, then its first stages: they arrive while the
  // hierarchy loads and the first residual runs.
  if (threadIdx.x == 0) {
    for (int k = 0; k < a.stages; ++k) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(full_bar(a, sh, k))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(empty_bar(a, sh, k)),
                   "r"(blockDim.x >> 5)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const Stream s = stream_of(a, b);
    float* ends = sh + a.ends;
    for (int i = s.phase; i < s.he; ++i) ends[i - s.phase] = s.src[i];
    for (int i = s.be; i < s.phase + s.n2; ++i) ends[4 + i - s.be] = s.src[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const Stream s = stream_of(a, b);
    for (int k = 0; k < a.stages; ++k) fill(a, sh, s, k);
  }
  int g = 0;  // the ring's stages read

  const float* q = q_g + off;
  const float* w = w_g + off;
  float* xb = p_out + off;           // the best iterate lives here
  // the fine vectors and the CG vectors are always in the workspace
  float* P = ws + F.x;  // p for the matvec's gathers; the V-cycle's fine iterate
  float* R = ws + F.b;
  float* Tv = ws + F.t;
  float* X = ws + a.xv;
  float* Pv = ws + a.pv;
  float* Z = ws + a.zv;
  float* AP = ws + a.apv;
  const float* TX = at(ws, sh, F.tx);
  const float* TY = at(ws, sh, F.ty);
  const float* Df = at(ws, sh, F.d);
  Reducer red{reinterpret_cast<float2*>(sh + a.red), 0};
  auto fine = [&](auto f) { tiles(NX, NY, f); };

  load_levels<UNIT>(ws, sh, a, b);
  fine([&](int I, int J) {
    float x[4];
    own(p0_g + off, NY, I, J, x);
    put(X, NY, I, J, x);
    put(xb, NY, I, J, x);
    put(Tv, NY, I, J, x);
  });
  __syncthreads();

  // r = q - A x from x in T, into R; adds the thread's (w r)^2 to wr2 and
  // (w q)^2 to wq2.
  auto residual = [&](float& wr2, float& wq2) {
    fine([&](int I, int J) {
      const Tile xt = gather(Tv, NX, NY, I, J);
      float Ax[4], qv[4], wv[4], r[4];
      stencil(TX, TY, Df, UNIT, NX, NY, I, J, xt, Ax);
      own(q, NY, I, J, qv);
      own(w, NY, I, J, wv);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        r[c] = qv[c] - Ax[c];
        const float wr = wv[c] * r[c], wq = wv[c] * qv[c];
        wr2 += wr * wr;
        wq2 += wq * wq;
      }
      put(R, NY, I, J, r);
    });
  };

  float wr2 = 0.0f, wq2 = 0.0f;
  residual(wr2, wq2);
  const float2 s0 = red.sum(wq2, wr2);
  const float bb = s0.x;
  float rr_best = s0.y;
  const float tol2 = (tol * tol) * fmaxf(bb, FLT_MIN);

  bool use_sd = false, r_valid = true, first = true;
  int n_bad = 0, kk = 0;
  while (kk < maxiter && rr_best > tol2 && n_bad < patience) {
    if (!r_valid) {  // after a blow-up x was reset to the best iterate
      fine([&](int I, int J) {
        float x[4];
        own(X, NY, I, J, x);
        put(Tv, NY, I, J, x);
      });
      __syncthreads();
      float unused = 0.0f;
      residual(unused, unused);
      __syncthreads();
    }
    vcycle<CHEB, UNIT>(ws, sh, a, b, Z, g);
    // The first window's direction is Minv(r0), which is this z; a
    // steepest-descent window restarts from z too.
    const bool restart = use_sd || first;
    float prz = 0.0f, prr = 0.0f;
    fine([&](int I, int J) {
      float r[4], z[4], wv[4], p[4];
      own(R, NY, I, J, r);
      own(Z, NY, I, J, z);
      own(w, NY, I, J, wv);
      own(Pv, NY, I, J, p);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        prz += r[c] * z[c];
        const float wr = wv[c] * r[c];
        prr += wr * wr;
        if (restart) p[c] = z[c];
      }
      if (restart) put(Pv, NY, I, J, p);
      put(P, NY, I, J, p);
    });
    float2 s = red.sum(prz, prr);
    float rz = s.x, rr = s.y;
    const float beta_mask = use_sd ? 0.0f : 1.0f;
    // Once a member's rr <= tol2 the window's remaining steps are no-ops
    // (alpha = 0, state kept), so they are skipped.
    for (int it = 0; it < restart_every && rr > tol2; ++it) {
      float ppap = 0.0f;
      fine([&](int I, int J) {
        const Tile pt = gather(P, NX, NY, I, J);
        float Ap[4], p[4];
        stencil(TX, TY, Df, UNIT, NX, NY, I, J, pt, Ap);
        own(Pv, NY, I, J, p);
#pragma unroll
        for (int c = 0; c < 4; ++c) ppap += p[c] * Ap[c];
        put(AP, NY, I, J, Ap);
      });
      const float pAp = red.sum(ppap, 0.0f).x;
      const float alpha = rz / (pAp == 0.0f ? 1.0f : pAp);
      fine([&](int I, int J) {
        float r[4], x[4], p[4], Ap[4];
        own(R, NY, I, J, r);
        own(X, NY, I, J, x);
        own(Pv, NY, I, J, p);
        own(AP, NY, I, J, Ap);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          x[c] = x[c] + alpha * p[c];
          r[c] = r[c] - alpha * Ap[c];
        }
        put(X, NY, I, J, x);
        put(R, NY, I, J, r);
      });
      __syncthreads();
      vcycle<CHEB, UNIT>(ws, sh, a, b, Z, g);
      prz = prr = 0.0f;
      fine([&](int I, int J) {
        float r[4], z[4], wv[4];
        own(R, NY, I, J, r);
        own(Z, NY, I, J, z);
        own(w, NY, I, J, wv);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          prz += r[c] * z[c];
          const float wr = wv[c] * r[c];
          prr += wr * wr;
        }
      });
      s = red.sum(prz, prr);
      const float beta = beta_mask * s.x / (rz == 0.0f ? 1.0f : rz);
      fine([&](int I, int J) {
        float z[4], p[4];
        own(Z, NY, I, J, z);
        own(Pv, NY, I, J, p);
#pragma unroll
        for (int c = 0; c < 4; ++c) p[c] = z[c] + beta * p[c];
        put(Pv, NY, I, J, p);
        put(P, NY, I, J, p);
      });
      rz = s.x;
      rr = s.y;
      __syncthreads();
    }
    // True residual of the window's iterate (residual replacement).
    fine([&](int I, int J) {
      float x[4];
      own(X, NY, I, J, x);
      put(Tv, NY, I, J, x);
    });
    __syncthreads();
    float wr2n = 0.0f, unused = 0.0f;
    residual(wr2n, unused);
    const float rr_new = red.sum(wr2n, 0.0f).x;
    const bool finite = isfinite(rr_new);
    const bool blown = !finite || rr_new > 100.0f * fmaxf(rr_best, tol2);
    const bool better = finite && rr_new < rr_best;
    if (better || blown) {
      fine([&](int I, int J) {
        float x[4];
        if (better) {
          own(X, NY, I, J, x);
          put(xb, NY, I, J, x);
        } else {
          own(xb, NY, I, J, x);
          put(X, NY, I, J, x);
        }
      });
    }
    if (better) rr_best = rr_new;
    n_bad = better ? 0 : n_bad + 1;
    use_sd = blown;
    r_valid = !blown;
    first = false;
    kk += restart_every;
  }
  if (threadIdx.x == 0) {
    it_out[b] = kk;
    rel_out[b] = sqrtf(rr_best / fmaxf(bb, FLT_MIN));
    // The copies still in flight, one a slot, land before the block's
    // shared memory is released.
    for (int gg = g; gg < g + a.stages; ++gg)
      wait_bar(full_bar(a, sh, gg % a.stages), (unsigned)((gg / a.stages) & 1));
  }
}

template <bool CHEB, bool UNIT>
int launch(const Args& a, const float* q, const float* p0, const float* w, float* p_out,
           int* it_out, float* rel_out, float* ws, int B, float tol, int maxiter,
           int restart_every, int patience, cudaStream_t stream) {
  auto kern = pressure_pcg_gm1_kernel<CHEB, UNIT>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<B, a.threads, a.smem, stream>>>(a, q, p0, w, p_out, it_out, rel_out, ws, tol, maxiter,
                                         restart_every, patience);
  return (int)cudaGetLastError();
}

template <bool CHEB, bool UNIT>
int info(int threads, int smem, int* out) {
  auto kern = pressure_pcg_gm1_kernel<CHEB, UNIT>;
  cudaFuncAttributes attr{};
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes + smem;
  out[3] = threads;
  out[4] = blocks;
  return (int)e;
}

}  // namespace

// lv: 3 * levels pointers, per level TX (B, n-1, m), TY (B, n, m-1), diag
// (B, n, m), float32; the level-0 diag is read only where unit is 0. ainv
// (B, nc, nc); q, p0, w, p_out (B, Nx, Ny); ws the workspace, B times the
// plan's floats. table (host memory, ops/pressure.py `gm1_table`): levels,
// floats a member, dynamic shared bytes, threads, the ring's stages and
// floats a stage, the shared offsets of the ring, its barriers, the
// reduction slots and the inverse's ends, the offsets of x, p, z and A p,
// then per level n, m and the offsets of TX, TY, D, 1/D, B, X and T. cheb:
// 0 for the damped-Jacobi smoother, 1 for the Chebyshev one.
extern "C" int hm_pressure_gm1_solve(const float* const* lv, const float* ainv, const float* q,
                                    const float* p0, const float* w, float* p_out, int* it_out,
                                    float* rel_out, float* ws, const int* table, int B,
                                    float tol, int maxiter, int restart_every, int patience,
                                    int cheb, int unit, void* stream) {
  Args a{};
  a.L = table[0];
  if (a.L < 2 || a.L > kMaxLevels || (!unit && lv[2] == nullptr)) return (int)cudaErrorInvalidValue;
  a.floats = table[1];
  a.smem = table[2];
  a.threads = table[3];
  a.stages = table[4];
  a.stage = table[5];
  a.ring = table[6];
  a.bars = table[7];
  a.red = table[8];
  a.ends = table[9];
  a.xv = table[10];
  a.pv = table[11];
  a.zv = table[12];
  a.apv = table[13];
  for (int l = 0; l < a.L; ++l) {
    const int* t = table + 14 + 9 * l;
    a.lv[l] = Level{t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], t[8]};
    a.tx[l] = lv[3 * l];
    a.ty[l] = lv[3 * l + 1];
    a.d[l] = lv[3 * l + 2];
  }
  a.ainv = ainv;
  if (a.lv[0].n % 2 || a.lv[0].m % 2 || a.lv[0].x < 0 || a.lv[0].b < 0 || a.lv[0].t < 0 ||
      a.xv < 0 || a.pv < 0 || a.zv < 0 || a.apv < 0 || a.threads < 32 || a.threads > kMaxThreads ||
      a.threads % 32 || a.smem > kSmemLimit || a.stages < kMinStages || a.stages > kMaxStages ||
      a.stage <= 0 || a.stage % 4 || a.ring % 4 || a.bars % 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define HM_GM(c, u) \
  launch<c, u>(a, q, p0, w, p_out, it_out, rel_out, ws, B, tol, maxiter, restart_every, patience, s)
  if (cheb) return unit ? HM_GM(true, true) : HM_GM(true, false);
  return unit ? HM_GM(false, true) : HM_GM(false, false);
#undef HM_GM
}

// out: registers a thread, local (stack and spill) bytes a thread, shared
// bytes a block (static and the plan's dynamic `smem`), threads a block,
// resident blocks an SM, of the instantiation for the smoother (cheb 0 or
// 1) and fine diagonal (unit) at the plan's `threads` and `smem`.
extern "C" int hm_pressure_gm1_info(int threads, int smem, int cheb, int unit, int* out) {
  if (cheb)
    return unit ? info<true, true>(threads, smem, out) : info<true, false>(threads, smem, out);
  return unit ? info<false, true>(threads, smem, out) : info<false, false>(threads, smem, out);
}
