// Kernel P-gm: kernel P (pressure_pcg.cu) on a member spread over G
// co-resident thread blocks, each holding a band of rows of every level but
// the coarsest and a block of the coarsest inverse's rows in its shared
// memory; band edges, the coarse right-hand side and correction, and the
// reductions go through L2.
//
// Replaces: historymatching_tpu/ops/pressure_pallas.py,
//   pressure_solve_pallas (pressure_pcg_kernel), and its multi-member
//   layouts _batched and _packed, at the grids where the TPU kernel keeps
//   its hierarchy in VMEM with vmem_limit_bytes raised (pressure_pallas.py
//   :163-166) and no cluster of P-cl holds the layout (120x440), or the
//   batch is past the grid's DIST_BATCH_MAX (the scaled 100x100): the
//   route of ops/pressure.py. P-gm1 (pressure_pcg_gm1.cu, one block a
//   member, its arrays in device memory) keeps the grids `gm_plan` cuts no
//   band for.
//
// It computes what P computes: the restarted MG-preconditioned CG of
// ops/cg.py `pcg` on the Jacobi-scaled (UNIT) or unscaled TPFA system, with
// the V-cycle of ops/multigrid.py `vcycle_apply` (damped Jacobi or the
// degree-2 Chebyshev smoother, 2x2 block-sum restriction, prolongation by
// injection times omega_c, a dense coarsest solve), the 100x blow-up guard,
// the patience stop and the best iterate; each sweep does P's float32
// operations in P's order (pcg_tile.cuh). The block and member sums and the
// coarse product sum in another order, so it agrees with the plain version
// to rounding, as P-cl does.
//
// Partition (ops/pressure.py `gm_plan`, `gm_layout`). A member takes G
// blocks; every level but the coarsest is split in bands of rows, units of
// 2^LS fine rows (LS = L - 1, so a band stays even down to the last split
// level, whose 2x2 restriction lands on the coarsest level's rows), the
// first blocks a unit more (P-cl/d's `cl_bands`). Where the units are fewer
// than the blocks (120x440: 15 units of 8 rows), the blocks past them hold
// no band, only rows of the coarsest inverse: the banded blocks KB rows
// each, the others KN, so that every block fits 232,448 bytes (the band's
// arrays of every split level with a halo row above and below, P-cl's
// layout; the coarsest level's right-hand side and correction; the
// inverse's rows, loaded once a member by one bulk asynchronous copy on an
// mbarrier). Inside its band a block is a P-cl rank: 2x2 tiles a thread,
// x, p, z and the metric weight w in registers, the best iterate written to
// p_out, the coarse temporaries aliased into the fine one.
//
// Exchange through L2. Blocks are co-resident (a cooperative launch of
// groups x G blocks; block (g, r) runs band r of members g, g + groups,
// ...), and each (group, block) has a flag that counts the synchronisation
// points it has passed. A phase that writes a split level's array stores
// its band's first and last rows, as it writes them, into the block's slot
// for that point (two slots, by the count's parity), then the block
// publishes the count with st.release.gpu; its neighbours poll the flag
// with ld.acquire.gpu (a wait of 2^26 polls traps: a fault fails the
// launch instead of hanging the card) and copy the rows into their halo.
// Only neighbours wait on each other there. A slot is rewritten two points
// later, after both neighbours have published the point in between, by
// which time they have copied it. Member-wide points are the reductions
// and the coarse solve: each block stores its total (its warps' partials
// in warp order) in a slot of its own, publishes, waits for every flag of
// the group, and sums the G totals in block order, so every block holds
// bit-identical p.Ap, r.z and residual norms and takes every loop test
// (rr > tol2, patience, `better`, `blown`) the same way (a block that
// diverged would never publish the point its neighbours wait for). The
// halo rows a reduction's phase writes ride on its publication. The last
// split level's restriction stores the coarse right-hand side to L2; after
// a member-wide point every block copies it, multiplies its rows of the
// inverse, and stores its part of the correction; after a second one each
// banded block copies the coarse rows its prolongation reads. Every block
// passes every point, so the counts agree; the blocks without a band wait
// for no neighbour.
//
// What bounds it on the H100: the latency of the points, as P-cl's cluster
// barriers bound it, now an L2 round trip each (about 12 neighbour points
// and 4 member-wide ones an iteration). Device memory sees one read of the
// hierarchy, the inverse, p0 and w a member, q at window ends and the best
// iterate, where P-gm1 streamed a member's 2.3 MB workspace (120x440) every
// sweep and its 2.72 MB inverse every V-cycle. A block takes a whole SM, so
// 132 / G members are in flight.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "pcg_tile.cuh"

#ifndef HM_GRID_NX
#error "pressure_pcg_gm.cu is built for one grid: -DHM_GRID_NX -DHM_GRID_NY -DHM_GM_G -DHM_GM_KB"
#endif

namespace {

constexpr int kSmemLimit = 232448;    // shared bytes one block may opt into (sm_90)
constexpr int kSmPerSm = 228 * 1024;  // an SM's shared memory; 1 KB of each block reserved
constexpr unsigned kMaxPolls = 1u << 26;
// A block's threads: about one per kTilesAThread fine tiles of its band, to
// the nearest multiple of 128, from kMinThreads to kMaxThreads (at 120x440
// 256 threads of four tiles each: 512 threads of two spilled at their 128
// registers).
constexpr int kTilesAThread = 4, kMinThreads = 256, kMaxThreads = 1024;

// The per-block geometry and shared-memory layout (floats) of one grid on G
// blocks, KB rows of the coarsest inverse on a banded block. Matches
// ops/pressure.py `gm_layout`.
template <int NX, int NY, int G_, int KB_, bool CHEB = false, bool UNIT = true>
struct Geo {
  static constexpr bool kCheb = CHEB;
  static constexpr bool kUnit = UNIT;
  static constexpr int kG = G_, KB = KB_;
  static constexpr int L = count_levels(NX, NY);
  static constexpr int LC = L - 1;
  static constexpr int LS = LC;  // every level but the coarsest is split in bands
  __host__ __device__ static constexpr int n(int l) { return NX >> l; }
  __host__ __device__ static constexpr int m(int l) { return NY >> l; }
  __host__ __device__ static constexpr int cells(int l) { return n(l) * m(l); }
  __host__ __device__ static constexpr bool split(int l) { return l < LS; }
  // Bands: U units of 2^LS fine rows over RANKS blocks, the first UX a unit
  // more; blocks RANKS.. hold none.
  static constexpr int U = NX >> LS;
  static constexpr int RANKS = kG < U ? kG : U;
  static constexpr int UB = U / RANKS, UX = U % RANKS;
  static constexpr bool kSame = UX == 0 && RANKS == kG;  // every block the same rows
  __host__ __device__ static constexpr int unit(int l) { return 1 << (LS - l); }
  __host__ __device__ static constexpr int band(int q, int l) {
    return q < RANKS ? (UB + (q < UX ? 1 : 0)) * unit(l) : 0;
  }
  __host__ __device__ static constexpr int first(int q, int l) {
    return (q < RANKS ? q * UB + (q < UX ? q : UX) : U) * unit(l);
  }
  __host__ __device__ static constexpr bool below(int q) { return q < RANKS - 1; }
  __host__ __device__ static constexpr int rows(int l) {
    return split(l) ? (UB + (UX > 0 ? 1 : 0)) * unit(l) : n(l);
  }
  __host__ __device__ static constexpr int rows_of(int q, int l) {
    return split(l) ? band(q, l) : n(l);
  }
  __host__ __device__ static constexpr int halo(int l) { return split(l) ? m(l) : 0; }
  __host__ __device__ static constexpr int vec(int l) {
    return r4((rows(l) + (split(l) ? 2 : 0)) * m(l));
  }
  __host__ __device__ static constexpr int faces(int l) { return vec(l); }
  __host__ __device__ static constexpr bool t_alias(int l) {
    int o = 0;
    for (int k = 1; k <= l; ++k) o += vec(k);
    return o <= vec(0);
  }
  __host__ __device__ static constexpr int t_offset(int l) {
    int o = 0;
    for (int k = 1; k < l; ++k) o += vec(k);
    return o;
  }
  __host__ __device__ static constexpr int level_size(int l) {
    return l == 0 ? faces(0) + (UNIT ? 4 : 6) * vec(0) : faces(l) + (t_alias(l) ? 5 : 6) * vec(l);
  }
  static constexpr int NC = cells(LC);
  // Threads a block (ops/pressure.py `gm_threads`).
  static constexpr int TILES0 = rows(0) * m(0) / 4;
  static constexpr int THREADS_RAW =
      ((TILES0 + kTilesAThread - 1) / kTilesAThread + 64) / 128 * 128;
  static constexpr int THREADS = THREADS_RAW < kMinThreads   ? kMinThreads
                                 : THREADS_RAW > kMaxThreads ? kMaxThreads
                                                             : THREADS_RAW;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int TPT = (TILES0 + THREADS - 1) / THREADS;
  static constexpr bool W_REGS = TPT <= 4;
  // The head: the coarsest level's right-hand side and correction (whole,
  // on every block), the warps' partial sums, the bulk copy's barrier.
  static constexpr int CB = 0, CX = r4(NC), RED = 2 * r4(NC);
  static constexpr int BAR = RED + r4(2 * WARPS);
  static constexpr int LEVELS = BAR + 4;
  __host__ __device__ static constexpr int base(int l) {
    int o = LEVELS;
    for (int k = 0; k < l; ++k) o += level_size(k);
    return o;
  }
  // Rows of the inverse: KB on each banded block, KN on each of the others
  // (the rest, spread), the last ones shorter or empty. A banded block's
  // follow its levels, another's the head; each placed 0-3 floats in so
  // that it keeps its source's 16-byte alignment.
  static constexpr int KN = kG > RANKS ? (NC - RANKS * KB + kG - RANKS - 1) / (kG - RANKS) : 0;
  __host__ __device__ static constexpr int inv_first(int q) {
    const int f = q < RANKS ? q * KB : RANKS * KB + (q - RANKS) * KN;
    return f < NC ? f : NC;
  }
  __host__ __device__ static constexpr int inv_rows(int q) {
    const int e = inv_first(q) + (q < RANKS ? KB : KN);
    return (e < NC ? e : NC) - inv_first(q);
  }
  static constexpr int INV_B = base(LC), INV_N = LEVELS;
  static constexpr int FLOATS_B = INV_B + r4(KB * NC) + 4;
  static constexpr int FLOATS_N = kG > RANKS ? INV_N + r4(KN * NC) + 4 : 0;
  static constexpr int FLOATS = FLOATS_B > FLOATS_N ? FLOATS_B : FLOATS_N;
  static constexpr int BYTES = 4 * FLOATS;
  static constexpr bool FITS =
      BYTES <= kSmemLimit && KB >= 0 && RANKS * KB + (kG - RANKS) * KN >= NC;
  static constexpr int SMEM_BLOCKS = kSmPerSm / (BYTES + 1024);
  static constexpr int MIN_BLOCKS = SMEM_BLOCKS < 1 ? 1 : SMEM_BLOCKS > 2 ? 2 : SMEM_BLOCKS;
  // A group's exchange in device memory (floats): per block two slots of a
  // band's first and last rows, per block two totals, the coarse
  // right-hand side and correction (ops/pressure.py `gm_net_floats`).
  static constexpr int NET_HALO = r4(kG * 4 * NY), NET_RED = r4(4 * kG);
  static constexpr int NET = NET_HALO + NET_RED + 2 * r4(NC);
  static_assert(NX % 2 == 0 && NY % 2 == 0 && L >= 2 && L <= kMaxLevels,
                "a tiled fine level and a coarse level");
  static_assert(kG >= 1 && RANKS >= 1, "a block a band at least");
};

// The arrays of level l in a block's shared memory, each at its first row
// of the band (after the halo row); the coarsest level's in the head.
template <class G, int l>
struct Lvl {
  static constexpr int m = G::m(l), H = G::halo(l);
  __device__ static float* tx0(float* sh) { return sh + G::base(l); }
  __device__ static float* ty0(float* sh) { return tx0(sh) + G::faces(l); }
  __device__ static float* TX(float* sh) { return tx0(sh) + H; }
  __device__ static float* TY(float* sh) { return ty0(sh) + H; }
  __device__ static float* D(float* sh) {
    if constexpr (l == 0) return ty0(sh) + 4 * G::vec(0) + H;
    else return ty0(sh) + G::vec(l) + H;
  }
  __device__ static float* RD(float* sh) { return D(sh) + G::vec(l); }
  __device__ static float* B(float* sh) {
    if constexpr (l == 0) return ty0(sh) + 2 * G::vec(0) + H;  // R
    else if constexpr (l == G::LC) return sh + G::CB;
    else return RD(sh) + G::vec(l);
  }
  __device__ static float* X(float* sh) {
    if constexpr (l == 0) return ty0(sh) + G::vec(0) + H;  // P
    else if constexpr (l == G::LC) return sh + G::CX;
    else return B(sh) + G::vec(l);
  }
  __device__ static float* T(float* sh) {
    if constexpr (l == 0 || G::t_alias(l))
      return Lvl<G, 0>::ty0(sh) + 3 * G::vec(0) + G::t_offset(l) + H;
    else return X(sh) + G::vec(l);
  }
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Wait until another block's flag reaches e. The blocks are co-resident,
// so a wait lasts microseconds; 2^26 polls can only be a fault, and trap.
__device__ __forceinline__ void wait_flag(const int* flag, int e) {
  for (unsigned polls = 0; ld_acquire(flag) < e;)
    if (++polls == kMaxPolls) __trap();
}

// One group's exchange, as block r sees it: the flags, the halo slots, the
// totals, the coarse right-hand side and correction in device memory, and
// the points passed (e) and the member-wide ones among them (mw).
template <class G>
struct Net {
  int* flags;
  float* halo;   // [block][parity][first, last][NY]
  float2* red;   // [block][parity]
  float* cb;     // [NC]
  float* cx;     // [NC]
  float2* part;  // the warps' partials, in shared memory
  int r, e, mw;
  // Block r's slot of its band's first (0) or last (1) row for the next point.
  __device__ float* slot(int which) const {
    return halo + ((size_t)(r * 2 + ((e + 1) & 1)) * 2 + which) * G::m(0);
  }
  // Block q's slot of the point just passed.
  __device__ const float* passed(int q, int which) const {
    return halo + ((size_t)(q * 2 + (e & 1)) * 2 + which) * G::m(0);
  }
};

template <int m>
__device__ __forceinline__ void own(const float* v, int I, int J, float out[4]) {
  const int o = 2 * I * m + 2 * J;
  const float2 a = ld2(v + o), b = ld2(v + o + m);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

template <int m>
__device__ __forceinline__ void put(float* v, int I, int J, const float x[4]) {
  const int o = 2 * I * m + 2 * J;
  *reinterpret_cast<float2*>(v + o) = make_float2(x[0], x[1]);
  *reinterpret_cast<float2*>(v + o + m) = make_float2(x[2], x[3]);
}

// Rows of level l around tile row I of block r's band: whether the level
// has a row above / below it (a split level's halo rows hold the
// neighbours' edge rows).
template <class G, int l>
struct Rows {
  static constexpr int m = G::m(l);
  static constexpr bool kSplit = G::split(l);
  __device__ static int TI(int r) { return G::rows_of(r, l) / 2; }
  __device__ static bool up(int I, int r) { return I > 0 || (kSplit && r > 0); }
  __device__ static bool dn(int I, int r) { return I < TI(r) - 1 || (kSplit && G::below(r)); }
};

// put, and on a split level the band's first and last rows into the
// block's slots for the next point.
template <class G, int l>
__device__ __forceinline__ void put_band(float* v, int I, int J, const Net<G>& net,
                                         const float x[4]) {
  using RW = Rows<G, l>;
  constexpr int m = RW::m;
  put<m>(v, I, J, x);
  if constexpr (RW::kSplit) {
    const int r = net.r;
    if (I == 0 && r > 0)
      __stcg(reinterpret_cast<float2*>(net.slot(0) + 2 * J), make_float2(x[0], x[1]));
    if (I == RW::TI(r) - 1 && G::below(r))
      __stcg(reinterpret_cast<float2*>(net.slot(1) + 2 * J), make_float2(x[2], x[3]));
  }
}

// After a point: the neighbours' edge rows of level l's array v into its
// halo rows (the row above the band, and the row after the block's own).
template <class G, int l>
__device__ __forceinline__ void copy_halos(const Net<G>& net, float* v) {
  constexpr int m = G::m(l);
  const int r = net.r;
  if (r >= G::RANKS) return;
  const int h = G::rows_of(r, l);
  for (int k = threadIdx.x; k < 2 * m; k += G::THREADS) {
    if (k < m) {
      if (r > 0) v[k - m] = __ldcg(net.passed(r - 1, 1) + k);
    } else if (G::below(r)) {
      v[h * m + k - m] = __ldcg(net.passed(r + 1, 0) + k - m);
    }
  }
}

// A point that only neighbours wait for: the block publishes it, waits for
// the bands above and below, and copies their edge rows of level l's array
// v (none where v is null).
template <class G, int l>
__device__ __forceinline__ void sync_nb(Net<G>& net, float* v) {
  __syncthreads();
  ++net.e;
  const int r = net.r;
  if (threadIdx.x == 0) st_release(net.flags + r, net.e);
  if (r < G::RANKS) {
    if (threadIdx.x == 32 && r > 0) wait_flag(net.flags + r - 1, net.e);
    if (threadIdx.x == 64 && G::below(r)) wait_flag(net.flags + r + 1, net.e);
  }
  __syncthreads();
  if (v != nullptr) {
    copy_halos<G, l>(net, v);
    __syncthreads();
  }
}

// A member-wide point: the block's total of (a, b) over its warps in warp
// order goes to its slot with the point; after every block of the group
// has published it, each sums the G totals in block order. The halo rows
// of level l's array v (if any) ride on it.
template <class G, int l = 0>
__device__ __forceinline__ float2 sync_all(Net<G>& net, float a, float b, float* v) {
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) net.part[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  ++net.e;
  ++net.mw;
  const int par = net.mw & 1;
  if (threadIdx.x == 0) {
    float2 t = net.part[0];
#pragma unroll
    for (int k = 1; k < G::WARPS; ++k) {
      const float2 u = net.part[k];
      t.x += u.x;
      t.y += u.y;
    }
    __stcg(net.red + net.r * 2 + par, t);
    st_release(net.flags + net.r, net.e);
  }
  for (int q = threadIdx.x; q < G::kG; q += G::THREADS) wait_flag(net.flags + q, net.e);
  __syncthreads();
  float2 t = __ldcg(net.red + par);
#pragma unroll 4
  for (int q = 1; q < G::kG; ++q) {
    const float2 u = __ldcg(net.red + q * 2 + par);
    t.x += u.x;
    t.y += u.y;
  }
  if (v != nullptr) {
    copy_halos<G, l>(net, v);
    __syncthreads();
  }
  return t;
}

template <class G, int l, bool UNITL>
__device__ __forceinline__ void stencil(const float* TX, const float* TY, const float* D, int I,
                                        int J, int r, const Tile& t, float out[4]) {
  using RW = Rows<G, l>;
  constexpr int m = RW::m;
  const int o = 2 * I * m + 2 * J;
  const float2 z2 = make_float2(0.0f, 0.0f);
  const float2 xu = RW::up(I, r) ? ld2(TX + o - m) : z2;
  const float2 xc = ld2(TX + o);
  const float2 xd = RW::dn(I, r) ? ld2(TX + o + m) : z2;
  const float2 y0 = ld2(TY + o), y1 = ld2(TY + o + m);
  const float yl0 = J > 0 ? TY[o - 1] : 0.0f;
  const float yl1 = J > 0 ? TY[o + m - 1] : 0.0f;
  float d[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  if constexpr (!UNITL) own<m>(D, I, J, d);
  tile_stencil(d, xu, xc, xd, y0, y1, yl0, yl1, t, out);
}

template <class G, int l>
__device__ __forceinline__ Tile gather(const float* v, int I, int J, int r) {
  using RW = Rows<G, l>;
  constexpr int m = RW::m;
  const int o = 2 * I * m + 2 * J;
  Tile t;
  own<m>(v, I, J, t.v);
  const float2 z2 = make_float2(0.0f, 0.0f);
  const float2 u = RW::up(I, r) ? ld2(v + o - m) : z2;
  const float2 d = RW::dn(I, r) ? ld2(v + o + 2 * m) : z2;
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

// f(k, I, J) for each tile of block r's rows of level l that this thread
// owns; k counts the largest band's tiles (the registers' index).
template <class G, int l, class F>
__device__ __forceinline__ void tiles(int r, F f) {
  constexpr int TJ = G::m(l) / 2, NT = (G::rows(l) / 2) * TJ, NW = G::THREADS;
  const int nt = G::kSame ? NT : (G::rows_of(r, l) / 2) * TJ;
  const int w = threadIdx.x;
#pragma unroll
  for (int k = 0; k < (NT + NW - 1) / NW; ++k) {
    const int T = w + k * NW;
    if ((G::kSame && NT % NW == 0) || T < nt) f(k, T / TJ, T % TJ);
  }
}

template <class G, int l>
constexpr bool unit_level() {
  return l == 0 && G::kUnit;
}

template <class G, int l, int m>
__device__ __forceinline__ void own_rd(float* sh, int I, int J, float rd[4]) {
  if constexpr (unit_level<G, l>()) {
    rd[0] = rd[1] = rd[2] = rd[3] = 1.0f;
  } else {
    own<m>(Lvl<G, l>::RD(sh), I, J, rd);
  }
}

// Level l+1's array (its B or X) at level l's tile (I, J) of block r, I
// from -1 to the band's tile rows: the block's own band (its halo rows
// beyond) where level l+1 is split; the coarsest level, whole, at this
// band's first coarse row, where it is not.
template <class G, int l>
struct Parent {
  static constexpr bool kSplit = G::split(l + 1);
  static constexpr int mc = G::m(l) / 2;
  __device__ static int at(int I, int J, int r) {
    return ((kSplit ? 0 : G::first(r, l) / 2) + I) * mc + J;
  }
  __device__ static float ld(const float* p, int I, int J, int r) { return p[at(I, J, r)]; }
  // A restricted value into the right-hand side and, where it is a band's
  // first or last coarse row, into the block's slot; on the coarsest
  // level, into the group's coarse right-hand side in device memory.
  __device__ static void st(float* p, int I, int J, const Net<G>& net, float v) {
    const int r = net.r;
    if constexpr (!kSplit) {
      __stcg(net.cb + at(I, J, r), v);
    } else {
      p[at(I, J, r)] = v;
      if (I == 0 && r > 0) __stcg(net.slot(0) + J, v);
      if (I == G::rows_of(r, l) / 2 - 1 && G::below(r)) __stcg(net.slot(1) + J, v);
    }
  }
};

template <class G, int l>
__device__ __forceinline__ void smooth_down(float* sh, const Net<G>& net) {
  using V = Lvl<G, l>;
  constexpr int m = V::m;
  const int r = net.r;
  tiles<G, l>(r, [&](int, int I, int J) {
    const Tile b = gather<G, l>(V::B(sh), I, J, r);
    Tile rdt;
    if constexpr (!unit_level<G, l>()) rdt = gather<G, l>(V::RD(sh), I, J, r);
    const Tile t = first_sweep<G::kCheb, unit_level<G, l>()>(b, rdt);
    float At[4], rd[4], x[4];
    stencil<G, l, unit_level<G, l>()>(V::TX(sh), V::TY(sh), V::D(sh), I, J, r, t, At);
    own_rd<G, l, m>(sh, I, J, rd);
    second_sweep_down<G::kCheb>(t, b, At, rd, x);
    put_band<G, l>(V::X(sh), I, J, net, x);
  });
}

template <class G, int l>
__device__ __forceinline__ void restrict_residual(float* sh, const Net<G>& net) {
  using V = Lvl<G, l>;
  constexpr int m = V::m;
  const int r = net.r;
  float* Bc = Lvl<G, l + 1>::B(sh);
  tiles<G, l>(r, [&](int, int I, int J) {
    const Tile x = gather<G, l>(V::X(sh), I, J, r);
    float Ax[4], b[4];
    stencil<G, l, unit_level<G, l>()>(V::TX(sh), V::TY(sh), V::D(sh), I, J, r, x, Ax);
    own<m>(V::B(sh), I, J, b);
    Parent<G, l>::st(Bc, I, J, net, restrict_tile(b, Ax));
  });
}

template <class G, int l>
__device__ __forceinline__ void smooth_up_first(float* sh, const Net<G>& net) {
  using V = Lvl<G, l>;
  using RW = Rows<G, l>;
  using E = Parent<G, l>;
  constexpr int m = V::m, mc = m / 2;
  const int r = net.r;
  const float* El = Lvl<G, l + 1>::X(sh);
  tiles<G, l>(r, [&](int, int I, int J) {
    Tile x = gather<G, l>(V::X(sh), I, J, r);
    prolong(x, [&](int dI, int dJ) { return E::ld(El, I + dI, J + dJ, r); }, RW::up(I, r),
            RW::dn(I, r), J > 0, J < mc - 1);
    float Ax[4], b[4], rd[4], t[4];
    stencil<G, l, unit_level<G, l>()>(V::TX(sh), V::TY(sh), V::D(sh), I, J, r, x, Ax);
    own<m>(V::B(sh), I, J, b);
    own_rd<G, l, m>(sh, I, J, rd);
    first_sweep_up<G::kCheb>(x, b, Ax, rd, t);
    put_band<G, l>(V::T(sh), I, J, net, t);
  });
}

template <class G, int l, class Out>
__device__ __forceinline__ void smooth_up_second(float* sh, int r, Out out) {
  using V = Lvl<G, l>;
  constexpr int m = V::m;
  tiles<G, l>(r, [&](int k, int I, int J) {
    const Tile t = gather<G, l>(V::T(sh), I, J, r);
    float At[4], b[4], rd[4], x[4];
    stencil<G, l, unit_level<G, l>()>(V::TX(sh), V::TY(sh), V::D(sh), I, J, r, t, At);
    own<m>(V::B(sh), I, J, b);
    own_rd<G, l, m>(sh, I, J, rd);
    float x0[4], e = 0.0f;
    if constexpr (G::kCheb) {
      own<m>(V::X(sh), I, J, x0);
      e = Parent<G, l>::ld(Lvl<G, l + 1>::X(sh), I, J, r);
    }
    second_sweep_up<G::kCheb>(t, b, At, rd, x0, e, x);
    out(k, I, J, x);
  });
}

// Down the split levels, each block on its band; the last one's
// restriction lands in the group's coarse right-hand side.
template <class G, int l>
__device__ __forceinline__ void down_split(float* sh, Net<G>& net) {
  if constexpr (l < G::LS) {
    smooth_down<G, l>(sh, net);
    sync_nb<G, l>(net, Lvl<G, l>::X(sh));
    restrict_residual<G, l>(sh, net);
    if constexpr (l + 1 < G::LS) {
      sync_nb<G, l + 1>(net, Lvl<G, l + 1>::B(sh));
      down_split<G, l + 1>(sh, net);
    }
  }
}

// Up the split levels from l to 1.
template <class G, int l>
__device__ __forceinline__ void up_split(float* sh, Net<G>& net) {
  if constexpr (l >= 1) {
    smooth_up_first<G, l>(sh, net);
    sync_nb<G, l>(net, Lvl<G, l>::T(sh));
    smooth_up_second<G, l>(sh, net.r, [&](int, int I, int J, const float* x) {
      put_band<G, l>(Lvl<G, l>::X(sh), I, J, net, x);
    });
    sync_nb<G, l>(net, Lvl<G, l>::X(sh));
    up_split<G, l - 1>(sh, net);
  }
}

// The coarsest level: after a member-wide point every block copies the
// coarse right-hand side, multiplies its rows of the inverse (at A, from
// row inv_first(r), in its shared memory) by it, a row a warp with the
// lanes along the row, and stores its part of the correction; after a
// second one each banded block copies the coarse rows its prolongation
// reads (its band's and the one above and below).
template <class G>
__device__ __forceinline__ void coarse_solve(float* sh, const float* A, Net<G>& net) {
  constexpr int nc = G::NC, mc = G::m(G::LC), lp = G::LS - 1;
  const int r = net.r;
  sync_all<G>(net, 0.0f, 0.0f, nullptr);
  float* b = sh + G::CB;
  for (int k = threadIdx.x; k < nc; k += G::THREADS) b[k] = __ldcg(net.cb + k);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = G::inv_first(r), k1 = k0 + G::inv_rows(r);
  for (int row = k0 + warp; row < k1; row += G::WARPS) {
    const float* a = A + (row - k0) * nc;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = lane; k < nc; k += 32) acc += a[k] * b[k];
    acc = warp_sum(acc);
    if (lane == 0) __stcg(net.cx + row, acc);
  }
  sync_all<G>(net, 0.0f, 0.0f, nullptr);
  if (r < G::RANKS) {
    const int f = G::first(r, lp) / 2, t = G::band(r, lp) / 2;
    const int lo = f > 0 ? f - 1 : 0, hi = f + t < G::n(G::LC) ? f + t : f + t - 1;
    float* x = sh + G::CX;
    for (int k = lo * mc + threadIdx.x; k < (hi + 1) * mc; k += G::THREADS)
      x[k] = __ldcg(net.cx + k);
  }
  __syncthreads();
}

// z = V-cycle(r) from a zero initial guess; the fine R vector is its
// right-hand side, z lands in the owning threads' registers.
template <class G>
__device__ __forceinline__ void vcycle(float* sh, const float* Ainv, Net<G>& net,
                                       float (&z)[G::TPT][4]) {
  down_split<G, 0>(sh, net);
  coarse_solve<G>(sh, Ainv, net);
  up_split<G, G::LS - 1>(sh, net);
  smooth_up_first<G, 0>(sh, net);
  sync_nb<G, 0>(net, Lvl<G, 0>::T(sh));
  smooth_up_second<G, 0>(sh, net.r, [&](int k, int, int, const float* x) {
#pragma unroll
    for (int c = 0; c < 4; ++c) z[k][c] = x[c];
  });
}

struct HierPtrs {  // per level: TX (B, n-1, m), TY (B, n, m-1), diag (B, n, m)
  const float* tx[kMaxLevels];
  const float* ty[kMaxLevels];
  const float* d[kMaxLevels];
  const float* ainv;  // (B, nc, nc)
};

// Member b's band of every split level into block r's shared memory, with
// the halo rows its stencil reads (TX from the face above the band, zero
// past the last face; the reciprocal diagonal a row beyond each side); TY
// padded to m wide, diagonals with their reciprocals (P-cl's load_level).
template <class G, int l>
__device__ __forceinline__ void load_level(float* sh, const HierPtrs& h, int b, int r) {
  if constexpr (l < G::LC) {
    using V = Lvl<G, l>;
    constexpr int n = G::n(l), m = G::m(l), T = G::THREADS;
    const int rows = G::rows_of(r, l), i0 = G::first(r, l);
    const float* tx = h.tx[l] + (size_t)b * (n - 1) * m;
    for (int k = threadIdx.x; k < (rows + 1) * m; k += T) {
      const int g = (i0 - 1) * m + k;  // from the face above the band
      V::TX(sh)[k - m] = g >= 0 && g < (n - 1) * m ? tx[g] : 0.0f;
    }
    const float* ty = h.ty[l] + (size_t)b * n * (m - 1);
    for (int k = threadIdx.x; k < rows * m; k += T) {
      const int i = k / m, j = k - i * m;
      V::TY(sh)[k] = j < m - 1 ? ty[(i0 + i) * (m - 1) + j] : 0.0f;
    }
    if constexpr (l > 0 || !G::kUnit) {
      const float* d = h.d[l] + (size_t)b * n * m;
      for (int k = threadIdx.x; k < (rows + 2) * m; k += T) {
        const int g = (i0 - 1) * m + k;
        if (g < 0 || g >= n * m) continue;
        const float v = d[g];
        V::D(sh)[k - m] = v;
        V::RD(sh)[k - m] = 1.0f / v;
      }
    }
    load_level<G, l + 1>(sh, h, b, r);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Block r's rows of member b's inverse (row-major, as in device memory) into
// its shared memory at `region` with one bulk asynchronous copy (TMA),
// completing on the barrier at BAR (initialised for one arrival); the
// unaligned first and last floats (at most three each) go by plain loads
// (P-cl/d's load_inverse). Returns where the rows start.
template <class G>
__device__ __forceinline__ const float* load_inverse(float* sh, float* region, const float* ainv,
                                                     int b, int r) {
  constexpr int nc = G::NC;
  const int rows = G::inv_rows(r);
  const float* src = ainv + (size_t)b * nc * nc + (size_t)G::inv_first(r) * nc;
  const int phase = (int)((reinterpret_cast<size_t>(src) >> 2) & 3);
  float* dst = region + phase;
  const int n = rows * nc, lead = (4 - phase) & 3, head = lead < n ? lead : n;
  const int mid = (n - head) / 4 * 4, tail = n - head - mid;
  const int t = threadIdx.x;
  if (t < head) dst[t] = src[t];
  if (t >= 32 && t < 32 + tail) dst[head + mid + t - 32] = src[head + mid + t - 32];
  if (t == 0) {
    const unsigned bar = smem_addr(sh + G::BAR), bytes = 4u * (unsigned)mid;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
    if (bytes > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(smem_addr(dst + head)),
          "l"(src + head), "r"(bytes), "r"(bar)
          : "memory");
  }
  return dst;
}

// Every thread waits for load_inverse's copy of the block's c-th member.
template <class G>
__device__ __forceinline__ void wait_inverse(float* sh, int c) {
  const unsigned bar = smem_addr(sh + G::BAR), parity = (unsigned)(c & 1);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

template <int NX, int NY, int GB, int KB, bool CHEB, bool UNIT>
__global__ void __launch_bounds__(Geo<NX, NY, GB, KB, CHEB, UNIT>::THREADS,
                                  Geo<NX, NY, GB, KB, CHEB, UNIT>::MIN_BLOCKS)
pressure_pcg_gm_kernel(HierPtrs h, const float* __restrict__ q_g, const float* __restrict__ p0_g,
                       const float* __restrict__ w_g, float* __restrict__ p_out,
                       int* __restrict__ it_out, float* __restrict__ rel_out, float* net_g,
                       int* flags_g, int B, int groups, float tol, int maxiter,
                       int restart_every, int patience) {
  using G = Geo<NX, NY, GB, KB, CHEB, UNIT>;
  using F = Lvl<G, 0>;
  constexpr int TPT = G::TPT;
  extern __shared__ float4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  const int grp = blockIdx.x / GB, r = blockIdx.x - grp * GB;
  float* gnet = net_g + (size_t)grp * G::NET;
  Net<G> net{flags_g + grp * GB,
             gnet,
             reinterpret_cast<float2*>(gnet + G::NET_HALO),
             gnet + G::NET_HALO + G::NET_RED,
             gnet + G::NET_HALO + G::NET_RED + r4(G::NC),
             reinterpret_cast<float2*>(sh + G::RED),
             r,
             0,
             0};
  const bool banded = r < G::RANKS;
  float* P = F::X(sh);
  float* R = F::B(sh);
  float* Tv = F::T(sh);
  const float* TX = F::TX(sh);
  const float* TY = F::TY(sh);
  const float* Df = UNIT ? nullptr : F::D(sh);
  float* inverse = sh + (banded ? G::INV_B : G::INV_N);
  auto fine = [&](auto f) { tiles<G, 0>(r, f); };
  if (threadIdx.x == 0)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(sh + G::BAR))
                 : "memory");
  __syncthreads();

  for (int b = grp, c = 0; b < B; b += groups, ++c) {
    const size_t off = (size_t)b * NX * NY + (size_t)G::first(r, 0) * NY;  // the band's first cell
    const float* q = q_g + off;
    float* xb = p_out + off;  // the best iterate lives here
    // the inverse's rows arrive while the hierarchy loads and the residual runs
    const float* Ainv = load_inverse<G>(sh, inverse, h.ainv, b, r);
    if (banded) load_level<G, 0>(sh, h, b, r);
    float x[TPT][4] = {}, p[TPT][4] = {}, w[G::W_REGS ? TPT : 1][4] = {}, z[TPT][4] = {};
    fine([&](int k, int I, int J) {
      own<NY>(p0_g + off, I, J, x[k]);
      if constexpr (G::W_REGS) own<NY>(w_g + off, I, J, w[k]);
      put<NY>(xb, I, J, x[k]);
      put_band<G, 0>(Tv, I, J, net, x[k]);
    });
    sync_nb<G, 0>(net, Tv);
    auto weight = [&](int k, int I, int J, float wv[4]) {
      if constexpr (G::W_REGS) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) wv[cc] = w[k][cc];
      } else {
        own<NY>(w_g + off, I, J, wv);
      }
    };

    // r = q - A x from x in T, into R; adds the thread's (w r)^2 to wr2 and
    // (w q)^2 to wq2.
    auto residual = [&](float& wr2, float& wq2) {
      fine([&](int k, int I, int J) {
        const Tile xt = gather<G, 0>(Tv, I, J, r);
        float Ax[4], qv[4], rv[4], wv[4];
        stencil<G, 0, UNIT>(TX, TY, Df, I, J, r, xt, Ax);
        own<NY>(q, I, J, qv);
        weight(k, I, J, wv);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          rv[cc] = qv[cc] - Ax[cc];
          const float wr = wv[cc] * rv[cc], wq = wv[cc] * qv[cc];
          wr2 += wr * wr;
          wq2 += wq * wq;
        }
        put_band<G, 0>(R, I, J, net, rv);
      });
    };

    float wr2 = 0.0f, wq2 = 0.0f;
    residual(wr2, wq2);
    const float2 s0 = sync_all<G>(net, wq2, wr2, R);
    const float bb = s0.x;
    float rr_best = s0.y;
    const float tol2 = (tol * tol) * fmaxf(bb, FLT_MIN);
    wait_inverse<G>(sh, c);  // also where no iteration runs

    bool use_sd = false, r_valid = true, first = true;
    int n_bad = 0, kk = 0;
    while (kk < maxiter && rr_best > tol2 && n_bad < patience) {
      if (!r_valid) {  // after a blow-up x was reset to the best iterate
        fine([&](int k, int I, int J) { put_band<G, 0>(Tv, I, J, net, x[k]); });
        sync_nb<G, 0>(net, Tv);
        float unused = 0.0f;
        residual(unused, unused);
        sync_nb<G, 0>(net, R);
      }
      vcycle<G>(sh, Ainv, net, z);
      const bool restart = use_sd || first;
      float prz = 0.0f, prr = 0.0f;
      fine([&](int k, int I, int J) {
        float rv[4], wv[4];
        own<NY>(R, I, J, rv);
        weight(k, I, J, wv);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          prz += rv[cc] * z[k][cc];
          const float wr = wv[cc] * rv[cc];
          prr += wr * wr;
          if (restart) p[k][cc] = z[k][cc];
        }
        put_band<G, 0>(P, I, J, net, p[k]);
      });
      float2 s = sync_all<G>(net, prz, prr, P);
      float rz = s.x, rr = s.y;
      const float beta_mask = use_sd ? 0.0f : 1.0f;
      for (int it = 0; it < restart_every && rr > tol2; ++it) {
        // A p goes to T, free until the V-cycle, read back on the thread's
        // own cells.
        float ppap = 0.0f;
        fine([&](int k, int I, int J) {
          const Tile pt = gather<G, 0>(P, I, J, r);
          float Ap[4];
          stencil<G, 0, UNIT>(TX, TY, Df, I, J, r, pt, Ap);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) ppap += p[k][cc] * Ap[cc];
          put<NY>(Tv, I, J, Ap);
        });
        const float pAp = sync_all<G>(net, ppap, 0.0f, nullptr).x;
        const float alpha = rz / (pAp == 0.0f ? 1.0f : pAp);
        fine([&](int k, int I, int J) {
          float rv[4], Ap[4];
          own<NY>(R, I, J, rv);
          own<NY>(Tv, I, J, Ap);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            x[k][cc] = x[k][cc] + alpha * p[k][cc];
            rv[cc] = rv[cc] - alpha * Ap[cc];
          }
          put_band<G, 0>(R, I, J, net, rv);
        });
        sync_nb<G, 0>(net, R);
        vcycle<G>(sh, Ainv, net, z);
        prz = prr = 0.0f;
        fine([&](int k, int I, int J) {
          float rv[4], wv[4];
          own<NY>(R, I, J, rv);
          weight(k, I, J, wv);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            prz += rv[cc] * z[k][cc];
            const float wr = wv[cc] * rv[cc];
            prr += wr * wr;
          }
        });
        s = sync_all<G>(net, prz, prr, nullptr);
        const float beta = beta_mask * s.x / (rz == 0.0f ? 1.0f : rz);
        fine([&](int k, int I, int J) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) p[k][cc] = z[k][cc] + beta * p[k][cc];
          put_band<G, 0>(P, I, J, net, p[k]);
        });
        rz = s.x;
        rr = s.y;
        sync_nb<G, 0>(net, P);
      }
      // True residual of the window's iterate (residual replacement).
      fine([&](int k, int I, int J) { put_band<G, 0>(Tv, I, J, net, x[k]); });
      sync_nb<G, 0>(net, Tv);
      float wr2n = 0.0f, unused = 0.0f;
      residual(wr2n, unused);
      const float rr_new = sync_all<G>(net, wr2n, 0.0f, R).x;
      const bool finite = isfinite(rr_new);
      const bool blown = !finite || rr_new > 100.0f * fmaxf(rr_best, tol2);
      const bool better = finite && rr_new < rr_best;
      if (better) fine([&](int k, int I, int J) { put<NY>(xb, I, J, x[k]); });
      if (blown) fine([&](int k, int I, int J) { own<NY>(xb, I, J, x[k]); });
      if (better) rr_best = rr_new;
      n_bad = better ? 0 : n_bad + 1;
      use_sd = blown;
      r_valid = !blown;
      first = false;
      kk += restart_every;
    }
    if (r == 0 && threadIdx.x == 0) {
      it_out[b] = kk;
      rel_out[b] = sqrtf(rr_best / fmaxf(bb, FLT_MIN));
    }
    __syncthreads();  // every read of this member's shared arrays done
  }
}

template <bool CHEB, bool UNIT>
using GridGeo = Geo<HM_GRID_NX, HM_GRID_NY, HM_GM_G, HM_GM_KB, CHEB, UNIT>;

template <bool CHEB, bool UNIT>
auto kernel_of() {
  return pressure_pcg_gm_kernel<HM_GRID_NX, HM_GRID_NY, HM_GM_G, HM_GM_KB, CHEB, UNIT>;
}

// The blocks an SM and the blocks the card holds at once.
template <bool CHEB, bool UNIT>
cudaError_t resident(int* blocks_sm, int* total) {
  using G = GridGeo<CHEB, UNIT>;
  auto kern = kernel_of<CHEB, UNIT>();
  int dev = 0, sms = 0;
  *blocks_sm = *total = 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_sm, kern, G::THREADS, G::BYTES);
  if (e == cudaSuccess) *total = *blocks_sm * sms;
  return e;
}

template <bool CHEB, bool UNIT>
int launch(const float* const* lv, int n_levels, const float* ainv, const float* q,
           const float* p0, const float* w, float* p_out, int* it_out, float* rel_out, float* net,
           int* flags, int groups_cap, int B, float tol, int maxiter, int restart_every,
           int patience, cudaStream_t stream) {
  using G = GridGeo<CHEB, UNIT>;
  if constexpr (!G::FITS) {
    return (int)cudaErrorInvalidValue;  // this plan does not fit this instantiation
  } else {
    if (n_levels != G::L || (!UNIT && lv[2] == nullptr)) return (int)cudaErrorInvalidValue;
    HierPtrs h{};
    for (int l = 0; l < G::L; ++l) {
      h.tx[l] = lv[3 * l];
      h.ty[l] = lv[3 * l + 1];
      h.d[l] = lv[3 * l + 2];
    }
    h.ainv = ainv;
    int blocks_sm, total;
    cudaError_t e = resident<CHEB, UNIT>(&blocks_sm, &total);
    if (e != cudaSuccess) return (int)e;
    // A member whose blocks the card cannot hold at once is refused.
    int groups = total / G::kG;
    if (groups < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    if (groups > groups_cap) groups = groups_cap;
    if (groups > B) groups = B;
    void* args[] = {&h,     &q,     &p0,    &w,   &p_out,   &it_out,        &rel_out, &net,
                    &flags, &B,     &groups, &tol, &maxiter, &restart_every, &patience};
    e = cudaLaunchCooperativeKernel((const void*)kernel_of<CHEB, UNIT>(), dim3(groups * G::kG),
                                    dim3(G::THREADS), args, G::BYTES, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
}

template <bool CHEB, bool UNIT>
int info(int* out) {
  using G = GridGeo<CHEB, UNIT>;
  if constexpr (!G::FITS) {
    return (int)cudaErrorInvalidValue;
  } else {
    cudaFuncAttributes a{};
    int blocks_sm = 0, total = 0;
    cudaError_t e = resident<CHEB, UNIT>(&blocks_sm, &total);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel_of<CHEB, UNIT>());
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = G::BYTES;
    out[3] = G::THREADS;
    out[4] = blocks_sm;
    out[5] = G::kG;
    out[6] = total / G::kG;
    return (int)e;
  }
}

}  // namespace

// The arguments of hm_pressure_solve (pressure_pcg.cu), with after rel_out
// the groups' exchange (net: groups_cap x `gm_net_floats` float32,
// uninitialised), their flags (groups_cap x G int32, zeroed) and the groups
// they hold. A cooperative launch of groups x G blocks, groups the fewest
// of groups_cap, B and the groups the card holds at once; refused (its
// error returned) where the card cannot hold one member's G blocks. This
// library is built for one grid and plan; another grid is refused.
extern "C" int hm_pressure_gm_solve(const float* const* lv, const float* ainv, const float* q,
                                    const float* p0, const float* w, float* p_out, int* it_out,
                                    float* rel_out, float* net, int* flags, int groups_cap, int B,
                                    int Nx, int Ny, int n_levels, float tol, int maxiter,
                                    int restart_every, int patience, int cheb, int unit,
                                    void* stream) {
  if (Nx != HM_GRID_NX || Ny != HM_GRID_NY || groups_cap < 1) return (int)cudaErrorInvalidValue;
#define HM_GM_LAUNCH(c, u)                                                                    \
  launch<c, u>(lv, n_levels, ainv, q, p0, w, p_out, it_out, rel_out, net, flags, groups_cap, \
               B, tol, maxiter, restart_every, patience, (cudaStream_t)stream)
  if (cheb) return unit ? HM_GM_LAUNCH(true, true) : HM_GM_LAUNCH(true, false);
  return unit ? HM_GM_LAUNCH(false, true) : HM_GM_LAUNCH(false, false);
#undef HM_GM_LAUNCH
}

// out: registers a thread, local (stack and spill) bytes a thread, dynamic
// shared bytes a block, threads a block, resident blocks an SM, blocks a
// member (G), and the members the card holds at once (groups).
extern "C" int hm_pressure_gm_info(int Nx, int Ny, int cheb, int unit, int* out) {
  if (Nx != HM_GRID_NX || Ny != HM_GRID_NY) return (int)cudaErrorInvalidValue;
  if (cheb) return unit ? info<true, true>(out) : info<true, false>(out);
  return unit ? info<false, true>(out) : info<false, false>(out);
}
