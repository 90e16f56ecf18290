// Kernel P-gm1: kernel P (pressure_pcg.cu) with its arrays in device
// memory, one thread block a member: the first device-memory form (PR 9's
// P-gm), kept for the grids P-gm (pressure_pcg_gm.cu) takes no plan for.
//
// Replaces: historymatching_tpu/ops/pressure_pallas.py,
//   pressure_solve_pallas (pressure_pcg_kernel), and its multi-member
//   layouts _batched and _packed, at the grids where the TPU kernel keeps
//   its hierarchy in VMEM with vmem_limit_bytes raised (pressure_pallas.py
//   :163-166), no cluster of P-cl holds the layout and P-gm's bands do not
//   fit (ops/pressure.py `gm_plan` None: e.g. 32x1088, whose band of 8 rows
//   of 1,088 cells exceeds one block's shared memory); anywhere with
//   force="gm1".
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
// One thread block per member, as P. The grid is a run-time argument (the
// kernel's parameters, read in place as a __grid_constant__), so one
// library serves every grid: the layout, every level's sides and the
// offsets of its arrays, comes from ops/pressure.py `layout` (with `gm1`)
// as a table, and the wrapper allocates a workspace of that many floats a
// member with torch.empty. Every level's faces, diagonal, reciprocal
// diagonal, right-hand side, iterate and temporary, and the CG vectors x,
// p, z and A p, live there; the metric weight w and q are read in place,
// the coarsest inverse too (row-major, as the plain version multiplies by
// it), and the reduction slots are in shared memory. Threads walk a
// level's 2x2 tiles in grid-stride loops; a thread owns the same tiles in
// every pass, so a pass that reads only its own cells needs no barrier,
// and the barriers are P's.
//
// What bounds it on the H100: device memory and L2. A CG iteration streams
// the fine level's arrays several times (each smoothing sweep reads TX, TY,
// B and a vector with its neighbours and writes one); at 128x128 a
// member's workspace is ~0.7 MB, so the resident members overflow the
// 50 MB L2 and the sweeps go to device memory. Where the coarsest level is
// large (15x55 = 825 cells on a 60x220 grid, 25x25 at 100x100) its
// inverse, read once a V-cycle, is the largest read of all; that solve
// runs on every warp, a row a warp, with coalesced reads along the row.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "pcg_tile.cuh"

namespace {

constexpr int kMaxThreads = 512;

// A level: its sides and the offsets (floats) of its arrays in a member's
// workspace, in the order of ops/pressure.py LEVEL_KEYS.
struct Level {
  int n, m, tx, ty, d, rd, b, x, t;
};

struct Args {
  int L;                 // levels; L - 1 is the coarsest
  int floats;            // a member's workspace
  int xv, pv, zv, apv;   // the CG vectors x, p, z, A p
  Level lv[kMaxLevels];
  const float* tx[kMaxLevels];  // the member-major inputs, per level
  const float* ty[kMaxLevels];
  const float* d[kMaxLevels];
  const float* ainv;  // (B, nc, nc)
};

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

// The view of level l of one member's workspace.
template <bool CHEB, bool UNIT>
struct View {
  float* ws;
  const Level* lv;
  int l;
  __device__ const Level& g() const { return lv[l]; }
  __device__ bool unit() const { return UNIT && l == 0; }
  __device__ float* TX() const { return ws + g().tx; }
  __device__ float* TY() const { return ws + g().ty; }
  __device__ float* D() const { return ws + g().d; }
  __device__ float* RD() const { return ws + g().rd; }
  __device__ float* B() const { return ws + g().b; }
  __device__ float* X() const { return ws + g().x; }
  __device__ float* T() const { return ws + g().t; }
  __device__ void own_rd(int I, int J, float rd[4]) const {
    if (unit()) {
      rd[0] = rd[1] = rd[2] = rd[3] = 1.0f;
    } else {
      own(RD(), g().m, I, J, rd);
    }
  }
};

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

// Coarsest level: x = inverse @ b, a row a warp, the lanes along the row.
__device__ void coarse_solve(const float* A, const float* b, float* x, int nc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int r = warp; r < nc; r += warps) {
    const float* row = A + (size_t)r * nc;
    float acc = 0.0f;
    for (int k = lane; k < nc; k += 32) acc += row[k] * b[k];
    acc = warp_sum(acc);
    if (lane == 0) x[r] = acc;
  }
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
// goes to `z`. Clobbers the levels' X and T vectors.
template <bool CHEB, bool UNIT>
__device__ void vcycle(float* ws, const Args& a, const float* Ainv, float* z) {
  const int LC = a.L - 1;
  for (int l = 0; l < LC; ++l) {
    const View<CHEB, UNIT> V{ws, a.lv, l};
    smooth_down(V);
    __syncthreads();
    restrict_residual(V, ws + a.lv[l + 1].b);
    __syncthreads();
  }
  const Level& c = a.lv[LC];
  coarse_solve(Ainv, ws + c.b, ws + c.x, c.n * c.m);
  __syncthreads();
  for (int l = LC - 1; l >= 0; --l) {
    const View<CHEB, UNIT> V{ws, a.lv, l};
    const float* E = ws + a.lv[l + 1].x;
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

// Member b's hierarchy into its workspace: TY padded to m wide, the
// diagonals with their reciprocals (not on the unit fine level).
template <bool UNIT>
__device__ void load_levels(float* ws, const Args& a, int b) {
  for (int l = 0; l < a.L - 1; ++l) {
    const Level& g = a.lv[l];
    const int n = g.n, m = g.m;
    const float* tx = a.tx[l] + (size_t)b * (n - 1) * m;
    for (int k = threadIdx.x; k < (n - 1) * m; k += blockDim.x) ws[g.tx + k] = tx[k];
    const float* ty = a.ty[l] + (size_t)b * n * (m - 1);
    for (int k = threadIdx.x; k < n * m; k += blockDim.x) {
      const int i = k / m, j = k - i * m;
      ws[g.ty + k] = j < m - 1 ? ty[i * (m - 1) + j] : 0.0f;
    }
    if (l > 0 || !UNIT) {
      const float* d = a.d[l] + (size_t)b * n * m;
      for (int k = threadIdx.x; k < n * m; k += blockDim.x) {
        const float v = d[k];
        ws[g.d + k] = v;
        ws[g.rd + k] = 1.0f / v;
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
  __shared__ float2 red_buf[2 * (kMaxThreads / 32)];
  const Level& F = a.lv[0];
  const int NX = F.n, NY = F.m, b = blockIdx.x;
  const size_t off = (size_t)b * NX * NY;
  float* ws = ws_g + (size_t)b * a.floats;
  const Level& C = a.lv[a.L - 1];
  const float* Ainv = a.ainv + (size_t)b * (C.n * C.m) * (C.n * C.m);
  const float* q = q_g + off;
  const float* w = w_g + off;
  float* xb = p_out + off;  // the best iterate lives here
  float* P = ws + F.x;      // p for the matvec's gathers; the V-cycle's fine iterate
  float* R = ws + F.b;
  float* Tv = ws + F.t;
  float* X = ws + a.xv;
  float* Pv = ws + a.pv;
  float* Z = ws + a.zv;
  float* AP = ws + a.apv;
  const float* TX = ws + F.tx;
  const float* TY = ws + F.ty;
  const float* Df = ws + F.d;
  Reducer red{red_buf, 0};
  auto fine = [&](auto f) { tiles(NX, NY, f); };

  load_levels<UNIT>(ws, a, b);
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
    vcycle<CHEB, UNIT>(ws, a, Ainv, Z);
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
      vcycle<CHEB, UNIT>(ws, a, Ainv, Z);
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
  }
}

// Threads a block: one per fine 2x2 tile, in whole warps, at most 512.
inline int block_threads(int Nx, int Ny) {
  const int t = (Nx / 2) * (Ny / 2);
  return t >= kMaxThreads ? kMaxThreads : (t + 31) / 32 * 32;
}

template <bool CHEB, bool UNIT>
int launch(const Args& a, const float* q, const float* p0, const float* w, float* p_out,
           int* it_out, float* rel_out, float* ws, int B, float tol, int maxiter,
           int restart_every, int patience, cudaStream_t stream) {
  pressure_pcg_gm1_kernel<CHEB, UNIT><<<B, block_threads(a.lv[0].n, a.lv[0].m), 0, stream>>>(
      a, q, p0, w, p_out, it_out, rel_out, ws, tol, maxiter, restart_every, patience);
  return (int)cudaGetLastError();
}

template <bool CHEB, bool UNIT>
int info(int Nx, int Ny, int* out) {
  auto kern = pressure_pcg_gm1_kernel<CHEB, UNIT>;
  cudaFuncAttributes at{};
  cudaError_t e = cudaFuncGetAttributes(&at, kern);
  int blocks = 0;
  const int threads = block_threads(Nx, Ny);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads, 0);
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = (int)at.sharedSizeBytes;
  out[3] = threads;
  out[4] = blocks;
  return (int)e;
}

}  // namespace

// lv: 3 * levels pointers, per level TX (B, n-1, m), TY (B, n, m-1), diag
// (B, n, m), float32; the level-0 diag is read only where unit is 0. ainv
// (B, nc, nc); q, p0, w, p_out (B, Nx, Ny); ws the workspace, B times the
// layout's floats. table (host memory): levels, floats a member, the
// offsets of x, p, z and A p, then per level n, m and the offsets of TX,
// TY, D, 1/D, B, X and T (ops/pressure.py `gm1_table`). cheb: 0 for the
// damped-Jacobi smoother, 1 for the Chebyshev one.
extern "C" int hm_pressure_gm1_solve(const float* const* lv, const float* ainv, const float* q,
                                    const float* p0, const float* w, float* p_out, int* it_out,
                                    float* rel_out, float* ws, const int* table, int B,
                                    float tol, int maxiter, int restart_every, int patience,
                                    int cheb, int unit, void* stream) {
  Args a{};
  a.L = table[0];
  if (a.L < 2 || a.L > kMaxLevels || (!unit && lv[2] == nullptr)) return (int)cudaErrorInvalidValue;
  a.floats = table[1];
  a.xv = table[2];
  a.pv = table[3];
  a.zv = table[4];
  a.apv = table[5];
  for (int l = 0; l < a.L; ++l) {
    const int* t = table + 6 + 9 * l;
    a.lv[l] = Level{t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], t[8]};
    a.tx[l] = lv[3 * l];
    a.ty[l] = lv[3 * l + 1];
    a.d[l] = lv[3 * l + 2];
  }
  a.ainv = ainv;
  if (a.lv[0].n % 2 || a.lv[0].m % 2) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define HM_GM(c, u) \
  launch<c, u>(a, q, p0, w, p_out, it_out, rel_out, ws, B, tol, maxiter, restart_every, patience, s)
  if (cheb) return unit ? HM_GM(true, true) : HM_GM(true, false);
  return unit ? HM_GM(false, true) : HM_GM(false, false);
#undef HM_GM
}

// out: registers a thread, local (stack and spill) bytes a thread, static
// shared bytes, threads a block at the grid, resident blocks an SM, of the
// instantiation for the smoother (cheb 0 or 1) and fine diagonal (unit).
extern "C" int hm_pressure_gm1_info(int Nx, int Ny, int cheb, int unit, int* out) {
  if (cheb) return unit ? info<true, true>(Nx, Ny, out) : info<true, false>(Nx, Ny, out);
  return unit ? info<false, true>(Nx, Ny, out) : info<false, false>(Nx, Ny, out);
}
