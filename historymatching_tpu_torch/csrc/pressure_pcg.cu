// Kernel P: the whole restarted multigrid-preconditioned CG solve of the
// Jacobi-scaled TPFA pressure system, for every ensemble member.
//
// Replaces: historymatching_tpu/ops/pressure_pallas.py,
//   pressure_solve_pallas (pressure_pcg_kernel), and its multi-member
//   layouts _batched and _packed, which compute the same per-member solve.
//   The semantics are those of historymatching_tpu/ops/cg.py `pcg` (each
//   member stops on its own), with the V-cycle of ops/multigrid.py
//   `vcycle_apply`: nu = 2 smoothing sweeps before and after, 2x2
//   block-sum restriction, prolongation by injection times omega_c = 1.4,
//   and a dense coarsest solve with the member's precomputed inverse. The
//   smoother is a template parameter (CHEB): damped Jacobi (omega 0.7), or
//   the degree-2 Chebyshev polynomial of `_cheb` (multigrid.py:167,
//   CHEB_BOUNDS (0.5, 2.0)), the `smoother="cheb"` variant of the Pallas
//   kernels. On the scaled system the fine diagonal is 1 (the contract
//   of models/ressim.py `scaled_system`): the UNIT instantiation takes that
//   as given and never reads a fine diagonal. The other (UNIT = false)
//   solves the unscaled system (`simulate(scale_system=False)`), whose
//   fine level keeps its diagonal and reciprocal diagonal in shared memory
//   as the coarse levels do.
//
// One thread block per member. The kernel is a template on the grid
// (grids.cuh; any other grid with a hierarchy is built into a library of
// its own on first use, ops/_build.py), the smoother and the fine
// diagonal: every level's size, loop bound and neighbour offset is a
// compile-time constant. Any even grid works: a level's tiles are 2x2
// cells, and every smoothed level has even sides (it is coarsened again);
// the coarsest may have odd ones (10x10 -> 5x5), as it is solved densely.
// Where the fine level has <= 64 cells (8x8) the block is one warp, and
// the fine level runs on it as on a block. Each thread owns whole 2x2
// tiles of cells (64x64: 256 threads, 4 fine tiles each), so restriction
// is local to a thread and a tile's 12 edge neighbours come in as 2-float
// loads. Four tiles a thread give each warp independent loads to overlap;
// on the H100 this layout beat 512 threads of 2 tiles, one 1024-thread
// block an SM, and the 16x16 level on the warp.
//
// What bounds it on the H100: latency. A CG iteration at 64x64 is ~0.4
// MFLOP of dependent stencil passes between block barriers, far below the
// SM's issue rate; the time goes to barrier and shared-memory latency.
// The design attacks both:
// - Two resident blocks per SM (64x64), so one member's barrier stalls
//   overlap the other's work. The footprint is cut to 114,976 bytes
//   (<= 113 KB) by keeping x, p and the metric weight w in registers,
//   writing the best iterate straight to p_out, keeping the fine diagonal
//   implicit (unit), and aliasing the coarse levels' smoothing
//   temporaries into the fine one. Budget at 64x64, in floats:
//     fine TX, TY (TY padded to 64 wide)          4,032 + 4,096
//     fine P (p; the V-cycle's x), R (r), T       3 x 4,096
//     levels 32^2, 16^2, 8^2: TX, TY, D, 1/D, b, x       7,424 + 560
//     coarsest 4x4: b, x, inverse (transposed)      288
//     reduction slots (2 x 8 warps x 2)              32
//     total 28,744 floats = 114,976 bytes
//   Reciprocal coarse diagonals are computed once per launch.
// - 16 barriers an iteration instead of 39: the V-cycle's zero-start
//   sweep is folded into the next sweep's neighbour reads (t = omega b/d
//   needs no barrier), residual and restriction are one pass, the
//   prolongation is folded into the following sweep's reads, reductions
//   take one barrier (each warp writes its partials, every thread sums
//   them, two alternating slots), and levels of <= 64 cells with the
//   coarsest solve run on one warp with __syncwarp only. At 64x64 the
//   count is matvec reduction 1, r update 1, V-cycle 12 (6 down, 1 after
//   the warp levels, 5 up), rz/rr reduction 1, p update 1.
// - No integer division and no IEEE division in the iteration: tile
//   coordinates come from constants, and the coarse sweeps multiply by
//   the stored reciprocal diagonal. Multiplying by 1/d instead of dividing
//   by d, and the block's summation order, change float32 rounding only.
// The right-hand side q is read from device memory at window ends; the
// other device-memory traffic is one read of the hierarchy, p0 and w and
// the write of the best iterate.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "grids.cuh"
#include "pcg_tile.cuh"

namespace {

// Compile-time geometry and shared-memory layout (floats) of one grid, and
// the smoother; the layout matches ops/pressure.py `smem_bytes` for both
// smoothers.
template <int NX, int NY, bool CHEB = false, bool UNIT = true>
struct Geo {
  static constexpr bool kCheb = CHEB;
  static constexpr bool kUnit = UNIT;  // the fine diagonal is 1 and not stored
  static constexpr int L = count_levels(NX, NY);
  static constexpr int LC = L - 1;  // coarsest level: dense solve
  __host__ __device__ static constexpr int n(int l) { return NX >> l; }
  __host__ __device__ static constexpr int m(int l) { return NY >> l; }
  __host__ __device__ static constexpr int cells(int l) { return n(l) * m(l); }
  __host__ __device__ static constexpr int first_warp_level() {
    int l = 0;
    while (l < LC && cells(l) > 64) ++l;
    return l;
  }
  // Levels LW.. run on warp 0; the fine level always runs on the block.
  static constexpr int LW = first_warp_level() > 1 ? first_warp_level() : 1;
  static constexpr int TILES0 = cells(0) / 4;
  static constexpr int THREADS = TILES0 > 256 ? 256 : (TILES0 + 31) / 32 * 32;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int TPT = (TILES0 + THREADS - 1) / THREADS;  // fine tiles a thread
  __host__ __device__ static constexpr int vec(int l) { return r4(cells(l)); }
  __host__ __device__ static constexpr int faces(int l) { return r4((n(l) - 1) * m(l)); }
  __host__ __device__ static constexpr int level_size(int l) {
    return l == 0 ? faces(0) + (UNIT ? 4 : 6) * vec(0)      // TX, TY, P, R, T[, D, 1/D]
           : l < LC ? faces(l) + 5 * vec(l)                 // TX, TY, D, 1/D, B, X
                    : 2 * vec(l) + r4(cells(l) * cells(l));  // B, X, inverse^T
  }
  __host__ __device__ static constexpr int base(int l) {
    int o = 0;
    for (int k = 0; k < l; ++k) o += level_size(k);
    return o;
  }
  __host__ __device__ static constexpr int t_offset(int l) {
    int o = 0;
    for (int k = 1; k < l; ++k) o += vec(k);
    return o;
  }
  static constexpr int RED = base(L);
  static constexpr int FLOATS = RED + 4 * WARPS;
  static constexpr int BYTES = 4 * FLOATS;
  // Two blocks an SM where two layouts fit the SM's 228 KB (1 KB of each
  // block reserved), else one.
  static constexpr int MIN_BLOCKS = 2 * (BYTES + 1024) <= 228 * 1024 ? 2 : 1;
  static_assert(NX % 2 == 0 && NY % 2 == 0 && L >= 2 && L <= kMaxLevels,
                "a tiled fine level and a coarse level");
  static_assert(t_offset(LC) <= vec(0), "coarse temporaries fit in the fine T vector");
};

// The arrays of level l in shared memory.
template <class G, int l>
struct Lvl {
  static constexpr int n = G::n(l), m = G::m(l);
  __device__ static float* TX(float* sh) { return sh + G::base(l); }
  __device__ static float* TY(float* sh) { return TX(sh) + G::faces(l); }
  __device__ static float* D(float* sh) {  // after T on the fine level
    if constexpr (l == 0) return TY(sh) + 4 * G::vec(0);
    else return TY(sh) + G::vec(l);
  }
  __device__ static float* RD(float* sh) { return D(sh) + G::vec(l); }
  __device__ static float* B(float* sh) {
    if constexpr (l == 0) return TY(sh) + 2 * G::vec(0);  // R
    else if constexpr (l == G::LC) return sh + G::base(l);
    else return RD(sh) + G::vec(l);
  }
  __device__ static float* X(float* sh) {
    if constexpr (l == 0) return TY(sh) + G::vec(0);  // P
    else return B(sh) + G::vec(l);
  }
  __device__ static float* T(float* sh) {  // coarse temporaries alias the fine T
    return Lvl<G, 0>::TY(sh) + 3 * G::vec(0) + G::t_offset(l);
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

template <int n, int m>
__device__ __forceinline__ Tile gather(const float* v, int I, int J) {
  const int o = 2 * I * m + 2 * J;
  Tile t;
  own<m>(v, I, J, t.v);
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

// (A v) on the tile's four cells (`tile_stencil`). TX is (n-1, m); TY is
// padded to (n, m) with a zero last column.
template <int n, int m, bool UNIT>
__device__ __forceinline__ void stencil(const float* TX, const float* TY, const float* D, int I,
                                        int J, const Tile& t, float out[4]) {
  const int o = 2 * I * m + 2 * J;
  const float2 z2 = make_float2(0.0f, 0.0f);
  const float2 xu = I > 0 ? ld2(TX + o - m) : z2;
  const float2 xc = ld2(TX + o);
  const float2 xd = I < n / 2 - 1 ? ld2(TX + o + m) : z2;
  const float2 y0 = ld2(TY + o), y1 = ld2(TY + o + m);
  const float yl0 = J > 0 ? TY[o - 1] : 0.0f;
  const float yl1 = J > 0 ? TY[o + m - 1] : 0.0f;
  float d[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  if constexpr (!UNIT) own<m>(D, I, J, d);
  tile_stencil(d, xu, xc, xd, y0, y1, yl0, yl1, t, out);
}

// f(k, I, J) for each tile of an n x m level that worker w of NW owns:
// tile w + k NW, row-major over the (n/2, m/2) tile grid.
template <int n, int m, int NW, class F>
__device__ __forceinline__ void tiles(int w, F f) {
  constexpr int TJ = m / 2, NT = (n / 2) * TJ;
#pragma unroll
  for (int k = 0; k < (NT + NW - 1) / NW; ++k) {
    const int T = w + k * NW;
    if (NT % NW == 0 || T < NT) f(k, T / TJ, T % TJ);
  }
}

// Own-cell reciprocal diagonal of level l (1 on the unit fine level).
template <class G, int l, int m>
__device__ __forceinline__ void own_rd(float* sh, int I, int J, float rd[4]) {
  if constexpr (l == 0 && G::kUnit) {
    rd[0] = rd[1] = rd[2] = rd[3] = 1.0f;
  } else {
    own<m>(Lvl<G, l>::RD(sh), I, J, rd);
  }
}

// Pre-smoothing from x = 0: the first sweep is folded into the second
// one's reads (`first_sweep`, `second_sweep_down`).
template <class G, int l, int NW>
__device__ __forceinline__ void smooth_down(float* sh, int w) {
  using V = Lvl<G, l>;
  constexpr int n = V::n, m = V::m;
  constexpr bool unit = l == 0 && G::kUnit;
  tiles<n, m, NW>(w, [&](int, int I, int J) {
    const Tile b = gather<n, m>(V::B(sh), I, J);
    Tile rdt;
    if constexpr (!unit) rdt = gather<n, m>(V::RD(sh), I, J);
    const Tile t = first_sweep<G::kCheb, unit>(b, rdt);
    float At[4], rd[4], x[4];
    stencil<n, m, unit>(V::TX(sh), V::TY(sh), V::D(sh), I, J, t, At);
    own_rd<G, l, m>(sh, I, J, rd);
    second_sweep_down<G::kCheb>(t, b, At, rd, x);
    put<m>(V::X(sh), I, J, x);
  });
}

// Residual b - A x of level l, restricted by 2x2 block sums into level
// l+1's right-hand side.
template <class G, int l, int NW>
__device__ __forceinline__ void restrict_residual(float* sh, int w) {
  using V = Lvl<G, l>;
  constexpr int n = V::n, m = V::m;
  float* Bc = Lvl<G, l + 1>::B(sh);
  tiles<n, m, NW>(w, [&](int, int I, int J) {
    const Tile x = gather<n, m>(V::X(sh), I, J);
    float Ax[4], b[4];
    stencil<n, m, l == 0 && G::kUnit>(V::TX(sh), V::TY(sh), V::D(sh), I, J, x, Ax);
    own<m>(V::B(sh), I, J, b);
    Bc[I * (m / 2) + J] = restrict_tile(b, Ax);
  });
}

// Coarsest level: x = inverse @ b, one row a lane.
template <class G, int NW>
__device__ __forceinline__ void coarse_solve(float* sh, int w) {
  using V = Lvl<G, G::LC>;
  constexpr int nc = V::n * V::m;
  const float* b = V::B(sh);
  const float* At = V::X(sh) + G::vec(G::LC);
  for (int r = w; r < nc; r += NW) {
    float acc = 0.0f;
#pragma unroll 5
    for (int k = 0; k < nc; ++k) acc += At[k * nc + r] * b[k];
    V::X(sh)[r] = acc;
  }
}

// First post-smoothing sweep after the coarse correction: x + omega_c
// e(parent) is formed at every cell read (`prolong`), and the sweep's t
// (`first_sweep_up`) goes to the level's temporary.
template <class G, int l, int NW>
__device__ __forceinline__ void smooth_up_first(float* sh, int w) {
  using V = Lvl<G, l>;
  constexpr int n = V::n, m = V::m, mc = m / 2;
  const float* E = Lvl<G, l + 1>::X(sh);
  tiles<n, m, NW>(w, [&](int, int I, int J) {
    Tile x = gather<n, m>(V::X(sh), I, J);
    prolong(x, [&](int dI, int dJ) { return E[(I + dI) * mc + J + dJ]; }, I > 0,
            I < n / 2 - 1, J > 0, J < mc - 1);
    float Ax[4], b[4], rd[4], t[4];
    stencil<n, m, l == 0 && G::kUnit>(V::TX(sh), V::TY(sh), V::D(sh), I, J, x, Ax);
    own<m>(V::B(sh), I, J, b);
    own_rd<G, l, m>(sh, I, J, rd);
    first_sweep_up<G::kCheb>(x, b, Ax, rd, t);
    put<m>(V::T(sh), I, J, t);
  });
}

// Second post-smoothing sweep; out(k, I, J, x) receives the result. The
// Chebyshev step also needs the sweep's start x0 = x + omega_c e(parent) on
// the thread's own cells: the same thread owns the same tiles in both
// sweeps and neither X nor the parent's iterate has been written since,
// so it is formed again from them, which takes neither a shared array nor
// registers held across the barrier.
template <class G, int l, int NW, class Out>
__device__ __forceinline__ void smooth_up_second(float* sh, int w, Out out) {
  using V = Lvl<G, l>;
  constexpr int n = V::n, m = V::m;
  tiles<n, m, NW>(w, [&](int k, int I, int J) {
    const Tile t = gather<n, m>(V::T(sh), I, J);
    float At[4], b[4], rd[4], x[4];
    stencil<n, m, l == 0 && G::kUnit>(V::TX(sh), V::TY(sh), V::D(sh), I, J, t, At);
    own<m>(V::B(sh), I, J, b);
    own_rd<G, l, m>(sh, I, J, rd);
    float x0[4], e = 0.0f;
    if constexpr (G::kCheb) {
      own<m>(V::X(sh), I, J, x0);
      e = Lvl<G, l + 1>::X(sh)[I * (m / 2) + J];
    }
    second_sweep_up<G::kCheb>(t, b, At, rd, x0, e, x);
    out(k, I, J, x);
  });
}

template <class G, int l>
__device__ __forceinline__ void down_block(float* sh) {
  if constexpr (l < G::LW) {
    smooth_down<G, l, G::THREADS>(sh, threadIdx.x);
    __syncthreads();
    restrict_residual<G, l, G::THREADS>(sh, threadIdx.x);
    __syncthreads();
    down_block<G, l + 1>(sh);
  }
}

// Levels LW.. (<= 64 cells) and the coarsest solve, on warp 0 alone.
template <class G, int l>
__device__ __forceinline__ void warp_levels(float* sh, int lane) {
  if constexpr (l == G::LC) {
    coarse_solve<G, 32>(sh, lane);
    __syncwarp();
  } else {
    using V = Lvl<G, l>;
    smooth_down<G, l, 32>(sh, lane);
    __syncwarp();
    restrict_residual<G, l, 32>(sh, lane);
    __syncwarp();
    warp_levels<G, l + 1>(sh, lane);
    smooth_up_first<G, l, 32>(sh, lane);
    __syncwarp();
    smooth_up_second<G, l, 32>(sh, lane, [&](int, int I, int J, const float* x) {
      put<V::m>(V::X(sh), I, J, x);
    });
    __syncwarp();
  }
}

template <class G, int l>
__device__ __forceinline__ void up_block(float* sh) {
  if constexpr (l >= 1) {
    using V = Lvl<G, l>;
    smooth_up_first<G, l, G::THREADS>(sh, threadIdx.x);
    __syncthreads();
    smooth_up_second<G, l, G::THREADS>(sh, threadIdx.x, [&](int, int I, int J, const float* x) {
      put<V::m>(V::X(sh), I, J, x);
    });
    __syncthreads();
    up_block<G, l - 1>(sh);
  }
}

// z = V-cycle(r) from a zero initial guess; r is the fine R vector, z
// lands in the owning threads' registers. Clobbers P and T.
template <class G>
__device__ __forceinline__ void vcycle(float* sh, float (&z)[G::TPT][4]) {
  down_block<G, 0>(sh);
  if (threadIdx.x < 32) warp_levels<G, G::LW>(sh, threadIdx.x);
  __syncthreads();
  up_block<G, G::LW - 1>(sh);
  smooth_up_first<G, 0, G::THREADS>(sh, threadIdx.x);
  __syncthreads();
  smooth_up_second<G, 0, G::THREADS>(sh, threadIdx.x, [&](int k, int, int, const float* x) {
#pragma unroll
    for (int c = 0; c < 4; ++c) z[k][c] = x[c];
  });
}

// Block sums of two values with one barrier: each warp writes its
// partials, every thread adds them up in the same order. Consecutive calls
// alternate between two slots, so a slot is rewritten only after a barrier
// that follows every read of it.
template <int WARPS>
struct Reducer {
  float2* buf;
  int slot;
  __device__ __forceinline__ float2 sum(float a, float b) {
    a = warp_sum(a);
    b = warp_sum(b);
    float2* s = buf + slot * WARPS;
    slot ^= 1;
    if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = make_float2(a, b);
    __syncthreads();
    float2 t = s[0];
#pragma unroll
    for (int k = 1; k < WARPS; ++k) {
      const float2 u = s[k];
      t.x += u.x;
      t.y += u.y;
    }
    return t;
  }
};

struct HierPtrs {  // per level: TX (B, n-1, m), TY (B, n, m-1), diag (B, n, m)
  const float* tx[kMaxLevels];
  const float* ty[kMaxLevels];
  const float* d[kMaxLevels];
  const float* ainv;  // (B, nc, nc)
};

// Member b's hierarchy into shared memory: TY padded to m wide, coarse
// diagonals with their reciprocals, the coarsest inverse transposed.
template <class G, int l>
__device__ __forceinline__ void load_level(float* sh, const HierPtrs& h, int b) {
  using V = Lvl<G, l>;
  constexpr int n = V::n, m = V::m, T = G::THREADS;
  if constexpr (l < G::LC) {
    const float* tx = h.tx[l] + (size_t)b * (n - 1) * m;
    for (int k = threadIdx.x; k < (n - 1) * m; k += T) V::TX(sh)[k] = tx[k];
    const float* ty = h.ty[l] + (size_t)b * n * (m - 1);
    for (int k = threadIdx.x; k < n * m; k += T) {
      const int i = k / m, j = k - i * m;
      V::TY(sh)[k] = j < m - 1 ? ty[i * (m - 1) + j] : 0.0f;
    }
    if constexpr (l > 0 || !G::kUnit) {
      const float* d = h.d[l] + (size_t)b * n * m;
      for (int k = threadIdx.x; k < n * m; k += T) {
        const float v = d[k];
        V::D(sh)[k] = v;
        V::RD(sh)[k] = 1.0f / v;
      }
    }
    load_level<G, l + 1>(sh, h, b);
  } else {
    constexpr int nc = n * m;
    const float* a = h.ainv + (size_t)b * nc * nc;
    float* At = V::X(sh) + G::vec(l);
    for (int k = threadIdx.x; k < nc * nc; k += T) {
      const int r = k / nc, c = k - r * nc;
      At[c * nc + r] = a[k];
    }
  }
}

template <int NX, int NY, bool CHEB, bool UNIT>
__global__ void __launch_bounds__(Geo<NX, NY, CHEB, UNIT>::THREADS,
                                  Geo<NX, NY, CHEB, UNIT>::MIN_BLOCKS)
pressure_pcg_kernel(HierPtrs h, const float* __restrict__ q_g, const float* __restrict__ p0_g,
                    const float* __restrict__ w_g, float* __restrict__ p_out,
                    int* __restrict__ it_out, float* __restrict__ rel_out, float tol, int maxiter,
                    int restart_every, int patience) {
  using G = Geo<NX, NY, CHEB, UNIT>;
  using F = Lvl<G, 0>;
  constexpr int T = G::THREADS, TPT = G::TPT;
  extern __shared__ float4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t off = (size_t)b * NX * NY;
  const float* q = q_g + off;
  float* xb = p_out + off;  // the best iterate lives here
  float* P = F::X(sh);
  float* R = F::B(sh);
  float* Tv = F::T(sh);
  const float* TX = F::TX(sh);
  const float* TY = F::TY(sh);
  const float* Df = UNIT ? nullptr : F::D(sh);
  Reducer<G::WARPS> red{reinterpret_cast<float2*>(sh + G::RED), 0};
  auto fine = [&](auto f) { tiles<NX, NY, T>(tid, f); };

  load_level<G, 0>(sh, h, b);
  float x[TPT][4] = {}, p[TPT][4] = {}, w[TPT][4] = {}, z[TPT][4] = {};
  fine([&](int k, int I, int J) {
    own<NY>(p0_g + off, I, J, x[k]);
    own<NY>(w_g + off, I, J, w[k]);
    put<NY>(xb, I, J, x[k]);
    put<NY>(Tv, I, J, x[k]);
  });
  __syncthreads();

  // r = q - A x from x in T, into R; adds the thread's (w r)^2 to wr2 and
  // (w q)^2 to wq2.
  auto residual = [&](float& wr2, float& wq2) {
    fine([&](int k, int I, int J) {
      const Tile xt = gather<NX, NY>(Tv, I, J);
      float Ax[4], qv[4], r[4];
      stencil<NX, NY, UNIT>(TX, TY, Df, I, J, xt, Ax);
      own<NY>(q, I, J, qv);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        r[c] = qv[c] - Ax[c];
        const float wr = w[k][c] * r[c], wq = w[k][c] * qv[c];
        wr2 += wr * wr;
        wq2 += wq * wq;
      }
      put<NY>(R, I, J, r);
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
      fine([&](int k, int I, int J) { put<NY>(Tv, I, J, x[k]); });
      __syncthreads();
      float unused = 0.0f;
      residual(unused, unused);
      __syncthreads();
    }
    vcycle<G>(sh, z);
    // The first window's direction is Minv(r0), which is this z; a
    // steepest-descent window restarts from z too.
    const bool restart = use_sd || first;
    float prz = 0.0f, prr = 0.0f;
    fine([&](int k, int I, int J) {
      float r[4];
      own<NY>(R, I, J, r);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        prz += r[c] * z[k][c];
        const float wr = w[k][c] * r[c];
        prr += wr * wr;
        if (restart) p[k][c] = z[k][c];
      }
      put<NY>(P, I, J, p[k]);
    });
    float2 s = red.sum(prz, prr);
    float rz = s.x, rr = s.y;
    const float beta_mask = use_sd ? 0.0f : 1.0f;
    // Once a member's rr <= tol2 the window's remaining steps are no-ops
    // (alpha = 0, state kept), so they are skipped.
    for (int it = 0; it < restart_every && rr > tol2; ++it) {
      float Ap[TPT][4] = {};
      float ppap = 0.0f;
      fine([&](int k, int I, int J) {
        const Tile pt = gather<NX, NY>(P, I, J);
        stencil<NX, NY, UNIT>(TX, TY, Df, I, J, pt, Ap[k]);
#pragma unroll
        for (int c = 0; c < 4; ++c) ppap += p[k][c] * Ap[k][c];
      });
      const float pAp = red.sum(ppap, 0.0f).x;
      const float alpha = rz / (pAp == 0.0f ? 1.0f : pAp);
      fine([&](int k, int I, int J) {
        float r[4];
        own<NY>(R, I, J, r);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          x[k][c] = x[k][c] + alpha * p[k][c];
          r[c] = r[c] - alpha * Ap[k][c];
        }
        put<NY>(R, I, J, r);
      });
      __syncthreads();
      vcycle<G>(sh, z);
      prz = prr = 0.0f;
      fine([&](int k, int I, int J) {
        float r[4];
        own<NY>(R, I, J, r);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          prz += r[c] * z[k][c];
          const float wr = w[k][c] * r[c];
          prr += wr * wr;
        }
      });
      s = red.sum(prz, prr);
      const float beta = beta_mask * s.x / (rz == 0.0f ? 1.0f : rz);
      fine([&](int k, int I, int J) {
#pragma unroll
        for (int c = 0; c < 4; ++c) p[k][c] = z[k][c] + beta * p[k][c];
        put<NY>(P, I, J, p[k]);
      });
      rz = s.x;
      rr = s.y;
      __syncthreads();
    }
    // True residual of the window's iterate (residual replacement).
    fine([&](int k, int I, int J) { put<NY>(Tv, I, J, x[k]); });
    __syncthreads();
    float wr2n = 0.0f, unused = 0.0f;
    residual(wr2n, unused);
    const float rr_new = red.sum(wr2n, 0.0f).x;
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
  if (tid == 0) {
    it_out[b] = kk;
    rel_out[b] = sqrtf(rr_best / fmaxf(bb, FLT_MIN));
  }
}

template <int NX, int NY, bool CHEB, bool UNIT>
int launch(const float* const* lv, int n_levels, const float* ainv, const float* q,
           const float* p0, const float* w, float* p_out, int* it_out, float* rel_out, int B,
           float tol, int maxiter, int restart_every, int patience, cudaStream_t stream) {
  using G = Geo<NX, NY, CHEB, UNIT>;
  if (n_levels != G::L || (!UNIT && lv[2] == nullptr)) return (int)cudaErrorInvalidValue;
  HierPtrs h{};
  for (int l = 0; l < G::L; ++l) {
    h.tx[l] = lv[3 * l];
    h.ty[l] = lv[3 * l + 1];
    h.d[l] = lv[3 * l + 2];
  }
  h.ainv = ainv;
  auto kern = pressure_pcg_kernel<NX, NY, CHEB, UNIT>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (e != cudaSuccess) return (int)e;
  kern<<<B, G::THREADS, G::BYTES, stream>>>(h, q, p0, w, p_out, it_out, rel_out, tol, maxiter,
                                            restart_every, patience);
  return (int)cudaGetLastError();
}

template <int NX, int NY, bool CHEB, bool UNIT>
int info(int* out) {
  using G = Geo<NX, NY, CHEB, UNIT>;
  auto kern = pressure_pcg_kernel<NX, NY, CHEB, UNIT>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  cudaFuncAttributes a{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kern);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, G::THREADS, G::BYTES);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = G::BYTES;
  out[3] = G::THREADS;
  out[4] = blocks;
  return (int)e;
}

}  // namespace

// The variants of one grid: smoother (cheb 0 or 1) by fine diagonal (unit
// 1: the scaled system's, not read; 0: read from lv[2]).
#define HM_VARIANTS(a, b, call)                                                   \
  if (Nx == a && Ny == b) {                                                       \
    if (cheb) return unit ? call(a, b, true, true) : call(a, b, true, false);    \
    return unit ? call(a, b, false, true) : call(a, b, false, false);            \
  }

// lv: 3 * n_levels pointers, per level TX, TY, diag, each (B, ...) float32.
// The level-0 diag is read only where unit is 0 and may be null otherwise.
// cheb: 0 for the damped-Jacobi smoother, 1 for the Chebyshev one. A grid
// this library was not built for is refused.
extern "C" int hm_pressure_solve(const float* const* lv, const float* ainv, const float* q,
                                 const float* p0, const float* w, float* p_out, int* it_out,
                                 float* rel_out, int B, int Nx, int Ny, int n_levels, float tol,
                                 int maxiter, int restart_every, int patience, int cheb,
                                 int unit, void* stream) {
#define HM_LAUNCH(a, b, c, u)                                                               \
  launch<a, b, c, u>(lv, n_levels, ainv, q, p0, w, p_out, it_out, rel_out, B, tol, maxiter, \
                     restart_every, patience, (cudaStream_t)stream)
#define HM_CASE(a, b) HM_VARIANTS(a, b, HM_LAUNCH)
  HM_FOR_GRIDS(HM_CASE)
#undef HM_CASE
#undef HM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// out: registers a thread, local (stack and spill) bytes a thread, dynamic
// shared bytes, threads a block, resident blocks an SM, of the instantiation
// for the grid, the smoother (cheb 0 or 1) and the fine diagonal (unit 0 or
// 1).
extern "C" int hm_pressure_info(int Nx, int Ny, int cheb, int unit, int* out) {
#define HM_INFO(a, b, c, u) info<a, b, c, u>(out)
#define HM_CASE(a, b) HM_VARIANTS(a, b, HM_INFO)
  HM_FOR_GRIDS(HM_CASE)
#undef HM_CASE
#undef HM_INFO
  return (int)cudaErrorInvalidValue;
}
