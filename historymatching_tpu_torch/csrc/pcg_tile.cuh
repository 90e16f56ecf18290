// Kernel P's arithmetic on one 2x2 tile, shared by its three variants:
// shared memory (pressure_pcg.cu), device memory (pressure_pcg_gm.cu) and
// a thread-block cluster a member (pressure_pcg_cl.cu). Here are the
// smoother's constants, the level count, the warp sum, and the float32
// operations of the stencil, the smoothing sweeps, the restriction and the
// prolongation, each in P's order. A variant keeps only its partition and
// memory placement: where a tile's values and faces come from, and where
// its results go.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kOmega = 0.7f;   // damped Jacobi's weight
constexpr float kOmegaC = 1.4f;  // the coarse correction's weight
constexpr int kMaxLevels = 8;

// Degree-2 Chebyshev on D^-1 A over [0.5, 2.0] (ops/multigrid.py `_cheb`,
// coefficients from its three-term recurrence, in double, then rounded):
// x1 = x0 + D^-1 (b - A x0) / theta, then
// x2 = x1 + rho1 rho0 (x1 - x0) + (2 rho1 / delta) D^-1 (b - A x1).
struct ChebCoef {
  static constexpr double lmin = 0.5, lmax = 2.0;
  static constexpr double theta = 0.5 * (lmax + lmin), delta = 0.5 * (lmax - lmin);
  static constexpr double sigma = theta / delta, rho0 = 1.0 / sigma;
  static constexpr double rho1 = 1.0 / (2.0 * sigma - rho0);
};
constexpr float kChebFirst = (float)(1.0 / ChebCoef::theta);
constexpr float kChebMom = (float)(ChebCoef::rho1 * ChebCoef::rho0);
constexpr float kChebStep = (float)(2.0 * ChebCoef::rho1 / ChebCoef::delta);

// The first sweep's step: omega, or 1 / theta.
__host__ __device__ constexpr float first_step(bool cheb) { return cheb ? kChebFirst : kOmega; }

// Levels of a grid's hierarchy (ops/multigrid.py `n_levels`).
__host__ __device__ constexpr int count_levels(int nx, int ny) {
  int n = 1;
  while (nx % 2 == 0 && ny % 2 == 0 && nx > 4 && ny > 4) {
    nx /= 2;
    ny /= 2;
    ++n;
  }
  return n;
}

__host__ __device__ constexpr int r4(int v) { return (v + 3) / 4 * 4; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A vector on a 2x2 tile (I, J) and its 8 edge neighbours, 0 outside the grid.
enum { C0, C1, C2, C3, U0, U1, D0, D1, L0, L1, R0, R1, NTILE };
struct Tile {
  float v[NTILE];
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// (A v) on the tile's four cells in the JAX package's term order
// (ops/stencil.py): d v - TX[i] v[i+1] - TX[i-1] v[i-1] - TY[j] v[j+1] -
// TY[j-1] v[j-1]. The faces: xc below the tile's two rows' first row, xu
// above it, xd below its second row; y0, y1 right of each row's two cells,
// yl0, yl1 left of them. A face outside the grid has coefficient and value
// 0, so its term subtracts an exact 0.
__device__ __forceinline__ void tile_stencil(const float d[4], float2 xu, float2 xc, float2 xd,
                                             float2 y0, float2 y1, float yl0, float yl1,
                                             const Tile& t, float out[4]) {
  const float* v = t.v;
  out[0] = d[0] * v[C0] - xc.x * v[C2] - xu.x * v[U0] - y0.x * v[C1] - yl0 * v[L0];
  out[1] = d[1] * v[C1] - xc.y * v[C3] - xu.y * v[U1] - y0.y * v[R0] - y0.x * v[C0];
  out[2] = d[2] * v[C2] - xd.x * v[D0] - xc.x * v[C0] - y1.x * v[C3] - yl1 * v[L1];
  out[3] = d[3] * v[C3] - xd.y * v[D1] - xc.y * v[C1] - y1.y * v[R1] - y1.x * v[C2];
}

// Pre-smoothing from x = 0: the first sweep's t = omega b / d (Chebyshev:
// b / (theta d)) on the tile and its neighbours, which the second sweep
// reads; `rd` is not read on the unit fine level.
template <bool CHEB, bool UNIT>
__device__ __forceinline__ Tile first_sweep(const Tile& b, const Tile& rd) {
  Tile t;
#pragma unroll
  for (int c = 0; c < NTILE; ++c) {
    if constexpr (UNIT)
      t.v[c] = first_step(CHEB) * b.v[c];
    else
      t.v[c] = first_step(CHEB) * b.v[c] * rd.v[c];
  }
  return t;
}

// The second pre-smoothing sweep from t: x = t + omega (b - A t) / d
// (Chebyshev: the recurrence with x0 = 0).
template <bool CHEB>
__device__ __forceinline__ void second_sweep_down(const Tile& t, const Tile& b, const float At[4],
                                                  const float rd[4], float x[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (CHEB)
      x[c] = t.v[c] + (kChebMom * t.v[c] + kChebStep * (b.v[c] - At[c]) * rd[c]);
    else
      x[c] = t.v[c] + kOmega * (b.v[c] - At[c]) * rd[c];
  }
}

// The residual b - A x of a tile, summed over its 2x2 cells: its parent's
// right-hand side.
__device__ __forceinline__ float restrict_tile(const float b[4], const float Ax[4]) {
  return ((b[0] - Ax[0]) + (b[1] - Ax[1])) + ((b[2] - Ax[2]) + (b[3] - Ax[3]));
}

// x + omega_c e(parent) on the tile and the neighbours that exist
// (prolongation by injection); e(dI, dJ) reads the parent's correction at
// the tile's parent offset by (dI, dJ), only for a neighbour that exists.
template <class E>
__device__ __forceinline__ void prolong(Tile& x, E e, bool up, bool dn, bool left, bool right) {
  const float e0 = e(0, 0);
#pragma unroll
  for (int c = C0; c <= C3; ++c) x.v[c] = x.v[c] + kOmegaC * e0;
  if (up) {
    const float eu = e(-1, 0);
    x.v[U0] = x.v[U0] + kOmegaC * eu;
    x.v[U1] = x.v[U1] + kOmegaC * eu;
  }
  if (dn) {
    const float ed = e(1, 0);
    x.v[D0] = x.v[D0] + kOmegaC * ed;
    x.v[D1] = x.v[D1] + kOmegaC * ed;
  }
  if (left) {
    const float el = e(0, -1);
    x.v[L0] = x.v[L0] + kOmegaC * el;
    x.v[L1] = x.v[L1] + kOmegaC * el;
  }
  if (right) {
    const float er = e(0, 1);
    x.v[R0] = x.v[R0] + kOmegaC * er;
    x.v[R1] = x.v[R1] + kOmegaC * er;
  }
}

// The first post-smoothing sweep from the corrected x: t = x + omega (b -
// A x) / d (Chebyshev: step 1 / theta).
template <bool CHEB>
__device__ __forceinline__ void first_sweep_up(const Tile& x, const float b[4], const float Ax[4],
                                               const float rd[4], float t[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) t[c] = x.v[c] + first_step(CHEB) * (b[c] - Ax[c]) * rd[c];
}

// The second post-smoothing sweep from t: Jacobi x = t + omega (b - A t)
// / d; Chebyshev the recurrence from the sweep's start x0 = x + omega_c e,
// formed again here from the level's iterate x0 and the parent's e on the
// tile (read only by Chebyshev).
template <bool CHEB>
__device__ __forceinline__ void second_sweep_up(const Tile& t, const float b[4],
                                                const float At[4], const float rd[4],
                                                float x0[4], float e, float x[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (CHEB) {
      x0[c] = x0[c] + kOmegaC * e;
      x[c] = t.v[c] + (kChebMom * (t.v[c] - x0[c]) + kChebStep * (b[c] - At[c]) * rd[c]);
    } else {
      x[c] = t.v[c] + kOmega * (b[c] - At[c]) * rd[c];
    }
  }
}

}  // namespace
