// Kernel P: the whole restarted multigrid-preconditioned CG solve of the
// Jacobi-scaled TPFA pressure system, for every ensemble member.
//
// Replaces: historymatching_tpu/ops/pressure_pallas.py,
//   pressure_solve_pallas (pressure_pcg_kernel), and its multi-member
//   layouts _batched and _packed, which compute the same per-member solve.
//   The semantics are those of historymatching_tpu/ops/cg.py `pcg` (each
//   member stops on its own), with the V-cycle of ops/multigrid.py
//   `vcycle_apply`: nu = 2 damped-Jacobi sweeps (omega 0.7) before and
//   after, 2x2 block-sum restriction, prolongation by injection times
//   omega_c = 1.4, and a dense coarsest solve with the member's
//   precomputed inverse.
//
// One thread block per member, 512 threads (fewer on small grids).
//
// What bounds it on the H100: barriers and latency. Per CG iteration at
// 64x64 the block does ~11 fine-grid stencil passes (matvec, 4 smoothing
// sweeps, residual, ...) and ~3 block reductions, each followed by a
// __syncthreads: ~25 barriers an iteration against ~0.4 MFLOP of work.
// Device-memory traffic would dominate if the operator and work vectors
// were re-read from HBM each pass (~100 KB a pass), so the design keeps the
// whole solve in shared memory: the member's hierarchy and coarse inverse
// are copied in once, and every vector lives there until the result is
// written. Budget at 64x64 (5 levels, coarsest 4x4), in floats:
//   hierarchy TX,TY,diag over 5 levels + 16x16 inverse   16,376
//   fine vectors x, r, p, z, Ap, x_best, smoothing tmp    7 x 4,096 = 28,672
//   coarse levels b, x, tmp (32^2 + 16^2 + 8^2 + 4^2)     3 x 1,360 =  4,080
//   reduction scratch                                          64
//   total 49,192 floats = 196,768 bytes <= 232,448 (227 KB)
// so one block fits an SM (opt-in above 48 KB via cudaFuncSetAttribute).
// The right-hand side q and the metric weight w are read from device
// memory (L1/L2) where used. The grids the repository uses (64x64,
// 20x20 with a 5x5 coarsest level, 16x16) all fit; the host entry refuses
// a grid whose footprint does not.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 12;
constexpr int kMaxThreads = 512;
constexpr float kOmega = 0.7f;
constexpr float kOmegaC = 1.4f;

struct Level {
  const float* TX;  // (n-1, m)
  const float* TY;  // (n, m-1)
  const float* diag;  // (n, m)
  float* b;  // coarse levels only
  float* x;
  float* t;
  int n, m;
};

struct Ctx {
  Level lv[kMaxLevels];
  int L;
  const float* Ainv;  // (nc, nc)
  float* red;
};

// Footprint of the packed hierarchy (floats) and of the coarse-level
// vectors; the layout matches ops/pressure.py `pack_hierarchy`.
__host__ __device__ inline void sizes(int Nx, int Ny, int L, int* hier, int* coarse) {
  int n = Nx, m = Ny, h = 0, c = 0;
  for (int l = 0; l < L; ++l) {
    h += (n - 1) * m + n * (m - 1) + n * m;
    if (l > 0) c += 3 * n * m;
    if (l < L - 1) { n /= 2; m /= 2; }
  }
  h += (n * m) * (n * m);
  *hier = h;
  *coarse = c;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block; every thread gets the result. Called uniformly.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();  // the previous result in red[32] has been read
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float s = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
    s = warp_sum(s);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  return red[32];
}

// (A v)[idx] in the JAX package's term order (ops/stencil.py).
__device__ __forceinline__ float Av(const Level& L, const float* v, int idx) {
  const int m = L.m, i = idx / m, j = idx - i * m;
  float out = L.diag[idx] * v[idx];
  if (i < L.n - 1) out -= L.TX[idx] * v[idx + m];
  if (i > 0) out -= L.TX[idx - m] * v[idx - m];
  if (j < m - 1) out -= L.TY[i * (m - 1) + j] * v[idx + 1];
  if (j > 0) out -= L.TY[i * (m - 1) + j - 1] * v[idx - 1];
  return out;
}

// dst = src + omega (b - A src) / diag, one damped-Jacobi sweep.
__device__ void jacobi(const Level& L, const float* src, const float* b, float* dst) {
  const int n = L.n * L.m;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x)
    dst[idx] = src[idx] + kOmega * (b[idx] - Av(L, src, idx)) / L.diag[idx];
  __syncthreads();
}

// z = V-cycle(b0) from a zero initial guess. b0 and z are fine-grid
// vectors in shared memory; lv[0].t is the fine smoothing temporary.
__device__ void vcycle(Ctx& c, const float* b0, float* z) {
  for (int l = 0; l < c.L - 1; ++l) {
    Level& L = c.lv[l];
    const float* b = l == 0 ? b0 : L.b;
    float* x = l == 0 ? z : L.x;
    const int n = L.n * L.m;
    // First sweep from x = 0: t = omega (b - 0) / diag.
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x)
      L.t[idx] = 0.0f + kOmega * b[idx] / L.diag[idx];
    __syncthreads();
    jacobi(L, L.t, b, x);
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) L.t[idx] = b[idx] - Av(L, x, idx);
    __syncthreads();
    Level& C = c.lv[l + 1];
    const int nc = C.n * C.m;
    for (int I = threadIdx.x; I < nc; I += blockDim.x) {
      const int ic = I / C.m, jc = I - ic * C.m;
      const int f = 2 * ic * L.m + 2 * jc;
      C.b[I] = (L.t[f] + L.t[f + 1]) + (L.t[f + L.m] + L.t[f + L.m + 1]);
    }
    __syncthreads();
  }
  {
    Level& C = c.lv[c.L - 1];
    const int nc = C.n * C.m;
    for (int r = threadIdx.x; r < nc; r += blockDim.x) {
      const float* row = c.Ainv + (size_t)r * nc;
      float acc = 0.0f;
      for (int k = 0; k < nc; ++k) acc += row[k] * C.b[k];
      C.x[r] = acc;
    }
    __syncthreads();
  }
  for (int l = c.L - 2; l >= 0; --l) {
    Level& L = c.lv[l];
    const Level& C = c.lv[l + 1];
    const float* b = l == 0 ? b0 : L.b;
    float* x = l == 0 ? z : L.x;
    const int n = L.n * L.m;
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const int i = idx / L.m, j = idx - i * L.m;
      x[idx] = x[idx] + kOmegaC * C.x[(i >> 1) * C.m + (j >> 1)];
    }
    __syncthreads();
    jacobi(L, x, b, L.t);
    jacobi(L, L.t, b, x);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
pressure_pcg_kernel(const float* __restrict__ hier_g, const float* __restrict__ q_g,
                    const float* __restrict__ p0_g, const float* __restrict__ w_g,
                    float* __restrict__ p_out, int* __restrict__ it_out,
                    float* __restrict__ rel_out, int Nx, int Ny, int nlev, int hier_stride,
                    float tol, int maxiter, int restart_every, int patience) {
  extern __shared__ float sh[];
  const int b = blockIdx.x;
  const int n = Nx * Ny;
  const float* q = q_g + (size_t)b * n;
  const float* w = w_g + (size_t)b * n;

  int hier_n, coarse_n;
  sizes(Nx, Ny, nlev, &hier_n, &coarse_n);
  for (int k = threadIdx.x; k < hier_n; k += blockDim.x)
    sh[k] = hier_g[(size_t)b * hier_stride + k];

  Ctx c;
  c.L = nlev;
  float* cur = sh;
  int ln = Nx, lm = Ny;
  for (int l = 0; l < nlev; ++l) {
    Level& L = c.lv[l];
    L.n = ln;
    L.m = lm;
    L.TX = cur; cur += (ln - 1) * lm;
    L.TY = cur; cur += ln * (lm - 1);
    L.diag = cur; cur += ln * lm;
    if (l < nlev - 1) { ln /= 2; lm /= 2; }
  }
  c.Ainv = cur;
  cur = sh + hier_n;
  float* x = cur; cur += n;
  float* r = cur; cur += n;
  float* p = cur; cur += n;
  float* z = cur; cur += n;
  float* Ap = cur; cur += n;
  float* xb = cur; cur += n;
  c.lv[0].t = cur; cur += n;
  c.lv[0].b = c.lv[0].x = nullptr;
  for (int l = 1; l < nlev; ++l) {
    const int nl = c.lv[l].n * c.lv[l].m;
    c.lv[l].b = cur; cur += nl;
    c.lv[l].x = cur; cur += nl;
    c.lv[l].t = cur; cur += nl;
  }
  c.red = cur;
  const Level& F = c.lv[0];

  float part = 0.0f;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const float v = p0_g[(size_t)b * n + idx];
    x[idx] = v;
    xb[idx] = v;
    const float wq = w[idx] * q[idx];
    part += wq * wq;
  }
  const float bb = block_sum(part, c.red);  // also orders the copies above
  const float tol2 = (tol * tol) * fmaxf(bb, FLT_MIN);

  part = 0.0f;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const float ri = q[idx] - Av(F, x, idx);
    r[idx] = ri;
    const float wr = w[idx] * ri;
    part += wr * wr;
  }
  float rr_best = block_sum(part, c.red);
  vcycle(c, r, p);  // initial direction: Minv(r0)

  bool use_sd = false, r_valid = true;
  int n_bad = 0, k = 0;
  while (k < maxiter && rr_best > tol2 && n_bad < patience) {
    if (!r_valid) {
      for (int idx = threadIdx.x; idx < n; idx += blockDim.x) r[idx] = q[idx] - Av(F, x, idx);
      __syncthreads();
    }
    vcycle(c, r, z);
    part = 0.0f;
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      part += r[idx] * z[idx];
      if (use_sd) p[idx] = z[idx];  // steepest-descent window restarts from z
    }
    float rz = block_sum(part, c.red);
    const float beta_mask = use_sd ? 0.0f : 1.0f;
    part = 0.0f;
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const float wr = w[idx] * r[idx];
      part += wr * wr;
    }
    float rr = block_sum(part, c.red);
    // Once a member's rr <= tol2 the window's remaining steps are no-ops
    // (alpha = 0, state kept), so they are skipped.
    for (int it = 0; it < restart_every && rr > tol2; ++it) {
      part = 0.0f;
      for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
        const float a = Av(F, p, idx);
        Ap[idx] = a;
        part += p[idx] * a;
      }
      const float pAp = block_sum(part, c.red);
      const float alpha = rz / (pAp == 0.0f ? 1.0f : pAp);
      for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
        x[idx] = x[idx] + alpha * p[idx];
        r[idx] = r[idx] - alpha * Ap[idx];
      }
      __syncthreads();
      vcycle(c, r, z);
      float pz = 0.0f, pr = 0.0f;
      for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
        pz += r[idx] * z[idx];
        const float wr = w[idx] * r[idx];
        pr += wr * wr;
      }
      const float rz_new = block_sum(pz, c.red);
      const float beta = beta_mask * rz_new / (rz == 0.0f ? 1.0f : rz);
      for (int idx = threadIdx.x; idx < n; idx += blockDim.x) p[idx] = z[idx] + beta * p[idx];
      rz = rz_new;
      rr = block_sum(pr, c.red);  // its barriers also order the p update
    }
    // True residual of the window's iterate (residual replacement).
    part = 0.0f;
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const float ri = q[idx] - Av(F, x, idx);
      r[idx] = ri;
      const float wr = w[idx] * ri;
      part += wr * wr;
    }
    const float rr_new = block_sum(part, c.red);
    const bool finite = isfinite(rr_new);
    const bool blown = !finite || rr_new > 100.0f * fmaxf(rr_best, tol2);
    const bool better = finite && rr_new < rr_best;
    if (better || blown) {
      for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
        if (better) xb[idx] = x[idx];
        if (blown) x[idx] = xb[idx];
      }
      __syncthreads();
    }
    if (better) rr_best = rr_new;
    n_bad = better ? 0 : n_bad + 1;
    use_sd = blown;
    r_valid = !blown;
    k += restart_every;
  }

  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) p_out[(size_t)b * n + idx] = xb[idx];
  if (threadIdx.x == 0) {
    it_out[b] = k;
    rel_out[b] = sqrtf(rr_best / fmaxf(bb, FLT_MIN));
  }
}

}  // namespace

extern "C" int hm_pressure_solve(const float* hier, const float* q, const float* p0,
                                 const float* w, float* p_out, int* it_out, float* rel_out,
                                 int B, int Nx, int Ny, int n_levels, int hier_stride, float tol,
                                 int maxiter, int restart_every, int patience, void* stream) {
  if (n_levels < 2 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  int hier_n, coarse_n;
  sizes(Nx, Ny, n_levels, &hier_n, &coarse_n);
  if (hier_n != hier_stride) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)hier_n + 7 * (size_t)Nx * Ny + coarse_n + 64);
  cudaError_t e = cudaFuncSetAttribute(pressure_pcg_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int threads = Nx * Ny < kMaxThreads ? Nx * Ny : kMaxThreads;
  threads = ((threads + 31) / 32) * 32;
  pressure_pcg_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      hier, q, p0, w, p_out, it_out, rel_out, Nx, Ny, n_levels, hier_stride, tol, maxiter,
      restart_every, patience);
  return (int)cudaGetLastError();
}
