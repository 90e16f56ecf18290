// Kernel B: a batched banded Cholesky factor-and-solve in float64, the
// exact oracle's pressure solve (ops/banded.py, models/oracle.py).
//
// Replaces no TPU kernel. The JAX package's float64 oracle
// (historymatching_tpu/models/oracle.py, simulate_oracle) solves each
// member's pinned TPFA system on the host with LAPACK dpbsv, through
// scipy.linalg.solveh_banded, one member at a time; the TPU has no float64.
// This kernel is that solve on the card, every member at once.
//
// It computes what ops/banded.py `banded_solve_torch` computes, in its
// order: for each column j (dpbtf2's order), the pivot's square root and
// its reciprocal r_j, the row of U scaled by r_j (as dpbtf2 scales it),
// the rank-1 update of the next kd rows' upper triangle, and the forward
// substitution U^T y = q carried alongside (y_j = q_j r_j, then q_{j+i} -=
// U_{j,j+i} y_j); then the back substitution U p = y by columns (p_c = y_c
// r_c, then y_{c-i} -= U_{c-i,c} p_c). Every product and difference is
// rounded on its own (__dmul_rn, __dsub_rn: nothing is contracted into an
// FMA), and the square root and the reciprocal are IEEE-rounded, as the
// plain version's tensor operations are, so the two agree bit for bit. A
// pivot that is not positive stops the member and writes its column + 1
// to info.
//
// Input: ab (B, kd+1, n) in LAPACK's upper band storage, ab[kd + i - c, c]
// = A[i, c]; q (B, n). Output: p (B, n), info (B,). Workspace: ucol (B, n,
// kd+1), ucol[c, i] = U[c-i, c] for i >= 1 and ucol[c, 0] = r_c, written by
// the factor, read by the back substitution a row at a time.
//
// Design (first form): one thread block a member. The active window, the
// (kd+1) x (kd+1) trailing block of rows and columns j..j+kd, lives in
// shared memory as a ring over columns: absolute index a sits in slot
// a mod (kd+1), and only the upper triangle of the ring's slots is stored
// (the window is symmetric), (kd+1)(kd+2)/2 doubles (17,160 bytes at kd =
// 64). Each thread owns up to E fixed pairs of slots. A step is three
// barriers: the first kd+1 threads scale the pivot column's entries into
// u (phase 1); each thread updates its pairs, a few at a time, without a
// branch (phase 2); the first kd+1 threads write the entering column
// j+kd+1 into the retired slot's pairs and update y (phase 3). Columns of
// ab and q enter through a ring of kStages chunks of kChunk columns copied
// ahead by cp.async, so a step reads no device memory. The back
// substitution runs on one warp, the rows of ucol streamed through a ring
// of kBack rows the same way.
//
// What bounds it on the H100: its bytes (ab and q read, p written: 2.2 MB
// a member at 64x64, 0.66 ms for 1,000 members at 3.35 TB/s) over its
// float64 operations (18.2 MFLOP a member, 0.27 ms at 67 TFLOP/s). This
// first form is far from either: a column is a dependent chain of a square
// root, a reciprocal and three barriers, the update reads and writes the
// window in shared memory, and the back substitution is one warp's chain
// of 4,096 steps (bench_routes.py --kernel banded times the parts). Not
// tried: the window in registers, the back substitution over several
// warps, DMMA.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kStages = 4;  // chunks of ab's columns in flight (ops/banded.py STAGES)
constexpr int kChunk = 8;   // columns a chunk (ops/banded.py CHUNK)
constexpr int kBack = 16;   // rows of ucol in flight in the back substitution
constexpr int kGroup = 4;   // pairs updated together

__host__ __device__ inline int smem_doubles(int K) {
  return K * (K + 1) / 2 + 1 + (K + 1) + K + kStages * (K + 1) * kChunk;
}

// Offset of slot pair (a, b), a <= b, in the packed upper triangle.
__device__ __forceinline__ int tri(int a, int b, int K) { return a * K - (a * (a - 1)) / 2 + (b - a); }

template <int E>
__global__ void __launch_bounds__(1024) banded_cholesky_kernel(
    const double* __restrict__ ab, const double* __restrict__ q, double* __restrict__ p,
    double* __restrict__ ucol, int* __restrict__ info, int n, int kd) {
  extern __shared__ double smem[];
  const int K = kd + 1;
  const int pairs = K * (K + 1) / 2;
  double* W = smem;           // the window's upper triangle by ring slots, and a spare
  double* u = W + pairs + 1;  // the pivot row scaled, by slot (0 at the pivot's and at K)
  double* y = u + K + 1;      // the right-hand side's ring
  double* stage = y + K;   // kStages chunks of (K rows of ab + q) x kChunk columns
  const int tid = threadIdx.x, T = blockDim.x;
  const size_t m = blockIdx.x;
  const double* abm = ab + m * K * n;
  const double* qm = q + m * n;
  double* pm = p + m * n;
  double* um = ucol + m * n * K;

  // This thread's pairs: offset | a << 16 | b << 24 (K <= 208); past the
  // triangle the spare (pairs, K, K), whose update is 0.
  unsigned own[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int e = tid + k * T;
    own[k] = (unsigned)pairs | ((unsigned)K << 16) | ((unsigned)K << 24);
    if (e < pairs) {
      int a = 0, start = 0;
      while (start + (K - a) <= e) start += K - a++;
      const int b = a + (e - start);
      own[k] = (unsigned)e | ((unsigned)a << 16) | ((unsigned)b << 24);
      // the leading window: absolute index = slot; identity past n
      W[e] = b < n ? abm[(size_t)(kd + a - b) * n + b] : (a == b ? 1.0 : 0.0);
    }
  }
  for (int s = tid; s < K; s += T) y[s] = s < n ? qm[s] : 0.0;
  if (tid == 0) W[pairs] = u[K] = 0.0;

  // Chunk g holds columns K + g*kChunk .. +kChunk of ab (rows 0..kd) and q
  // (row K); past n the identity's columns and zeros.
  auto issue = [&](int g) {
    double* st = stage + (size_t)(g % kStages) * (K + 1) * kChunk;
    const int c0 = K + g * kChunk;
    for (int i = tid; i < (K + 1) * kChunk; i += T) {
      const int r = i / kChunk, c = c0 + (i - r * kChunk);
      if (c < n)
        __pipeline_memcpy_async(st + i, r < K ? abm + (size_t)r * n + c : qm + c, sizeof(double));
      else
        st[i] = r == kd ? 1.0 : 0.0;
    }
    __pipeline_commit();
  };
  for (int g = 0; g < kStages - 1; ++g) issue(g);
  __syncthreads();

  bool failed = false;
  int sj = 0;  // j mod K
  for (int j = 0; j < n; ++j, sj = sj + 1 == K ? 0 : sj + 1) {
    const int jc = j % kChunk;
    if (jc == 0) {
      issue(j / kChunk + kStages - 1);
      __pipeline_wait_prior(kStages - 1);  // this thread's copies of the chunk of step j
    }
    // Phase 1: the pivot, the scaled row, the forward substitution's y_j.
    const double dv = W[tri(sj, sj, K)];
    if (!(dv > 0.0)) {
      if (tid == 0) info[m] = j + 1;
      failed = true;
      break;
    }
    const double rd = __drcp_rn(sqrt(dv));
    for (int s = tid; s < K; s += T) {
      const int off = s - sj;
      const int i = off >= 0 ? off : off + K;  // the entry is U[j, j+i]
      const double us = i == 0 ? 0.0 : __dmul_rn(W[off < 0 ? tri(s, sj, K) : tri(sj, s, K)], rd);
      u[s] = us;
      if (j + i < n) um[(size_t)(j + i) * K + i] = i == 0 ? rd : us;
    }
    const double yj = __dmul_rn(y[sj], rd);
    if (tid == 0) pm[j] = yj;
    __syncthreads();
    // Phase 2: the rank-1 update, kGroup pairs at a time: their loads
    // issue together, then their stores (the compiler cannot tell the
    // pairs' addresses apart). The retired slot's pairs keep their values
    // (u there is 0).
#pragma unroll
    for (int k0 = 0; k0 < E; k0 += kGroup) {
      double w[kGroup], ua[kGroup], ub[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const unsigned o = own[k0 + k];
        w[k] = W[o & 0xffff];
        ua[k] = u[(o >> 16) & 0xff];
        ub[k] = u[o >> 24];
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        W[own[k0 + k] & 0xffff] = __dsub_rn(w[k], __dmul_rn(ua[k], ub[k]));
    }
    __syncthreads();
    // Phase 3: the retired slot takes column j + K (slot s holds absolute
    // j + 1 + r, row r of ab's column), and y its entry of q.
    const double* st = stage + (size_t)((j / kChunk) % kStages) * (K + 1) * kChunk + jc;
    for (int s = tid; s < K; s += T) {
      const int r = s > sj ? s - sj - 1 : s - sj + kd;
      W[s < sj ? tri(s, sj, K) : tri(sj, s, K)] = st[r * kChunk];
      y[s] = s == sj ? st[K * kChunk] : __dsub_rn(y[s], __dmul_rn(u[s], yj));
    }
    __syncthreads();
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (failed || tid >= 32) return;

  // Back substitution, one warp: slot s of y holds absolute c - i, i = (c -
  // s) mod K; rows of ucol stream through `stage`.
  const int lane = tid;
  double* ring = stage;
  auto fetch = [&](int c) {
    if (c >= 0)
      for (int i = lane; i < K; i += 32)
        __pipeline_memcpy_async(ring + (c % kBack) * K + i, um + (size_t)c * K + i, sizeof(double));
    __pipeline_commit();
  };
  const int s_last = (n - 1) % K;
  for (int s = lane; s < K; s += 32) {
    const int back = s_last - s >= 0 ? s_last - s : s_last - s + K;
    y[s] = n - 1 - back >= 0 ? pm[n - 1 - back] : 0.0;
  }
  for (int t = 0; t < kBack - 1; ++t) fetch(n - 1 - t);
  int sc = s_last;
  for (int c = n - 1; c >= 0; --c, sc = sc == 0 ? K - 1 : sc - 1) {
    fetch(c - (kBack - 1));
    __pipeline_wait_prior(kBack - 1);
    __syncwarp();
    const double* row = ring + (c % kBack) * K;
    const double pc = __dmul_rn(y[sc], row[0]);
    __syncwarp();
    for (int s = lane; s < K; s += 32) {
      const int i = sc - s >= 0 ? sc - s : sc - s + K;
      if (i == 0)
        y[s] = c - K >= 0 ? pm[c - K] : 0.0;  // the entering y, absolute c - K
      else
        y[s] = __dsub_rn(y[s], __dmul_rn(row[i], pc));
    }
    if (lane == 0) pm[c] = pc;
    __syncwarp();
  }
  __pipeline_wait_prior(0);
}

template <int E>
cudaError_t configure(int K, size_t* bytes) {
  *bytes = sizeof(double) * (size_t)smem_doubles(K);
  return cudaFuncSetAttribute(banded_cholesky_kernel<E>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

template <int E>
int launch(const double* ab, const double* q, double* p, double* ucol, int* info, int B, int n,
           int kd, int threads, cudaStream_t stream) {
  size_t bytes = 0;
  cudaError_t e = configure<E>(kd + 1, &bytes);
  if (e != cudaSuccess) return (int)e;
  banded_cholesky_kernel<E><<<B, threads, bytes, stream>>>(ab, q, p, ucol, info, n, kd);
  return (int)cudaGetLastError();
}

template <int E>
int info_of(int kd, int threads, int* out) {
  size_t bytes = 0;
  cudaError_t e = configure<E>(kd + 1, &bytes);
  cudaFuncAttributes a{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, banded_cholesky_kernel<E>);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, banded_cholesky_kernel<E>, threads,
                                                       bytes);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)bytes;
  out[3] = threads;
  out[4] = blocks;
  return (int)e;
}

}  // namespace

// B members' solves on `stream`: `per` pairs a thread (16 or 32, the
// template), `threads` a block (ops/banded.py launch_plan); K = kd + 1 <=
// 208 (the pair's packing) and the block's shared memory within the card's.
extern "C" int hm_banded_solve(const double* ab, const double* q, double* p, double* ucol,
                               int* info, int B, int n, int kd, int per, int threads,
                               void* stream) {
  if (kd < 1 || kd + 1 > 208 || threads < 32 || threads > 1024 ||
      (long long)per * threads < (long long)(kd + 1) * (kd + 2) / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (per == 16) return launch<16>(ab, q, p, ucol, info, B, n, kd, threads, s);
  if (per == 32) return launch<32>(ab, q, p, ucol, info, B, n, kd, threads, s);
  return (int)cudaErrorInvalidValue;
}

// Its resources at band width kd: registers and local (stack and spill)
// bytes a thread, dynamic shared bytes and threads a block, resident
// blocks an SM.
extern "C" int hm_banded_info(int kd, int per, int threads, int* out) {
  if (per == 16) return info_of<16>(kd, threads, out);
  if (per == 32) return info_of<32>(kd, threads, out);
  return (int)cudaErrorInvalidValue;
}
