// Kernel P-cl: kernel P (pressure_pcg.cu) on a thread-block cluster per
// member, the member's levels in the cluster's distributed shared memory.
//
// Replaces: historymatching_tpu/ops/pressure_pallas.py,
//   pressure_solve_pallas (pressure_pcg_kernel), and its multi-member
//   layouts _batched and _packed, at the grids where kernel P's layout does
//   not fit one block's shared memory and the TPU kernel keeps its
//   hierarchy in VMEM with vmem_limit_bytes raised (pressure_pallas.py
//   :163-166): 60x60, 88x88, 96x96, 100x100, 128x128, a 60x220 layer and
//   larger (ops/pressure.py `route`). P-gm (pressure_pcg_gm.cu) keeps the
//   grids no cluster holds.
//
// It computes what P computes: the restarted MG-preconditioned CG of
// ops/cg.py `pcg` on the Jacobi-scaled (UNIT) or unscaled TPFA system, with
// the V-cycle of ops/multigrid.py `vcycle_apply` (damped Jacobi or the
// degree-2 Chebyshev smoother, 2x2 block-sum restriction, prolongation by
// injection times omega_c, a dense coarsest solve), the 100x blow-up guard,
// the patience stop and the best iterate; each sweep does P's float32
// operations in P's order. The block and cluster sums, and the coarse
// product where the inverse is read in place, sum in another order, so it
// agrees with the plain version to rounding, as P-gm does.
//
// Partition. One cluster of C blocks (ranks) per member, launched with
// cudaLaunchKernelEx and a cluster dimension, the grid B C blocks, T
// threads a rank (ops/pressure.py `cl_threads`). Rank r
// owns a band of rows of every level that is split, its height even on
// each (so 2x2 tiles and the 2x2 restriction stay inside a rank): equal
// bands n / C (the levels from the fine one down while a band has an even
// height and the level has more than 256 cells, 16x16), or, where the
// inverse is distributed, bands of unequal even heights on every level but
// the coarsest (`Geo::band`; every rank's layout makes room for the
// largest, and ranks past the rows hold none). Inside its band a rank is kernel P's block: 2x2
// tiles a thread, x, p and the metric weight w in registers (w read from
// device memory where a thread holds more than four tiles), z in the fine
// iterate's rows, the best iterate written to p_out, the coarse
// temporaries aliased into the fine one.
// Every array of a split level has a halo row above and below the band.
// A rank never reads another's shared memory to get them: whoever writes
// a band's first or last row also stores it into the neighbouring rank's
// halo (st.shared::cluster, distributed shared memory; every rank's layout
// is the same, so the neighbour's array sits at the same offset), before
// the cluster barrier that orders it. A remote store does not stall the
// thread that issues it, where a remote load stalls each band-edge tile
// after every barrier (pulling the rows instead ran slower: PERF.md, PR 10).
// The static halos (the face row above, the reciprocal diagonal's rows)
// come from device memory with the band. The levels below the split ones
// are gathered, whole, on every rank: the last split level's restriction
// stores each value of its residual into every rank's right-hand side,
// and after one cluster barrier every rank runs those levels as P runs its
// coarse levels (on its block, then the levels of <= 64 cells and the
// coarse solve on warp 0), the same operations in the same order, so every
// rank's copy of the correction holds the same bits and each prolongs
// from its own. Where the coarsest inverse does not fit beside the bands
// it stays in device memory (60x60, 88x88), read in place a row a warp,
// the rows split over every rank's warps, each result stored into every
// rank, as P-gm's `coarse_solve` reads it. Where it fits neither a rank
// nor beside a whole SM's two blocks (100x100, 625 cells, 1.56 MB; a
// 60x220 layer, 825 cells, 2.72 MB) it is distributed: rank r holds rows
// [r KR, (r + 1) KR) of it in its shared memory, loaded once a launch by
// one bulk asynchronous copy that runs under the prologue; the last split
// level's restriction stores each coarse right-hand side value into every
// rank, each rank multiplies its rows, and stores each result into the
// ranks whose bands read it: the coarse solve costs no cluster barrier
// beyond the one before the prolongation, and device memory sees the
// inverse once a launch, where P-gm and the in-place variant read it
// every V-cycle. The grid, the cluster size, the threads and the
// inverse's place are compile-time constants (ops/_build.py builds one
// library a grid and plan), and ops/pressure.py `layout` (with `cl`)
// counts the same per-rank layout that `Geo` below places.
//
// Agreement across the cluster. Every barrier of P that orders a halo
// becomes a cluster barrier (barrier.cluster arrive.release /
// wait.acquire), which orders the stores into the neighbours' halos before
// their reads; a rank stores into a neighbour's halo only after the
// barrier that follows the neighbour's last read of it (the schedule is
// emulated in tests/test_torch_pressure_cl.py, and the probe build,
// -DHM_CL_PROBE, counts the cluster barriers member 0 passes and reports
// the layout `Geo` places, which the card tests hold to that emulation's).
// (Splitting a barrier, the band-edge tiles before the arrival and the
// interior ones before the wait, ran slower on an H100, as did a reduction that stores every warp's
// pair into every rank: PERF.md.) A reduction sums each rank's warps into
// its total, which its thread 0 stores into every rank; after the cluster
// barrier every thread of every rank adds the ranks' totals in rank order,
// so every rank holds bit-identical r.z, p.Ap and residual norms and takes
// every loop test (rr > tol2, the patience count, `better`, `blown`) the
// same way; a divergent rank would deadlock the next barrier. A final
// cluster barrier keeps every rank's shared memory alive until no rank
// reads it any more.
//
// What bounds it on the H100: barrier and shared-memory latency, as P. At
// 128x128 a member's hierarchy (~0.46 MB of P's layout) no longer fits one
// SM, and P-gm streamed it from device memory (~3 MB a member an
// iteration, 132 members in flight); here each rank holds a band of the
// load of P's 64x64 block, every array in shared memory, so device memory
// sees one read of the hierarchy, p0 and w, q at window ends and the write
// of the best iterate. The cost is the cluster barriers (15 an iteration
// at 128x128) and the stores of the band-edge rows. With the
// inverse distributed a rank takes a whole SM and a cluster of 9-16 most
// of a GPC, so about a tenth of the members P-gm keeps in flight run at
// once; each runs its V-cycles from shared memory only.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "pcg_tile.cuh"

#ifndef HM_GRID_NX
#error "pressure_pcg_cl.cu is built for one grid and plan: -DHM_GRID_NX -DHM_GRID_NY -DHM_CL \
-DHM_CL_INV -DHM_CL_THREADS"
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kSmemLimit = 232448;    // shared bytes one block may opt into (sm_90)
constexpr int kSmPerSm = 228 * 1024;  // an SM's shared memory; 1 KB of each block reserved
constexpr int kSplitMinCells = 256;   // a level of <= 16x16 cells is gathered on every rank
// Where the coarsest inverse lives (ops/pressure.py INV_PLACES): read in
// place from device memory, whole (transposed) in every rank's shared memory,
// or a block of its rows in each rank's shared memory.
constexpr int kInvDevice = 0, kInvShared = 1, kInvDistributed = 2;

// The per-rank geometry and shared-memory layout (floats) of one grid on a
// cluster of C ranks of T threads, the coarsest inverse at INV. Matches
// ops/pressure.py `layout` with `cl`.
template <int NX, int NY, int C, int INV, int T, bool CHEB = false, bool UNIT = true>
struct Geo {
  static constexpr bool kCheb = CHEB;
  static constexpr bool kUnit = UNIT;
  static constexpr bool kShared = INV == kInvShared;
  static constexpr bool kDist = INV == kInvDistributed;
  static constexpr int kC = C;
  static constexpr int L = count_levels(NX, NY);
  static constexpr int LC = L - 1;
  __host__ __device__ static constexpr int n(int l) { return NX >> l; }
  __host__ __device__ static constexpr int m(int l) { return NY >> l; }
  __host__ __device__ static constexpr int cells(int l) { return n(l) * m(l); }
  // Equal bands while they stay even; with the inverse distributed, every
  // level but the coarsest (ops/pressure.py `cl_split`).
  __host__ __device__ static constexpr int split_levels() {
    if (kDist) return LC;
    int l = 0;
    while (l < LC && n(l) % (2 * C) == 0 && cells(l) > kSplitMinCells) ++l;
    return l;
  }
  static constexpr int LS = split_levels();  // levels 0..LS-1 are split in bands
  __host__ __device__ static constexpr bool split(int l) { return l < LS; }
  // Bands (ops/pressure.py `cl_bands`): units of 2^LS fine rows, U of them;
  // rank q holds UB units and one more where q < UX, so every rank's rows
  // stay even down to level LS-1. Ranks past the units (UB = 0) hold none
  // and come last: RANKS of them hold rows.
  static constexpr int U = NX >> LS, UB = U / C, UX = U % C;
  static constexpr bool kEqual = UX == 0;
  static constexpr int RANKS = UB > 0 ? C : UX;
  __host__ __device__ static constexpr int unit(int l) { return 1 << (LS - l); }
  // Rank q's rows of level l <= LS, and its first row.
  __host__ __device__ static constexpr int band(int q, int l) {
    return (kEqual ? UB : UB + (q < UX ? 1 : 0)) * unit(l);
  }
  __host__ __device__ static constexpr int first(int q, int l) {
    return (kEqual ? q * UB : q * UB + (q < UX ? q : UX)) * unit(l);
  }
  // Whether the rank below q holds rows of a split level (rank q - 1,
  // above, does whenever q does).
  __host__ __device__ static constexpr bool below(int q) { return q < RANKS - 1; }
  // A split level's rows: the largest band (every rank's layout holds it),
  // and rank q's own; a gathered level's: all of them.
  __host__ __device__ static constexpr int rows(int l) {
    return split(l) ? (UB + (UX > 0 ? 1 : 0)) * unit(l) : n(l);
  }
  __host__ __device__ static constexpr int rows_of(int q, int l) {
    return split(l) ? band(q, l) : n(l);
  }
  // A split level's arrays start with a halo row, and end with one.
  __host__ __device__ static constexpr int halo(int l) { return split(l) ? m(l) : 0; }
  __host__ __device__ static constexpr int vec(int l) {
    return r4((rows(l) + (split(l) ? 2 : 0)) * m(l));
  }
  __host__ __device__ static constexpr int faces(int l) {
    return split(l) ? vec(l) : r4((n(l) - 1) * m(l));
  }
  // A coarse level's smoothing temporary aliases the fine T while the
  // temporaries of levels 1..l fit in it, else it follows the level's X.
  // Where levels are gathered, only the fine T's own rows (from TB): a
  // neighbour may store into its halo rows while this rank still runs them.
  static constexpr int TB = kDist ? 0 : halo(0);
  __host__ __device__ static constexpr bool t_alias(int l) {
    int o = 0;
    for (int k = 1; k <= l; ++k) o += vec(k);
    return o <= (kDist ? vec(0) : rows(0) * m(0));
  }
  __host__ __device__ static constexpr int t_offset(int l) {
    int o = 0;
    for (int k = 1; k < l; ++k) o += vec(k);
    return o;
  }
  __host__ __device__ static constexpr int level_size(int l) {
    return l == 0 ? faces(0) + (UNIT ? 4 : 6) * vec(0)
           : l < LC ? faces(l) + (t_alias(l) ? 5 : 6) * vec(l)
                    : 2 * vec(l);
  }
  __host__ __device__ static constexpr int base(int l) {
    int o = 0;
    for (int k = 0; k < l; ++k) o += level_size(k);
    return o;
  }
  static constexpr int NC = cells(LC);
  // Rows of the inverse a rank holds where it is distributed (ops/pressure.py
  // `cl_inverse_rows`): a block of KR, from row r KR, the last ones shorter.
  static constexpr int KR = (NC + C - 1) / C;
  static constexpr int INVERSE = base(L);
  // The distributed block is placed 0-3 floats in, so that it has its
  // source's 16-byte alignment (the bulk copy's); its copy's barrier follows.
  static constexpr int BAR = INVERSE + (kShared ? r4(NC * NC) : kDist ? r4(KR * NC) + 4 : 0);
  static constexpr int RED = BAR + (kDist ? 4 : 0);
  // Threads a rank (ops/pressure.py `cl_threads`: about one per four fine
  // tiles of the largest band, in a multiple of 128, at least 256 where the
  // inverse is distributed or read in place).
  static constexpr int THREADS = T;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int TILES0 = rows(0) * m(0) / 4;
  static constexpr int TPT = (TILES0 + THREADS - 1) / THREADS;
  // The metric weight w of a thread's tiles stays in registers up to four
  // tiles a thread; past that (96x96, 100x100, 60x220, 192x192) it is read
  // from device memory where used, so that x and p fit the registers.
  static constexpr bool W_REGS = TPT <= 4;
  // Two reduction slots, each the warps' pairs and the ranks' totals.
  static constexpr int SLOT = WARPS + C;
  static constexpr int FLOATS = RED + 4 * SLOT;
  static constexpr int BYTES = 4 * FLOATS;
  static constexpr bool FITS = BYTES <= kSmemLimit;
  // Resident blocks an SM by shared memory, at no fewer than 128
  // registers a thread.
  static constexpr int SMEM_BLOCKS = kSmPerSm / (BYTES + 1024);
  static constexpr int REG_BLOCKS = 65536 / (THREADS * 128);
  static constexpr int MIN_BLOCKS_RAW = SMEM_BLOCKS < REG_BLOCKS ? SMEM_BLOCKS : REG_BLOCKS;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_RAW < 1 ? 1 : MIN_BLOCKS_RAW;
  // Gathered levels of <= 64 cells and the coarse solve run on each rank's
  // warp 0 (where the inverse is in shared memory and small); the others
  // on each rank's block.
  __host__ __device__ static constexpr int first_warp_level() {
    int l = LS;
    while (l < LC && cells(l) > 64) ++l;
    return l;
  }
  static constexpr bool WARP_TAIL = kShared && NC <= 64;
  static constexpr int LW = WARP_TAIL ? first_warp_level() : LC;
  static_assert(NX % 2 == 0 && NY % 2 == 0 && L >= 2 && L <= kMaxLevels,
                "a tiled fine level and a coarse level");
  static_assert(C >= 2 && C <= 16 && LS >= 1 && RANKS >= 1, "the cluster splits the fine level");
  static_assert(T % 128 == 0 && T >= 128 && T <= 1024, "whole register granules of threads");
};

// The arrays of level l in a rank's shared memory (the same offsets on
// every rank), each at its first row of the band (after the halo row).
template <class G, int l>
struct Lvl {
  static constexpr int h = G::rows(l), m = G::m(l), H = G::halo(l);
  __host__ __device__ static float* tx0(float* sh) { return sh + G::base(l); }
  __host__ __device__ static float* ty0(float* sh) { return tx0(sh) + G::faces(l); }
  __host__ __device__ static float* TX(float* sh) { return tx0(sh) + H; }
  __host__ __device__ static float* TY(float* sh) { return ty0(sh) + H; }
  __host__ __device__ static float* D(float* sh) {
    if constexpr (l == 0) return ty0(sh) + 4 * G::vec(0) + H;
    else return ty0(sh) + G::vec(l) + H;
  }
  __host__ __device__ static float* RD(float* sh) { return D(sh) + G::vec(l); }
  __host__ __device__ static float* B(float* sh) {
    if constexpr (l == 0) return ty0(sh) + 2 * G::vec(0) + H;  // R
    else if constexpr (l == G::LC) return sh + G::base(l);
    else return RD(sh) + G::vec(l);
  }
  __host__ __device__ static float* X(float* sh) {
    if constexpr (l == 0) return ty0(sh) + G::vec(0) + H;  // P
    else return B(sh) + G::vec(l);
  }
  __host__ __device__ static float* T(float* sh) {
    if constexpr (l == 0)
      return ty0(sh) + 3 * G::vec(0) + H;
    else if constexpr (G::t_alias(l))
      return Lvl<G, 0>::ty0(sh) + 3 * G::vec(0) + G::TB + G::t_offset(l) + H;
    else return X(sh) + G::vec(l);
  }
};

__device__ __forceinline__ unsigned cluster_rank() { return cg::this_cluster().block_rank(); }

// Rank `rank`'s copy of a shared-memory address, in the cluster's shared
// window (32 bits, so the stores below stay shared-memory ones).
__device__ __forceinline__ unsigned at_rank(const void* p, int rank) {
  unsigned a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(a)
      : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_rank(float* p, int rank, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(at_rank(p, rank)), "f"(v));
}

__device__ __forceinline__ void st2_rank(float* p, int rank, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(at_rank(p, rank)), "f"(a),
               "f"(b));
}

#ifdef HM_CL_PROBE
// The probe build counts the cluster barriers that block 0 (member 0's
// rank 0) passes (`hm_pressure_cl_barriers`).
__device__ unsigned g_cluster_barriers;
#endif

// Every thread of every rank arrives (its shared-memory stores, its own
// and those into other ranks, released) before any goes on.
__device__ __forceinline__ void cluster_sync() {
#ifdef HM_CL_PROBE
  if (blockIdx.x == 0 && threadIdx.x == 0) ++g_cluster_barriers;
#endif
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

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

// Rows of level l around tile row I of rank r's band: whether the level
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

// put, and on a split level the band's first row into the rank above's
// lower halo (after that rank's own rows) and its last into the rank
// below's upper one.
template <class G, int l>
__device__ __forceinline__ void put_band(float* v, int I, int J, int r, const float x[4]) {
  using RW = Rows<G, l>;
  constexpr int m = RW::m;
  put<m>(v, I, J, x);
  if constexpr (RW::kSplit) {
    if (I == 0 && r > 0) st2_rank(v + G::band(r - 1, l) * m + 2 * J, r - 1, x[0], x[1]);
    if (I == RW::TI(r) - 1 && G::below(r)) st2_rank(v - m + 2 * J, r + 1, x[2], x[3]);
  }
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

// (A v) on the tile's four cells in P's term order (pressure_pcg.cu
// `stencil`). A split level's TX holds the band's faces below each row and
// the face above its first row in the halo.
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

// f(k, I, J) for each tile of rank r's rows of level l that worker w of NW
// owns; k counts the largest band's tiles (the registers' index).
template <class G, int l, int NW, class F>
__device__ __forceinline__ void tiles(int w, int r, F f) {
  constexpr int TJ = G::m(l) / 2, NT = (G::rows(l) / 2) * TJ;
  constexpr bool kSame = G::kEqual || !G::split(l);  // every rank the same rows
  const int nt = kSame ? NT : (G::rows_of(r, l) / 2) * TJ;
#pragma unroll
  for (int k = 0; k < (NT + NW - 1) / NW; ++k) {
    const int T = w + k * NW;
    if ((kSame && NT % NW == 0) || T < nt) f(k, T / TJ, T % TJ);
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

// Level l+1's array (its B or X) at level l's tile (I, J) of rank r, I
// from -1 to the band's tile rows: the rank's own band (its halo rows
// beyond) where level l+1 is split, or level l is gathered; the rank's
// copy of the whole gathered level, from this band's first coarse row,
// where level l is split and level l+1 gathered (every rank's right-hand
// side receives every rank's restriction).
template <class G, int l>
struct Parent {
  static constexpr bool kSplit = G::split(l + 1);
  static constexpr bool kGathered = G::split(l) && !kSplit;
  static constexpr int mc = G::m(l) / 2;
  __device__ static int at(int I, int J, int r) {
    return ((kGathered ? G::first(r, l) / 2 : 0) + I) * mc + J;
  }
  __device__ static float ld(const float* p, int I, int J, int r) { return p[at(I, J, r)]; }
  // A restricted value into the right-hand side, and into the neighbour's
  // halo where it is a band's first or last coarse row.
  __device__ static void st(float* p, int I, int J, int r, float v) {
    if constexpr (kGathered) {
#pragma unroll
      for (int q = 0; q < G::kC; ++q) st_rank(p + at(I, J, r), q, v);
    } else {
      p[at(I, J, r)] = v;
      if constexpr (kSplit) {
        if (I == 0 && r > 0) st_rank(p + G::band(r - 1, l + 1) * mc + J, r - 1, v);
        if (I == G::rows_of(r, l) / 2 - 1 && G::below(r)) st_rank(p - mc + J, r + 1, v);
      }
    }
  }
};

// Pre-smoothing from x = 0, the first sweep folded into the second's reads
// (pressure_pcg.cu `smooth_down`).
template <class G, int l, int NW>
__device__ __forceinline__ void smooth_down(float* sh, int w, int r) {
  using V = Lvl<G, l>;
  constexpr int m = V::m;
  tiles<G, l, NW>(w, r, [&](int, int I, int J) {
    const Tile b = gather<G, l>(V::B(sh), I, J, r);
    Tile rdt;
    if constexpr (!unit_level<G, l>()) rdt = gather<G, l>(V::RD(sh), I, J, r);
    const Tile t = first_sweep<G::kCheb, unit_level<G, l>()>(b, rdt);
    float At[4], rd[4], x[4];
    stencil<G, l, unit_level<G, l>()>(V::TX(sh), V::TY(sh), V::D(sh), I, J, r, t, At);
    own_rd<G, l, m>(sh, I, J, rd);
    second_sweep_down<G::kCheb>(t, b, At, rd, x);
    put_band<G, l>(V::X(sh), I, J, r, x);
  });
}

// Residual b - A x of level l, restricted by 2x2 block sums into level
// l+1's right-hand side (every rank's, where level l+1 is gathered).
template <class G, int l, int NW>
__device__ __forceinline__ void restrict_residual(float* sh, int w, int r) {
  using V = Lvl<G, l>;
  constexpr int m = V::m;
  float* Bc = Lvl<G, l + 1>::B(sh);
  tiles<G, l, NW>(w, r, [&](int, int I, int J) {
    const Tile x = gather<G, l>(V::X(sh), I, J, r);
    float Ax[4], b[4];
    stencil<G, l, unit_level<G, l>()>(V::TX(sh), V::TY(sh), V::D(sh), I, J, r, x, Ax);
    own<m>(V::B(sh), I, J, b);
    Parent<G, l>::st(Bc, I, J, r, restrict_tile(b, Ax));
  });
}

// Coarsest level on each rank, inverse in shared memory: x = inverse @ b,
// one row a worker (P's `coarse_solve`).
template <class G, int NW>
__device__ __forceinline__ void coarse_solve(float* sh, int w) {
  using V = Lvl<G, G::LC>;
  constexpr int nc = G::NC;
  const float* b = V::B(sh);
  const float* At = sh + G::INVERSE;
  for (int row = w; row < nc; row += NW) {
    float acc = 0.0f;
#pragma unroll 5
    for (int k = 0; k < nc; ++k) acc += At[k * nc + row] * b[k];
    V::X(sh)[row] = acc;
  }
}

// Coarsest level, inverse in device memory (row-major, read in place): every
// rank holds b (its own gathered levels computed it), every warp of every
// rank takes rows rank-major, the lanes along the row (P-gm's
// `coarse_solve`), and lane q stores each result into rank q. Before a
// cluster barrier.
template <class G>
__device__ __forceinline__ void coarse_solve_cluster(float* sh, const float* A, int r) {
  using V = Lvl<G, G::LC>;
  constexpr int nc = G::NC;
  const float* b = V::B(sh);
  float* x = V::X(sh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = r * G::WARPS + warp; row < nc; row += G::kC * G::WARPS) {
    const float* a = A + (size_t)row * nc;
    float acc = 0.0f;
    for (int k = lane; k < nc; k += 32) acc += a[k] * b[k];
    acc = warp_sum(acc);
    if (lane < G::kC) st_rank(x + row, lane, acc);
  }
}

// Coarsest level, inverse distributed: rank r multiplies its block of rows
// (from row r KR, in its own shared memory at A) by b, which the last
// split level's restriction stored into every rank; a row a warp, the
// lanes along the row (as coarse_solve_cluster), and lane q stores the
// result into rank q where rank q's band reads that coarse row (its own
// rows and the halo row above and below). Between two cluster barriers.
template <class G>
__device__ __forceinline__ void coarse_product(float* sh, const float* A, int r) {
  using V = Lvl<G, G::LC>;
  constexpr int nc = G::NC, KR = G::KR, mc = G::m(G::LC);
  const float* b = V::B(sh);
  float* x = V::X(sh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = r * KR, k1 = k0 + KR < nc ? k0 + KR : nc;
  const int f = G::first(lane, G::LC), t = G::band(lane, G::LC);  // lane's rank's coarse rows
  for (int row = k0 + warp; row < k1; row += G::WARPS) {
    const float* a = A + (row - k0) * nc;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = lane; k < nc; k += 32) acc += a[k] * b[k];
    acc = warp_sum(acc);
    const int i = row / mc;
    if (lane < G::kC && t > 0 && i >= f - 1 && i <= f + t) st_rank(x + row, lane, acc);
  }
}

// First post-smoothing sweep after the coarse correction E (level l+1's
// iterate), prolongation folded into the reads (P's `smooth_up_first`).
template <class G, int l, int NW>
__device__ __forceinline__ void smooth_up_first(float* sh, int w, int r) {
  using V = Lvl<G, l>;
  using RW = Rows<G, l>;
  using E = Parent<G, l>;
  constexpr int m = V::m, mc = m / 2;
  const float* El = Lvl<G, l + 1>::X(sh);
  tiles<G, l, NW>(w, r, [&](int, int I, int J) {
    Tile x = gather<G, l>(V::X(sh), I, J, r);
    prolong(x, [&](int dI, int dJ) { return E::ld(El, I + dI, J + dJ, r); }, RW::up(I, r),
            RW::dn(I, r), J > 0, J < mc - 1);
    float Ax[4], b[4], rd[4], t[4];
    stencil<G, l, unit_level<G, l>()>(V::TX(sh), V::TY(sh), V::D(sh), I, J, r, x, Ax);
    own<m>(V::B(sh), I, J, b);
    own_rd<G, l, m>(sh, I, J, rd);
    first_sweep_up<G::kCheb>(x, b, Ax, rd, t);
    put_band<G, l>(V::T(sh), I, J, r, t);
  });
}

// Second post-smoothing sweep; out(k, I, J, x) receives the result (P's
// `smooth_up_second`).
template <class G, int l, int NW, class Out>
__device__ __forceinline__ void smooth_up_second(float* sh, int w, int r, Out out) {
  using V = Lvl<G, l>;
  constexpr int m = V::m;
  tiles<G, l, NW>(w, r, [&](int k, int I, int J) {
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

// Down the split levels, every rank on its band; the last one's
// restriction stores into every rank's copy of the next level.
template <class G, int l>
__device__ __forceinline__ void down_split(float* sh, int r) {
  if constexpr (l < G::LS) {
    smooth_down<G, l, G::THREADS>(sh, threadIdx.x, r);
    cluster_sync();
    restrict_residual<G, l, G::THREADS>(sh, threadIdx.x, r);
    cluster_sync();
    down_split<G, l + 1>(sh, r);
  }
}

// Down the gathered levels above LW, on each rank's block.
template <class G, int l>
__device__ __forceinline__ void down_gathered(float* sh) {
  if constexpr (l < G::LW) {
    smooth_down<G, l, G::THREADS>(sh, threadIdx.x, 0);
    __syncthreads();
    restrict_residual<G, l, G::THREADS>(sh, threadIdx.x, 0);
    __syncthreads();
    down_gathered<G, l + 1>(sh);
  }
}

// Levels LW.. (<= 64 cells) and the coarse solve, on each rank's warp 0.
template <class G, int l>
__device__ __forceinline__ void warp_levels(float* sh, int lane) {
  if constexpr (l == G::LC) {
    coarse_solve<G, 32>(sh, lane);
    __syncwarp();
  } else {
    using V = Lvl<G, l>;
    smooth_down<G, l, 32>(sh, lane, 0);
    __syncwarp();
    restrict_residual<G, l, 32>(sh, lane, 0);
    __syncwarp();
    warp_levels<G, l + 1>(sh, lane);
    smooth_up_first<G, l, 32>(sh, lane, 0);
    __syncwarp();
    smooth_up_second<G, l, 32>(sh, lane, 0, [&](int, int I, int J, const float* x) {
      put<V::m>(V::X(sh), I, J, x);
    });
    __syncwarp();
  }
}

// Up the gathered levels from l to LS, on each rank's block.
template <class G, int l>
__device__ __forceinline__ void up_gathered(float* sh) {
  if constexpr (l >= G::LS) {
    using V = Lvl<G, l>;
    smooth_up_first<G, l, G::THREADS>(sh, threadIdx.x, 0);
    __syncthreads();
    smooth_up_second<G, l, G::THREADS>(sh, threadIdx.x, 0, [&](int, int I, int J, const float* x) {
      put<V::m>(V::X(sh), I, J, x);
    });
    __syncthreads();
    up_gathered<G, l - 1>(sh);
  }
}

// Up the split levels from l to 1, every rank on its band.
template <class G, int l>
__device__ __forceinline__ void up_split(float* sh, int r) {
  if constexpr (l >= 1) {
    smooth_up_first<G, l, G::THREADS>(sh, threadIdx.x, r);
    cluster_sync();
    smooth_up_second<G, l, G::THREADS>(sh, threadIdx.x, r, [&](int, int I, int J, const float* x) {
      put_band<G, l>(Lvl<G, l>::X(sh), I, J, r, x);
    });
    cluster_sync();
    up_split<G, l - 1>(sh, r);
  }
}

// z = V-cycle(r) from a zero initial guess; the fine R vector is its
// right-hand side, z lands in the fine X's own rows (the fine P, which
// holds the V-cycle's iterate until then and p again once the thread has
// read z there, tile by tile: no register holds z). Ainv: the
// member's inverse in device memory, or the rank's block of its rows in
// shared memory where it is distributed. Where levels are gathered, every
// rank runs them on its own copy; the first split phase up needs no
// barrier before it, as its halos were ordered on the way down and its
// stores go to halos no gathered level aliases.
template <class G>
__device__ __forceinline__ void vcycle(float* sh, const float* Ainv, int r) {
  down_split<G, 0>(sh, r);
  if constexpr (G::kDist) {
    coarse_product<G>(sh, Ainv, r);  // every level above the coarsest is split
    cluster_sync();
  } else {
    down_gathered<G, G::LS>(sh);
    if constexpr (G::kShared) {
      if constexpr (G::WARP_TAIL) {
        if (threadIdx.x < 32) warp_levels<G, G::LW>(sh, threadIdx.x);
      } else {
        coarse_solve<G, G::THREADS>(sh, threadIdx.x);
      }
      __syncthreads();
      up_gathered<G, G::LW - 1>(sh);
    } else {
      coarse_solve_cluster<G>(sh, Ainv, r);
      cluster_sync();
      up_gathered<G, G::LC - 1>(sh);
    }
  }
  up_split<G, G::LS - 1>(sh, r);
  smooth_up_first<G, 0, G::THREADS>(sh, threadIdx.x, r);
  cluster_sync();
  smooth_up_second<G, 0, G::THREADS>(sh, threadIdx.x, r, [&](int, int I, int J, const float* x) {
    put<G::m(0)>(Lvl<G, 0>::X(sh), I, J, x);
  });
}

// Cluster sums of two values: each warp writes its partials to a slot,
// one block barrier, thread 0 adds them in warp order into the block's
// total and stores it into every rank's slot, one cluster barrier, then
// every thread of every rank adds the ranks' totals in rank order, so
// every rank holds the same bits. Two slots alternate, so a slot is
// rewritten only after a barrier that follows every read of it.
template <int WARPS, int C>
struct Reducer {
  float2* buf;
  int slot;
  __device__ __forceinline__ float2 sum(float a, float b, int r) {
    a = warp_sum(a);
    b = warp_sum(b);
    float2* s = buf + slot * (WARPS + C);
    slot ^= 1;
    if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = make_float2(a, b);
    __syncthreads();
    if (threadIdx.x < 32) {
      float2 t = s[0];
#pragma unroll
      for (int k = 1; k < WARPS; ++k) {
        const float2 u = s[k];
        t.x += u.x;
        t.y += u.y;
      }
      if (threadIdx.x < C) st2_rank(reinterpret_cast<float*>(s + WARPS + r), threadIdx.x, t.x, t.y);
    }
    cluster_sync();
    float2 t = s[WARPS];
#pragma unroll
    for (int q = 1; q < C; ++q) {
      const float2 u = s[WARPS + q];
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

// Member b's hierarchy into rank r's shared memory: a split level's band
// with the halo rows its stencil reads (TX from the face above the band,
// zero past the last face; the reciprocal diagonal a row beyond each
// side), a gathered level whole; TY padded to m wide, diagonals with their
// reciprocals, the coarsest inverse transposed where it lives whole in
// shared memory.
template <class G, int l>
__device__ __forceinline__ void load_level(float* sh, const HierPtrs& h, int b, int r) {
  using V = Lvl<G, l>;
  constexpr int n = G::n(l), m = G::m(l), T = G::THREADS;
  if constexpr (l < G::LC) {
    constexpr int hal = G::split(l) ? 1 : 0;
    const int rows = G::rows_of(r, l), i0 = G::split(l) ? G::first(r, l) : 0;
    const float* tx = h.tx[l] + (size_t)b * (n - 1) * m;
    for (int k = threadIdx.x; k < (rows + hal - (G::split(l) ? 0 : 1)) * m; k += T) {
      const int g = (i0 - hal) * m + k;  // from the face above the band
      V::TX(sh)[k - hal * m] = g >= 0 && g < (n - 1) * m ? tx[g] : 0.0f;
    }
    const float* ty = h.ty[l] + (size_t)b * n * (m - 1);
    for (int k = threadIdx.x; k < rows * m; k += T) {
      const int i = k / m, j = k - i * m;
      V::TY(sh)[k] = j < m - 1 ? ty[(i0 + i) * (m - 1) + j] : 0.0f;
    }
    if constexpr (l > 0 || !G::kUnit) {
      const float* d = h.d[l] + (size_t)b * n * m;
      for (int k = threadIdx.x; k < (rows + 2 * hal) * m; k += T) {
        const int g = (i0 - hal) * m + k;
        if (g < 0 || g >= n * m) continue;
        const float v = d[g];
        V::D(sh)[k - hal * m] = v;
        V::RD(sh)[k - hal * m] = 1.0f / v;
      }
    }
    load_level<G, l + 1>(sh, h, b, r);
  } else if constexpr (G::kShared) {
    constexpr int nc = G::NC;
    const float* a = h.ainv + (size_t)b * nc * nc;
    float* At = sh + G::INVERSE;
    for (int k = threadIdx.x; k < nc * nc; k += T) {
      const int row = k / nc, c = k - row * nc;
      At[c * nc + row] = a[k];
    }
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Rank r's block of member b's inverse (rows r KR on, row-major as in
// device memory) into its shared memory with one bulk asynchronous copy
// (TMA), completing on the barrier at BAR, which thread 0 has initialised
// for one arrival. The copy moves 16-byte-aligned bytes between 16-byte-
// aligned addresses: the block lands 0-3 floats into its region so that it
// keeps its source's alignment, and the unaligned first and last floats
// (at most three each) go by plain loads. Returns where the block starts.
template <class G>
__device__ __forceinline__ const float* load_inverse(float* sh, const float* ainv, int b, int r) {
  constexpr int nc = G::NC, KR = G::KR;
  const int k0 = r * KR, rows = k0 >= nc ? 0 : k0 + KR < nc ? KR : nc - k0;
  const float* src = ainv + (size_t)b * nc * nc + (size_t)k0 * nc;
  const int phase = (int)((reinterpret_cast<size_t>(src) >> 2) & 3);
  float* dst = sh + G::INVERSE + phase;
  const int n = rows * nc, lead = (4 - phase) & 3, head = lead < n ? lead : n;
  const int mid = (n - head) / 4 * 4, tail = n - head - mid;
  const int t = threadIdx.x;
  if (t < head) dst[t] = src[t];
  if (t >= 32 && t < 32 + tail) dst[head + mid + t - 32] = src[head + mid + t - 32];
  if (t == 0) {
    const unsigned bar = smem_addr(sh + G::BAR), bytes = 4u * (unsigned)mid;
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

// Every thread waits for load_inverse's copy (the barrier's first phase).
template <class G>
__device__ __forceinline__ void wait_inverse(float* sh) {
  const unsigned bar = smem_addr(sh + G::BAR);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar)
        : "memory");
}

template <int NX, int NY, int C, int INV, int THR, bool CHEB, bool UNIT>
__global__ void __launch_bounds__(THR, (Geo<NX, NY, C, INV, THR, CHEB, UNIT>::MIN_BLOCKS))
pressure_pcg_cl_kernel(HierPtrs h, const float* __restrict__ q_g, const float* __restrict__ p0_g,
                       const float* __restrict__ w_g, float* __restrict__ p_out,
                       int* __restrict__ it_out, float* __restrict__ rel_out, float tol,
                       int maxiter, int restart_every, int patience) {
  using G = Geo<NX, NY, C, INV, THR, CHEB, UNIT>;
  using F = Lvl<G, 0>;
  constexpr int T = G::THREADS, TPT = G::TPT;
  extern __shared__ float4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  const int r = (int)cluster_rank(), b = blockIdx.x / C, tid = threadIdx.x;
  const size_t off = (size_t)b * NX * NY + (size_t)G::first(r, 0) * NY;  // the band's first cell
  const float* q = q_g + off;
  const float* Ainv = h.ainv + (size_t)b * G::NC * G::NC;
  float* xb = p_out + off;  // the best iterate lives here
  float* P = F::X(sh);
  float* R = F::B(sh);
  float* Tv = F::T(sh);
  const float* TX = F::TX(sh);
  const float* TY = F::TY(sh);
  const float* Df = UNIT ? nullptr : F::D(sh);
  Reducer<G::WARPS, C> red{reinterpret_cast<float2*>(sh + G::RED), 0};
  auto fine = [&](auto f) { tiles<G, 0, T>(tid, r, f); };
  if constexpr (G::kDist) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(sh + G::BAR))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  // every rank running before any stores into another's shared memory
  cluster_sync();

  // the inverse's rows arrive while the hierarchy loads and the residual runs
  if constexpr (G::kDist) Ainv = load_inverse<G>(sh, h.ainv, b, r);
  load_level<G, 0>(sh, h, b, r);
  float x[TPT][4] = {}, p[TPT][4] = {}, w[G::W_REGS ? TPT : 1][4] = {};
  fine([&](int k, int I, int J) {
    own<NY>(p0_g + off, I, J, x[k]);
    if constexpr (G::W_REGS) own<NY>(w_g + off, I, J, w[k]);
    put<NY>(xb, I, J, x[k]);
    put_band<G, 0>(Tv, I, J, r, x[k]);
  });
  cluster_sync();
  // The metric weight on tile k, (I, J) of the thread (`W_REGS`).
  auto weight = [&](int k, int I, int J, float wv[4]) {
    if constexpr (G::W_REGS) {
#pragma unroll
      for (int c = 0; c < 4; ++c) wv[c] = w[k][c];
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
      for (int c = 0; c < 4; ++c) {
        rv[c] = qv[c] - Ax[c];
        const float wr = wv[c] * rv[c], wq = wv[c] * qv[c];
        wr2 += wr * wr;
        wq2 += wq * wq;
      }
      put_band<G, 0>(R, I, J, r, rv);
    });
  };

  float wr2 = 0.0f, wq2 = 0.0f;
  residual(wr2, wq2);
  const float2 s0 = red.sum(wq2, wr2, r);
  const float bb = s0.x;
  float rr_best = s0.y;
  const float tol2 = (tol * tol) * fmaxf(bb, FLT_MIN);
  if constexpr (G::kDist) wait_inverse<G>(sh);  // also where no iteration runs

  bool use_sd = false, r_valid = true, first = true;
  int n_bad = 0, kk = 0;
  while (kk < maxiter && rr_best > tol2 && n_bad < patience) {
    if (!r_valid) {  // after a blow-up x was reset to the best iterate
      fine([&](int k, int I, int J) { put_band<G, 0>(Tv, I, J, r, x[k]); });
      cluster_sync();
      float unused = 0.0f;
      residual(unused, unused);
      cluster_sync();
    }
    vcycle<G>(sh, Ainv, r);
    const bool restart = use_sd || first;
    float prz = 0.0f, prr = 0.0f;
    fine([&](int k, int I, int J) {
      float rv[4], wv[4], zv[4];
      own<NY>(R, I, J, rv);
      own<NY>(P, I, J, zv);
      weight(k, I, J, wv);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        prz += rv[c] * zv[c];
        const float wr = wv[c] * rv[c];
        prr += wr * wr;
        if (restart) p[k][c] = zv[c];
      }
      put_band<G, 0>(P, I, J, r, p[k]);
    });
    float2 s = red.sum(prz, prr, r);
    float rz = s.x, rr = s.y;
    const float beta_mask = use_sd ? 0.0f : 1.0f;
    for (int it = 0; it < restart_every && rr > tol2; ++it) {
      // A p goes to T, free until the V-cycle, and is read back on the
      // thread's own cells, so no registers hold it across the reduction.
      float ppap = 0.0f;
      fine([&](int k, int I, int J) {
        const Tile pt = gather<G, 0>(P, I, J, r);
        float Ap[4];
        stencil<G, 0, UNIT>(TX, TY, Df, I, J, r, pt, Ap);
#pragma unroll
        for (int c = 0; c < 4; ++c) ppap += p[k][c] * Ap[c];
        put<NY>(Tv, I, J, Ap);
      });
      const float pAp = red.sum(ppap, 0.0f, r).x;
      const float alpha = rz / (pAp == 0.0f ? 1.0f : pAp);
      fine([&](int k, int I, int J) {
        float rv[4], Ap[4];
        own<NY>(R, I, J, rv);
        own<NY>(Tv, I, J, Ap);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          x[k][c] = x[k][c] + alpha * p[k][c];
          rv[c] = rv[c] - alpha * Ap[c];
        }
        put_band<G, 0>(R, I, J, r, rv);
      });
      cluster_sync();
      vcycle<G>(sh, Ainv, r);
      prz = prr = 0.0f;
      fine([&](int k, int I, int J) {
        float rv[4], wv[4], zv[4];
        own<NY>(R, I, J, rv);
        own<NY>(P, I, J, zv);
        weight(k, I, J, wv);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          prz += rv[c] * zv[c];
          const float wr = wv[c] * rv[c];
          prr += wr * wr;
        }
      });
      s = red.sum(prz, prr, r);
      const float beta = beta_mask * s.x / (rz == 0.0f ? 1.0f : rz);
      fine([&](int k, int I, int J) {
        float zv[4];
        own<NY>(P, I, J, zv);
#pragma unroll
        for (int c = 0; c < 4; ++c) p[k][c] = zv[c] + beta * p[k][c];
        put_band<G, 0>(P, I, J, r, p[k]);
      });
      rz = s.x;
      rr = s.y;
      cluster_sync();
    }
    // True residual of the window's iterate (residual replacement).
    fine([&](int k, int I, int J) { put_band<G, 0>(Tv, I, J, r, x[k]); });
    cluster_sync();
    float wr2n = 0.0f, unused = 0.0f;
    residual(wr2n, unused);
    const float rr_new = red.sum(wr2n, 0.0f, r).x;
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
  if (r == 0 && tid == 0) {
    it_out[b] = kk;
    rel_out[b] = sqrtf(rr_best / fmaxf(bb, FLT_MIN));
  }
  cluster_sync();  // no rank leaves while another may still store into it
}

template <bool CHEB, bool UNIT>
using GridGeo = Geo<HM_GRID_NX, HM_GRID_NY, HM_CL, HM_CL_INV, HM_CL_THREADS, CHEB, UNIT>;

template <bool CHEB, bool UNIT>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int B,
                      cudaStream_t stream) {
  using G = GridGeo<CHEB, UNIT>;
  auto kern =
      pressure_pcg_cl_kernel<HM_GRID_NX, HM_GRID_NY, HM_CL, HM_CL_INV, HM_CL_THREADS, CHEB, UNIT>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (e == cudaSuccess && G::kC > 8)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G::kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(B * G::kC);
  cfg->blockDim = dim3(G::THREADS);
  cfg->dynamicSmemBytes = G::BYTES;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return e;
}

template <bool CHEB, bool UNIT>
int launch(const float* const* lv, int n_levels, const float* ainv, const float* q,
           const float* p0, const float* w, float* p_out, int* it_out, float* rel_out, int B,
           float tol, int maxiter, int restart_every, int patience, cudaStream_t stream) {
  using G = GridGeo<CHEB, UNIT>;
  if constexpr (!G::FITS) {
    return (int)cudaErrorInvalidValue;  // this layout needs a larger cluster
  } else {
    if (n_levels != G::L || (!UNIT && lv[2] == nullptr)) return (int)cudaErrorInvalidValue;
    HierPtrs h{};
    for (int l = 0; l < G::L; ++l) {
      h.tx[l] = lv[3 * l];
      h.ty[l] = lv[3 * l + 1];
      h.d[l] = lv[3 * l + 2];
    }
    h.ainv = ainv;
    auto kern =
        pressure_pcg_cl_kernel<HM_GRID_NX, HM_GRID_NY, HM_CL, HM_CL_INV, HM_CL_THREADS, CHEB, UNIT>;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t e = configure<CHEB, UNIT>(&cfg, attr, B, stream);
    if (e != cudaSuccess) return (int)e;
    // A cluster the card cannot hold is refused before the launch.
    static int clusters = -1;
    if (clusters < 0) {
      e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
      if (e != cudaSuccess) return (int)e;
    }
    if (clusters == 0) return (int)cudaErrorLaunchOutOfResources;
    e = cudaLaunchKernelEx(&cfg, kern, h, q, p0, w, p_out, it_out, rel_out, tol, maxiter,
                           restart_every, patience);
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
    auto kern =
        pressure_pcg_cl_kernel<HM_GRID_NX, HM_GRID_NY, HM_CL, HM_CL_INV, HM_CL_THREADS, CHEB, UNIT>;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t e = configure<CHEB, UNIT>(&cfg, attr, 1, nullptr);
    cudaFuncAttributes a{};
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kern);
    int blocks = 0, clusters = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, G::THREADS, G::BYTES);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = G::BYTES;
    out[3] = G::THREADS;
    out[4] = blocks;
    out[5] = G::kC;
    out[6] = clusters;
    return (int)e;
  }
}

#ifdef HM_CL_PROBE
// Level l's rows, columns and array offsets (floats, of the halo row above
// where the level is split), in ops/pressure.py LEVEL_KEYS' order, as Lvl
// places them; the coarsest level's B and X only.
template <class G, int l>
void level_offsets(float* sh, int* out) {
  if constexpr (l < G::L) {
    using V = Lvl<G, l>;
    const int H = G::halo(l);
    int* o = out + 9 * l;
    o[0] = G::rows(l);
    o[1] = G::m(l);
    const bool coarsest = l == G::LC;
    o[2] = coarsest ? 0 : (int)(V::TX(sh) - sh) - H;
    o[3] = coarsest ? 0 : (int)(V::TY(sh) - sh) - H;
    o[4] = coarsest ? 0 : (int)(V::D(sh) - sh) - H;
    o[5] = coarsest ? 0 : (int)(V::RD(sh) - sh) - H;
    o[6] = (int)(V::B(sh) - sh) - H;
    o[7] = (int)(V::X(sh) - sh) - H;
    o[8] = coarsest ? 0 : (int)(V::T(sh) - sh) - H;
    level_offsets<G, l + 1>(sh, out);
  }
}

template <bool UNIT>
int layout_of(int* out) {
  using G = GridGeo<false, UNIT>;
  static float sh[G::FLOATS];  // only its addresses are taken
  out[0] = G::L;
  level_offsets<G, 0>(sh, out + 1);
  int* e = out + 1 + 9 * G::L;
  e[0] = G::INVERSE;
  e[1] = G::BAR;
  e[2] = G::RED;
  e[3] = G::FLOATS;
  return 0;
}
#endif

}  // namespace

#ifdef HM_CL_PROBE
// The probe build's entry points. The cluster barriers block 0 passed since
// the last call, into *out; the counter restarts from 0.
extern "C" int hm_pressure_cl_barriers(unsigned* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, g_cluster_barriers, sizeof(unsigned));
  const unsigned zero = 0;
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_cluster_barriers, &zero, sizeof(unsigned));
  return (int)e;
}

// A rank's layout as `Geo` and `Lvl` place it: out[0] the levels L, then
// for each level its rows, columns, TX, TY, D, RD, B, X and T
// (`level_offsets`), then the coarsest inverse's offset, its copy's
// barrier's, the reduction slots' and the floats a rank (at most 1 + 9 *
// kMaxLevels + 4 ints).
extern "C" int hm_pressure_cl_layout(int unit, int* out) {
  return unit ? layout_of<true>(out) : layout_of<false>(out);
}
#endif

// The arguments of hm_pressure_solve (pressure_pcg.cu): lv holds 3 *
// n_levels pointers, per level TX, TY, diag, each (B, ...) float32, the
// level-0 diag read only where unit is 0; cheb picks the smoother. This
// library is built for one grid and plan; another grid is refused.
extern "C" int hm_pressure_cl_solve(const float* const* lv, const float* ainv, const float* q,
                                    const float* p0, const float* w, float* p_out, int* it_out,
                                    float* rel_out, int B, int Nx, int Ny, int n_levels,
                                    float tol, int maxiter, int restart_every, int patience,
                                    int cheb, int unit, void* stream) {
  if (Nx != HM_GRID_NX || Ny != HM_GRID_NY) return (int)cudaErrorInvalidValue;
#define HM_CL_LAUNCH(c, u)                                                                    \
  launch<c, u>(lv, n_levels, ainv, q, p0, w, p_out, it_out, rel_out, B, tol, maxiter,        \
               restart_every, patience, (cudaStream_t)stream)
  if (cheb) return unit ? HM_CL_LAUNCH(true, true) : HM_CL_LAUNCH(true, false);
  return unit ? HM_CL_LAUNCH(false, true) : HM_CL_LAUNCH(false, false);
#undef HM_CL_LAUNCH
}

// out: registers a thread, local (stack and spill) bytes a thread, dynamic
// shared bytes a rank, threads a rank, resident blocks an SM, ranks a
// cluster, and the clusters the card holds at once.
extern "C" int hm_pressure_cl_info(int Nx, int Ny, int cheb, int unit, int* out) {
  if (Nx != HM_GRID_NX || Ny != HM_GRID_NY) return (int)cudaErrorInvalidValue;
  if (cheb) return unit ? info<true, true>(out) : info<true, false>(out);
  return unit ? info<false, true>(out) : info<false, false>(out);
}
