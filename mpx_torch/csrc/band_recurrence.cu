// K3: SCAMP diagonal-recurrence sweep of one self-join job, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mpx/kernels/pallas_tpu.py:_band_kernel
// (wrapper sweep_band_pallas).  For the rhombus rows [r0, r0+S) x diagonals
// [k0, k0+W) it carries QT along each diagonal with the O(1) update
//   QT(i, j) = QT(i-1, j) + U(i, j),
//   U(i, j)  = df_r[i] * dg_c[i+j] + df_c[i+j] * dg_r[i],
// from one exact seed per job at band row 0 (seed_qt, computed by the
// wrapper), forms P = QT * inv_r * inv_c, masks it (exclusion zone
// k0 + j >= excl, bounds r <= w-1 and c <= w-1, finite inverse norms, NaN;
// a masked pair is -1e12, never 0) and reduces it to the row max with the
// smallest column and the (S + W,) column max with the smallest row.
// P never reaches device memory.
//
// Bound: eight floating-point instructions a pair (the update: multiply,
// FMA, add; P: two multiplies; the NaN test; the row and the column
// comparison; here the NaN test is folded into the comparisons) of the
// statistics' type; device-memory traffic is O(S + W) statistics plus the
// partials.  So K3 is bound by instructions, and it reaches that bound only
// if the card is full of independent work.
//
// Arithmetic: float64 for float32 and float64 statistics alike (the seed,
// the segment sums, QT, P and the comparisons; the outputs are rounded to
// the statistics' type).  The float32 recurrence carries its rounding down
// the band, and near-constant windows amplify it: beside a constant run the
// plain float32 version is up to 1.1e-3 from the exact recurrence of the
// same statistics (PERF.md), so a float32 segment order, another rounding
// of the same sums, could not be held to 1e-4 of it.  In float64 the
// float32 tier is as exact as its statistics, at the float64 tier's cost:
// the FP64 units run at half the FP32 rate, so this halves the float32
// tier's headroom under its bound.
//
// What the first design (one thread per diagonal walking all S rows) lost:
// a job gave the card only W threads (128 blocks of 128 at W = 16384, about
// 4 warps on an SM that holds 64), each step of QT waited on the one before,
// and every 16 rows cost four block barriers, synchronous staging and a
// column reduce of 143 anti-diagonals by 128 threads.  It reached ~3 % of
// its bound at ~280 W.
//
// The design here, part by part:
//
// * Row segments carried by an in-order scan, not by reseeds.  Along a
//   diagonal QT is a prefix sum of the update terms:
//     QT(i, j) = seed(j) + sum_{t=1..i} U(t, j).
//   The band's rows are cut into segments of R rows; k3_segsum writes, for
//   each segment g but the last and each diagonal, the sum of that
//   segment's update terms in row order, and block (jb, g) of k3_tiles
//   starts each diagonal at seed[j] + seg[0][j] + ... + seg[g-1][j], added
//   in that order.  These are the sequential recurrence's own increments,
//   added in another order, so the result is deterministic and does not
//   depend on the block schedule.  Segment g's first row adds its own
//   update; only band row 0 takes the seed alone.  (Exact reseeds, a dot
//   product per segment, moved f64 results by 4.5e-10 against a 1e-12
//   tolerance in a probe before this design; on the CPU, a random walk
//   n = 65,536, m = 256, job r0 = 8192, k0 = 64, S = 4096, W = 1024, the
//   scan moved max |dP| against the sequential recurrence by 5.1e-14 to
//   6.4e-14 in f64 for R = 64..512 (3.5e-5 to 3.7e-5 in f32), exact reseeds
//   every 256 rows by 1.2e-12.)  At S = 4096, W = 16384 the grid is
//   (W / BW) x (S / R) = 128 x 16 blocks, not 128.
// * Several diagonals a thread.  A block is one warp; lane t owns the D
//   adjacent diagonals tD .. tD + D - 1 of the block's BW, so it runs D
//   independent QT chains, reduces its D pairs of a row in registers, and
//   slides a window of D column statistics down the rows, loading one
//   new column a row.  There is no block barrier at all.  Registers are
//   capped at 128 (TILES_PER_SM = 16 blocks an SM), which spills a few
//   bytes and ran faster than 137 registers and 12 blocks did.
// * Rows: every RR rows the lanes' (value, column) maxima are reduced by a
//   transposing butterfly (each exchange halves the rows a lane holds), a
//   little over one shuffle exchange per row and lane.
// * Columns: lane t's pairs of D consecutive rows touch 2D - 1 consecutive
//   columns, of which the first D are touched next by lane t - 1 in the
//   next D rows.  So each lane keeps 2D - 1 column accumulators in
//   registers and, every D rows, hands the lower D to lane t - 1 (a
//   shuffle) and merges the upper D - 1 into what lane t + 1 hands it:
//   a systolic column reduce with no shared memory; lane 0 writes the
//   completed columns.  The segment's last group is flushed by every lane.
// * Staging: each TR-row sub-tile's statistics (BW + TR - 1 columns, TR
//   rows) are copied by cp.async into one of two shared buffers while the
//   other is in use; a masked row or column gets a NaN inverse norm, so its
//   pairs' P is NaN and loses every comparison, and band row 0 gets a zero
//   update.  The column buffers are padded one element in 128 bytes, so
//   the lanes' stride-D reads hit distinct banks.
// * k3_segsum loads its segment's statistics whole into shared memory,
//   coalesced, before summing: stride-D reads of device memory bounded
//   it before.
// * Partials and reduce: rows (W/BW, S), block (jb, g) writing rows
//   [gR, gR + R); columns one (R + BW - 1) partial per (g, jb) block.
//   k3_reduce merges, for each row, the W/BW partials and, for each column,
//   every (g, jb) block that reaches it, spread over 8 warps per 32 outputs.
//   Every reduction orders by value descending, then index ascending: the
//   reference's tie rule, independent of the block schedule.
// The wrapper allocates all scratch; the kernels allocate nothing.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;
constexpr int D = 4;                  // adjacent diagonals per lane
constexpr int BW = LANES * D;         // diagonals per block (one warp)
constexpr int R = 256;                // rows per segment
constexpr int TR = 16;                // rows per staged sub-tile
constexpr int LOG2_RR = 3;
constexpr int RR = 1 << LOG2_RR;      // rows per register row reduce
constexpr int CW = BW + TR - 1;       // columns one sub-tile touches
constexpr int BCOLS = R + BW - 1;     // columns of one block's partial
constexpr int NSUB = R / TR;
constexpr int TILES_PER_SM = 16;      // k3_tiles blocks an SM should hold: caps registers
constexpr int REDUCE_THREADS = 256;
constexpr int RED_OUT = 32;                           // outputs per reduce block
constexpr int RED_SLICES = REDUCE_THREADS / RED_OUT;  // warps over an output's partials
constexpr unsigned FULL = 0xffffffffu;

// The recurrence's arithmetic type, for float32 and float64 statistics
// alike: a parallel order cannot keep float32's rounding down thousands of
// rows within the f32 tolerance (see the header).
using Acc = double;

static_assert(R % TR == 0 && TR % D == 0 && TR % RR == 0, "row tiling");
static_assert(RR <= LANES, "row reduce");

template <typename T>
__device__ __forceinline__ T aggregate_init() { return T(-1e12); }

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000ll);
}

// (v, i) <- the better of (v, i) and (v2, i2): larger value, then smaller index.
template <typename T>
__device__ __forceinline__ void take_better(T& v, int& i, T v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

// Column buffer slot of column x: one element of padding per 128 bytes.
template <typename T>
__host__ __device__ constexpr int col_slot(int x) { return x + x / (128 / (int)sizeof(T)); }

template <typename T>
struct Stage {
  T dfc[col_slot<T>(CW - 1) + 1], dgc[col_slot<T>(CW - 1) + 1], invc[col_slot<T>(CW - 1) + 1];
  T dfr[TR], dgr[TR], invr[TR];
};

template <int N>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(d), "l"(src), "n"(N), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy the statistics of the sub-tile whose first band row is i0 and first
// column (relative to c0) is t0; zero-fill what lies outside the job.
template <typename T>
__device__ __forceinline__ void stage_issue(Stage<T>& s, const T* df_r, const T* dg_r,
                                            const T* inv_r, const T* df_c, const T* dg_c,
                                            const T* inv_c, int i0, int t0, int S, int SW,
                                            int lane) {
  constexpr int E = sizeof(T);
  for (int x = lane; x < CW; x += LANES) {
    const int t = t0 + x;
    const int tt = t < SW ? t : 0;
    const int bytes = t < SW ? E : 0;
    const int p = col_slot<T>(x);
    cp_async_elem<E>(&s.dfc[p], df_c + tt, bytes);
    cp_async_elem<E>(&s.dgc[p], dg_c + tt, bytes);
    cp_async_elem<E>(&s.invc[p], inv_c + tt, bytes);
  }
  if (lane < TR) {
    const int i = i0 + lane;
    const int ii = i < S ? i : 0;
    const int bytes = i < S ? E : 0;
    cp_async_elem<E>(&s.dfr[lane], df_r + ii, bytes);
    cp_async_elem<E>(&s.dgr[lane], dg_r + ii, bytes);
    cp_async_elem<E>(&s.invr[lane], inv_r + ii, bytes);
  }
}

// Fold the masks into the staged statistics: a masked row or column gets a
// NaN inverse norm (so every pair on it fails the NaN test), band row 0 a
// zero update (it takes the seed alone).
template <typename T>
__device__ __forceinline__ void stage_fixup(Stage<T>& s, int i0, int t0, int r0, int c0,
                                            int S, int SW, int w, int lane) {
  for (int x = lane; x < CW; x += LANES) {
    const int t = t0 + x;
    const int p = col_slot<T>(x);
    if (!(t < SW && c0 + t <= w - 1 && isfinite(s.invc[p]))) s.invc[p] = quiet_nan<T>();
  }
  if (lane < TR) {
    const int i = i0 + lane;
    if (!(i < S && r0 + i <= w - 1 && isfinite(s.invr[lane]))) s.invr[lane] = quiet_nan<T>();
    if (i == 0) { s.dfr[lane] = T(0); s.dgr[lane] = T(0); }
  }
}

// Sum of segment g's update terms, in row order, for each diagonal; one
// block (one warp) per (diagonal block, segment), every segment but the
// last.  The segment's statistics (R rows, R + BW - 1 columns) are first
// loaded whole, coalesced, into shared memory: the lanes' stride-D reads
// of device memory were what bounded this pass.
template <typename T>
__global__ void __launch_bounds__(LANES)
k3_segsum(const T* __restrict__ df_r, const T* __restrict__ dg_r,
          const T* __restrict__ df_c, const T* __restrict__ dg_c,
          int S, int W, Acc* __restrict__ seg) {
  __shared__ Acc s_dfc[col_slot<Acc>(BCOLS - 1) + 1], s_dgc[col_slot<Acc>(BCOLS - 1) + 1];
  __shared__ Acc s_dfr[R], s_dgr[R];
  const int lane = threadIdx.x;
  const int g = blockIdx.y;
  const int j0 = blockIdx.x * BW;
  const int jl = lane * D;                   // this lane's first diagonal, block-relative
  const int SW = S + W;
  for (int x = lane; x < BCOLS; x += LANES) {
    const int t = g * R + j0 + x;
    s_dfc[col_slot<Acc>(x)] = t < SW ? Acc(df_c[t]) : Acc(0);
    s_dgc[col_slot<Acc>(x)] = t < SW ? Acc(dg_c[t]) : Acc(0);
  }
  for (int y = lane; y < R; y += LANES) {    // a full segment: not the last one
    const int i = g * R + y;
    s_dfr[y] = i > 0 ? Acc(df_r[i]) : Acc(0);  // band row 0 takes no update
    s_dgr[y] = i > 0 ? Acc(dg_r[i]) : Acc(0);
  }
  __syncwarp();
  Acc wdf[D], wdg[D], s[D];
#pragma unroll
  for (int d = 0; d < D - 1; ++d) {
    wdf[d + 1] = s_dfc[col_slot<Acc>(jl + d)];
    wdg[d + 1] = s_dgc[col_slot<Acc>(jl + d)];
  }
#pragma unroll
  for (int d = 0; d < D; ++d) s[d] = Acc(0);
#pragma unroll 4
  for (int y = 0; y < R; ++y) {
#pragma unroll
    for (int d = 0; d + 1 < D; ++d) { wdf[d] = wdf[d + 1]; wdg[d] = wdg[d + 1]; }
    wdf[D - 1] = s_dfc[col_slot<Acc>(y + jl + D - 1)];
    wdg[D - 1] = s_dgc[col_slot<Acc>(y + jl + D - 1)];
    const Acc dfr = s_dfr[y], dgr = s_dgr[y];
#pragma unroll
    for (int d = 0; d < D; ++d) s[d] += fma(dfr, wdg[d], wdf[d] * dgr);
  }
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (j0 + jl + d < W) seg[(size_t)g * W + j0 + jl + d] = s[d];
}

// Reduce RR rows' (value, column) maxima held by every lane (rv[k], ri[k]
// for row k) to one per row; lane l ends with row l / (LANES / RR) in
// rv[0], ri[0].
template <typename T>
__device__ __forceinline__ void reduce_rows(T (&rv)[RR], int (&ri)[RR], int lane) {
#pragma unroll
  for (int st = 0; st < LOG2_RR; ++st) {
    const int o = LANES >> (st + 1);
    const int h = RR >> (st + 1);
    const bool up = lane & o;
#pragma unroll
    for (int k = 0; k < h; ++k) {
      const T sv = up ? rv[k] : rv[k + h];
      const int si = up ? ri[k] : ri[k + h];
      T kv = up ? rv[k + h] : rv[k];
      int ki = up ? ri[k + h] : ri[k];
      take_better(kv, ki, __shfl_xor_sync(FULL, sv, o), __shfl_xor_sync(FULL, si, o));
      rv[k] = kv;
      ri[k] = ki;
    }
  }
#pragma unroll
  for (int o = LANES / RR / 2; o > 0; o >>= 1)
    take_better(rv[0], ri[0], __shfl_xor_sync(FULL, rv[0], o), __shfl_xor_sync(FULL, ri[0], o));
}

// One segment of one diagonal block: block (jb, g) sweeps band rows
// [gR, gR + R) x diagonals [jb BW, jb BW + BW).
template <typename T>
__global__ void __launch_bounds__(LANES, TILES_PER_SM)
k3_tiles(const T* __restrict__ df_r, const T* __restrict__ dg_r,
         const T* __restrict__ inv_r, const T* __restrict__ df_c,
         const T* __restrict__ dg_c, const T* __restrict__ inv_c,
         const Acc* __restrict__ seed, const Acc* __restrict__ seg, int r0, int k0,
         int S, int W, int w, int excl, T* __restrict__ part_rv,
         int* __restrict__ part_ri, T* __restrict__ part_cv, int* __restrict__ part_ci) {
  __shared__ Stage<T> stage[2];

  const Acc init = aggregate_init<Acc>();
  const int lane = threadIdx.x;
  const int jb = blockIdx.x;
  const int g = blockIdx.y;
  const int j0 = jb * BW;             // block's first diagonal
  const int jl = lane * D;            // lane's first diagonal, block-relative
  const int c0 = r0 + k0;
  const int SW = S + W;
  const int gr0 = g * R;              // segment's first band row

  // The carry: the seed plus the earlier segments' sums, in segment order.
  Acc qt[D];
  bool dok[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int j = j0 + jl + d;
    Acc q = Acc(0);
    if (j < W) {
      q = seed[j];
      for (int h = 0; h < g; ++h) q += seg[(size_t)h * W + j];
    }
    qt[d] = q;
    dok[d] = j < W && k0 + j >= excl;
  }

  // Column accumulators: av[e] is column (q + lane) D + e of the segment
  // during row group q (rows qD .. qD + D - 1).
  Acc av[2 * D - 1];
  int ai[2 * D - 1];
#pragma unroll
  for (int e = 0; e < 2 * D - 1; ++e) { av[e] = init; ai[e] = -1; }
  T* out_cv = part_cv + ((size_t)g * gridDim.x + jb) * BCOLS;
  int* out_ci = part_ci + ((size_t)g * gridDim.x + jb) * BCOLS;
  Acc rv[RR];
  int ri[RR];

  stage_issue(stage[0], df_r, dg_r, inv_r, df_c, dg_c, inv_c, gr0, gr0 + j0, S, SW, lane);
  cp_async_commit();
  for (int k = 0; k < NSUB; ++k) {
    const int i0 = gr0 + k * TR;      // band row of the sub-tile's first row
    if (k + 1 < NSUB)
      stage_issue(stage[(k + 1) & 1], df_r, dg_r, inv_r, df_c, dg_c, inv_c, i0 + TR,
                  i0 + TR + j0, S, SW, lane);
    cp_async_commit();                // possibly empty: keeps the group count
    cp_async_wait1();
    __syncwarp();
    Stage<T>& s = stage[k & 1];
    stage_fixup(s, i0, i0 + j0, r0, c0, S, SW, w, lane);
    __syncwarp();

    Acc wdf[D], wdg[D], winv[D];      // columns ii + jl + d of the sub-tile
#pragma unroll
    for (int d = 0; d < D - 1; ++d) {
      const int p = col_slot<T>(jl + d);
      wdf[d + 1] = s.dfc[p]; wdg[d + 1] = s.dgc[p]; winv[d + 1] = s.invc[p];
    }
#pragma unroll
    for (int ii = 0; ii < TR; ++ii) {
#pragma unroll
      for (int d = 0; d + 1 < D; ++d) { wdf[d] = wdf[d + 1]; wdg[d] = wdg[d + 1]; winv[d] = winv[d + 1]; }
      {
        const int p = col_slot<T>(ii + jl + D - 1);
        wdf[D - 1] = s.dfc[p]; wdg[D - 1] = s.dgc[p]; winv[D - 1] = s.invc[p];
      }
      const Acc dfr = s.dfr[ii], dgr = s.dgr[ii], ivr = s.invr[ii];
      const int r = ii % D;           // row within its group
      Acc v = init;
      int vd = 0;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        qt[d] += fma(dfr, wdg[d], wdf[d] * dgr);
        const Acc p = qt[d] * ivr * winv[d];
        // A NaN p (a masked row or column) fails both comparisons below.
        const Acc pm = dok[d] ? p : init;
        if (pm > v) { v = pm; vd = d; }
        if (pm > av[r + d]) { av[r + d] = pm; ai[r + d] = r0 + i0 + ii; }
      }
      rv[ii % RR] = v;
      ri[ii % RR] = c0 + i0 + ii + j0 + jl + vd;

      if (ii % RR == RR - 1) {
        reduce_rows(rv, ri, lane);
        const int i = i0 + ii - (RR - 1) + lane / (LANES / RR);
        if (lane % (LANES / RR) == 0 && i < S) {
          part_rv[(size_t)jb * S + i] = T(rv[0]);
          part_ri[(size_t)jb * S + i] = ri[0];
        }
      }

      // End of row group q: hand the lower D columns to lane - 1 (lane 0
      // writes them: complete), merge the upper D - 1 into lane + 1's.
      if (r == D - 1 && !(k == NSUB - 1 && ii == TR - 1)) {
        const int q = (k * TR + ii) / D;
        if (lane == 0) {
#pragma unroll
          for (int e = 0; e < D; ++e) { out_cv[q * D + e] = T(av[e]); out_ci[q * D + e] = ai[e]; }
        }
#pragma unroll
        for (int e = 0; e < D; ++e) {
          Acc nv = __shfl_down_sync(FULL, av[e], 1);
          int ni = __shfl_down_sync(FULL, ai[e], 1);
          if (lane == LANES - 1) { nv = init; ni = -1; }
          if (e < D - 1) take_better(nv, ni, av[e + D], ai[e + D]);
          av[e] = nv;
          ai[e] = ni;
        }
#pragma unroll
        for (int e = D; e < 2 * D - 1; ++e) { av[e] = init; ai[e] = -1; }
      }
    }
    __syncwarp();                     // the buffer is read: the next copy may land
  }

  // The segment's last row group: lane t's upper columns are lane t + 1's
  // lower ones; every lane writes its lower D, lane 31 also its upper D - 1.
  const int q = R / D - 1;
#pragma unroll
  for (int e = 0; e < D - 1; ++e) {
    const Acc v2 = __shfl_up_sync(FULL, av[e + D], 1);
    const int i2 = __shfl_up_sync(FULL, ai[e + D], 1);
    if (lane > 0) take_better(av[e], ai[e], v2, i2);
  }
#pragma unroll
  for (int e = 0; e < D; ++e) {
    out_cv[(q + lane) * D + e] = T(av[e]);
    out_ci[(q + lane) * D + e] = ai[e];
  }
  if (lane == LANES - 1) {
#pragma unroll
    for (int e = 0; e < D - 1; ++e) {
      out_cv[(q + LANES) * D + e] = T(av[e + D]);
      out_ci[(q + LANES) * D + e] = ai[e + D];
    }
  }
}

// Reduce the partials: a block either owns RED_OUT rows (one partial per
// diagonal block) or RED_OUT columns (every (g, jb) block whose partial
// reaches the column), its RED_SLICES warps splitting the partials.  An
// index stays -1 when the value is still the aggregate init.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
k3_reduce(const T* __restrict__ part_rv, const int* __restrict__ part_ri,
          const T* __restrict__ part_cv, const int* __restrict__ part_ci,
          int S, int W, int nbj, int G,
          T* __restrict__ row_v, int* __restrict__ row_i,
          T* __restrict__ col_v, int* __restrict__ col_i) {
  __shared__ T red_v[RED_SLICES][RED_OUT];
  __shared__ int red_i[RED_SLICES][RED_OUT];
  const T init = aggregate_init<T>();
  const int row_blocks = (S + RED_OUT - 1) / RED_OUT;
  const int lane = threadIdx.x % RED_OUT, q = threadIdx.x / RED_OUT;
  const bool rows = (int)blockIdx.x < row_blocks;
  const int t = (rows ? blockIdx.x : blockIdx.x - row_blocks) * RED_OUT + lane;
  T v = init;
  int idx = -1;
  if (rows) {
    if (t < S) {
#pragma unroll 4
      for (int b = q; b < nbj; b += RED_SLICES)
        take_better(v, idx, part_rv[(size_t)b * S + t], part_ri[(size_t)b * S + t]);
    }
  } else if (t < S + W) {
    for (int g = q; g < G && g * R <= t; g += RED_SLICES) {
      const int base = t - g * R;     // column relative to the segment's first
      const int first = base - BCOLS + 1;
      const int jlo = first <= 0 ? 0 : (first + BW - 1) / BW;
      const int jhi = min(nbj - 1, base / BW);
      for (int jb = jlo; jb <= jhi; ++jb) {
        const size_t at = ((size_t)g * nbj + jb) * BCOLS + (base - jb * BW);
        take_better(v, idx, part_cv[at], part_ci[at]);
      }
    }
  }
  red_v[q][lane] = v;
  red_i[q][lane] = idx;
  __syncthreads();
  if (q == 0 && t < (rows ? S : S + W)) {
#pragma unroll
    for (int p = 1; p < RED_SLICES; ++p) take_better(v, idx, red_v[p][lane], red_i[p][lane]);
    (rows ? row_v : col_v)[t] = v;
    (rows ? row_i : col_i)[t] = v > init ? idx : -1;
  }
}

// Ask for the largest shared-memory carveout for k3_tiles (the default one
// holds fewer of its blocks than its registers allow), once per device: the
// driver's job loop launches K3 thousands of times.
constexpr int MAX_DEVICES = 64;

template <typename T>
cudaError_t configure() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  err = cudaFuncSetAttribute(k3_tiles<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true, std::memory_order_relaxed);
  return err;
}

template <typename T>
int launch(const void* df_r, const void* dg_r, const void* inv_r,
           const void* df_c, const void* dg_c, const void* inv_c,
           const void* seed, int r0, int k0, int S, int W, int w, int excl,
           void* seg, void* part_rv, void* part_ri, void* part_cv, void* part_ci,
           void* row_v, void* row_i, void* col_v, void* col_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbj = (W + BW - 1) / BW;
  const int G = (S + R - 1) / R;
  cudaError_t err = configure<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G > 1) {
    k3_segsum<T><<<dim3(nbj, G - 1), LANES, 0, st>>>(
        static_cast<const T*>(df_r), static_cast<const T*>(dg_r),
        static_cast<const T*>(df_c), static_cast<const T*>(dg_c), S, W,
        static_cast<Acc*>(seg));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  k3_tiles<T><<<dim3(nbj, G), LANES, 0, st>>>(
      static_cast<const T*>(df_r), static_cast<const T*>(dg_r),
      static_cast<const T*>(inv_r), static_cast<const T*>(df_c),
      static_cast<const T*>(dg_c), static_cast<const T*>(inv_c),
      static_cast<const Acc*>(seed), static_cast<const Acc*>(seg), r0, k0, S, W, w, excl,
      static_cast<T*>(part_rv), static_cast<int*>(part_ri),
      static_cast<T*>(part_cv), static_cast<int*>(part_ci));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (S + RED_OUT - 1) / RED_OUT + (S + W + RED_OUT - 1) / RED_OUT;
  k3_reduce<T><<<blocks, REDUCE_THREADS, 0, st>>>(
      static_cast<const T*>(part_rv), static_cast<const int*>(part_ri),
      static_cast<const T*>(part_cv), static_cast<const int*>(part_ci), S, W,
      nbj, G, static_cast<T*>(row_v), static_cast<int*>(row_i),
      static_cast<T*>(col_v), static_cast<int*>(col_i));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int resident_blocks(int which) {
  int n = 0;
  cudaError_t err = configure<T>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  err =
      which == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k3_segsum<T>, LANES, 0)
      : which == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k3_tiles<T>, LANES, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k3_reduce<T>, REDUCE_THREADS, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

extern "C" {

int mpx_k3_block_w() { return BW; }
int mpx_k3_segment_rows() { return R; }
int mpx_k3_block_columns() { return BCOLS; }

// Resident blocks per SM of k3_segsum (which = 0), k3_tiles (1) or
// k3_reduce (2) in f64 (f64 != 0) or f32; a negative cudaError_t on failure.
int mpx_k3_resident_blocks(int f64, int which) {
  return f64 ? resident_blocks<double>(which) : resident_blocks<float>(which);
}

// One job: segment sums (when the band has more than one segment), sweep,
// then partial reduce, all on `stream`.  Returns a cudaError_t (0 on
// success).  Pointers are device pointers: the row statistics (S,) from r0,
// the column statistics (S + W,) from c0 = r0 + k0, the (W,) float64 seed
// QT(r0, c0 + j).  Scratch: float64 segment sums (G - 1, W) with
// G = ceil(S / R) (unused when G = 1); partials rows (ceil(W/BW), S), columns
// (G * ceil(W/BW), mpx_k3_block_columns()); outputs rows (S,), columns (S + W,).
int mpx_k3_sweep_f32(const void* df_r, const void* dg_r, const void* inv_r,
                     const void* df_c, const void* dg_c, const void* inv_c,
                     const void* seed, int r0, int k0, int S, int W, int w,
                     int excl, void* seg, void* part_rv, void* part_ri,
                     void* part_cv, void* part_ci, void* row_v, void* row_i,
                     void* col_v, void* col_i, void* stream) {
  return launch<float>(df_r, dg_r, inv_r, df_c, dg_c, inv_c, seed, r0, k0, S,
                       W, w, excl, seg, part_rv, part_ri, part_cv, part_ci,
                       row_v, row_i, col_v, col_i, stream);
}

int mpx_k3_sweep_f64(const void* df_r, const void* dg_r, const void* inv_r,
                     const void* df_c, const void* dg_c, const void* inv_c,
                     const void* seed, int r0, int k0, int S, int W, int w,
                     int excl, void* seg, void* part_rv, void* part_ri,
                     void* part_cv, void* part_ci, void* row_v, void* row_i,
                     void* col_v, void* col_i, void* stream) {
  return launch<double>(df_r, dg_r, inv_r, df_c, dg_c, inv_c, seed, r0, k0, S,
                        W, w, excl, seg, part_rv, part_ri, part_cv, part_ci,
                        row_v, row_i, col_v, col_i, stream);
}

}  // extern "C"
