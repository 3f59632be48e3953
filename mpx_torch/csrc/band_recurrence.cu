// K3: SCAMP diagonal-recurrence sweep of self-join jobs, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mpx/kernels/pallas_tpu.py:_band_kernel
// (wrapper sweep_band_pallas).  For the rhombus rows [r0, r0+S) x diagonals
// [k0, k0+W) it carries QT along each diagonal with the O(1) update
//   QT(i, j) = QT(i-1, j) + U(i, j),
//   U(i, j)  = df_r[i] * dg_c[i+j] + df_c[i+j] * dg_r[i],
// from one exact seed per job at band row 0 (k3_seed, seed_qt's form),
// forms P = QT * inv_r * inv_c, masks it (exclusion zone
// k0 + j >= excl, bounds r <= w-1 and c <= w-1, finite inverse norms, NaN;
// a masked pair is -1e12, never 0) and reduces it to the row max with the
// smallest column and the (S + W,) column max with the smallest row.
// P never reaches device memory.
//
// Bound: eight floating-point instructions a pair (the update: multiply,
// FMA, add; P: two multiplies; the NaN test; the row and the column
// comparison) of the statistics' type; device-memory traffic is O(S + W)
// statistics plus the partials.  So K3 is bound by instructions.  Here a
// pair takes six FP64 instructions: the update is two dependent FMAs,
//   QT = fma(df_c[i+j], dg_r[i], fma(df_r[i], dg_c[i+j], QT)),
// another rounding of the same sum in float64, and the NaN test is folded
// into the comparisons.  An FP64 instruction holds the pipe two cycles a
// warp and a sub-partition issues one instruction a cycle, so the loop runs
// at the FP64 rate only while a pair costs at most twelve issue slots: the
// selects, shared loads, shuffles and staging around the arithmetic are what
// this design counts (PERF.md section 6 has the census).
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
// * Row segments, as few as fill the card.  Along a diagonal QT is a
//   prefix sum of the update terms:
//     QT(i, j) = seed(j) + sum_{t=1..i} U(t, j).
//   A block of k3_tiles sweeps one row segment of L rows (a multiple of
//   R = 256, the staging chunk) of one diagonal block: it stages R rows at
//   a time and keeps the carry, the sliding column window and the column
//   accumulators in registers across the chunks, so a segment is one
//   unbroken run of the recurrence.  The host picks L once a call, from the
//   job's shape and the card alone (recurrence.segment_rows): the fewest
//   segments for which one full batch of jobs fills 90 % of a wave of
//   k3_tiles blocks.  At S = 4096, W = 16384 on an H100 that is one
//   segment a job: 16 jobs x 64 diagonal blocks, one wave at 97 % of 132 x
//   8 slots, every diagonal carried from its seed down all S rows in the
//   plain recurrence's own row order, and k3_segsum does not run.  With
//   several segments (narrow chunks: too few diagonal blocks to fill the
//   card), k3_segsum first writes, for each segment g but the last and each
//   diagonal, the sum of that segment's update terms in row order, and
//   block (jb, g) starts each diagonal at seed[j] + seg[0][j] + ... +
//   seg[g-1][j], added in that order.  These are the sequential
//   recurrence's own increments, added in another order, so the result is
//   deterministic and does not depend on the block schedule; since L never
//   depends on the batch, a job rounds the same in any batch.  Segment g's
//   first row adds its own update; only band row 0 takes the seed alone.
//   (Exact reseeds, a dot product per segment, moved f64 results by
//   4.5e-10 against a 1e-12 tolerance in a probe before this design; on the
//   CPU, a random walk n = 65,536, m = 256, job r0 = 8192, k0 = 64, S =
//   4096, W = 1024, the segment order moved max |dP| against the sequential
//   recurrence by 5.1e-14 to 6.4e-14 in f64 for L = 64..512 (3.5e-5 to
//   3.7e-5 in f32), exact reseeds every 256 rows by 1.2e-12.)
// * Several diagonals a thread.  A block is one warp; lane t owns the D = 8
//   adjacent diagonals tD .. tD + D - 1 of the block's BW = 256, so it runs
//   D independent QT chains, reduces its D pairs of a row in registers, and
//   slides a window of D column statistics down the rows, loading one
//   new column a row.  There is no block barrier at all.  The row reduce
//   and the column hand-off cost the same per row whatever D, so eight
//   diagonals share them among twice the pairs four did.  At 255 registers
//   (TILES_PER_SM = 8) nothing spills; capped at 168 for more blocks an SM
//   it spills or runs slower (PERF.md section 6).
// * Exclusion zone: a diagonal in it, or past W, starts its carry at NaN,
//   so its pairs lose every comparison as a masked row's or column's do;
//   the pair loop has no mask of its own.
// * Rows: each lane writes its row maximum (value, column) to shared memory;
//   every TR = 16 rows two lanes a row take half of its lanes each, in lane
//   order, and one shuffle joins the halves.  A shuffle butterfly in
//   registers took a third of the sweep's time.
// * Columns: at row y lane t's pairs touch columns y + tD .. y + tD + D - 1;
//   after the row, column y + tD is next touched by lane t - 1, as its last
//   column, in the next D rows, and by no other lane meanwhile.  So each
//   lane keeps D column accumulators in registers and, every row, hands
//   its first to lane t - 1 (one shuffle exchange, no merge), and lane 0
//   writes the completed column.  The segment's last columns are flushed
//   by every lane.
// * Staging: a block loads its segment's statistics R rows at a time (R
//   rows, R + BW - 1 columns) into shared memory, coalesced, folding in the
//   masks: a masked row or column gets a NaN inverse norm, so its pairs' P
//   is NaN and loses every comparison, and band row 0 gets a zero update.
//   Column x sits in class x % D at position x / D, so a row's new columns
//   are consecutive across the lanes (no bank conflict) at an address that
//   is a register a sub-tile plus a constant.  Staging every 16 rows the
//   ~BW columns a sub-tile reaches, and masking them, took a fifth of the
//   time.  A segment's last chunk is the last that reaches a row of the
//   job: a block sweeps no chunk wholly past S.
// * k3_segsum loads each chunk of its segment's statistics whole into
//   shared memory, coalesced, before summing it: stride-D reads of device
//   memory bounded it before.
// * Partials and merge: rows (W/BW, S), block (jb, g) writing rows
//   [gL, gL + L); columns one (L + BW - 1) partial per (g, jb) block, of
//   which a last segment cut short by S writes its swept rows + BW - 1.
//   k3_merge reduces, for each row, the W/BW partials and, for each column,
//   every (g, jb) block that reaches it, spread over 8 warps per 32 outputs.
//   Every reduction orders by value descending, then index ascending: the
//   reference's tie rule, independent of the block schedule.
// * Batches (mpx_k3_sweep_batch_*, the one entry): a loop over a
//   self-join's jobs with one launch each cost ~0.43 ms of host work a job
//   (a seed of ~10 torch ops, seven allocations, the launch, two merges)
//   against 0.16 ms of these kernels, so the card idled most of a
//   self-join.  A batch is B jobs in one launch of each kernel: k3_segsum
//   and k3_tiles take their job from blockIdx.z and its r0 / k0 from device
//   arrays, and find their rows and columns in the whole statistics
//   vectors.  The jobs of a batch are any consecutive jobs of a call, at
//   any k0.  k3_seed computes every job's seed (seed_qt's
//   cancellation-resistant form) and k3_merge reduces each job's partials
//   and max-merges them straight into the global row and column
//   aggregates, the jobs that reach an output in batch order with a strict
//   >: the incumbent, then the earlier job, wins a tie, as job after job
//   through merge_window.  Its blocks step over the batch's span of rows
//   and columns 32 outputs at a time, and each warp finds the jobs that
//   reach an output span with one ballot, so the span between jobs far
//   apart (a batch across a k0 change, or anytime's shuffled jobs) costs a
//   few instructions a 32 outputs.  One job is a batch of one.
// The wrapper allocates all scratch; the kernels allocate nothing.

#include <atomic>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;
constexpr int D = 8;                  // adjacent diagonals per lane
constexpr int BW = LANES * D;         // diagonals per block (one warp)
constexpr int R = 256;                // rows a chunk: a segment is staged R rows at a time
constexpr int TR = 16;                // rows per sub-tile: the row reduce's batch
constexpr int BCOLS = R + BW - 1;     // columns a chunk's pairs reach
constexpr int NSUB = R / TR;
constexpr int TILES_PER_SM = 8;       // k3_tiles blocks an SM should hold: caps registers
constexpr int REDUCE_THREADS = 256;
constexpr int RED_OUT = 32;                           // outputs per reduce step
constexpr int RED_SLICES = REDUCE_THREADS / RED_OUT;  // warps over an output's partials
constexpr int SEED_THREADS = 256;     // k3_seed: columns a block, one a thread
constexpr int SEED_M = 256;           // k3_seed: query elements staged at a time
constexpr unsigned FULL = 0xffffffffu;

// The recurrence's arithmetic type, for float32 and float64 statistics
// alike: a parallel order cannot keep float32's rounding down thousands of
// rows within the f32 tolerance (see the header).
using Acc = double;

static_assert(R % TR == 0 && TR % D == 0, "row tiling");
static_assert(LANES == 2 * TR, "row reduce: two lanes a row");
static_assert(RED_OUT == LANES, "k3_merge: one output a lane");
constexpr int MERGE_WAVES = 4;        // k3_merge's grid: at most this many waves of blocks

template <typename T>
__device__ __forceinline__ T aggregate_init() { return T(-1e12); }

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000ll);
}

// The jobs of a launch: block z sweeps job z, whose band rows start at
// r0s[z] and diagonals at k0s[z] (device arrays).
struct Jobs {
  const int* r0s;
  const int* k0s;
};

__device__ __forceinline__ int2 job_at(const Jobs& jobs, int z) {
  return make_int2(__ldg(jobs.r0s + z), __ldg(jobs.k0s + z));
}

// (v, i) <- the better of (v, i) and (v2, i2): larger value, then smaller index.
template <typename T>
__device__ __forceinline__ void take_better(T& v, int& i, T v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

// Column buffer slot of column x: one element of padding per 128 bytes.
template <typename T>
__host__ __device__ constexpr int col_slot(int x) { return x + x / (128 / (int)sizeof(T)); }

// A chunk of a k3_tiles block's statistics: R rows and the BCOLS columns
// their pairs reach, column x at [x % D][x / D].  At a row every lane's new
// column is in one class, at consecutive positions: the reads are
// conflict-free, and their addresses a register a sub-tile plus constants.
template <typename T>
struct Chunk {
  T dfc[D][BCOLS / D + 1], dgc[D][BCOLS / D + 1], invc[D][BCOLS / D + 1];
  T dfr[R], dgr[R], invr[R];
};

// The lanes' row maxima of one sub-tile: row ii's of lane t at [ii][t],
// rows padded so both the writes and the reduce's reads are conflict-free.
struct RowMaxima {
  Acc v[TR][LANES + 1];
  int i[TR][LANES + 1];
};

// Load the chunk's rows [gr0, gr0 + R) and columns [t0, t0 + BCOLS) (t0
// relative to c0) with the masks folded in: a masked row or column (past
// the job or the profile, or a non-finite inverse norm) gets a NaN inverse
// norm, so every pair on it is NaN and loses every comparison; band row 0 a
// zero update (it takes the seed alone).
template <typename T>
__device__ __forceinline__ void stage_chunk(Chunk<T>& s, const T* __restrict__ df,
                                            const T* __restrict__ dg,
                                            const T* __restrict__ inv, int r0, int c0,
                                            int gr0, int t0, int S, int SW, int w,
                                            int lane) {
  const T nan = quiet_nan<T>();
#pragma unroll 4
  for (int x = lane; x < BCOLS; x += LANES) {
    const int t = t0 + x;
    const bool in = t < SW;
    const T iv = in ? inv[c0 + t] : T(0);
    s.dfc[x % D][x / D] = in ? df[c0 + t] : T(0);
    s.dgc[x % D][x / D] = in ? dg[c0 + t] : T(0);
    s.invc[x % D][x / D] = in && c0 + t <= w - 1 && isfinite(iv) ? iv : nan;
  }
#pragma unroll 4
  for (int y = lane; y < R; y += LANES) {
    const int i = gr0 + y;
    const bool in = i < S;
    const T iv = in ? inv[r0 + i] : T(0);
    s.dfr[y] = in && i > 0 ? df[r0 + i] : T(0);
    s.dgr[y] = in && i > 0 ? dg[r0 + i] : T(0);
    s.invr[y] = in && r0 + i <= w - 1 && isfinite(iv) ? iv : nan;
  }
}

// Row r of a sub-tile's maxima, over lanes [h LANES / 2, (h + 1) LANES / 2):
// the lanes' columns rise with the lane, so taking a later lane's only on a
// strict > keeps the smallest column of a tie.  Four runs of four lanes,
// then the runs in order.
__device__ __forceinline__ void row_half_max(const RowMaxima& rows, int r, int h, Acc& v,
                                             int& vi) {
  constexpr int RUN = LANES / 2 / 4;
  Acc rv[4];
  int ri[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int t0 = h * (LANES / 2) + q * RUN;
    rv[q] = rows.v[r][t0];
    ri[q] = rows.i[r][t0];
#pragma unroll
    for (int t = 1; t < RUN; ++t) {
      const Acc v2 = rows.v[r][t0 + t];
      const int i2 = rows.i[r][t0 + t];
      if (v2 > rv[q]) { rv[q] = v2; ri[q] = i2; }
    }
  }
  v = rv[0];
  vi = ri[0];
#pragma unroll
  for (int q = 1; q < 4; ++q)
    if (rv[q] > v) { v = rv[q]; vi = ri[q]; }
}

// Sum of segment g's update terms, in row order, for each diagonal; one
// block (one warp) per (diagonal block, segment), every segment but the
// last (so every row it sums lies in the job), for job blockIdx.z (segment
// sums (G - 1, W) a job).  Segments are L rows, summed R rows at a time:
// each chunk's statistics (R rows, R + BW - 1 columns) are first loaded
// whole, coalesced, into shared memory (the lanes' stride-D reads of device
// memory were what bounded this pass), and the sums and the column window
// carry across the chunks in registers.
template <typename T>
__global__ void __launch_bounds__(LANES)
k3_segsum(const T* __restrict__ df, const T* __restrict__ dg, Jobs jobs,
          int S, int W, int L, Acc* __restrict__ seg) {
  __shared__ Acc s_dfc[col_slot<Acc>(BCOLS - 1) + 1], s_dgc[col_slot<Acc>(BCOLS - 1) + 1];
  __shared__ Acc s_dfr[R], s_dgr[R];
  const int2 job = job_at(jobs, blockIdx.z);
  const T* df_r = df + job.x;
  const T* dg_r = dg + job.x;
  const T* df_c = df + job.x + job.y;
  const T* dg_c = dg + job.x + job.y;
  seg += (size_t)blockIdx.z * gridDim.y * W;
  const int lane = threadIdx.x;
  const int g = blockIdx.y;
  const int j0 = blockIdx.x * BW;
  const int jl = lane * D;                   // this lane's first diagonal, block-relative
  Acc wdf[D], wdg[D], s[D];
#pragma unroll
  for (int d = 0; d < D; ++d) s[d] = Acc(0);
  for (int cr0 = g * L; cr0 < (g + 1) * L; cr0 += R) {
    __syncwarp();                            // the last chunk is read
    for (int x = lane; x < BCOLS; x += LANES) {
      const int t = cr0 + j0 + x;
      s_dfc[col_slot<Acc>(x)] = t < S + W ? Acc(df_c[t]) : Acc(0);
      s_dgc[col_slot<Acc>(x)] = t < S + W ? Acc(dg_c[t]) : Acc(0);
    }
    for (int y = lane; y < R; y += LANES) {
      const int i = cr0 + y;
      s_dfr[y] = i > 0 ? Acc(df_r[i]) : Acc(0);  // band row 0 takes no update
      s_dgr[y] = i > 0 ? Acc(dg_r[i]) : Acc(0);
    }
    __syncwarp();
    if (cr0 == g * L) {
#pragma unroll
      for (int d = 0; d < D - 1; ++d) {
        wdf[d + 1] = s_dfc[col_slot<Acc>(jl + d)];
        wdg[d + 1] = s_dgc[col_slot<Acc>(jl + d)];
      }
    }
#pragma unroll 4
    for (int y = 0; y < R; ++y) {
#pragma unroll
      for (int d = 0; d + 1 < D; ++d) { wdf[d] = wdf[d + 1]; wdg[d] = wdg[d + 1]; }
      wdf[D - 1] = s_dfc[col_slot<Acc>(y + jl + D - 1)];
      wdg[D - 1] = s_dgc[col_slot<Acc>(y + jl + D - 1)];
      const Acc dfr = s_dfr[y], dgr = s_dgr[y];
#pragma unroll
      for (int d = 0; d < D; ++d) s[d] = fma(wdf[d], dgr, fma(dfr, wdg[d], s[d]));
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (j0 + jl + d < W) seg[(size_t)g * W + j0 + jl + d] = s[d];
}

// One segment of one diagonal block of job blockIdx.z: block (jb, g, z)
// sweeps band rows [gL, min(gL + L, S)) x diagonals [jb BW, jb BW + BW), R
// rows at a time.  A job's seed is (W,), its segment sums (G - 1, W), its
// partials (nbj, S) and (G nbj, L + BW - 1), each job's after the one
// before.
template <typename T>
__global__ void __launch_bounds__(LANES, TILES_PER_SM)
k3_tiles(const T* __restrict__ df, const T* __restrict__ dg, const T* __restrict__ inv,
         Jobs jobs, const Acc* __restrict__ seed, const Acc* __restrict__ seg,
         int S, int W, int L, int w, int excl, T* __restrict__ part_rv,
         int* __restrict__ part_ri, T* __restrict__ part_cv, int* __restrict__ part_ci) {
  __shared__ Chunk<T> s;
  __shared__ RowMaxima rows;

  const int2 job = job_at(jobs, blockIdx.z);
  const int r0 = job.x, k0 = job.y;
  const int c0 = r0 + k0;
  const int pcols = L + BW - 1;       // columns of a block's partial
  {
    const size_t z = blockIdx.z;
    seed += z * W;
    seg += z * (gridDim.y - 1) * W;
    part_rv += z * gridDim.x * S;
    part_ri += z * gridDim.x * S;
    part_cv += z * gridDim.y * gridDim.x * pcols;
    part_ci += z * gridDim.y * gridDim.x * pcols;
  }
  const Acc init = aggregate_init<Acc>();
  const int lane = threadIdx.x;
  const int jb = blockIdx.x;
  const int g = blockIdx.y;
  const int j0 = jb * BW;             // block's first diagonal
  const int jl = lane * D;            // lane's first diagonal, block-relative
  const int SW = S + W;
  const int gr0 = g * L;              // segment's first band row
  const int nch = (min(L, S - gr0) + R - 1) / R;  // chunks that reach a row of the job

  // The carry: the seed plus the earlier segments' sums, in segment order
  // (with one segment, the seed alone).  A diagonal outside the job (j >= W)
  // or in the exclusion zone starts at NaN, so every pair on it is NaN and
  // loses every comparison below, as a masked row or column does
  // (stage_chunk).
  Acc qt[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int j = j0 + jl + d;
    Acc q = quiet_nan<Acc>();
    if (j < W && k0 + j >= excl) {
      q = seed[j];
      for (int h = 0; h < g; ++h) q += seg[(size_t)h * W + j];
    }
    qt[d] = q;
  }

  // Column accumulators: during segment row y, av[d] is column y + jl + d of
  // the block's partial, the column of this lane's diagonal d.
  Acc av[D];
  int ai[D];
#pragma unroll
  for (int d = 0; d < D; ++d) { av[d] = init; ai[d] = -1; }
  T* out_cv = part_cv + ((size_t)g * gridDim.x + jb) * pcols;
  int* out_ci = part_ci + ((size_t)g * gridDim.x + jb) * pcols;

  stage_chunk(s, df, dg, inv, r0, c0, gr0, gr0 + j0, S, SW, w, lane);
  __syncwarp();

  // The column window: at row y, columns y + jl + d.  It, the carry and the
  // column accumulators run on across the chunks.
  Acc wdf[D], wdg[D], winv[D];
#pragma unroll
  for (int d = 0; d < D - 1; ++d) {   // column jl + d: class d, position lane
    wdf[d + 1] = s.dfc[d][lane]; wdg[d + 1] = s.dgc[d][lane]; winv[d + 1] = s.invc[d][lane];
  }
  for (int ch = 0;;) {
    const int cr0 = gr0 + ch * R;     // chunk's first band row
    for (int k = 0; k < NSUB; ++k) {
#pragma unroll
      for (int ii = 0; ii < TR; ++ii) {
        const int y = k * TR + ii;    // chunk row
#pragma unroll
        for (int d = 0; d + 1 < D; ++d) {
          wdf[d] = wdf[d + 1]; wdg[d] = wdg[d + 1]; winv[d] = winv[d + 1];
        }
        {
          // Column y + jl + D - 1 of the chunk.
          const int c = (ii + D - 1) % D, q = lane + k * (TR / D) + (ii + D - 1) / D;
          wdf[D - 1] = s.dfc[c][q]; wdg[D - 1] = s.dgc[c][q]; winv[D - 1] = s.invc[c][q];
        }
        const Acc dfr = s.dfr[y], dgr = s.dgr[y], ivr = s.invr[y];
        Acc v = init;
        int vd = 0;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          qt[d] = fma(wdf[d], dgr, fma(dfr, wdg[d], qt[d]));
          const Acc p = qt[d] * ivr * winv[d];
          // A NaN p (a masked row, column or diagonal) fails both comparisons.
          if (p > v) { v = p; vd = d; }
          if (p > av[d]) { av[d] = p; ai[d] = r0 + cr0 + y; }
        }
        rows.v[ii][lane] = v;
        rows.i[ii][lane] = c0 + cr0 + y + j0 + jl + vd;

        // Column y + jl leaves this lane: no later row of the segment
        // reaches it here, and the next D rows reach it in lane - 1 (as its
        // av[D - 1]).  Lane 0's is complete: it writes it.  Lane 31 starts
        // column y + BW.
        if (lane == 0) { out_cv[cr0 - gr0 + y] = T(av[0]); out_ci[cr0 - gr0 + y] = ai[0]; }
        const Acc nv = __shfl_down_sync(FULL, av[0], 1);
        const int ni = __shfl_down_sync(FULL, ai[0], 1);
#pragma unroll
        for (int d = 0; d + 1 < D; ++d) { av[d] = av[d + 1]; ai[d] = ai[d + 1]; }
        av[D - 1] = lane == LANES - 1 ? init : nv;
        ai[D - 1] = lane == LANES - 1 ? -1 : ni;
      }

      // The sub-tile's row maxima: lanes r and r + TR each take half of row
      // r's lanes; the lower half's columns are the smaller, so the upper
      // half's maximum wins only a strict >.
      __syncwarp();
      {
        const int r = lane % TR, h = lane / TR;
        Acc v;
        int vi;
        row_half_max(rows, r, h, v, vi);
        const Acc v2 = __shfl_down_sync(FULL, v, TR);
        const int i2 = __shfl_down_sync(FULL, vi, TR);
        if (v2 > v) { v = v2; vi = i2; }
        const int i = cr0 + k * TR + r;
        if (h == 0 && i < S) {
          part_rv[(size_t)jb * S + i] = T(v);
          part_ri[(size_t)jb * S + i] = vi;
        }
      }
      __syncwarp();                   // rows and s are read: they may be written again
    }
    if (++ch == nch) break;
    stage_chunk(s, df, dg, inv, r0, c0, gr0 + ch * R, gr0 + ch * R + j0, S, SW, w, lane);
    __syncwarp();
  }

  // The columns the segment's rows left in the lanes: nch R + jl + d, all
  // but lane 31's last (which no row reached).
  const int swept = nch * R;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (jl + d < BW - 1) {
      out_cv[swept + jl + d] = T(av[d]);
      out_ci[swept + jl + d] = ai[d];
    }
  }
}

// One job's partials at its row t (rows) or column t (relative to c0): warp
// q of a reduce block takes every RED_SLICES-th partial that reaches it
// (one per diagonal block for a row, every (g, jb) block whose partial
// reaches the column), into (v, idx).
template <typename T>
__device__ __forceinline__ void reduce_partials(
    const T* __restrict__ part_rv, const int* __restrict__ part_ri,
    const T* __restrict__ part_cv, const int* __restrict__ part_ci, bool rows, int t,
    int q, int S, int L, int nbj, int G, T& v, int& idx) {
  if (rows) {
#pragma unroll 4
    for (int b = q; b < nbj; b += RED_SLICES)
      take_better(v, idx, part_rv[(size_t)b * S + t], part_ri[(size_t)b * S + t]);
    return;
  }
  for (int g = q; g < G && g * L <= t; g += RED_SLICES) {
    const int base = t - g * L;       // column relative to the segment's first
    // The columns a block of segment g wrote: its swept rows + BW - 1.
    const int width = (min(L, S - g * L) + R - 1) / R * R + BW - 1;
    const int first = base - width + 1;
    const int jlo = first <= 0 ? 0 : (first + BW - 1) / BW;
    const int jhi = min(nbj - 1, base / BW);
    for (int jb = jlo; jb <= jhi; ++jb) {
      const size_t at = ((size_t)g * nbj + jb) * (L + BW - 1) + (base - jb * BW);
      take_better(v, idx, part_cv[at], part_ci[at]);
    }
  }
}

// A batch's reduce and merge.  The batch's global row aggregates [row_lo,
// row_lo + 32 row_tiles) and column aggregates [col_lo, col_lo + 32
// col_tiles) are cut into tiles of RED_OUT consecutive outputs, and block x
// takes tiles x, x + gridDim.x, ...  For each job of the batch in order
// whose rows [r0, r0 + S) or columns [c0, c0 + S + W) reach a tile, the
// block reduces that job's partials there (its RED_SLICES warps splitting
// them) and keeps a job's (value, index) only if its value beats the
// earlier jobs' strictly; then the result replaces the global entry only if
// it beats it strictly.  So the incumbent, then the earlier job, wins a
// tie: the global aggregates end as a max-merge of the jobs' BandOuts job
// after job would leave them.  Each warp finds the jobs that reach a tile
// with one ballot over 32 jobs, the same in every warp, so a tile that no
// job reaches (between the jobs of a batch far apart) costs a few
// instructions.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
k3_merge(const T* __restrict__ part_rv, const int* __restrict__ part_ri,
         const T* __restrict__ part_cv, const int* __restrict__ part_ci, Jobs jobs, int B,
         int S, int W, int L, int nbj, int G, int row_lo, int row_tiles, int col_lo,
         int col_tiles, T* __restrict__ row_v, int* __restrict__ row_i,
         T* __restrict__ col_v, int* __restrict__ col_i) {
  __shared__ T red_v[RED_SLICES][RED_OUT];
  __shared__ int red_i[RED_SLICES][RED_OUT];
  const T init = aggregate_init<T>();
  const int lane = threadIdx.x % RED_OUT, q = threadIdx.x / RED_OUT;
  const size_t row_part = (size_t)nbj * S, col_part = (size_t)G * nbj * (L + BW - 1);
  for (int tile = blockIdx.x; tile < row_tiles + col_tiles; tile += gridDim.x) {
    const bool rows = tile < row_tiles;
    const int first = rows ? row_lo + tile * RED_OUT : col_lo + (tile - row_tiles) * RED_OUT;
    const int len = rows ? S : S + W;
    T best = init;
    int best_i = -1;
    for (int b0 = 0; b0 < B; b0 += LANES) {
      // Job b0 + lane's offset, and whether it reaches the tile.
      int off = 0;
      bool reach = false;
      if (b0 + lane < B) {
        const int2 job = job_at(jobs, b0 + lane);
        off = rows ? job.x : job.x + job.y;
        reach = off < first + RED_OUT && off + len > first;
      }
      for (unsigned todo = __ballot_sync(FULL, reach); todo; todo &= todo - 1) {
        const int k = __ffs(todo) - 1;  // the jobs in batch order
        const int b = b0 + k;
        const int t = first + lane - __shfl_sync(FULL, off, k);
        const bool live = t >= 0 && t < len;
        T v = init;
        int idx = -1;
        if (live)
          reduce_partials(part_rv + b * row_part, part_ri + b * row_part,
                          part_cv + b * col_part, part_ci + b * col_part, rows, t, q, S, L,
                          nbj, G, v, idx);
        red_v[q][lane] = v;
        red_i[q][lane] = idx;
        __syncthreads();
        if (q == 0 && live) {
#pragma unroll
          for (int p = 1; p < RED_SLICES; ++p) take_better(v, idx, red_v[p][lane], red_i[p][lane]);
          if (v > best) { best = v; best_i = idx; }
        }
        __syncthreads();              // the slices are read: the next job may write them
      }
    }
    if (q == 0 && best > init) {
      T* gv = (rows ? row_v : col_v) + first + lane;
      int* gi = (rows ? row_i : col_i) + first + lane;
      if (best > *gv) { *gv = best; *gi = best_i; }
    }
  }
}

// The sum of v over the block, the same in every thread (a fixed order).
__device__ __forceinline__ Acc block_sum(Acc v, Acc* red) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();                    // red is free: an earlier sum is read
  if (threadIdx.x % LANES == 0) red[threadIdx.x / LANES] = v;
  __syncthreads();
  Acc s = Acc(0);
#pragma unroll
  for (int k = 0; k < SEED_THREADS / LANES; ++k) s += red[k];
  return s;
}

// The seeds of a batch, in float64: block (x, z) computes job z's
//   QT(r0, c) = sum_t qc[t] (T[c + t] - g) - (mu[c] - g) sum_t qc[t]
// for its SEED_THREADS columns c = c0 + j, with the centered query
// qc = T[r0 : r0 + m] - mu[r0] and g the mean of the block's own column
// segment T[c0 + j0 : c0 + j0 + SEED_THREADS + m - 1]: seed_qt's
// cancellation-resistant form (any g keeps the identity exact; one near
// the segment keeps every product O(local deviation)).  The query and
// the segment are staged SEED_M elements of m at a time.
template <typename T>
__global__ void __launch_bounds__(SEED_THREADS)
k3_seed(const T* __restrict__ ts, const T* __restrict__ mu, Jobs jobs, int m, int W,
        Acc* __restrict__ seed) {
  __shared__ Acc s_q[SEED_M], s_x[SEED_THREADS + SEED_M - 1];
  __shared__ Acc red[SEED_THREADS / LANES];
  const int tid = threadIdx.x;
  const int2 job = job_at(jobs, blockIdx.y);
  const int r0 = job.x, c0 = job.x + job.y;
  const int j0 = blockIdx.x * SEED_THREADS;
  const int nc = min(SEED_THREADS, W - j0);
  const int nx = nc + m - 1;
  const Acc mr = Acc(mu[r0]);
  Acc a = Acc(0), b = Acc(0);
  for (int t = tid; t < m; t += SEED_THREADS) a += Acc(ts[r0 + t]) - mr;
  for (int x = tid; x < nx; x += SEED_THREADS) b += Acc(ts[c0 + j0 + x]);
  const Acc sq = block_sum(a, red);
  const Acc g = block_sum(b, red) / nx;
  Acc acc = Acc(0);
  for (int t0 = 0; t0 < m; t0 += SEED_M) {
    const int mt = min(SEED_M, m - t0);
    __syncthreads();                  // the last chunk is read
    for (int t = tid; t < mt; t += SEED_THREADS) s_q[t] = Acc(ts[r0 + t0 + t]) - mr;
    for (int x = tid; x < nc + mt - 1; x += SEED_THREADS)
      s_x[x] = Acc(ts[c0 + j0 + t0 + x]) - g;
    __syncthreads();
    if (tid < nc)
      for (int t = 0; t < mt; ++t) acc = fma(s_q[t], s_x[tid + t], acc);
  }
  if (tid < nc)
    seed[(size_t)blockIdx.y * W + j0 + tid] = acc - (Acc(mu[c0 + j0 + tid]) - g) * sq;
}

// Once per device: ask for the largest shared-memory carveout for k3_tiles
// (the default one holds fewer of its blocks than its registers allow), and
// size k3_merge's grid, MERGE_WAVES waves of its blocks (a self-join
// launches K3 hundreds of times).  Sets *merge_blocks.
constexpr int MAX_DEVICES = 64;

template <typename T>
cudaError_t configure(int* merge_blocks) {
  static std::atomic<int> blocks[MAX_DEVICES];  // 0 until configured
  int dev = 0, n = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && (n = blocks[dev].load(std::memory_order_relaxed)) > 0) {
    *merge_blocks = n;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(k3_tiles<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k3_merge<T>, REDUCE_THREADS, 0);
  if (err != cudaSuccess) return err;
  n = MERGE_WAVES * sms * (n > 0 ? n : 1);
  if (dev < MAX_DEVICES) blocks[dev].store(n, std::memory_order_relaxed);
  *merge_blocks = n;
  return cudaSuccess;
}

// A batch: k3_seed, k3_segsum (when the band has more than one segment),
// k3_tiles, then k3_merge, for the B jobs of r0s / k0s (see the entry).
template <typename T>
int launch_batch(const void* ts, const void* mu, const void* df, const void* dg,
                 const void* inv, const void* r0s, const void* k0s, int B, int m, int S,
                 int W, int L, int w, int excl, int row_lo, int row_hi, int col_lo,
                 int col_hi, void* seed, void* seg, void* part_rv, void* part_ri,
                 void* part_cv, void* part_ci, void* row_v, void* row_i, void* col_v,
                 void* col_i, void* stream) {
  if (L <= 0 || L % R != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbj = (W + BW - 1) / BW;
  const int G = (S + L - 1) / L;
  const Jobs jobs{static_cast<const int*>(r0s), static_cast<const int*>(k0s)};
  const T *tdf = static_cast<const T*>(df), *tdg = static_cast<const T*>(dg);
  T *prv = static_cast<T*>(part_rv), *pcv = static_cast<T*>(part_cv);
  int *pri = static_cast<int*>(part_ri), *pci = static_cast<int*>(part_ci);
  int merge_blocks = 0;
  cudaError_t err = configure<T>(&merge_blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  k3_seed<T><<<dim3((W + SEED_THREADS - 1) / SEED_THREADS, B), SEED_THREADS, 0, st>>>(
      static_cast<const T*>(ts), static_cast<const T*>(mu), jobs, m, W,
      static_cast<Acc*>(seed));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (G > 1) {
    k3_segsum<T><<<dim3(nbj, G - 1, B), LANES, 0, st>>>(tdf, tdg, jobs, S, W, L,
                                                        static_cast<Acc*>(seg));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  k3_tiles<T><<<dim3(nbj, G, B), LANES, 0, st>>>(
      tdf, tdg, static_cast<const T*>(inv), jobs, static_cast<const Acc*>(seed),
      static_cast<const Acc*>(seg), S, W, L, w, excl, prv, pri, pcv, pci);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int row_tiles = (row_hi - row_lo + RED_OUT - 1) / RED_OUT;
  const int col_tiles = (col_hi - col_lo + RED_OUT - 1) / RED_OUT;
  k3_merge<T><<<min(row_tiles + col_tiles, merge_blocks), REDUCE_THREADS, 0, st>>>(
      prv, pri, pcv, pci, jobs, B, S, W, L, nbj, G, row_lo, row_tiles, col_lo, col_tiles,
      static_cast<T*>(row_v), static_cast<int*>(row_i), static_cast<T*>(col_v),
      static_cast<int*>(col_i));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int resident_blocks(int which) {
  int n = 0;
  cudaError_t err = configure<T>(&n);
  if (err != cudaSuccess) return -static_cast<int>(err);
  err =
      which == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k3_segsum<T>, LANES, 0)
      : which == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k3_tiles<T>, LANES, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k3_merge<T>, REDUCE_THREADS, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

extern "C" {

int mpx_k3_block_w() { return BW; }
int mpx_k3_segment_rows() { return R; }

// Resident blocks per SM of k3_segsum (which = 0), k3_tiles (1) or
// k3_merge (2) in f64 (f64 != 0) or f32; a negative cudaError_t on failure.
int mpx_k3_resident_blocks(int f64, int which) {
  return f64 ? resident_blocks<double>(which) : resident_blocks<float>(which);
}

// A batch of B jobs, all on `stream`: the seeds, the segment sums, the
// sweep, then the partials reduced and max-merged, in the jobs' order, into
// the global aggregates (k3_merge).  Returns a cudaError_t (0 on success).
// Device pointers: the series ts and the statistics mu, df, dg, inv, whole;
// int32 r0s and k0s (B,); the global aggregates row_v/row_i and
// col_v/col_i, which every job's rows [r0, r0 + S) and columns
// [c0, c0 + S + W) must lie in.  [row_lo, row_hi) and [col_lo, col_hi)
// hold the batch's rows and columns.  L, the rows of a segment, is a
// positive multiple of mpx_k3_segment_rows(); a job has G = ceil(S / L)
// segments.  Scratch, each job's after the one before: float64 seeds
// (B, W), float64 segment sums (B, G - 1, W), partials rows (B, ceil(W/BW),
// S), columns (B, G * ceil(W/BW), L + BW - 1).
int mpx_k3_sweep_batch_f32(const void* ts, const void* mu, const void* df, const void* dg,
                           const void* inv, const void* r0s, const void* k0s, int B, int m,
                           int S, int W, int L, int w, int excl, int row_lo, int row_hi,
                           int col_lo, int col_hi, void* seed, void* seg, void* part_rv,
                           void* part_ri, void* part_cv, void* part_ci, void* row_v,
                           void* row_i, void* col_v, void* col_i, void* stream) {
  return launch_batch<float>(ts, mu, df, dg, inv, r0s, k0s, B, m, S, W, L, w, excl, row_lo,
                             row_hi, col_lo, col_hi, seed, seg, part_rv, part_ri, part_cv,
                             part_ci, row_v, row_i, col_v, col_i, stream);
}

int mpx_k3_sweep_batch_f64(const void* ts, const void* mu, const void* df, const void* dg,
                           const void* inv, const void* r0s, const void* k0s, int B, int m,
                           int S, int W, int L, int w, int excl, int row_lo, int row_hi,
                           int col_lo, int col_hi, void* seed, void* seg, void* part_rv,
                           void* part_ri, void* part_cv, void* part_ci, void* row_v,
                           void* row_i, void* col_v, void* col_i, void* stream) {
  return launch_batch<double>(ts, mu, df, dg, inv, r0s, k0s, B, m, S, W, L, w, excl, row_lo,
                              row_hi, col_lo, col_hi, seed, seg, part_rv, part_ri, part_cv,
                              part_ci, row_v, row_i, col_v, col_i, stream);
}

}  // extern "C"
