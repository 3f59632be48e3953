// K3: SCAMP diagonal-recurrence sweep of one self-join job, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mpx/kernels/pallas_tpu.py:_band_kernel
// (wrapper sweep_band_pallas).  For the rhombus rows [r0, r0+S) x diagonals
// [k0, k0+W) it carries QT along each diagonal with the O(1) update
//   QT(i, j) = QT(i-1, j) + df_r[i] * dg_c[i+j] + df_c[i+j] * dg_r[i],
// seeded exactly at band row 0 (seed_qt, computed by the wrapper), forms
// P = QT * inv_r * inv_c, masks it (exclusion zone k0 + j >= excl, bounds
// r <= w-1 and c <= w-1, finite inverse norms, NaN; a masked pair is -1e12,
// never 0) and reduces it to the row max with the smallest column and the
// (S + W,) column max with the smallest row.
// P never reaches device memory.
//
// Bound: about ten floating-point operations and a few shared-memory
// accesses per pair, against K1's 2m FMAs; device-memory traffic is O(S + W)
// statistics plus the per-block partials.  One seed per band (the TPU
// kernel's and the plain version's numerics) leaves the card only W threads,
// one per diagonal (16,384 at the default chunk: ~4 warps per SM), so the
// sweep is latency-bound.  Splitting the band into exactly reseeded row
// segments would multiply the threads, but its results then differ from the
// single-seed recurrence by that recurrence's own rounding drift.
//
// Design.  On the TPU the grid runs in order and the kernel carries QT and
// the column aggregates in VMEM scratch from one grid step to the next,
// with a lane roll per row and a Hillis-Steele prefix sum over 8-row
// sub-blocks.  Here one thread owns one diagonal and walks the band's rows,
// so the QT carry is a register.  Blocks of BW diagonals stage TR rows at a
// time: the statistics of the sub-tile go to shared memory, each thread
// writes its TR masked correlations into a TR x BW tile, and the block
// reduces the tile twice: along rows (RQ threads per row, then shuffles)
// and along the anti-diagonals, which are the columns.  Column maxima
// accumulate in a shared ring; a column is complete once the sub-tile rows
// have moved past it and is written out then.  Blocks run in parallel and in
// no order, so they write per-block partials (rows: (W/BW, S); columns:
// (W/BW, S' + BW - 1), S' = S rounded up to TR rows) and a second kernel
// reduces them.  Every reduction orders by value descending, then index
// ascending: the reference's tie rule, independent of the block schedule.
// Left for later: more threads per job, a persistent launch over many jobs,
// and prefetching the next sub-tile's statistics.

#include <cuda_runtime.h>

namespace {

constexpr int BW = 128;          // diagonals per block, one thread each
constexpr int TR = 16;           // rows per sub-tile staged in shared memory
constexpr int RQ = BW / TR;      // threads per row in the row reduction
constexpr int CW = TR + BW - 1;  // columns one sub-tile touches
constexpr int RING = 256;        // column-accumulator ring, >= CW + TR, a power of 2
constexpr int PAD = 8;           // tile row padding: conflict-free row reduction
constexpr int REDUCE_THREADS = 256;

static_assert(BW % TR == 0 && 32 % RQ == 0, "a row's reducers share a warp");
static_assert(RING >= CW + TR && (RING & (RING - 1)) == 0, "ring size");

template <typename T>
__device__ __forceinline__ T aggregate_init() { return T(-1e12); }

// Columns of one block's partial: the band's sub-tiles, then the tail the
// last sub-tile reaches.
__host__ __device__ __forceinline__ int block_columns(int S) {
  return (S + TR - 1) / TR * TR + BW - 1;
}

// (v, i) <- the better of (v, i) and (v2, i2): larger value, then smaller index.
template <typename T>
__device__ __forceinline__ void take_better(T& v, int& i, T v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

template <typename T>
__global__ void __launch_bounds__(BW)
k3_tiles(const T* __restrict__ df_r, const T* __restrict__ dg_r,
         const T* __restrict__ inv_r, const T* __restrict__ df_c,
         const T* __restrict__ dg_c, const T* __restrict__ inv_c,
         const T* __restrict__ seed, int r0, int k0, int S, int W, int w,
         int excl, T* __restrict__ part_rv, int* __restrict__ part_ri,
         T* __restrict__ part_cv, int* __restrict__ part_ci) {
  __shared__ T tile[TR][BW + PAD];
  __shared__ T s_dfc[CW], s_dgc[CW], s_invc[CW];
  __shared__ bool s_cok[CW];
  __shared__ T s_dfr[TR], s_dgr[TR], s_invr[TR];
  __shared__ bool s_rok[TR];
  __shared__ T ring_v[RING];
  __shared__ int ring_i[RING];

  const T init = aggregate_init<T>();
  const int tid = threadIdx.x;
  const int jb = blockIdx.x;
  const int j0 = jb * BW;            // block's first diagonal lane
  const int j = j0 + tid;            // this thread's diagonal lane
  const int c0 = r0 + k0;
  const int ncol = block_columns(S);
  const int nsub = (S + TR - 1) / TR;
  const bool lane_ok = j < W && k0 + j >= excl;
  T qt = j < W ? seed[j] : T(0);
  T* out_cv = part_cv + (size_t)jb * ncol;
  int* out_ci = part_ci + (size_t)jb * ncol;
  for (int u = tid; u < RING; u += BW) { ring_v[u] = init; ring_i[u] = -1; }

  for (int k = 0; k < nsub; ++k) {
    const int i0 = k * TR;           // first band row of the sub-tile
    const int t0 = i0 + j0;          // its first column, relative to c0
    __syncthreads();                 // the last sub-tile's readers are done
    for (int x = tid; x < CW; x += BW) {
      const int t = t0 + x;
      const bool in = t < S + W;
      const T iv = in ? inv_c[t] : T(0);
      s_dfc[x] = in ? df_c[t] : T(0);
      s_dgc[x] = in ? dg_c[t] : T(0);
      s_invc[x] = iv;
      s_cok[x] = in && c0 + t <= w - 1 && isfinite(iv);
    }
    if (tid < TR) {
      const int i = i0 + tid;
      const bool in = i < S;
      const T iv = in ? inv_r[i] : T(0);
      s_dfr[tid] = in ? df_r[i] : T(0);
      s_dgr[tid] = in ? dg_r[i] : T(0);
      s_invr[tid] = iv;
      s_rok[tid] = in && r0 + i <= w - 1 && isfinite(iv);
    }
    __syncthreads();

    // The recurrence: row i0 + ii touches column t0 + ii + tid.
#pragma unroll
    for (int ii = 0; ii < TR; ++ii) {
      const int x = ii + tid;
      if (i0 + ii > 0) qt += s_dfr[ii] * s_dgc[x] + s_dfc[x] * s_dgr[ii];
      const T p = qt * s_invr[ii] * s_invc[x];
      tile[ii][tid] = (lane_ok && s_rok[ii] && s_cok[x] && p == p) ? p : init;
    }
    __syncthreads();

    // Row max / smallest column: RQ neighbouring lanes per row, each over
    // an interleaved eighth of the diagonals, then shuffles.
    {
      const int ii = tid / RQ;
      const int q = tid % RQ;
      T v = tile[ii][q];
      int idx = q;
#pragma unroll
      for (int y = 1; y < BW / RQ; ++y) {
        const T v2 = tile[ii][q + RQ * y];
        if (v2 > v) { v = v2; idx = q + RQ * y; }
      }
#pragma unroll
      for (int off = RQ / 2; off > 0; off >>= 1) {
        const T v2 = __shfl_xor_sync(0xffffffffu, v, off);
        const int i2 = __shfl_xor_sync(0xffffffffu, idx, off);
        take_better(v, idx, v2, i2);
      }
      const int i = i0 + ii;
      if (q == 0 && i < S) {
        part_rv[(size_t)jb * S + i] = v;
        part_ri[(size_t)jb * S + i] = c0 + i + j0 + idx;
      }
    }

    // Column max / smallest row along the tile's anti-diagonals, merged
    // into the ring (strict >: earlier sub-tiles hold earlier rows).
    for (int x = tid; x < CW; x += BW) {
      T v = init;
      int row = -1;
      const int lo = max(0, x - BW + 1);
      const int hi = min(TR - 1, x);
      for (int ii = lo; ii <= hi; ++ii) {
        const T v2 = tile[ii][x - ii];
        if (v2 > v) { v = v2; row = ii; }
      }
      const int slot = (k * TR + x) & (RING - 1);
      if (v > ring_v[slot]) { ring_v[slot] = v; ring_i[slot] = r0 + i0 + row; }
    }
    __syncthreads();

    // Columns k*TR .. k*TR + TR - 1 (relative to c0 + j0) are complete.
    if (tid < TR) {
      const int u = k * TR + tid;
      const int slot = u & (RING - 1);
      out_cv[u] = ring_v[slot];
      out_ci[u] = ring_i[slot];
      ring_v[slot] = init;
      ring_i[slot] = -1;
    }
  }
  __syncthreads();

  // The rest of the block's columns, which the last sub-tile reached.
  for (int u = nsub * TR + tid; u < ncol; u += BW) {
    const int slot = u & (RING - 1);
    out_cv[u] = ring_v[slot];
    out_ci[u] = ring_i[slot];
  }
}

// Reduce the per-block partials: thread t < S owns row t (one partial per
// diagonal block), thread S + c owns column c0 + c (the blocks whose
// columns reach it).  An index stays -1 when the value is
// still the aggregate init.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
k3_reduce(const T* __restrict__ part_rv, const int* __restrict__ part_ri,
          const T* __restrict__ part_cv, const int* __restrict__ part_ci,
          int S, int W, int nbj,
          T* __restrict__ row_v, int* __restrict__ row_i,
          T* __restrict__ col_v, int* __restrict__ col_i) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const T init = aggregate_init<T>();
  if (t < S) {
    T v = part_rv[t];
    int idx = part_ri[t];
    for (int b = 1; b < nbj; ++b)
      take_better(v, idx, part_rv[(size_t)b * S + t], part_ri[(size_t)b * S + t]);
    row_v[t] = v;
    row_i[t] = v > init ? idx : -1;
  } else if (t < 2 * S + W) {
    const int c = t - S;
    const int ncol = block_columns(S);
    // Blocks jb with 0 <= c - jb * BW < ncol.
    const int first = c - ncol + 1;
    const int jlo = first <= 0 ? 0 : (first + BW - 1) / BW;
    const int jhi = min(nbj - 1, c / BW);
    T v = init;
    int idx = -1;
    for (int jb = jlo; jb <= jhi; ++jb) {
      const size_t at = (size_t)jb * ncol + (c - jb * BW);
      take_better(v, idx, part_cv[at], part_ci[at]);
    }
    col_v[c] = v;
    col_i[c] = v > init ? idx : -1;
  }
}

template <typename T>
int launch(const void* df_r, const void* dg_r, const void* inv_r,
           const void* df_c, const void* dg_c, const void* inv_c,
           const void* seed, int r0, int k0, int S, int W, int w, int excl,
           void* part_rv, void* part_ri, void* part_cv, void* part_ci,
           void* row_v, void* row_i, void* col_v, void* col_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbj = (W + BW - 1) / BW;
  k3_tiles<T><<<nbj, BW, 0, st>>>(
      static_cast<const T*>(df_r), static_cast<const T*>(dg_r),
      static_cast<const T*>(inv_r), static_cast<const T*>(df_c),
      static_cast<const T*>(dg_c), static_cast<const T*>(inv_c),
      static_cast<const T*>(seed), r0, k0, S, W, w, excl,
      static_cast<T*>(part_rv), static_cast<int*>(part_ri),
      static_cast<T*>(part_cv), static_cast<int*>(part_ci));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = 2 * S + W;
  k3_reduce<T><<<(n + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, st>>>(
      static_cast<const T*>(part_rv), static_cast<const int*>(part_ri),
      static_cast<const T*>(part_cv), static_cast<const int*>(part_ci), S, W,
      nbj, static_cast<T*>(row_v), static_cast<int*>(row_i),
      static_cast<T*>(col_v), static_cast<int*>(col_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mpx_k3_block_w() { return BW; }
int mpx_k3_block_columns(int S) { return block_columns(S); }

// One job: sweep kernel then partial reduce, both on `stream`.  Returns a
// cudaError_t (0 on success).  Pointers are device pointers: the row
// statistics (S,) from r0, the column statistics (S + W,) from c0 = r0 + k0,
// the (W,) seed QT(r0, c0 + j).  Partials: rows (ceil(W/BW), S), columns
// (ceil(W/BW), mpx_k3_block_columns(S)); outputs rows (S,), columns (S + W,).
int mpx_k3_sweep_f32(const void* df_r, const void* dg_r, const void* inv_r,
                     const void* df_c, const void* dg_c, const void* inv_c,
                     const void* seed, int r0, int k0, int S, int W, int w,
                     int excl, void* part_rv, void* part_ri,
                     void* part_cv, void* part_ci, void* row_v, void* row_i,
                     void* col_v, void* col_i, void* stream) {
  return launch<float>(df_r, dg_r, inv_r, df_c, dg_c, inv_c, seed, r0, k0, S,
                       W, w, excl, part_rv, part_ri, part_cv, part_ci,
                       row_v, row_i, col_v, col_i, stream);
}

int mpx_k3_sweep_f64(const void* df_r, const void* dg_r, const void* inv_r,
                     const void* df_c, const void* dg_c, const void* inv_c,
                     const void* seed, int r0, int k0, int S, int W, int w,
                     int excl, void* part_rv, void* part_ri,
                     void* part_cv, void* part_ci, void* row_v, void* row_i,
                     void* col_v, void* col_i, void* stream) {
  return launch<double>(df_r, dg_r, inv_r, df_c, dg_c, inv_c, seed, r0, k0, S,
                        W, w, excl, part_rv, part_ri, part_cv, part_ci,
                        row_v, row_i, col_v, col_i, stream);
}

}  // extern "C"
