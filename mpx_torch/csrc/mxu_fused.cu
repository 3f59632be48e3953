// K1: fused tile sweep of one self-join job, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mpx/kernels/mxu_fused.py:_kernel (wrapper
// sweep_band_mxu_fused).  For the job rows [r0, r0+S) x columns [c0, c0+W)
// it computes the correlation tile P = U_r . U_c^T of unit-normalized
// windows, masks it (exclusion zone c - r >= excl, bounds r <= w-1 and
// c <= w-1, finite inverse norms; a masked pair is -1e12, never 0) and
// reduces it to the row max with the smallest column and the column max
// with the smallest row.  P never reaches device memory.
//
// Bound: FP32 / FP64 FMA throughput (no TF32, no tensor cores), 2m FLOPs
// per pair.  Device-memory traffic is only the (S + W) * m operand elements
// per S * W pairs (panels are re-read by many blocks out of L2) plus the
// per-tile partials: 2 * (S * W/BN + W * S/BM) (value, index) pairs.
//
// Design.  On the TPU the grid runs in order, so the kernel carries the
// column aggregates in a (1, W) scratch from one grid step to the next.
// Blocks here run in parallel and in no order, so each BM x BN block
// writes per-tile partials (rows: (W/BN, S), columns: (S/BM, W)) and a
// second small kernel reduces them.  Every reduction orders by value
// descending, then index ascending, which is the reference's tie rule
// (smallest index within a tile, strict > across tiles and jobs) and
// makes the result independent of the block schedule.
//
// Each block stages the m axis through shared memory in BK-deep slabs
// (the next slab is prefetched into registers while the current one is
// consumed) and each thread keeps a TM x TN register tile of accumulators,
// split in two halves of 4 rows / columns so shared-memory reads are
// conflict-free 16-byte loads.  Left for later: wgmma / DMMA tensor-core
// products (split-TF32 for f32), TMA with an mbarrier ring instead of the
// register prefetch, and one persistent launch over many jobs.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;              // tile rows per block
constexpr int BN = 128;              // tile columns per block
constexpr int BK = 8;                // m-slab depth staged in shared memory
constexpr int TM = 8;                // register tile rows per thread
constexpr int TN = 8;                // register tile columns per thread
constexpr int TXS = BN / TN;         // 16 threads across the columns
constexpr int THREADS = (BM / TM) * TXS;  // 256
constexpr int WARPS = THREADS / 32;
constexpr int REDUCE_THREADS = 256;

template <typename T>
__device__ __forceinline__ T aggregate_init() { return T(-1e12); }

__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }

// Four contiguous shared-memory values as 16-byte loads.
__device__ __forceinline__ void lds4(const float* p, float* o) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
__device__ __forceinline__ void lds4(const double* p, double* o) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// (v, i) <- the better of (v, i) and (v2, i2): larger value, then smaller index.
template <typename T>
__device__ __forceinline__ void take_better(T& v, int& i, T v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
k1_tiles(const T* __restrict__ U, const T* __restrict__ inv, int m,
         int r0, int c0, int S, int W, int w, int excl,
         T* __restrict__ part_rv, int* __restrict__ part_ri,
         T* __restrict__ part_cv, int* __restrict__ part_ci) {
  __shared__ __align__(16) T As[BK][BM];
  __shared__ __align__(16) T Bs[BK][BN];
  __shared__ T red_v[WARPS][BN];
  __shared__ int red_i[WARPS][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TXS;          // lane bits 0..3
  const int ty = tid / TXS;
  const int rb = blockIdx.y * BM;    // block's first row, local to the band
  const int cb = blockIdx.x * BN;    // block's first column, local to the chunk

  // Global -> shared: each thread loads 4 consecutive k of one row of the
  // row panel and one row of the column panel (BM * BK / THREADS = 4).
  const int ld_row = tid / 2;
  const int ld_k = (tid % 2) * 4;
  const bool a_ok = rb + ld_row < S;
  const bool b_ok = cb + ld_row < W;
  const T* a_ptr = U + (size_t)(r0 + rb + ld_row) * m;
  const T* b_ptr = U + (size_t)(c0 + cb + ld_row) * m;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  T a_reg[4], b_reg[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = ld_k + e;
    a_reg[e] = (a_ok && k < m) ? a_ptr[k] : T(0);
    b_reg[e] = (b_ok && k < m) ? b_ptr[k] : T(0);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    As[ld_k + e][ld_row] = a_reg[e];
    Bs[ld_k + e][ld_row] = b_reg[e];
  }
  __syncthreads();

  for (int k0 = 0; k0 < m; k0 += BK) {
    const bool more = k0 + BK < m;
    if (more) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + BK + ld_k + e;
        a_reg[e] = (a_ok && k < m) ? a_ptr[k] : T(0);
        b_reg[e] = (b_ok && k < m) ? b_ptr[k] : T(0);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM], b[TN];
      lds4(&As[kk][ty * 4], a);
      lds4(&As[kk][BM / 2 + ty * 4], a + 4);
      lds4(&Bs[kk][tx * 4], b);
      lds4(&Bs[kk][BN / 2 + tx * 4], b + 4);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmadd(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        As[ld_k + e][ld_row] = a_reg[e];
        Bs[ld_k + e][ld_row] = b_reg[e];
      }
      __syncthreads();
    }
  }

  // Epilogue: the thread's rows and columns, ascending in i and j.
  const T init = aggregate_init<T>();
  int lrow[TM], grow[TM], lcol[TN], gcol[TN];
  bool rok[TM], cok[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    lrow[i] = (i < 4 ? 0 : BM / 2) + ty * 4 + (i & 3);
    const int lr = rb + lrow[i];
    grow[i] = r0 + lr;
    rok[i] = lr < S && grow[i] <= w - 1 && isfinite(inv[grow[i]]);
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    lcol[j] = (j < 4 ? 0 : BN / 2) + tx * 4 + (j & 3);
    const int lc = cb + lcol[j];
    gcol[j] = c0 + lc;
    cok[j] = lc < W && gcol[j] <= w - 1 && isfinite(inv[gcol[j]]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (!(rok[i] && cok[j] && gcol[j] - grow[i] >= excl)) acc[i][j] = init;

  // Row max / smallest column: in-thread, then over the 16 lanes that
  // share the row (they differ in lane bits 0..3).
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    T v = acc[i][0];
    int idx = gcol[0];
#pragma unroll
    for (int j = 1; j < TN; ++j)
      if (acc[i][j] > v) { v = acc[i][j]; idx = gcol[j]; }
#pragma unroll
    for (int off = TXS / 2; off > 0; off >>= 1) {
      const T v2 = __shfl_xor_sync(0xffffffffu, v, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, idx, off);
      take_better(v, idx, v2, i2);
    }
    const int lr = rb + lrow[i];
    if (tx == 0 && lr < S) {
      part_rv[(size_t)blockIdx.x * S + lr] = v;
      part_ri[(size_t)blockIdx.x * S + lr] = idx;
    }
  }

  // Column max / smallest row: in-thread, then with the lane 16 apart
  // (ty and ty + 1 of one warp), then over the warps through shared memory.
  const int warp = tid / 32;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    T v = acc[0][j];
    int idx = grow[0];
#pragma unroll
    for (int i = 1; i < TM; ++i)
      if (acc[i][j] > v) { v = acc[i][j]; idx = grow[i]; }
    const T v2 = __shfl_xor_sync(0xffffffffu, v, 16);
    const int i2 = __shfl_xor_sync(0xffffffffu, idx, 16);
    take_better(v, idx, v2, i2);
    if ((tid & 16) == 0) {
      red_v[warp][lcol[j]] = v;
      red_i[warp][lcol[j]] = idx;
    }
  }
  __syncthreads();
  if (tid < BN) {
    T v = red_v[0][tid];
    int idx = red_i[0][tid];
#pragma unroll
    for (int p = 1; p < WARPS; ++p) take_better(v, idx, red_v[p][tid], red_i[p][tid]);
    const int lc = cb + tid;
    if (lc < W) {
      part_cv[(size_t)blockIdx.y * W + lc] = v;
      part_ci[(size_t)blockIdx.y * W + lc] = idx;
    }
  }
}

// Reduce the per-tile partials: thread t < S owns row t (nbn partials),
// thread S + c owns column c (nbm partials).  An index stays -1 when the
// value is still the aggregate init.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
k1_reduce(const T* __restrict__ part_rv, const int* __restrict__ part_ri,
          const T* __restrict__ part_cv, const int* __restrict__ part_ci,
          int S, int W, int nbn, int nbm,
          T* __restrict__ row_v, int* __restrict__ row_i,
          T* __restrict__ col_v, int* __restrict__ col_i) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const T init = aggregate_init<T>();
  if (t < S) {
    T v = part_rv[t];
    int idx = part_ri[t];
    for (int b = 1; b < nbn; ++b)
      take_better(v, idx, part_rv[(size_t)b * S + t], part_ri[(size_t)b * S + t]);
    row_v[t] = v;
    row_i[t] = v > init ? idx : -1;
  } else if (t < S + W) {
    const int c = t - S;
    T v = part_cv[c];
    int idx = part_ci[c];
    for (int b = 1; b < nbm; ++b)
      take_better(v, idx, part_cv[(size_t)b * W + c], part_ci[(size_t)b * W + c]);
    col_v[c] = v;
    col_i[c] = v > init ? idx : -1;
  }
}

template <typename T>
int launch(const void* U, const void* inv, int m, int r0, int c0, int S, int W,
           int w, int excl, void* part_rv, void* part_ri, void* part_cv,
           void* part_ci, void* row_v, void* row_i, void* col_v, void* col_i,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbn = (W + BN - 1) / BN;
  const int nbm = (S + BM - 1) / BM;
  k1_tiles<T><<<dim3(nbn, nbm), THREADS, 0, st>>>(
      static_cast<const T*>(U), static_cast<const T*>(inv), m, r0, c0, S, W, w,
      excl, static_cast<T*>(part_rv), static_cast<int*>(part_ri),
      static_cast<T*>(part_cv), static_cast<int*>(part_ci));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = S + W;
  k1_reduce<T><<<(n + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, st>>>(
      static_cast<const T*>(part_rv), static_cast<const int*>(part_ri),
      static_cast<const T*>(part_cv), static_cast<const int*>(part_ci), S, W,
      nbn, nbm, static_cast<T*>(row_v), static_cast<int*>(row_i),
      static_cast<T*>(col_v), static_cast<int*>(col_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mpx_k1_block_m() { return BM; }
int mpx_k1_block_n() { return BN; }

// One job: tile kernel then partial reduce, both on `stream`.  Returns a
// cudaError_t (0 on success).  Pointers are device pointers; U is the
// (pw, m) row-major unit-window matrix, inv its (pw,) inverse norms.
int mpx_k1_sweep_f32(const void* U, const void* inv, int m, int r0, int c0,
                     int S, int W, int w, int excl, void* part_rv, void* part_ri,
                     void* part_cv, void* part_ci, void* row_v, void* row_i,
                     void* col_v, void* col_i, void* stream) {
  return launch<float>(U, inv, m, r0, c0, S, W, w, excl, part_rv, part_ri,
                       part_cv, part_ci, row_v, row_i, col_v, col_i, stream);
}

int mpx_k1_sweep_f64(const void* U, const void* inv, int m, int r0, int c0,
                     int S, int W, int w, int excl, void* part_rv, void* part_ri,
                     void* part_cv, void* part_ci, void* row_v, void* row_i,
                     void* col_v, void* col_i, void* stream) {
  return launch<double>(U, inv, m, r0, c0, S, W, w, excl, part_rv, part_ri,
                        part_cv, part_ci, row_v, row_i, col_v, col_i, stream);
}

}  // extern "C"
