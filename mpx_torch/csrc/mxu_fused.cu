// K1: fused tile sweep of one job, for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel mpx/kernels/mxu_fused.py:_kernel (wrapper
// sweep_band_mxu_fused).  For the job rows [r0, r0+S) x columns [c0, c0+W)
// it computes the correlation tile P = U_r . U_c^T of unit-normalized
// windows, masks it (exclusion zone c - r >= excl, bounds r <= w-1 and
// c <= wc-1, finite inverse norms; a masked pair is -1e12, never 0) and
// reduces it to the row max with the smallest column and the column max
// with the smallest row.  P never reaches device memory.  Rows come from
// (U, inv), columns from (Uc, inv_c): a self-join passes the same matrix
// twice, an AB-join the two series' (no exclusion zone: the wrapper passes
// an excl that no pair of the job can fail).
//
// Bound: the tensor-core rate, 2m FLOPs per pair.  f64 runs on the FP64
// tensor cores (DMMA, mma.sync m16n8k8 .f64; 67 TFLOP/s on an H100 SXM,
// where wgmma has no f64 form).  f32 runs as split TF32 on mma.sync
// m16n8k8 .tf32, which keeps f32 accuracy where plain TF32 (a 10-bit
// mantissa) would not: each operand is split into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi), and every k8 step adds lo.hi + hi.lo, then hi.hi,
// to an f32 accumulator (the lo.lo term, ~2^-22 relative, is dropped):
// three TF32 products, so 495 / 3 TFLOP/s.  The tensor cores add into an
// f32 accumulator with truncation, not round-to-nearest, so one chain of
// 3m/8 MMAs along the whole m axis drifts toward zero by up to an ulp a
// step (a self-match reads d ~ 0.1 at m = 1024).  Each slab's products
// therefore go into a zeroed register tile, which is folded into the
// master accumulator with one round-to-nearest FADD per element: the
// truncated chain is 12 MMAs long at any m.  Device-memory traffic is only
// the (S + W) * m operand elements (panels are re-read out of L2) plus the
// per-tile partials.
//
// Design.  On the TPU the grid runs in order, so the kernel carries the
// column aggregates in a (1, W) scratch from one grid step to the next.
// Blocks here run in parallel and in no order, so each BM x BN block
// writes per-tile partials (rows: (W/BN, S), columns: (S/BM, W)) and a
// second small kernel reduces them.  Every reduction orders by value
// descending, then index ascending (take_better at every step: in-thread,
// across shuffles and across warps), which is the reference's tie rule
// and makes the result independent of the block schedule.
//
// Staging.  The m axis goes through shared memory in slabs of 128 bytes a
// row (16 doubles or 32 floats), in a ring of STAGES slabs that cp.async
// fills STAGES - 1 slabs ahead of the MMAs, one barrier per slab.  A row of
// U starts on a 16-byte boundary only when m is a multiple of
// 16 / sizeof(T): then the copies are 16 bytes, else one element each (m is
// any value >= 4).  The tail past m and rows outside the job are
// zero-filled by the copy itself, so they add nothing to a product.
//
// Fragments.  ldmatrix has no 64-bit form, so fragments are read from
// shared memory by hand.  The order of the k terms inside one MMA does not
// change the sum, so each lane takes adjacent k values (2 doubles or
// 4 floats: one 16-byte load per fragment row) where the PTX layout has
// k = t and t + 4.  A row's 16-byte chunk c is stored at c ^ ((row & 1) << 2),
// which keeps the fragment loads free of bank conflicts.  f32 operands are
// split as they come out of shared memory, each once per warp that reads
// it: a split copy in shared memory would double the fragment loads.
// A block is 128 x 64 pairs: four warps (2 x 2), each owning a 64 x 32
// sub-tile of m16n8 accumulators.  Two blocks share an SM, so one block's
// epilogue and first loads overlap the other's products.
//
// Epilogue.  An accumulator fragment holds rows g and g + 8 and columns
// 2t, 2t + 1 of each m16n8 tile (g = lane / 4, t = lane % 4): a row's
// columns lie on the 4 lanes of a group, a column's rows on 8 lanes and the
// two warp rows.  Rows reduce in-thread, over lanes xor 1, 2, then over the
// two warp columns in shared memory; columns in-thread, over lanes
// xor 4, 8, 16, then over the two warp rows.
//
// Left for later: TMA with an mbarrier ring, wgmma for the f32 product,
// and one persistent launch over many jobs.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int BM = 128;                       // tile rows per block
constexpr int BN = 64;                        // tile columns per block
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;  // 128
constexpr int WM = BM / WARPS_M;              // 64 rows per warp
constexpr int WN = BN / WARPS_N;              // 32 columns per warp
constexpr int MI = WM / 16;                   // m16 tiles per warp
constexpr int NI = WN / 8;                    // n8 tiles per warp
constexpr int ROW_BYTES = 128;                // one row of a slab
constexpr int CHUNKS = ROW_BYTES / 16;        // its 16-byte chunks
constexpr int GROUPS = ROW_BYTES / 64;        // its k-groups: 4 lanes x 16 bytes
constexpr int STAGES = 3;                     // slabs in the cp.async ring
constexpr int STAGE_BYTES = (BM + BN) * ROW_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;  // 72 KB
constexpr int REDUCE_THREADS = 256;
constexpr int RED_ROWS = 32;                          // rows per reduce block
constexpr int RED_SLICES = REDUCE_THREADS / RED_ROWS;  // warps over a row's partials

template <typename T>
__device__ __forceinline__ T aggregate_init() { return T(-1e12); }

// (v, i) <- the better of (v, i) and (v2, i2): larger value, then smaller index.
template <typename T>
__device__ __forceinline__ void take_better(T& v, int& i, T v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

// Byte offset of 16-byte chunk c of slab row r (rows 0..BM-1 hold the row
// panel, BM..BM+BN-1 the column panel).
__device__ __forceinline__ int chunk_offset(int r, int c) {
  return r * ROW_BYTES + ((c ^ ((r & 1) << 2)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

template <int N>
__device__ __forceinline__ void cp_async_elem(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(dst), "l"(src), "n"(N), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy k-slab [k0, k0 + ROW_BYTES / sizeof(T)) of the block's BM rows
// (rows of U from a_row0, a_rows of them in the job) and BN columns (rows
// of Uc from b_row0) into the slab at shared address `slab`, zero-filling
// what lies outside.
template <typename T>
__device__ __forceinline__ void load_slab(uint32_t slab, const T* __restrict__ U,
                                          const T* __restrict__ Uc, int m, int k0,
                                          int a_row0, int a_rows, int b_row0, int b_rows,
                                          bool vec, int tid) {
  constexpr int E = 16 / sizeof(T);           // elements per chunk
  constexpr int BK = ROW_BYTES / sizeof(T);   // elements per slab row
  if (vec) {
    // Chunk tid % CHUNKS of rows tid / CHUNKS + PASS * i of each panel.
    constexpr int PASS = THREADS / CHUNKS;
    const int lr0 = tid / CHUNKS, c = tid % CHUNKS;
    const int k = k0 + c * E;
    const T* a_src = U + (size_t)(a_row0 + lr0) * m + k;
    const T* b_src = Uc + (size_t)(b_row0 + lr0) * m + k;
#pragma unroll
    for (int i = 0; i < BM / PASS; ++i) {
      const bool ok = lr0 + PASS * i < a_rows && k < m;
      cp_async16(slab + chunk_offset(lr0 + PASS * i, c),
                 ok ? a_src + (size_t)PASS * i * m : U, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < BN / PASS; ++i) {
      const bool ok = lr0 + PASS * i < b_rows && k < m;
      cp_async16(slab + chunk_offset(BM + lr0 + PASS * i, c),
                 ok ? b_src + (size_t)PASS * i * m : U, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < (BM + BN) * BK / THREADS; ++it) {
      const int id = tid + it * THREADS;
      const int r = id / BK, kk = id % BK;
      const bool a = r < BM;
      const int lr = a ? r : r - BM;
      const int k = k0 + kk;
      const bool ok = lr < (a ? a_rows : b_rows) && k < m;
      const T* base = a ? U : Uc;
      const T* src = ok ? base + (size_t)((a ? a_row0 : b_row0) + lr) * m + k : U;
      cp_async_elem<(int)sizeof(T)>(slab + chunk_offset(r, kk / E) + (kk % E) * sizeof(T), src,
                               ok ? (int)sizeof(T) : 0);
    }
  }
}

// D += A . B on the FP64 tensor cores: A 16x8 (rows g, g+8; k slots t,
// t+4), B 8x8 (k slots t, t+4; column g), D 16x8 (rows g, g+8; columns
// 2t, 2t+1).
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// The same shape on the TF32 tensor cores, accumulating in f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo + O(2^-22 x), both TF32: the rounding of cvt.rna.tf32.f32
// (to nearest, ties away from zero; the 13 low bits cleared), in integer
// operations, which run faster than cvt.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// The products of one k-group (64 bytes of k) of a slab.  `arow` / `brow`
// are the slab rows of the lane's first A / B fragment row; `off` the byte
// offset within a row of the lane's 16-byte chunk of the group.
__device__ __forceinline__ void mma_group(double (&acc)[MI][NI][4], const unsigned char* slab,
                                          int arow, int brow, int off) {
  double a[MI][4], b[NI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const double2 x = *reinterpret_cast<const double2*>(slab + (arow + mi * 16) * ROW_BYTES + off);
    const double2 y = *reinterpret_cast<const double2*>(
        slab + (arow + mi * 16 + 8) * ROW_BYTES + off);
    a[mi][0] = x.x; a[mi][1] = y.x; a[mi][2] = x.y; a[mi][3] = y.y;
  }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const double2 z = *reinterpret_cast<const double2*>(slab + (brow + ni * 8) * ROW_BYTES + off);
    b[ni][0] = z.x; b[ni][1] = z.y;
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) mma_f64(acc[mi][ni], a[mi], b[ni]);
}

__device__ __forceinline__ void mma_group(float (&acc)[MI][NI][4], const unsigned char* slab,
                                          int arow, int brow, int off) {
  float4 xa[MI][2], xb[NI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    xa[mi][0] = *reinterpret_cast<const float4*>(
        slab + (arow + mi * 16) * ROW_BYTES + off);
    xa[mi][1] = *reinterpret_cast<const float4*>(
        slab + (arow + mi * 16 + 8) * ROW_BYTES + off);
  }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
    xb[ni] = *reinterpret_cast<const float4*>(slab + (brow + ni * 8) * ROW_BYTES + off);
  // Two k8 steps: the lane's k values 0, 1 of its chunk, then 2, 3.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t ahi[MI][4], alo[MI][4], bhi[NI][2], blo[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      split_tf32(h ? xa[mi][0].z : xa[mi][0].x, ahi[mi][0], alo[mi][0]);
      split_tf32(h ? xa[mi][1].z : xa[mi][1].x, ahi[mi][1], alo[mi][1]);
      split_tf32(h ? xa[mi][0].w : xa[mi][0].y, ahi[mi][2], alo[mi][2]);
      split_tf32(h ? xa[mi][1].w : xa[mi][1].y, ahi[mi][3], alo[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      split_tf32(h ? xb[ni].z : xb[ni].x, bhi[ni][0], blo[ni][0]);
      split_tf32(h ? xb[ni].w : xb[ni].y, bhi[ni][1], blo[ni][1]);
    }
    // Small terms first; each pass runs MI * NI independent products.
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], alo[mi], bhi[ni]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], ahi[mi], blo[ni]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], ahi[mi], bhi[ni]);
  }
}

// Resident blocks per SM: two.  f64's accumulators allow no more; f32's
// master and slab accumulators (128 floats a thread) spilled ~400 bytes a
// thread at three (168 registers), which ran 20 % slower on an H100 than
// two without spills.  AB = false is the self-join: the columns are read from
// (U, inv, w) and the column operand is ignored, so the compiler sees one
// matrix (with two, ptxas schedules the f64 body otherwise and it runs ~6 %
// slower on an H100).
template <typename T, bool AB>
__global__ void __launch_bounds__(THREADS, 2)
k1_tiles(const T* __restrict__ U, const T* __restrict__ inv, const T* __restrict__ Uc,
         const T* __restrict__ inv_c, int m, int r0, int c0, int S, int W, int w, int wc,
         int excl,
         T* __restrict__ part_rv, int* __restrict__ part_ri,
         T* __restrict__ part_cv, int* __restrict__ part_ci) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int BK = ROW_BYTES / sizeof(T);
  if (!AB) {
    Uc = U;
    inv_c = inv;
    wc = w;
  }

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  // Row blocks run fastest, so the blocks resident at one time share a few
  // column blocks and the whole row panel.
  const int nbm = (S + BM - 1) / BM;
  const int by = blockIdx.x % nbm, bx = blockIdx.x / nbm;
  const int rb = by * BM;    // block's first row, local to the band
  const int cb = bx * BN;    // block's first column, local to the chunk
  const bool vec = m % (16 / (int)sizeof(T)) == 0 &&
                   ((reinterpret_cast<uintptr_t>(U) | reinterpret_cast<uintptr_t>(Uc)) & 15) == 0;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int arow = wm * WM + g;
  const int brow = BM + wn * WN + g;
  // Every fragment row of the lane has the parity of g (see chunk_offset).
  int off[GROUPS];
#pragma unroll
  for (int q = 0; q < GROUPS; ++q) off[q] = ((4 * q + t) ^ ((g & 1) << 2)) << 4;

  T acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = T(0);

  const int nk = (m + BK - 1) / BK;
  const int a_rows = S - rb, b_rows = W - cb;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_slab<T>(sbase + s * STAGE_BYTES, U, Uc, m, s * BK, r0 + rb, a_rows, c0 + cb,
                   b_rows, vec, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab kt has landed; slab kt - 1 is free
    const int next = kt + STAGES - 1;
    const unsigned char* slab = smem + (kt % STAGES) * STAGE_BYTES;
    if (next < nk)
      load_slab<T>(sbase + (next % STAGES) * STAGE_BYTES, U, Uc, m, next * BK, r0 + rb,
                   a_rows, c0 + cb, b_rows, vec, tid);
    cp_async_commit();
    if constexpr (sizeof(T) == 8) {
#pragma unroll
      for (int q = 0; q < GROUPS; ++q) mma_group(acc, slab, arow, brow, off[q]);
    } else {
      // The slab's 12 truncating MMAs into a zeroed tile, then one
      // round-to-nearest add into the master accumulator.
      T slab_acc[MI][NI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) slab_acc[mi][ni][e] = T(0);
#pragma unroll
      for (int q = 0; q < GROUPS; ++q) mma_group(slab_acc, slab, arow, brow, off[q]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], slab_acc[mi][ni][e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the epilogue reuses it

  // Mask from the global rows and columns of the lane's fragments.
  const T init = aggregate_init<T>();
  int grow[MI][2], gcol[NI][2];
  bool rok[MI][2], cok[NI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = rb + arow + mi * 16 + 8 * h;
      grow[mi][h] = r0 + lr;
      rok[mi][h] = lr < S && grow[mi][h] <= w - 1 && isfinite(inv[grow[mi][h]]);
    }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int lc = cb + wn * WN + ni * 8 + 2 * t + j;
      gcol[ni][j] = c0 + lc;
      cok[ni][j] = lc < W && gcol[ni][j] <= wc - 1 && isfinite(inv_c[gcol[ni][j]]);
    }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, j = e % 2;
        if (!(rok[mi][h] && cok[ni][j] && gcol[ni][j] - grow[mi][h] >= excl))
          acc[mi][ni][e] = init;
      }

  T* red_rv = reinterpret_cast<T*>(smem);               // [WARPS_N][BM]
  int* red_ri = reinterpret_cast<int*>(red_rv + WARPS_N * BM);
  T* red_cv = reinterpret_cast<T*>(red_ri + WARPS_N * BM);  // [WARPS_M][BN]
  int* red_ci = reinterpret_cast<int*>(red_cv + WARPS_M * BN);

  // Row max / smallest column: in-thread, over the 4 lanes of the group,
  // then (below) over the warp columns.
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      T v = acc[mi][0][2 * h];
      int idx = gcol[0][0];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (ni + j > 0) take_better(v, idx, acc[mi][ni][2 * h + j], gcol[ni][j]);
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        const T v2 = __shfl_xor_sync(0xffffffffu, v, x);
        const int i2 = __shfl_xor_sync(0xffffffffu, idx, x);
        take_better(v, idx, v2, i2);
      }
      if (t == 0) {
        const int r = arow + mi * 16 + 8 * h;
        red_rv[wn * BM + r] = v;
        red_ri[wn * BM + r] = idx;
      }
    }

  // Column max / smallest row: in-thread, over the 8 groups of the warp,
  // then (below) over the warp rows.
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      T v = acc[0][ni][j];
      int idx = grow[0][0];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (mi + h > 0) take_better(v, idx, acc[mi][ni][2 * h + j], grow[mi][h]);
#pragma unroll
      for (int x = 4; x <= 16; x <<= 1) {
        const T v2 = __shfl_xor_sync(0xffffffffu, v, x);
        const int i2 = __shfl_xor_sync(0xffffffffu, idx, x);
        take_better(v, idx, v2, i2);
      }
      if (g == 0) {
        const int c = wn * WN + ni * 8 + 2 * t + j;
        red_cv[wm * BN + c] = v;
        red_ci[wm * BN + c] = idx;
      }
    }
  __syncthreads();

  for (int u = tid; u < BM + BN; u += THREADS) {
    if (u < BM) {
      T v = red_rv[u];
      int idx = red_ri[u];
#pragma unroll
      for (int p = 1; p < WARPS_N; ++p) take_better(v, idx, red_rv[p * BM + u], red_ri[p * BM + u]);
      const int lr = rb + u;
      if (lr < S) {
        part_rv[(size_t)bx * S + lr] = v;
        part_ri[(size_t)bx * S + lr] = idx;
      }
    } else {
      const int c = u - BM;
      T v = red_cv[c];
      int idx = red_ci[c];
#pragma unroll
      for (int p = 1; p < WARPS_M; ++p) take_better(v, idx, red_cv[p * BN + c], red_ci[p * BN + c]);
      const int lc = cb + c;
      if (lc < W) {
        part_cv[(size_t)by * W + lc] = v;
        part_ci[(size_t)by * W + lc] = idx;
      }
    }
  }
}

// Reduce the per-tile partials.  The first ceil(S / RED_ROWS) blocks take
// rows: warp q reads partials q, q + RED_SLICES, ... of RED_ROWS
// consecutive rows (one coalesced load each) and the warps' bests meet in
// shared memory.  The other blocks take columns, one thread each over its
// nbm partials.  An index stays -1 when the value is still the aggregate
// init.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
k1_reduce(const T* __restrict__ part_rv, const int* __restrict__ part_ri,
          const T* __restrict__ part_cv, const int* __restrict__ part_ci,
          int S, int W, int nbn, int nbm,
          T* __restrict__ row_v, int* __restrict__ row_i,
          T* __restrict__ col_v, int* __restrict__ col_i) {
  __shared__ T red_v[RED_SLICES][RED_ROWS];
  __shared__ int red_i[RED_SLICES][RED_ROWS];
  const T init = aggregate_init<T>();
  const int row_blocks = (S + RED_ROWS - 1) / RED_ROWS;
  if ((int)blockIdx.x < row_blocks) {
    const int lane = threadIdx.x % RED_ROWS, q = threadIdx.x / RED_ROWS;
    const int t = blockIdx.x * RED_ROWS + lane;
    T v = init;
    int idx = INT_MAX;
    if (t < S) {
#pragma unroll 4
      for (int b = q; b < nbn; b += RED_SLICES)
        take_better(v, idx, part_rv[(size_t)b * S + t], part_ri[(size_t)b * S + t]);
    }
    red_v[q][lane] = v;
    red_i[q][lane] = idx;
    __syncthreads();
    if (q == 0 && t < S) {
#pragma unroll
      for (int p = 1; p < RED_SLICES; ++p) take_better(v, idx, red_v[p][lane], red_i[p][lane]);
      row_v[t] = v;
      row_i[t] = v > init ? idx : -1;
    }
  } else {
    const int c = (blockIdx.x - row_blocks) * REDUCE_THREADS + threadIdx.x;
    if (c < W) {
      T v = part_cv[c];
      int idx = part_ci[c];
#pragma unroll 8
      for (int b = 1; b < nbm; ++b)
        take_better(v, idx, part_cv[(size_t)b * W + c], part_ci[(size_t)b * W + c]);
      col_v[c] = v;
      col_i[c] = v > init ? idx : -1;
    }
  }
}

template <typename T>
int launch(const void* U, const void* inv, const void* Uc, const void* inv_c, int m,
           int r0, int c0, int S, int W, int w, int wc, int excl, void* part_rv,
           void* part_ri, void* part_cv,
           void* part_ci, void* row_v, void* row_i, void* col_v, void* col_i,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbn = (W + BN - 1) / BN;
  const int nbm = (S + BM - 1) / BM;
  const bool ab = U != Uc || inv != inv_c || w != wc;
  auto tiles = ab ? k1_tiles<T, true> : k1_tiles<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  tiles<<<nbn * nbm, THREADS, SMEM_BYTES, st>>>(
      static_cast<const T*>(U), static_cast<const T*>(inv), static_cast<const T*>(Uc),
      static_cast<const T*>(inv_c), m, r0, c0, S, W, w, wc, excl, static_cast<T*>(part_rv),
      static_cast<int*>(part_ri), static_cast<T*>(part_cv), static_cast<int*>(part_ci));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (S + RED_ROWS - 1) / RED_ROWS + (W + REDUCE_THREADS - 1) / REDUCE_THREADS;
  k1_reduce<T><<<blocks, REDUCE_THREADS, 0, st>>>(
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
// (pw, m) row-major unit-window matrix of the rows, inv its (pw,) inverse
// norms, Uc / inv_c the same of the columns (pw_c rows; U / inv again for
// a self-join).
int mpx_k1_sweep_f32(const void* U, const void* inv, const void* Uc, const void* inv_c,
                     int m, int r0, int c0, int S, int W, int w, int wc, int excl,
                     void* part_rv, void* part_ri, void* part_cv, void* part_ci,
                     void* row_v, void* row_i, void* col_v, void* col_i, void* stream) {
  return launch<float>(U, inv, Uc, inv_c, m, r0, c0, S, W, w, wc, excl, part_rv, part_ri,
                       part_cv, part_ci, row_v, row_i, col_v, col_i, stream);
}

int mpx_k1_sweep_f64(const void* U, const void* inv, const void* Uc, const void* inv_c,
                     int m, int r0, int c0, int S, int W, int w, int wc, int excl,
                     void* part_rv, void* part_ri, void* part_cv, void* part_ci,
                     void* row_v, void* row_i, void* col_v, void* col_i, void* stream) {
  return launch<double>(U, inv, Uc, inv_c, m, r0, c0, S, W, w, wc, excl, part_rv, part_ri,
                        part_cv, part_ci, row_v, row_i, col_v, col_i, stream);
}

}  // extern "C"
