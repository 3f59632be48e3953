// Window statistics: the O(n·m) part of the SCAMP statistics, for Hopper (sm_90a).
//
// No Pallas kernel of mpx computes these.  The counterparts are mpx's host
// C++ (mpx/native/scamp_host.cpp: mpx_precompute, :61-100, and
// mpx_precompute_stats, :144-188) and the on-device backend of
// mpx/ops/precompute.py (backend='jax', _ssq_two_pass_jax_f64).  The O(n)
// running mean stays on the host, so every backend hands every tier the same
// window means.  From the float64 series T and those means mu, one thread a
// window i accumulates in float64
//   ssq   = sum_k (T[i+k] - mu[i])^2         (the two-pass centered estimator)
//   sumsq = sum_k T[i+k]^2                    (the zero-variance reference)
//   qt0   = sum_k (T[i+k] - mu[i]) (T[k] - mu[0])   (on request: the centered
//                                              first-row product, as mpx_precompute)
//   resid = sum_k (T[i+k] - mu[i])            (on request: the mean's correction)
// and writes inv = 1/sqrt(ssq), or +inf where ssq <= 1e-10 sumsq.
//
// Order of the sums: k ascending with fma, the even k in one accumulator and
// the odd k in another, added at the end; an odd m's last term joins the
// even one.  That is mpx_precompute_stats' AVX-512 lane order, so where the
// host's native build takes that path, inv may come out bit-equal to it.
//
// Bound: 3 FP64 instructions a window element (the subtraction and two fma;
// 4 with qt0, 5 with resid) against reading T and mu once and writing inv
// (and qt0, resid) once: at n = 2^20, m = 256 that is ~8e8 instructions
// against ~24 MB, so the kernel is bound by operations.  Adjacent threads
// read adjacent T[i+k], so every load is coalesced and the overlapping
// windows of a block come from L1; T[k] - mu[0] is staged in shared memory
// a tile at a time.  The (w, m) window block is never materialized, which a
// plain PyTorch version must do (blocked) and pass over three times.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
// Elements of T[k] - mu[0] staged in shared memory at once (16 KB); even,
// so the even/odd split of k is the same in every tile.
constexpr int kTile = 2048;
constexpr double kZeroVarianceRel = 1e-10;

template <bool kQt0, bool kResid>
__global__ void __launch_bounds__(kThreads)
window_stats(const double* __restrict__ T, const double* __restrict__ mu, int w, int m,
             double* __restrict__ inv, double* __restrict__ qt0,
             double* __restrict__ resid) {
  __shared__ double c0[kQt0 ? kTile : 1];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < w;
  const double* Ti = T + (live ? i : 0);
  const double mui = live ? mu[i] : 0.0;
  double s0 = 0.0, s1 = 0.0, q0 = 0.0, q1 = 0.0;
  double p0 = 0.0, p1 = 0.0, r0 = 0.0, r1 = 0.0;
  for (int base = 0; base < m; base += kTile) {
    const int len = min(kTile, m - base);
    if (kQt0) {
      const double mu0 = mu[0];
      __syncthreads();
      for (int k = threadIdx.x; k < len; k += kThreads) c0[k] = T[base + k] - mu0;
      __syncthreads();
    }
    if (!live) continue;
    const double* t = Ti + base;
    int k = 0;
#pragma unroll 4
    for (; k + 2 <= len; k += 2) {
      const double t0 = t[k], t1 = t[k + 1];
      const double a0 = t0 - mui, a1 = t1 - mui;
      s0 = fma(a0, a0, s0);
      s1 = fma(a1, a1, s1);
      q0 = fma(t0, t0, q0);
      q1 = fma(t1, t1, q1);
      if (kQt0) {
        p0 = fma(a0, c0[k], p0);
        p1 = fma(a1, c0[k + 1], p1);
      }
      if (kResid) {
        r0 += a0;
        r1 += a1;
      }
    }
    if (k < len) {
      const double t0 = t[k];
      const double a0 = t0 - mui;
      s0 = fma(a0, a0, s0);
      q0 = fma(t0, t0, q0);
      if (kQt0) p0 = fma(a0, c0[k], p0);
      if (kResid) r0 += a0;
    }
  }
  if (!live) return;
  const double ssq = s0 + s1, sumsq = q0 + q1;
  inv[i] = ssq <= kZeroVarianceRel * sumsq ? CUDART_INF : 1.0 / sqrt(ssq);
  if (kQt0) qt0[i] = p0 + p1;
  if (kResid) resid[i] = r0 + r1;
}

template <bool kQt0, bool kResid>
int launch(const double* T, const double* mu, int w, int m, double* inv, double* qt0,
           double* resid, cudaStream_t stream) {
  const int blocks = (w + kThreads - 1) / kThreads;
  window_stats<kQt0, kResid><<<blocks, kThreads, 0, stream>>>(T, mu, w, m, inv, qt0, resid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The statistics of the w = n - m + 1 windows of the float64 series T (n,)
// with window means mu (w,), all device pointers, on `stream`: inv (w,)
// always, qt0 (w,) and resid (w,) where not null.  Returns a cudaError_t
// (0 on success).
int mpx_window_stats(const void* T, const void* mu, int w, int m, void* inv, void* qt0,
                     void* resid, void* stream) {
  const auto* t = static_cast<const double*>(T);
  const auto* u = static_cast<const double*>(mu);
  auto* iv = static_cast<double*>(inv);
  auto* q = static_cast<double*>(qt0);
  auto* r = static_cast<double*>(resid);
  auto s = static_cast<cudaStream_t>(stream);
  if (q && r) return launch<true, true>(t, u, w, m, iv, q, r, s);
  if (q) return launch<true, false>(t, u, w, m, iv, q, r, s);
  if (r) return launch<false, true>(t, u, w, m, iv, q, r, s);
  return launch<false, false>(t, u, w, m, iv, q, r, s);
}

}  // extern "C"
