// Native host-side library.
//
// The TPU framework's counterpart to the reference's host-side C++
// (include/host/HostSideComputation.hpp, test/include/MatrixProfileReference.hpp):
//  * mpx_precompute      — exact float64 statistics in one pass (the
//    PreComputeStatistics analog, vectorizable O(n*m));
//  * mpx_golden_scamp    — the O(n^2) golden SCAMP oracle, OpenMP-parallel
//    over diagonal chunks with private aggregates + max-merge, fast enough
//    to validate n ~ 10^5..10^6 runs where the Python oracle cannot;
//  * mpx_merge_aggregates — UpdateAggregates analog for host-side merging.
//
// Exposed with plain C linkage for ctypes (no pybind11 in this image).
// Semantics mirror the reference exactly: aggregate init -1e12 / -1,
// exclusion zone column - row < m/4, strict-greater updates (NaN never
// wins), dist = sqrt(2m(1-P)).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {
constexpr double kAggregateInit = -1e12;
constexpr int32_t kIndexInit = -1;

// Centered dot product sum_j (x[j]-mux)(y[j]-muy) with 8 independent
// accumulators: the explicit reassociation lets the compiler emit one
// AVX-512 FMA per 8 doubles (a single accumulator chain cannot be
// vectorized without -ffast-math).  Error is <= the sequential sum's
// (~sqrt(m) ulps of the result), and deterministic for a given m.
inline double dot_centered(const double* x, const double* y, double mux,
                           double muy, int64_t m) {
  double acc[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  int64_t j = 0;
  for (; j + 8 <= m; j += 8) {
    for (int k = 0; k < 8; ++k) {
      acc[k] += (x[j + k] - mux) * (y[j + k] - muy);
    }
  }
  for (; j < m; ++j) {
    acc[j & 7] += (x[j] - mux) * (y[j] - muy);
  }
  return ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
         ((acc[4] + acc[5]) + (acc[6] + acc[7]));
}
}  // namespace

extern "C" {

// Statistics of the n-point series for subsequence length m.
// Outputs are length w = n - m + 1 (caller-allocated).
void mpx_precompute(const double* T, int64_t n, int64_t m, double* mu,
                    double* df, double* dg, double* inv, double* qt0) {
  const int64_t w = n - m + 1;
  // Rolling mean (reference recurrence, HostSideComputation.hpp:23-29).
  double mean = 0.0;
  for (int64_t k = 0; k < m; ++k) mean += T[k];
  mean /= static_cast<double>(m);
  mu[0] = mean;
  for (int64_t i = 1; i < w; ++i) {
    mean += (T[i + m - 1] - T[i - 1]) / static_cast<double>(m);
    mu[i] = mean;
  }
  df[0] = 0.0;
  dg[0] = 0.0;
  for (int64_t i = 1; i < w; ++i) {
    df[i] = (T[i + m - 1] - T[i - 1]) / 2.0;
    dg[i] = (T[i + m - 1] - mu[i]) + (T[i - 1] - mu[i - 1]);
  }
  // Numerically-zero variance (constant subsequence up to rounding) maps
  // to inv = inf so downstream finite-masks skip it deterministically.
  // The threshold is relative to the window's raw energy — variance
  // below 1e-10 of sum(T^2) cannot be resolved by the cumsum-based
  // backends and must be treated identically by every backend.
  constexpr double kZeroVarianceRel = 1e-10;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < w; ++i) {
    double ssq = 0.0, qt = 0.0, sumsq = 0.0;
    const double mui = mu[i];
    const double mu0 = mu[0];
    for (int64_t k = 0; k < m; ++k) {
      const double a = T[i + k] - mui;
      ssq += a * a;
      sumsq += T[i + k] * T[i + k];
      qt += a * (T[k] - mu0);
    }
    inv[i] = (ssq <= kZeroVarianceRel * sumsq) ? INFINITY
                                               : 1.0 / std::sqrt(ssq);
    qt0[i] = qt;
  }
}

// mu/inv only (no df/dg/qt0): the hybrid double tier's host statistics
// (mpx/hybrid.py) need just the exact rescoring operands — the
// recurrence seeds are a third of mpx_precompute's work for nothing.
// The ssq/sumsq reductions run on 8 independent accumulators each (same
// reassociation contract as dot_centered: deterministic for a given m,
// error <= the sequential chain's) so the compiler can vectorize what a
// single serial FMA chain cannot (measured 0.45s -> ~0.05s at n=2^20 on
// one core).  Zero-variance classification is identical to
// mpx_precompute: relative threshold on the window's raw energy.
namespace {
constexpr double kZeroVarianceRel = 1e-10;

// Scalar per-window ssq/sumsq -> inv, 4-way k-unrolled (deterministic).
inline void stats_window_scalar(const double* T, int64_t m, double mui,
                                double* inv_out) {
  double s0 = 0, s1 = 0, s2 = 0, s3 = 0, q0 = 0, q1 = 0, q2 = 0, q3 = 0;
  int64_t k = 0;
  for (; k + 4 <= m; k += 4) {
    const double a0 = T[k] - mui, a1 = T[k + 1] - mui;
    const double a2 = T[k + 2] - mui, a3 = T[k + 3] - mui;
    s0 += a0 * a0; s1 += a1 * a1; s2 += a2 * a2; s3 += a3 * a3;
    q0 += T[k] * T[k]; q1 += T[k + 1] * T[k + 1];
    q2 += T[k + 2] * T[k + 2]; q3 += T[k + 3] * T[k + 3];
  }
  for (; k < m; ++k) {
    const double a = T[k] - mui;
    s0 += a * a;
    q0 += T[k] * T[k];
  }
  const double ssq = (s0 + s1) + (s2 + s3);
  const double sumsq = (q0 + q1) + (q2 + q3);
  *inv_out = (ssq <= kZeroVarianceRel * sumsq) ? INFINITY
                                               : 1.0 / std::sqrt(ssq);
}
}  // namespace

void mpx_precompute_stats(const double* T, int64_t n, int64_t m, double* mu,
                          double* inv) {
  const int64_t w = n - m + 1;
  double mean = 0.0;
  for (int64_t k = 0; k < m; ++k) mean += T[k];
  mean /= static_cast<double>(m);
  mu[0] = mean;
  for (int64_t i = 1; i < w; ++i) {
    mean += (T[i + m - 1] - T[i - 1]) / static_cast<double>(m);
    mu[i] = mean;
  }
#if defined(__AVX512F__)
  // Vectorize ACROSS 8 consecutive windows: for a fixed tap k the loads
  // T[i+k .. i+k+7] are contiguous, each lane keeps its own window's
  // accumulator, and the per-window summation order is the plain
  // sequential k order (2-way unrolled) — GCC refuses to auto-vectorize
  // the within-window reduction ("not profitable"), this shape is the
  // one the hardware actually likes.  ~0.03s at n=2^20 m=256 vs 0.45s
  // for the scalar chain.
  const int64_t w8 = w & ~int64_t(7);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < w8; i += 8) {
    const __m512d vmu = _mm512_loadu_pd(mu + i);
    __m512d s0 = _mm512_setzero_pd(), s1 = _mm512_setzero_pd();
    __m512d q0 = _mm512_setzero_pd(), q1 = _mm512_setzero_pd();
    int64_t k = 0;
    for (; k + 2 <= m; k += 2) {
      const __m512d t0 = _mm512_loadu_pd(T + i + k);
      const __m512d t1 = _mm512_loadu_pd(T + i + k + 1);
      const __m512d a0 = _mm512_sub_pd(t0, vmu);
      const __m512d a1 = _mm512_sub_pd(t1, vmu);
      s0 = _mm512_fmadd_pd(a0, a0, s0);
      s1 = _mm512_fmadd_pd(a1, a1, s1);
      q0 = _mm512_fmadd_pd(t0, t0, q0);
      q1 = _mm512_fmadd_pd(t1, t1, q1);
    }
    if (k < m) {
      const __m512d t0 = _mm512_loadu_pd(T + i + k);
      const __m512d a0 = _mm512_sub_pd(t0, vmu);
      s0 = _mm512_fmadd_pd(a0, a0, s0);
      q0 = _mm512_fmadd_pd(t0, t0, q0);
    }
    const __m512d ssq = _mm512_add_pd(s0, s1);
    const __m512d sumsq = _mm512_add_pd(q0, q1);
    const __m512d thr =
        _mm512_mul_pd(_mm512_set1_pd(kZeroVarianceRel), sumsq);
    const __mmask8 bad = _mm512_cmp_pd_mask(ssq, thr, _CMP_LE_OQ);
    const __m512d r = _mm512_div_pd(_mm512_set1_pd(1.0), _mm512_sqrt_pd(ssq));
    _mm512_storeu_pd(
        inv + i,
        _mm512_mask_blend_pd(bad, r, _mm512_set1_pd(INFINITY)));
  }
  for (int64_t i = w8; i < w; ++i) {
    stats_window_scalar(T + i, m, mu[i], inv + i);
  }
#else
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < w; ++i) {
    stats_window_scalar(T + i, m, mu[i], inv + i);
  }
#endif
}

// Strict-greater merge of (value, index) aggregates: b into a.
void mpx_merge_aggregates(double* a_val, int32_t* a_idx, const double* b_val,
                          const int32_t* b_idx, int64_t len) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < len; ++i) {
    if (b_val[i] > a_val[i]) {
      a_val[i] = b_val[i];
      a_idx[i] = b_idx[i];
    }
  }
}

// Exact float64 Pearson correlations for explicit candidate pairs —
// stage 2 of the hybrid double tier (f32 device sweep proposes
// candidates; this rescores them exactly).  Two-pass centered dot:
//   P = sum_j (T[a+j]-mu[a]) (T[b+j]-mu[b]) * inv[a] * inv[b].
// Degenerate windows (inv = inf) or negative indices yield the
// aggregate init so they never win a merge.
void mpx_rescore(const double* T, const double* mu, const double* inv,
                 int64_t m, const int32_t* rows, const int32_t* cols,
                 int64_t count, double* P) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < count; ++i) {
    const int64_t a = rows[i];
    const int64_t b = cols[i];
    if (a < 0 || b < 0 || !std::isfinite(inv[a]) || !std::isfinite(inv[b])) {
      P[i] = kAggregateInit;
      continue;
    }
    P[i] = dot_centered(T + a, T + b, mu[a], mu[b], m) * inv[a] * inv[b];
  }
}

// Self-join pair resolution: rescore each suspect pair ONCE and merge
// the exact value into BOTH endpoints' (bestP, bestI) under the
// strict-greater / smallest-index-tie rule.  Callers pass each
// unordered pair a single time (the capture stage records every pair
// on both sides; deduplicating halves the O(m) rescoring).  bestP /
// bestI must be pre-initialized to the aggregate inits.
void mpx_resolve_sym(const double* T, const double* mu, const double* inv,
                     int64_t m, const int32_t* rows, const int32_t* cols,
                     int64_t count, double* bestP, int32_t* bestI) {
  for (int64_t i = 0; i < count; ++i) {
    const int64_t a = rows[i];
    const int64_t b = cols[i];
    if (a < 0 || b < 0 || !std::isfinite(inv[a]) || !std::isfinite(inv[b])) {
      continue;
    }
    const double p = dot_centered(T + a, T + b, mu[a], mu[b], m) *
                     inv[a] * inv[b];
    if (p > bestP[a] || (p == bestP[a] && b < bestI[a])) {
      bestP[a] = p;
      bestI[a] = static_cast<int32_t>(b);
    }
    if (p > bestP[b] || (p == bestP[b] && a < bestI[b])) {
      bestP[b] = p;
      bestI[b] = static_cast<int32_t>(a);
    }
  }
}

// Self-join resolution straight from the raw capture-slot matrix
// (wq x nslots; sentinels are any value outside [0, wq)).  For each
// row i and candidate c: skip within-row duplicates; for c < i, skip
// when i also appears in c's slots (that copy is scored from c's
// side, where the partner i > c) — each unordered pair is scored once
// and merged into BOTH endpoints under strict-greater /
// smallest-index-tie.  Replaces the numpy membership-gather glue
// (O(wq*nslots) fancy indexing on the single host core).
void mpx_resolve_slots(const double* T, const double* mu, const double* inv,
                       int64_t m, const int32_t* cand, int64_t wq,
                       int64_t nslots, double* bestP, int32_t* bestI) {
  for (int64_t i = 0; i < wq; ++i) {
    if (!std::isfinite(inv[i])) continue;
    const int32_t* row = cand + i * nslots;
    for (int64_t j = 0; j < nslots; ++j) {
      const int64_t c = row[j];
      if (c < 0 || c >= wq) continue;
      bool skip = false;
      for (int64_t t = 0; t < j; ++t) {
        if (row[t] == static_cast<int32_t>(c)) {  // duplicate slot
          skip = true;
          break;
        }
      }
      if (!skip && c < i) {
        const int32_t* prow = cand + c * nslots;
        for (int64_t t = 0; t < nslots; ++t) {
          if (prow[t] == static_cast<int32_t>(i)) {  // captured on c's side
            skip = true;
            break;
          }
        }
      }
      if (skip || !std::isfinite(inv[c])) continue;
      const double p = dot_centered(T + i, T + c, mu[i], mu[c], m) *
                       inv[i] * inv[c];
      if (p > bestP[i] || (p == bestP[i] && c < bestI[i])) {
        bestP[i] = p;
        bestI[i] = static_cast<int32_t>(c);
      }
      if (p > bestP[c] || (p == bestP[c] && i < bestI[c])) {
        bestP[c] = p;
        bestI[c] = static_cast<int32_t>(i);
      }
    }
  }
}

// One-sided slot resolution (left/right profiles and AB-joins, where
// the two endpoints belong to different output arrays): score every
// valid slot of each query row against the target series and keep the
// per-row best under strict-greater / smallest-index-tie.  Slot
// sentinels are any value outside [0, wt); within-row duplicates are
// skipped inline.  Self-series callers pass the same pointers for q/t.
void mpx_resolve_slots_ab(const double* Tq, const double* muq,
                          const double* invq, const double* Tt,
                          const double* mut, const double* invt, int64_t m,
                          const int32_t* cand, int64_t wq, int64_t wt,
                          int64_t nslots, double* bestP, int32_t* bestI) {
  for (int64_t i = 0; i < wq; ++i) {
    if (!std::isfinite(invq[i])) continue;
    const int32_t* row = cand + i * nslots;
    for (int64_t j = 0; j < nslots; ++j) {
      const int64_t c = row[j];
      if (c < 0 || c >= wt) continue;
      bool dup = false;
      for (int64_t t = 0; t < j; ++t) {
        if (row[t] == static_cast<int32_t>(c)) {
          dup = true;
          break;
        }
      }
      if (dup || !std::isfinite(invt[c])) continue;
      const double p = dot_centered(Tq + i, Tt + c, muq[i], mut[c], m) *
                       invq[i] * invt[c];
      if (p > bestP[i] || (p == bestP[i] && c < bestI[i])) {
        bestP[i] = p;
        bestI[i] = static_cast<int32_t>(c);
      }
    }
  }
}

// Two-series variant (AB-joins): rows index into (Tq, muq, invq),
// cols into (Tt, mut, invt).
void mpx_rescore_ab(const double* Tq, const double* muq, const double* invq,
                    const double* Tt, const double* mut, const double* invt,
                    int64_t m, const int32_t* rows, const int32_t* cols,
                    int64_t count, double* P) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < count; ++i) {
    const int64_t a = rows[i];
    const int64_t b = cols[i];
    if (a < 0 || b < 0 || !std::isfinite(invq[a]) || !std::isfinite(invt[b])) {
      P[i] = kAggregateInit;
      continue;
    }
    P[i] = dot_centered(Tq + a, Tt + b, muq[a], mut[b], m) *
           invq[a] * invt[b];
  }
}

// Two-series full scan: best target neighbor of each query row.
// excl < 0 disables the trivial-match zone (AB-joins).
void mpx_row_scan_ab(const double* Tq, const double* muq, const double* invq,
                     const double* Tt, const double* mut, const double* invt,
                     int64_t m, int64_t wt, int64_t excl, const int32_t* rows,
                     int64_t count, double* bestP, int32_t* bestIdx) {
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t i = 0; i < count; ++i) {
    const int64_t r = rows[i];
    bestP[i] = kAggregateInit;
    bestIdx[i] = kIndexInit;
    if (r < 0 || !std::isfinite(invq[r])) continue;
    const double mur = muq[r];
    double bv = kAggregateInit;
    int32_t bi = kIndexInit;
    for (int64_t c = 0; c < wt; ++c) {
      if (excl >= 0) {
        const int64_t k = (c > r) ? (c - r) : (r - c);
        if (k < excl) continue;
      }
      if (!std::isfinite(invt[c])) continue;
      const double p =
          dot_centered(Tq + r, Tt + c, mur, mut[c], m) * invq[r] * invt[c];
      if (p > bv) {
        bv = p;
        bi = static_cast<int32_t>(c);
      }
    }
    bestP[i] = bv;
    bestIdx[i] = bi;
  }
}

// Exact float64 full scan for one subsequence against every valid
// neighbor (both sides of the join) — the escalation path for rows whose
// f32 suspect count overflows the captured candidate slots.  O(w*m) per
// row; callers invoke it for the (rare) flagged rows only.
void mpx_row_scan(const double* T, const double* mu, const double* inv,
                  int64_t m, int64_t w, int64_t excl, const int32_t* rows,
                  int64_t count, double* bestP, int32_t* bestIdx) {
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t i = 0; i < count; ++i) {
    const int64_t r = rows[i];
    bestP[i] = kAggregateInit;
    bestIdx[i] = kIndexInit;
    if (r < 0 || r >= w || !std::isfinite(inv[r])) continue;
    const double mur = mu[r];
    double bv = kAggregateInit;
    int32_t bi = kIndexInit;
    for (int64_t c = 0; c < w; ++c) {
      const int64_t k = (c > r) ? (c - r) : (r - c);
      if (k < excl || !std::isfinite(inv[c])) continue;
      const double p = dot_centered(T + r, T + c, mur, mu[c], m) *
                       inv[r] * inv[c];
      if (p > bv) {
        bv = p;
        bi = static_cast<int32_t>(c);
      }
    }
    bestP[i] = bv;
    bestIdx[i] = bi;
  }
}

// Golden O(n^2) SCAMP self-join.  Parallelized over diagonal chunks;
// each thread sweeps its diagonals with the O(1) QT update against
// private aggregates, merged under strict-greater at the end (ties keep
// the lower-diagonal owner, matching first-seen row-major order for row
// aggregates; index divergence on exact ties is accepted by the test
// contract).
void mpx_golden_scamp(const double* T, int64_t n, int64_t m, double* MP,
                      int32_t* MPI) {
  const int64_t w = n - m + 1;
  const int64_t excl = m / 4;

  std::vector<double> mu(w), df(w), dg(w), inv(w), qt0(w);
  mpx_precompute(T, n, m, mu.data(), df.data(), dg.data(), inv.data(),
                 qt0.data());

  int nthreads = 1;
#if defined(_OPENMP)
  nthreads = omp_get_max_threads();
#endif
  std::vector<std::vector<double>> vals(
      nthreads, std::vector<double>(w, kAggregateInit));
  std::vector<std::vector<int32_t>> idxs(
      nthreads, std::vector<int32_t>(w, kIndexInit));

#pragma omp parallel
  {
    int tid = 0;
#if defined(_OPENMP)
    tid = omp_get_thread_num();
#endif
    double* val = vals[tid].data();
    int32_t* idx = idxs[tid].data();
#pragma omp for schedule(dynamic, 64)
    for (int64_t k = excl; k < w; ++k) {
      // Sweep diagonal k: pairs (r, r + k) for r in [0, w - k).
      double qt = qt0[k];
      for (int64_t r = 0; r < w - k; ++r) {
        const int64_t c = r + k;
        if (r > 0) qt += df[r] * dg[c] + df[c] * dg[r];
        const double p = qt * inv[r] * inv[c];
        if (p > val[r]) {
          val[r] = p;
          idx[r] = static_cast<int32_t>(c);
        }
        if (p > val[c]) {
          val[c] = p;
          idx[c] = static_cast<int32_t>(r);
        }
      }
    }
  }

  for (int64_t i = 0; i < w; ++i) {
    MP[i] = kAggregateInit;
    MPI[i] = kIndexInit;
  }
  for (int t = 0; t < nthreads; ++t) {
    mpx_merge_aggregates(MP, MPI, vals[t].data(), idxs[t].data(), w);
  }
  for (int64_t i = 0; i < w; ++i) {
    MP[i] = std::sqrt(2.0 * static_cast<double>(m) * (1.0 - MP[i]));
  }
}

}  // extern "C"
