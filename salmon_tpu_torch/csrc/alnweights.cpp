// Copied from native/alnweights.cpp of the JAX package (salmon_tpu), unchanged
// below this comment: the port builds it into its own host library
// (salmon_tpu_torch/_native.py) and loads nothing under native/.

// Native alignment-mode per-batch grouping/weighting.
//
// Role: the per-fragment weight normalization + equivalence-class
// emission of the reference's alignment-mode minibatch worker
// (src/alignment/SalmonQuantifyAlignments.cpp:940-1213, processMiniBatch).
// The Python/numpy formulation (alignment/quant.py r4) spent the
// alignment-mode budget in ~15 O(n) array passes plus (F, T2)
// take_along_axis dedup sorts; this is the same computation as ONE
// OpenMP pass over fragments (records arrive grouped by fragment:
// frag ids are a cumsum over the BAM walk, so runs are contiguous).
//
// Semantics (bit-parity targets, see test_alignment_mode.py):
//   w        = exp(logw - max(logw in fragment))
//   valid    = w > min_aln_prob
//   eq row   = ascending unique txps of valid records, weights SUMMED
//              over duplicates, INVALID_TXP (0x7FFFFFFF) padding
//   wn       = valid ? w / sum(valid w) : 0        (posterior)
//   best     = first index reaching max(valid w), -1 if none
//   fld_hist = sum of wn over valid paired records with obs >= 0,
//              flen in (0, max_flen], bucketed by flen

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_thread_num() { return 0; }
static int omp_get_max_threads() { return 1; }
#endif

extern "C" {

static const int32_t INVALID_TXP = 0x7FFFFFFF;

// Pass 1: fragment run starts (fid nondecreasing). Fills starts
// (caller-allocated, n+1 capacity); returns F. starts[F] = n.
int64_t aln_frag_starts(const int64_t* fid, int64_t n,
                        int64_t* starts) {
  int64_t f = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (i == 0 || fid[i] != fid[i - 1]) starts[f++] = i;
  }
  starts[f] = n;
  return f;
}

// Pass 2: per-fragment weights + eq rows. All outputs caller-allocated:
//   eq_txp (F*T2) i32, eq_w (F*T2) f32, wn (n) f64, best (F) i64,
//   fld_hist (max_flen+1) f64 (zeroed by caller or here — zeroed here).
// Returns num_mapped (fragments with >= 1 valid record).
int64_t aln_group_eq(const int64_t* starts, int64_t F, int64_t n,
                     const int32_t* txp, const int64_t* flen,
                     const int64_t* obs, const double* logw,
                     double min_aln_prob, int64_t T2,
                     int paired, int64_t max_flen,
                     int32_t* eq_txp, float* eq_w, double* wn,
                     int64_t* best, double* fld_hist) {
  const int nt = omp_get_max_threads();
  std::vector<double> hists((size_t)nt * (max_flen + 1), 0.0);
  int64_t n_mapped = 0;

#pragma omp parallel num_threads(nt) reduction(+ : n_mapped)
  {
    const int tid = omp_get_thread_num();
    double* hist = &hists[(size_t)tid * (max_flen + 1)];
    std::vector<std::pair<int32_t, double>> buf;

#pragma omp for schedule(static)
    for (int64_t f = 0; f < F; ++f) {
      const int64_t s = starts[f], e = starts[f + 1];
      double mx = -1e300;
      for (int64_t i = s; i < e; ++i) mx = std::max(mx, logw[i]);
      double wsum = 0.0;
      buf.clear();
      int64_t bi = -1;
      double bw = 0.0;
      for (int64_t i = s; i < e; ++i) {
        const double w = std::exp(logw[i] - mx);
        const bool valid = w > min_aln_prob;
        if (valid) {
          wsum += w;
          buf.emplace_back(txp[i], w);
          if (w > bw) { bw = w; bi = i; }
        }
        wn[i] = valid ? w : 0.0;  // normalized below
      }
      // "first index reaching the max": ties keep the earliest
      if (bi >= 0) {
        for (int64_t i = s; i < e; ++i) {
          if (wn[i] == bw) { bi = i; break; }
        }
      }
      best[f] = bi;
      const double inv = wsum > 0 ? 1.0 / wsum : 0.0;
      for (int64_t i = s; i < e; ++i) wn[i] *= inv;
      if (paired) {
        for (int64_t i = s; i < e; ++i) {
          if (wn[i] > 0.0 && obs[i] >= 0 && flen[i] > 0) {
            const int64_t b = flen[i] <= max_flen ? flen[i] : max_flen;
            hist[b] += wn[i];
          }
        }
      }
      // dedup + ascending labels
      std::sort(buf.begin(), buf.end());
      int32_t* row_t = eq_txp + f * T2;
      float* row_w = eq_w + f * T2;
      int64_t w_out = 0;
      for (size_t j = 0; j < buf.size() && w_out < T2; ) {
        const int32_t t = buf[j].first;
        double acc = 0.0;
        while (j < buf.size() && buf[j].first == t) acc += buf[j++].second;
        row_t[w_out] = t;
        row_w[w_out] = (float)acc;
        ++w_out;
      }
      if (w_out > 0) ++n_mapped;
      for (; w_out < T2; ++w_out) {
        row_t[w_out] = INVALID_TXP;
        row_w[w_out] = 0.0f;
      }
    }
  }
  std::memset(fld_hist, 0, (size_t)(max_flen + 1) * sizeof(double));
  for (int t = 0; t < nt; ++t)
    for (int64_t b = 0; b <= max_flen; ++b)
      fld_hist[b] += hists[(size_t)t * (max_flen + 1) + b];
  return n_mapped;
}

}  // extern "C"
