// Copied from native/kmersort.cpp of the JAX package (salmon_tpu), unchanged
// below this comment: the port builds it into its own host library
// (salmon_tpu_torch/_native.py) and loads nothing under native/.

// Native index-build hot path: canonical k-mer enumeration + parallel
// LSD radix sort.
//
// Role: the reference's index construction parallelism (pufferfish /
// TwoPaCo multi-threaded CDBG build, driven from
// src/index/BuildSalmonIndex.cpp) — here the index is a sorted
// (canonical k-mer -> occurrences) CSR, so the build cost is one big
// sort. numpy's single-threaded comparison argsort dominates the
// Python build (~13 min at 200k transcripts); this module replaces it
// with an OpenMP radix sort over the 2k key bits (stable, so
// occurrences stay in (transcript, position) order within a k-mer).
//
// K-mer convention matches salmon_tpu.utils.dna bit-for-bit:
// big-endian 2-bit packing, canonical = min(fwd, revcomp),
// fwd flag = (fwd <= revcomp).

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

// Greedy oct-alignment pads: pads[i] records inserted before key i so
// its min(counts[i], cap) leading records never cross an 8-record row
// boundary (salmon_tpu.index.diskfmt.oct_align_csr). Sequential phase
// chain — trivially O(n), memory-bound.
void oct_align_pads(const int64_t* counts, int64_t n, int64_t cap,
                    int64_t* pads) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t c = counts[i];
    const int64_t lead = c < cap ? c : cap;
    const int64_t phase = pos & 7;
    const int64_t pad = (phase + lead > 8) ? (8 - phase) : 0;
    pads[i] = pad;
    pos += pad + c;
  }
}

// Count valid k-mer windows per transcript (windows containing a code
// >= 4 are invalid). Returns the total; fills counts[t] per transcript.
int64_t kmer_count(const uint8_t* seq, const int64_t* offsets,
                   int64_t n_txps, int32_t k, int64_t* counts) {
  int64_t total = 0;
#pragma omp parallel for schedule(dynamic, 64) reduction(+ : total)
  for (int64_t t = 0; t < n_txps; ++t) {
    const uint8_t* s = seq + offsets[t];
    const int64_t n = offsets[t + 1] - offsets[t];
    int64_t cnt = 0;
    int64_t last_bad = -1;
    for (int64_t i = 0; i < n; ++i) {
      if (s[i] >= 4) last_bad = i;
      if (i >= k - 1 && last_bad < i - k + 1) ++cnt;
    }
    counts[t] = cnt;
    total += cnt;
  }
  return total;
}

// Enumerate canonical k-mers into caller buffers at per-transcript
// start offsets (exclusive prefix sums of kmer_count's counts).
// keys[i]    = canonical k-mer (low 2k bits)
// payload[i] = txp << 32 | pos << 1 | fwd
void kmer_enumerate(const uint8_t* seq, const int64_t* offsets,
                    int64_t n_txps, int32_t k, const int64_t* starts,
                    uint64_t* keys, uint64_t* payload) {
  const int shift_hi = 2 * (k - 1);
  const uint64_t mask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t t = 0; t < n_txps; ++t) {
    const uint8_t* s = seq + offsets[t];
    const int64_t n = offsets[t + 1] - offsets[t];
    int64_t out = starts[t];
    uint64_t fw = 0, rc = 0;
    int64_t last_bad = -1;
    for (int64_t i = 0; i < n; ++i) {
      const uint64_t c = s[i] < 4 ? s[i] : 0;
      if (s[i] >= 4) last_bad = i;
      fw = ((fw << 2) | c) & mask;
      rc = (rc >> 2) | ((3ull - c) << shift_hi);
      if (i >= k - 1 && last_bad < i - k + 1) {
        const bool is_fw = fw <= rc;
        const uint64_t canon = is_fw ? fw : rc;
        const uint64_t pos = (uint64_t)(i - k + 1);
        keys[out] = canon;
        payload[out] = ((uint64_t)t << 32) | (pos << 1) |
                       (is_fw ? 1ull : 0ull);
        ++out;
      }
    }
  }
}

// Partitioned variants for genome-scale builds (3Gb+ concatenated
// input, where one flat enumeration would need >100 GB of sort
// buffers): only k-mers whose canonical value has top `part_bits`
// equal to `part_id` are kept. Partitioning by the TOP canonical bits
// means per-partition sorts concatenate into the globally ascending
// order, and each partition needs only its share of the buffers.
int64_t kmer_count_part(const uint8_t* seq, const int64_t* offsets,
                        int64_t n_txps, int32_t k, int64_t* counts,
                        int32_t part_bits, uint64_t part_id) {
  const int shift_hi = 2 * (k - 1);
  const uint64_t mask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  const int part_shift = 2 * k - part_bits;
  int64_t total = 0;
#pragma omp parallel for schedule(dynamic, 64) reduction(+ : total)
  for (int64_t t = 0; t < n_txps; ++t) {
    const uint8_t* s = seq + offsets[t];
    const int64_t n = offsets[t + 1] - offsets[t];
    int64_t cnt = 0;
    uint64_t fw = 0, rc = 0;
    int64_t last_bad = -1;
    for (int64_t i = 0; i < n; ++i) {
      const uint64_t c = s[i] < 4 ? s[i] : 0;
      if (s[i] >= 4) last_bad = i;
      fw = ((fw << 2) | c) & mask;
      rc = (rc >> 2) | ((3ull - c) << shift_hi);
      if (i >= k - 1 && last_bad < i - k + 1) {
        const uint64_t canon = fw <= rc ? fw : rc;
        if ((canon >> part_shift) == part_id) ++cnt;
      }
    }
    counts[t] = cnt;
    total += cnt;
  }
  return total;
}

void kmer_enumerate_part(const uint8_t* seq, const int64_t* offsets,
                         int64_t n_txps, int32_t k,
                         const int64_t* starts, uint64_t* keys,
                         uint64_t* payload, int32_t part_bits,
                         uint64_t part_id) {
  const int shift_hi = 2 * (k - 1);
  const uint64_t mask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  const int part_shift = 2 * k - part_bits;
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t t = 0; t < n_txps; ++t) {
    const uint8_t* s = seq + offsets[t];
    const int64_t n = offsets[t + 1] - offsets[t];
    int64_t out = starts[t];
    uint64_t fw = 0, rc = 0;
    int64_t last_bad = -1;
    for (int64_t i = 0; i < n; ++i) {
      const uint64_t c = s[i] < 4 ? s[i] : 0;
      if (s[i] >= 4) last_bad = i;
      fw = ((fw << 2) | c) & mask;
      rc = (rc >> 2) | ((3ull - c) << shift_hi);
      if (i >= k - 1 && last_bad < i - k + 1) {
        const bool is_fw = fw <= rc;
        const uint64_t canon = is_fw ? fw : rc;
        if ((canon >> part_shift) != part_id) continue;
        const uint64_t pos = (uint64_t)(i - k + 1);
        keys[out] = canon;
        payload[out] = ((uint64_t)t << 32) | (pos << 1) |
                       (is_fw ? 1ull : 0ull);
        ++out;
      }
    }
  }
}

// Unpack sorted payload words into (txp, pos, fwd) columns in one
// parallel pass (numpy's u64 shift+cast chain costs several seconds at
// hundreds of millions of occurrences).
// decode straight to the packed pf = pos << 1 | fwd plane (the payload
// low word IS pf) — skips the separate pos/fwd planes and the later
// packing transient at genome scale
void kmer_decode_payload_pf(const uint64_t* payload, int64_t n,
                            int32_t* txp, int32_t* pf) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t p = payload[i];
    txp[i] = (int32_t)(p >> 32);
    pf[i] = (int32_t)(p & 0xFFFFFFFFu);
  }
}

void kmer_decode_payload(const uint64_t* payload, int64_t n,
                         int32_t* txp, int32_t* pos, uint8_t* fwd) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t p = payload[i];
    txp[i] = (int32_t)(p >> 32);
    pos[i] = (int32_t)((p >> 1) & 0x7FFFFFFFu);
    fwd[i] = (uint8_t)(p & 1);
  }
}

// ---------------------------------------------------------------------------
// Two-choice bucket-table placement (salmon_tpu.index.hashtable
// build_hash_table rounds 1-3). The Python path's np.lexsort ranking is
// single-threaded and dominates sharded-index loads (~47 min at 312M
// keys); this reproduces the exact placement (bit-identical slot_key)
// with the parallel radix sort above. Reference role: pufferfish MPHF
// construction (SalmonIndex load path, SURVEY.md §2.3).
//
// Hash mixes are bit-for-bit twins of hashtable.py mix32 / mix32b.

static inline uint32_t mix32_c(uint32_t hi, uint32_t lo) {
  uint32_t x = lo ^ (hi * 0x9E3779B9u) ^ 0x85EBCA6Bu;
  x ^= x >> 16; x *= 0x85EBCA6Bu;
  x ^= x >> 13; x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

static inline uint32_t mix32b_c(uint32_t hi, uint32_t lo) {
  uint32_t x = hi ^ (lo * 0x85EBCA77u) ^ 0xC2B2AE3Du;
  x ^= x >> 17; x *= 0xED5AD4BBu;
  x ^= x >> 11; x *= 0xAC4C1B51u;
  x ^= x >> 15;
  return x;
}

void radix_sort_u64(uint64_t* keys, uint64_t* payload, int64_t n,
                    int32_t bits, uint64_t* tk, uint64_t* tp);

// Places n unique keys into n_buckets 4-slot buckets. counts[i] is the
// key's ranking weight (stored occurrence count; < 2^32). slot_key
// (n_buckets * 4 int32, caller-allocated) receives the key index per
// slot or -1. Returns the number of evicted keys (walk exhaustion).
// Placement equals the numpy path element-for-element: same balanced
// first choice (<= tie), same lowest-count-first in-bucket ranking with
// input-order ties (stable sorts), same deterministic kick walk.
int64_t table_place(const uint64_t* keys, const uint32_t* counts,
                    int64_t n, int64_t n_buckets, int32_t* slot_key) {
  const uint32_t mask = (uint32_t)(n_buckets - 1);
  std::vector<uint32_t> b1(n), b2(n);
  std::vector<uint32_t> cand1(n_buckets, 0), cand2(n_buckets, 0);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t hi = (uint32_t)(keys[i] >> 32);
    const uint32_t lo = (uint32_t)keys[i];
    const uint32_t v1 = mix32_c(hi, lo) & mask;
    const uint32_t v2 = mix32b_c(hi, lo) & mask;
    b1[i] = v1;
    b2[i] = v2;
    __atomic_fetch_add(&cand1[v1], 1u, __ATOMIC_RELAXED);
    __atomic_fetch_add(&cand2[v2], 1u, __ATOMIC_RELAXED);
  }

  // round 1: sort (preferred bucket, count) composites; stable radix
  // keeps input order on ties, matching np.lexsort((counts, bucket))
  std::vector<uint64_t> comp(n), pidx(n), tk(n), tp(n);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t f =
        cand1[b1[i]] <= cand2[b2[i]] ? b1[i] : b2[i];
    comp[i] = ((uint64_t)f << 32) | counts[i];
    pidx[i] = (uint64_t)i;
  }
  int bucket_bits = 0;
  while ((1ll << bucket_bits) < n_buckets) ++bucket_bits;
  radix_sort_u64(comp.data(), pidx.data(), n, 32 + bucket_bits,
                 tk.data(), tp.data());

#pragma omp parallel for schedule(static)
  for (int64_t s = 0; s < n_buckets * 4; ++s) slot_key[s] = -1;
  std::vector<uint8_t> used(n_buckets, 0);
  std::vector<uint8_t> placed((size_t)n, 0);
  {
    int64_t run_start = 0;
    for (int64_t i = 0; i < n; ++i) {
      if (i && (comp[i] >> 32) != (comp[i - 1] >> 32)) run_start = i;
      const int64_t rank = i - run_start;
      if (rank < 4) {
        const int64_t b = (int64_t)(comp[i] >> 32);
        slot_key[b * 4 + rank] = (int32_t)pidx[i];
        placed[pidx[i]] = 1;
        used[b] = (uint8_t)(rank + 1);
      }
    }
  }

  // round 2: overflow keys fall back to the alternate bucket's
  // remaining capacity (subset in input order, same stable ranking)
  int64_t n2 = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (placed[i]) continue;
    const uint32_t f = cand1[b1[i]] <= cand2[b2[i]] ? b1[i] : b2[i];
    const uint32_t sec = (f == b1[i]) ? b2[i] : b1[i];
    comp[n2] = ((uint64_t)sec << 32) | counts[i];
    pidx[n2] = (uint64_t)i;
    ++n2;
  }
  radix_sort_u64(comp.data(), pidx.data(), n2, 32 + bucket_bits,
                 tk.data(), tp.data());
  {
    int64_t run_start = 0;
    for (int64_t i = 0; i < n2; ++i) {
      if (i && (comp[i] >> 32) != (comp[i - 1] >> 32)) run_start = i;
      const int64_t rank = i - run_start;
      const int64_t b = (int64_t)(comp[i] >> 32);
      if (rank < 4 - used[b]) {
        slot_key[b * 4 + used[b] + rank] = (int32_t)pidx[i];
        placed[pidx[i]] = 1;
      }
    }
  }

  // round 3: deterministic cuckoo kicks for the residue (input order)
  int64_t n_evicted = 0;
  for (int64_t u = 0; u < n; ++u) {
    if (placed[u]) continue;
    int64_t key = u;
    bool done = false;
    for (int t = 0; t < 64 && !done; ++t) {
      const int64_t cand[2] = {(int64_t)b1[key], (int64_t)b2[key]};
      for (int c = 0; c < 2 && !done; ++c) {
        for (int s = 0; s < 4; ++s) {
          if (slot_key[cand[c] * 4 + s] < 0) {
            slot_key[cand[c] * 4 + s] = (int32_t)key;
            done = true;
            break;
          }
        }
      }
      if (done) break;
      const int64_t b = (t % 2 == 0) ? (int64_t)b1[key]
                                     : (int64_t)b2[key];
      const int64_t v = (key * 7 + (int64_t)t * 5 + 3) % 4;
      const int64_t victim = slot_key[b * 4 + v];
      slot_key[b * 4 + v] = (int32_t)key;
      key = victim;
    }
    if (!done) ++n_evicted;
  }
  return n_evicted;
}

// Parallel fixed-width row gather: dst[i] = src[idx[i]] for row_bytes-
// sized rows (numpy fancy indexing is single-threaded; sharded-index
// loads gather hundreds of millions of 6/8-byte occurrence records).
void gather_rows(const uint8_t* src, const int64_t* idx, int64_t n,
                 int64_t row_bytes, uint8_t* dst) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                (size_t)row_bytes);
}

// Stable parallel LSD radix sort of (keys, payload) by the low `bits`
// key bits. tk/tp are caller-allocated scratch of the same size.
// Stability: per-pass static chunking is identical between the
// histogram and scatter loops, and thread chunks are laid out in tid
// order by the (bucket, thread) prefix sum.
void radix_sort_u64(uint64_t* keys, uint64_t* payload, int64_t n,
                    int32_t bits, uint64_t* tk, uint64_t* tp) {
  if (n <= 1) return;
  const int passes = (bits + 7) / 8;
  const int nt = omp_get_max_threads();
  std::vector<int64_t> hist((size_t)nt * 256);
  // identical static partition for both loops of every pass
  const int64_t chunk = (n + nt - 1) / nt;

  uint64_t* sk = keys;
  uint64_t* sp = payload;
  uint64_t* dk = tk;
  uint64_t* dp = tp;
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * 8;
    std::fill(hist.begin(), hist.end(), 0);
#pragma omp parallel num_threads(nt)
    {
      const int tid = omp_get_thread_num();
      int64_t* h = &hist[(size_t)tid * 256];
      const int64_t lo = tid * chunk;
      const int64_t hi = lo + chunk < n ? lo + chunk : n;
      for (int64_t i = lo; i < hi; ++i) ++h[(sk[i] >> shift) & 0xFF];
    }
    int64_t sum = 0;
    for (int b = 0; b < 256; ++b)
      for (int t = 0; t < nt; ++t) {
        const int64_t c = hist[(size_t)t * 256 + b];
        hist[(size_t)t * 256 + b] = sum;
        sum += c;
      }
#pragma omp parallel num_threads(nt)
    {
      const int tid = omp_get_thread_num();
      int64_t* h = &hist[(size_t)tid * 256];
      const int64_t lo = tid * chunk;
      const int64_t hi = lo + chunk < n ? lo + chunk : n;
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t d = h[(sk[i] >> shift) & 0xFF]++;
        dk[d] = sk[i];
        dp[d] = sp[i];
      }
    }
    std::swap(sk, dk);
    std::swap(sp, dp);
  }
  if (sk != keys) {
    std::memcpy(keys, sk, (size_t)n * 8);
    std::memcpy(payload, sp, (size_t)n * 8);
  }
}

}  // extern "C"
