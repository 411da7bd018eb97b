// Equivalence-class table of the port's eq accumulator
// (salmon_tpu_torch/inference/eqclasses.py).
//
// Role: the reference's concurrent cuckoo hash map of classes
// (include/salmon/internal/quant/EquivalenceClassBuilder.hpp:237-272).
// A class is keyed on its whole row: ncols int32, the transcript ids
// (INVALID_TXP padded) and, under range factorization, as many bin ids.
// Each class carries a float64 count and t2 float64 aux-weight sums.
//
// Layout: the keys of the classes lie contiguously in the order the
// classes were opened; an open-addressing slot array (linear probing,
// at most half full) holds each class's index beside its 64-bit row
// hash. A probe compares the stored hash before the key, and growth
// rehashes from the stored hashes without reading a key. A merge that
// would pass the load limit first grows the slots once, to the size
// that holds every row it could open, so no merge pays for more than
// one rehash; the class arrays are reserved to the same limit, so they
// move only then. The global table starts at 2^16 slots (room for 2^15
// classes, inference/eqclasses.py) and doubles from there.
//
// Sums: a class's rows are added in the order they arrive, in float64.
// The same code serves any ncols (mapping mode's labels and bins,
// alignment mode's labels alone).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

struct Slot {
  uint64_t hash;
  int64_t idx;  // class index; -1: empty
};

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

// xxHash64's round over 8-byte words, then its avalanche
inline uint64_t row_hash(const int32_t* k, int64_t ncols) {
  const uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                 P3 = 0x165667B19E3779F9ULL;
  uint64_t h = P3 ^ (uint64_t)ncols;
  int64_t j = 0;
  for (; j + 2 <= ncols; j += 2) {
    uint64_t w;
    std::memcpy(&w, k + j, 8);
    h ^= rotl(w * P2, 31) * P1;
    h = rotl(h, 27) * P1 + P3;
  }
  if (j < ncols) {
    h ^= (uint64_t)(uint32_t)k[j] * P1;
    h = rotl(h, 23) * P2 + P3;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

struct Table {
  int64_t ncols, t2;
  int64_t n = 0;          // classes
  int64_t limit = 0;      // rows the class arrays hold: half the slots
  std::vector<Slot> slots;
  int32_t* keys = nullptr;
  double* counts = nullptr;
  double* wsum = nullptr;

  Table(int64_t ncols_, int64_t t2_, int64_t n_slots)
      : ncols(ncols_), t2(t2_) {
    resize(n_slots);
  }
  ~Table() {
    std::free(keys);
    std::free(counts);
    std::free(wsum);
  }

  template <class T>
  static T* grow_array(T* p, int64_t elems) {
    void* q = std::realloc(p, (size_t)(elems > 0 ? elems : 1) * sizeof(T));
    if (q == nullptr) throw std::bad_alloc();
    return static_cast<T*>(q);
  }

  // the class arrays reserved to half of n_slots (a power of two), then
  // the slot array rebuilt at n_slots from the stored hashes; a failed
  // allocation leaves the table as it was
  void resize(int64_t n_slots) {
    const int64_t rows = n_slots / 2;
    keys = grow_array(keys, rows * ncols);
    counts = grow_array(counts, rows);
    wsum = grow_array(wsum, rows * t2);
    std::vector<Slot> fresh((size_t)n_slots, Slot{0, -1});
    const uint64_t mask = (uint64_t)n_slots - 1;
    for (const Slot& s : slots) {
      if (s.idx < 0) continue;
      uint64_t p = s.hash & mask;
      while (fresh[p].idx >= 0) p = (p + 1) & mask;
      fresh[p] = s;
    }
    slots.swap(fresh);
    limit = rows;
  }

  // room for m more classes, by at most one rehash
  void reserve(int64_t m) {
    if (n + m <= limit) return;
    int64_t s = (int64_t)slots.size();
    while ((n + m) > s / 2) s *= 2;
    resize(s);
  }

  // add m rows (count 1 each when in_counts is null); returns the rows
  // that opened a class. The rows' hashes are taken first, so that the
  // slot of a row 8 rows ahead is fetched while this one probes.
  template <class W>
  int64_t add(const int32_t* in_keys, const double* in_counts,
              const W* in_w, int64_t m) {
    reserve(m);
    const uint64_t mask = (uint64_t)slots.size() - 1;
    const size_t key_bytes = (size_t)ncols * sizeof(int32_t);
    const int64_t n0 = n;
    std::vector<uint64_t> hashes((size_t)m);
    for (int64_t r = 0; r < m; ++r)
      hashes[r] = row_hash(in_keys + r * ncols, ncols);
    for (int64_t r = 0; r < m; ++r) {
      if (r + 8 < m) __builtin_prefetch(&slots[hashes[r + 8] & mask]);
      const int32_t* k = in_keys + r * ncols;
      const W* w = in_w + r * t2;
      const double c = in_counts != nullptr ? in_counts[r] : 1.0;
      const uint64_t h = hashes[r];
      uint64_t p = h & mask;
      int64_t idx;
      for (;;) {
        const Slot& s = slots[p];
        if (s.idx < 0) {
          idx = n++;
          slots[p] = Slot{h, idx};
          std::memcpy(keys + idx * ncols, k, key_bytes);
          counts[idx] = c;
          double* ws = wsum + idx * t2;
          for (int64_t j = 0; j < t2; ++j) ws[j] = (double)w[j];
          break;
        }
        if (s.hash == h &&
            std::memcmp(keys + s.idx * ncols, k, key_bytes) == 0) {
          idx = s.idx;
          counts[idx] += c;
          double* ws = wsum + idx * t2;
          for (int64_t j = 0; j < t2; ++j) ws[j] += (double)w[j];
          break;
        }
        p = (p + 1) & mask;
      }
    }
    return n - n0;
  }
};

// the least power of two, at least 16, that holds rows under the limit
int64_t slots_for(int64_t rows) {
  int64_t s = 16;
  while (rows > s / 2) s *= 2;
  return s;
}

}  // namespace

extern "C" {

// A new, empty table of classes keyed on ncols int32 with t2 weight
// sums, with room for n_rows classes before it grows. Null when out of
// memory.
void* eqt_new(int64_t ncols, int64_t t2, int64_t n_rows) {
  try {
    return new Table(ncols, t2, slots_for(n_rows));
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

void eqt_free(void* t) { delete static_cast<Table*>(t); }

int64_t eqt_size(void* t) { return static_cast<Table*>(t)->n; }

// Merge m deduped rows (keys m x ncols, counts m, wsum m x t2) into the
// table; returns the number of rows that opened a class, or -1 when out
// of memory (the table is then as it was).
int64_t eqt_merge(void* t, const int32_t* keys, const double* counts,
                  const double* wsum, int64_t m) {
  try {
    return static_cast<Table*>(t)->add(keys, counts, wsum, m);
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

// The table's rows ascending by their bytes (memcmp, the order of a
// numpy void view of the rows): keys (n x ncols), counts (n), wsum
// (n x t2), caller-allocated. Returns 0, or -1 when out of memory.
int64_t eqt_export(void* t, int32_t* keys, double* counts, double* wsum) {
  const Table* tab = static_cast<Table*>(t);
  const int64_t nc = tab->ncols, t2 = tab->t2;
  const size_t key_bytes = (size_t)nc * sizeof(int32_t);
  try {
    std::vector<int64_t> order((size_t)tab->n);
    for (int64_t i = 0; i < tab->n; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      return std::memcmp(tab->keys + a * nc, tab->keys + b * nc,
                         key_bytes) < 0;
    });
    for (int64_t i = 0; i < tab->n; ++i) {
      const int64_t r = order[i];
      std::memcpy(keys + i * nc, tab->keys + r * nc, key_bytes);
      counts[i] = tab->counts[r];
      std::memcpy(wsum + i * t2, tab->wsum + r * t2,
                  (size_t)t2 * sizeof(double));
    }
  } catch (const std::bad_alloc&) {
    return -1;
  }
  return 0;
}

// One batch's dedupe: m rows (keys m x ncols, float32 weights m x t2,
// one fragment each) through a table of the batch's own size. Writes the
// unique rows in order of first appearance, their counts and float64
// weight sums (caller-allocated, m rows each); returns their number, or
// -1 when out of memory.
int64_t eqt_dedupe(const int32_t* keys, const float* w, int64_t m,
                   int64_t ncols, int64_t t2, int32_t* out_keys,
                   double* out_counts, double* out_wsum) {
  try {
    Table tab(ncols, t2, slots_for(m));
    const int64_t n = tab.add(keys, nullptr, w, m);
    std::memcpy(out_keys, tab.keys, (size_t)(n * ncols) * sizeof(int32_t));
    std::memcpy(out_counts, tab.counts, (size_t)n * sizeof(double));
    std::memcpy(out_wsum, tab.wsum, (size_t)(n * t2) * sizeof(double));
    return n;
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

}  // extern "C"
