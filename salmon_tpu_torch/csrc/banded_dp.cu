// Score-only banded affine-gap DP for selective-alignment validation.
//
// Replaces the Pallas TPU kernel
// salmon_tpu/mapping/align.py::_banded_scores_pallas (and its probe
// ancestor scripts/probe_r5_dp2.py::banded_pallas_noskew). It computes
// what salmon_tpu_torch/mapping/align.py::_banded_scores_plain computes
// on the packed-sequence path, bit for bit:
//
//   F[d]  = max(F'[d+1] - ge, H'[d+1] - go - ge)         gap in read
//   Hn[d] = max(H'[d] + sub(read_i, ref_{i+d}), F[d])
//   P[d]  = max(P[d-1] - ge, Hn[d] - go)                 gap in reference
//   H[d]  = max(Hn[d], P[d-1] - ge)  (softclip: max(H, 0))
//
// over band offsets d in [-bw, bw] (B = 2*bw + 1 cells), for every read
// row in [read_start, read_start + read_len); score = max_d H (softclip:
// max over rows of max_d H).
//
// Design for the H100.
// - int32 cells, NEG = -1e9. Every real cell is an integer sum far below
//   2^24 and H starts at 0 in every band cell, so a NEG-derived value
//   never wins a max against a real one: the int32 DP gives the plain
//   float32 version's outputs exactly (tests/test_torch_dp_int.py holds
//   a numpy emulation of this data flow to it). Scores come in as ints
//   (the wrapper refuses others). Each recurrence above is one Hopper
//   DPX add-max, VIADDMNMX (__viaddmax_s32; _relu folds the softclip
//   clamp); ptxas emits the same instruction for max(a + b, c) written
//   out.
// - The prefix P is a serial running max inside a lane: 2 instructions
//   a cell, where a log-depth scan costs 2 ceil(log2 B).
// - Blocked lanes: G lanes per problem, lane g holding the C cells
//   [gC, gC + C), C >= B / G, 32/G problems per warp. The d+1 shift
//   leaves a lane only at its last cell (2 shuffles a row). With G > 1
//   the prefix takes two passes: a lane-local pass gives the lane's
//   aggregate, a log2(G)-step segmented max-plus scan gives each lane
//   its carry-in, and a second pass computes H from it. Integer
//   max-plus is associative, so the order of association is free.
//   Cells at B or above stay NEG. The main DP's band (15) runs G = 1,
//   a thread per problem with no shuffle; the rescue's band (80) G =
//   BANDED_DP_LANES_80; other bands with B <= 31 G = 1 with C rounded
//   up to a multiple of 8, wider ones G = 32, B at run time.
// - Substitution scores from bitmasks, once per row: each lane keeps the
//   2-bit reference codes of its C cells in one register, slid by one
//   base a row; x = ref ^ (read code * 0x55..) gives the match bits of
//   all C cells at once, and a cell's score is one bit test and a
//   select. The cells inside the transcript form one range per row;
//   rows where no lane of the warp leaves the transcript skip the OOB
//   select (a warp vote picks the row's path).
// - Staging stays fused: each lane copies its own problem's read row
//   (by read_id, 16-byte loads) and the 2-bit words of its reference
//   window into shared memory, so a warp's loads are all in flight
//   together; the read stride is padded so that 32 lanes reading row i
//   of 32 problems hit 32 banks. No (P, W) window tensor reaches device
//   memory.
//
// What bounds it: a main-path batch holds ~5e7 band cells against a few
// MB of input, so not memory but the integer pipe. At bw 15 a row's
// 31 cells are 231 SASS instructions in the row loop's block without
// the OOB select (7.45 a cell: 4 VIADDMNMX, 2 IMAD, 1 SEL, R2P;
// tools/sass_banded_dp.py), and the 16,384 problems are 512 warps, one
// per scheduler. Two lanes per problem (twice the warps, more
// instructions) and two rows in flight per step were both slower, so
// the dispatch rate of the add-max chain, not latency, bounds it. At
// bw 80 the rescue's 1,024 problems make 512 warps at G = 16, one a
// scheduler, and each row is a chain of shuffles, a scan and two serial
// passes: latency bounds it. PERF.md holds the times and the lane counts
// measured.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -1000000000;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kEven = 0x5555555555555555ull;
constexpr int kWarpsPerBlock = 2;
// largest band half-width: B = 2 bw + 1 cells fill at most 8 per lane
// at G = 32 (salmon_tpu_torch/mapping/align.py MAX_KERNEL_BANDWIDTH)
constexpr int kMaxBandwidth = 127;
// other bands: B <= kNarrowCells a thread per problem, C rounded up to
// a multiple of 8; wider ones G = 32
constexpr int kNarrowCells = 31;
constexpr int kGenericLanes = 32;
// Bands compiled with B fixed: the main DP's default and the rescue's
// (salmon_tpu_torch/constants.py dp_bandwidth, rescue_bandwidth;
// tests/test_torch_align.py holds this list to those defaults), and
// their lanes per problem (a build may set others with -D, as
// tools/compare_banded_dp.py does to measure them).
constexpr int kFixedBands[] = {15, 80};
#ifndef BANDED_DP_LANES_15
#define BANDED_DP_LANES_15 1
#endif
#ifndef BANDED_DP_LANES_80
#define BANDED_DP_LANES_80 16
#endif

constexpr int cells_per_lane(int bw, int lanes) {
  return (2 * bw + 1 + lanes - 1) / lanes;
}
static_assert(32 % BANDED_DP_LANES_15 == 0 && 32 % BANDED_DP_LANES_80 == 0,
              "lanes per problem must divide the warp");
static_assert(cells_per_lane(kFixedBands[0], BANDED_DP_LANES_15) <= 31 &&
                  cells_per_lane(kFixedBands[1], BANDED_DP_LANES_80) <= 31 &&
                  cells_per_lane(kMaxBandwidth, kGenericLanes) <= 31,
              "a lane's reference codes must fit one 64-bit register");

// shared memory of one warp: 32/G read rows, their stride in 4-byte
// words odd (bank-conflict free), then 32/G windows of 2-bit words
__host__ __device__ inline int read_stride(int L) {
  const int words = (L + 3) / 4;
  return 4 * (words | 1);
}
__host__ __device__ inline int window_words(int L, int lanes, int cells) {
  return (L + lanes * cells + 15) / 16 + 1;
}
__host__ __device__ inline int warp_smem_bytes(int L, int lanes, int cells) {
  return (32 / lanes) *
         (read_stride(L) + 4 * (window_words(L, lanes, cells) | 1));
}

struct Args {
  const uint8_t* reads;
  int64_t n_reads;
  int L;
  const int32_t* read_ids;
  const int32_t* read_lens;
  const int32_t* ref_base;
  const int32_t* txp_lens;
  const int32_t* read_starts;
  const void* seq_off;
  int off64;
  const uint32_t* words;
  int64_t n_word_rows;
  int words_shift;
  int P;
  int bw;
  int ma, mp, go, ge, oob;
  float* out;
};

template <int C>
using RefBits = typename std::conditional<(C <= 16), uint32_t, uint64_t>::type;

// Bits 2k of the cells [lo, hi) of a lane, 0 <= lo, hi <= C <= 31.
template <int C>
__device__ __forceinline__ RefBits<C> cell_range(int lo, int hi) {
  const uint64_t below_hi = (1ull << (2 * hi)) - 1;
  const uint64_t below_lo = (1ull << (2 * lo)) - 1;
  return static_cast<RefBits<C>>(below_hi & ~below_lo & kEven);
}

// One read row of one problem's lane: cells updated in place, in
// ascending order (cell k reads the old k + 1, not updated yet).
// `match` holds bit 2k for cells whose reference base equals the read
// base; with OOB, `inside` holds bit 2k for cells inside the transcript.
template <int G, int C, int BWC, bool SOFTCLIP, bool OOB>
__device__ __forceinline__ void dp_row(int (&H)[C], int (&F)[C], int& hm,
                                       RefBits<C> match, RefBits<C> inside,
                                       int g, int n_valid, unsigned mask,
                                       const Args& a) {
  // cells k < always_valid lie inside the band in every lane
  constexpr int always_valid = BWC > 0 ? 2 * BWC + 1 - (G - 1) * C : 0;
  const int go_ge = a.go + a.ge;
  RefBits<C> oob_bits = 0;
  if (OOB) {
    match &= inside;
    oob_bits = ~inside & static_cast<RefBits<C>>(kEven);
  }
  int Hd = kNeg, Fd = kNeg;  // the cell past the lane's last one
  if constexpr (G > 1) {
    Hd = __shfl_down_sync(mask, H[0], 1, G);
    Fd = __shfl_down_sync(mask, F[0], 1, G);
    if (g == G - 1) Hd = Fd = kNeg;
  }
  int run = kNeg;  // G = 1: the prefix P; G > 1: the lane's aggregate
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int hn1 = k + 1 < C ? H[k + 1 < C ? k + 1 : 0] : Hd;
    const int fn1 = k + 1 < C ? F[k + 1 < C ? k + 1 : 0] : Fd;
    const int fn = __viaddmax_s32(fn1, -a.ge, hn1 - go_ge);
    int sub = (match >> (2 * k)) & 1 ? a.ma : a.mp;
    if (OOB && ((oob_bits >> (2 * k)) & 1)) sub = a.oob;
    const int hnf = __viaddmax_s32(H[k], sub, fn);
    const bool ok = k < always_valid || k < n_valid;
    F[k] = ok ? fn : kNeg;
    if constexpr (G == 1) {
      const int hn = SOFTCLIP ? __viaddmax_s32_relu(run, -a.ge, hnf)
                              : __viaddmax_s32(run, -a.ge, hnf);
      H[k] = ok ? hn : kNeg;
    } else {
      H[k] = hnf;  // pass 2 turns it into H
    }
    run = __viaddmax_s32(run, -a.ge, hnf - a.go);
  }
  if constexpr (G > 1) {
    // carry-in: P at the lane's first cell from the lanes below, by a
    // segmented max-plus scan of the aggregates (a lane spans C cells)
    const int ge_c = a.ge * C;
#pragma unroll
    for (int s = 1; s < G; s <<= 1) {
      const int up = __shfl_up_sync(mask, run, s, G);
      if (g >= s) run = __viaddmax_s32(up, -ge_c * s, run);
    }
    int P = __shfl_up_sync(mask, run, 1, G);
    if (g == 0) P = kNeg;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int hnf = H[k];
      const int hn = SOFTCLIP ? __viaddmax_s32_relu(P, -a.ge, hnf)
                              : __viaddmax_s32(P, -a.ge, hnf);
      P = __viaddmax_s32(P, -a.ge, hnf - a.go);
      const bool ok = k < always_valid || k < n_valid;
      H[k] = ok ? hn : kNeg;
    }
  }
  if constexpr (SOFTCLIP) {
#pragma unroll
    for (int k = 0; k < C; k += 2)
      hm = __vimax3_s32(hm, H[k], H[k + 1 < C ? k + 1 : k]);
  }
}

// G lanes per problem, C cells per lane; BWC > 0 fixes the band
// half-width at compile time, BWC = 0 takes it from a.bw
template <int G, int C, int BWC, bool SOFTCLIP>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
banded_dp_kernel(const Args a) {
  using Ref = RefBits<C>;
  constexpr int kProblemsPerWarp = 32 / G;
  const int BW = BWC > 0 ? BWC : a.bw;
  const int B = 2 * BW + 1;
  const int L = a.L;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane % G;
  const int q = lane / G;
  const int p0 = (blockIdx.x * kWarpsPerBlock + warp) * kProblemsPerWarp;
  if (p0 >= a.P) return;  // whole warps leave together; no block barrier
  const int p = p0 + q;
  const bool live = p < a.P;
  const int pc = live ? p : a.P - 1;

  // --- stage the read rows and the reference windows -------------------
  const int stride = read_stride(L);
  const int n_words = window_words(L, G, C);
  const int wstride = n_words | 1;
  extern __shared__ uint32_t smem[];
  uint32_t* mine = smem + warp * (warp_smem_bytes(L, G, C) / 4);
  uint8_t* rows = reinterpret_cast<uint8_t*>(mine);
  uint32_t* wins = mine + kProblemsPerWarp * stride / 4;

  int64_t rid = a.read_ids[pc];
  rid = rid < 0 ? 0 : (rid >= a.n_reads ? a.n_reads - 1 : rid);
  const int rb = a.ref_base[pc];
  const int tl = a.txp_lens[pc];
  const int64_t so = a.off64 ? static_cast<const int64_t*>(a.seq_off)[pc]
                             : static_cast<const int32_t*>(a.seq_off)[pc];
  int64_t a0 = so + static_cast<int64_t>(rb - BW + a.words_shift);
  if (a0 < 0) a0 = 0;
  const int sh = static_cast<int>(a0 & 15);
  // each lane copies a share of its own problem's read row and window
  // words (the G lanes of a problem split them), so the whole warp's
  // loads are independent and in flight together
  uint8_t* rd = rows + q * stride;
  uint32_t* win = wins + q * wstride;
  if (live) {
    const uint8_t* src = a.reads + rid * L;
    if ((L & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      for (int t = g; t < L / 16; t += G) {
        const uint4 v = reinterpret_cast<const uint4*>(src)[t];
        uint32_t* dst = reinterpret_cast<uint32_t*>(rd) + 4 * t;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    } else {
      for (int t = g; t < L; t += G) rd[t] = src[t];
    }
    const int64_t w0 = a0 >> 4;
    for (int t = g; t < n_words; t += G) {
      const int64_t wa = w0 + t;
      int64_t r = wa >> 3;
      if (r > a.n_word_rows - 1) r = a.n_word_rows - 1;
      win[t] = a.words[r * 8 + (wa & 7)];
    }
  }
  __syncwarp();
  auto code_at = [&](int w) -> Ref {  // 2-bit code at window position w
    const int pos = sh + w;
    return static_cast<Ref>((win[pos >> 4] >> (2 * (pos & 15))) & 3u);
  };

  // --- the DP over the active rows ---------------------------------------
  const int rs = a.read_starts[pc];
  const int i0 = rs > 0 ? rs : 0;
  const int i1 = min(rs + a.read_lens[pc], L);
  const int len = live && i1 > i0 ? i1 - i0 : 0;
  const int cell0 = g * C;
  const int n_valid = min(max(B - cell0, 0), C);
  int H[C], F[C];
  Ref ref = 0;
  const int first = min(i0, L);
#pragma unroll
  for (int k = 0; k < C; ++k) {
    H[k] = k < n_valid ? 0 : kNeg;  // cells past the band stay NEG
    F[k] = kNeg;
    ref |= code_at(first + cell0 + k) << (2 * k);
  }
  int hm = kNeg;
  const int base0 = rb - BW + cell0;  // transcript position of cell 0, row 0
  const int rows_max = static_cast<int>(
      __reduce_max_sync(kFull, static_cast<unsigned>(len)));
  for (int j = 0; j < rows_max; ++j) {
    const bool act = j < len;
    const int i = min(i0 + j, L - 1);
    const int rc = rd[i];
    const Ref x = ref ^ (static_cast<Ref>(kEven) * static_cast<Ref>(rc & 3));
    const Ref match = rc >= 4 ? 0 : ~(x | (x >> 1)) & static_cast<Ref>(kEven);
    const int lo = min(max(-(base0 + i), 0), C);
    const int hi = min(max(tl - (base0 + i), 0), C);
    const Ref inside = cell_range<C>(lo, hi);
    // slide: drop cell 0's base, take the one past cell C - 1
    const Ref slid = (ref >> 2) | (code_at(i + cell0 + C) << (2 * (C - 1)));
    const bool any_oob = __any_sync(kFull, act && (lo > 0 || hi < C));
    const unsigned mask = G > 1 ? __ballot_sync(kFull, act) : kFull;
    if (act) {
      if (any_oob)
        dp_row<G, C, BWC, SOFTCLIP, true>(H, F, hm, match, inside, g,
                                          n_valid, mask, a);
      else
        dp_row<G, C, BWC, SOFTCLIP, false>(H, F, hm, match, 0, g, n_valid,
                                           mask, a);
      ref = slid;
    }
  }

  int v = hm;
  if (!SOFTCLIP) {
    v = H[0];
#pragma unroll
    for (int k = 1; k < C; ++k) v = max(v, H[k]);
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, o, G));
  if (g == 0 && live) a.out[p] = static_cast<float>(v);
}

template <int G, int C, int BWC, bool SOFTCLIP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kProblemsPerWarp = 32 / G;
  const int smem = kWarpsPerBlock * warp_smem_bytes(a.L, G, C);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        banded_dp_kernel<G, C, BWC, SOFTCLIP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int warps = (a.P + kProblemsPerWarp - 1) / kProblemsPerWarp;
  const int blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  banded_dp_kernel<G, C, BWC, SOFTCLIP>
      <<<blocks, kWarpsPerBlock * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool SOFTCLIP>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  // the fixed bands with B known to the compiler; every other band
  // through the runtime-band instances, G = 32
  constexpr int G0 = BANDED_DP_LANES_15, G1 = BANDED_DP_LANES_80;
  if (a.bw == kFixedBands[0])
    return launch<G0, cells_per_lane(kFixedBands[0], G0), kFixedBands[0],
                  SOFTCLIP>(a, stream);
  if (a.bw == kFixedBands[1])
    return launch<G1, cells_per_lane(kFixedBands[1], G1), kFixedBands[1],
                  SOFTCLIP>(a, stream);
  if (2 * a.bw + 1 <= kNarrowCells) {  // a thread per problem
    switch ((2 * a.bw + 1 + 7) / 8) {
      case 1: return launch<1, 8, 0, SOFTCLIP>(a, stream);
      case 2: return launch<1, 16, 0, SOFTCLIP>(a, stream);
      case 3: return launch<1, 24, 0, SOFTCLIP>(a, stream);
      default: return launch<1, kNarrowCells, 0, SOFTCLIP>(a, stream);
    }
  }
  constexpr int G = kGenericLanes;
  switch (cells_per_lane(a.bw, G)) {
    case 1: return launch<G, 1, 0, SOFTCLIP>(a, stream);
    case 2: return launch<G, 2, 0, SOFTCLIP>(a, stream);
    case 3: return launch<G, 3, 0, SOFTCLIP>(a, stream);
    case 4: return launch<G, 4, 0, SOFTCLIP>(a, stream);
    case 5: return launch<G, 5, 0, SOFTCLIP>(a, stream);
    case 6: return launch<G, 6, 0, SOFTCLIP>(a, stream);
    case 7: return launch<G, 7, 0, SOFTCLIP>(a, stream);
    case 8: return launch<G, 8, 0, SOFTCLIP>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code (banded_dp_error_string
// names it). Launches on `stream` and does not synchronise. Scores are
// integers (the wrapper checks that |score| < 2^20).
int banded_dp_scores(const void* reads, int64_t n_reads, int L,
                     const void* read_ids, const void* read_lens,
                     const void* ref_base, const void* txp_lens,
                     const void* read_starts, const void* seq_off, int off64,
                     const void* words, int64_t n_word_rows, int words_shift,
                     int P, int bandwidth, int ma, int mp, int go, int ge,
                     int oob_score, int softclip, void* out, void* stream) {
  if (P <= 0) return 0;
  if (L <= 0 || n_reads <= 0 || n_word_rows <= 0 || bandwidth < 0 ||
      bandwidth > kMaxBandwidth)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint8_t*>(reads), n_reads, L,
               static_cast<const int32_t*>(read_ids),
               static_cast<const int32_t*>(read_lens),
               static_cast<const int32_t*>(ref_base),
               static_cast<const int32_t*>(txp_lens),
               static_cast<const int32_t*>(read_starts), seq_off, off64,
               static_cast<const uint32_t*>(words), n_word_rows, words_shift,
               P, bandwidth, ma, mp, go, ge, oob_score,
               static_cast<float*>(out)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(softclip ? dispatch<true>(a, s)
                                   : dispatch<false>(a, s));
}

const char* banded_dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
