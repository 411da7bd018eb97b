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
//   X     = Kogge-Stone max-plus prefix of Hn - go      gap in reference
//   H[d]  = max(Hn[d], X[d-1] - ge)  (softclip: max(H, 0))
//
// over band offsets d in [-bw, bw] (B = 2*bw + 1 cells), for every read
// row in [read_start, read_start + read_len); score = max_d H (softclip:
// max over rows of max_d H).
//
// Design for the H100. One warp per problem, J = ceil(B / 32) cells per
// lane (template parameter, 1..8, so bw <= 127). Cells are interleaved:
// register j of lane l holds band offset d = l + 32 j, and cells at
// d >= B stay NEG. H, F and the running max live in registers. Every
// shift by s < 32 band cells is one rotation __shfl_sync per register,
// lanes below s taking the rotated value of register j - 1; a shift by
// a multiple of 32 is a register move. The d+1 shift of F and H, the
// Kogge-Stone prefix (steps s = 1, 2, 4, ... < B) and the final d-1
// shift of E all read only the previous step's values and keep the plain
// version's association order, so the float results match exactly, NEG
// saturation included. With one register (B <= 31) the shifts are plain
// __shfl_down_sync / __shfl_up_sync, lane 31 lying outside the band.
// The bands the main paths run (kFixedBands) are compiled with B known,
// so the prefix steps need no runtime test; other bands take B at run
// time, which costs time (PERF.md).
// Each warp first gathers its read row (by read_id) and decodes its
// reference window from the 2-bit words into shared memory (code 5
// outside the transcript), so no (P, W) window tensor ever reaches
// device memory.
//
// What bounds it: per band cell a row costs ~20 fp32 add/max operations
// plus shuffles, and a main-path batch has ~5e7 cells against a few MB
// of input, so it is bound by instruction issue, not memory. The rows of
// one problem form a serial chain of shuffles, so latency is hidden by
// keeping many warps resident (small blocks, a few KB of shared memory
// each), not by work inside a warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxCellsPerLane = 8;
// largest band half-width: B = 2 bw + 1 cells fill at most 8 per lane
// (salmon_tpu_torch/mapping/align.py MAX_KERNEL_BANDWIDTH)
constexpr int kMaxBandwidth = (32 * kMaxCellsPerLane - 1) / 2;
// Bands compiled with B fixed: the main DP's default and the rescue's
// (salmon_tpu_torch/constants.py dp_bandwidth, rescue_bandwidth;
// tests/test_torch_kernels.py holds this list to those defaults).
constexpr int kFixedBands[] = {15, 80};

constexpr int cells_per_lane(int bw) { return (2 * bw + 1 + 31) / 32; }
static_assert(cells_per_lane(kFixedBands[0]) <= kMaxCellsPerLane &&
                  cells_per_lane(kFixedBands[1]) <= kMaxCellsPerLane,
              "a fixed band is wider than the kernel takes");

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// out[j] at lane l = the cell s band offsets below (d - s), NEG below
// d = 0, for 0 < s < 32.
template <int J>
__device__ __forceinline__ void shift_up(const float (&v)[J], float (&out)[J],
                                         int s, int lane) {
  if constexpr (J == 1) {
    const float u = __shfl_up_sync(kFull, v[0], s);
    out[0] = lane >= s ? u : kNeg;
    return;
  }
  float rot[J];
#pragma unroll
  for (int j = 0; j < J; ++j)
    rot[j] = __shfl_sync(kFull, v[j], (lane - s) & 31);
#pragma unroll
  for (int j = 0; j < J; ++j)
    out[j] = lane >= s ? rot[j] : (j > 0 ? rot[j > 0 ? j - 1 : 0] : kNeg);
}

// J cells per lane; BWC > 0 fixes the band half-width at compile time
// (the bands the main paths run), BWC = 0 takes it from `bw`
template <int J, int BWC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
banded_dp_kernel(const uint8_t* __restrict__ reads, int64_t n_reads, int L,
                 const int32_t* __restrict__ read_ids,
                 const int32_t* __restrict__ read_lens,
                 const int32_t* __restrict__ ref_base,
                 const int32_t* __restrict__ txp_lens,
                 const int32_t* __restrict__ read_starts,
                 const void* __restrict__ seq_off, int off64,
                 const uint32_t* __restrict__ words, int64_t n_word_rows,
                 int words_shift, int P, int bw, float ma, float mp,
                 float go, float ge, float oob_score, int softclip,
                 float* __restrict__ out) {
  const int BW = BWC > 0 ? BWC : bw;
  const int B = 2 * BW + 1;
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + warp;
  if (p >= P) return;  // whole warps leave together; no block barrier
  const int W = L + B - 1;
  uint8_t* win = smem + warp * (round16(W) + round16(L));
  uint8_t* rd = win + round16(W);

  // --- stage the read row and the reference window -------------------
  int64_t rid = read_ids[p];
  rid = rid < 0 ? 0 : (rid >= n_reads ? n_reads - 1 : rid);
  const uint8_t* row = reads + rid * L;
  for (int i = lane; i < L; i += 32) rd[i] = row[i];

  const int rb = ref_base[p];
  const int tl = txp_lens[p];
  const int64_t so = off64 ? static_cast<const int64_t*>(seq_off)[p]
                           : static_cast<const int32_t*>(seq_off)[p];
  int64_t a0 = so + static_cast<int64_t>(rb - BW + words_shift);
  if (a0 < 0) a0 = 0;
  const int64_t w0 = a0 >> 4;
  const int sh = static_cast<int>(a0 & 15);
  for (int w = lane; w < W; w += 32) {
    const int widx = rb - BW + w;
    uint8_t code = 5;
    if (widx >= 0 && widx < tl) {
      const int64_t wa = w0 + ((sh + w) >> 4);
      int64_t r = wa >> 3;
      if (r > n_word_rows - 1) r = n_word_rows - 1;
      const uint32_t word = words[r * 8 + (wa & 7)];
      code = static_cast<uint8_t>((word >> (2 * ((sh + w) & 15))) & 3u);
    }
    win[w] = code;
  }
  __syncwarp();

  // --- the DP over the active rows ---------------------------------------
  bool in_band[J];
  float H[J], F[J], Hm[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    in_band[j] = lane + 32 * j < B;
    H[j] = in_band[j] ? 0.f : kNeg;  // cells past the band stay NEG
    F[j] = kNeg;
    Hm[j] = kNeg;
  }
  const int rs = read_starts[p];
  const int i0 = rs > 0 ? rs : 0;
  const int i1 = min(rs + read_lens[p], L);
  const int down = (lane + 1) & 31;
  for (int i = i0; i < i1; ++i) {
    const int rc = rd[i];
    // d+1 shift of F and H: lane 31 takes lane 0 of register j + 1 (with
    // one register, lane 31 lies outside every band and takes its own)
    float Fr[J], Hr[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      Fr[j] = J == 1 ? __shfl_down_sync(kFull, F[j], 1)
                     : __shfl_sync(kFull, F[j], down);
      Hr[j] = J == 1 ? __shfl_down_sync(kFull, H[j], 1)
                     : __shfl_sync(kFull, H[j], down);
    }
    float Fn[J], Hnf[J], X[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int jn = j + 1 < J ? j + 1 : j;
      const float Fd = lane < 31 || J == 1 ? Fr[j]
                                           : (j + 1 < J ? Fr[jn] : kNeg);
      const float Hd = lane < 31 || J == 1 ? Hr[j]
                                           : (j + 1 < J ? Hr[jn] : kNeg);
      const int ref = in_band[j] ? win[i + lane + 32 * j] : 5;
      const float sub = ref >= 5 ? oob_score
                                 : ((rc == ref && rc < 4 && ref < 4) ? ma
                                                                     : mp);
      Fn[j] = fmaxf(Fd - ge, Hd - go - ge);
      Hnf[j] = fmaxf(H[j] + sub, Fn[j]);
      X[j] = Hnf[j] - go;
    }
    // Kogge-Stone max-plus prefix, steps s = 1, 2, 4, ... while s < B
    // (the trip count is a constant, so registers keep constant indices)
#pragma unroll
    for (int k = 0; (1 << k) < 32 * J; ++k) {
      const int s = 1 << k;
      if (s < B) {  // uniform across the warp
        float up[J];
        if (s < 32) {
          shift_up<J>(X, up, s, lane);
        } else {
#pragma unroll
          for (int j = 0; j < J; ++j)
            up[j] = j >= s / 32 ? X[j >= s / 32 ? j - s / 32 : 0] : kNeg;
        }
#pragma unroll
        for (int j = 0; j < J; ++j)
          X[j] = fmaxf(X[j], up[j] - ge * static_cast<float>(s));
      }
    }
    float E[J];
    shift_up<J>(X, E, 1, lane);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float Hn = fmaxf(Hnf[j], E[j] - ge);
      if (softclip) Hn = fmaxf(Hn, 0.f);
      if (in_band[j]) {
        H[j] = Hn;
        F[j] = Fn[j];
        Hm[j] = fmaxf(Hm[j], Hn);
      }
    }
  }

  float v = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (in_band[j]) v = fmaxf(v, softclip ? Hm[j] : H[j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) out[p] = v;
}

template <int J, int BWC>
cudaError_t launch(const uint8_t* reads, int64_t n_reads, int L,
                   const int32_t* read_ids, const int32_t* read_lens,
                   const int32_t* ref_base, const int32_t* txp_lens,
                   const int32_t* read_starts, const void* seq_off,
                   int off64, const uint32_t* words, int64_t n_word_rows,
                   int words_shift, int P, int BW, float ma, float mp,
                   float go, float ge, float oob_score, int softclip,
                   float* out, cudaStream_t stream) {
  const int W = L + 2 * BW;
  const size_t smem =
      static_cast<size_t>(kWarpsPerBlock) * (round16(W) + round16(L));
  const int blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
  banded_dp_kernel<J, BWC><<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
      reads, n_reads, L, read_ids, read_lens, ref_base, txp_lens,
      read_starts, seq_off, off64, words, n_word_rows, words_shift, P, BW,
      ma, mp, go, ge, oob_score, softclip, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code (banded_dp_error_string
// names it). Launches on `stream` and does not synchronise.
int banded_dp_scores(const void* reads, int64_t n_reads, int L,
                     const void* read_ids, const void* read_lens,
                     const void* ref_base, const void* txp_lens,
                     const void* read_starts, const void* seq_off, int off64,
                     const void* words, int64_t n_word_rows, int words_shift,
                     int P, int bandwidth, float ma, float mp, float go,
                     float ge, float oob_score, int softclip, void* out,
                     void* stream) {
  if (P <= 0) return 0;
  if (L <= 0 || n_reads <= 0 || n_word_rows <= 0 || bandwidth < 0 ||
      bandwidth > kMaxBandwidth)
    return static_cast<int>(cudaErrorInvalidValue);
  const int J = cells_per_lane(bandwidth);
#define BANDED_DP_LAUNCH(CELLS, BWC)                                         \
    return static_cast<int>(launch<CELLS, BWC>(                              \
        static_cast<const uint8_t*>(reads), n_reads, L,                      \
        static_cast<const int32_t*>(read_ids),                               \
        static_cast<const int32_t*>(read_lens),                              \
        static_cast<const int32_t*>(ref_base),                               \
        static_cast<const int32_t*>(txp_lens),                               \
        static_cast<const int32_t*>(read_starts), seq_off, off64,            \
        static_cast<const uint32_t*>(words), n_word_rows, words_shift, P,    \
        bandwidth, ma, mp, go, ge, oob_score, softclip,                      \
        static_cast<float*>(out), static_cast<cudaStream_t>(stream)));
  // the fixed bands with B known to the compiler; every other band
  // through the runtime-band instances
  if (bandwidth == kFixedBands[0])
    BANDED_DP_LAUNCH(cells_per_lane(kFixedBands[0]), kFixedBands[0])
  if (bandwidth == kFixedBands[1])
    BANDED_DP_LAUNCH(cells_per_lane(kFixedBands[1]), kFixedBands[1])
  switch (J) {
    case 1: BANDED_DP_LAUNCH(1, 0)
    case 2: BANDED_DP_LAUNCH(2, 0)
    case 3: BANDED_DP_LAUNCH(3, 0)
    case 4: BANDED_DP_LAUNCH(4, 0)
    case 5: BANDED_DP_LAUNCH(5, 0)
    case 6: BANDED_DP_LAUNCH(6, 0)
    case 7: BANDED_DP_LAUNCH(7, 0)
    case 8: BANDED_DP_LAUNCH(8, 0)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BANDED_DP_LAUNCH
}

const char* banded_dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
