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
// over band offsets d in [-bw, bw] (B = 2*bw + 1 lanes), for every read
// row in [read_start, read_start + read_len); score = max_d H (softclip:
// max over rows of max_d H).
//
// Design for the H100. One warp per problem: lane d holds band offset d,
// so H, F and the running max live in registers, the d+1 shift is one
// __shfl_down_sync and the prefix is five __shfl_up_sync steps in the
// same association order as the plain version (the float results match
// exactly, NEG saturation included). Each warp first gathers its read
// row (by read_id) and decodes its reference window from the 2-bit words
// into shared memory (code 5 outside the transcript), so no (P, W)
// window tensor ever reaches device memory.
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

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

template <int BW>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
banded_dp_kernel(const uint8_t* __restrict__ reads, int64_t n_reads, int L,
                 const int32_t* __restrict__ read_ids,
                 const int32_t* __restrict__ read_lens,
                 const int32_t* __restrict__ ref_base,
                 const int32_t* __restrict__ txp_lens,
                 const int32_t* __restrict__ read_starts,
                 const void* __restrict__ seq_off, int off64,
                 const uint32_t* __restrict__ words, int64_t n_word_rows,
                 int words_shift, int P, float ma, float mp, float go,
                 float ge, float oob_score, int softclip,
                 float* __restrict__ out) {
  constexpr int B = 2 * BW + 1;
  static_assert(B <= 32, "one warp holds the band");
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
  const bool in_band = lane < B;
  const int rs = read_starts[p];
  const int i0 = rs > 0 ? rs : 0;
  const int i1 = min(rs + read_lens[p], L);
  float H = in_band ? 0.f : kNeg;  // lanes past the band stay NEG
  float F = kNeg;
  float Hm = kNeg;
  for (int i = i0; i < i1; ++i) {
    const int rc = rd[i];
    const int ref = in_band ? win[i + lane] : 5;
    const float sub = ref >= 5 ? oob_score
                               : ((rc == ref && rc < 4 && ref < 4) ? ma : mp);
    const float Fd = __shfl_down_sync(kFull, F, 1);
    const float Hd = __shfl_down_sync(kFull, H, 1);
    const float Fn = fmaxf(Fd - ge, Hd - go - ge);
    const float Hnf = fmaxf(H + sub, Fn);
    float X = Hnf - go;
#pragma unroll
    for (int s = 1; s < B; s <<= 1) {
      float up = __shfl_up_sync(kFull, X, s);
      if (lane < s) up = kNeg;
      X = fmaxf(X, up - ge * static_cast<float>(s));
    }
    float E = __shfl_up_sync(kFull, X, 1);
    if (lane == 0) E = kNeg;
    float Hn = fmaxf(Hnf, E - ge);
    if (softclip) Hn = fmaxf(Hn, 0.f);
    if (in_band) {
      H = Hn;
      F = Fn;
      Hm = fmaxf(Hm, Hn);
    }
  }

  float v = in_band ? (softclip ? Hm : H) : __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) out[p] = v;
}

template <int BW>
cudaError_t launch(const uint8_t* reads, int64_t n_reads, int L,
                   const int32_t* read_ids, const int32_t* read_lens,
                   const int32_t* ref_base, const int32_t* txp_lens,
                   const int32_t* read_starts, const void* seq_off,
                   int off64, const uint32_t* words, int64_t n_word_rows,
                   int words_shift, int P, float ma, float mp, float go,
                   float ge, float oob_score, int softclip, float* out,
                   cudaStream_t stream) {
  constexpr int B = 2 * BW + 1;
  const int W = L + B - 1;
  const size_t smem =
      static_cast<size_t>(kWarpsPerBlock) * (round16(W) + round16(L));
  const int blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
  banded_dp_kernel<BW><<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
      reads, n_reads, L, read_ids, read_lens, ref_base, txp_lens,
      read_starts, seq_off, off64, words, n_word_rows, words_shift, P, ma,
      mp, go, ge, oob_score, softclip, out);
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
  if (L <= 0 || n_reads <= 0 || n_word_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bandwidth) {
    case 15:
      return static_cast<int>(launch<15>(
          static_cast<const uint8_t*>(reads), n_reads, L,
          static_cast<const int32_t*>(read_ids),
          static_cast<const int32_t*>(read_lens),
          static_cast<const int32_t*>(ref_base),
          static_cast<const int32_t*>(txp_lens),
          static_cast<const int32_t*>(read_starts), seq_off, off64,
          static_cast<const uint32_t*>(words), n_word_rows, words_shift, P,
          ma, mp, go, ge, oob_score, softclip, static_cast<float*>(out),
          static_cast<cudaStream_t>(stream)));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* banded_dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
