"""Banded affine-gap alignment scoring (selective alignment).

Counterpart of salmon_tpu/mapping/align.py (reference PuffAligner + ksw2
banded score-only DP, consumed at src/quant/SalmonQuantify.cpp:1523-1525;
ma=2 mp=-4 go=6 ge=2, bandwidth=15). The DP runs in BAND coordinates:
for a candidate whose chain predicts the read starts at reference
position `pos`, the state is H[i, d] for band offset d in [-bw, bw]
(ref pos = pos + i + d), one step per read base:

  diag move   keeps d        -> H_prev[d] + sub(read_i, ref_{i+d})
  gap-in-read (ref advances) -> from d+1 in the previous row (F)
  gap-in-ref  (read advances)-> within-row max-plus prefix over d (E),
                                a Kogge-Stone shift-max cascade

Two implementations of one function:
  * the CUDA kernel csrc/banded_dp.cu (int32 cells, G lanes per
    problem, any band half-width up to MAX_KERNEL_BANDWIDTH), launched
    for CUDA tensors; it fuses the read-row gather and the 2-bit window
    fetch, and takes integer scores only (`integer_scores`);
  * `_banded_scores_plain`, a torch port of the JAX package's lax.scan
    DP, run for CPU tensors and used as the kernel's reference.
Scores are small integer sums in float32, so the two agree exactly.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

NEG = -1e9
OOB_PENALTY = -1000.0  # aligning outside the transcript (overhang)

#: largest band half-width the CUDA kernel takes: B = 2*bw + 1 cells
#: held 8 to a lane across one warp (csrc/banded_dp.cu)
MAX_KERNEL_BANDWIDTH = 127
#: the kernel's scores are int32 and must stay far from its NEG = -1e9
SCORE_LIMIT = 2 ** 20


class KernelCounter:
    """Launch count of one hand-written kernel. The wrapper adds one per
    kernel launch and nowhere else, so a run can show that its path went
    through the kernel; `by_shape` splits the count by a shape key of the
    wrapper's choosing (the band half-width for banded_dp)."""

    def __init__(self, name: str):
        self.name = name
        self.by_shape: dict = {}

    @property
    def launches(self) -> int:
        return sum(self.by_shape.values())

    def reset(self) -> None:
        self.by_shape = {}

    def add(self, shape_key) -> None:
        self.by_shape[shape_key] = self.by_shape.get(shape_key, 0) + 1


BANDED_DP = KernelCounter("banded_dp")


def pack_seq4(seq_codes: np.ndarray, lead_pad: int = 256):
    """Pack base codes 2-bit, 16 per uint32 word, rows of 8 words, with
    `lead_pad` zero bases prepended (so window fetch arithmetic never
    goes negative). Returns ((n_rows, 8) uint32 word matrix,
    offset_shift=lead_pad).

    N bases (code 4) have no 2-bit encoding; they pack as the
    position-derived base (i & 3), exactly as the JAX package packs them
    (a DP band can only brush an N through a nearby candidate; the fill
    mismatches ~3/4 of read bases)."""
    codes = np.asarray(seq_codes, np.uint8)
    fill = (np.arange(codes.shape[0], dtype=np.int64) & 3).astype(
        np.uint8)
    codes = np.where(codes < 4, codes, fill)
    padded = np.concatenate([
        np.zeros(lead_pad, np.uint8), codes, np.zeros(256, np.uint8)])
    n = padded.shape[0]
    n128 = -(-n // 128) * 128
    padded = np.pad(padded, (0, n128 - n))
    duo = padded.reshape(-1, 16).astype(np.uint32)
    words = np.zeros(duo.shape[0], dtype=np.uint32)
    for j in range(16):
        words |= duo[:, j] << np.uint32(2 * j)
    return words.reshape(-1, 8), lead_pad


def _fetch_windows_packed(seq_word_rows: torch.Tensor, a0: torch.Tensor,
                          W: int) -> torch.Tensor:
    """(P,) absolute window starts (int64, >= 0) -> (P, W) int8 base
    codes from the (n_rows, 8) int32 word matrix. Row indices past the
    end clip to the last row, as the JAX package's gathers do."""
    n_words = (W + 15) // 16 + 1
    n_rows = (n_words + 7) // 8 + 1
    P = a0.shape[0]
    dev = a0.device
    w0 = a0 >> 4
    ridx = (w0 >> 3)[:, None] + torch.arange(n_rows, device=dev)
    rows = seq_word_rows[ridx.clamp(max=seq_word_rows.shape[0] - 1)]
    flat_w = rows.reshape(P, n_rows * 8)
    w_al = torch.gather(flat_w, 1, (w0 & 7)[:, None]
                        + torch.arange(n_words, device=dev))
    bas = torch.stack([(w_al >> (2 * j)) & 3 for j in range(16)],
                      dim=-1).reshape(P, n_words * 16)
    out = torch.gather(bas, 1, (a0 & 15)[:, None]
                       + torch.arange(W, device=dev))
    return out.to(torch.int8)


def _subst_scores(read_codes, ref_codes, ma: float, mp: float,
                  oob_score: float):
    """Substitution scores; invalid bases (>=4) mismatch, reference OOB
    (code 5) scores `oob_score`."""
    match = (read_codes == ref_codes) & (read_codes < 4) & (ref_codes < 4)
    s = torch.where(match, ma, mp)
    return torch.where(ref_codes >= 5, oob_score, s)


def _banded_scores_plain(read_codes, read_ids, read_lens, ref_base,
                         txp_lens, seq_codes, seq_off, bandwidth: int,
                         ma: float, mp: float, go: float, ge: float,
                         seq_words=None, seq_words_shift: int = 0,
                         softclip: bool = False,
                         softclip_overhangs: bool = False,
                         read_starts=None) -> torch.Tensor:
    """Plain torch version: the JAX package's lax.scan DP, one Python
    step per read row over a (B, P) state."""
    dev = read_codes.device
    if read_ids is None:
        P, L = read_codes.shape
        reads_p = read_codes
    else:
        P, L = read_ids.shape[0], read_codes.shape[1]
        reads_p = read_codes[read_ids.clamp(0, read_codes.shape[0] - 1)]
    if read_starts is None:
        read_starts = torch.zeros_like(read_lens)
    B = 2 * bandwidth + 1
    W = L + B - 1
    w_idx = ref_base[:, None] + (torch.arange(W, dtype=torch.int32,
                                              device=dev) - bandwidth)
    w_oob = (w_idx < 0) | (w_idx >= txp_lens[:, None])
    if seq_words is not None:
        a0 = seq_off + (ref_base - bandwidth
                        + seq_words_shift).to(seq_off.dtype)
        ref_win = _fetch_windows_packed(
            seq_words, a0.clamp(min=0).to(torch.int64), W)
    else:
        ref_win = seq_codes[(seq_off[:, None] + w_idx).clamp(
            0, seq_codes.shape[0] - 1)].to(torch.int8)
    ref_win = torch.where(w_oob, 5, ref_win)
    oob_score = 0.0 if softclip_overhangs else OOB_PENALTY

    ref_t = ref_win.T.to(torch.int32)      # (W, P)
    reads_t = reads_p.T.to(torch.int32)    # (L, P)
    n_shift = int(np.ceil(np.log2(max(B, 2))))
    neg_rows = torch.full((B, P), NEG, dtype=torch.float32, device=dev)
    H = torch.zeros((B, P), dtype=torch.float32, device=dev)
    F = neg_rows.clone()
    Hmax = neg_rows.clone()
    lo = read_starts[None, :]
    hi = (read_starts + read_lens)[None, :]
    for i in range(L):
        sub = _subst_scores(reads_t[i:i + 1], ref_t[i:i + B], ma, mp,
                            oob_score)
        # gap-in-read: previous row at band offset d+1
        F_n = torch.maximum(
            torch.cat([F[1:], neg_rows[:1]]) - ge,
            torch.cat([H[1:], neg_rows[:1]]) - go - ge)
        H_nf = torch.maximum(H + sub, F_n)
        # gap-in-ref: H[d] = max(H_nf[d], max_{d'<d} H_nf[d'] - go
        # - ge*(d - d'))
        X = H_nf - go
        s = 1
        for _ in range(n_shift):
            X = torch.maximum(X, torch.cat([neg_rows[:s], X[:-s]]) - ge * s)
            s *= 2
        E = torch.cat([neg_rows[:1], X[:-1]]) - ge
        H_new = torch.maximum(H_nf, E)
        if softclip:
            H_new = torch.clamp(H_new, min=0.0)
        # rows outside [read_start, read_start + len) leave the state as
        # it is (flip-based reverse complements park reads at the right)
        active = (i >= lo) & (i < hi)
        H = torch.where(active, H_new, H)
        F = torch.where(active, F_n, F)
        Hmax = torch.maximum(Hmax, torch.where(active, H, NEG))
    return (Hmax if softclip else H).amax(dim=0)


def _check(t: torch.Tensor, name: str, dtypes, ndim: int, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D tensor")


def integer_scores(*scores) -> tuple:
    """The DP scores (ma, mp, go, ge, oob) as Python ints, for the
    kernel's int32 cells. Raises ValueError on a score that is not an
    integer or whose magnitude is SCORE_LIMIT or more."""
    out = []
    for s in scores:
        f = float(s)
        if not (math.isfinite(f) and f == int(f) and abs(f) < SCORE_LIMIT):
            raise ValueError(
                f"the banded-DP kernel takes integer scores of magnitude "
                f"below {SCORE_LIMIT}, not {s!r}")
        out.append(int(f))
    return tuple(out)


def bind_banded_dp(lib: ctypes.CDLL, float_scores: bool = False
                   ) -> ctypes.CDLL:
    """Declare the C interface of a library built from csrc/banded_dp.cu
    (banded_dp_scores and banded_dp_error_string) on `lib`. The kernel
    takes int scores; `float_scores` declares the float ones of builds
    from before the int32 redesign (tools/compare_banded_dp.py)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    sc = ctypes.c_float if float_scores else i32
    lib.banded_dp_scores.argtypes = [
        vp, i64, i32, vp, vp, vp, vp, vp, vp, i32, vp, i64, i32, i32, i32,
        sc, sc, sc, sc, sc, i32, vp, vp]
    lib.banded_dp_scores.restype = i32
    lib.banded_dp_error_string.argtypes = [i32]
    lib.banded_dp_error_string.restype = ctypes.c_char_p
    return lib


def _banded_dp_cuda(reads, read_ids, read_lens, ref_base, txp_lens,
                    seq_off, bandwidth: int, ma: float, mp: float,
                    go: float, ge: float, seq_words, seq_words_shift: int,
                    softclip: bool, softclip_overhangs: bool,
                    read_starts) -> torch.Tensor:
    """Launch csrc/banded_dp.cu on the current stream."""
    ma, mp, go, ge, oob = integer_scores(
        ma, mp, go, ge, 0.0 if softclip_overhangs else OOB_PENALTY)
    if not 0 <= bandwidth <= MAX_KERNEL_BANDWIDTH:
        raise ValueError(
            f"the banded-DP kernel takes band half-widths 0 to "
            f"{MAX_KERNEL_BANDWIDTH}, not {bandwidth}")
    if seq_words is None:
        raise ValueError(
            "the banded-DP kernel reads the 2-bit packed sequence words "
            "(seq_words); byte-per-base sequences run only on the CPU")
    dev = reads.device
    P = read_ids.shape[0]
    if read_starts is None:
        read_starts = torch.zeros(P, dtype=torch.int32, device=dev)
    _check(reads, "reads", (torch.uint8,), 2, dev)
    for name, t in (("read_ids", read_ids), ("read_lens", read_lens),
                    ("ref_base", ref_base), ("txp_lens", txp_lens),
                    ("read_starts", read_starts)):
        _check(t, name, (torch.int32,), 1, dev)
        if t.shape[0] != P:
            raise ValueError(f"{name} has {t.shape[0]} entries, expected "
                             f"{P}")
    _check(seq_off, "seq_off", (torch.int32, torch.int64), 1, dev)
    if seq_off.shape[0] != P:
        raise ValueError(f"seq_off has {seq_off.shape[0]} entries, "
                         f"expected {P}")
    _check(seq_words, "seq_words", (torch.int32,), 2, dev)
    if seq_words.shape[1] != 8:
        raise ValueError("seq_words must be (n_rows, 8) words")

    out = torch.empty(P, dtype=torch.float32, device=dev)
    if P == 0:
        return out
    from salmon_tpu_torch import _cuda
    lib = bind_banded_dp(_cuda.load("banded_dp"))
    fn = lib.banded_dp_scores
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(reads.data_ptr(), reads.shape[0], reads.shape[1],
                read_ids.data_ptr(), read_lens.data_ptr(),
                ref_base.data_ptr(), txp_lens.data_ptr(),
                read_starts.data_ptr(), seq_off.data_ptr(),
                int(seq_off.dtype == torch.int64), seq_words.data_ptr(),
                seq_words.shape[0], seq_words_shift, P, bandwidth,
                ma, mp, go, ge, oob, int(softclip), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("banded_dp kernel launch failed: "
                           + lib.banded_dp_error_string(rc).decode())
    BANDED_DP.add(bandwidth)
    return out


def banded_scores_indexed(reads, read_ids, read_lens, ref_base, txp_lens,
                          seq_codes, seq_off, bandwidth: int, ma: float,
                          mp: float, go: float, ge: float,
                          seq_words=None, seq_words_shift: int = 0,
                          softclip: bool = False,
                          softclip_overhangs: bool = False,
                          read_starts=None) -> torch.Tensor:
    """Score-only banded affine DP; problems share read rows.

    Args:
      reads: (NR, L) uint8 read codes, orientation-resolved (reverse
        complements are flipped, their content at rows
        [read_starts, read_starts + read_lens)).
      read_ids: (P,) int32 row of `reads` per problem.
      read_lens, ref_base, txp_lens, read_starts: (P,) int32 — content
        length, predicted read start on the transcript (may be negative
        or past the end), transcript length, first content row.
      seq_codes: (total_len,) uint8 transcript codes, read only when
        `seq_words` is None (CPU only).
      seq_off: (P,) int32/int64 transcript start in the concatenation.
      seq_words: (n_rows, 8) int32 2-bit words from pack_seq4, whose
        base i sits at i + seq_words_shift.
      bandwidth: band half-width; ma/mp/go/ge: match / mismatch /
        gap-open / gap-extend scores (mp negative, go/ge costs).

    Returns (P,) float32 best alignment scores. CUDA tensors go through
    the CUDA kernel, CPU tensors through the plain version.
    """
    if reads.is_cuda:
        return _banded_dp_cuda(reads, read_ids, read_lens, ref_base,
                               txp_lens, seq_off, bandwidth, ma, mp, go,
                               ge, seq_words, seq_words_shift, softclip,
                               softclip_overhangs, read_starts)
    return _banded_scores_plain(reads, read_ids, read_lens, ref_base,
                                txp_lens, seq_codes, seq_off, bandwidth,
                                ma, mp, go, ge, seq_words, seq_words_shift,
                                softclip, softclip_overhangs, read_starts)


def banded_scores(read_codes, read_lens, ref_base, txp_lens, seq_codes,
                  seq_off, bandwidth: int, ma: float, mp: float,
                  go: float, ge: float, **kw) -> torch.Tensor:
    """banded_scores_indexed with one read row per problem:
    read_codes is (P, L)."""
    ids = torch.arange(read_codes.shape[0], dtype=torch.int32,
                       device=read_codes.device)
    return banded_scores_indexed(read_codes, ids, read_lens, ref_base,
                                 txp_lens, seq_codes, seq_off, bandwidth,
                                 ma, mp, go, ge, **kw)
