"""The banded-DP CUDA kernel's integer data flow, emulated in numpy on the
CPU and held exactly to the plain version (`_banded_scores_plain`).

csrc/banded_dp.cu computes in int32 with NEG = -1,000,000,000 and has no
CPU mode, so this file repeats its arithmetic step for step: G lanes per
problem with C = ceil(B / G) consecutive band cells each, the
gap-in-reference prefix as a lane-local running max whose lane
aggregates are combined by a log2(G)-step max-plus scan, and substitution
scores from 2-bit reference bitmasks slid one base per read row, with
the in-transcript cells of each row one range of the lane's cells. It
runs for the (G, C) of every instance the kernel compiles: the fixed
bands with the lane counts the source names (and the other count
measured for each), every other band with G = 32. The emulation keeps
int64 and checks that no value leaves int32.
"""

import os
import re

import numpy as np
import pytest
import torch

from salmon_tpu_torch.mapping import align as ta
from salmon_tpu_torch.mapping.pipeline import _SEQ4_SHIFT

torch.set_num_threads(2)

MA, MP, GO, GE = 2, -4, 6, 2
K_NEG = -1_000_000_000
EVEN = 0x5555555555555555
MODES = [dict(), dict(softclip=True), dict(softclip_overhangs=True),
         dict(softclip=True, softclip_overhangs=True)]
MODE_IDS = ["plain", "softclip", "overhangs", "softclip+overhangs"]
BANDS = [0, 1, 7, 15, 16, 31, 40, 80, 127]


def kernel_lanes() -> dict:
    """{band: lanes per problem} of the kernel's fixed-band instances,
    from the BANDED_DP_LANES_<band> defaults in csrc/banded_dp.cu."""
    src = os.path.join(os.path.dirname(ta.__file__), os.pardir, "csrc",
                       "banded_dp.cu")
    with open(src) as fh:
        found = re.findall(r"#define BANDED_DP_LANES_(\d+) (\d+)", fh.read())
    return {int(bw): int(g) for bw, g in found}


def kernel_shape(bw: int) -> tuple:
    """(G, C) of the instance the kernel launches for band `bw`: the
    fixed bands' lanes; B <= 31 a thread per problem with C rounded up
    to a multiple of 8 (31 at most); wider bands G = 32."""
    B = 2 * bw + 1
    G = kernel_lanes().get(bw)
    if G is not None:
        return G, -(-B // G)
    if B <= 31:
        return 1, min(-(-B // 8) * 8, 31)
    return 32, -(-B // 32)


def problems(seed, bw, P=160, L=48, n_txps=12, off_dtype=np.int64):
    """DP problems as banded_scores_indexed takes them: ragged reads,
    left- and flip-aligned, N bases in reads and transcripts, short
    transcripts (narrower than the band), problems near and wholly off
    the transcript ends, zero-length problems and out-of-range read
    ids."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, 200, n_txps)
    off = np.concatenate([[0], np.cumsum(lens)])
    seq = rng.integers(0, 4, off[-1]).astype(np.uint8)
    seq[rng.random(seq.shape[0]) < 0.01] = 4
    words, _ = ta.pack_seq4(seq, lead_pad=_SEQ4_SHIFT)
    NR = P // 2
    reads = rng.integers(0, 4, (NR, L)).astype(np.uint8)
    reads[rng.random((NR, L)) < 0.02] = 4
    t = rng.integers(0, n_txps, P)
    ids = rng.integers(0, NR, P).astype(np.int32)
    rl = rng.integers(1, L + 1, P).astype(np.int32)
    rs = np.where(rng.random(P) < 0.5, L - rl, 0).astype(np.int32)
    rb = rng.integers(-L, 220, P).astype(np.int32)
    jitter = min(60, 3 * bw // 4)
    for p in np.nonzero(rng.random(P) < 0.5)[0]:
        b = int(rng.integers(0, max(lens[t[p]] - rl[p], 1)))
        src = seq[off[t[p]] + b: off[t[p]] + b + rl[p]]
        reads[ids[p], rs[p]:rs[p] + src.shape[0]] = src
        rb[p] = b - rs[p] + int(rng.integers(-jitter, jitter + 1))
    rl[:3] = 0                                 # no active row
    rs[3] = L                                  # starts past the row
    rb[4:8] = lens[t[4:8]] + bw + L            # wholly past the end
    rb[8:10] = -(2 * bw + 2 * L)               # wholly before the start
    ids[10:12] = (-3, NR + 5)                  # clip to the first / last
    return dict(reads=reads, ids=ids, rl=rl, rs=rs, rb=rb,
                tl=lens[t].astype(np.int32), so=off[t].astype(off_dtype),
                words=words.view(np.int32))


def emulate(d, bw, G, C, ma, mp, go, ge, softclip, softclip_overhangs):
    """The kernel's arithmetic on the CPU, G lanes of C cells per
    problem: (P,) float32 scores."""
    oob = 0 if softclip_overhangs else -1000
    B = 2 * bw + 1
    assert G * C >= B and C <= 31
    reads = d["reads"]
    NR, L = reads.shape
    P = d["ids"].shape[0]
    g = np.arange(G)
    valid = (g[:, None] * C + np.arange(C)[None, :]) < B       # (G, C)
    rows = reads[np.clip(d["ids"].astype(np.int64), 0, NR - 1)]
    # staging: the window's 2-bit words, as the warp copies them
    flat = d["words"].view(np.uint32).reshape(-1)
    n_rows = d["words"].shape[0]
    a0 = d["so"].astype(np.int64) + (d["rb"].astype(np.int64) - bw
                                     + _SEQ4_SHIFT)
    a0 = np.maximum(a0, 0)
    w0, sh = a0 >> 4, a0 & 15
    NW = -(-(L + G * C) // 16) + 1
    wa = w0[:, None] + np.arange(NW)
    r = np.minimum(wa >> 3, n_rows - 1)
    sw = flat[r * 8 + (wa & 7)].astype(np.int64)              # (P, NW)
    pidx = np.arange(P)

    def code(w):
        """2-bit code at window position w, (P, ...) -> same shape."""
        pos = sh.reshape((P,) + (1,) * (w.ndim - 1)) + w
        word = np.take_along_axis(sw, (pos >> 4).reshape(P, -1),
                                  1).reshape(pos.shape)
        return (word >> (2 * (pos & 15))) & 3

    def ev(n):   # even bits of cells [0, n)
        return ((np.left_shift(np.uint64(1), (2 * n).astype(np.uint64))
                 - np.uint64(1)) & np.uint64(EVEN))

    i0 = np.maximum(d["rs"], 0).astype(np.int64)
    i1 = np.minimum(d["rs"].astype(np.int64) + d["rl"], L)
    ln = np.maximum(i1 - i0, 0)
    # reference bits of each lane's C cells at its first row
    cell = g[:, None] * C + np.arange(C)[None, :]             # (G, C)
    codes = code(np.minimum(i0, L)[:, None, None] + cell[None])  # (P,G,C)
    refbits = np.zeros((P, G), np.uint64)
    for k in range(C):
        refbits |= codes[:, :, k].astype(np.uint64) << np.uint64(2 * k)
    H = np.where(valid[None], 0, K_NEG).astype(np.int64) * np.ones(
        (P, 1, 1), np.int64)
    F = np.full((P, G, C), K_NEG, np.int64)
    hm = np.full((P, G), K_NEG, np.int64)
    rc_all = rows.astype(np.int64)
    base0 = (d["rb"].astype(np.int64) - bw)[:, None] + g[None, :] * C
    tl = d["tl"].astype(np.int64)[:, None]
    for j in range(int(ln.max(initial=0))):
        act = j < ln
        i = i0 + j
        rc = rc_all[pidx, np.minimum(i, L - 1)]
        x = refbits ^ (np.uint64(EVEN) * np.minimum(rc, 3).astype(
            np.uint64))[:, None]
        m = ~(x | (x >> np.uint64(1))) & np.uint64(EVEN)
        m = np.where((rc >= 4)[:, None], np.uint64(0), m)
        base = base0 + i[:, None]
        klo = np.clip(-base, 0, C)
        khi = np.clip(tl - base, 0, C)
        inr = ev(khi) & ~ev(klo)
        mm, oo = m & inr, ~inr & ev(np.full_like(khi, C))
        bit = np.uint64(1) << (2 * np.arange(C, dtype=np.uint64))
        sub = np.where((mm[:, :, None] & bit) != 0, ma,
                       np.where((oo[:, :, None] & bit) != 0, oob, mp))
        # the d+1 shift leaves the lane only at its last cell
        Hd = np.concatenate([H[:, 1:, 0], np.full((P, 1), K_NEG)], 1)
        Fd = np.concatenate([F[:, 1:, 0], np.full((P, 1), K_NEG)], 1)
        Hnf = np.empty_like(H)
        Fn = np.empty_like(F)
        A = np.full((P, G), K_NEG, np.int64)
        for k in range(C):       # pass 1: lane aggregate of Hnf - go
            hn1 = H[:, :, k + 1] if k + 1 < C else Hd
            fn1 = F[:, :, k + 1] if k + 1 < C else Fd
            Fn[:, :, k] = np.maximum(fn1 - ge, hn1 - go - ge)
            Hnf[:, :, k] = np.maximum(H[:, :, k] + sub[:, :, k], Fn[:, :, k])
            A = np.maximum(A - ge, Hnf[:, :, k] - go)
        v, s = A, 1               # max-plus scan over the lanes
        while s < G:
            up = np.concatenate([np.full((P, s), K_NEG), v[:, :-s]], 1)
            v = np.where(g[None] >= s, np.maximum(v, up - ge * C * s), v)
            s *= 2
        Pc = np.concatenate([np.full((P, 1), K_NEG), v[:, :-1]], 1)
        Hn_all = np.empty_like(H)
        for k in range(C):        # pass 2: H from the carry-in
            hn = np.maximum(Pc - ge, Hnf[:, :, k])
            if softclip:
                hn = np.maximum(hn, 0)
            Pc = np.maximum(Pc - ge, Hnf[:, :, k] - go)
            Hn_all[:, :, k] = np.where(valid[None, :, k], hn, K_NEG)
        Fn = np.where(valid[None], Fn, K_NEG)
        a3 = act[:, None, None]
        H = np.where(a3, Hn_all, H)
        F = np.where(a3, Fn, F)
        hm = np.where(act[:, None], np.maximum(hm, Hn_all.max(2)), hm)
        for t in (H, F, Hnf, A, v):
            assert t.min() >= -2 ** 31 and t.max() < 2 ** 31
        # slide: drop cell 0's base, take the one past cell C - 1
        nxt = code(np.minimum(i + 1, L)[:, None] + g[None, :] * C + C - 1)
        slid = (refbits >> np.uint64(2)) | (
            nxt.astype(np.uint64) << np.uint64(2 * (C - 1)))
        refbits = np.where(act[:, None], slid, refbits)
    if softclip:
        score = hm.max(1)
    else:
        score = np.where(valid[None], H, np.iinfo(np.int64).min).max((1, 2))
    return score.astype(np.float32)


def plain(d, bw, **mode):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}
    return ta._banded_scores_plain(
        t["reads"], t["ids"], t["rl"], t["rb"], t["tl"], None, t["so"], bw,
        float(MA), float(MP), float(GO), float(GE), seq_words=t["words"],
        seq_words_shift=_SEQ4_SHIFT, read_starts=t["rs"], **mode).numpy()


@pytest.mark.parametrize("off_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("bw", BANDS)
def test_integer_dp_emulation_matches_plain(bw, mode, off_dtype):
    d = problems(100 + bw, bw, off_dtype=off_dtype)
    want = plain(d, bw, **mode)
    got = emulate(d, bw, *kernel_shape(bw), MA, MP, GO, GE,
                  mode.get("softclip", False),
                  mode.get("softclip_overhangs", False))
    np.testing.assert_array_equal(got, want)
    if mode.get("softclip"):
        assert (want[:4] == -1e9).all()      # no active row
    else:
        assert (want[:4] == 0).all()
    assert (want > 0).mean() > 0.2


@pytest.mark.parametrize("mode", MODES[:2], ids=MODE_IDS[:2])
@pytest.mark.parametrize("bw,lanes,cells", [
    (15, 2, 16), (15, 4, 8), (80, 8, 21), (80, 16, 11), (80, 32, 6),
    (7, 1, 31), (7, 32, 1)])
def test_integer_dp_emulation_other_shapes(bw, lanes, cells, mode):
    """The lane counts measured against the chosen ones, and others: the
    layout is exact at any G and with cells past the band."""
    d = problems(7 + lanes, bw)
    got = emulate(d, bw, lanes, cells, MA, MP, GO, GE,
                  mode.get("softclip", False), False)
    np.testing.assert_array_equal(got, plain(d, bw, **mode))


def test_fixed_band_lanes_cover_the_fixed_bands():
    """Every band compiled fixed names its lane count, and each lane's
    cells fit the kernel's 64-bit reference register."""
    lanes = kernel_lanes()
    assert set(lanes) == {15, 80}
    for bw, G in lanes.items():
        assert 32 % G == 0 and -(-(2 * bw + 1) // G) <= 31


@pytest.mark.parametrize("scores,want", [
    ((2.0, -4.0, 6.0, 2.0, -1000.0), (2, -4, 6, 2, -1000)),
    ((np.float32(3), np.int64(-2), 5, 3, 0.0), (3, -2, 5, 3, 0)),
    ((2 ** 20 - 1, -(2 ** 20 - 1), 0, 0, 0), (2 ** 20 - 1, -(2 ** 20 - 1),
                                             0, 0, 0))])
def test_integer_scores_accepts_integers(scores, want):
    got = ta.integer_scores(*scores)
    assert got == want and all(type(v) is int for v in got)


@pytest.mark.parametrize("scores,match", [
    ((2.5, -4, 6, 2, -1000), "2.5"),
    ((2, -4, 6, float("nan"), 0), "nan"),
    ((2, -4, 6, 2 ** 20, 0), str(2 ** 20)),
    ((2, -(2 ** 20), 6, 2, 0), str(-(2 ** 20))),
    ((2, -4, float("inf"), 2, 0), "inf")])
def test_integer_scores_rejects_what_int32_cells_cannot_hold(scores, match):
    with pytest.raises(ValueError, match=match):
        ta.integer_scores(*scores)
