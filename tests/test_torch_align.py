"""Banded-DP parity: the port's plain DP (the CUDA kernel's reference)
against the JAX package's lax.scan DP and its scalar numpy reference,
for every mode of tests/test_align.py. The CUDA kernel is held to the
plain DP on the card in tests/test_torch_kernels.py, which imports no
JAX so that it runs on a GPU machine without it.

Scores are small integer sums stored as float32, so every comparison is
exact. Near N bases the 2-bit packed path scores the position fill
(pack_seq4), not a mismatch; the packed comparisons therefore hold the
port to the JAX packed path, and the numpy reference is compared on
sequences without N.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salmon_tpu.mapping import align as ja
from salmon_tpu_torch.mapping import align as ta

torch.set_num_threads(2)

MA, MP, GO, GE = 2.0, -4.0, 6.0, 2.0
BW = 15
SHIFT = 1280


def problems(seed, n_txps=20, NR=40, L=64, P=300, n_frac=0.0, jitter=3):
    """Random transcripts and DP problems near, on and off their ends,
    with ragged reads, flip-style read_starts and read rows shared
    between problems; aligned problems sit within `jitter` bases of
    their read's origin."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(100, 400, n_txps)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    seq = rng.integers(0, 4, off[-1]).astype(np.uint8)
    if n_frac:
        seq[rng.random(seq.shape[0]) < n_frac] = 4
    reads = rng.integers(0, 4, (NR, L)).astype(np.uint8)
    reads[rng.random((NR, L)) < 0.02] = 4
    t = rng.integers(0, n_txps, P)
    ids = rng.integers(0, NR, P).astype(np.int32)
    rl = rng.integers(20, L + 1, P).astype(np.int32)
    rs = np.where(rng.random(P) < 0.5, L - rl, 0).astype(np.int32)
    rb = rng.integers(-40, 400, P).astype(np.int32)
    # half of the problems align their read to the reference
    for p in np.nonzero(rng.random(P) < 0.5)[0]:
        b = int(rng.integers(0, max(lens[t[p]] - rl[p], 1)))
        src = seq[off[t[p]] + b: off[t[p]] + b + rl[p]]
        reads[ids[p], rs[p]:rs[p] + src.shape[0]] = src
        rb[p] = b - rs[p] + int(rng.integers(-jitter, jitter + 1))
    return dict(seq=seq, reads=reads, ids=ids, rl=rl, rs=rs, rb=rb,
                tl=lens[t].astype(np.int32), so=off[t])


MODES = [dict(), dict(softclip=True), dict(softclip_overhangs=True),
         dict(softclip=True, softclip_overhangs=True)]
MODE_IDS = ["plain", "softclip", "overhangs", "softclip+overhangs"]


@pytest.mark.parametrize("kw", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("off_dtype", [np.int32, np.int64])
def test_plain_dp_matches_jax_scan(kw, off_dtype):
    d = problems(0, n_frac=0.01)
    words, _ = ja.pack_seq4(d["seq"], lead_pad=SHIFT)
    so = d["so"].astype(off_dtype)
    common_j = (jnp.asarray(d["reads"]), jnp.asarray(d["ids"]),
                jnp.asarray(d["rl"]), jnp.asarray(d["rb"]),
                jnp.asarray(d["tl"]), jnp.asarray(d["seq"]), jnp.asarray(so),
                BW, MA, MP, GO, GE)
    common_t = (torch.from_numpy(d["reads"]), torch.from_numpy(d["ids"]),
                torch.from_numpy(d["rl"]), torch.from_numpy(d["rb"]),
                torch.from_numpy(d["tl"]), torch.from_numpy(d["seq"]),
                torch.from_numpy(so), BW, MA, MP, GO, GE)
    rs_j, rs_t = jnp.asarray(d["rs"]), torch.from_numpy(d["rs"])
    launches = ta.BANDED_DP.launches
    # byte-per-base sequence
    want = np.asarray(ja.banded_scores_indexed(*common_j, read_starts=rs_j,
                                               **kw))
    got = ta.banded_scores_indexed(*common_t, read_starts=rs_t, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    # 2-bit packed words (the main path's form)
    want = np.asarray(ja.banded_scores_indexed(
        *common_j, seq_words=jnp.asarray(words), seq_words_shift=SHIFT,
        read_starts=rs_j, **kw))
    got = ta.banded_scores_indexed(
        *common_t, seq_words=torch.from_numpy(words.view(np.int32)),
        seq_words_shift=SHIFT, read_starts=rs_t, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.1      # many problems really align
    assert ta.BANDED_DP.launches == launches   # CPU tensors never launch


@pytest.mark.parametrize("kw", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("bw", [7, 40, 80])
def test_plain_dp_matches_jax_scan_any_band(bw, kw):
    """Other band half-widths than the main DP's 15: narrower, wider and
    the rescue's 80 (B = 161), on the packed path. The last problems lie
    wholly past their transcript's end, where every diagonal step pays
    the OOB penalty and the best path runs through the NEG-seeded gap
    cells instead."""
    d = problems(bw, P=200, jitter=min(60, 3 * bw // 4))
    d["rb"][-10:] = d["tl"][-10:] + bw + 20     # wholly past the end
    words, _ = ja.pack_seq4(d["seq"], lead_pad=SHIFT)
    want = np.asarray(ja.banded_scores_indexed(
        jnp.asarray(d["reads"]), jnp.asarray(d["ids"]),
        jnp.asarray(d["rl"]), jnp.asarray(d["rb"]), jnp.asarray(d["tl"]),
        jnp.asarray(d["seq"]), jnp.asarray(d["so"]), bw, MA, MP, GO, GE,
        seq_words=jnp.asarray(words), seq_words_shift=SHIFT,
        read_starts=jnp.asarray(d["rs"]), **kw))
    got = ta.banded_scores_indexed(
        torch.from_numpy(d["reads"]), torch.from_numpy(d["ids"]),
        torch.from_numpy(d["rl"]), torch.from_numpy(d["rb"]),
        torch.from_numpy(d["tl"]), None, torch.from_numpy(d["so"]), bw,
        MA, MP, GO, GE, seq_words=torch.from_numpy(words.view(np.int32)),
        seq_words_shift=SHIFT, read_starts=torch.from_numpy(d["rs"]), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.15
    if not (kw.get("softclip") or kw.get("softclip_overhangs")):
        assert (want[-10:] < 0).all()


@pytest.mark.parametrize("kw", MODES, ids=MODE_IDS)
def test_plain_dp_matches_numpy_reference(kw):
    """banded_scores (one read row per problem) against the scalar
    reference on N-free sequences, content left-aligned and
    flip-aligned."""
    rng = np.random.default_rng(3)
    L, P = 48, 24
    ref = rng.integers(0, 4, 600).astype(np.uint8)
    lens = rng.integers(20, L + 1, P).astype(np.int32)
    base = rng.integers(0, 560, P).astype(np.int32)
    left = rng.integers(0, 4, (P, L)).astype(np.uint8)
    for i in range(P):
        n = min(int(lens[i]), 600 - base[i])
        left[i, :n] = ref[base[i]:base[i] + n]
        left[i, rng.integers(0, lens[i], 2)] = rng.integers(0, 4, 2)
    right = np.full((P, L), 4, np.uint8)
    for i in range(P):
        right[i, L - lens[i]:] = left[i, :lens[i]]
    want = [ja.banded_scores_numpy(left[i, :lens[i]], ref[base[i]:], BW,
                                   MA, MP, GO, GE, **kw) for i in range(P)]
    args = (torch.from_numpy(lens), torch.from_numpy(base),
            torch.full((P,), 600, dtype=torch.int32),
            torch.from_numpy(ref), torch.zeros(P, dtype=torch.int32), BW,
            MA, MP, GO, GE)
    got_l = ta.banded_scores(torch.from_numpy(left), *args, **kw)
    np.testing.assert_array_equal(got_l.numpy(), np.float32(want))
    args = (torch.from_numpy(lens), torch.from_numpy(base - (L - lens)),
            *args[2:])
    got_r = ta.banded_scores(torch.from_numpy(right), *args,
                             read_starts=torch.from_numpy(L - lens), **kw)
    np.testing.assert_array_equal(got_r.numpy(), np.float32(want))


def test_known_scores():
    """The hand-checked cases of tests/test_align.py."""
    rng = np.random.default_rng(1)
    ref = rng.integers(0, 4, 50).astype(np.uint8)

    def score(read, ref, base=0, **kw):
        read = np.asarray(read, np.uint8)
        return float(ta.banded_scores(
            torch.from_numpy(read[None, :]),
            torch.tensor([read.shape[0]], dtype=torch.int32),
            torch.tensor([base], dtype=torch.int32),
            torch.tensor([len(ref)], dtype=torch.int32),
            torch.from_numpy(np.asarray(ref, np.uint8)),
            torch.zeros(1, dtype=torch.int32), BW, MA, MP, GO, GE,
            **kw)[0])

    assert score(ref[:20], ref) == 40.0
    deleted = np.concatenate([ref[:20], ref[22:40]])
    assert score(deleted, ref) == 2.0 * 38 - (GO + 2 * GE)
    tail = np.concatenate([ref[40:], rng.integers(0, 4, 10)])
    assert score(tail, ref, base=40) == 2.0 * 10 - (GO + GE * 10)
    assert score(tail, ref, base=40, softclip_overhangs=True) == 20.0


def test_kernel_fixed_bands_are_the_default_bands():
    """csrc/banded_dp.cu compiles the main DP's and the rescue's default
    bands with B fixed (kFixedBands), and chip_smoke.py times the kernel
    at those two: the three must name the same bands, or a default path
    would quietly run the slower runtime-band build."""
    import os
    import re

    import chip_smoke
    from salmon_tpu_torch.constants import DEFAULTS

    src = os.path.join(os.path.dirname(ta.__file__), os.pardir, "csrc",
                       "banded_dp.cu")
    with open(src) as fh:
        fixed = re.search(r"kFixedBands\[\] = \{([^}]*)\}", fh.read())
    want = (DEFAULTS.dp_bandwidth, DEFAULTS.rescue_bandwidth)
    assert tuple(int(b) for b in fixed.group(1).split(",")) == want
    assert (chip_smoke.MAIN_BW, chip_smoke.RESCUE_BW) == want
    assert max(want) <= ta.MAX_KERNEL_BANDWIDTH


def test_kernel_counter_launches_sum_the_bands():
    counter = ta.KernelCounter("dp")
    for band in (15, 80, 15):
        counter.add(band)
    assert counter.by_shape == {15: 2, 80: 1} and counter.launches == 3
    counter.reset()
    assert counter.by_shape == {} and counter.launches == 0


def test_fetch_windows_packed_matches():
    rng = np.random.default_rng(7)
    seq = rng.integers(0, 5, 3000).astype(np.uint8)
    words, shift = ja.pack_seq4(seq, lead_pad=256)
    starts = rng.integers(0, 2900, 64).astype(np.int64) + shift
    want = np.asarray(ja._fetch_windows_packed(jnp.asarray(words),
                                               jnp.asarray(starts), 83))
    got = ta._fetch_windows_packed(torch.from_numpy(words.view(np.int32)),
                                   torch.from_numpy(starts), 83)
    np.testing.assert_array_equal(got.numpy(), want)
