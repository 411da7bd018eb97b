"""Seeding parity: k-mers, hashes, bucket lookup, occurrence expansion
and chain scoring of the PyTorch port against the JAX package.

Every stage here is integer arithmetic, so every comparison is exact.
u32 values are int64 tensors in the port (salmon_tpu_torch.utils.u32)
and uint32 arrays in JAX; they are compared as int64.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salmon_tpu.index import builder as jb
from salmon_tpu.index import hashtable as jht
from salmon_tpu.mapping import kmers as jkm
from salmon_tpu.mapping import lookup as jlk
from salmon_tpu.mapping import pipeline as jpipe
from salmon_tpu.mapping import score as jsc
from salmon_tpu_torch.index import builder as tb
from salmon_tpu_torch.io.fastq import iter_paired_chunks
from salmon_tpu_torch.mapping import kmers as tkm
from salmon_tpu_torch.mapping import lookup as tlk
from salmon_tpu_torch.mapping import pipeline as tpipe
from salmon_tpu_torch.mapping import score as tsc

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_eq(got, want, msg=""):
    g, w = np_(got), np_(want)
    assert g.shape == w.shape, (msg, g.shape, w.shape)
    np.testing.assert_array_equal(g.astype(np.int64) if g.dtype != bool
                                  else g,
                                  w.astype(np.int64) if w.dtype != bool
                                  else w, err_msg=msg)


@pytest.fixture(scope="module")
def sample_batch():
    """The first 512 pairs of tests/data in a 128-column batch, plus
    the same reads with random N bases."""
    chunk = next(iter_paired_chunks([os.path.join(DATA, "reads_1.fastq")],
                                    [os.path.join(DATA, "reads_2.fastq")],
                                    512, 128))
    codes = chunk.left.codes.copy()
    rng = np.random.default_rng(5)
    codes_n = codes.copy()
    codes_n[rng.random(codes.shape) < 0.01] = 4
    return codes, codes_n, chunk.left.lengths


@pytest.mark.parametrize("k", [25, 31])
def test_extract_kmers_exact(sample_batch, k):
    for codes in sample_batch[:2]:
        lens = sample_batch[2]
        want = jkm.extract_kmers(jnp.asarray(codes), jnp.asarray(lens), k)
        got = tkm.extract_kmers(torch.from_numpy(codes),
                                torch.from_numpy(lens), k)
        for name in ("hi", "lo", "is_fw", "valid"):
            assert_eq(got[name], want[name], name)


def test_hashes_exact():
    """The four hashes against the JAX device versions and the numpy
    versions that built the table."""
    rng = np.random.default_rng(17)
    hi = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    hi[:4] = [0, 0xFFFFFFFF, 1, 0x80000000]
    lo[:4] = [0, 0xFFFFFFFF, 0x80000000, 1]
    th = torch.from_numpy(hi.astype(np.int64))
    tl = torch.from_numpy(lo.astype(np.int64))
    jh, jl = jnp.asarray(hi), jnp.asarray(lo)
    for name in ("mix32", "mix32b", "fingerprint16", "fingerprint30"):
        got = getattr(tlk, name)(th, tl)
        assert_eq(got, getattr(jlk, name)(jh, jl), name)
        assert_eq(got, getattr(jht, name)(hi, lo), name + " (numpy)")


@pytest.fixture(scope="module")
def index_pair():
    fasta = os.path.join(DATA, "transcripts.fasta")
    jidx = jb.build_index(fasta, k=31)
    tidx = tb.build_index(fasta, k=31)
    return (jidx, jpipe.device_index_arrays(jidx),
            tpipe.device_index_tensors(tidx, device="cpu"))


def _seeds(codes, lens, jdev, tdev, stride):
    """k-mers and lookups of both packages, stride-sliced."""
    n_slots = int(jdev["tab_rows"].shape[0]) * 4
    jk = jkm.extract_kmers(jnp.asarray(codes), jnp.asarray(lens), 31)
    tk = tkm.extract_kmers(torch.from_numpy(codes), torch.from_numpy(lens),
                           31)
    jk = {k: v[:, ::stride] for k, v in jk.items()}
    tk = {k: v[:, ::stride] for k, v in tk.items()}
    jl = jlk.hash_lookup(jk["hi"], jk["lo"], jdev["tab_rows"], n_slots, 8)
    tl = tlk.hash_lookup(tk["hi"], tk["lo"], tdev["tab_rows"], n_slots, 8)
    return jk, tk, jl, tl


@pytest.mark.parametrize("stride", [1, 6])
def test_hash_lookup_exact(sample_batch, index_pair, stride):
    _, jdev, tdev = index_pair
    codes, _, lens = sample_batch
    _, _, jl, tl = _seeds(codes, lens, jdev, tdev, stride)
    found = np_(jl[2])
    assert found.mean() > 0.5          # the sample reads do hit the index
    for name, g, w in zip(("start", "count", "found", "inl"), tl, jl):
        assert_eq(g, w, name)
    # the inline record is defined only where the slot is inlined
    inl = np_(jl[3])
    for name, g, w in zip(("itxp", "ipf"), tl[4:], jl[4:]):
        np.testing.assert_array_equal(np_(g)[inl], np_(w)[inl], name)


def _check_candidates(jk, tk, jl, tl, occ_j, occ_t, stride, tail_frac,
                      C=8):
    want = jax.jit(jsc.expand_occurrences, static_argnums=(3, 4, 5, 6))(
        jk, jl, occ_j, C, 1000, stride, tail_frac)
    got = tsc.expand_occurrences(tk, tl, occ_t, C, 1000, stride=stride,
                                 tail_frac=tail_frac)
    valid = np_(want[3])
    assert_eq(got[3], want[3], "valid")
    for name, g, w in zip(("key", "rpos", "diag"), got[:3], want[:3]):
        # lanes that are not valid hold unspecified records in both
        np.testing.assert_array_equal(
            np.where(valid, np_(g).astype(np.int64), 0),
            np.where(valid, np_(w).astype(np.int64), 0), err_msg=name)
    assert_eq(got[4], want[4], "n_tail_over")
    n_windows = np_(tl[0]).shape[1]
    wb = max(8, int(np.ceil(np.log2(max(n_windows, 2)))))
    dbb = jsc.diag_bucket_bits_for(1 << 20, wb)
    cw = jax.jit(jsc.score_candidates, static_argnums=(3, 4, 5, 6))(
        *want[:3], 64, stride, wb, dbb)
    ct = tsc.score_candidates(*got[:3], 64, stride=stride, window_bits=wb,
                              diag_bucket_bits=dbb)
    assert_eq(ct["valid"], cw["valid"], "valid")
    assert_eq(ct["score"], cw["score"], "score")
    lens = np.full(np_(tl[0]).shape[0], 100, np.int32)
    ct["start"] = tsc.candidate_read_start(ct, torch.from_numpy(lens), 31)
    cw["start"] = jsc.candidate_read_start(cw, jnp.asarray(lens), 31)
    assert_same_up_to_ties(ct, cw, ("txp", "is_fw", "min_diag", "start"))
    return int(np_(want[4]))


def assert_same_up_to_ties(got: dict, want: dict, fields, T=64):
    """Candidates ranked by score agree as sets within each group of
    equal scores: the JAX package ranks them with an unstable sort, so
    its order inside a tie is arbitrary, while the port keeps the input
    (run) order. Where the top-T cut falls inside a tie group, only the
    group's size is compared. Slots past a read's runs (score 0) hold an
    unspecified payload and are skipped."""
    score = np_(want["score"]).astype(np.int64)
    valid = np_(want["valid"])
    full = valid.sum(1, keepdims=True) == min(T, valid.shape[1])
    low = np.where(valid, score, np.iinfo(np.int64).max).min(
        1, keepdims=True)
    keep = valid & ~(full & (score == low))   # the cut may split a tie
    rows = np.broadcast_to(np.arange(score.shape[0])[:, None], score.shape)

    def canonical(d):
        cols = [np.where(keep, np_(d[f]).astype(np.int64), 0)
                for f in fields]
        # per row: by score, descending, then by the fields
        order = np.lexsort([c.ravel() for c in cols[::-1]]
                           + [-np.where(keep, score, 0).ravel(),
                              rows.ravel()])
        return np.stack([c.ravel()[order] for c in cols], -1)

    np.testing.assert_array_equal(canonical(got), canonical(want))


@pytest.mark.parametrize("stride", [1, 6])
def test_expand_and_score_on_index(sample_batch, index_pair, stride):
    _, jdev, tdev = index_pair
    codes, codes_n, lens = sample_batch
    for c in (codes, codes_n):
        jk, tk, jl, tl = _seeds(c, lens, jdev, tdev, stride)
        _check_candidates(jk, tk, jl, tl, jdev["occ_oct"], tdev["occ_oct"],
                          stride, 64)


def test_expand_tail_budget_overflow():
    """Unaligned CSR starts with long occurrence lists: more windows
    spill past their first oct row than the tail budget holds, so
    tail_over is non-zero, and the windows that keep their tail
    records are the same in both packages."""
    rng = np.random.default_rng(23)
    R, P, C = 32, 80, 16
    n_occ = 50000
    occ = np.zeros((n_occ // 8, 16), np.int32)
    occ[:, 0::2] = rng.integers(0, 40, (n_occ // 8, 8))
    occ[:, 1::2] = rng.integers(0, 2 * 3000, (n_occ // 8, 8))
    start = rng.integers(0, n_occ - 64, (R, P)).astype(np.int32)
    count = rng.integers(1, C + 1, (R, P)).astype(np.int32)
    found = rng.random((R, P)) < 0.9
    start = np.where(found, start, -1).astype(np.int32)
    count = np.where(found, count, 0).astype(np.int32)
    inl = np.zeros((R, P), bool)
    zeros = np.zeros((R, P), np.int32)
    hi = rng.integers(0, 2**32, (R, P), dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, (R, P), dtype=np.uint64).astype(np.uint32)
    fw = rng.random((R, P)) < 0.5
    valid = rng.random((R, P)) < 0.95
    jk = {"hi": jnp.asarray(hi), "lo": jnp.asarray(lo),
          "is_fw": jnp.asarray(fw), "valid": jnp.asarray(valid)}
    tk = {"hi": torch.from_numpy(hi.astype(np.int64)),
          "lo": torch.from_numpy(lo.astype(np.int64)),
          "is_fw": torch.from_numpy(fw), "valid": torch.from_numpy(valid)}
    jl = tuple(jnp.asarray(a) for a in (start, count, found, inl, zeros,
                                        zeros))
    tl = tuple(torch.from_numpy(a) for a in (start, count, found, inl,
                                             zeros, zeros))
    over = _check_candidates(jk, tk, jl, tl, jnp.asarray(occ),
                             torch.from_numpy(occ), 1, 8, C=C)
    assert over > 0


def test_gather_occ_oct_exact():
    """C consecutive records from any start in the oct-packed matrix,
    negative starts clipping to row 0 as in the JAX package."""
    rng = np.random.default_rng(29)
    occ = rng.integers(-1, 5000, (300, 16)).astype(np.int32)
    start = rng.integers(-20, 300 * 8, (16, 40)).astype(np.int32)
    for C in (1, 8, 16):
        want = jsc.gather_occ_oct(jnp.asarray(occ), jnp.asarray(start), C)
        got = tsc.gather_occ_oct(torch.from_numpy(occ),
                                 torch.from_numpy(start), C)
        assert_eq(got, want, f"C={C}")
