"""Mate-join parity: join_pairs, orphan_hits, merge_paired_with_orphans
and observed_paired_code of the PyTorch port against the JAX package,
on the same candidate sets (made by the JAX package from the sample
reads, and made with numpy from a seed).

Integer outputs, so exact where the order is defined. The JAX package
sorts with is_stable=False; the port sorts stably. Two places depend on
that order:
  * hits of equal score ranked for the top T2 are compared as sets
    within each score group;
  * two candidates of one end on the same (transcript, orientation) tie
    on the join key, and whichever sorts next to the mate is joined.
    Rows holding such a tie are left out of the comparison; the test
    checks that the other rows match and that the sample has few such
    rows (test_torch_pipeline holds the whole batch's outputs).
"""

import os

import jax
import numpy as np
import pytest
import torch

from salmon_tpu.index import builder as jb
from salmon_tpu.mapping import pair as jpair
from salmon_tpu.mapping import pipeline as jpipe
from salmon_tpu_torch.io.fastq import iter_paired_chunks
from salmon_tpu_torch.mapping import pair as tpair

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
T2 = 64
FLD_MAX = 1000


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def to_torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.fixture(scope="module")
def sample_cands():
    """Both ends' candidates (and read starts) of 512 sample pairs, as
    the JAX package scores them at the default configuration."""
    idx = jb.build_index(os.path.join(DATA, "transcripts.fasta"), k=31)
    dev = jpipe.device_index_arrays(idx)
    cfg = jpipe.MapperConfig.from_index(idx)
    chunk = next(iter_paired_chunks([os.path.join(DATA, "reads_1.fastq")],
                                    [os.path.join(DATA, "reads_2.fastq")],
                                    512, 128))

    @jax.jit
    def seed(cl, ll, cr, lr):
        return jpipe._seed_candidates([cl, cr], [ll, lr], dev, cfg)

    (cl, sl), (cr, sr) = seed(chunk.left.codes, chunk.left.lengths,
                              chunk.right.codes, chunk.right.lengths)
    cl = {k: v for k, v in cl.items() if k != "tail_over"}
    cr = {k: v for k, v in cr.items() if k != "tail_over"}
    return cl, cr, sl, sr, chunk.left.lengths, chunk.right.lengths


def random_cands(seed: int, unique_keys: bool, R=256, T=8):
    """Candidate sets made with numpy: few transcripts, so many joins.
    With unique_keys, no end holds two candidates of one (transcript,
    orientation)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        if unique_keys:
            # T distinct (transcript, orientation) codes per row
            code = np.argsort(rng.random((R, 24)), axis=1)[:, :T]
            txp, fw = code // 2, code % 2 == 1
        else:
            txp = rng.integers(0, 30, (R, T))
            fw = rng.random((R, T)) < 0.5
        score = rng.integers(1, 12, (R, T))
        valid = rng.random((R, T)) < 0.7
        score = np.where(valid, score, 0)
        cand = {"txp": txp.astype(np.int32), "is_fw": fw,
                "score": score.astype(np.int32), "valid": valid,
                "min_diag": rng.integers(0, 900, (R, T)).astype(np.int32)}
        out.append((cand, rng.integers(-20, 900, (R, T)).astype(np.int32)))
    (cl, sl), (cr, sr) = out
    ll = rng.integers(60, 101, R).astype(np.int32)
    lr = rng.integers(60, 101, R).astype(np.int32)
    return cl, cr, sl, sr, ll, lr


def tied_join_rows(cl, cr):
    """Rows where one end holds two valid candidates on the same
    (transcript, orientation): the join key ties there."""
    tied = np.zeros(np_(cl["txp"]).shape[0], bool)
    for c in (cl, cr):
        key = np.where(np_(c["valid"]),
                       np_(c["txp"]).astype(np.int64) * 2
                       + np_(c["is_fw"]), -1 - np.arange(
                           np_(c["txp"]).shape[1]))
        s = np.sort(key, axis=1)
        tied |= ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any(axis=1)
    return tied


def assert_rows_match(got: dict, want: dict, rows, fields):
    """Per row, the same valid hits: scores in the same order, and the
    hits of one score as the same set (the JAX order inside a tie is
    arbitrary)."""
    for r in np.nonzero(rows)[0]:
        v = np_(want["valid"])[r]
        np.testing.assert_array_equal(np_(got["valid"])[r], v)
        np.testing.assert_array_equal(np_(got["score"])[r][v],
                                      np_(want["score"])[r][v])

        def hits(d):
            return sorted(zip(*(np_(d[f])[r][v].astype(np.int64).tolist()
                                for f in ("score",) + fields)))
        assert hits(got) == hits(want), r


def _run_join(inputs):
    cl, cr, sl, sr, ll, lr = inputs
    want = jax.jit(jpair.join_pairs, static_argnums=(6, 7, 8))(
        cl, cr, sl, sr, ll, lr, T2, FLD_MAX, False)
    got = tpair.join_pairs(to_torch(cl), to_torch(cr),
                           torch.from_numpy(np.array(sl)),
                           torch.from_numpy(np.array(sr)),
                           torch.from_numpy(np.array(ll)),
                           torch.from_numpy(np.array(lr)), T2, FLD_MAX,
                           False)
    return want, got


def _check_join(inputs, max_tied_frac):
    cl, cr = inputs[:2]
    want, got = _run_join(inputs)
    tied = tied_join_rows(cl, cr)
    assert tied.mean() <= max_tied_frac, tied.mean()
    for name in ("has_pair", "has_dovetail_only"):
        np.testing.assert_array_equal(np_(got[name])[~tied],
                                      np_(want[name])[~tied], name)
    assert_rows_match(got, want, ~tied,
                      ("txp", "frag_len", "pos", "obs_code", "fw"))
    return want, got


def test_join_pairs_sample(sample_cands):
    _check_join(sample_cands, 0.05)


def test_join_pairs_random_unique_keys():
    _, got = _check_join(random_cands(3, unique_keys=True), 0.0)
    assert np_(got["has_pair"]).mean() > 0.3


def test_join_pairs_random_tied_keys():
    """Many tied join keys: the rows without a tie still match
    exactly."""
    inputs = random_cands(4, unique_keys=False)
    assert tied_join_rows(*inputs[:2]).mean() < 1.0
    _check_join(inputs, 1.0)


@pytest.mark.parametrize("discard", [False, True])
def test_orphans_and_merge(sample_cands, discard):
    cl, cr, sl, sr = sample_cands[:4]
    want_p, got_p = _run_join(sample_cands)
    tied = tied_join_rows(cl, cr)
    jorph = jax.jit(jpair.orphan_hits, static_argnums=(2, 3))
    ol_w, or_w = jorph(cl, sl, 1, T2), jorph(cr, sr, 2, T2)
    ol_g = tpair.orphan_hits(to_torch(cl), torch.from_numpy(np.array(sl)),
                             1, T2)
    or_g = tpair.orphan_hits(to_torch(cr), torch.from_numpy(np.array(sr)),
                             2, T2)
    for g, w in ((ol_g, ol_w), (or_g, or_w)):
        assert g["mate_status"] == w["mate_status"]
        assert_rows_match(g, w, np.ones(g["txp"].shape[0], bool),
                          ("txp", "pos", "fw", "frag_len", "obs_code"))
    want = jpair.merge_paired_with_orphans(want_p, ol_w, or_w, discard)
    got = tpair.merge_paired_with_orphans(got_p, ol_g, or_g, discard)
    np.testing.assert_array_equal(np_(got["mate_status"])[~tied],
                                  np_(want["mate_status"])[~tied])
    assert_rows_match(got, want, ~tied,
                      ("txp", "frag_len", "pos", "obs_code", "fw"))


def test_observed_paired_code_exact():
    rng = np.random.default_rng(9)
    s1, s2 = rng.integers(0, 50, (2, 4000)).astype(np.int32)
    fw1, fw2 = rng.random((2, 4000)) < 0.5
    want = jpair.observed_paired_code(s1, fw1, s2, fw2)
    got = tpair.observed_paired_code(*(torch.from_numpy(a)
                                       for a in (s1, fw1, s2, fw2)))
    np.testing.assert_array_equal(np_(got), np_(want))
