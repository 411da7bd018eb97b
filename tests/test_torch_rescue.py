"""Orphan-rescue parity (--recoverOrphans): the port's probes, its
_rescue_orphans and map_paired_batch with the rescue on, against the
JAX package's, on the error-riddled orphans of
tests/test_quant_extras.py::test_orphan_rescue.

The rescue DP runs at the rescue band (80, B = 161). Its scores are
small integer sums in float32, so on the same joined hits rescued
positions, scores and counts must be equal. The probe lengths are
quantiles of a float32 running sum of the FLD, so they are compared on
their own first: a one-ulp difference between the two packages' sums
could move a probe by one.

The rescue probes an orphan's first hit only. Where its orphan hits tie
on score (paralogous transcripts), the JAX package's unstable ranking
(pair.py:162) and the port's stable one may put another transcript
first, and the mate may be rescued on one and not on the other. Through
the whole pipeline, rows are therefore compared where the top hit is
not tied, and the counts within the number of tied rows.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salmon_tpu.index import builder as jb
from salmon_tpu.mapping import pipeline as jpipe
from salmon_tpu.models.fld import FragmentLengthDistribution as JFld
from salmon_tpu.utils import libformat as jlf
from salmon_tpu.utils.dna import decode_seq, revcomp_codes
from salmon_tpu_torch.index import builder as tb
from salmon_tpu_torch.io.fastq import pack_seqs
from salmon_tpu_torch.mapping import pair as tpair
from salmon_tpu_torch.mapping import pipeline as tpipe

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")


def fld_logpmf(n_obs: int, seed: int) -> np.ndarray:
    """The prior FLD (n_obs = 0) or one learned from n_obs lengths."""
    fld = JFld(max_val=1000, prior_mu=250.0, prior_sigma=25.0)
    if n_obs:
        rng = np.random.default_rng(seed)
        lens = np.clip(rng.normal(200 + 40 * seed, 30 + 20 * seed, n_obs),
                       0, 1000).astype(np.int64)
        fld.add_observations(np.bincount(lens, minlength=1001)
                             .astype(np.float64))
    return fld.log_pmf().astype(np.float32)


def jax_probes(logpmf: np.ndarray, Q: int) -> np.ndarray:
    """The probe lengths as salmon_tpu/mapping/pipeline.py:553-565
    computes them."""
    pmf = jnp.exp(jnp.asarray(logpmf))
    if Q == 1:
        mean = jnp.sum(pmf * jnp.arange(logpmf.shape[0], dtype=jnp.float32))
        return np.asarray([jnp.round(mean).astype(jnp.int32)])
    cdf = jnp.cumsum(pmf)
    qs = sorted([(i + 0.5) / Q for i in range(Q)], key=lambda q: abs(q - 0.5))
    return np.asarray([jnp.searchsorted(cdf, q * cdf[-1]).astype(jnp.int32)
                       for q in qs])


@pytest.mark.parametrize("Q", [1, 3, 4])
@pytest.mark.parametrize("n_obs,seed", [(0, 0), (5000, 1), (100000, 2)],
                         ids=["prior", "learned-5k", "learned-100k"])
def test_rescue_probe_lengths_match_jax(n_obs, seed, Q):
    logpmf = fld_logpmf(n_obs, seed)
    got = tpipe.rescue_probe_lengths(torch.from_numpy(logpmf), Q).numpy()
    want = jax_probes(logpmf, Q)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (Q,)
    assert 0 < got.min() <= got.max() < 1000


@pytest.fixture(scope="module")
def orphans():
    """32 fragments whose right mate has a mismatch every 12 bases (no
    k = 31 seed survives) but still aligns above minScoreFraction, in a
    batch of 160 rows (the rescue takes R // 4 = 40 problems)."""
    fasta = os.path.join(DATA, "transcripts.fasta")
    jidx, tidx = jb.build_index(fasta, k=31), tb.build_index(fasta, k=31)
    rng = np.random.default_rng(0)
    R, RL = 160, 76
    s1, s2 = [], []
    for _ in range(32):
        codes = jidx.transcript_codes(int(rng.integers(
            0, jidx.num_valid_targets)))
        start = int(rng.integers(0, codes.shape[0] - 250))
        left = codes[start:start + RL].copy()
        right = revcomp_codes(codes[start + 250 - RL:start + 250]).copy()
        for p in range(5, RL, 12):
            right[p] = (right[p] + 1) % 4
        s1.append(decode_seq(left).encode())
        s2.append(decode_seq(right).encode())
    (c1, l1), (c2, l2) = pack_seqs(s1, R, RL), pack_seqs(s2, R, RL)
    arrays = {"codes_l": c1, "lengths_l": l1, "codes_r": c2,
              "lengths_r": l2}
    fmt = jlf.parse_library_format("IU")
    return dict(
        arrays=arrays, logpmf=fld_logpmf(0, 0),
        cp=jlf.paired_compat_table(fmt), co=jlf.orphan_compat_table(fmt),
        jdev=jpipe.device_index_arrays(jidx),
        jcfg=jpipe.MapperConfig.from_index(jidx, recover_orphans=True),
        tdev=tpipe.device_index_tensors(tidx, device="cpu"),
        tcfg=tpipe.MapperConfig.from_index(tidx, recover_orphans=True))


def port_joined(tbatch: dict, dev: dict, cfg) -> dict:
    """The port's joined hits of a paired batch (stages 1-4)."""
    (cl, sl), (cr, sr) = tpipe._seed_candidates(
        [tbatch["codes_l"], tbatch["codes_r"]],
        [tbatch["lengths_l"], tbatch["lengths_r"]], dev, cfg)
    return tpair.merge_paired_with_orphans(
        tpair.join_pairs(cl, cr, sl, sr, tbatch["lengths_l"],
                         tbatch["lengths_r"], cfg.max_pair_cands,
                         cfg.fld_max, cfg.allow_dovetail),
        tpair.orphan_hits(cl, sl, tpair.MS_LEFT_ORPHAN, cfg.max_pair_cands),
        tpair.orphan_hits(cr, sr, tpair.MS_RIGHT_ORPHAN, cfg.max_pair_cands),
        cfg.discard_orphans)


def test_rescue_orphans_matches_jax(orphans):
    """_rescue_orphans of both packages on the same joined hits (the
    port's) and DP scores: every output equal."""
    o = orphans
    tbatch = {k: torch.from_numpy(v) for k, v in o["arrays"].items()}
    cfg, dev = o["tcfg"], o["tdev"]
    joined = port_joined(tbatch, dev, cfg)
    aln, perfect = tpipe._dp_scores(joined, tbatch, dev, cfg)
    logpmf = torch.from_numpy(o["logpmf"])
    got = tpipe._rescue_orphans(joined, tbatch, dev, cfg, logpmf, aln,
                                perfect)
    want = jpipe._rescue_orphans(
        {k: jnp.asarray(v.numpy()) for k, v in joined.items()},
        {k: jnp.asarray(v) for k, v in o["arrays"].items()}, o["jdev"],
        o["jcfg"], jnp.asarray(o["logpmf"]), jnp.asarray(aln.numpy()),
        jnp.asarray(perfect.numpy()))
    (gj, ga, gp, gn), (wj, wa, wp, wn) = got, want
    assert int(gn) == int(wn) >= 25
    assert set(gj) == set(wj)
    for k in sorted(wj):
        np.testing.assert_array_equal(gj[k].numpy(), np.asarray(wj[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    rescued = (gj["mate_status"].numpy() == tpair.MS_PAIRED) \
        & (joined["mate_status"].numpy() != tpair.MS_PAIRED)
    assert rescued.sum() == int(gn)
    # a rescued fragment spans both mates: 250 bases, give or take the
    # band's shift of the probed mate
    assert (np.abs(gj["frag_len"].numpy()[rescued, 0] - 250) <= 80).all()


def test_map_paired_batch_with_rescue_matches_jax(orphans):
    o = orphans
    cp, co = o["cp"], o["co"]
    want = jpipe.map_paired_batch(
        {k: jnp.asarray(v) for k, v in o["arrays"].items()}, o["jdev"],
        o["jcfg"], jnp.asarray(o["logpmf"]), jnp.asarray(cp),
        jnp.asarray(co))
    tbatch = {k: torch.from_numpy(v) for k, v in o["arrays"].items()}
    got = tpipe.map_paired_batch(
        tbatch, o["tdev"], o["tcfg"], torch.from_numpy(o["logpmf"]),
        torch.from_numpy(cp), torch.from_numpy(co))
    joined = port_joined(tbatch, o["tdev"], o["tcfg"])
    score = joined["score"].numpy()
    tied = (score[:, 0] == score[:, 1]) & joined["valid"][:, 1].numpy()
    assert 0 < tied.sum() < 32
    for key in ("num_orphans_rescued", "num_paired"):
        g, w = int(got[key]), int(want[key])
        assert g >= 25 and w >= 25 and abs(g - w) <= tied.sum(), key
    for key in ("best_is_paired", "frag_ok", "eq_txp", "eq_bins"):
        np.testing.assert_array_equal(got[key].numpy()[~tied],
                                      np.asarray(want[key])[~tied],
                                      err_msg=key)
    np.testing.assert_allclose(got["eq_weight"].numpy()[~tied],
                               np.asarray(want["eq_weight"])[~tied],
                               rtol=1e-5, atol=1e-6)
    # the same batch without the rescue pairs almost nothing
    off = tpipe.map_paired_batch(
        {k: torch.from_numpy(v) for k, v in o["arrays"].items()}, o["tdev"],
        tpipe.MapperConfig.from_index(tb.build_index(
            os.path.join(DATA, "transcripts.fasta"), k=31)),
        torch.from_numpy(o["logpmf"]), torch.from_numpy(cp),
        torch.from_numpy(co))
    assert int(off["num_paired"]) < 5
    assert int(off["num_orphans_rescued"]) == 0
