"""Whole-batch parity: map_paired_batch of the PyTorch port against the
JAX package's on batches of the sample reads, output key by output key.

Integer outputs (eq-class labels, bins, counters, histograms) must be
equal. Float outputs are sums of per-hit weights (exp of small integer
sums plus FLD log-probabilities) taken in the same order in both
packages; they are held to rtol 1e-6, a few float32 ulps, since XLA may
fuse exp/log differently from torch's CPU kernels.

One tie order shows in the outputs. The best hit of a fragment
(best_txp, best_pos, best_flen, best_fw and, through best_flen,
fld_hist) is the first of the joined hits, which are ranked by pair
score with an unstable sort in the JAX package and a stable one in the
port. Where two hits tie on the top score the packages may report
different ones. These keys are compared on the fragments without such
a tie, and fld_hist is held, in each package, to the histogram of its
own best fragment lengths. Eq classes, weights and counters do not
depend on it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salmon_tpu.index import builder as jb
from salmon_tpu.mapping import pipeline as jpipe
from salmon_tpu.models.fld import FragmentLengthDistribution as JFld
from salmon_tpu.utils import libformat as jlf
from salmon_tpu_torch.index import builder as tb
from salmon_tpu_torch.io.fastq import iter_paired_chunks
from salmon_tpu_torch.mapping import pair as tpair
from salmon_tpu_torch.mapping import pipeline as tpipe

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
FLOAT_KEYS = ("eq_weight", "txp_mass")
BEST_KEYS = ("best_txp", "best_pos", "best_flen", "best_fw")


def tied_top_rows(batch: dict, dev: dict, cfg) -> np.ndarray:
    """Fragments whose two best joined hits tie on score (the port's
    join, whose scores equal the JAX package's)."""
    (cl, sl), (cr, sr) = tpipe._seed_candidates(
        [batch["codes_l"], batch["codes_r"]],
        [batch["lengths_l"], batch["lengths_r"]], dev, cfg)
    paired = tpair.join_pairs(cl, cr, sl, sr, batch["lengths_l"],
                              batch["lengths_r"], cfg.max_pair_cands,
                              cfg.fld_max, cfg.allow_dovetail)
    joined = tpair.merge_paired_with_orphans(
        paired, tpair.orphan_hits(cl, sl, tpair.MS_LEFT_ORPHAN,
                                  cfg.max_pair_cands),
        tpair.orphan_hits(cr, sr, tpair.MS_RIGHT_ORPHAN,
                          cfg.max_pair_cands), cfg.discard_orphans)
    score = joined["score"].numpy()
    return (score[:, 0] == score[:, 1]) & joined["valid"][:, 1].numpy()


def own_fld_hist(out: dict, fld_max: int = 1000) -> np.ndarray:
    flen = np.clip(np.asarray(out["best_flen"]), 0, fld_max)
    return np.bincount(flen, weights=np.asarray(out["best_is_paired"]),
                       minlength=fld_max + 1)


@pytest.fixture(scope="module")
def setup():
    fasta = os.path.join(DATA, "transcripts.fasta")
    jidx, tidx = jb.build_index(fasta, k=31), tb.build_index(fasta, k=31)
    chunks = iter_paired_chunks([os.path.join(DATA, "reads_1.fastq")],
                                [os.path.join(DATA, "reads_2.fastq")],
                                1024, 256)
    batches = [next(chunks) for _ in range(2)]
    return (jidx, jpipe.device_index_arrays(jidx),
            jpipe.MapperConfig.from_index(jidx), tidx,
            tpipe.device_index_tensors(tidx, device="cpu"),
            tpipe.MapperConfig.from_index(tidx), batches)


def _fld(mode):
    fld = JFld(max_val=1000, prior_mu=250.0, prior_sigma=25.0)
    rng = np.random.default_rng(mode)
    fld.add_observations(rng.poisson(30, 1001).astype(np.float64))
    return fld.log_pmf().astype(np.float32), \
        fld.log_cmf().astype(np.float32)


# mode None: the FLD is passed as a bare log-pmf (log-CMF derived)
CASES = [("IU", 2, 0), ("IU", 0, 1), ("ISF", 1, 0), ("A", 2, 1),
         ("IU", None, 1)]


@pytest.mark.parametrize("lib,mode,batch_i", CASES,
                         ids=[f"{c[0]}-mode{c[1]}-b{c[2]}" for c in CASES])
def test_map_paired_batch_all_keys(setup, lib, mode, batch_i):
    _, jdev, jcfg, _, tdev, tcfg, batches = setup
    chunk = batches[batch_i]
    logpmf, logcmf = _fld(mode or 1)
    if lib == "A":      # auto-detection runs with every format compatible
        cp, co = np.ones(6, bool), np.ones((2, 2), bool)
    else:
        fmt = jlf.parse_library_format(lib)
        cp, co = jlf.paired_compat_table(fmt), jlf.orphan_compat_table(fmt)
    arrays = {"codes_l": chunk.left.codes, "lengths_l": chunk.left.lengths,
              "codes_r": chunk.right.codes,
              "lengths_r": chunk.right.lengths}
    if mode is None:
        fld_j, fld_t = jnp.asarray(logpmf), torch.from_numpy(logpmf)
    else:
        fld_j = {"logpmf": jnp.asarray(logpmf),
                 "logcmf": jnp.asarray(logcmf), "mode": jnp.int32(mode)}
        fld_t = {"logpmf": torch.from_numpy(logpmf),
                 "logcmf": torch.from_numpy(logcmf), "mode": mode}
    want = jpipe.map_paired_batch(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jdev, jcfg, fld_j,
        jnp.asarray(cp), jnp.asarray(co))
    tbatch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    got = tpipe.map_paired_batch(tbatch, tdev, tcfg, fld_t,
                                 torch.from_numpy(cp), torch.from_numpy(co))
    # the port's marks for its wide pass ride beside the JAX package's keys
    assert set(got) == set(want) | set(tpipe.MARK_KEYS)
    marks = tpipe.mark_stats(got["mark_counts"])
    assert marks["frags_marked"] == int(got["frag_marked"].sum())
    assert int(want["num_mapped"]) > 0.4 * int(want["num_processed"])
    untied = ~tied_top_rows(tbatch, tdev, tcfg)
    assert untied.mean() > 0.5
    for key in sorted(want):
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape, key
        if key in BEST_KEYS:
            np.testing.assert_array_equal(g[untied].astype(w.dtype),
                                          w[untied], err_msg=key)
        elif key == "fld_hist":
            np.testing.assert_array_equal(g, own_fld_hist(got))
            np.testing.assert_array_equal(w, own_fld_hist(want))
        elif key in FLOAT_KEYS:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w,
                                          err_msg=key)
