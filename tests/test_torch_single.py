"""Single-end parity: the port's FASTQ chunker, library-format tables and
map_single_batch against the JAX package's, on the sample reads.

Integer outputs (chunks, tables, eq-class labels, bins, counters,
histograms) must be equal. Float outputs are held to rtol 1e-5: the
weights are exp of small integer sums plus FLD log-probabilities, taken
in the same order in both packages, and XLA may fuse exp/log
differently from torch's CPU kernels.

The best hit of a read is the first of its candidates after the
orphan-hit ranking by score (pair.py:162), an unstable sort in the JAX
package and a stable one in the port. Its strand feeds fmt_hist, so
fmt_hist is held, in each package, to the strands of its own best hits
only where the top score is not tied.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salmon_tpu.index import builder as jb
from salmon_tpu.io import fastq as jfastq
from salmon_tpu.mapping import pipeline as jpipe
from salmon_tpu.models.fld import FragmentLengthDistribution as JFld
from salmon_tpu.utils import libformat as jlf
from salmon_tpu_torch.index import builder as tb
from salmon_tpu_torch.io import fastq as tfastq
from salmon_tpu_torch.mapping import pair as tpair
from salmon_tpu_torch.mapping import pipeline as tpipe
from salmon_tpu_torch.utils import libformat as tlf

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
READS_1 = os.path.join(DATA, "reads_1.fastq")
FLOAT_KEYS = ("eq_weight", "txp_mass")
FORMATS = ["U", "SF", "SR", "IU", "ISF", "ISR", "OU", "OSF", "OSR", "MU",
           "MSF", "MSR"]


@pytest.mark.parametrize("batch_size,max_len", [(1024, 256), (4096, 40)],
                         ids=["whole-reads", "cut-to-40"])
def test_iter_single_chunks_matches_jax(batch_size, max_len):
    want = list(jfastq._iter_single_chunks_py([READS_1, READS_1],
                                              batch_size, max_len))
    got = list(tfastq.iter_single_chunks([READS_1, READS_1], batch_size,
                                         max_len))
    assert len(got) == len(want) == -(-20000 // batch_size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.lengths, w.lengths)


@pytest.mark.parametrize("name", FORMATS)
def test_single_compat_table_matches_jax(name):
    np.testing.assert_array_equal(
        tlf.single_compat_table(tlf.parse_library_format(name)),
        jlf.single_compat_table(jlf.parse_library_format(name)))
    assert tlf.format_names_single() == jlf.format_names_single()


@pytest.fixture(scope="module")
def setup():
    fasta = os.path.join(DATA, "transcripts.fasta")
    jidx, tidx = jb.build_index(fasta, k=31), tb.build_index(fasta, k=31)
    chunks = tfastq.iter_single_chunks([READS_1], 1024, 256)
    batches = [next(chunks) for _ in range(2)]
    return (jpipe.device_index_arrays(jidx), jpipe.MapperConfig.from_index(
        jidx), tpipe.device_index_tensors(tidx, device="cpu"),
        tpipe.MapperConfig.from_index(tidx), batches)


def _fld(mode):
    fld = JFld(max_val=1000, prior_mu=250.0, prior_sigma=25.0)
    rng = np.random.default_rng(mode)
    fld.add_observations(rng.poisson(30, 1001).astype(np.float64))
    return fld.log_pmf().astype(np.float32), \
        fld.log_cmf().astype(np.float32)


def best_strand_untied(batch: dict, dev: dict, cfg):
    """(fw of the best hit, top score not tied) per read, from the
    port's candidates, whose scores equal the JAX package's."""
    [(cand, start)] = tpipe._seed_candidates(
        [batch["codes"]], [batch["lengths"]], dev, cfg)
    hits = tpair.orphan_hits(cand, start, tpair.MS_PAIRED,
                             cfg.max_pair_cands)
    score = hits["score"].numpy()
    tied = (score[:, 0] == score[:, 1]) & hits["valid"][:, 1].numpy()
    return hits["fw"][:, 0].numpy(), ~tied


# mode None: the FLD is passed as a bare log-pmf (log-CMF derived)
CASES = [("A", 2, 0), ("SF", 1, 0), ("U", 0, 1), ("SR", None, 1)]


@pytest.mark.parametrize("lib,mode,batch_i", CASES,
                         ids=[f"{c[0]}-mode{c[1]}-b{c[2]}" for c in CASES])
def test_map_single_batch_all_keys(setup, lib, mode, batch_i):
    jdev, jcfg, tdev, tcfg, batches = setup
    chunk = batches[batch_i]
    logpmf, logcmf = _fld(mode or 1)
    cs = (np.ones(2, bool) if lib == "A"
          else jlf.single_compat_table(jlf.parse_library_format(lib)))
    if mode is None:
        fld_j, fld_t = jnp.asarray(logpmf), torch.from_numpy(logpmf)
    else:
        fld_j = {"logpmf": jnp.asarray(logpmf),
                 "logcmf": jnp.asarray(logcmf), "mode": jnp.int32(mode)}
        fld_t = {"logpmf": torch.from_numpy(logpmf),
                 "logcmf": torch.from_numpy(logcmf), "mode": mode}
    want = jpipe.map_single_batch(
        {"codes": jnp.asarray(chunk.codes),
         "lengths": jnp.asarray(chunk.lengths)}, jdev, jcfg, fld_j,
        jnp.asarray(cs))
    tbatch = {"codes": torch.from_numpy(chunk.codes),
              "lengths": torch.from_numpy(chunk.lengths)}
    got = tpipe.map_single_batch(tbatch, tdev, tcfg, fld_t,
                                 torch.from_numpy(cs))
    assert set(got) == set(want)
    n_mapped = int(want["num_mapped"])
    assert n_mapped > (0.3 if lib in ("SF", "SR") else 0.9) \
        * int(want["num_processed"])
    fw, untied = best_strand_untied(tbatch, tdev, tcfg)
    assert untied.mean() > 0.5
    for key in sorted(want):
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape, key
        if key == "fmt_hist":
            # equal over reads whose best hit is not tied; tied reads
            # may count either strand
            ok = got["frag_ok"].numpy()
            sure = np.bincount(np.where(fw, 0, 1)[ok & untied],
                               minlength=6)
            assert g.sum() == w.sum() == n_mapped
            assert (g >= sure).all() and (w >= sure).all()
            assert np.abs(g - w).sum() <= 2 * (ok & ~untied).sum()
        elif key in FLOAT_KEYS:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w,
                                          err_msg=key)
