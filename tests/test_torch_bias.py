"""Bias models: the port's models/bias.py, bias_expected.py and
bias_correct.py against the JAX package's, on inputs made with numpy
from a seed over the sample index.

Integer work is held exactly: the VLMM state indices, the context and
GC gathers (with the out-of-range indices both packages clamp), the
bins, and the observed histograms (weight 1.0, as quant.py passes, so
every bin is an integer in float32). The two passes sum float32 values
in another order than XLA does (and exp/log differ in the last ulp),
so they are held at rtol 1e-5: a float32 sum of n positive terms moves
by ~1e-7 per order change and n is a few thousand here. Row chunking
leaves the effective lengths unchanged bit for bit (rows are
independent) and the expected sums within 1e-4, as does spreading the
histograms over copies of their bins (both add partial sums in another
order; see CHUNK_RTOL).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salmon_tpu.constants import SalmonDefaults as JOpts
from salmon_tpu.models import bias as JB
from salmon_tpu.models import bias_correct as JBC
from salmon_tpu.models import bias_expected as JBE
from salmon_tpu_torch.constants import SalmonDefaults as TOpts
from salmon_tpu_torch.index.builder import build_index
from salmon_tpu_torch.models import bias as TB
from salmon_tpu_torch.models import bias_correct as TBC
from salmon_tpu_torch.models import bias_expected as TBE
from salmon_tpu_torch.models.efflen import effective_lengths

torch.set_num_threads(2)

RTOL = 1e-5
# the whole bucket adds up to ~30,000 float32 terms into one bin in
# sequence; its rounding (~sqrt(n) 2^-24, ~1e-5) is not shared by the
# partial sums of row chunks or of spread bin copies
CHUNK_RTOL = 1e-4
INVALID_TXP = 0x7FFFFFFF


@pytest.fixture(scope="module")
def index(sample_data_dir):
    import os
    return build_index(os.path.join(sample_data_dir, "transcripts.fasta"),
                       k=31)


def fld_pmf(mean=250.0, sd=25.0, n=1001):
    x = np.arange(n)
    pmf = np.exp(-0.5 * ((x - mean) / sd) ** 2)
    return pmf / pmf.sum()


def t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_sb_context_indices_exact():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 5, (500, 9)).astype(np.uint8)
    want = np.asarray(JB.sb_context_indices(jnp.asarray(codes)))
    got = TB.sb_context_indices(t(codes)).numpy()
    np.testing.assert_array_equal(got, want)


def test_host_helpers_equal():
    rng = np.random.default_rng(1)
    counts = rng.random((JB.SB_ROWS, JB.SB_CTX)) * 50
    np.testing.assert_array_equal(TB.sb_normalize(counts),
                                  JB.sb_normalize(counts))
    np.testing.assert_array_equal(TB.sb_marginalize(counts),
                                  JB.sb_marginalize(counts))
    lens = rng.integers(100, 5000, 97)
    np.testing.assert_array_equal(TB.length_class_bounds(lens),
                                  JB.length_class_bounds(lens))
    masses = rng.random(20) * 30
    for uk in (False, True):
        np.testing.assert_array_equal(
            TB.pos_project_weights(masses, 700, uk),
            JB.pos_project_weights(masses, 700, uk))
    obs, exp = rng.random((5, 20)) * 9, rng.random((5, 20)) * 9
    np.testing.assert_array_equal(TBC._pos_factor_grid(obs, exp, True),
                                  JBC._pos_factor_grid(obs, exp, True))
    g_obs, g_exp = rng.random((3, 101)), rng.random((3, 101))
    for n, c in ((25, 3), (25, 1), (101, 3)):
        np.testing.assert_array_equal(
            TBC.expand_gc_ratio(TBC._gc_ratio(
                TBC.fold_gc_counts(g_obs, n, c),
                TBC.fold_gc_counts(g_exp, n, c)), n, c),
            JBC.expand_gc_ratio(JBC._gc_ratio(
                JBC.fold_gc_counts(g_obs, n, c),
                JBC.fold_gc_counts(g_exp, n, c)), n, c))
    assert TBE.fld_quantile_bounds(fld_pmf()) == \
        JBE.fld_quantile_bounds(fld_pmf())


def test_bins_exact():
    """pos_bin_of and length_class_of, including positions on bin
    edges, where a float32 quotient that rounded otherwise would flip
    the bin."""
    rng = np.random.default_rng(2)
    lens = rng.integers(1, 4000, 4000).astype(np.int32)
    pos = (rng.random(4000) * lens).astype(np.int32)
    edge = (np.arange(4000) % 20 * lens / 20).astype(np.int32)
    for p in (pos, edge, np.full(4000, -3, np.int32)):
        np.testing.assert_array_equal(
            TB.pos_bin_of(t(p), t(lens)).numpy(),
            np.asarray(JB.pos_bin_of(jnp.asarray(p), jnp.asarray(lens))))
    bounds = JB.length_class_bounds(lens)
    np.testing.assert_array_equal(
        TB.length_class_of(t(lens, torch.int64), t(bounds)).numpy(),
        np.asarray(JB.length_class_of(jnp.asarray(lens),
                                      jnp.asarray(bounds))))


def best_hits(index, seed: int, n: int = 3000):
    """Best-hit fields of a mapped batch: positions and fragment lengths
    around and past the transcript ends, invalid transcript ids on some
    rows, reads of 30-100 bases."""
    rng = np.random.default_rng(seed)
    nv = index.num_valid_targets
    txp = rng.integers(0, nv, n).astype(np.int32)
    txp[rng.random(n) < 0.05] = INVALID_TXP
    tl = np.asarray(index.lengths)[np.minimum(txp, nv - 1)]
    pos = (rng.random(n) * (tl + 40) - 20).astype(np.int32)
    flen = rng.integers(40, 700, n).astype(np.int32)
    return {"txp": txp, "start": pos, "end": pos + flen - 1,
            "fw": rng.random(n) < 0.5,
            "len1": rng.integers(30, 101, n).astype(np.int32),
            "len2": rng.integers(30, 101, n).astype(np.int32),
            "valid": (rng.random(n) < 0.9) & (txp < nv)}


def test_gather_context_and_gc_desc_exact(index):
    h = best_hits(index, 3)
    jdev = JB.bias_device_arrays(index)
    tdev = TB.bias_device_tensors(index, "cpu")
    for rc in (False, True):
        rcv = np.full(h["txp"].shape, rc)
        jc, jv = JB._gather_context(jdev, jnp.asarray(h["txp"]),
                                    jnp.asarray(h["start"]),
                                    jnp.asarray(rcv))
        tc, tv = TB._gather_context(tdev, t(h["txp"]), t(h["start"]),
                                    t(rcv))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    want = JB._gc_desc(jdev, jnp.asarray(h["txp"]), jnp.asarray(h["start"]),
                       jnp.asarray(h["end"]))
    got = TB._gc_desc(tdev, t(h["txp"]), t(h["start"]), t(h["end"]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [4, 5])
def test_collect_bias_observations_exact(index, seed):
    h = best_hits(index, seed)
    args = [h[k] for k in ("txp", "start", "end", "fw", "len1", "len2",
                           "valid")] + [np.ones(h["txp"].shape, np.float32)]
    want = JB.collect_bias_observations(JB.bias_device_arrays(index),
                                        *[jnp.asarray(a) for a in args])
    got = TB.collect_bias_observations(TB.bias_device_tensors(index, "cpu"),
                                       *[t(a) for a in args])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert float(got["bias_obs5"].sum()) > 0 and float(
        got["bias_gc"].sum()) > 0
    # the host accumulators agree after two batches
    jo, to = JB.BiasObservations(), TB.BiasObservations()
    for _ in range(2):
        jo.add_batch(want)
        to.add_batch(got)
    for f in dataclasses.fields(jo):
        np.testing.assert_array_equal(getattr(to, f.name),
                                      getattr(jo, f.name))


def bucket_inputs(index, seed: int):
    """The sample index's buckets with weights, effective lengths and
    length classes; an FLD cdf; random model tables."""
    rng = np.random.default_rng(seed)
    n = index.num_valid_targets
    lengths = np.asarray(index.lengths[:n])
    jb = JBE.bucket_transcripts(index.transcript_codes, lengths)
    tb = TBE.bucket_transcripts(index.transcript_codes, lengths)
    for (ji, jm), (ti, tm) in zip(jb, tb):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tm, jm)
    lc = np.clip(np.searchsorted(JB.length_class_bounds(lengths), lengths,
                                 side="right"), 0, 4).astype(np.int32)
    weights = rng.random(n).astype(np.float32)
    weights[rng.random(n) < 0.2] = 0.0
    eff = effective_lengths(lengths, fld_pmf()).astype(np.float32)
    logp = [TB.sb_normalize(rng.random((64, 9)) * 40 + 1).astype(np.float32)
            for _ in range(4)]
    tables = logp + [rng.uniform(0.4, 2.5, (3, 101)).astype(np.float32),
                     rng.uniform(0.3, 3.0, (5, TBE.POS_GRID)).astype(
                         np.float32),
                     rng.uniform(0.3, 3.0, (5, TBE.POS_GRID)).astype(
                         np.float32)]
    return jb, lengths, lc, weights, eff, tables


FLAGS = {"seq": (True, False, False), "gc": (False, True, False),
         "pos": (False, False, True), "all": (True, True, True)}


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_expected_pass_matches_jax(index, flags):
    seq_b, gc_b, pos_b = FLAGS[flags]
    jb, lengths, lc, weights, _, _ = bucket_inputs(index, 6)
    pmf = fld_pmf()
    cdf = np.cumsum(pmf).astype(np.float32)
    lo, hi = JBE.fld_quantile_bounds(pmf)
    for idxs, mat in jb:
        args = (mat, lengths[idxs].astype(np.int32), weights[idxs], lc[idxs],
                cdf)
        want = JBE.expected_pass_bucket(*[jnp.asarray(a) for a in args],
                                        lo, hi, 5, seq_b, gc_b, pos_b)
        got = TBE.expected_pass_bucket(*[t(a) for a in args], lo, hi, 5,
                                       seq_b, gc_b, pos_b)
        # rows of three: chunks of the bucket; and the bins spread over
        # 64 copies, as the GPU spreads them (HIST_COPIES)
        chunked = TBE.expected_pass_bucket(*[t(a) for a in args], lo, hi,
                                           5, seq_b, gc_b, pos_b,
                                           max_cells=3 * mat.shape[1])
        spread = TBE.expected_pass_bucket(*[t(a) for a in args], lo, hi,
                                          5, seq_b, gc_b, pos_b,
                                          hist_copies=64)
        assert set(got) == set(want) == set(chunked) == set(spread)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=RTOL, err_msg=k)
            for other in (chunked, spread):
                np.testing.assert_allclose(other[k].numpy(),
                                           got[k].numpy(), rtol=CHUNK_RTOL)


@pytest.mark.parametrize("flags,no_threshold",
                         [(f, False) for f in sorted(FLAGS)]
                         + [("all", True)])
def test_efflen_pass_matches_jax(index, flags, no_threshold):
    seq_b, gc_b, pos_b = FLAGS[flags]
    jb, lengths, lc, weights, eff, tables = bucket_inputs(index, 7)
    pmf = fld_pmf()
    cdf = np.cumsum(pmf).astype(np.float32)
    lo, hi = JBE.fld_quantile_bounds(pmf)
    process = weights > 0
    for idxs, mat in jb:
        args = (mat, lengths[idxs].astype(np.int32), eff[idxs],
                process[idxs], lc[idxs], cdf)
        want = np.asarray(JBE.efflen_pass_bucket(
            *[jnp.asarray(a) for a in args], lo, hi, 5,
            *[jnp.asarray(a) for a in tables], seq_b, gc_b, pos_b,
            no_threshold))
        targs = [t(a) for a in args]
        got = TBE.efflen_pass_bucket(*targs, lo, hi, 5,
                                     *[t(a) for a in tables], seq_b, gc_b,
                                     pos_b, no_threshold).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL)
        chunked = TBE.efflen_pass_bucket(
            *targs, lo, hi, 5, *[t(a) for a in tables], seq_b, gc_b, pos_b,
            no_threshold, max_cells=2 * mat.shape[1]).numpy()
        np.testing.assert_array_equal(chunked, got)
        # the correction moved the processed rows
        assert not np.allclose(got[process[idxs]], eff[idxs][
            process[idxs]]) or not process[idxs].any()


CONFIGS = {
    "seq+gc": dict(seq_bias_correct=True, gc_bias_correct=True),
    "gc-only": dict(gc_bias_correct=True, conditional_gc_bins=1),
    "pos": dict(pos_bias_correct=True),
    "all+corrected+aux": dict(seq_bias_correct=True, gc_bias_correct=True,
                              pos_bias_correct=True,
                              pos_bias_corrected=True),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_corrected_effective_lengths_match_jax(index, config):
    """BiasState on the sample index, fed the same observations and
    alphas: expected statistics, GC models and effective lengths."""
    rng = np.random.default_rng(8)
    n = index.num_valid_targets
    kw = CONFIGS[config]
    jopts, topts = JOpts(), TOpts()
    for o in (jopts, topts):
        for k, v in kw.items():
            setattr(o, k, v)
    js, ts = JBC.BiasState(index, jopts), TBC.BiasState(index, topts, "cpu")
    obs = {"obs5": rng.random((64, 9)) * 300, "obs3": rng.random((64, 9)) * 300,
           "gc_obs": rng.random((3, 101)) * 50,
           "pos5": rng.random((5, 20)) * 80, "pos3": rng.random((5, 20)) * 80}
    for s in (js, ts):
        for k, v in obs.items():
            setattr(s.obs, k, v.copy())
        s.obs.mass_fwd, s.obs.mass_rc = 1000.0, 900.0
    if "aux" in config:
        skip = np.zeros(n, bool)
        skip[[1, 4]] = True
        js.skip_bias = ts.skip_bias = skip
    pmf = fld_pmf()
    eff = effective_lengths(np.asarray(index.lengths[:n]), pmf)
    alphas = rng.random(n) * 500
    alphas[3] = 0.0
    want = js.corrected_effective_lengths(alphas, eff, pmf)
    got = ts.corrected_effective_lengths(alphas, eff, pmf)
    assert got.dtype == np.float64 and got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert not np.allclose(got, eff)
    if "aux" in config:
        np.testing.assert_array_equal(got[[1, 3, 4]], eff[[1, 3, 4]])
    for k in ("exp5_counts", "exp3_counts", "gc_exp", "pos5_exp",
              "pos3_exp", "gc_obs_model", "gc_exp_model"):
        w = getattr(js, k, None)
        if w is not None:
            np.testing.assert_allclose(getattr(ts, k), w, rtol=RTOL,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=k)
    assert set(ts.seconds) == {"expected", "efflen"}


def test_pos_efflen_matches_bruteforce():
    """Pass-2 positional semantics: the bucket pass equals the reference
    formula sum_fl flW(fl) * sum_s posFW(s/L) * posRC(e/L)
    (SalmonUtils.cpp:1700-1760, positional factors only) computed as a
    brute-force numpy double loop over the same grids (the port's copy
    of tests/test_bias.py's test)."""
    rng = np.random.default_rng(3)
    lens = np.array([240, 480, 500, 333], dtype=np.int32)
    Bn, L = lens.shape[0], 512
    codes = np.full((Bn, L), 4, dtype=np.uint8)
    for r, ln in enumerate(lens):
        codes[r, :ln] = rng.integers(0, 4, ln)

    pmf = np.zeros(401)
    pmf[120:221] = np.exp(-0.5 * ((np.arange(120, 221) - 170) / 20.0) ** 2)
    pmf /= pmf.sum()
    cdf_np = np.cumsum(pmf)
    fld_low, fld_high = TBE.fld_quantile_bounds(pmf)
    gc_samp = 3

    g = np.linspace(0.0, 1.0, TBE.POS_GRID)
    grid_fw = np.stack([np.exp(-(0.3 + 0.2 * li) * g)
                        for li in range(TB.POS_LENGTH_CLASSES)])
    grid_rc = np.stack([1.0 + 0.5 * np.sin(2 * np.pi * g + li)
                        for li in range(TB.POS_LENGTH_CLASSES)])
    len_class = np.array([0, 2, 2, 4], dtype=np.int32)
    eff_in = lens.astype(np.float64) - 170.0

    zeros = torch.zeros((TB.SB_ROWS, TB.SB_CTX))
    eff_dev = TBE.efflen_pass_bucket(
        t(codes), t(lens), t(eff_in, torch.float32),
        torch.ones(Bn, dtype=torch.bool), t(len_class),
        t(cdf_np, torch.float32), fld_low, fld_high, gc_samp,
        zeros, zeros, zeros, zeros, torch.ones((3, 101)),
        t(grid_fw, torch.float32), t(grid_rc, torch.float32),
        seq_bias=False, gc_bias=False, pos_bias=True).numpy()

    for r in range(Bn):
        Ln = int(lens[r])
        li = int(len_class[r])
        max_arg = min(cdf_np.shape[0] - 1, Ln)
        max_val = cdf_np[max_arg]

        def ccdf(x):
            if x > max_arg:
                return 1.0
            return cdf_np[max(0, min(x, cdf_np.shape[0] - 1))] / max_val

        frac = (np.arange(Ln) / Ln * TBE.POS_GRID).astype(int)
        frac = np.clip(frac, 0, TBE.POS_GRID - 1)
        pfw = grid_fw[li][frac]
        prc = grid_rc[li][frac]
        eff = 0.0
        fl = fld_low
        while fl <= fld_low + ((fld_high - fld_low) // gc_samp) * gc_samp:
            fl_w = ccdf(fl) - ccdf(fl - gc_samp)
            inner = 0.0
            for s in range(Ln - fl + 1):
                inner += pfw[s] * prc[s + fl - 1]
            eff += fl_w * inner
            fl += gc_samp
        barrier = max(eff, min(eff_in[r], max(1.0, Ln - eff_in[r])))
        assert eff_dev[r] == pytest.approx(barrier, rel=2e-3), (
            f"row {r}: device {eff_dev[r]} vs bruteforce {barrier}")
