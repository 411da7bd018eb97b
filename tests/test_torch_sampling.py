"""Posterior sampling: the port's inference/sampling.py against the JAX
package's, on equivalence classes made with numpy from a seed.

- split_deep_classes and dense_classes: exact.
- Bootstraps resample class counts on the host with the very numpy
  call of the JAX package, then run one EM/VBEM per replicate that
  stops on its own; from 65,536 label entries on, as the JAX package's
  bootstrap_samples_routed: deep classes split, the resample drawn in
  the routed engine's region order, all replicates stopping together
  after a chunk of 100 iterations. Both sum float32 in another order (and digamma
  differs in the last ulp), so replicates are held at rtol 1e-3 with
  atol 1e-3 reads, as tests/test_torch_em.py holds the EM: ~1e-7 per
  sum, carried through a few hundred contracting iterations. At the
  default tolerance (relative change <= 1e-2) a replicate whose last
  change sits on the threshold may stop one iteration apart in the two
  packages; those cases run at tol 1e-4, where the stopping iteration
  is not on a knife edge.
- Gibbs draws come from a torch.Generator, not jax.random, so they are
  held by distribution: integral, totals conserved, unique classes
  respected, chain means within Monte Carlo error of the JAX package's
  and of the EM estimate.
"""

import numpy as np
import pytest
import test_torch_em
import torch

from salmon_tpu.inference import sampling as jsamp
from salmon_tpu.inference.eqclasses import PackedEqClasses as JPacked
from salmon_tpu_torch.inference import em as tem
from salmon_tpu_torch.inference import sampling as tsamp
from salmon_tpu_torch.inference.eqclasses import PackedEqClasses as TPacked

torch.set_num_threads(2)

RTOL = ATOL = 1e-3


def random_eq(seed: int, n_txps: int, n_classes: int, max_size: int):
    """tests/test_torch_em.py's classes: (JAX classes, port classes,
    effective lengths)."""
    return test_torch_em.random_eq(seed, n_txps, n_classes, max_size)[:3]


def toy_eq():
    """3 transcripts: class {0} c=100, class {1,2} c=200 (equal aux),
    class {0,1} c=50 (tests/test_sampling.py)."""
    fields = dict(labels=np.array([0, 1, 2, 0, 1], dtype=np.int32),
                  weights=np.array([1.0, 0.5, 0.5, 0.5, 0.5]),
                  offsets=np.array([0, 1, 3, 5], dtype=np.int64),
                  counts=np.array([100.0, 200.0, 50.0]),
                  class_sizes=np.array([1, 2, 2], dtype=np.int32))
    return TPacked(**fields)


def make_eq(label_sets, counts, cls=TPacked):
    labels = np.concatenate([np.asarray(s, np.int32) for s in label_sets])
    sizes = np.array([len(s) for s in label_sets], np.int32)
    offsets = np.zeros(len(label_sets) + 1, np.int64)
    offsets[1:] = np.cumsum(sizes)
    weights = np.concatenate([np.full(len(s), 1.0 / len(s))
                              for s in label_sets])
    return cls(labels=labels, weights=weights, offsets=offsets,
               counts=np.asarray(counts, np.float64), class_sizes=sizes)


def test_split_deep_classes_exact():
    for cap in (100, 7):
        sets, counts = [[0, 1], [2], [1, 3, 4]], [250, 5, 1000]
        want = jsamp.split_deep_classes(make_eq(sets, counts, JPacked),
                                        cap=cap)
        got = tsamp.split_deep_classes(make_eq(sets, counts), cap=cap)
        for f in ("labels", "weights", "offsets", "counts", "class_sizes"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(want, f), err_msg=f)
    eq = make_eq([[0, 1], [2]], [10, 5])
    assert tsamp.split_deep_classes(eq) is eq
    for n in (1, 49, 50, 99, 100, 199, 200, 1000):
        assert tsamp._nchains(n) == jsamp._nchains(n)


def test_dense_classes_exact():
    jeq, teq, _ = random_eq(1, 60, 200, 7)
    want, ws = jsamp.dense_classes(jeq, 60)
    got, gs = tsamp.dense_classes(teq, 60, "cpu")
    assert gs == ws
    for k in ("labels", "aux", "mask", "counts"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_multinomial_rows_marginals():
    gen = torch.Generator().manual_seed(0)
    probs = torch.tensor([[0.5, 0.3, 0.2], [0.1, 0.1, 0.8]])
    mask = torch.ones((2, 3), dtype=torch.bool)
    n = torch.tensor([1000.0, 1000.0])
    d = tsamp.multinomial_rows(gen, n, probs[None].expand(200, 2, 3),
                               mask).numpy()
    np.testing.assert_array_equal(d.sum(axis=2), 1000.0)
    assert (d == np.round(d)).all()
    mean = d.mean(axis=0)
    # 200 draws: the standard error of a mean is at most 1.2 % of it
    np.testing.assert_allclose(mean[0], [500, 300, 200], rtol=0.05)
    np.testing.assert_allclose(mean[1], [100, 100, 800], rtol=0.07)


def test_multinomial_rows_masked_slots():
    gen = torch.Generator().manual_seed(1)
    d = tsamp.multinomial_rows(gen, torch.tensor([100.0]),
                               torch.tensor([[0.5, 0.5, 0.5]]),
                               torch.tensor([[True, True, False]]))
    assert d[0, 2] == 0.0 and d.sum() == 100.0
    # a masked slot in the middle, and a zero-probability tail
    d = tsamp.multinomial_rows(gen, torch.tensor([50.0, 7.0]),
                               torch.tensor([[0.2, 9.0, 0.8, 0.0],
                                             [0.0, 1.0, 0.0, 0.0]]),
                               torch.tensor([[True, False, True, True],
                                             [True, True, True, False]]))
    assert d[0, 1] == 0.0 and d[0].sum() == 50.0
    np.testing.assert_array_equal(d[1].numpy(), [0.0, 7.0, 0.0, 0.0])


BOOT = {
    "em": dict(use_vbem=False),
    "vbem": dict(use_vbem=True),
    "em-reproject": dict(use_vbem=False, reproject=True),
    "vbem-reproject": dict(use_vbem=True, reproject=True),
}


@pytest.mark.parametrize("mode", sorted(BOOT))
def test_bootstrap_matches_jax(mode):
    jeq, teq, eff = random_eq(2, 150, 600, 6)
    kw = dict(BOOT[mode], vb_prior=1e-2, per_transcript_prior=True,
              tol=1e-4, seed=17)
    want = jsamp.bootstrap_samples(jeq, 150, eff, 12, **kw)
    got = tsamp.bootstrap_samples(teq, 150, eff, 12, device="cpu", **kw)
    assert got.shape == want.shape == (12, 150)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the replicates differ: the resampling happened
    assert np.std(got[:, int(np.argmax(got.mean(axis=0)))]) > 0


def test_bootstrap_default_tolerance_and_totals():
    """At the default tolerance: replicates assign the resampled total
    and stay close to the JAX package's (a replicate may stop one
    iteration apart, which moves a transcript by at most the 1e-2
    stopping change)."""
    jeq, teq, eff = random_eq(3, 120, 500, 5)
    kw = dict(use_vbem=True, vb_prior=1e-2, per_transcript_prior=True,
              seed=5)
    want = jsamp.bootstrap_samples(jeq, 120, eff, 10, **kw)
    got = tsamp.bootstrap_samples(teq, 120, eff, 10, device="cpu", **kw)
    np.testing.assert_allclose(got.sum(axis=1), jeq.counts.sum(),
                               rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=0.1)


def test_bootstrap_min_iterations_over_max():
    """With max_iter below the 50 minimum iterations, every replicate
    still runs 50 (the JAX package's while_loop condition)."""
    jeq, teq, eff = random_eq(4, 40, 120, 4)
    kw = dict(use_vbem=False, vb_prior=1e-2, per_transcript_prior=True,
              max_iter=10, seed=3)
    np.testing.assert_allclose(
        tsamp.bootstrap_samples(teq, 40, eff, 3, device="cpu", **kw),
        jsamp.bootstrap_samples(jeq, 40, eff, 3, **kw), rtol=RTOL,
        atol=ATOL)


def test_region_order_matches_fastem():
    """The routed engine's class order (fastem.pack_routed's c_order),
    gigantic classes included."""
    from salmon_tpu.inference import fastem
    rng = np.random.default_rng(8)
    sizes = np.concatenate([rng.integers(1, 40, 500),
                            [4096, 4097, 9000, 1, 3]]).astype(np.int32)
    np.testing.assert_array_equal(tsamp._bucket_widths(sizes),
                                  fastem._bucket_widths(sizes))
    jeq = make_eq([list(range(n)) for n in sizes], np.ones(len(sizes)),
                  JPacked)
    want = fastem.pack_routed(jeq, int(sizes.max()),
                              np.full(int(sizes.max()), 100.0)).class_order
    np.testing.assert_array_equal(tsamp.region_order(sizes), want)


@pytest.mark.parametrize("mode", ["em", "vbem-reproject"])
def test_bootstrap_routed_matches_jax(mode, monkeypatch):
    """At >= 65,536 label entries, with the default tolerance, against
    bootstrap_samples_routed: the same draws within rtol 1e-3 / atol 1e-3
    reads, after the same number of iterations (a multiple of 100; the
    JAX package's count is the sum of its chunks' trip counts, read by
    wrapping fastem._em_chunk)."""
    from salmon_tpu.inference import fastem
    jeq, teq, eff = random_eq(3, 3000, 20000, 6)
    assert jeq.labels.shape[0] >= tem.ROUTED_MIN_ENTRIES
    kw = dict(BOOT[mode], vb_prior=1e-2, per_transcript_prior=True, seed=9)
    chunks = []
    em_chunk = fastem._em_chunk

    def counted(static, arrays, alpha, prior, counts, use_vbem, n):
        chunks.append(n)
        return em_chunk(static, arrays, alpha, prior, counts, use_vbem, n)

    monkeypatch.setattr(fastem, "_em_chunk", counted)
    want = jsamp.bootstrap_samples_routed(jeq, 3000, eff, 2, **kw)
    if kw.get("reproject"):
        assert chunks.pop() == 1           # the reprojection's update
    stats = {}
    got = tsamp.bootstrap_samples(teq, 3000, eff, 2, device="cpu",
                                  stats=stats, **kw)
    assert got.shape == want.shape == (2, 3000)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert stats["iterations"] == sum(chunks) and len(chunks) >= 2, \
        (stats, chunks)
    assert stats["iterations"] % tem.EM_CHUNK == 0
    # the replicates differ: the resampling happened
    assert np.std(got[:, int(np.argmax(got.mean(axis=0)))]) > 0


def test_bootstrap_routed_deep_classes():
    """Above the threshold a class deeper than the multinomial cap is
    split before the resample, as in the JAX package."""
    jeq, teq, eff = random_eq(3, 3000, 20000, 6)
    for eq in (jeq, teq):
        eq.counts[:3] = [3e7, 1e7, 2.5e7]
    kw = dict(use_vbem=False, vb_prior=1e-2, per_transcript_prior=True,
              seed=4, max_iter=100)
    want = jsamp.bootstrap_samples_routed(jeq, 3000, eff, 2, **kw)
    got = tsamp.bootstrap_samples(teq, 3000, eff, 2, device="cpu", **kw)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # float32 sums over ~6.6e7 reads
    np.testing.assert_allclose(got.sum(axis=1), teq.counts.sum(), rtol=1e-4)


def test_gibbs_conserves_counts_and_centers():
    eq = toy_eq()
    eff = np.array([100.0, 100.0, 100.0])
    init = np.array([125.0, 150.0, 75.0])
    s = tsamp.gibbs_samples(eq, 3, eff, init, num_samples=40, thinning=4,
                            prior=1e-3, seed=3, device="cpu")
    assert s.shape == (40, 3) and s.dtype == np.float64
    assert (s == np.round(s)).all()
    np.testing.assert_array_equal(s.sum(axis=1), 350.0)
    # txp0 keeps its unique class; txp1 + txp2 keep theirs
    assert (s[:, 0] >= 100).all() and (s[:, 1] + s[:, 2] >= 200).all()


def test_gibbs_no_gamma_draw_low_variance():
    eq = toy_eq()
    eff = np.array([100.0, 100.0, 100.0])
    init = np.array([125.0, 150.0, 75.0])
    s_g = tsamp.gibbs_samples(eq, 3, eff, init, num_samples=60, thinning=4,
                              seed=5, device="cpu")
    s_p = tsamp.gibbs_samples(eq, 3, eff, init, num_samples=60, thinning=4,
                              no_gamma_draw=True, seed=5, device="cpu")
    # a point-mass mu (noGammaDraw) removes the gamma shot noise
    assert s_p[:, 1].std() <= s_g[:, 1].std() * 1.5
    np.testing.assert_array_equal(s_p.sum(axis=1), 350.0)


def test_gibbs_generator_reproducible():
    jeq, teq, eff = random_eq(6, 50, 150, 4)
    init = np.full(50, teq.counts.sum() / 50)
    a, b, c = (tsamp.gibbs_samples(teq, 50, eff, init, 8, thinning=2,
                                   seed=s, device="cpu")
               for s in (11, 11, 12))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_gibbs_matches_jax_in_distribution():
    """Port and JAX chains on one eq set (two chains each at 64
    samples): equal totals, and per-transcript means within Monte Carlo
    error of each other and of the EM estimate."""
    jeq, teq, eff = random_eq(7, 120, 400, 5)
    em = tem.optimize(teq, 120, eff, config=tem.EMConfig(use_vbem=False),
                      device="cpu")["alphas"]
    kw = dict(thinning=4, prior=1e-3)
    gj = jsamp.gibbs_samples(jeq, 120, eff, em, 64, seed=21, **kw)
    gt = tsamp.gibbs_samples(teq, 120, eff, em, 64, seed=21, device="cpu",
                             **kw)
    total = teq.counts.sum()
    np.testing.assert_array_equal(gt.sum(axis=1), total)
    np.testing.assert_allclose(gj.sum(axis=1), total)
    mt, mj = gt.mean(axis=0), gj.mean(axis=0)
    from scipy.stats import spearmanr
    assert spearmanr(mt, mj).statistic > 0.97
    assert spearmanr(mt, em).statistic > 0.97
    big = mj > 5.0
    # four standard errors of a difference of two 64-sample means (draws
    # of a chain are correlated; the 8 % of the mean absorbs that)
    se = gt.std(axis=0) / 8 + gj.std(axis=0) / 8
    assert (np.abs(mt - mj)[big] <= 4 * se[big] + 0.08 * mj[big]).all()


def test_gibbs_deep_class_exact_totals():
    """A class deeper than 2^24 fragments keeps EXACT totals: it is
    chunked below the float32 bound and totals add in int32."""
    n_deep = (1 << 24) + 3
    eq = make_eq([[0, 1], [2]], [n_deep, 5])
    eff = np.array([300.0, 300.0, 300.0])
    init = np.array([n_deep / 2, n_deep / 2, 5.0])
    s = tsamp.gibbs_samples(eq, 3, eff, init, num_samples=3, thinning=2,
                            seed=11, device="cpu")
    np.testing.assert_array_equal(s.sum(axis=1), float(n_deep + 5))
    assert (s[:, 2] == 5).all()
