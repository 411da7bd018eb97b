"""The compiled post-mapping loops on the card: each loop's CUDA graphs
against its eager body (`*_impl` without a cache) on the same inputs.
Every test here needs an NVIDIA GPU and skips without one; the file
imports nothing of JAX, so it runs on a GPU machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_graph_post_cuda.py

float32 index_add_ on the card adds in no fixed order, so two eager runs
differ in the last bits and the EM may stop one iteration apart where
its largest change sits on the tolerance: a graph is held to its eager
run with the eager run's own spread as the yardstick (rtol 1e-5, or
twice what two eager runs differ by where that is more), and to the
same iteration count unless two eager runs differ in it too. Integral
work (the observed-bias histograms of weight 1.0, the Gibbs draws' sums)
is exact.
"""

import os

import numpy as np
import pytest
import torch

from salmon_tpu_torch.constants import SalmonDefaults
from salmon_tpu_torch.index.builder import build_index
from salmon_tpu_torch.inference import em as tem
from salmon_tpu_torch.inference import sampling as tsamp
from salmon_tpu_torch.inference.eqclasses import PackedEqClasses
from salmon_tpu_torch.models import bias as TB
from salmon_tpu_torch.models import bias_correct as TBC
from salmon_tpu_torch.models import bias_expected as TBE
from salmon_tpu_torch.models.efflen import effective_lengths

DATA = os.path.join(os.path.dirname(__file__), "data")
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode "
                    "(python3 chip_smoke.py also runs the loops on the "
                    "card)")
    return torch.device("cuda")


def random_eq(seed: int, n_txps: int, n_classes: int, max_size: int):
    """Eq classes of up to max_size distinct transcripts drawn with a
    skewed popularity (tests/test_torch_em.py's generator, without JAX);
    returns (eq, effective lengths)."""
    rng = np.random.default_rng(seed)
    pop = rng.pareto(1.2, n_txps) + 1e-3
    draws = np.sort(rng.choice(n_txps, (n_classes, max_size),
                               p=pop / pop.sum()), axis=1)
    first = np.ones(draws.shape, bool)
    first[:, 1:] = draws[:, 1:] != draws[:, :-1]
    keep = first & (np.cumsum(first, axis=1) <= rng.integers(
        1, max_size + 1, (n_classes, 1)))
    sizes = keep.sum(axis=1).astype(np.int32)
    labels = draws[keep].astype(np.int32)
    weights = rng.random(labels.shape[0]) + 0.05
    seg = np.repeat(np.arange(n_classes), sizes)
    weights /= np.bincount(seg, weights=weights)[seg]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    eq = PackedEqClasses(labels=labels, weights=weights, offsets=offsets,
                         counts=rng.integers(1, 50, n_classes).astype(
                             np.float64), class_sizes=sizes)
    return eq, rng.integers(50, 3000, n_txps).astype(np.float64)


def rel_diff(a, b) -> float:
    """max |a - b| / max(|b|, 1): relative on counts of a read or more."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max())


def held_to_eager(graph, eager, eager2) -> None:
    spread = rel_diff(eager2, eager)
    assert rel_diff(graph, eager) <= max(RTOL, 2 * spread), \
        (rel_diff(graph, eager), spread)


def em_args(eq, eff, dev, vbem=True):
    n = eff.shape[0]
    a0 = tem.initial_alphas(n, None, eq.num_fragments)
    pri = tem.prior_alphas(n, eff, 1e-2, True)
    seg = np.repeat(np.arange(eq.num_classes), eq.class_sizes)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    f32, i64 = torch.float32, torch.int64
    return (put(eq.labels, i64), put(seg, i64), put(eq.counts, f32),
            put(eq.weights, f32), put(eq.class_sizes, i64), put(a0, f32),
            put(pri, f32), put(eff, f32), n, vbem)


@pytest.mark.cuda
@pytest.mark.parametrize("chunked", [False, True],
                         ids=["per-iteration", "chunked"])
def test_em_graph_matches_eager(cuda, chunked):
    eq, eff = random_eq(5, 2000, 15000, 6)
    args = em_args(eq, eff, cuda) + (1e-3, 50, 2000)
    stats = {}
    graph = tem.run_em(*args, chunked=chunked, stats=stats)
    eager = tem.run_em_impl(*args, chunked=chunked)
    eager2 = tem.run_em_impl(*args, chunked=chunked)
    assert graph[1] == eager[1] or eager2[1] != eager[1], \
        (graph[1], eager[1], eager2[1])
    if graph[1] == eager[1]:
        held_to_eager(graph[0].cpu(), eager[0].cpu(), eager2[0].cpu())
    assert graph[3] == eager[3]
    assert torch.equal(graph[4], eager[4])
    g = stats["graph"]
    assert (g["eager"], g["captures"], g["replays"]) == \
        (1, 1, stats["chunks"] - 1)
    assert stats["chunks"] >= 3 and g["pool_bytes"] >= 0
    assert 0 <= stats["masked_iterations"] < tem.EM_GRAPH_CHUNK


@pytest.mark.cuda
@pytest.mark.parametrize("routed", [False, True],
                         ids=["per-replicate", "chunked"])
def test_bootstrap_graph_matches_eager(cuda, routed, monkeypatch):
    if routed:
        monkeypatch.setattr(tsamp, "ROUTED_MIN_ENTRIES", 0)
    eq, eff = random_eq(2, 600, 3000, 6)
    kw = dict(use_vbem=True, vb_prior=1e-2, per_transcript_prior=True,
              tol=1e-3, seed=17, device=cuda)
    stats, st_e, st_e2 = {}, {}, {}
    graph = tsamp.bootstrap_samples(eq, 600, eff, 8, stats=stats, **kw)
    eager = tsamp.bootstrap_samples_impl(eq, 600, eff, 8, stats=st_e, **kw)
    eager2 = tsamp.bootstrap_samples_impl(eq, 600, eff, 8, stats=st_e2,
                                          **kw)
    assert stats["iterations"] == st_e["iterations"] or \
        st_e2["iterations"] != st_e["iterations"]
    held_to_eager(graph, eager, eager2)
    np.testing.assert_allclose(graph.sum(axis=1), eq.counts.sum(),
                               rtol=1e-4)
    g = stats["graph"]
    assert (g["eager"], g["captures"], g["replays"]) == \
        (1, 1, stats["chunks"] - 1)


@pytest.mark.cuda
def test_gibbs_graph_draws_are_reproducible_and_conserve(cuda):
    """One seed gives the same draws at every call (the sample graph
    replays with the call's generator registered); draws are integral
    and each sample's total is the classes' total."""
    eq, eff = random_eq(6, 300, 1500, 5)
    init = np.full(300, eq.counts.sum() / 300)
    stats = {}
    a = tsamp.gibbs_samples(eq, 300, eff, init, 16, thinning=4, seed=11,
                            device=cuda, stats=stats)
    b = tsamp.gibbs_samples(eq, 300, eff, init, 16, thinning=4, seed=11,
                            device=cuda)
    c = tsamp.gibbs_samples(eq, 300, eff, init, 16, thinning=4, seed=12,
                            device=cuda)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert (a == np.round(a)).all()
    np.testing.assert_array_equal(a.sum(axis=1), eq.counts.sum())
    # the samples differ from one another: each replay drew anew
    assert len({row.tobytes() for row in a}) == 16
    g = stats["graph"]
    assert (g["eager"], g["captures"], g["replays"]) == (1, 1, 15)
    eager = tsamp.gibbs_samples_impl(eq, 300, eff, init, 16, thinning=4,
                                     seed=11, device=cuda)
    np.testing.assert_array_equal(eager.sum(axis=1), eq.counts.sum())


@pytest.fixture
def sample_index():
    return build_index(os.path.join(DATA, "transcripts.fasta"), k=31)


@pytest.mark.cuda
def test_bias_passes_graph_match_eager(cuda, sample_index):
    """BiasState's two passes on the sample index, the per-length body
    replayed against the eager passes."""
    n = sample_index.num_valid_targets
    rng = np.random.default_rng(8)
    opts = SalmonDefaults()
    opts.seq_bias_correct = opts.gc_bias_correct = True
    opts.pos_bias_correct = True
    pmf = np.exp(-0.5 * ((np.arange(1001) - 250.0) / 25.0) ** 2)
    pmf /= pmf.sum()
    eff = effective_lengths(np.asarray(sample_index.lengths[:n]), pmf)
    alphas = rng.random(n) * 500

    def run():
        s = TBC.BiasState(sample_index, opts, cuda)
        s.obs.obs5 = rng_obs.random((64, 9)) * 300
        s.obs.obs3 = rng_obs.random((64, 9)) * 300
        s.obs.gc_obs = rng_obs.random((3, 101)) * 50
        s.obs.pos5 = rng_obs.random((5, 20)) * 80
        s.obs.pos3 = rng_obs.random((5, 20)) * 80
        s.obs.mass_fwd, s.obs.mass_rc = 1000.0, 900.0
        return s.corrected_effective_lengths(alphas, eff, pmf), s

    rng_obs = np.random.default_rng(9)
    graph, st = run()
    assert st.graphs["expected"]["captures"] >= 1
    assert st.graphs["efflen"]["replays"] > 0
    from salmon_tpu_torch.scripts import bench_graph_post

    with bench_graph_post.eager_bias_passes():
        rng_obs = np.random.default_rng(9)
        eager, st_e = run()
        rng_obs = np.random.default_rng(9)
        eager2, st_e2 = run()
    # the eager passes ran no graph
    assert st_e.graphs["expected"]["signatures"] == 0
    assert st_e.graphs["efflen"]["signatures"] == 0
    held_to_eager(graph, eager, eager2)
    held_to_eager(st.gc_exp, st_e.gc_exp, st_e2.gc_exp)
    assert not np.allclose(graph, eff)


@pytest.mark.cuda
def test_bias_collection_graph_matches_eager(cuda, sample_index):
    """Batches of 4,096 and of other lengths (padded to a power of two):
    every histogram equal to the eager body's (weights of 1.0 sum
    exactly in any order)."""
    bdev = TB.bias_device_tensors(sample_index, cuda)
    n = sample_index.num_valid_targets
    lengths = np.asarray(sample_index.lengths[:n])
    rng = np.random.default_rng(4)
    for rows in (4096, 4096, 4096, 4096, 3000, 2900):
        txp = rng.integers(0, n, rows).astype(np.int32)
        start = (rng.random(rows) * (lengths[txp] - 50)).astype(np.int32) - 3
        end = start + rng.integers(100, 400, rows).astype(np.int32)
        args = [txp, start, end, rng.random(rows) < 0.5,
                np.full(rows, 50, np.int32), np.full(rows, 50, np.int32),
                rng.random(rows) < 0.9, np.ones(rows, np.float32)]
        args = [torch.as_tensor(a, device=cuda) for a in args]
        got = TB.collect_bias_observations(bdev, *args)
        want = TB.collect_bias_observations_impl(bdev, *args)
        for k in want:
            assert torch.equal(got[k], want[k]), (rows, k)
    # one signature: the short batches padded to 4,096 rows replay it
    assert [(s.label, s.eager, s.captures, s.replays)
            for s in TB.collect_graph_stats(bdev)] == \
        [("bias collection R=4096", 1, 1, 5)]


@pytest.mark.cuda
def test_loops_reuse_one_graph_pool(cuda):
    """Every loop captures through its device's loop_graphs: one side
    stream and one pool, so that a call after the first takes the blocks
    that the earlier capture freed and adds nothing to the pool."""
    from salmon_tpu_torch.utils.graphcache import loop_graphs

    eq, eff = random_eq(5, 2000, 15000, 6)
    args = em_args(eq, eff, cuda) + (1e-3, 50, 2000)
    first, again = {}, {}
    tem.run_em(*args, stats=first)
    grown = loop_graphs(cuda).grown
    tem.run_em(*args, stats=again)
    assert first["graph"]["captures"] == again["graph"]["captures"] == 1
    assert again["graph"]["pool_bytes"] == 0
    assert loop_graphs(cuda).grown == grown
    assert loop_graphs(cuda).last is not None


@pytest.mark.cuda
def test_a_failed_capture_raises_naming_the_step(cuda):
    """A chunk that reads the device's state on the host cannot be
    captured: the cache raises, naming the signature, and does not run
    the step eagerly in its place. (Last in the file: the failed capture
    is ended, but nothing after it in this process relies on that.)"""
    from salmon_tpu_torch.utils.graphcache import GraphCache

    x = torch.zeros(4, device=cuda)
    cache = GraphCache()

    def step():
        x.add_(float(x.sum()) + 1.0)

    cache.step("k", step, cuda, label="em test-signature")
    with pytest.raises(RuntimeError, match="em test-signature"):
        cache.step("k", step, cuda, label="em test-signature")
