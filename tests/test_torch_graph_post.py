"""The compiled post-mapping loops on the CPU: the EM's masked chunks
(inference/em.py::masked_loop), the bootstrap replicates' chunks, the
Gibbs samples and the bias passes' per-length body, each the counterpart
of a program that the JAX package compiles.

The card's graphs cannot run here, so each loop is also driven through a
GraphCache on CpuGraphs, a stand-in with CudaGraphs' interface whose
"capture" records nothing and whose "replay" runs the step again on the
tensors it updates in place, as a graph replay does: through it every
loop equals its eager body bit for bit, with one eager step, one capture
and a replay for every later step. The new formulations are held to the
JAX package as the port's own tests hold the old ones: the masked EM
stops at exactly the iteration of the JAX package's run_em (its
while_loop) in every case of the stopping rule, with alphas at
tests/test_torch_em.py's tolerance; the bias passes, whose fragment
length is now a device tensor (gathers at s + fl - 1 in place of rolls),
meet tests/test_torch_bias.py's tolerance at other FLD ranges and
sampling steps, lengths past a transcript's end included. The card's
graphs against the eager bodies: tests/test_torch_graph_post_cuda.py
(marked cuda) and chip_smoke.py's post phase.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_bias as tbias
import test_torch_em
import torch

from salmon_tpu.inference import em as jem
from salmon_tpu.models import bias_expected as JBE
from salmon_tpu_torch.index.builder import build_index
from salmon_tpu_torch.inference import em as tem
from salmon_tpu_torch.inference import sampling as tsamp
from salmon_tpu_torch.models import bias as TB
from salmon_tpu_torch.models import bias_expected as TBE
from salmon_tpu_torch.utils.graphcache import GraphCache, stats_totals

torch.set_num_threads(2)

K = tem.EM_GRAPH_CHUNK


class CpuGraphs:
    """CudaGraphs' interface on the CPU for loop steps: eager runs the
    step, capture records nothing (a capture does not run the step) and
    its replay runs the step again on the tensors it updates in place."""

    def __init__(self):
        self.captures = 0
        self.generators = []

    def eager(self, fn, inputs, device=None):
        return fn(inputs)

    def capture(self, fn, inputs, device=None, generator=None):
        self.captures += 1
        self.generators.append(generator)

        def replay():
            fn(inputs)
        return replay, {}, 0


def cpu_cache():
    return GraphCache(graphs=CpuGraphs())


@pytest.fixture(scope="module")
def index(sample_data_dir):
    return build_index(os.path.join(sample_data_dir, "transcripts.fasta"),
                       k=31)


def _em_args(teq, eff, mass, vbem, n):
    a0 = tem.initial_alphas(n, mass, teq.num_fragments)
    pri = tem.prior_alphas(n, eff, 1e-2, True)
    seg = np.repeat(np.arange(teq.num_classes), teq.class_sizes)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    f32, i64 = torch.float32, torch.int64
    return (put(teq.labels, i64), put(seg, i64), put(teq.counts, f32),
            put(teq.weights, f32), put(teq.class_sizes, i64),
            put(a0, f32), put(pri, f32), put(eff, f32), n, vbem)


# (vbem, tol, min_iter, max_iter): the stopping rule's cases
EM_CASES = {
    "em": (False, 1e-2, 50, 10_000),
    "vbem": (True, 1e-2, 50, 10_000),
    # convergence inside a chunk, long before min_iter would bind
    "converges-mid-chunk": (True, 1e-2, 3, 10_000),
    # converged at once, held to min_iter, which ends no chunk
    "min-iter-over-chunk": (False, 0.5, 47, 10_000),
    # max_iter ends no chunk, reached unconverged
    "max-iter-unconverged": (True, 1e-12, 10, 57),
    # min_iter over max_iter: the while_loop runs to min_iter
    "min-iter-over-max": (False, 0.5, 33, 12),
}


@pytest.mark.parametrize("case", sorted(EM_CASES))
def test_masked_em_stops_where_jax_does(case):
    """optimize through the masked chunks against the JAX package's
    run_em (its classic engine's while_loop): the same iteration count,
    convergence flag and alphas; the masked iterations are the chunks'
    surplus, fewer than a chunk."""
    vbem, tol, min_iter, max_iter = EM_CASES[case]
    jeq, teq, eff, mass = test_torch_em.random_eq(5, 400, 3000, 6)
    assert jeq.labels.shape[0] < jem.ROUTED_MIN_ENTRIES
    cfg = dict(use_vbem=vbem, rel_diff_tolerance=tol,
               min_iterations=min_iter, max_iterations=max_iter)
    want = jem.optimize(jeq, 400, eff, online_mass=mass,
                        config=jem.EMConfig(**cfg), engine="xla")
    got = tem.optimize(teq, 400, eff, online_mass=mass,
                       config=tem.EMConfig(**cfg), device="cpu")
    assert got["iterations"] == want["iterations"], (got["iterations"],
                                                     want["iterations"])
    assert got["converged"] == want["converged"]
    test_torch_em._compare(want, got, check_iters=False)
    chunks = -(-got["iterations"] // K)
    assert got["masked_iterations"] == chunks * K - got["iterations"]
    assert 0 <= got["masked_iterations"] < K
    if case == "converges-mid-chunk":
        assert got["converged"] and got["iterations"] % K != 0
    if case == "min-iter-over-chunk":
        assert got["iterations"] == min_iter
    if case in ("max-iter-unconverged", "min-iter-over-max"):
        assert got["iterations"] == max(min_iter, max_iter)
    # on the CPU nothing is captured
    assert got["graph"] == stats_totals(())


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["per-iteration", "chunked"])
def test_em_chunks_through_the_cache_equal_the_eager_loop(chunked):
    _, teq, eff, mass = test_torch_em.random_eq(5, 400, 3000, 6)
    args = _em_args(teq, eff, mass, True, 400) + (1e-3, 50, 1000)
    want_stats, got_stats = {}, {}
    want = tem.run_em(*args, chunked=chunked, stats=want_stats)
    cache = cpu_cache()
    got = tem.run_em_impl(*args, chunked=chunked, stats=got_stats,
                          cache=cache)
    assert torch.equal(got[0], want[0])
    assert got[1:4] == want[1:4]
    assert torch.equal(got[4], want[4])
    chunks = want_stats["chunks"]
    assert chunks == -(-want[1] // K) and chunks >= 3
    if chunked:
        assert want[1] % tem.EM_CHUNK == 0 or want[1] == 1000
    (st,) = cache.stats.values()
    assert (st.eager, st.captures, st.replays) == (1, 1, chunks - 1)
    assert f"K={K}" in st.label and ("chunked" if chunked else
                                   "per-iteration") in st.label
    assert got_stats["graph"]["replays"] == chunks - 1
    assert got_stats["masked_iterations"] == chunks * K - want[1]


def test_em_without_iterations():
    """max_iter 0 under the chunked rule runs no chunk, as the routed
    engine runs none."""
    _, teq, eff, mass = test_torch_em.random_eq(5, 400, 3000, 6)
    args = _em_args(teq, eff, mass, False, 400) + (1e-2, 0, 0)
    stats = {}
    alpha, iters, mrd, _, _ = tem.run_em(*args, chunked=True, stats=stats)
    assert (iters, mrd, stats["chunks"]) == (0, float("inf"), 0)
    torch.testing.assert_close(alpha, args[5], rtol=0, atol=0)


@pytest.mark.parametrize("routed", [False, True],
                         ids=["per-replicate", "chunked"])
def test_bootstrap_chunks_through_the_cache_equal_the_eager_loop(
        routed, monkeypatch):
    """Both loops of bootstrap_samples_impl; the routed one (all
    replicates stop together after a chunk of EM_CHUNK) forced at a
    small size."""
    if routed:
        monkeypatch.setattr(tsamp, "ROUTED_MIN_ENTRIES", 0)
    _, teq, eff, _ = test_torch_em.random_eq(2, 150, 600, 6)
    kw = dict(use_vbem=True, vb_prior=1e-2, per_transcript_prior=True,
              tol=1e-3, seed=17)
    want_stats, got_stats = {}, {}
    want = tsamp.bootstrap_samples(teq, 150, eff, 6, device="cpu",
                                   stats=want_stats, **kw)
    cache = cpu_cache()
    got = tsamp.bootstrap_samples_impl(teq, 150, eff, 6, device="cpu",
                                       stats=got_stats, cache=cache, **kw)
    np.testing.assert_array_equal(got, want)
    k = K if routed else tsamp.BOOT_GRAPH_CHUNK
    its = want_stats["iterations"]
    assert got_stats["iterations"] == its >= 50
    assert want_stats["chunks"] == -(-its // k)
    if routed:
        assert its % tem.EM_CHUNK == 0
    (st,) = cache.stats.values()
    assert (st.eager, st.captures, st.replays) == \
        (1, 1, want_stats["chunks"] - 1)


def test_gibbs_samples_through_the_cache_equal_the_eager_rounds():
    _, teq, eff, _ = test_torch_em.random_eq(6, 50, 150, 4)
    init = np.full(50, teq.counts.sum() / 50)
    kw = dict(thinning=3, seed=11, device="cpu")
    stats = {}
    want = tsamp.gibbs_samples(teq, 50, eff, init, 8, **kw)
    graphs = CpuGraphs()
    cache = GraphCache(graphs=graphs)
    got = tsamp.gibbs_samples_impl(teq, 50, eff, init, 8, stats=stats,
                                   cache=cache, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.sum(axis=1), teq.counts.sum())
    # one chain of 8 samples: one eager, one captured with the chain's
    # generator, replayed for the rest
    (st,) = cache.stats.values()
    assert (st.eager, st.captures, st.replays) == (1, 1, 7)
    assert isinstance(graphs.generators[0], torch.Generator)
    assert stats["rounds"] == 8 * 3


# FLDs past the sample index's default (tests/test_torch_bias.py's mean
# 250, sd 25, gc_samp 5): short fragments at a step of 3, and long ones at
# a step of 7 whose longest reach past the shortest transcripts (849 to
# 2,396 bases) and the ends of every other
FLD_CASES = {"short-step-3": (120.0, 30.0, 3),
             "long-step-7": (700.0, 150.0, 7)}


def _bucket_args(index, case, seed):
    mean, sd, step = FLD_CASES[case]
    jb, lengths, lc, weights, eff, tables = tbias.bucket_inputs(index, seed)
    pmf = tbias.fld_pmf(mean, sd)
    lo, hi = JBE.fld_quantile_bounds(pmf)
    cdf = np.cumsum(pmf).astype(np.float32)
    return jb, lengths, lc, weights, eff, tables, cdf, lo, hi, step


@pytest.mark.parametrize("case", sorted(FLD_CASES))
def test_expected_pass_with_a_device_length_matches_jax(index, case):
    jb, lengths, lc, weights, _, _, cdf, lo, hi, step = _bucket_args(
        index, case, 6)
    if case == "long-step-7":
        assert hi > lengths.min()
    gc_total = 0.0
    for idxs, mat in jb:
        args = (mat, lengths[idxs].astype(np.int32), weights[idxs], lc[idxs],
                cdf)
        want = JBE.expected_pass_bucket(*[jnp.asarray(a) for a in args],
                                        lo, hi, step, True, True, True)
        targs = [tbias.t(a) for a in args]
        got = TBE.expected_pass_bucket(*targs, lo, hi, step, True, True,
                                       True)
        cache = cpu_cache()
        graphed = TBE.expected_pass_bucket_impl(
            *targs, lo, hi, step, True, True, True, max_cells=2 * mat.shape[1],
            cache=cache)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=tbias.RTOL, err_msg=k)
            np.testing.assert_allclose(graphed[k].numpy(), got[k].numpy(),
                                       rtol=tbias.CHUNK_RTOL, err_msg=k)
        gc_total += float(got["gc_exp"].sum())
        n_len = len(TBE._fl_grid(lo, hi, step))
        chunks = -(-mat.shape[0] // 2)
        assert stats_totals(cache.stats.values())["replays"] == \
            chunks * (n_len - 1)
        # each chunk's graph is dropped after its last length
        assert not cache._entries
    assert gc_total > 0


@pytest.mark.parametrize("case", sorted(FLD_CASES))
def test_efflen_pass_with_a_device_length_matches_jax(index, case):
    jb, lengths, lc, weights, eff, tables, cdf, lo, hi, step = \
        _bucket_args(index, case, 7)
    process = weights > 0
    for idxs, mat in jb:
        args = (mat, lengths[idxs].astype(np.int32), eff[idxs],
                process[idxs], lc[idxs], cdf)
        want = np.asarray(JBE.efflen_pass_bucket(
            *[jnp.asarray(a) for a in args], lo, hi, step,
            *[jnp.asarray(a) for a in tables], True, True, True, False))
        targs = [tbias.t(a) for a in args] + [lo, hi, step] + [
            tbias.t(a) for a in tables] + [True, True, True, False]
        got = TBE.efflen_pass_bucket(*targs).numpy()
        np.testing.assert_allclose(got, want, rtol=tbias.RTOL)
        cache = cpu_cache()
        graphed = TBE.efflen_pass_bucket_impl(*targs, cache=cache).numpy()
        np.testing.assert_array_equal(graphed, got)
        (st,) = cache.stats.values()
        assert (st.eager, st.captures, st.replays) == \
            (1, 1, len(TBE._fl_grid(lo, hi, step)) - 1)


def test_gc_bins_gather_equals_the_roll_on_valid_cells():
    """The fragment's bins from gathers at s + fl - 1 against the rolled
    tensors of the earlier formulation, wherever the fragment lies
    inside its transcript."""
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, 5, (6, 300)).astype(np.int32))
    lens = torch.tensor([300, 299, 120, 37, 1, 250], dtype=torch.int32)
    gcum, pos = TBE._row_tables(codes)
    windows = TBE._gc_windows(gcum, lens, pos)
    fp_gc, fp_size, tp_gc, tp_size = windows
    L = codes.shape[1]
    for fl in (1, 2, 37, 38, 120, 299, 300):
        got = TBE._gc_bins(gcum, windows, pos,
                           torch.tensor(fl, dtype=torch.int32))
        gc = torch.roll(gcum, -fl, dims=1)[:, :L] - gcum[:, :L]
        frag = torch.round(100.0 * gc.to(torch.float32) / fl).to(
            torch.int32).clamp(0, 100)
        ctx = (fp_size + torch.roll(tp_size, -(fl - 1), dims=1)).to(
            torch.float32)
        frac = torch.where(ctx > 0, torch.round(
            100.0 * (fp_gc + torch.roll(tp_gc, -(fl - 1), dims=1)).to(
                torch.float32) / ctx.clamp(min=1.0)), 0.0)
        cond = torch.clamp((frac / (100.0 / 3)).to(torch.int32), max=2)
        valid = pos + fl - 1 < lens[:, None]
        assert torch.equal(got[0][valid], frag[valid])
        assert torch.equal(got[1][valid], cond[valid])
        # every cell, valid or not, indexes a bin
        assert int(got[0].min()) >= 0 and int(got[0].max()) <= 100
        assert int(got[1].min()) >= 0 and int(got[1].max()) <= 2


def test_a_dropped_step_is_captured_again():
    """GraphCache.drop forgets a signature's graph and keeps its
    counters: the next step of that signature is captured anew. On the
    CPU a loop has no cache (loop_cache), so it runs its eager body."""
    from salmon_tpu_torch.utils.graphcache import loop_cache

    assert loop_cache("cpu") is None
    graphs = CpuGraphs()
    cache = GraphCache(graphs=graphs)
    x = torch.zeros(3)

    def step():
        x.add_(1.0)

    for _ in range(3):
        cache.step("k", step, "cpu")
    cache.drop("k")
    cache.drop("k")        # dropping what is gone does nothing
    cache.step("k", step, "cpu")
    (st,) = cache.stats.values()
    assert (st.eager, st.captures, st.replays) == (1, 2, 3)
    assert graphs.captures == 2 and torch.equal(x, torch.full((3,), 4.0))


def test_padded_collection_adds_nothing(index):
    """The card pads a batch to a power of two with invalid rows so that
    batches of other lengths share a graph: the histograms are the
    unpadded batch's, bit for bit."""
    h = tbias.best_hits(index, 4, n=1000)
    args = [tbias.t(h[k]) for k in ("txp", "start", "end", "fw", "len1",
                                    "len2", "valid")] + [
        torch.ones(1000, dtype=torch.float32)]
    bdev = TB.bias_device_tensors(index, "cpu")
    want = TB.collect_bias_observations_impl(bdev, *args)
    padded = TB.padded_rows(args)
    assert padded[0].shape == (1024,) and not bool(padded[6][1000:].any())
    got = TB.collect_bias_observations_impl(bdev, *padded)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert TB.padded_rows([torch.zeros(3)])[0].shape == \
        (TB.COLLECT_MIN_ROWS,)
    assert TB.padded_rows([torch.zeros(4096)])[0].shape == (4096,)
    # on the CPU the collection runs eagerly: no graph cache
    assert TB.collect_graph_stats(bdev) == []
