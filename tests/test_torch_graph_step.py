"""The compiled batch step (mapping.pipeline.map_paired_batch /
map_single_batch through utils.graphcache) on the CPU.

The card's graphs cannot run here, so the cache is driven by CpuGraphs,
a stand-in with its `eager` / `capture` interface whose "replay" runs
the step again into the captured output tensors, overwriting them as a
graph replay does, while the launch counters stay as they were (a
replay runs no Python). With it: the signature function, the output
ring, the first sighting that is never captured, the launch counts a
replay adds, a failed capture that raises, and the pipeline's own glue
(step_signature, the static inputs, the FLD dict rebuilt inside the
step) bit-equal to the eager step on the sample reads in the paired,
single-end, rescue and sparse modes. On CPU tensors the entries are the
eager step itself, and still equal the JAX package's map_paired_batch /
map_single_batch on the sample tile. The card's graph against the eager
step is tests/test_torch_kernels.py::test_graph_step_matches_eager
(marked cuda) and chip_smoke.py's graph phase.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salmon_tpu.index import builder as jb
from salmon_tpu.mapping import pipeline as jpipe
from salmon_tpu_torch.index import builder as tb
from salmon_tpu_torch.io.fastq import iter_paired_chunks
from salmon_tpu_torch.mapping import pipeline as tpipe
from salmon_tpu_torch.mapping.align import BANDED_DP, KernelCounter
from salmon_tpu_torch.models.fld import FragmentLengthDistribution
from salmon_tpu_torch.utils import graphcache
from salmon_tpu_torch.utils import libformat as tlf

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
R = 256


class CpuGraphs:
    """CudaGraphs' interface on the CPU: capture runs the step once on
    the static inputs (as recording does, its launch counts are taken
    back by the cache); replay recomputes into the captured outputs and
    leaves `counters` as they were."""

    def __init__(self, counters=(), fail=False):
        self.counters = list(counters)
        self.fail = fail
        self.captures = 0

    def eager(self, fn, inputs):
        return fn(inputs)

    def capture(self, fn, static):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        self.captures += 1
        out = fn(static)

        def replay():
            saved = [dict(c.by_shape) for c in self.counters]
            for k, v in fn(static).items():
                out[k].copy_(v)
            for c, s in zip(self.counters, saved):
                c.by_shape = s
        return replay, out, 0


def _double(ts):
    return {"y": ts[0] * 2, "s": ts[0].sum()}


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_ring_keeps_the_outputs_in_flight(depth):
    cache = graphcache.GraphCache(graphs=CpuGraphs())
    outs = []
    for i in range(8):
        x = torch.arange(5, dtype=torch.float32) + 10 * i
        outs.append((x, cache.run("k", _double, [x], ring=depth + 1)))
        # this call's outputs and the depth before it are intact
        for x_j, out_j in outs[-(depth + 1):]:
            assert torch.equal(out_j["y"], x_j * 2)
            assert float(out_j["s"]) == float(x_j.sum())
    # the ring holds depth + 1 sets: older outputs were reused
    assert not torch.equal(outs[-(depth + 2)][1]["y"],
                           outs[-(depth + 2)][0] * 2)
    st = cache.stats["k"]
    assert (st.eager, st.captures, st.replays) == (1, 1, 7)


def test_a_ring_that_grows_keeps_what_is_in_flight():
    cache = graphcache.GraphCache(graphs=CpuGraphs())
    outs = []
    for i, ring in enumerate([2, 2, 2, 4, 4, 4, 4]):
        x = torch.full((3,), float(i))
        outs.append((x, cache.run("k", _double, [x], ring=ring)))
        for x_j, out_j in outs[-ring:]:
            if out_j is not outs[0][1]:        # the eager run's own
                assert torch.equal(out_j["y"], x_j * 2)


def test_a_signature_seen_once_is_never_captured():
    graphs = CpuGraphs()
    cache = graphcache.GraphCache(graphs=graphs)
    for n in range(1, 5):
        x = torch.ones(n)
        assert torch.equal(cache.run(("k", n), _double, [x])["y"], 2 * x)
    assert graphs.captures == 0
    assert all(st.eager == 1 and st.replays == 0
               for st in cache.stats.values())
    cache.run(("k", 2), _double, [torch.ones(2)])
    assert graphs.captures == 1
    assert graphcache.stats_totals(cache.stats.values()) == {
        "signatures": 4, "eager": 4, "captures": 1, "replays": 1,
        "capture_seconds": cache.stats[("k", 2)].capture_seconds,
        "pool_bytes": 0}


def test_replays_add_the_launches_the_capture_recorded():
    counter = KernelCounter("dp")
    cache = graphcache.GraphCache([counter], graphs=CpuGraphs([counter]))

    def step(ts):
        counter.add(15)
        counter.add(80)
        counter.add(15)
        return {"y": ts[0] + 1}

    for i in range(6):
        cache.run("k", step, [torch.full((4,), float(i))])
        assert counter.by_shape == {15: 2 * (i + 1), 80: i + 1}
    st = cache.stats["k"]
    assert (st.eager, st.captures, st.replays) == (1, 1, 5)


def test_a_failed_capture_raises_naming_the_signature():
    cache = graphcache.GraphCache(graphs=CpuGraphs(fail=True))
    cache.run("k", _double, [torch.ones(3)], label="paired R=4 L=32")
    with pytest.raises(RuntimeError, match="paired R=4 L=32"):
        cache.run("k", _double, [torch.ones(3)], label="paired R=4 L=32")


# --- the pipeline's signature and glue, on the sample reads


@pytest.fixture(scope="module")
def sample():
    fasta = os.path.join(DATA, "transcripts.fasta")
    tidx = tb.build_index(fasta, k=31)
    chunks = iter_paired_chunks([os.path.join(DATA, "reads_1.fastq")],
                                [os.path.join(DATA, "reads_2.fastq")], R,
                                256)
    return fasta, tidx, tpipe.device_index_tensors(tidx, "cpu"), \
        [next(chunks) for _ in range(3)]


def _batch(chunk, single=False, orphans=0):
    if single:
        return {"codes": torch.from_numpy(chunk.left.codes),
                "lengths": torch.from_numpy(chunk.left.lengths)}
    cr = chunk.right.codes.copy()
    # the rescue's orphans: a mismatch every 12 bases leaves the first
    # `orphans` right mates no k = 31 seed, and they still align above
    # minScoreFraction (tests/test_torch_rescue.py's orphans)
    cr[:orphans, 5::12] = np.where(cr[:orphans, 5::12] < 4,
                                   (cr[:orphans, 5::12] + 1) % 4,
                                   cr[:orphans, 5::12])
    return {"codes_l": torch.from_numpy(chunk.left.codes),
            "lengths_l": torch.from_numpy(chunk.left.lengths),
            "codes_r": torch.from_numpy(cr),
            "lengths_r": torch.from_numpy(chunk.right.lengths)}


def _fld(seed, mode=1):
    fld = FragmentLengthDistribution(max_val=1000, prior_mu=250.0,
                                     prior_sigma=25.0)
    rng = np.random.default_rng(seed)
    obs = np.zeros(1001)
    obs[200:300] = rng.poisson(30, 100)
    fld.add_observations(obs)
    return {"logpmf": torch.from_numpy(fld.log_pmf().astype(np.float32)),
            "logcmf": torch.from_numpy(fld.log_cmf().astype(np.float32)),
            "mode": mode}


def _compat(single=False):
    fmt = tlf.parse_library_format("IU" if not single else "U")
    if single:
        return (torch.from_numpy(tlf.single_compat_table(fmt)),)
    return (torch.from_numpy(tlf.paired_compat_table(fmt)),
            torch.from_numpy(tlf.orphan_compat_table(fmt)))


def test_signature_same_for_same_shapes_and_values(sample, monkeypatch):
    _, tidx, dev, chunks = sample
    monkeypatch.delenv("SALMON_TPU_ROWPOOL", raising=False)
    cfg = tpipe.MapperConfig.from_index(tidx)
    keys = {tpipe.step_signature("paired", _batch(c), dev, cfg, _fld(i),
                                 _compat()) for i, c in enumerate(chunks)}
    # other reads and another FLD's values: one signature
    assert len(keys) == 1
    # the same config built again is the same key
    again = tpipe.MapperConfig.from_index(tidx)
    assert tpipe.step_signature("paired", _batch(chunks[0]), dev, again,
                                _fld(0), _compat()) in keys


def test_signature_differs_where_the_step_differs(sample, monkeypatch):
    _, tidx, dev, chunks = sample
    monkeypatch.delenv("SALMON_TPU_ROWPOOL", raising=False)
    cfg = tpipe.MapperConfig.from_index(tidx)
    b = _batch(chunks[0])

    def key(batch=b, cfg=cfg, fld=None, kind="paired", compat=None):
        return tpipe.step_signature(kind, batch, dev, cfg,
                                    _fld(0) if fld is None else fld,
                                    compat or _compat())

    base = key()
    # another width bucket (io/fastq.py LEN_BUCKETS): L 128 instead of 64
    wide = {k: (torch.nn.functional.pad(v, (0, 128 - v.shape[1]), value=4)
                if v.dim() == 2 else v) for k, v in b.items()}
    others = [
        key(batch=wide),
        key(fld=_fld(0, mode=2)),
        key(fld=_fld(0, mode=0)),
        key(fld=_fld(0)["logpmf"]),             # a bare log-pmf
        key(cfg=dataclasses.replace(cfg, recover_orphans=True)),
        key(cfg=dataclasses.replace(cfg, sparse_seed=True)),
        key(kind="single"),
        key(compat=(torch.ones(6, dtype=torch.bool),
                    torch.ones(2, dtype=torch.bool))),
    ]
    monkeypatch.setenv("SALMON_TPU_ROWPOOL", "64")
    others.append(key())
    assert len(set(others)) == len(others)
    assert base not in others
    # another index's tensors (the graph reads them in place)
    dev2 = dict(dev, seq4=dev["seq4"].clone())
    monkeypatch.delenv("SALMON_TPU_ROWPOOL")
    assert tpipe.step_signature("paired", b, dev2, cfg, _fld(0),
                                _compat()) != base


MODES = ["paired", "single", "rescue", "sparse"]


@pytest.mark.parametrize("mode", MODES)
def test_graphed_glue_is_the_eager_step(sample, mode, monkeypatch):
    """The pipeline's _graphed through a GraphCache on CpuGraphs, three
    batches whose reads and FLD differ: every output key bit-equal to
    the eager step's, and BANDED_DP counted as the eager step counts
    (nothing on the CPU)."""
    _, tidx, dev, chunks = sample
    cfg = tpipe.MapperConfig.from_index(tidx)
    if mode == "rescue":
        cfg = dataclasses.replace(cfg, recover_orphans=True)
    if mode == "sparse":
        cfg = dataclasses.replace(cfg, sparse_seed=True)
    single = mode == "single"
    impl = tpipe.map_single_batch_impl if single \
        else tpipe.map_paired_batch_impl
    cache = graphcache.GraphCache([BANDED_DP], graphs=CpuGraphs([BANDED_DP]))
    monkeypatch.setattr(tpipe, "graph_cache", lambda d: cache)
    compat = _compat(single)
    BANDED_DP.reset()
    got = []
    for i, chunk in enumerate(chunks):
        b = _batch(chunk, single, orphans=64 if mode == "rescue" else 0)
        fld = _fld(i, mode=1 + (i % 2))
        got.append((b, fld, tpipe._graphed(
            "single" if single else "paired", impl, b, dev, cfg, fld,
            compat, in_flight=len(chunks))))
    assert BANDED_DP.by_shape == {}
    for b, fld, out in got:
        want = impl(b, dev, cfg, fld, *compat)
        assert set(out) == set(want)
        for k in want:
            assert torch.equal(out[k], want[k]), (mode, k)
        if mode == "rescue":
            assert int(out["num_orphans_rescued"]) > 0
    # fld modes 1 and 2 alternate: two signatures, the second batch of
    # mode 1 replays
    totals = graphcache.stats_totals(cache.stats.values())
    assert (totals["signatures"], totals["eager"], totals["captures"],
            totals["replays"]) == (2, 2, 1, 1)


def test_cpu_entries_are_the_eager_step(sample):
    _, tidx, dev, chunks = sample
    cfg = tpipe.MapperConfig.from_index(tidx)
    b, fld = _batch(chunks[1]), _fld(3, mode=2)
    got = tpipe.map_paired_batch(b, dev, cfg, fld, *_compat())
    want = tpipe.map_paired_batch_impl(b, dev, cfg, fld, *_compat())
    assert all(torch.equal(got[k], want[k]) for k in want)
    bs = _batch(chunks[1], single=True)
    got = tpipe.map_single_batch(bs, dev, cfg, fld, *_compat(True))
    want = tpipe.map_single_batch_impl(bs, dev, cfg, fld, *_compat(True))
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert tpipe.graph_stats(dev) == []


# eq classes and counters: exact; weights and masses within rtol 1e-6, as
# tests/test_torch_pipeline.py holds them (XLA may fuse exp/log
# differently). The best-hit keys and histograms depend on the top-score
# tie order and are held there.
EXACT_KEYS = ("eq_txp", "eq_bins", "frag_ok", "num_processed", "num_mapped",
              "num_decoy_fragments", "num_frags_filtered_vm",
              "num_alns_below_threshold", "num_orphans_rescued",
              "seed_tail_over")


@pytest.mark.parametrize("single", [False, True], ids=["paired", "single"])
def test_cpu_entries_match_jax(sample, single):
    fasta, tidx, dev, chunks = sample
    jidx = jb.build_index(fasta, k=31)
    jdev = jpipe.device_index_arrays(jidx)
    jcfg = jpipe.MapperConfig.from_index(jidx)
    cfg = tpipe.MapperConfig.from_index(tidx)
    b, fld, compat = _batch(chunks[0], single), _fld(5, mode=2), \
        _compat(single)
    fld_j = {"logpmf": jnp.asarray(fld["logpmf"].numpy()),
             "logcmf": jnp.asarray(fld["logcmf"].numpy()),
             "mode": jnp.int32(2)}
    jb_ = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
    jc = [jnp.asarray(c.numpy()) for c in compat]
    if single:
        want = jpipe.map_single_batch(jb_, jdev, jcfg, fld_j, *jc)
        got = tpipe.map_single_batch(b, dev, cfg, fld, *compat)
    else:
        want = jpipe.map_paired_batch(jb_, jdev, jcfg, fld_j, *jc)
        got = tpipe.map_paired_batch(b, dev, cfg, fld, *compat)
    assert set(got) == set(want)
    assert int(got["num_mapped"]) > 0.4 * int(got["num_processed"])
    for k in EXACT_KEYS:
        np.testing.assert_array_equal(
            got[k].numpy(), np.asarray(want[k]).astype(got[k].numpy().dtype),
            err_msg=k)
    for k in ("eq_weight", "txp_mass"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
