"""The last compiled programs on the CPU: the `-a` error model's five
steps (alignment/errormodel_device.py), the --indexShards map step
(parallel/sharded.py, two graphs around the hit all-gather) and config
5's B1 and B2 (scripts/demo_config5_quant.py), each the counterpart of a
program that the JAX package compiles.

- The error model's grid is padded as the JAX package's _pack pads it
  (power-of-four row buckets from 4,096, a grid width that only grows):
  the same bucket, width and arrays at n = 1, 4,096, 4,097 and 20,000
  and across a grid that grows. On those padded grids the fused keys
  equal the JAX package's exactly; likelihoods and count increments lie
  within rtol 1e-6 of its (float32 sums in another order). The sentinel
  scatter equals the boolean-mask scatter it replaced exactly.
- The card's graphs cannot run here, so each compiled entry is driven
  through a GraphCache on test_torch_graph_step.CpuGraphs, a stand-in
  whose replay runs the step again into the captured outputs: three
  calls or more of a signature (eager, capture, replay) equal the eager
  body bit for bit, for the error model's -a calls, for the sharded
  step on two CPU ranks over gloo, and for config 5 at 2 shards on
  tests/test_torch_config5.py's table-less index. Signatures differ
  where the step differs (another bucket, a wider grid, another mate,
  another shard's planes), and the sharded step's ring keeps the
  outputs of `in_flight` earlier calls readable, which the quant asks
  for with its pipeline depth.
The card's graphs against the eager bodies:
tests/test_torch_graph_rest_cuda.py (marked cuda) and chip_smoke.py's
rest phase.
"""

import os

import numpy as np
import pytest
import torch
from test_torch_bamio import mixed_records, targets
from test_torch_config5 import READS, tl_index  # noqa: F401 (fixture)
from test_torch_graph_step import CpuGraphs
from test_torch_parallel import run_ranks

from salmon_tpu.alignment import errormodel_device as jdev
from salmon_tpu_torch.alignment import bamio as tbam
from salmon_tpu_torch.alignment import errormodel_device as tdev
from salmon_tpu_torch.index.builder import build_index, load_index, save_index
from salmon_tpu_torch.io.fastq import iter_paired_chunks
from salmon_tpu_torch.mapping import pipeline as tpipe
from salmon_tpu_torch.mapping.align import BANDED_DP
from salmon_tpu_torch.models.fld import FragmentLengthDistribution
from salmon_tpu_torch.parallel import sharded as tsh
from salmon_tpu_torch.scripts import demo_config5_quant as t_demo
from salmon_tpu_torch.utils import libformat
from salmon_tpu_torch.utils.graphcache import GraphCache, stats_totals

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _stand_in(counters=()):
    return GraphCache(list(counters), graphs=CpuGraphs(list(counters)))


# ---------------------------------------------------------------------------
# the error model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bam_setup(tmp_path_factory):
    """(reference arrays, batches of three mixed BAMs)."""
    names, lens, seqs = targets()
    seq = np.concatenate(seqs)
    seq_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    d = tmp_path_factory.mktemp("graph_rest_bams")
    batches = []
    for seed in (11, 12, 13):
        path = str(d / f"m{seed}.bam")
        tbam.write_bam(path, names, lens, mixed_records(seed=seed, n=240))
        rdr = tbam.BamReader(path)
        batches.append(next(rdr.batches()))
        rdr.close()
    ref = (seq, seq_off, np.asarray(lens, np.int64),
           np.arange(len(names), dtype=np.int64))
    return ref, batches


def _mapped(b):
    return np.nonzero(b.refid[:b.n] >= 0)[0]


def _models(ref):
    seq, seq_off, tlens, _ = ref
    return (jdev.DeviceAlignmentErrorModel(seq, seq_off, tlens),
            tdev.DeviceAlignmentErrorModel(seq, seq_off, tlens,
                                           device="cpu"))


def _sel(b, n, seed, short=False):
    """n records of batch b (drawn with repeats), only reads of at most
    64 bases where `short`."""
    pool = _mapped(b)
    if short:
        pool = pool[b.read_len[pool] <= 64]
    return np.sort(np.random.default_rng(seed).choice(pool, size=n))


def _assert_same_pack(tm, jm, b, sel, ref_map):
    p, fits, n = tm._pack_padded(b, sel, ref_map)
    jp, jfits, jn = jm._pack(b, sel, ref_map)
    assert n == jn == sel.size
    assert tm._rl_grid == jm._rl_grid
    np.testing.assert_array_equal(fits, jfits)
    for k, v in jp.items():
        got = p[k].numpy()
        want = np.asarray(v)
        if k == "rseq":
            want = want.view(np.uint8)
        assert got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    return p, jp, fits, n


@pytest.mark.parametrize("n", [1, 4096, 4097, 20000])
def test_padded_pack_matches_jax(bam_setup, n):
    ref, batches = bam_setup
    jm, tm = _models(ref)
    p, _, _, _ = _assert_same_pack(tm, jm, batches[0],
                                   _sel(batches[0], n, n), ref[3])
    assert p["rlen"].shape[0] == tdev.row_bucket(n)
    assert p["rlen"].shape[0] == {1: 4096, 4096: 4096, 4097: 16384,
                                  20000: 65536}[n]
    # padded rows are all zero
    for k, v in p.items():
        assert not v[n:].any(), k


def test_padded_pack_matches_jax_as_the_grid_grows(bam_setup):
    """Short reads first (a 64-wide grid), then the whole batch (128),
    then short reads again, which stay on the wider grid."""
    ref, batches = bam_setup
    jm, tm = _models(ref)
    widths = []
    for b, short in ((batches[0], True), (batches[1], False),
                     (batches[2], True)):
        _assert_same_pack(tm, jm, b, _sel(b, 300, 5, short), ref[3])
        widths.append(tm._rl_grid)
    assert widths == [64, 128, 128]


def _lp_tables(seed, dyadic=False):
    """Normalized log-probabilities of random positive counts, as
    normalize() makes them: (2, N_BINS, 82, 82) and (2, N_BINS) float32.
    dyadic: rounded to multiples of 1/64, whose row sums are exact in
    float32 in any order."""
    rng = np.random.default_rng(seed)
    counts = rng.random((2, tdev.N_BINS, tdev.N_FULL, tdev.N_FULL)) + 1e-3
    logp = np.log(counts / counts.sum(axis=3, keepdims=True))
    if dyadic:
        logp = np.round(logp * 64) / 64
    logp = logp.astype(np.float32)
    return logp, logp[:, :, 0, 0].copy()


def _assert_row_sums_close(got, want, keys, lp_flat, lp_bg, n_flat):
    """Row sums of fg - bg terms within 1e-6 of the row's sum of |terms|
    (the scale of a float32 sum's rounding; the packages add a row's
    terms in other orders), and exact where every sum is exact."""
    k = np.asarray(keys)
    valid = k < n_flat
    fg = np.append(lp_flat, 0.0)[k]
    bg = np.append(lp_bg, 0.0)[np.minimum(k // (tdev.N_FULL * tdev.N_FULL),
                                          lp_bg.size)]
    scale = np.where(valid, np.abs(fg.astype(np.float64) - bg), 0.0).sum(1)
    np.testing.assert_array_less(np.abs(got.astype(np.float64) - want),
                                 1e-6 * np.maximum(scale, 1e-30) + 1e-30)


@pytest.mark.parametrize("n", [1, 4096, 4097])
@pytest.mark.parametrize("dyadic", [False, True], ids=["real", "dyadic"])
def test_steps_on_padded_grids_match_jax(bam_setup, n, dyadic):
    """The five steps on the padded grid: keys exactly, likelihoods
    within 1e-6 of each row's scale (exactly with dyadic tables), count
    increments within rtol 1e-6 of the JAX package's."""
    import jax.numpy as jnp

    ref, batches = bam_setup
    jm, tm = _models(ref)
    b = batches[1]
    sel = _sel(b, n, 100 + n)
    p, jp, fits, _ = _assert_same_pack(tm, jm, b, sel, ref[3])
    grid = [p[k] for k in ("ops", "oplens", "rseq", "rlen", "toff", "pos",
                           "tlen")]
    jgrid = [jp[k] for k in ("ops", "oplens", "rseq", "rlen", "toff",
                             "pos", "tlen")]
    npad = grid[0].shape[0]
    rng = np.random.default_rng(n)
    mate = (rng.random(npad) < 0.5).astype(np.int32)
    w = rng.random(npad).astype(np.float32)
    logp, lp_bg = _lp_tables(n, dyadic)
    check = (np.testing.assert_array_equal if dyadic
             else _assert_row_sums_close)

    keys = tdev.expand_fused(*grid, torch.from_numpy(mate), tm.seq_codes)
    jkeys = jdev._expand_fused(*jgrid, jnp.asarray(mate), jm.seq_codes)
    assert keys.shape == (npad, grid[2].shape[1] + tdev.COL_SLACK)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    assert (keys.numpy() < 2 * tdev.N_FLAT).any()

    got = tdev.ll_keys(keys, torch.from_numpy(logp.reshape(-1)),
                       torch.from_numpy(lp_bg.reshape(-1))).numpy()
    want = np.asarray(jdev._ll_keys(jkeys, jnp.asarray(logp.reshape(-1)),
                                    jnp.asarray(lp_bg.reshape(-1))))
    args = () if dyadic else (keys.numpy(), logp.reshape(-1),
                              lp_bg.reshape(-1), 2 * tdev.N_FLAT)
    check(got, want, *args)
    np.testing.assert_allclose(
        tdev.update_keys(keys, torch.from_numpy(w)).numpy(),
        np.asarray(jdev._update_keys(jkeys, jnp.asarray(w))), rtol=1e-6)
    for m in (0, 1):
        got = tdev.log_likelihood_rows(
            *grid, torch.from_numpy(logp[m].reshape(-1)),
            torch.from_numpy(lp_bg[m]), tm.seq_codes).numpy()
        want = np.asarray(jdev._log_likelihood(
            *jgrid, jnp.asarray(logp[m].reshape(-1)), jnp.asarray(lp_bg[m]),
            jm.seq_codes))
        if dyadic:
            check(got, want)
        else:
            key, _ = tdev.expand_keys(*grid, tm.seq_codes)
            check(got, want, key.numpy(), logp[m].reshape(-1), lp_bg[m],
                  tdev.N_FLAT)
    np.testing.assert_allclose(
        tdev.count_update(*grid, torch.from_numpy(w), tm.seq_codes).numpy(),
        np.asarray(jdev._count_update(*jgrid, jnp.asarray(w),
                                      jm.seq_codes)), rtol=1e-6)


def _mask_scatter(key, valid, w, n):
    """The boolean-mask scatter that the sentinel scatter replaced."""
    wcol = w.to(torch.float32)[:, None].expand(key.shape)
    return torch.zeros(n, dtype=torch.float32).index_add_(
        0, key[valid], wcol[valid])


@pytest.mark.parametrize("seed", [0, 1])
def test_sentinel_scatter_equals_the_mask_scatter(bam_setup, seed):
    ref, batches = bam_setup
    _, tm = _models(ref)
    b = batches[seed]
    p, _, _ = tm._pack_padded(b, _sel(b, 600, seed), ref[3])
    key, valid = tdev.expand_keys(p["ops"], p["oplens"], p["rseq"],
                                  p["rlen"], p["toff"], p["pos"], p["tlen"],
                                  tm.seq_codes)
    assert 0 < int(valid.sum()) < valid.numel()
    w = torch.from_numpy(np.random.default_rng(seed).random(
        key.shape[0]).astype(np.float32))
    assert torch.equal(tdev._scatter_valid(key, valid, w, tdev.N_FLAT),
                       _mask_scatter(key, valid, w, tdev.N_FLAT))


def _drive_model(model, batches, ref_map):
    """The -a quant's calls, then the per-mate ones, over the batches:
    (fused keys, likelihoods, counts) after each batch."""
    seen = []
    rng = np.random.default_rng(3)
    for b in batches:
        sel = _mapped(b)
        k = sel.size // 2
        prep = model.prepare(b, sel[:k], sel[k:2 * k], ref_map)
        keys = prep.keys.clone()
        ll = prep.log_likelihood()
        prep.update(rng.random(k))
        lls = [model.log_likelihood(b, sel, ref_map, m) for m in (0, 1)]
        model.update(b, sel, ref_map, rng.random(sel.size), 1)
        seen.append((keys, ll, lls, tdev.read_counts(model)))
    return seen


def test_error_model_through_the_stand_in_is_the_eager_model(bam_setup):
    """Every step of the model through a GraphCache on the stand-in, four
    batches of one signature: keys, likelihoods and counts bit-equal to
    the model without a cache, and each of the five steps eager once,
    captured once and replayed from then on."""
    ref, batches = bam_setup
    seq, seq_off, tlens, ref_map = ref
    plain = tdev.DeviceAlignmentErrorModel(seq, seq_off, tlens,
                                           device="cpu")
    graphed = tdev.DeviceAlignmentErrorModel(seq, seq_off, tlens,
                                             device="cpu")
    assert plain.graphs is None
    graphed.graphs = _stand_in()
    batches = batches + batches[:1]
    for (k1, l1, m1, c1), (k2, l2, m2, c2) in zip(
            _drive_model(graphed, batches, ref_map),
            _drive_model(plain, batches, ref_map)):
        assert torch.equal(k1, k2)
        np.testing.assert_array_equal(l1, l2)
        for a, b in zip(m1, m2):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c1, c2)
    names = {key[0]: 0 for key in graphed.graphs.stats}
    for key, st in graphed.graphs.stats.items():
        names[key[0]] += 1
        # the capture's own call replays too
        assert (st.eager, st.captures, st.replays) == (1, 1, 3), st.label
    # one signature a step; the per-mate likelihood one per mate
    assert names == {"expand_fused": 1, "ll_keys": 1, "update_keys": 1,
                     "log_likelihood_rows": 2, "count_update": 1}


def test_error_model_signatures_differ_where_the_step_differs(bam_setup):
    ref, batches = bam_setup
    seq, seq_off, tlens, ref_map = ref
    model = tdev.DeviceAlignmentErrorModel(seq, seq_off, tlens,
                                           device="cpu")
    model.graphs = _stand_in()
    b = batches[0]

    def expand_keys_after(sel):
        before = set(model.graphs.stats)
        model.prepare(b, sel, None, ref_map)
        return set(model.graphs.stats) - before

    short = _sel(b, 100, 1, short=True)
    assert len(expand_keys_after(short)) == 1              # 64 wide
    assert expand_keys_after(_sel(b, 120, 2, short=True)) == set()
    assert len(expand_keys_after(_sel(b, 100, 3))) == 1     # 128 wide
    assert len(expand_keys_after(_sel(b, 5000, 4))) == 1    # 16,384 rows
    assert expand_keys_after(short) == set()   # the grid stayed 128 wide
    w = np.ones(short.size)
    model.update(b, short, ref_map, w, 0)
    model.update(b, short, ref_map, w, 1)
    model.update(b, short, ref_map, w, 1)
    mates = [key[-1] for key in model.graphs.stats
             if key[0] == "count_update"]
    assert sorted(mates) == [0, 1]
    # another model's sequence (the steps read it in place)
    other = tdev.DeviceAlignmentErrorModel(seq.copy(), seq_off, tlens,
                                           device="cpu")
    other.graphs = model.graphs
    before = set(model.graphs.stats)
    other.prepare(b, short, None, ref_map)
    assert len(set(model.graphs.stats) - before) == 1


def test_a_step_on_the_card_needs_a_cache():
    with pytest.raises(ValueError, match="ll_keys"):
        tdev.compiled_step(None, "ll_keys", tdev.ll_keys_impl,
                           [_FakeCuda()])


class _FakeCuda:
    """A tensor stand-in that says it lies on the card."""

    shape, dtype, device = (3,), torch.int64, torch.device("cpu")
    is_cuda = True


def test_a_failed_capture_names_the_error_model_step(bam_setup):
    ref, batches = bam_setup
    seq, seq_off, tlens, ref_map = ref
    model = tdev.DeviceAlignmentErrorModel(seq, seq_off, tlens,
                                           device="cpu")
    model.graphs = GraphCache(graphs=CpuGraphs(fail=True))
    sel = _mapped(batches[0])
    model.prepare(batches[0], sel, None, ref_map)
    with pytest.raises(RuntimeError, match="error model expand_fused"):
        model.prepare(batches[0], sel, None, ref_map)


# ---------------------------------------------------------------------------
# the sharded map step, on two CPU ranks over gloo
# ---------------------------------------------------------------------------

SHARD_ROWS = 64
SHARD_BATCHES = 5
IN_FLIGHT = 2


def _shard_inputs(inputs):
    idx = load_index(os.path.join(inputs, "idx"))
    chunks = iter_paired_chunks([READS[0]], [READS[1]], SHARD_ROWS, 256)
    batches = []
    for _, c in zip(range(SHARD_BATCHES), chunks):
        batches.append({"codes_l": torch.from_numpy(c.left.codes),
                        "lengths_l": torch.from_numpy(c.left.lengths),
                        "codes_r": torch.from_numpy(c.right.codes),
                        "lengths_r": torch.from_numpy(c.right.lengths)})
    fld = FragmentLengthDistribution(max_val=1000)
    fmt = libformat.parse_library_format("IU")
    return (idx, batches,
            {"logpmf": torch.from_numpy(fld.log_pmf().astype(np.float32)),
             "logcmf": torch.from_numpy(fld.log_cmf().astype(np.float32)),
             "mode": 1},
            (torch.as_tensor(libformat.paired_compat_table(fmt)),
             torch.as_tensor(libformat.orphan_compat_table(fmt))),
            (torch.as_tensor(libformat.single_compat_table(fmt)),))


def _same(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _sharded_worker(world, inputs, out_dir):
    """Each batch through the stand-in's two graphs and eagerly; the
    ring's last IN_FLIGHT + 1 outputs still readable after the loop;
    the signatures of another shard's planes; a quant on the sharded
    index passing its pipeline depth as in_flight."""
    from salmon_tpu_torch import quant as tquant
    from salmon_tpu_torch.constants import SalmonDefaults

    idx, batches, fld, cpo, cs = _shard_inputs(inputs)
    dev, over = tsh.device_sharded_index(idx, world, 2)
    cfg = tsh.sharded_config(idx, over)
    bits = over["shard_bits"]
    rec = {}
    for kind, compat in (("paired", cpo), ("single", cs)):
        cache = _stand_in([BANDED_DP])
        graphed, equal = [], []
        for b in batches:
            if kind == "single":
                b = {"codes": b["codes_l"], "lengths": b["lengths_l"]}
            impl = (tsh.sharded_map_paired_impl if kind == "paired"
                    else tsh.sharded_map_single_impl)
            want = impl(world, b, dev, cfg, bits, fld, *compat)
            got = tsh._graphed(kind, world, b, dev, cfg, bits, fld, compat,
                               IN_FLIGHT, cache)
            equal.append(_same(got, want))
            graphed.append((got, want))
        rec[f"{kind}_equal"] = equal
        # the ring: the outputs of the last IN_FLIGHT + 1 calls intact
        rec[f"{kind}_ring"] = [_same(g, w)
                               for g, w in graphed[-(IN_FLIGHT + 1):]]
        rec[f"{kind}_nonzero"] = int(sum(int(w["num_mapped"])
                                         for _, w in graphed))
        rec[f"{kind}_stats"] = sorted(
            (key[0], st.eager, st.captures, st.replays)
            for key, st in cache.stats.items())
        # another shard's planes: a signature of each graph
        before = set(cache.stats)
        tsh._graphed(kind, world, b, dict(dev, occ_oct=dev["occ_oct"].clone()),
                     cfg, bits, fld, compat, IN_FLIGHT, cache)
        rec[f"{kind}_new_signatures"] = sorted(
            key[0] for key in set(cache.stats) - before)

    seen = []

    def recording(*a, in_flight=1, **kw):
        seen.append(in_flight)
        return tsh.sharded_map_paired(*a, in_flight=in_flight, **kw)

    tquant.sharded_map_paired = recording
    os.environ["SALMON_TPU_PIPE_DEPTH"] = "2"
    opts = SalmonDefaults()
    opts.index_shards = 2
    tquant.quantify(idx, "A", [READS[0]], [READS[1]], opts=opts,
                    progress=False, device="cpu", world=world)
    rec["quant_in_flight"] = seen
    torch.save(rec, os.path.join(out_dir, f"rank{world.rank}.pt"))


@pytest.fixture(scope="module")
def sharded_ranks(tmp_path_factory):
    inputs = str(tmp_path_factory.mktemp("shard_inputs"))
    save_index(build_index(os.path.join(DATA, "transcripts.fasta"), k=25),
               os.path.join(inputs, "idx"))
    out_dir = str(tmp_path_factory.mktemp("shard_out"))
    run_ranks(_sharded_worker, 2, inputs, out_dir)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(2)]


@pytest.mark.parametrize("kind", ["paired", "single"])
def test_sharded_step_through_the_stand_in_is_the_eager_step(
        sharded_ranks, kind):
    for rec in sharded_ranks:
        assert rec[f"{kind}_equal"] == [True] * SHARD_BATCHES
        assert rec[f"{kind}_nonzero"] > 0
        # A and B: one signature each, eager once, captured once
        assert rec[f"{kind}_stats"] == [
            ("sharded map", 1, 1, SHARD_BATCHES - 1),
            ("sharded seeds", 1, 1, SHARD_BATCHES - 1)]


@pytest.mark.parametrize("kind", ["paired", "single"])
def test_sharded_ring_keeps_the_outputs_in_flight(sharded_ranks, kind):
    for rec in sharded_ranks:
        assert rec[f"{kind}_ring"] == [True] * (IN_FLIGHT + 1)


def test_another_shards_planes_is_another_signature(sharded_ranks):
    for rec in sharded_ranks:
        for kind in ("paired", "single"):
            assert rec[f"{kind}_new_signatures"] == ["sharded map",
                                                     "sharded seeds"]


def test_quant_passes_its_depth_as_in_flight(sharded_ranks):
    for rec in sharded_ranks:
        assert rec["quant_in_flight"] and \
            set(rec["quant_in_flight"]) == {2}


# ---------------------------------------------------------------------------
# config 5's B1 and B2
# ---------------------------------------------------------------------------

def test_config5_through_the_stand_in_is_the_eager_run(
        tl_index, monkeypatch):
    """At 2 shards and R = 4,096 (three batches of the sample pairs):
    the run through the stand-in caches equals the run without them (eq
    classes, alphas, the report but for its seconds); B1 per shard and
    B2 each eager once, captured once and replayed; each shard's B1
    graph dropped after its pass."""
    monkeypatch.setattr(t_demo, "R", 4096)
    args = (tl_index, READS[0], READS[1], 2, 20000, "cpu")
    want = t_demo.quantify(*args)
    dropped = []
    b1, b2 = _stand_in(), _stand_in([BANDED_DP])
    drop = b1.drop
    b1.drop = lambda key: (dropped.append(key[:2]), drop(key))
    got = t_demo.quantify(*args, caches=(b1, b2))
    timed = ("load_min", "map_s", "frags_per_s", "em_s")
    assert {k: v for k, v in got.report.items() if k not in timed} == {
        k: v for k, v in want.report.items() if k not in timed}
    for k in ("labels", "weights", "offsets", "counts", "class_sizes"):
        np.testing.assert_array_equal(getattr(got.eq, k),
                                      getattr(want.eq, k), err_msg=k)
    np.testing.assert_array_equal(got.alphas, want.alphas)
    assert [(key[1], st.eager, st.captures, st.replays)
            for key, st in b1.stats.items()] == [(0, 1, 1, 2), (1, 1, 1, 2)]
    assert [(st.eager, st.captures, st.replays)
            for st in b2.stats.values()] == [(1, 1, 2)]
    assert dropped == [("b1", 0), ("b1", 1)]
    assert not b1._entries
    totals = stats_totals(b2.stats.values())
    assert {k: got.seconds[f"b2_graph_{k}"]
            for k in ("signatures", "eager", "captures", "replays")} == {
        k: totals[k] for k in ("signatures", "eager", "captures",
                               "replays")}
    assert got.seconds["b1_graph_signatures"] == 2
    assert want.seconds["b1_graph_signatures"] == 0
