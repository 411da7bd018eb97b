"""The port's multi-process mapping and EM (salmon_tpu_torch/parallel)
against the JAX package's mesh programs, on gloo groups of CPU
processes (one rank per JAX device).

- sharded_map_paired / sharded_map_single on 4 ranks (2 reads groups x
  2 index shards) against JAX's 2 x 2 mesh
  (make_sharded_mesh(2, n_devices=4)) on the same 64-row batch: the
  ranks' outputs concatenated in rank order equal the JAX outputs,
  which are sharded over (reads, kmer) in the same order; the summed
  statistics are equal, txp_mass within rtol 1e-5. Exact: the seeding
  equals the single-device sparse flow. The best hit is the first
  joined hit after the pairing's ranking, an unstable sort in the JAX
  package (ROADMAP queue 3), so the best_* keys are compared on
  fragments without a tie on the top score and each fld_hist is held
  to its own best hits, as tests/test_torch_seed_sparse.py does. The
  tie order also decides which hits the weight_width truncation keeps,
  so num_alns_below_threshold, a count over those hits, differs between
  the packages already on one device (5 against 2 on this batch); it
  is held to the port's single-device value instead.
- At the default budget and at seed_hits_per_end=512, every output
  against the port's own single-device sparse map.
- Data-parallel mapping on 2 ranks (each rank's map_paired_batch, its
  statistics merged by quant_step.merge_stats) against JAX's
  parallel_map_paired on a 2-device mesh, and run_em_sharded on 2
  ranks against JAX's (same iteration count, alphas within rtol 1e-4 /
  atol 1e-3, the tolerance of tests/test_parallel.py).
- The host collectives: allreduce_histograms bit-equal to a numpy sum
  in rank order, allgather_eq_state with no row on one rank, the
  has-data vote.

Each group runs once per module (a fixture) with its own time limit;
the tests read what its ranks saved.
"""

import dataclasses
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_pipeline as ttp
import torch.multiprocessing as mp
from test_parallel import _mk_batch

from salmon_tpu.constants import DEFAULTS as JDEFAULTS
from salmon_tpu.index import builder as jb
from salmon_tpu.inference import em as jem
from salmon_tpu.mapping import pipeline as jpipe
from salmon_tpu.parallel import make_mesh, parallel_map_paired, run_em_sharded
from salmon_tpu.parallel import sharded as jsh
from salmon_tpu_torch.index.builder import build_index, load_index, save_index
from salmon_tpu_torch.inference.eqclasses import EquivalenceClassAccumulator
from salmon_tpu_torch.mapping import pipeline as tpipe
from salmon_tpu_torch.models.fld import FragmentLengthDistribution
from salmon_tpu_torch.parallel import distributed
from salmon_tpu_torch.parallel import em as tem
from salmon_tpu_torch.parallel import quant_step
from salmon_tpu_torch.parallel import sharded as tsh
from salmon_tpu_torch.parallel.launch import free_port
from salmon_tpu_torch.utils import libformat

FASTA = os.path.join(os.path.dirname(__file__), "data", "transcripts.fasta")
RANK_TIMEOUT = 240          # seconds for one group of ranks
PSUM_KEYS = quant_step._PSUM_KEYS


def _rank_main(rank, fn, nprocs, port, args):
    torch.set_num_threads(1)
    os.environ.update({distributed.ENV_COORD: f"127.0.0.1:{port}",
                       distributed.ENV_NPROC: str(nprocs),
                       distributed.ENV_PID: str(rank)})
    fn(distributed.init_from_env("cpu"), *args)


def run_ranks(fn, nprocs: int, *args, timeout: float = RANK_TIMEOUT):
    """fn(world, *args) in each of nprocs spawned processes joined in a
    gloo group on the CPU through the launch variables (which the CLI
    reads too); raises when a rank fails or the time limit passes (the
    other ranks are stopped)."""
    ctx = mp.start_processes(_rank_main, args=(fn, nprocs, free_port(),
                                               args),
                             nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks passed {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def _save(out_dir, name, world, arrays: dict):
    np.savez(os.path.join(out_dir, f"{name}_{world.rank}.npz"), **arrays)


def _load(out_dir, name, nprocs):
    return [dict(np.load(os.path.join(out_dir, f"{name}_{r}.npz")))
            for r in range(nprocs)]


def _np(out: dict) -> dict:
    return {k: v.numpy() for k, v in out.items()}


def _mapping_inputs(inputs):
    z = np.load(os.path.join(inputs, "batch.npz"))
    batch = {k: torch.from_numpy(z[k]) for k in
             ("codes_l", "lengths_l", "codes_r", "lengths_r")}
    fld = torch.from_numpy(z["logpmf"])
    fmt = libformat.parse_library_format("IU")
    cp = torch.as_tensor(libformat.paired_compat_table(fmt))
    co = torch.as_tensor(libformat.orphan_compat_table(fmt))
    cs = torch.as_tensor(libformat.single_compat_table(fmt))
    return load_index(os.path.join(inputs, "idx")), batch, fld, cp, co, cs


def _four_rank_worker(world, inputs, out_dir):
    """4 ranks: sharded maps (budgets 32 and 512), host collectives."""
    idx, batch, fld, cp, co, cs = _mapping_inputs(inputs)
    g, s, n_groups = world.layout(2)
    rows = batch["lengths_l"].shape[0] // n_groups
    mine = {k: v[g * rows:(g + 1) * rows] for k, v in batch.items()}
    single = {"codes": mine["codes_l"], "lengths": mine["lengths_l"]}
    dev, over = tsh.device_sharded_index(idx, world, 2)
    for budget in (32, 512):
        cfg = tsh.sharded_config(idx, over, seed_hits_per_end=budget)
        _save(out_dir, f"paired{budget}", world, _np(tsh.sharded_map_paired(
            world, mine, dev, cfg, over["shard_bits"], fld, cp, co)))
    _save(out_dir, "single", world, _np(tsh.sharded_map_single(
        world, single, dev, tsh.sharded_config(idx, over),
        over["shard_bits"], fld, cs)))

    rng = np.random.default_rng(100 + world.rank)
    # magnitudes far apart, so that the order of the sum shows
    hist = [rng.random((3, 4)) * 10.0 ** rng.integers(-8, 8, (3, 4)),
            rng.random(5) * 1e12, np.float64(rng.random() * 1e-9)]
    summed = distributed.allreduce_histograms(hist)
    n = [5, 0, 3, 7][world.rank]       # rank 1 has no eq row
    keys = rng.integers(0, 100, (n, 6 if n else 0)).astype(np.int32)
    counts, wsum = rng.random(n), rng.random((n, 6 if n else 0))
    k2, c2, w2 = distributed.allgather_eq_state(keys, counts, wsum)
    _save(out_dir, "host", world, {
        **{f"hist{i}": h for i, h in enumerate(hist)},
        **{f"sum{i}": h for i, h in enumerate(summed)},
        "keys": keys, "counts": counts, "wsum": wsum,
        "k2": k2, "c2": c2, "w2": w2,
        "vote_one": distributed.any_rank(world.rank == 2),
        "vote_none": distributed.any_rank(False)})


def _two_rank_worker(world, inputs, out_dir):
    """2 ranks: data-parallel map, sharded EM."""
    idx, batch, fld, cp, co, _ = _mapping_inputs(inputs)
    dev = tpipe.device_index_tensors(idx, "cpu")
    cfg = tpipe.MapperConfig.from_index(idx)
    rows = batch["lengths_l"].shape[0] // world.size
    mine = {k: v[world.rank * rows:(world.rank + 1) * rows]
            for k, v in batch.items()}
    _save(out_dir, "dp", world, _np(quant_step.merge_stats(
        world, tpipe.map_paired_batch(mine, dev, cfg, fld, cp, co))))
    z = {k: torch.from_numpy(v)
         for k, v in np.load(os.path.join(inputs, "em.npz")).items()}
    alpha, it, mrd = tem.run_em_sharded(
        world, z["labels"], z["seg"], z["counts"], z["aux"],
        z["class_sizes"], z["alpha0"], z["prior"], z["eff_lens"],
        int(z["num_txps"]), True, 0.01, 50, 1000)
    _save(out_dir, "em", world, {"alpha": alpha.numpy(), "iters": it,
                                 "mrd": mrd})


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs both packages map: the sample index (k 25), a 64-row
    batch of 48 simulated pairs, a prior FLD, and the eq classes of the
    batch for the EM."""
    inputs = str(tmp_path_factory.mktemp("inputs"))
    idx = build_index(FASTA, k=25)
    save_index(idx, os.path.join(inputs, "idx"))
    jidx = jb.build_index(FASTA, k=25)
    batch = {k: np.array(v) for k, v in
             _mk_batch(np.random.default_rng(8), jidx, n_pairs=48).items()}
    logpmf = FragmentLengthDistribution(
        max_val=JDEFAULTS.max_frag_length).log_pmf().astype(np.float32)
    np.savez(os.path.join(inputs, "batch.npz"), logpmf=logpmf, **batch)

    fmt = libformat.parse_library_format("IU")
    out = tpipe.map_paired_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        tpipe.device_index_tensors(idx, "cpu"),
        tpipe.MapperConfig.from_index(idx), torch.from_numpy(logpmf),
        torch.as_tensor(libformat.paired_compat_table(fmt)),
        torch.as_tensor(libformat.orphan_compat_table(fmt)))
    acc = EquivalenceClassAccumulator()
    acc.add_batch(out["eq_txp"].numpy(), out["eq_weight"].numpy(),
                  out["eq_bins"].numpy())
    eq = acc.finish()
    n = jidx.num_valid_targets
    eff = np.maximum(jidx.lengths[:n].astype(np.float64) - 150.0, 1.0)
    a0 = jem.initial_alphas(n, None, eq.num_fragments)
    pri = jem.prior_alphas(n, eff, 1e-2, True)
    np.savez(os.path.join(inputs, "em.npz"),
             labels=eq.labels.astype(np.int64),
             seg=np.repeat(np.arange(eq.num_classes), eq.class_sizes),
             counts=eq.counts.astype(np.float32),
             aux=eq.weights.astype(np.float32),
             class_sizes=eq.class_sizes.astype(np.int64),
             alpha0=a0.astype(np.float32), prior=pri.astype(np.float32),
             eff_lens=eff.astype(np.float32), num_txps=n)
    compat = tuple(jnp.asarray(t) for t in (
        libformat.paired_compat_table(fmt),
        libformat.orphan_compat_table(fmt),
        libformat.single_compat_table(fmt)))
    return inputs, jidx, batch, logpmf, compat, eq, eff, a0, pri


@pytest.fixture(scope="module")
def four_ranks(setup, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("four"))
    run_ranks(_four_rank_worker, 4, setup[0], out_dir)
    return out_dir


@pytest.fixture(scope="module")
def two_ranks(setup, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("two"))
    run_ranks(_two_rank_worker, 2, setup[0], out_dir)
    return out_dir


def _cat(per_rank: list, key: str):
    return np.concatenate([r[key] for r in per_rank])


def _untied(setup, **cfg):
    """Fragments of the batch without a tie on the top joined score
    (the port's single-device join under `cfg`)."""
    inputs, _, batch, *_ = setup
    idx = load_index(os.path.join(inputs, "idx"))
    return ~ttp.tied_top_rows(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        tpipe.device_index_tensors(idx, "cpu"),
        tpipe.MapperConfig.from_index(idx, **cfg))


def _assert_same_outputs(got_ranks, want, untied=None, skip=()):
    """Row outputs concatenated in rank order equal (the best hit where
    untied); summed statistics equal on every rank (txp_mass to rtol
    1e-5, fld_hist each to its own best hits)."""
    marks = set(tpipe.MARK_KEYS)
    assert set(got_ranks[0]) == set(want) | marks
    for key, w in want.items():
        w = np.asarray(w)
        if key in skip:
            continue
        if key in marks:
            # the port's single-device marks: per row in rank order, each
            # count the ranks' sum (marks are not summed over the world)
            got = (sum(r[key] for r in got_ranks) if key == "mark_counts"
                   else _cat(got_ranks, key))
            np.testing.assert_array_equal(got, w, err_msg=key)
            continue
        if key in ttp.BEST_KEYS:
            np.testing.assert_array_equal(_cat(got_ranks, key)[untied],
                                          w[untied], err_msg=key)
        elif key == "fld_hist" and "best_flen" in want:
            own = ttp.own_fld_hist({k: _cat(got_ranks, k) for k in
                                    ("best_flen", "best_is_paired")})
            np.testing.assert_array_equal(w, ttp.own_fld_hist(want))
            for r in got_ranks:
                np.testing.assert_array_equal(r[key], own)
        elif key in PSUM_KEYS:
            for r in got_ranks:
                if key == "txp_mass":
                    np.testing.assert_allclose(r[key], w, rtol=1e-5,
                                               atol=1e-6)
                else:
                    np.testing.assert_array_equal(r[key], w, err_msg=key)
        elif key == "eq_weight":
            np.testing.assert_allclose(_cat(got_ranks, key), w, rtol=1e-5)
        else:
            np.testing.assert_array_equal(_cat(got_ranks, key), w,
                                          err_msg=key)


@pytest.mark.parametrize("single", [False, True], ids=["paired", "single"])
def test_sharded_map_matches_jax_mesh(setup, four_ranks, single):
    _, jidx, batch, logpmf, (cp, co, cs), *_ = setup
    mesh = jsh.make_sharded_mesh(2, n_devices=4)
    assert dict(mesh.shape) == {"reads": 2, "kmer": 2}
    sdev, over = jsh.device_sharded_index(jidx, mesh)
    cfg = jsh.sharded_config(jidx, mesh, over)
    jb_ = {k: jnp.asarray(v) for k, v in batch.items()}
    if single:
        want = jsh.sharded_map_single(
            mesh, {"codes": jb_["codes_l"], "lengths": jb_["lengths_l"]},
            sdev, cfg, over["shard_bits"], jnp.asarray(logpmf), cs)
    else:
        want = jsh.sharded_map_paired(mesh, jb_, sdev, cfg,
                                      over["shard_bits"],
                                      jnp.asarray(logpmf), cp, co)
    got = _load(four_ranks, "single" if single else "paired32", 4)
    assert int(want["num_mapped"]) > 40
    _assert_same_outputs(got, want, _untied(setup, sparse_seed=True),
                         skip=("num_alns_below_threshold",))


@pytest.mark.parametrize("budget", [32, 512])
def test_sharded_map_matches_single_device(setup, four_ranks, budget):
    """At the default budget of 32 hits a read end, and at one no read
    end reaches (512), the 4-rank sharded map equals the port's
    single-device sparse map."""
    inputs, _, batch, logpmf, *_ = setup
    idx = load_index(os.path.join(inputs, "idx"))
    fmt = libformat.parse_library_format("IU")
    want = tpipe.map_paired_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        tpipe.device_index_tensors(idx, "cpu"),
        tpipe.MapperConfig.from_index(idx, sparse_seed=True,
                                      seed_hits_per_end=budget),
        torch.from_numpy(logpmf),
        torch.as_tensor(libformat.paired_compat_table(fmt)),
        torch.as_tensor(libformat.orphan_compat_table(fmt)))
    _assert_same_outputs(_load(four_ranks, f"paired{budget}", 4),
                         _np(want), np.ones(64, bool))


def test_parallel_map_matches_jax(setup, two_ranks):
    _, jidx, batch, logpmf, (cp, co, _), *_ = setup
    want = parallel_map_paired(
        make_mesh(2), {k: jnp.asarray(v) for k, v in batch.items()},
        jpipe.device_index_arrays(jidx), jpipe.MapperConfig.from_index(jidx),
        jnp.asarray(logpmf), cp, co)
    got = _load(two_ranks, "dp", 2)
    for k in ("num_processed", "num_mapped", "num_paired", "num_orphans",
              "fmt_hist"):
        for r in got:
            np.testing.assert_array_equal(r[k], np.asarray(want[k]), k)
    np.testing.assert_array_equal(_cat(got, "eq_txp"),
                                  np.asarray(want["eq_txp"]))
    for r in got:
        np.testing.assert_allclose(r["txp_mass"], np.asarray(
            want["txp_mass"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["fld_hist"], np.asarray(
            want["fld_hist"]), atol=2)


def test_run_em_sharded_matches_jax(setup, two_ranks):
    *_, eq, eff, a0, pri = setup
    eqd, _ = jem.pad_eqclasses(eq, pad_multiple=256)
    alpha, iters, _ = run_em_sharded(
        make_mesh(2), eqd, jnp.asarray(a0, jnp.float32),
        jnp.asarray(pri, jnp.float32), len(a0), True, 0.01, 50, 1000,
        eff_lens=jnp.asarray(eff, jnp.float32))
    for r in _load(two_ranks, "em", 2):
        assert int(r["iters"]) == int(iters)
        np.testing.assert_allclose(r["alpha"], np.asarray(alpha),
                                   rtol=1e-4, atol=1e-3)


def test_allreduce_histograms_bit_equal(four_ranks):
    ranks = _load(four_ranks, "host", 4)
    for i in range(3):
        want = np.stack([r[f"hist{i}"] for r in ranks]).sum(axis=0)
        for r in ranks:
            assert r[f"sum{i}"].dtype == np.float64
            np.testing.assert_array_equal(r[f"sum{i}"], want)


def test_allgather_eq_state_with_an_empty_rank(four_ranks):
    ranks = _load(four_ranks, "host", 4)
    assert ranks[1]["keys"].shape[0] == 0
    full = [r for r in ranks if r["keys"].size]
    want_k = np.concatenate([r["keys"] for r in full])
    for r in ranks:
        np.testing.assert_array_equal(r["k2"], want_k)
        np.testing.assert_array_equal(
            r["c2"], np.concatenate([x["counts"] for x in full]))
        np.testing.assert_array_equal(
            r["w2"], np.concatenate([x["wsum"] for x in full]))
        assert bool(r["vote_one"]) and not bool(r["vote_none"])


def test_layout_and_row_checks():
    """JAX's messages: a world that the shard count does not divide, and
    batch rows that it does not."""
    w = distributed.World(rank=0, size=3, device=torch.device("cpu"),
                          backend="gloo")
    with pytest.raises(ValueError, match="3 devices not divisible by 2 "
                                         "index shards"):
        w.layout(2)
    assert dataclasses.replace(w, size=4, rank=3).layout(2) == (1, 1, 2)
    with pytest.raises(ValueError, match="batch rows 5 not divisible"):
        tsh._check_rows(5, 2)
