"""The last compiled programs against their eager bodies, on the card.

    python -m salmon_tpu_torch.scripts.bench_graph_rest --index IDX \\
        -1 R1 -2 R2 --bam BAM --targets FASTA --config5-index DIR \\
        [--runs a,sharded2,config5] [--work DIR]

Three runs, each eager (the compiled entries swapped for their `*_impl`,
eager_steps) and graphed (one CUDA graph per signature, through
salmon_tpu_torch.utils.graphcache), REPS timed calls of each side in
turns, then one more of each under torch.profiler:
  a         `quant -a BAM -t FASTA -l A` through the CLI: the error
            model's five steps (alignment/errormodel_device.py)
  sharded2  `quant --indexShards 2` of the pairs on IDX in 2 processes
            sharing the card over gloo (this script with --rank): the
            sharded map step, its two graphs around the hit all-gather
            (parallel/sharded.py)
  config5   demo_config5_quant.quantify at 2 shards on the table-less
            index DIR: B1's shard_hits and B2's map_batch
Checked, or the run fails, graphed against eager on the same inputs in
the same process: the error model's keys and log-likelihoods exactly,
its count increments within rtol 1e-5 or within the rounding of a
float32 sum of their terms in another order (held_to_sum_order), on the
BAM's first batches; the sharded step's integer outputs exactly and its
float ones within rtol 1e-5, on each rank's first batches; config 5's
eq classes (labels, counts) exactly and their weights within rtol 1e-5;
every graphed run captured and replayed, and no eager run. A float is
held relative to a read (max |a - b| / max(|b|, 1)), and, as
scripts/bench_graph_post.py holds its loops, the masses and weights
within twice what two eager runs differ by where that is more: float
index_add_ adds in no fixed order on the card.
Measured per run and side: wall seconds of the run (the quant's, or
quantify's; the median of its timed calls, and each), the seconds of
the graphed part (errmodel_seconds;
map_seconds less the shard build, the slowest rank's; B1 + B2), device
busy seconds and host-issued launches from the profiled call, launches a
batch and the idle share (1 - busy / wall); the graph caches' counters
(signatures, eager, captures, replays, capture seconds, pool bytes).
One JSON line a run, then the card's name and power limit and a last
JSON line of all runs. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from salmon_tpu_torch.scripts import require_device
from salmon_tpu_torch.scripts.bench_graph_step import LAUNCH_APIS
from salmon_tpu_torch.utils.graphcache import stats_totals

RUNS = ("a", "sharded2", "config5")
# the checkout's root, where a rank process imports the package from
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RTOL = 1e-5
CHECK_BATCHES = 4      # batches each step is held to its eager body on
CONFIG5_SHARDS = 2
# timed calls of each side a run, in turns (a sharded2 or config5 call
# takes 5-8 s, an `-a` call 1-2 s)
REPS = {"a": 3, "sharded2": 1, "config5": 1}
RANK_TIMEOUT = 600     # seconds for the two ranks of sharded2
GRAPH_KEYS = ("signatures", "eager", "captures", "replays",
              "capture_seconds", "pool_bytes")


def rel_diff(a, b) -> float:
    """max |a - b| / max(|b|, 1) (0 for empty inputs)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max())


def held_to_eager(name: str, graph, eager, eager2) -> tuple:
    """(graph against eager, eager against eager), relative to a read;
    fails unless the first is within RTOL or twice the second."""
    got, spread = rel_diff(graph, eager), rel_diff(eager2, eager)
    if got > max(RTOL, 2 * spread):
        raise AssertionError(f"{name}: graph against eager {got!r}, eager "
                             f"against eager {spread!r}")
    return got, spread


def held_to_sum_order(name: str, got, want, terms) -> float:
    """Float32 sums of nonnegative terms added in another order (float
    index_add_ adds in no fixed order on the card): each within RTOL of
    a read, or within 8 sqrt(n) 2^-24 of itself, n its terms (the
    rounding of a sum in a random order; measured, eager against eager
    runs differ by up to 1.4e-5 of a read). Returns the largest
    difference relative to a read."""
    got, want = got.double().cpu(), want.double().cpu()
    lim = torch.maximum(RTOL * want.abs().clamp(min=1.0),
                        8 * terms.double().cpu().sqrt() * 2.0**-24
                        * want.abs())
    if ((got - want).abs() > lim).any():
        raise AssertionError(f"{name}: graph against eager beyond the "
                             f"order of a float32 sum: "
                             f"{rel_diff(got, want)!r}")
    return rel_diff(got, want)


def _drop(impl, *names):
    """impl without the compiled entry's keyword arguments `names`."""
    def run(*args, **kwargs):
        for n in names:
            kwargs.pop(n, None)
        return impl(*args, **kwargs)
    return run


@contextlib.contextmanager
def eager_steps():
    """The compiled entries of the error model, of the quant's sharded
    step and of config 5 swapped for their eager bodies (`*_impl`, no
    graph cache)."""
    from salmon_tpu_torch import quant
    from salmon_tpu_torch.alignment import errormodel_device as emd
    from salmon_tpu_torch.parallel import sharded as tsh
    from salmon_tpu_torch.scripts import demo_config5_quant as demo

    swaps = [(emd, name, _drop(getattr(emd, f"{name}_impl"), "cache",
                               "mate"))
             for name in ("expand_fused", "ll_keys", "update_keys",
                          "count_update", "log_likelihood_rows")]
    swaps += [(quant, f"sharded_map_{k}",
               _drop(getattr(tsh, f"sharded_map_{k}_impl"), "in_flight"))
              for k in ("paired", "single")]
    swaps += [(demo, "shard_hits", _drop(demo.shard_hits_impl, "cache")),
              (demo, "map_batch", _drop(demo.map_batch_impl, "cache"))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def profiled(fn) -> tuple:
    """(fn()'s result, {busy_s, host_launches}) of fn() under
    torch.profiler: the device's busy seconds and the host-issued
    launches (kernels, graph launches, copies, memsets)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    busy = sum(e.duration_ns() for e in events
               if e.device_type() == DeviceType.CUDA
               and not e.name().startswith("loop step:")) / 1e9
    launches = sum(1 for e in events if e.name() in LAUNCH_APIS)
    return out, {"busy_s": busy, "host_launches": launches}


class Clocks(logging.Handler):
    """The stage clocks the port logs (extra={"clocks": {...}})."""

    def __init__(self):
        super().__init__()
        self.clocks = {}

    def emit(self, record):
        self.clocks.update(getattr(record, "clocks", {}))


def cli_quant(argv: list) -> tuple:
    """(seconds, clocks) of `quant ARGV -q` through the CLI."""
    from salmon_tpu_torch import cli

    clocks = Clocks()
    log = logging.getLogger("salmon_tpu_torch")
    log.addHandler(clocks)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cli.main(["quant", *argv, "-q"]) != 0:
            raise AssertionError(f"quant {' '.join(argv)} failed")
        torch.cuda.synchronize()
        return time.perf_counter() - t0, clocks.clocks
    finally:
        log.removeHandler(clocks)


def sides(call, reps: int) -> dict:
    """call(eager: bool) -> (result, wall, graphed part's seconds, graph
    counters): `reps` calls of each side, eager and graphed in turns (the
    medians and every call's seconds), then one more of each profiled.
    Returns {side: record} with each side's first and profiled results
    under "_outs" and its first call's graph counters."""
    recs = {side: {"walls_s": [], "parts_s": [], "_outs": []}
            for side in ("eager", "graph")}
    for profile in [False] * reps + [True]:
        for eager in (True, False):
            r = recs["eager" if eager else "graph"]
            with eager_steps() if eager else contextlib.nullcontext():
                if profile:
                    (out, *_), p = profiled(lambda: call(eager))
                    r["_outs"].append(out)
                    r.update(p)
                    continue
                out, wall, part, graphs = call(eager)
            if not r["_outs"]:
                r["_outs"].append(out)
                r.update(graphs)
            r["walls_s"].append(wall)
            r["parts_s"].append(part)
    for r in recs.values():
        r["wall_s"] = float(np.median(r["walls_s"]))
        r["part_s"] = float(np.median(r["parts_s"]))
    return recs


def finish(rec: dict, batches: int) -> dict:
    """Launches a batch and idle shares into rec; fails unless the graphed
    side captured and replayed and the eager side ran no graph."""
    rec["batches"] = batches
    for side in ("eager", "graph"):
        r = rec[side]
        r.pop("_outs", None)
        r["launches_per_batch"] = r["host_launches"] / max(batches, 1)
        r["idle"] = 1.0 - r["busy_s"] / r["wall_s"]
    g, e = rec["graph"], rec["eager"]
    if not (g.get("captures", 0) >= 1 and g.get("replays", 0) > 0):
        raise AssertionError(f"{rec['run']}: graph counters {g}")
    if e.get("captures", 0) or e.get("replays", 0):
        raise AssertionError(f"{rec['run']}: the eager run replayed {e}")
    return rec


# --- a -----------------------------------------------------------------

def errmodel_check(bam: str, targets: str, device, n: int = CHECK_BATCHES,
                   batch_records: int | None = None) -> dict:
    """The five steps through a model's graphs against their eager bodies
    on the same inputs, on the BAM's first n batches (of the reader's
    size, or of batch_records; the -a quant's fused calls, then the
    per-mate ones), the model trained by the graphed updates as it goes:
    keys and log-likelihoods exactly, count increments as
    held_to_sum_order holds them (and, for the record, two eager runs'
    difference)."""
    from salmon_tpu_torch.alignment import errormodel_device as emd
    from salmon_tpu_torch.alignment import quant as aq
    from salmon_tpu_torch.alignment.bamio import BamReader

    names, tlens, records = aq._load_targets(targets)
    shim = aq._targets_index(names, tlens, records)
    model = emd.DeviceAlignmentErrorModel(shim.seq_codes, shim.seq_offsets,
                                          tlens, device=device)
    rdr = (BamReader(bam) if batch_records is None
           else BamReader(bam, batch_records=batch_records))
    ref_map = np.arange(len(names), dtype=np.int64)
    grid = ("ops", "oplens", "rseq", "rlen", "toff", "pos", "tlen")
    worst = dict.fromkeys(("count_update", "count_update_eager",
                           "update_keys", "update_keys_eager"), 0.0)
    exact = 0
    for i, b in zip(range(n), rdr.batches()):
        g = aq._group_fragments(b, True)
        keep = np.nonzero(g[1])[0]
        sel = np.concatenate([g[8][keep], g[9][keep]])
        p, _, m = model._pack_padded(b, sel, ref_map)
        args = [p[k] for k in grid]
        mate = torch.zeros(args[0].shape[0], dtype=torch.int32,
                           device=device)
        mate[m // 2:m] = 1
        model.normalize()
        lp2 = (model._logp.reshape(-1), model._lp_bg.reshape(-1))
        w = torch.rand(args[0].shape[0], generator=torch.Generator(
            device).manual_seed(i), device=device)
        pairs = [
            ("expand_fused", emd.expand_fused(*args, mate, model.seq_codes,
                                              cache=model.graphs),
             emd.expand_fused_impl(*args, mate, model.seq_codes))]
        keys = pairs[0][1].clone()
        pairs.append(("ll_keys", emd.ll_keys(keys, *lp2, cache=model.graphs),
                      emd.ll_keys_impl(keys, *lp2)))
        for mt in (0, 1):
            lp = (model._logp[mt].reshape(-1), model._lp_bg[mt])
            pairs.append(("log_likelihood_rows", emd.log_likelihood_rows(
                *args, *lp, model.seq_codes, cache=model.graphs, mate=mt),
                emd.log_likelihood_rows_impl(*args, *lp, model.seq_codes)))
        upd = emd.update_keys(keys, w, cache=model.graphs)
        cnt = emd.count_update(*args, w, model.seq_codes,
                               cache=model.graphs, mate=1)
        for name, got, want in pairs:
            if not torch.equal(got, want):
                raise AssertionError(f"-a {name}: graph and eager differ "
                                     f"on batch {i}")
            exact += 1
        key1, _ = emd.expand_keys(*args, model.seq_codes)
        for name, got, want, want2, k, n_flat in (
                ("update_keys", upd, emd.update_keys_impl(keys, w),
                 emd.update_keys_impl(keys, w), keys, 2 * emd.N_FLAT),
                ("count_update", cnt, emd.count_update_impl(
                    *args, w, model.seq_codes), emd.count_update_impl(
                    *args, w, model.seq_codes), key1, emd.N_FLAT)):
            # the columns each count adds up
            terms = torch.bincount(k.reshape(-1), minlength=n_flat + 1)
            d = held_to_sum_order(f"-a {name}, batch {i}", got, want,
                                  terms[:n_flat].reshape(want.shape))
            worst[name] = max(worst[name], d)
            worst[f"{name}_eager"] = max(worst[f"{name}_eager"],
                                         rel_diff(want2.cpu(), want.cpu()))
        model.counts += upd
    rdr.close()
    return {"exact_outputs": exact, "max_rel_diff": worst,
            "graphs": stats_totals(model.graphs.stats.values())}


def a_run(bam: str, targets: str, tmp: str, device) -> dict:
    from salmon_tpu_torch.alignment.bamio import BamReader

    check = errmodel_check(bam, targets, device)
    rdr = BamReader(bam)
    batches = sum(1 for _ in rdr.batches())
    rdr.close()
    outs = {}

    def call(eager):
        out = os.path.join(tmp, f"a_{'eager' if eager else 'graph'}")
        sec, clocks = cli_quant(["-a", bam, "-t", targets, "-l", "A",
                                 "-o", out])
        outs.setdefault(eager, out)
        graphs = {k: clocks[f"errmodel_graph_{k}"] for k in GRAPH_KEYS}
        return out, sec, clocks["errmodel_seconds"], graphs

    rec = {"run": "a", "check": check}
    rec.update(sides(call, REPS["a"]))
    rec["numreads_rel_diff"] = rel_diff(_numreads(outs[False]),
                                        _numreads(outs[True]))
    return finish(rec, batches)


def _numreads(out_dir: str) -> np.ndarray:
    with open(os.path.join(out_dir, "quant.sf")) as fh:
        next(fh)
        return np.array([float(ln.split("\t")[4]) for ln in fh])


# --- sharded2 ----------------------------------------------------------

def _outputs_close(name: str, got: dict, want: dict, want2: dict) -> tuple:
    """Integer outputs equal, float ones as held_to_eager holds them (want2:
    a second eager run); the largest float differences, graph against
    eager and eager against eager."""
    if set(got) != set(want):
        raise AssertionError(f"{name}: keys {sorted(got)} {sorted(want)}")
    worst = (0.0, 0.0)
    for k in want:
        if want[k].is_floating_point():
            d = held_to_eager(f"{name} {k}", got[k].cpu(), want[k].cpu(),
                              want2[k].cpu())
            worst = tuple(map(max, worst, d))
        elif not torch.equal(got[k], want[k]):
            raise AssertionError(f"{name} {k}: graph and eager differ")
    return worst


def sharded_check(world, index, r1: str, r2: str,
                  n: int = CHECK_BATCHES) -> dict:
    """The sharded step's two graphs against its eager body on this
    rank's first n batches (both ranks in the same order)."""
    from salmon_tpu_torch.constants import DEFAULTS
    from salmon_tpu_torch.io.fastq import iter_paired_chunks
    from salmon_tpu_torch.mapping.pipeline import graph_stats
    from salmon_tpu_torch.models.fld import FragmentLengthDistribution
    from salmon_tpu_torch.parallel import sharded as tsh
    from salmon_tpu_torch.utils import libformat

    dev_t = world.device
    dev, over = tsh.device_sharded_index(index, world, 2)
    cfg = tsh.sharded_config(index, over)
    fmt = libformat.parse_library_format("IU")
    compat = tuple(torch.as_tensor(t, device=dev_t) for t in (
        libformat.paired_compat_table(fmt),
        libformat.orphan_compat_table(fmt)))
    fld = FragmentLengthDistribution(DEFAULTS.max_frag_length)
    fld_in = {"logpmf": torch.as_tensor(fld.log_pmf(), dtype=torch.float32,
                                        device=dev_t),
              "logcmf": torch.as_tensor(fld.log_cmf(), dtype=torch.float32,
                                        device=dev_t), "mode": 0}
    worst, done = (0.0, 0.0), 0
    chunks = iter_paired_chunks([r1], [r2], DEFAULTS.reads_per_batch,
                                DEFAULTS.max_read_len)
    for i, c in zip(range(n), chunks):
        done += 1
        b = {k: torch.from_numpy(v).to(dev_t) for k, v in (
            ("codes_l", c.left.codes), ("lengths_l", c.left.lengths),
            ("codes_r", c.right.codes), ("lengths_r", c.right.lengths))}
        want, want2 = (tsh.sharded_map_paired_impl(
            world, b, dev, cfg, over["shard_bits"], fld_in, *compat)
            for _ in range(2))
        got = tsh.sharded_map_paired(world, b, dev, cfg, over["shard_bits"],
                                     fld_in, *compat)
        worst = tuple(map(max, worst, _outputs_close(
            f"sharded2 batch {i}", got, want, want2)))
    return {"batches": done, "max_float_rel_diff": worst[0],
            "max_float_rel_diff_eager": worst[1],
            "graphs": stats_totals(graph_stats(dev))}


def rank_main(out_json: str, index_dir: str, r1: str, r2: str,
              work: str) -> int:
    """One rank of sharded2 (started by sharded_run with the launch
    variables): the step check, then the quant eager and graphed."""
    from salmon_tpu_torch.index.builder import load_index
    from salmon_tpu_torch.parallel import distributed

    world = distributed.init_from_env()
    check = sharded_check(world, load_index(index_dir), r1, r2)
    outs = {}

    def call(eager):
        out = os.path.join(work, f"sharded2_{'eager' if eager else 'graph'}")
        sec, clocks = cli_quant(["-i", index_dir, "-l", "A", "-1", r1,
                                 "-2", r2, "--indexShards", "2", "-o", out])
        outs.setdefault(eager, out)
        graphs = {k: clocks[f"graph_{k}"] for k in GRAPH_KEYS}
        part = clocks["map_seconds"] - clocks.get("shard_build_seconds", 0.0)
        return clocks["mapped_batches"], sec, part, graphs

    rec = {"rank": world.rank, "device": str(world.device),
           "backend": world.backend, "check": check}
    rec.update(sides(call, REPS["sharded2"]))
    rec["batches"] = rec["graph"].pop("_outs")[0]
    rec["eager"].pop("_outs")
    if world.rank == 0:
        rec["numreads_rel_diff"] = rel_diff(_numreads(outs[False]),
                                            _numreads(outs[True]))
    with open(out_json, "w") as fh:
        json.dump(rec, fh)
    return 0


def sharded_run(index_dir: str, r1: str, r2: str, tmp: str) -> dict:
    """sharded2: two processes of this script (--rank) sharing the first
    card over gloo; the slowest rank's numbers."""
    from salmon_tpu_torch.parallel import distributed
    from salmon_tpu_torch.parallel.launch import free_port

    port = free_port()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    procs = []
    for pid in range(2):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=visible,
                   **{distributed.ENV_COORD: f"127.0.0.1:{port}",
                      distributed.ENV_NPROC: "2",
                      distributed.ENV_PID: str(pid)})
        out = os.path.join(tmp, f"rank{pid}.json")
        log = open(os.path.join(tmp, f"rank{pid}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "salmon_tpu_torch.scripts.bench_graph_rest",
             "--rank", out, "--index", index_dir, "-1", r1, "-2", r2,
             "--work", tmp], env=env, stdout=log, stderr=subprocess.STDOUT,
            cwd=REPO), out, log))
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p, _, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p, _, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    for pid, (p, out, log) in enumerate(procs):
        if p.returncode != 0:
            with open(log.name) as fh:
                tail = fh.read()[-4000:]
            raise AssertionError(f"sharded2 rank {pid}: exit code "
                                 f"{p.returncode}\n{tail}")
    ranks = []
    for _, out, _ in procs:
        with open(out) as fh:
            ranks.append(json.load(fh))
    rec = {"run": "sharded2", "ranks": ranks,
           "numreads_rel_diff": ranks[0]["numreads_rel_diff"],
           "check": [r["check"] for r in ranks]}
    for side in ("eager", "graph"):
        slow = max(ranks, key=lambda r: r[side]["wall_s"])
        rec[side] = dict(slow[side], rank=slow["rank"])
    return finish(rec, ranks[0]["batches"])


# --- config5 -------------------------------------------------------------

def config5_run(decoy_idx: str, r1: str, r2: str, max_frags: int,
                device) -> dict:
    from salmon_tpu_torch.scripts import demo_config5_quant as demo

    def call(eager):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = demo.quantify(decoy_idx, r1, r2, CONFIG5_SHARDS, max_frags,
                            device)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        s = run.seconds
        graphs = {k: s[f"b1_graph_{k}"] + s[f"b2_graph_{k}"]
                  for k in GRAPH_KEYS}
        graphs["b1"] = {k: s[f"b1_graph_{k}"] for k in GRAPH_KEYS}
        graphs["b2"] = {k: s[f"b2_graph_{k}"] for k in GRAPH_KEYS}
        return run, sec, s["b1_s"] + s["b2_s"], graphs

    rec = {"run": "config5", "shards": CONFIG5_SHARDS}
    rec.update(sides(call, REPS["config5"]))
    (e, e2), (g, _) = rec["eager"]["_outs"], rec["graph"]["_outs"]
    for f in ("labels", "offsets", "counts"):
        if not np.array_equal(getattr(g.eq, f), getattr(e.eq, f)):
            raise AssertionError(f"config5 eq {f}: graph and eager differ")
    d, spread = held_to_eager("config5 eq weights", g.eq.weights,
                              e.eq.weights, e2.eq.weights)
    rec["check"] = {"eq_classes": int(e.eq.num_classes),
                    "eq_weights_rel_diff": d,
                    "eq_weights_eager_rel_diff": spread,
                    "alphas_rel_diff": rel_diff(g.alphas, e.alphas),
                    "n_frags": e.report["n_frags"]}
    return finish(rec, -(-e.report["n_frags"] // demo.R))


def run(runs, index_dir: str, r1: str, r2: str, bam: str, targets: str,
        config5_index: str, work: str | None = None,
        device="cuda") -> list:
    """The records of each run (see the module's text)."""
    device = require_device(device, "bench_graph_rest")
    if device.type != "cuda":
        raise RuntimeError("bench_graph_rest measures the card's graphs")
    recs = []
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        for name in runs:
            t0 = time.perf_counter()
            if name == "a":
                recs.append(a_run(bam, targets, tmp, device))
            elif name == "sharded2":
                recs.append(sharded_run(index_dir, r1, r2, tmp))
            elif name == "config5":
                recs.append(config5_run(config5_index, r1, r2, 10**9,
                                        device))
            else:
                raise ValueError(f"no run {name!r}: {', '.join(RUNS)}")
            recs[-1]["run_seconds"] = time.perf_counter() - t0
    return recs


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m salmon_tpu_torch.scripts.bench_graph_rest")
    ap.add_argument("--index", required=True)
    ap.add_argument("-1", dest="r1", required=True)
    ap.add_argument("-2", dest="r2", required=True)
    ap.add_argument("--bam")
    ap.add_argument("--targets")
    ap.add_argument("--config5-index")
    ap.add_argument("--runs", default=",".join(RUNS))
    ap.add_argument("--work", default=None)
    ap.add_argument("--rank", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    os.environ.setdefault("SALMON_NO_VERSION_CHECK", "1")
    if args.rank:
        return rank_main(args.rank, args.index, args.r1, args.r2,
                         args.work or tempfile.gettempdir())
    runs = args.runs.split(",")
    if set(runs) - set(RUNS):
        ap.error(f"--runs takes {','.join(RUNS)}")
    if "a" in runs and not (args.bam and args.targets):
        ap.error("the a run needs --bam and --targets")
    if "config5" in runs and not args.config5_index:
        ap.error("the config5 run needs --config5-index")
    require_device(device, "bench_graph_rest")
    recs = run(runs, args.index, args.r1, args.r2, args.bam, args.targets,
               args.config5_index, args.work, device)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"graph_rest": recs,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
