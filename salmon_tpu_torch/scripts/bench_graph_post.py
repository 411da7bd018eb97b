"""The post-mapping loops against their CUDA graphs, on the card.

    python -m salmon_tpu_torch.scripts.bench_graph_post --index IDX \\
        -1 R1 -2 R2 [--draws 16] [--steps em,em-fixture,...]

A paired quant with --seqBias --gcBias of the reads on the index gives
the loops their inputs: its eq classes, effective lengths, counts and
bias state. Each step then runs eagerly (its `*_impl` without a graph
cache) and through its entry, whose loop replays CUDA graphs captured in
the call (salmon_tpu_torch.utils.graphcache: the first step of a loop
eager, the second captured, the rest replayed), each REPS times in
turns, then once more each under torch.profiler:
  em          run_em on the quant's eq classes as the paired quant
              runs it (VBEM, the default tolerance, 50 to 10,000
              iterations, the per-iteration rule below 65,536 entries),
              from uniform starting alphas
  em-fixture  run_em on the harness's 964,064-entry fixture
              (bench.em_fixture; VBEM, tolerance 1e-2, the chunked rule)
  bootstrap   bootstrap_samples, `draws` replicates
  gibbs       gibbs_samples, `draws` samples, thinning 16, prior 1.0
  bias        BiasState.corrected_effective_lengths: the expected and the
              efflen pass over every bucket
Checked, or the run fails: the graph stops at the eager run's iteration
count unless two eager runs differ in it; its outputs lie within rtol
1e-5 of the eager run's (relative to a read and more: max |a - b| /
max(|b|, 1)), or within twice what two eager runs differ by where that
is more (float32 index_add_ adds in no fixed order on the card); the
Gibbs draws are integral, each sample sums to the eq classes' total, and
two calls at one seed draw the same; every graphed step captured once
and replayed.
Measured per step: wall seconds of a call (host clock ended by a
synchronize; a call's capture included; the median of REPS calls of
each side, eager and graphed in turns), device busy seconds and
host-issued launches of a call and the idle share (1 - busy / wall) from
a profiled call of each side (these come after every step's timed
calls), host-issued launches per unit of the loop (an
iteration, a Gibbs round, a sampled fragment length) in its steps (the
graphcache.STEP_SCOPES of the trace: eager steps in the eager call,
replayed ones in the graphed call), iterations and masked iterations,
capture seconds and pool bytes, the bytes the allocator's reserve grew
by at its peak in the first eager and the first graphed call, and the
loops' graph pool (graphcache.loop_graphs) after the step; the bias
step also holds the quant's own (its passes' graph counters, the loops'
pool after it, the process's peak reserve). One JSON line a step, then
the card's name and power limit and a last JSON line of all steps.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from salmon_tpu_torch.scripts import require_device
from salmon_tpu_torch.scripts.bench_graph_step import LAUNCH_APIS

STEPS = ("em", "em-fixture", "bootstrap", "gibbs", "bias")
RTOL = 1e-5
REPS = 3               # timed calls of each side of a step, in turns
GIBBS_THINNING = 16


def rel_diff(a, b) -> float:
    """max |a - b| / max(|b|, 1) (0 for empty inputs)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max())


def check_close(name: str, graph, eager, eager2) -> dict:
    """The graph's outputs against the eager run's, with two eager runs'
    own difference as the yardstick where it exceeds RTOL."""
    got, spread = rel_diff(graph, eager), rel_diff(eager2, eager)
    if got > max(RTOL, 2 * spread):
        raise AssertionError(f"{name}: graph against eager {got!r}, eager "
                             f"against eager {spread!r}")
    return {"graph_vs_eager": got, "eager_vs_eager": spread}


def check_iterations(name: str, graph: int, eager: int, eager2: int):
    if graph != eager and eager2 == eager:
        raise AssertionError(f"{name}: the graph stopped after {graph} "
                             f"iterations, two eager runs after {eager}")


def timed(fn):
    """(fn()'s result, seconds to it, ended by a synchronize, and the
    bytes the allocator's reserve grew by at its peak in the call)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_reserved() - base)


def profiled(fn, unit_per_step: int, scope: str) -> dict:
    """fn() under torch.profiler: device busy seconds, host-issued
    launches, and the launches inside the trace's `scope` steps
    (graphcache.STEP_SCOPES) per unit, a step holding unit_per_step
    units."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from salmon_tpu_torch.utils.graphcache import STEP_SCOPES

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the trace's raw events: prof.events() would build a Python object
    # and a tree for each of the eager loops' ~10^5 events, for seconds
    events = prof.profiler.kineto_results.events()
    # a scope is traced twice: on the host, and as an annotation over the
    # device's work (not device time of its own)
    names = set(STEP_SCOPES.values())
    busy = sum(e.duration_ns() for e in events
               if e.device_type() == DeviceType.CUDA
               and e.name() not in names) / 1e9
    starts = sorted(e.start_ns() for e in events
                    if e.name() in LAUNCH_APIS)
    scopes = [(e.start_ns(), e.end_ns()) for e in events
              if e.name() == STEP_SCOPES[scope]
              and e.device_type() == DeviceType.CPU]
    in_scope = sum(bisect.bisect_right(starts, end)
                   - bisect.bisect_left(starts, start)
                   for start, end in scopes)
    return {"busy_s": busy, "host_launches": len(starts),
            "steps": len(scopes),
            "launches_per_unit": (in_scope / (len(scopes) * unit_per_step)
                                  if scopes else None)}


def ab(name: str, eager_fn, graph_fn, unit: str, per_step: int) -> tuple:
    """Eager and graphed calls in turns, REPS of each, timed; a step of
    the loop holds per_step units. The profiled calls wait for
    profile_record, after every step's timed ones. Returns the record's
    common part and the first two outputs of each side."""
    outs = {"eager": [], "graph": []}
    walls = {"eager": [], "graph": []}
    growth = {}
    for _ in range(REPS):
        for side, fn in (("eager", eager_fn), ("graph", graph_fn)):
            out, sec, grown = timed(fn)
            if len(outs[side]) < 2:
                outs[side].append(out)
            walls[side].append(sec)
            growth.setdefault(side, grown)
    rec = {"step": name, "unit": unit,
           "_profile": (eager_fn, graph_fn, per_step)}
    for side in ("eager", "graph"):
        w = walls[side]
        rec[side] = {"wall_s": float(np.median(w)), "walls_s": w,
                     "reserved_growth": growth[side]}
    return rec, (*outs["eager"], *outs["graph"])


def profile_record(rec: dict) -> None:
    """The record's eager and graphed call once more each, profiled: its
    device busy seconds, host-issued launches and idle share (against
    the median wall); fails unless the graph's host-issued launches a
    unit are below a tenth of eager's."""
    eager_fn, graph_fn, per_step = rec.pop("_profile")
    for side, fn, scope in (("eager", eager_fn, "eager"),
                            ("graph", graph_fn, "replay")):
        p = profiled(fn, per_step, scope)
        rec[side].update(p, idle=1.0 - p["busy_s"] / rec[side]["wall_s"])
    le = rec["eager"]["launches_per_unit"]
    lg = rec["graph"]["launches_per_unit"]
    if not lg or not le or lg >= le / 10:
        raise AssertionError(f"{rec['step']}: host-issued launches a "
                             f"{rec['unit']}: eager {le}, graph {lg}")


def graph_counts(rec: dict, g: dict) -> None:
    """The graph cache's counters of the graphed call into rec; fails
    unless it captured and replayed."""
    rec["graph"].update({k: g[k] for k in ("signatures", "eager",
                                           "captures", "replays",
                                           "capture_seconds",
                                           "pool_bytes")})
    if not (g["captures"] >= 1 and g["replays"] > 0):
        raise AssertionError(f"{rec['step']}: graph counters {g}")


def em_inputs(eq, eff: np.ndarray, n: int, device, use_vbem: bool,
              tol: float, min_iter: int, max_iter: int) -> tuple:
    """run_em's arguments for eq classes, as em.optimize puts them on the
    device: uniform starting alphas, the default prior."""
    from salmon_tpu_torch.inference import em

    cfg = em.EMConfig()
    seg = np.repeat(np.arange(eq.num_classes), eq.class_sizes)

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return (put(eq.labels, torch.int64), put(seg, torch.int64),
            put(eq.counts), put(eq.weights), put(eq.class_sizes,
                                                 torch.int64),
            put(em.initial_alphas(n, None, eq.num_fragments)),
            put(em.prior_alphas(n, eff, cfg.vb_prior,
                                cfg.per_transcript_prior)),
            put(eff), n, use_vbem, tol, min_iter, max_iter)


def em_step(name: str, args: tuple) -> dict:
    from salmon_tpu_torch.inference import em

    K = em.EM_GRAPH_CHUNK
    stats = {}

    def eager():
        return em.run_em_impl(*args)

    def graph():
        return em.run_em(*args, stats=stats)

    rec, (e1, e2, g1, g2) = ab(name, eager, graph, "iteration", K)
    check_iterations(name, g1[1], e1[1], e2[1])
    check_iterations(name, g2[1], e1[1], e2[1])
    rec.update(entries=int(args[0].shape[0]),
               iterations={"eager": e1[1], "eager2": e2[1], "graph": g1[1],
                           "graph2": g2[1]},
               masked_iterations=stats["masked_iterations"])
    if g1[1] == e1[1]:
        rec["max_diff"] = check_close(name, g1[0].cpu(), e1[0].cpu(),
                                      e2[0].cpu())
    graph_counts(rec, stats["graph"])
    return rec


def bootstrap_step(res, n: int, draws: int, device) -> dict:
    from salmon_tpu_torch.constants import DEFAULTS
    from salmon_tpu_torch.inference import em, sampling

    kw = dict(use_vbem=True, vb_prior=DEFAULTS.vb_prior,
              per_transcript_prior=True, device=device)
    routed = res.eq_classes.labels.shape[0] >= sampling.ROUTED_MIN_ENTRIES
    per_step = em.EM_GRAPH_CHUNK if routed else sampling.BOOT_GRAPH_CHUNK
    runs = {"eager": [], "graph": []}

    def call(kind, fn):
        st = {}
        out = fn(res.eq_classes, n, res.eff_lens, draws, stats=st, **kw)
        runs[kind].append(st)
        return out

    rec, (e1, e2, g1, g2) = ab(
        "bootstrap", lambda: call("eager", sampling.bootstrap_samples_impl),
        lambda: call("graph", sampling.bootstrap_samples), "iteration",
        per_step)
    (st_e, st_e2, *_), (st_g, st_g2, *_) = runs["eager"], runs["graph"]
    for st in (st_g, st_g2):
        check_iterations("bootstrap", st["iterations"],
                         st_e["iterations"], st_e2["iterations"])
    total = float(res.eq_classes.counts.sum())
    dev = float(np.abs(g1.sum(axis=1) / total - 1.0).max())
    if dev > 1e-3:
        raise AssertionError(f"bootstrap: a replicate's total is {dev!r} "
                             f"off the eq classes' {total}")
    rec.update(iterations={"eager": st_e["iterations"],
                           "eager2": st_e2["iterations"],
                           "graph": st_g["iterations"],
                           "graph2": st_g2["iterations"]},
               masked_iterations=st_g["masked_iterations"], draws=draws,
               largest_total_deviation=dev)
    if st_g["iterations"] == st_e["iterations"]:
        rec["max_diff"] = check_close("bootstrap", g1, e1, e2)
    graph_counts(rec, st_g["graph"])
    return rec


def gibbs_step(res, n: int, draws: int, device) -> dict:
    from salmon_tpu_torch.inference import sampling

    kw = dict(thinning=GIBBS_THINNING, prior=1.0, seed=271828,
              device=device)
    stats = {}

    def eager():
        return sampling.gibbs_samples_impl(res.eq_classes, n, res.eff_lens,
                                           res.counts, draws, **kw)

    def graph():
        return sampling.gibbs_samples(res.eq_classes, n, res.eff_lens,
                                      res.counts, draws, stats=stats, **kw)

    rec, (e1, e2, g1, g2) = ab("gibbs", eager, graph, "round",
                               GIBBS_THINNING)
    total = float(res.eq_classes.counts.sum())
    for name, s in (("eager", e1), ("graph", g1)):
        if not ((s == np.round(s)).all()
                and (s.sum(axis=1) == total).all()):
            raise AssertionError(f"gibbs: {name} draws not integral or "
                                 f"not summing to {total}")
    if not (np.array_equal(g1, g2) and np.array_equal(e1, e2)):
        raise AssertionError("gibbs: two calls at one seed drew apart")
    rec.update(draws=draws, rounds=stats["rounds"],
               draws_equal_to_eager=bool(np.array_equal(g1, e1)),
               mean_rel_diff_to_eager=rel_diff(g1.mean(axis=0),
                                               e1.mean(axis=0)))
    graph_counts(rec, stats["graph"])
    return rec


def _eager(impl):
    """impl without a graph cache, in place of the compiled entry that
    BiasState calls (whose `stats` it ignores)."""
    def run(*args, stats=None, **kwargs):
        return impl(*args, **kwargs)
    return run


@contextlib.contextmanager
def eager_bias_passes():
    """BiasState's passes through the eager bodies (the *_impl, no
    graph cache)."""
    from salmon_tpu_torch.models import bias_expected as BE

    saved = BE.expected_pass_bucket, BE.efflen_pass_bucket
    BE.expected_pass_bucket = _eager(BE.expected_pass_bucket_impl)
    BE.efflen_pass_bucket = _eager(BE.efflen_pass_bucket_impl)
    try:
        yield
    finally:
        BE.expected_pass_bucket, BE.efflen_pass_bucket = saved


def bias_step(index, res, quant: dict) -> dict:
    from salmon_tpu_torch.models.efflen import effective_lengths

    state = res.bias
    n = index.num_valid_targets
    pmf = res.fld.pmf()
    eff0 = effective_lengths(np.asarray(index.lengths[:n]), pmf)

    def run():
        lengths = state.corrected_effective_lengths(res.counts, eff0, pmf)
        return lengths, state.gc_exp.copy(), dict(state.graphs)

    def eager():
        with eager_bias_passes():
            return run()

    rec, (e1, e2, g1, g2) = ab("bias", eager, run, "length", 1)
    g = {k: sum(p[k] for p in g1[2].values()) for k in g1[2]["expected"]}
    rec.update(lengths=g["eager"] + g["replays"],
               max_diff=check_close("bias", g1[0], e1[0], e2[0]),
               gc_exp_max_diff=check_close("bias gc_exp", g1[1], e1[1],
                                           e2[1]),
               seconds=dict(state.seconds), quant=quant)
    graph_counts(rec, g)
    return rec


def bias_quant(index, r1: str, r2: str, device):
    """The paired quant with --seqBias --gcBias whose results feed the
    steps."""
    from salmon_tpu_torch import quant
    from salmon_tpu_torch.constants import SalmonDefaults

    opts = SalmonDefaults()
    opts.seq_bias_correct = opts.gc_bias_correct = True
    return quant.quantify(index, "A", [r1], [r2], opts=opts, progress=False,
                          device=device)


def run(index, r1: str, r2: str, draws: int = 16, steps=STEPS,
        device="cuda") -> list:
    """The records of each step (see the module's text)."""
    from salmon_tpu_torch import bench
    from salmon_tpu_torch.constants import DEFAULTS
    from salmon_tpu_torch.inference import em

    from salmon_tpu_torch.utils.graphcache import loop_graphs

    device = require_device(device, "bench_graph_post")
    if device.type != "cuda":
        raise RuntimeError("bench_graph_post measures the card's graphs")
    t0 = time.perf_counter()
    res = bias_quant(index, r1, r2, device)
    # the quant's own bias passes and EMs: their graphs' counters, the
    # loops' graph pool after them, the process's peak reserve so far
    quant = {"seconds": time.perf_counter() - t0,
             "bias_graphs": dict(res.bias.graphs),
             "loop_pool_bytes": loop_graphs(device).grown,
             "max_memory_reserved": torch.cuda.max_memory_reserved()}
    n = index.num_valid_targets
    cfg, opts = em.EMConfig(), DEFAULTS
    recs = []
    for step in steps:
        t0 = time.perf_counter()
        if step == "em":
            # the paired quant's EM (no bias flags: min 50 iterations)
            recs.append(em_step("em", em_inputs(
                res.eq_classes, res.eff_lens, n, device, cfg.use_vbem,
                cfg.rel_diff_tolerance, opts.min_em_iterations,
                cfg.max_iterations)))
        elif step == "em-fixture":
            fx = bench.em_fixture()
            recs.append(em_step("em-fixture", em_inputs(
                fx, np.full(bench.EM_TXPS, bench.EM_EFF_LEN),
                bench.EM_TXPS, device, True, 1e-2, 50, 10_000)))
        elif step == "bootstrap":
            recs.append(bootstrap_step(res, n, draws, device))
        elif step == "gibbs":
            recs.append(gibbs_step(res, n, draws, device))
        elif step == "bias":
            recs.append(bias_step(index, res, quant))
        else:
            raise ValueError(f"no step {step!r}: {', '.join(STEPS)}")
        # the step's timed runs; the loops' pool after them
        recs[-1]["step_seconds"] = time.perf_counter() - t0
        recs[-1]["loop_pool_bytes"] = loop_graphs(device).grown
    # every profiled call after every timed one, so that the timed calls
    # run as a quant's do, after no profiler session
    for rec in recs:
        profile_record(rec)
    return recs


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m salmon_tpu_torch.scripts.bench_graph_post")
    ap.add_argument("--index", required=True)
    ap.add_argument("-1", dest="r1", required=True)
    ap.add_argument("-2", dest="r2", required=True)
    ap.add_argument("--draws", type=int, default=16)
    ap.add_argument("--steps", default=",".join(STEPS))
    args = ap.parse_args(argv)
    steps = args.steps.split(",")
    if set(steps) - set(STEPS):
        ap.error(f"--steps takes {','.join(STEPS)}")
    require_device(device, "bench_graph_post")
    from salmon_tpu_torch.index.builder import load_index

    recs = run(load_index(args.index), args.r1, args.r2, args.draws, steps,
               device)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"graph_post": recs,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
