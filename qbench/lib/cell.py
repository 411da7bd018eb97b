"""One run of one cell: set-up, the measured window, the sample's finish,
then the check against the plain reference.

The program is driven through its public entries, as a user's quant
is: `load_index`, then `quantify` on two named pipes that the stream
feeds, then `write_outputs`. Set-up runs to the progress record of the
cell's `warm_batches`-th batch (by then every batch signature of the
burn-in has run eagerly and been captured, and the library format is
detected). The burn-in follows: salmon maps its first
`num_burnin_frags` fragments (5,000,000 by default) with a fragment-
length model still learning, and the rest, most of a sample, with it
frozen. The window opens `burnin_warm_batches` batches after the
progress record that passes the burn-in (the frozen model's signature
runs eagerly and is captured in them, which counts as set-up; the
burn-in's batches before them count neither as set-up nor in the
window) and lasts `seconds`; then the stream ends and the program
finishes the sample.
"""

from __future__ import annotations

import dataclasses
import json
import os
import resource
import statistics
import sys
import tempfile
import time

import numpy as np

from qbench.lib import check, observe, trace, traffic, txome as txome_mod
from qbench.lib.registry import Registry
from qbench.lib.stream import PairStream

FORBIDDEN = ("jax", "jaxlib", "flax", "salmon_tpu")


def process_start() -> float:
    """This process's start on the perf_counter clock."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: dict
    clocks: dict
    progress: list            # (t, fragments) of every batch
    window: tuple             # (t0, t1)
    open_batch: int           # progress records up to the window's start
    spans: dict               # harness spans, seconds
    trace: dict | None        # reduce_trace of the traced sub-window
    traced_batches: int

    def per_batch(self, clock: str):
        n = self.clocks.get("mapped_batches")
        v = self.clocks.get(clock)
        if not n or v is None:
            return None
        return 1e3 * v / n


def _frags_at(progress, t: float) -> float:
    """Fragments processed by time t, linear between batch records."""
    prev = (progress[0][0], 0)
    for cur in progress:
        if cur[0] >= t:
            span = cur[0] - prev[0]
            if span <= 0:
                return float(cur[1])
            return prev[1] + (cur[1] - prev[1]) * (t - prev[0]) / span
        prev = cur
    return float(progress[-1][1])


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace_on: bool, control: bool = False, cache: str | None = None,
             device: str = "cuda", log=None) -> dict:
    t_proc = process_start()
    log = log or (lambda s: print(f"# {s}", file=sys.stderr, flush=True))
    import torch

    reg = Registry(root)
    cell = reg.workload(workload)
    cfg = reg.config(cell["config"])
    mix = reg.traffic(cell["traffic"])
    dev = torch.device(device)
    cache = cache or os.path.join(reg.qdir, ".cache")
    os.environ.setdefault("SALMON_NO_VERSION_CHECK", "1")

    from salmon_tpu_torch.constants import DEFAULTS

    t = time.perf_counter()
    npz, idx_dir = txome_mod.ensure_cache(cache, cfg["transcriptome"],
                                          cfg["k"], log)
    cache_s = time.perf_counter() - t
    t_gen = time.perf_counter()
    tx = txome_mod.Txome.load(npz, int(cfg["reference"]["polya_clip"]))
    options = dict(cfg["quant"]["options"], progress_update_ms=0)
    if control:
        options["hard_filter"] = True
    opts = dataclasses.replace(DEFAULTS, **options)
    pool = traffic.make_pool(tx, mix, seed, opts.reads_per_batch)
    members = (traffic.gzip_members(pool, 1), traffic.gzip_members(pool, 2))
    gen_s = time.perf_counter() - t_gen
    log(f"inputs: {pool.n} pairs in {pool.members} gzip members "
        f"({sum(map(len, members[0])) + sum(map(len, members[1]))} bytes) "
        f"made in {gen_s:.2f} s (not set-up); cache {cache_s:.1f} s")
    rng = traffic.seed_rng(seed, 2)
    n_sample = min(int(cell["sample_batches"]), pool.members)
    sample = set(int(m) for m in rng.choice(pool.members, n_sample,
                                            replace=False))
    with tempfile.TemporaryDirectory(
            prefix="qbench-", dir=os.environ.get("TMPDIR")) as work:
        out = _stream(cell, cfg, opts, dev, idx_dir, members, pool.members,
                      sample, seconds, trace_on, work, log)
    e2e = out["e2e"]
    # the seed's reads and a checkout's first build of the transcriptome
    # and index are the benchmark's inputs, not the program's set-up
    e2e["setup_s"] -= t_proc + gen_s + cache_s
    log("window: " + json.dumps(e2e))

    # the check, once the program's state is freed
    t = time.perf_counter()
    params = dict(cfg["reference"], k=cfg["k"])
    taps, names = out["taps"], out["names"]
    numbers = {}
    numbers["map_answer_mismatch"] = check.answer_mismatch(
        taps, pool, tx, names, params, dev, log, control)
    ref_index = {tx.name(i): i for i in range(tx.n)}
    port_lens = tx.lengths[[ref_index[n] for n in names]]
    numbers.update(check.eq_and_em_gaps(taps, out["pmf"], port_lens, params,
                                        dev, control, log))
    log(f"check took {time.perf_counter() - t:.1f} s")
    limits = cell["limits"]
    correct = set(limits) <= set(numbers) and all(
        k in limits and np.isfinite(v) and v <= limits[k]
        for k, v in numbers.items())
    return {"run": out["run"], "e2e": e2e, "numbers": numbers,
            "limits": limits, "correct": correct,
            "attempted": out["offered"],
            "failed": max(out["offered"] - out["processed"], 0),
            "peak_dev": out["peak_dev"], "registry": reg, "cell": cell}


def _stream(cell, cfg, opts, dev, idx_dir, members, n_members, sample,
            seconds, trace_on, work, log) -> dict:
    """The program's run on the stream: set-up, window, finish. Returns
    the end-to-end numbers (setup_s on the perf_counter clock), the
    Run, the taps and what the check needs of the program's answer."""
    import torch

    from salmon_tpu_torch.index.builder import load_index
    from salmon_tpu_torch.quant import quantify, write_outputs

    warm = int(cell["warm_batches"])
    burnin = int(opts.num_burnin_frags)
    burnin_warm = int(cell["burnin_warm_batches"])
    captured = set()
    state = {"t_warm": None, "cross": None, "open": None, "t0": None,
             "prof_range": None}

    def want(b):
        # the sampled members' first batches inside the window
        m = b % n_members
        if state["open"] is not None and b >= state["open"] and \
                m in sample and m not in captured:
            captured.add(m)
            return True
        return False

    skip, n_tr = int(cell["trace_skip_batches"]), int(cell["trace_batches"])
    prof = None
    if trace_on:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            # start the tracer once in set-up, so that its first start
            # does not stall the window
            with profile(activities=acts):
                torch.ones(1, device=dev).add_(1).cpu()
        prof = profile(activities=acts)
    stream = PairStream(members[0], members[1], work, int(cell["pipe_bytes"]))

    def on_batch(nb, t_b, frags):
        if nb == warm:
            state["t_warm"] = t_b
        if state["cross"] is None and frags >= burnin:
            state["cross"] = (nb, t_b)
        if state["open"] is None and nb >= warm and state["cross"] \
                and nb >= state["cross"][0] + burnin_warm:
            state["open"], state["t0"] = nb, t_b
            stream.stop_at(t_b + seconds)
        if prof is not None and state["open"] is not None:
            if nb == state["open"] + skip:
                prof.start()
                state["prof_range"] = [nb, None]
            elif nb == state["open"] + skip + n_tr and state["prof_range"]:
                prof.stop()
                state["prof_range"][1] = nb

    tap = observe.LogTap(on_batch)
    taps = observe.Taps(want, spans=trace_on)
    try:
        stream.start()
        tap.install()
        taps.install()
        t = time.perf_counter()
        index = load_index(idx_dir)
        index_load_s = time.perf_counter() - t
        names = list(index.names)
        result = quantify(index, cfg["quant"]["lib_format"],
                          [stream.paths[0]], [stream.paths[1]], opts,
                          device=dev)
        t = time.perf_counter()
        write_outputs(result, index, os.path.join(work, "out"), opts,
                      device=dev)
        write_s = time.perf_counter() - t
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_out = time.perf_counter()
    finally:
        taps.remove()
        tap.remove()
        stream.close()
        if prof is not None and state["prof_range"] and \
                state["prof_range"][1] is None:
            prof.stop()
    if stream.errors:
        log(f"stream: {stream.errors}")
    peak_dev = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" \
        else 0
    peak_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    progress = tap.progress
    if state["t0"] is None:
        raise RuntimeError(f"the stream ended after {len(progress)} batches, "
                           f"before the window ({warm} warm-up batches, "
                           f"{burnin} fragments of burn-in, then "
                           f"{burnin_warm} batches)")
    t0 = state["t0"]
    t1 = t0 + seconds
    if progress[-1][0] < t1:
        raise RuntimeError("the program's last batch came before the "
                           "window's end")
    frags = _frags_at(progress, t1) - _frags_at(progress, t0)
    log(f"{frags:.0f} fragments in the window, {len(progress)} batches in "
        f"all; index load {index_load_s:.2f} s; clocks " + json.dumps(
            {k: v for k, v in tap.clocks.items()
             if isinstance(v, (int, float))}))
    trace_sum = None
    traced = 0
    if prof is not None and state["prof_range"] and state["prof_range"][1]:
        path = os.path.join(work, "trace.json")
        prof.export_chrome_trace(path)
        trace_sum = trace.reduce_trace(path)
        traced = state["prof_range"][1] - state["prof_range"][0]
    run = Run(cell=cell, clocks=dict(tap.clocks), progress=progress,
              window=(t0, t1), open_batch=state["open"],
              spans={"index_load_s": index_load_s,
                     "write_outputs_s": write_s},
              trace=trace_sum, traced_batches=traced)
    t_cross = max(state["cross"][1], state["t_warm"])
    post_s = t_out - progress[-1][0]
    log(f"set-up: the warm-up's {warm} batches, then "
        f"{t0 - t_cross!r} s from the burn-in's end (batch "
        f"{state['cross'][0]}) to the window (batch {state['open']}); "
        f"burn-in left out {t_cross - state['t_warm']!r} s; post_s "
        f"{post_s!r} (the last batch to the outputs), write_outputs "
        f"{write_s!r} s; rss {_rss_mib()}")
    out = {"e2e": {"setup_s": state["t_warm"] + (t0 - t_cross),
                   "map_frags_per_s": frags / seconds,
                   "post_s": post_s,
                   "peak_device_mib": peak_dev / 2**20,
                   "peak_rss_mib": peak_rss / 2**20},
           "run": run, "taps": taps, "names": names,
           "pmf": result.fld.pmf() if result.fld is not None else None,
           "processed": result.num_processed,
           "offered": stream.members_written() * opts.reads_per_batch,
           "peak_dev": peak_dev}
    del result, index
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _rss_mib() -> str:
    """The process's resident set now and at its peak (VmRSS, VmHWM)."""
    try:
        with open("/proc/self/status") as fh:
            return " ".join(ln.split(":")[0] + " " + ln.split()[1] + " kB"
                            for ln in fh if ln.startswith(("VmRSS",
                                                           "VmHWM")))
    except OSError:
        return "n/a"


def percentile(values, q: float):
    """The q-th percentile (0-100), by statistics.quantiles' inclusive
    method; None for fewer than two values."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[
        max(0, min(98, int(round(q)) - 1))]
