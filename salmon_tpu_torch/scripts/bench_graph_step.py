"""The compiled batch step against the eager one, on the card.

    python -m salmon_tpu_torch.scripts.bench_graph_step --index IDX \\
        -1 R1 -2 R2 [--batches 8] [--rows 4096] \\
        [--modes paired,single,rescue,sparse]

For each mode (paired; single-end on the first mates; paired with
--recoverOrphans; paired with the sparse seed flow) the same `batches`
batches of `rows` reads are mapped twice: by map_*_batch_impl, the eager
step, and by map_*_batch, one CUDA graph per signature
(salmon_tpu_torch.utils.graphcache: the first batch eager, the second
captured, the rest replayed). Batch i has its own FLD, the prior plus
the paired fragment lengths of the batches before it, as quant's loop
feeds it (mode 1). Checked, or the run fails:
  - every output key of every batch bit-equal between the two, but
    txp_mass, an index_add_ of float32 weights whose atomic adds land in
    another order on every run (eager against eager too): it is held to
    rtol 1e-5, and its largest difference is printed;
  - banded_dp launched as often through the graph as eagerly;
  - the graph cache's counters: one eager batch, one capture and
    batches - 1 replays.
Measured per mode, over the batches after the capture: wall ms a batch
(host clock ended by a synchronize), device busy ms a batch, device ops
a batch and host-issued launches a batch (torch.profiler over the same
batches: runtime launch, graph launch, memcpy and memset calls), the
capture's seconds, the bytes the graphs' pool grew by, the bytes of one
output set (the ring holds in_flight + 1 of them), and
torch.cuda.memory_reserved() after the mode. One JSON line a mode, then
the card's name and power limit and a last JSON line of all modes.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from salmon_tpu_torch.scripts import require_device

MODES = ("paired", "single", "rescue", "sparse")
MAIN_BW, RESCUE_BW = 15, 80
TXP_MASS_RTOL = 1e-5
# the CUDA runtime calls by which the host hands the card work
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
               "cudaMemsetAsync")


def load_batches(r1: str, r2: str, rows: int, n: int, device) -> list:
    """The first n paired chunks of rows reads, on the device."""
    from salmon_tpu_torch.constants import DEFAULTS
    from salmon_tpu_torch.io.fastq import iter_paired_chunks

    chunks = iter_paired_chunks([r1], [r2], rows, DEFAULTS.max_read_len)
    out = []
    for _, c in zip(range(n), chunks):
        out.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    for k, v in (("codes_l", c.left.codes),
                                 ("lengths_l", c.left.lengths),
                                 ("codes_r", c.right.codes),
                                 ("lengths_r", c.right.lengths))})
    if len(out) < n:
        raise ValueError(f"{r1} holds {len(out)} batches of {rows}, not {n}")
    return out


def fld_inputs(batches, dev, cfg, compat, device) -> list:
    """Batch i's FLD: the prior plus the eager paired step's fragment
    lengths of batches 0..i-1."""
    from salmon_tpu_torch.mapping.pipeline import map_paired_batch_impl
    from salmon_tpu_torch.models.fld import FragmentLengthDistribution

    fld = FragmentLengthDistribution()
    flds = []
    for b in batches:
        f = {"logpmf": torch.as_tensor(fld.log_pmf(), dtype=torch.float32,
                                       device=device),
             "logcmf": torch.as_tensor(fld.log_cmf(), dtype=torch.float32,
                                       device=device), "mode": 1}
        flds.append(f)
        out = map_paired_batch_impl(b, dev, cfg, f, *compat)
        fld.add_observations(out["fld_hist"].cpu().double().numpy())
    return flds


def _profile(fn, n: int) -> dict:
    """fn() under torch.profiler: device busy ms, device ops and
    host-issued launches, each a batch of n."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    dev_ev = [e for e in avg if e.device_type == DeviceType.CUDA]
    return {"busy_ms": sum(e.self_device_time_total for e in dev_ev)
            / 1e3 / n,
            "device_ops": sum(e.count for e in dev_ev) / n,
            "host_launches": sum(e.count for e in avg
                                 if e.key in LAUNCH_APIS) / n,
            "banded_dp_kernels": sum(e.count for e in dev_ev
                                     if "banded_dp_kernel" in e.key) / n}


def run_mode(mode: str, index, batches: list, flds: list, device) -> dict:
    from salmon_tpu_torch.mapping import pipeline
    from salmon_tpu_torch.mapping.align import BANDED_DP
    from salmon_tpu_torch.utils import libformat

    cfg = pipeline.MapperConfig.from_index(index)
    if mode == "rescue":
        cfg = dataclasses.replace(cfg, recover_orphans=True)
    elif mode == "sparse":
        cfg = dataclasses.replace(cfg, sparse_seed=True)
    single = mode == "single"
    if single:
        batches = [{"codes": b["codes_l"], "lengths": b["lengths_l"]}
                   for b in batches]
        compat = (torch.as_tensor(libformat.single_compat_table(
            libformat.parse_library_format("U")), device=device),)
        impl, entry = (pipeline.map_single_batch_impl,
                       pipeline.map_single_batch)
    else:
        fmt = libformat.parse_library_format("IU")
        compat = tuple(torch.as_tensor(t, device=device) for t in (
            libformat.paired_compat_table(fmt),
            libformat.orphan_compat_table(fmt)))
        impl, entry = (pipeline.map_paired_batch_impl,
                       pipeline.map_paired_batch)
    # a fresh copy of the index tensors: a graph cache of its own
    dev = pipeline.device_index_tensors(index, device)
    n = len(batches)
    timed = range(2, n)

    def eager(i):
        return impl(batches[i], dev, cfg, flds[i], *compat)

    def graphed(i):
        return entry(batches[i], dev, cfg, flds[i], *compat, in_flight=n)

    def wall(fn, outs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in timed:
            outs[i] = fn(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / len(timed)

    BANDED_DP.reset()
    eager_out = [eager(0), eager(1), *([None] * (n - 2))]
    eager_ms = wall(eager, eager_out)
    eager_dp = dict(BANDED_DP.by_shape)

    BANDED_DP.reset()
    graph_out = [graphed(0), graphed(1), *([None] * (n - 2))]
    graph_ms = wall(graphed, graph_out)
    graph_dp = dict(BANDED_DP.by_shape)
    st, = pipeline.graph_stats(dev)
    counters = {"eager": st.eager, "captures": st.captures,
                "replays": st.replays}
    reserved = torch.cuda.memory_reserved()

    want_dp = {MAIN_BW: n, **({RESCUE_BW: n} if mode == "rescue" else {})}
    if eager_dp != want_dp or graph_dp != want_dp:
        raise AssertionError(f"{mode}: banded_dp launches eager {eager_dp}, "
                             f"graph {graph_dp}, want {want_dp}")
    if counters != {"eager": 1, "captures": 1, "replays": n - 1}:
        raise AssertionError(f"{mode}: graph counters {counters}")
    diff = {"txp_mass": 0.0, "txp_mass_eager_rerun": 0.0}
    for i in range(n):
        e, g = eager_out[i], graph_out[i]
        if set(e) != set(g):
            raise AssertionError(f"{mode}: keys {sorted(set(e) ^ set(g))}")
        for k in e:
            if k == "txp_mass":
                torch.testing.assert_close(g[k], e[k], rtol=TXP_MASS_RTOL,
                                           atol=0.0)
                diff[k] = max(diff[k], float((g[k] - e[k]).abs().max()))
            elif not torch.equal(g[k], e[k]):
                raise AssertionError(f"{mode}: batch {i} key {k} differs "
                                     f"between the graph and the eager step")
    n_keys = len(graph_out[0])
    # one output set of the ring (the graph's static outputs are another)
    set_bytes = sum(v.numel() * v.element_size()
                    for v in graph_out[-1].values())
    mapped = float(graph_out[0]["num_mapped"]) / float(
        graph_out[0]["num_processed"])

    # the same batches again under the profiler (the graph's replays
    # reuse the ring's slots of graph_out); the eager pass's outputs show
    # txp_mass's run-to-run order against the first eager pass
    again = [None] * n
    prof_eager = _profile(lambda: [again.__setitem__(i, eager(i))
                                   for i in timed], len(timed))
    prof_graph = _profile(lambda: [graphed(i) for i in timed], len(timed))
    for i in timed:
        diff["txp_mass_eager_rerun"] = max(
            diff["txp_mass_eager_rerun"], float(
                (again[i]["txp_mass"] - eager_out[i]["txp_mass"]).abs()
                .max()))
    return {"mode": mode, "batches": n,
            "rows": batches[0][next(iter(batches[0]))].shape[0],
            "width": batches[0][next(iter(batches[0]))].shape[1],
            "signature": st.label,
            "eager": {"wall_ms": eager_ms, **prof_eager},
            "graph": {"wall_ms": graph_ms, **prof_graph,
                      "capture_seconds": st.capture_seconds,
                      "pool_bytes": st.pool_bytes,
                      "output_set_bytes": set_bytes},
            "banded_dp": graph_dp,
            "counters": counters,
            "bit_equal_keys": n_keys - 1, "output_keys": n_keys,
            "max_abs_diff": diff, "memory_reserved": reserved,
            "mapped_fraction": mapped}


def run(index, r1: str, r2: str, n_batches: int = 8, rows: int = 4096,
        modes=MODES, device="cuda") -> list:
    """The records of run_mode for each mode (see the module's text)."""
    from salmon_tpu_torch.mapping import pipeline
    from salmon_tpu_torch.utils import libformat

    if n_batches < 3:
        raise ValueError("the comparison needs 3 or more batches: eager, "
                         "capture, replays")
    device = require_device(device, "bench_graph_step")
    if device.type != "cuda":
        raise RuntimeError("bench_graph_step measures the card's graphs")
    batches = load_batches(r1, r2, rows, n_batches, device)
    fmt = libformat.parse_library_format("IU")
    compat = tuple(torch.as_tensor(t, device=device) for t in (
        libformat.paired_compat_table(fmt),
        libformat.orphan_compat_table(fmt)))
    dev = pipeline.device_index_tensors(index, device)
    flds = fld_inputs(batches, dev, pipeline.MapperConfig.from_index(index),
                      compat, device)
    del dev
    return [run_mode(m, index, batches, flds, device) for m in modes]


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m salmon_tpu_torch.scripts.bench_graph_step")
    ap.add_argument("--index", required=True)
    ap.add_argument("-1", dest="r1", required=True)
    ap.add_argument("-2", dest="r2", required=True)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--modes", default=",".join(MODES))
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    if set(modes) - set(MODES):
        ap.error(f"--modes takes {','.join(MODES)}")
    require_device(device, "bench_graph_step")
    from salmon_tpu_torch.index.builder import load_index

    t0 = time.perf_counter()
    index = load_index(args.index)
    load_s = time.perf_counter() - t0
    recs = run(index, args.r1, args.r2, args.batches, args.rows, modes,
               device)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"graph_step": recs, "index_load_seconds": load_s,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
