"""The benchmark of salmon_tpu_torch: one run of one cell.

    python3 qbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1]

from the root of a checkout. With --trace 0 the last line of standard
output is a JSON object whose metrics are the cell's end-to-end metrics
(BENCHMARK.json "end_to_end"); with --trace 1 they are its per-layer
metrics, read from a torch.profiler trace of a steady sub-window and the
program's clocks. `correct` is the check against the plain reference
(qbench/reference); its numbers and limits are the last lines of
standard error and the last key of the result. --control 1 runs the
check's control (see qbench/lib/check.py), which must come out not
correct. Needs as many CUDA devices as the cell names; writes only in
the checkout (qbench/.cache: the transcriptome and the index, built on
a cell's first run) and in TMPDIR.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fail(msg: str) -> int:
    print(f"qbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None, device: str = "cuda", root: str = ROOT,
         cache: str | None = None) -> int:
    ap = argparse.ArgumentParser(prog="qbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch

    from qbench.lib.cell import forbidden_modules, run_cell
    from qbench.lib.registry import Registry

    try:
        chips = int(Registry(root).workload(args.workload).get("chips", 1))
    except (OSError, KeyError, ValueError) as e:
        return _fail(f"cannot read the cell: {e!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            return _fail("no CUDA device")
        if torch.cuda.device_count() < chips:
            return _fail(f"the cell needs {chips} devices, "
                         f"{torch.cuda.device_count()} visible")
    out = run_cell(root, args.workload, args.seed, args.seconds,
                   bool(args.trace), bool(args.control), cache=cache,
                   device=device)
    reg = out["registry"]
    name = args.workload
    metrics = {}
    if args.trace:
        for m in reg.per_layer(name):
            v = reg.metric_reader(m["name"])(out["run"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in reg.end_to_end(name):
            metrics[m["name"]] = {"value": float(out["e2e"][m["name"]]),
                                  "unit": m["unit"]}
    if device == "cuda":
        dev_info = {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": chips, "memory_peak_bytes": int(out["peak_dev"])}
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": dev_info}
    tr = out["run"].trace
    if args.trace and tr is not None:
        dev_info["busy_s"] = tr["busy_s"]
        dev_info["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    found = forbidden_modules()
    if found:
        return _fail(f"modules of JAX or the JAX package were loaded: "
                     f"{found}")
    result["check"] = {k: {"value": v, "limit": out["limits"].get(k)}
                       for k, v in out["numbers"].items()}
    for k, v in out["numbers"].items():
        print(f"check {k}: {v!r} (limit {out['limits'].get(k)!r})",
              file=sys.stderr)
    print(f"check correct: {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
