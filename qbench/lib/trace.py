"""Reduction of a torch.profiler Chrome trace to device numbers.

Device activity is every complete event of a device category (kernels,
copies, sets). `reduce_trace` gives the union of their intervals (busy),
the time of each kernel name, the longest gaps between device activity
labelled by the innermost host event that covered each gap's middle,
and the traced window's length (first to last host or device event).
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


def _union(intervals):
    total = 0.0
    gaps = []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def reduce_trace(path: str, top: int = 10) -> dict:
    """Numbers of the trace at `path` (times in seconds), over the span
    of all its events."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    dev, host = [], []
    lo = hi = None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((s, e, ev.get("name", "?")))
        elif cat in HOST_CATS:
            host.append((s, e, ev.get("name", "?")))
        else:
            continue
        lo = s if lo is None else min(lo, s)
        hi = e if hi is None else max(hi, e)
    if lo is None or hi is None or hi <= lo:
        return {"busy_s": 0.0, "window_s": 0.0, "kernels": {},
                "device_ops": [], "idle_gaps": []}
    clipped = dev
    busy, gaps = _union([(s, e) for s, e, _ in clipped])
    by_name = {}
    for s, e, n in clipped:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    if clipped:
        first = min(s for s, _, _ in clipped)
        last = max(e for _, e, _ in clipped)
        gaps = ([(lo, first)] if first > lo else []) + gaps + (
            [(last, hi)] if hi > last else [])
    else:
        gaps = [(lo, hi)]
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        cover = [(e - s, n) for s, e, n in host if s <= mid <= e]
        label = min(cover)[1] if cover else "host: no traced event"
        labelled.append([label, (b - a) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy * 1e-6, "window_s": (hi - lo) * 1e-6,
            "kernels": {n: v * 1e-6 for n, v in by_name.items()},
            "device_ops": [[n, v * 1e-6] for n, v in ops],
            "idle_gaps": labelled}
