"""What the readers of the program's own spans share (the port's
salmon_tpu_torch.utils.spans, on the perf_counter clock of the harness's
progress records and window): the records of the run's mapping loop,
the batches of the measured window, and the window's time. A batch's
id is its place in the loop, so batch i's progress record is
run.progress[i]. The traced sub-window and the two batches after it are
left out, as loop_batch_ms_p95.map leaves them out. Every reader gives
None where the program keeps no such records (a program without the
store, or the CPU for the device's intervals)."""

from __future__ import annotations

import numpy as np


def store():
    """The program's span store module, or None."""
    try:
        from salmon_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def _left_out(run):
    """(lo, hi): the progress records of the traced part, or None."""
    if not run.traced_batches:
        return None
    lo = run.open_batch + int(run.cell["trace_skip_batches"])
    return lo, lo + run.traced_batches + 1


def window_batches(run) -> np.ndarray:
    """Ids of the batches whose progress record lies in the window."""
    t0, t1 = run.window
    out = _left_out(run)
    return np.array([i for i, (t, _) in enumerate(run.progress)
                     if t0 < t <= t1
                     and not (out and out[0] <= i <= out[1])], np.int64)


def window_ns(run):
    """(t0, t1, cut): the window in ns and the part of it left out, as
    (a, b) in ns, or None."""
    t0, t1 = (int(round(t * 1e9)) for t in run.window)
    out = _left_out(run)
    cut = None
    if out is not None and out[0] >= 1:
        hi = min(out[1], len(run.progress) - 1)
        cut = (int(round(run.progress[out[0] - 1][0] * 1e9)),
               int(round(run.progress[hi][0] * 1e9)))
    return t0, t1, cut


def _loop_start(rec, t0: int):
    """Start of the newest mapping loop that began before t0, or None."""
    s = rec["start_ns"][(rec["name"] == "quant.loop")
                        & (rec["start_ns"] < t0)]
    return int(s.max()) if s.size else None


def loop_records(run, spans):
    """The records of the run's own loop: those that began with or after
    the newest quant.loop span that began before the window."""
    rec = spans.records()
    start = _loop_start(rec, window_ns(run)[0])
    if start is None:
        return rec
    keep = rec["start_ns"] >= start
    return {k: v[keep] for k, v in rec.items()}


def per_batch_ms(run, name: str):
    """The time of spans `name` of the window's batches per batch, ms;
    None where the window's batches have no quant.consume span."""
    spans = store()
    sel = window_batches(run)
    if spans is None or not sel.size:
        return None
    rec = loop_records(run, spans)
    mine = np.isin(rec["batch"], sel)
    if not (mine & (rec["name"] == "quant.consume")).any():
        return None
    m = mine & (rec["name"] == name)
    return 1e-6 * float((rec["end_ns"][m] - rec["start_ns"][m]).sum()) \
        / sel.size


def device_intervals(run):
    """The run's per-batch device intervals (batch, start_ns, end_ns),
    or None."""
    spans = store()
    if spans is None:
        return None
    dv = spans.device_intervals()
    start = _loop_start(spans.records(), window_ns(run)[0])
    if start is not None:
        keep = dv["start_ns"] >= start
        dv = {k: v[keep] for k, v in dv.items()}
    return dv if dv["batch"].size else None


def newest_before_window(run, name: str):
    """Seconds of the newest span `name` that ended before the window."""
    spans = store()
    if spans is None:
        return None
    rec = spans.records()
    m = (rec["name"] == name) & (rec["end_ns"] <= window_ns(run)[0])
    if not m.any():
        return None
    i = np.flatnonzero(m)[np.argmax(rec["end_ns"][m])]
    return 1e-9 * float(rec["end_ns"][i] - rec["start_ns"][i])
