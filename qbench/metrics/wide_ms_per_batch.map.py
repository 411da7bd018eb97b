"""The card's time in the wide pass per batch of the window, ms: the
program's per-batch "step.wide" intervals (CUDA events around the wide
pass's sub-batches) summed over the window's batches, over their number
(a batch that marks nothing adds none); the traced part is left out as
for the other span readers. Nothing on the CPU or where the program
keeps no such intervals."""

import numpy as np

from qbench.metrics._program_spans import (device_intervals, store,
                                           window_batches, window_ns)


def read(run):
    spans = store()
    step = device_intervals(run)
    if spans is None or step is None:
        return None
    try:
        dv = spans.device_intervals("step.wide")
    except TypeError:
        return None
    sel = window_batches(run)
    if not sel.size:
        return None
    rec = spans.records()
    t0 = window_ns(run)[0]
    loops = rec["start_ns"][(rec["name"] == "quant.loop")
                            & (rec["start_ns"] < t0)]
    m = np.isin(dv["batch"], sel)
    if loops.size:
        m &= dv["start_ns"] >= loops.max()
    return 1e-6 * float((dv["end_ns"][m] - dv["start_ns"][m]).sum()) \
        / sel.size
