"""Mean of the card's per-batch intervals (CUDA events before and after
the batch step) of the window's batches, ms; nothing on the CPU."""

import numpy as np

from qbench.metrics._program_spans import device_intervals, window_batches


def read(run):
    dv = device_intervals(run)
    if dv is None:
        return None
    m = np.isin(dv["batch"], window_batches(run))
    if not m.any():
        return None
    return 1e-6 * float(np.mean(dv["end_ns"][m] - dv["start_ns"][m]))
