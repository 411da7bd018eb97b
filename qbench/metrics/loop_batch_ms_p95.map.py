"""95th percentile of the time between successive batches' progress
records inside the window, in ms; the batches of the traced sub-window
and the two around it are left out."""

from qbench.lib.cell import percentile


def read(run):
    t0, t1 = run.window
    lo = run.open_batch + int(run.cell["trace_skip_batches"])
    hi = lo + run.traced_batches + 1
    gaps = []
    for i in range(1, len(run.progress)):
        t = run.progress[i][0]
        if t0 < t <= t1 and not (run.traced_batches and lo <= i <= hi):
            gaps.append(1e3 * (t - run.progress[i - 1][0]))
    return percentile(gaps, 95)
