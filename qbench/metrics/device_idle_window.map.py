"""Share of the window in which the card ran no batch step, %: 100 x
(1 - union of the per-batch device intervals / window), over the window
less its traced part; nothing on the CPU."""

from qbench.metrics._program_spans import device_intervals, window_ns


def _pieces(s, e, t0, t1, cut):
    s, e = max(s, t0), min(e, t1)
    if cut is None:
        return [(s, e)] if e > s else []
    a, b = cut
    return [(x, y) for x, y in ((s, min(e, a)), (max(s, b), e)) if y > x]


def read(run):
    dv = device_intervals(run)
    if dv is None:
        return None
    t0, t1, cut = window_ns(run)
    pieces = []
    for s, e in zip(dv["start_ns"].tolist(), dv["end_ns"].tolist()):
        pieces += _pieces(s, e, t0, t1, cut)
    if not pieces:
        return None
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(pieces):
        if cur_e is None or s > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = t1 - t0
    if cut is not None:
        span -= max(0, min(cut[1], t1) - max(cut[0], t0))
    return 100.0 * (1.0 - busy / span) if span > 0 else None
