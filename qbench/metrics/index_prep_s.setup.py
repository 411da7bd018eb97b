"""Seconds of the program's newest index.prep span before the window:
the upload's host work (the occ_oct rebuild, seq4, casts and the
page-ins they force)."""

from qbench.metrics._program_spans import newest_before_window


def read(run):
    return newest_before_window(run, "index.prep")
