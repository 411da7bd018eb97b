"""Seconds of the program's newest index.h2d span before the window:
the index tensors' copies to the card."""

from qbench.metrics._program_spans import newest_before_window


def read(run):
    return newest_before_window(run, "index.h2d")
