"""Seconds of load_index, timed by the harness around the call."""


def read(run):
    return run.spans.get("index_load_s")
