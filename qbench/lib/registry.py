"""Finding a cell's pieces by name.

BENCHMARK.json at the checkout's root names the cells, configurations
and metrics. Each piece sits in a file of its own under qbench/:
  configs/<config>.json       (the entry's "file")
  traffic/<mix>.json          (the cell's "traffic")
  workloads/<cell>.json       (the harness's settings and the limits of
                               the cell's check)
  metrics/<metric>.py         (a reader: read(run) -> number or None)
so that a cell, a configuration, a mix or a metric is added with new
files and new entries, and no file is edited.
"""

from __future__ import annotations

import importlib.util
import json
import os

WORKLOAD_DEFAULTS = {
    "warm_batches": 24,       # batches of set-up before the burn-in
    "burnin_warm_batches": 8,  # batches of set-up after the burn-in,
                              # before the window opens
    "sample_batches": 2,      # batches whose labels the check compares
    "trace_skip_batches": 10,  # batches of the window before the trace
    "trace_batches": 60,      # batches the traced sub-window holds
    "pipe_bytes": 1 << 20,    # each named pipe's buffer
    "limits": {},
}


class Registry:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        with open(os.path.join(self.root, "BENCHMARK.json")) as fh:
            self.bench = json.load(fh)
        self.qdir = os.path.join(self.root, "qbench")

    def _entry(self, key: str, name: str) -> dict:
        for e in self.bench[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key[:-1]} named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        """The BENCHMARK.json entry merged with workloads/<name>.json."""
        cell = dict(WORKLOAD_DEFAULTS)
        path = os.path.join(self.qdir, "workloads", f"{name}.json")
        if os.path.exists(path):
            with open(path) as fh:
                cell.update(json.load(fh))
        cell.update(self._entry("workloads", name))
        return cell

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        with open(os.path.join(self.root, entry["file"])) as fh:
            cfg = json.load(fh)
        cfg["name"] = name
        return cfg

    def traffic(self, mix: str) -> dict:
        with open(os.path.join(self.qdir, "traffic", f"{mix}.json")) as fh:
            return json.load(fh)

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", [cell])]

    def metric_reader(self, name: str):
        path = os.path.join(self.qdir, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"qbench_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
