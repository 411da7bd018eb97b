"""Finding a cell's pieces by name, and adding them with new files."""

from __future__ import annotations

import json
import os

import pytest

from conftest import REPO, make_tiny_root
from qbench.lib.cell import Run
from qbench.lib.registry import Registry


def test_repo_cells_resolve():
    reg = Registry(REPO)
    for w in reg.bench["workloads"]:
        cell = reg.workload(w["name"])
        cfg = reg.config(cell["config"])
        mix = reg.traffic(cell["traffic"])
        assert cfg["k"] == 31 and cfg["transcriptome"]["n_txps"] == 200000
        assert mix["read_len"] == 100
        assert set(cell["limits"]) == {"map_answer_mismatch", "eq_class_gap",
                                       "efflen_gap", "em_numreads_gap"}
    for m in reg.bench["per_layer"]:
        assert callable(reg.metric_reader(m["name"]))
    assert {m["name"] for m in reg.end_to_end("paralog-vbem.stream")} == {
        "setup_s", "map_frags_per_s", "peak_device_mib", "peak_rss_mib"}


@pytest.mark.parametrize("cell", ["paralog-vbem.stream",
                                  "paralog-vbem.offtarget"])
def test_per_layer_by_cell(cell):
    names = {m["name"] for m in Registry(REPO).per_layer(cell)}
    assert {"loop_batch_ms_p95.map", "device_idle.map", "index_upload_s.setup",
            "index_load_s.setup"} <= names


def test_added_from_files(tmp_path):
    """A new configuration, mix, cell and metric: new files and new
    entries, no file edited."""
    root = make_tiny_root(str(tmp_path))
    q = os.path.join(root, "qbench")
    with open(os.path.join(q, "metrics", "batches_seen.map.py"), "w") as fh:
        fh.write("def read(run):\n    return float(len(run.progress))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["per_layer"].append({
        "name": "batches_seen.map", "unit": "1", "better": "higher",
        "source": "program_span", "layer": "driver loop",
        "moves": "map_frags_per_s", "workloads": ["tiny.stream"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    reg = Registry(root)
    cell = reg.workload("tiny.stream")
    assert cell["warm_batches"] == 3 and cell["chips"] == 1
    assert reg.config("tiny")["transcriptome"]["n_txps"] == 300
    assert reg.traffic("tiny")["pool_pairs"] == 2048
    assert "batches_seen.map" in {m["name"] for m in
                                  reg.per_layer("tiny.stream")}
    assert "batches_seen.map" not in {m["name"] for m in
                                      reg.per_layer("paralog-vbem.stream")}
    run = Run(cell=cell, clocks={}, progress=[(0.0, 1), (1.0, 2)],
              window=(0.0, 1.0), open_batch=1, spans={}, trace=None,
              traced_batches=0)
    assert reg.metric_reader("batches_seen.map")(run) == 2.0
    # readers that find nothing to read return nothing
    assert reg.metric_reader("device_idle.map")(run) is None
    assert reg.metric_reader("index_upload_s.setup")(run) is None
