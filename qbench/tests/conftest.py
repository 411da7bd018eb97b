"""Shared fixtures of the benchmark's tests: a tiny copy of the
benchmark (300 transcripts, 2,048 pairs, batches of 256) in a
temporary checkout, and its cache, made once per session."""

from __future__ import annotations

import io
import json
import os
import shutil
import sys
from contextlib import redirect_stdout, redirect_stderr

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
os.environ.setdefault("SALMON_NO_VERSION_CHECK", "1")

TINY_LIMITS = {"map_answer_mismatch": 0.03, "eq_class_gap": 1e-15,
               "efflen_gap": 1e-6, "em_numreads_gap": 1e-5}


def make_tiny_root(dst: str, config: str = "paralog-vbem",
                   n_txps: int = 300, options: dict | None = None) -> str:
    """A checkout holding BENCHMARK.json and qbench/ plus a tiny cell,
    `tiny.stream`, added with new files and new entries only: `config`'s
    transcriptome cut to n_txps, batches of 256, a burn-in of 1,024
    fragments."""
    root = os.path.join(dst, "root")
    shutil.copytree(os.path.join(REPO, "qbench"), os.path.join(root, "qbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    q = os.path.join(root, "qbench")
    with open(os.path.join(q, "configs", f"{config}.json")) as fh:
        cfg = json.load(fh)
    cfg["transcriptome"]["n_txps"] = n_txps
    cfg["quant"]["options"] = dict({"reads_per_batch": 256,
                                    "num_burnin_frags": 1024},
                                   **(options or {}))
    with open(os.path.join(q, "configs", "tiny.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(q, "traffic", "stream.json")) as fh:
        mix = json.load(fh)
    mix["pool_pairs"] = 2048
    with open(os.path.join(q, "traffic", "tiny.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(q, "workloads", "tiny.stream.json"), "w") as fh:
        json.dump({"warm_batches": 3, "burnin_warm_batches": 2,
                   "sample_batches": 2,
                   "trace_skip_batches": 1, "trace_batches": 2,
                   "pipe_bytes": 65536, "limits": TINY_LIMITS}, fh)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "qbench/configs/tiny.json",
                             "reduced": ["n_txps"], "why": "test"})
    bench["workloads"].append({"name": "tiny.stream", "config": "tiny",
                               "traffic": "tiny", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append("tiny.stream")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("qbench"))
    return {"root": make_tiny_root(d), "cache": os.path.join(d, "cache")}


def run_main(tiny, argv, device="cpu"):
    """run.main in this process: (exit code, last stdout line as JSON or
    None, stderr text)."""
    sys.path.insert(0, os.path.join(REPO, "qbench"))
    try:
        import run
    finally:
        sys.path.pop(0)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(argv, device=device, root=tiny["root"],
                      cache=tiny["cache"])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
