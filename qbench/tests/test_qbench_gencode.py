"""The gencode-vbem cell's configuration on the CPU: a 3,000-transcript
copy of it (batches of 256) through run.main is correct, with the
program's wide pass completing the labels that the batch step's caps
cut; under --control 1 it is not."""

from __future__ import annotations

import os

import pytest

from conftest import make_tiny_root, run_main


@pytest.fixture(scope="module")
def gencode(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("gencode"))
    return {"root": make_tiny_root(d, "gencode-vbem", n_txps=3000),
            "cache": os.path.join(d, "cache")}


@pytest.mark.parametrize("control", [0, 1], ids=["sound", "control"])
def test_gencode_cell(gencode, control):
    rc, res, err = run_main(gencode, [
        "--workload", "tiny.stream", "--seconds", "2", "--seed",
        "3000000017", "--trace", "0", "--control", str(control)])
    assert rc == 0, err[-3000:]
    assert res["correct"] is (not control), err[-3000:]
    if not control:
        assert res["check"]["map_answer_mismatch"]["value"] <= 0.01
