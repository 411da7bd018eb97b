"""A CPU rehearsal of run.py on the tiny cell: the contract's last line,
the traced run's per-layer metrics, and `correct` false under the
control and under each fault the cell can have, planted in the timed
path underneath the harness (which skips its look for a chip)."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from conftest import make_tiny_root, run_main

ARGS = ["--workload", "tiny.stream", "--seconds", "2"]


def test_result_line(tiny):
    rc, res, err = run_main(tiny, ARGS + ["--seed", "3000000017",
                                          "--trace", "0"])
    assert rc == 0, err[-3000:]
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device", "check"}
    assert list(res)[-1] == "check"
    assert res["correct"] is True, err[-3000:]
    assert set(res["metrics"]) == {"setup_s", "map_frags_per_s",
                                   "peak_device_mib", "peak_rss_mib"}
    assert set(res["check"]) == {"map_answer_mismatch", "eq_class_gap",
                                 "efflen_gap", "em_numreads_gap"}
    assert res["failed"] == 0 and res["attempted"] > 0
    assert "check correct: True" in err.strip().splitlines()[-1]


def test_traced_result_line(tiny):
    rc, res, err = run_main(tiny, ARGS + ["--seed", "-5", "--trace", "1"])
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    names = set(res["metrics"])
    assert {"read_ms_per_batch.map", "index_upload_s.setup",
            "index_load_s.setup"} <= names
    assert "setup_s" not in names
    assert "breakdown" in res and "window_s" in res["device"]


def _alter(out):
    t = out["eq_txp"]
    out["eq_txp"] = torch.where(t != 0x7FFFFFFF, (t + 1) % 300, t)
    return out


def _halve(out):
    half = out["eq_txp"].shape[0] // 2
    out["eq_txp"] = out["eq_txp"].clone()
    out["eq_txp"][half:] = 0x7FFFFFFF
    out["eq_weight"] = out["eq_weight"].clone()
    out["eq_weight"][half:] = 0.0
    return out


@pytest.mark.parametrize("fault", ["label_altered", "half_batch_left_out",
                                   "eq_merge_dropped", "em_state_unchanged",
                                   "control"])
def test_not_correct(tiny, monkeypatch, fault):
    from salmon_tpu_torch.inference import em, eqclasses
    from salmon_tpu_torch.mapping import pipeline

    argv = ARGS + ["--seed", "41", "--trace", "0"]
    if fault in ("label_altered", "half_batch_left_out"):
        orig = pipeline.map_paired_batch_impl
        change = _alter if fault == "label_altered" else _halve

        def broken(*a, **kw):
            return change(orig(*a, **kw))
        monkeypatch.setattr(pipeline, "map_paired_batch_impl", broken)
    elif fault == "eq_merge_dropped":
        acc = eqclasses.EquivalenceClassAccumulator
        orig_collapse = acc._collapse

        def dropped(self):
            # the newest batch's table is lost in the merge
            if len(self._chunks) > 1:
                self._chunks.pop()
            return orig_collapse(self)
        monkeypatch.setattr(acc, "_collapse", dropped)
    elif fault == "em_state_unchanged":
        orig_em = em.run_em

        def unchanged(labels, seg, counts, aux, sizes, alpha0, *a, **kw):
            out = orig_em(labels, seg, counts, aux, sizes, alpha0, *a, **kw)
            return (alpha0.clone(),) + tuple(out[1:])
        monkeypatch.setattr(em, "run_em", unchanged)
    else:
        argv += ["--control", "1"]
    rc, res, err = run_main(tiny, argv)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, err[-3000:]


def test_checkout_without_program_fails(tmp_path):
    root = make_tiny_root(str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "qbench/run.py", "--workload",
                        "tiny.stream", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()
