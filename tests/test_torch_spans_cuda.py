"""The card's per-batch intervals (utils.spans.BatchEvents) of a small
paired quantify: each lies between its batch's quant.submit start and
its quant.wait end on the host's clock, and they follow one another.
Needs an NVIDIA GPU and skips without one; the file imports nothing of
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_spans_cuda.py
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from salmon_tpu_torch.constants import DEFAULTS
from salmon_tpu_torch.index.builder import build_index
from salmon_tpu_torch.quant import quantify
from salmon_tpu_torch.utils import spans

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA events have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_intervals_inside_their_batches(cuda, monkeypatch):
    store = spans.SpanStore()
    monkeypatch.setattr(spans, "STORE", store)
    idx = build_index(os.path.join(DATA, "transcripts.fasta"), k=31)
    opts = dataclasses.replace(DEFAULTS, reads_per_batch=1024,
                               progress_update_ms=0)
    res = quantify(idx, "IU", [os.path.join(DATA, "reads_1.fastq")],
                   [os.path.join(DATA, "reads_2.fastq")], opts, device=cuda)
    n = res.num_batches
    dv = store.device_intervals()
    rec = store.records()
    assert list(dv["batch"]) == list(range(n))

    def first(name):
        m = rec["name"] == name
        out = {}
        for b, s, e in zip(rec["batch"][m], rec["start_ns"][m],
                           rec["end_ns"][m]):
            out[int(b)] = (int(s), int(e))
        return out
    submit, wait = first("quant.submit"), first("quant.wait")
    for b, s, e in zip(dv["batch"], dv["start_ns"], dv["end_ns"]):
        assert submit[int(b)][0] <= s < e <= wait[int(b)][1], int(b)
    # one stream: each batch's step starts after the one before ended
    assert np.all(dv["start_ns"][1:] >= dv["end_ns"][:-1])
    assert store.totals()["quant.wait"].calls == n
