"""The port's span store (salmon_tpu_torch.utils.spans): the store itself,
the spans and clocks of a small paired quantify on the CPU, the eq-class
accumulator's merge counters, and the benchmark's readers of the store
(qbench/metrics) on a synthetic run. The card's per-batch intervals:
tests/test_torch_spans_cuda.py."""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
import threading

import numpy as np
import pytest
import torch

from qbench.lib.cell import Run
from qbench.lib.registry import Registry
from salmon_tpu_torch.constants import DEFAULTS
from salmon_tpu_torch.index.builder import build_index
from salmon_tpu_torch.inference.eqclasses import (INVALID_TXP,
                                                  EquivalenceClassAccumulator)
from salmon_tpu_torch.quant import quantify
from salmon_tpu_torch.utils import spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


class FakeClock:
    """perf_counter_ns at a time the test sets, in seconds."""

    def __init__(self):
        self.now = 0

    def at(self, t: float) -> None:
        self.now = int(round(t * 1e9))

    def perf_counter_ns(self) -> int:
        return self.now


@pytest.fixture
def fresh(monkeypatch):
    """A store of the process's own (spans.STORE) that starts empty."""
    st = spans.SpanStore()
    monkeypatch.setattr(spans, "STORE", st)
    return st


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(spans, "time", c)
    return c


def _by_seq(rec):
    return {int(s): i for i, s in enumerate(rec["seq"])}


def test_parents_and_nesting(fresh, clock):
    clock.at(1.0)
    with spans.span("outer", 3):
        clock.at(1.1)
        with spans.span("inner"):
            clock.at(1.2)
            with spans.span("leaf", 5):
                clock.at(1.25)
            clock.at(1.3)
        clock.at(1.4)
    with spans.span("after"):
        clock.at(1.5)
    rec = spans.records()
    assert list(rec["name"]) == ["outer", "inner", "leaf", "after"]
    # a span takes its parent's batch unless it names its own
    assert list(rec["batch"]) == [3, 3, 5, -1]
    seq = rec["seq"]
    assert list(rec["parent"]) == [-1, seq[0], seq[1], -1]
    np.testing.assert_array_equal(
        rec["end_ns"] - rec["start_ns"],
        np.array([0.4, 0.2, 0.05, 0.1]) * 1e9)


def test_threads_keep_their_own_parents(fresh):
    seen = {}

    def work():
        with spans.span("thread.top"):
            with spans.span("thread.child"):
                pass
        seen["done"] = True

    with spans.span("main.top", 1):
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive() and seen["done"]
    rec = spans.records()
    names = list(rec["name"])
    top = names.index("thread.top")
    child = names.index("thread.child")
    assert rec["parent"][top] == -1 and rec["batch"][top] == -1
    assert rec["parent"][child] == rec["seq"][top]
    assert spans.totals()["thread.child"].calls == 1


def test_ring_wraps_totals_intact(clock):
    st = spans.SpanStore(capacity=8)
    for b in range(20):
        clock.at(b)
        with st.span("step", b):
            clock.at(b + 0.001 * (b + 1))
    rec = st.records()
    assert list(rec["batch"]) == list(range(12, 20))
    assert list(rec["seq"]) == list(range(12, 20))
    tot = st.totals()["step"]
    assert tot.calls == 20
    assert tot.seconds == pytest.approx(0.001 * sum(range(1, 21)))
    # totals since a mark
    mark = st.totals()
    clock.at(100.0)
    with st.span("step", 20):
        clock.at(100.5)
    assert st.totals(mark)["step"] == (pytest.approx(0.5), 1)


def test_counters(fresh):
    spans.count("rows", 5)
    spans.count("rows", 7)
    spans.count("merges")
    mark = spans.counters()
    assert mark == {"rows": 12, "merges": 1}
    spans.count("rows", 3)
    assert spans.counters(mark) == {"rows": 3, "merges": 0}


def test_device_intervals_ring():
    st = spans.SpanStore(capacity=4)
    for b in range(6):
        st.add_interval(b, 10 * b, 10 * b + 3)
    dv = st.device_intervals()
    assert list(dv["batch"]) == [2, 3, 4, 5]
    assert list(dv["end_ns"] - dv["start_ns"]) == [3] * 4


def test_profiler_names(fresh):
    from torch.profiler import ProfilerActivity, profile
    with spans.span("outside.profiler") as sp:
        assert sp.rf is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("inside.profiler") as sp:
            assert sp.rf is not None
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "inside.profiler" in names
    assert "outside.profiler" not in names
    # both are in the store either way
    assert {"inside.profiler", "outside.profiler"} <= set(
        spans.records()["name"])


# --- a small paired quantify on the CPU --------------------------------

class _Clocks(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.INFO)
        self.clocks = {}

    def emit(self, record):
        self.clocks.update(getattr(record, "clocks", None) or {})


@pytest.fixture(scope="module")
def quant_run():
    """quantify on tests/data in batches of 1,024 pairs, with a store of
    its own: (records, clocks, batches, totals)."""
    torch.set_num_threads(2)
    idx = build_index(os.path.join(DATA, "transcripts.fasta"), k=31)
    store = spans.SpanStore()
    saved = spans.STORE
    spans.STORE = store
    tap = _Clocks()
    lg = logging.getLogger("salmon_tpu_torch")
    level = lg.level
    lg.addHandler(tap)
    lg.setLevel(logging.INFO)
    try:
        opts = dataclasses.replace(DEFAULTS, reads_per_batch=1024,
                                   progress_update_ms=0)
        res = quantify(idx, "IU", [os.path.join(DATA, "reads_1.fastq")],
                       [os.path.join(DATA, "reads_2.fastq")], opts,
                       device="cpu")
    finally:
        spans.STORE = saved
        lg.removeHandler(tap)
        lg.setLevel(level)
    return store.records(), tap.clocks, res.num_batches, store.totals()


def test_quant_batch_spans(quant_run):
    rec, _, n, _ = quant_run
    assert n == 10
    for name in ("quant.submit", "quant.consume", "quant.wait", "quant.eq",
                 "eq.dedupe"):
        assert sorted(rec["batch"][rec["name"] == name]) == list(range(n)), \
            name
    # each batch's read, and the read that finds the end of the input
    assert sorted(rec["batch"][rec["name"] == "quant.read"]) == \
        list(range(n + 1))
    # in each batch: read, then submit, then (after the next submit)
    # consume
    first = {}
    for name, b, s in zip(rec["name"], rec["batch"], rec["start_ns"]):
        first.setdefault((str(name), int(b)), int(s))
    for b in range(n):
        assert first[("quant.read", b)] < first[("quant.submit", b)] \
            < first[("quant.consume", b)]
        if b + 1 < n:
            assert first[("quant.submit", b + 1)] < \
                first[("quant.consume", b)]


def test_quant_nesting(quant_run):
    rec, _, _, _ = quant_run
    at = _by_seq(rec)
    names = rec["name"]
    for child, parent in (("quant.wait", "quant.consume"),
                          ("quant.eq", "quant.consume"),
                          ("eq.dedupe", "quant.eq"),
                          ("quant.consume", "quant.loop"),
                          ("quant.submit", "quant.loop")):
        for i in np.flatnonzero(names == child):
            p = at[int(rec["parent"][i])]
            assert names[p] == parent, (child, names[p])
            assert rec["start_ns"][p] <= rec["start_ns"][i] <= \
                rec["end_ns"][i] <= rec["end_ns"][p]
            if parent != "quant.loop":
                assert rec["batch"][p] == rec["batch"][i]


def test_quant_clocks_are_span_sums(quant_run):
    rec, clocks, n, tot = quant_run

    def total(name):
        m = rec["name"] == name
        return 1e-9 * float((rec["end_ns"][m] - rec["start_ns"][m]).sum())
    assert clocks["mapped_batches"] == n
    assert clocks["read_seconds"] == pytest.approx(total("quant.read"))
    assert clocks["eq_accumulate_seconds"] == pytest.approx(
        total("quant.eq"))
    assert clocks["consume_seconds"] == pytest.approx(
        total("quant.consume") - total("quant.eq"))
    assert clocks["submit_seconds"] == pytest.approx(total("quant.submit"))
    assert clocks["device_wait_seconds"] == pytest.approx(
        total("quant.wait"))
    assert clocks["eq_dedupe_seconds"] == pytest.approx(total("eq.dedupe"))
    assert clocks["index_prep_seconds"] == pytest.approx(
        tot["index.prep"].seconds)
    assert clocks["index_h2d_seconds"] == pytest.approx(
        tot["index.h2d"].seconds)
    # the five index tensors' bytes
    assert clocks["index_h2d_bytes"] > 0
    for key in ("eq_merge_seconds", "eq_merges", "eq_rows_merged",
                "map_seconds", "map_loop_seconds", "em_seconds"):
        assert key in clocks
    # no device, no intervals
    assert "step_device_seconds" not in clocks
    assert 0 < clocks["map_loop_seconds"] <= clocks["map_seconds"]


# --- the accumulator's merges --------------------------------------------

def test_eq_merge_counters(fresh, monkeypatch):
    rng = np.random.default_rng(5)
    acc = EquivalenceClassAccumulator(merge_buffer_rows=40)
    done = []
    collapse = EquivalenceClassAccumulator._collapse

    def counted(self):
        if len(self._chunks) > 1:
            done.append(sum(c[0].shape[0] for c in self._chunks))
        return collapse(self)
    monkeypatch.setattr(EquivalenceClassAccumulator, "_collapse", counted)
    for _ in range(30):
        txp = np.full((64, 4), INVALID_TXP, np.int32)
        txp[:, 0] = rng.integers(0, 200, 64)
        txp[:8, 1] = 500
        txp[:] = np.sort(txp, axis=1)
        acc.add_batch(txp, rng.random((64, 4)).astype(np.float32))
    assert len(done) >= 3
    c = spans.counters()
    assert c["eq_merges"] == len(done)
    assert c["eq_rows_merged"] == sum(done)
    tot = spans.totals()
    assert tot["eq.merge"].calls == len(done)
    assert tot["eq.dedupe"].calls == 30
    # each class is opened by one merged row: the rest found their class
    n = acc.num_classes   # merges the batches still pending
    assert spans.counters()["eq_rows_new"] == n


# --- the benchmark's readers of the store --------------------------------

READERS = {
    # name: its value on the synthetic run, computed by hand
    "submit_ms_per_batch.map": (2 + 6 + 7 + 8) / 4,
    "device_wait_ms_per_batch.map": 2.0,
    "eq_dedupe_ms_per_batch.map": 0.5,
    "eq_merge_ms_per_batch.map": 10.0 / 4,
    "step_device_ms_per_batch.map": (2 + 6 + 7 + 8) / 4,
    "device_idle_window.map": 100.0 * (1 - 0.023 / 0.4),
    "index_prep_s.setup": 0.2,
    "index_h2d_s.setup": 0.15,
}


def _synthetic_run():
    """Batches 0-7 with progress records at 1.0 + 0.1 b s; the window
    (1.05, 1.75] holds batches 1-7, of which the traced batch 2 and the
    two after it are left out: 1, 5, 6, 7 are measured, over 0.4 s."""
    progress = [(1.0 + 0.1 * b, 100 * (b + 1)) for b in range(8)]
    return Run(cell={"trace_skip_batches": 1}, clocks={}, progress=progress,
               window=(1.05, 1.75), open_batch=1, spans={}, trace=None,
               traced_batches=1)


def _record_synthetic(clock):
    """Spans of an older run, then this run's set-up and loop: batch b's
    submit takes 1 + b ms, its wait 2 ms, its dedupe 0.5 ms; batch 6
    merges for 10 ms; on the card batch b runs 1 + b ms."""
    for name, s, e in (("quant.loop", 0.0, 0.01), ("quant.submit", 0.001,
                                                   0.009)):
        clock.at(s)
        with spans.span(name, 1 if name != "quant.loop" else -1):
            clock.at(e)
    for name, s, e in (("index.prep", 0.02, 0.07), ("index.prep", 0.1, 0.3),
                       ("index.h2d", 0.3, 0.45)):
        clock.at(s)
        with spans.span(name):
            clock.at(e)
    clock.at(0.5)
    with spans.span("quant.loop"):
        for b in range(8):
            t = 1.0 + 0.1 * b
            clock.at(t - 0.09)
            with spans.span("quant.submit", b):
                clock.at(t - 0.09 + 0.001 * (1 + b))
            clock.at(t - 0.03)
            with spans.span("quant.consume", b):
                with spans.span("quant.wait"):
                    clock.at(t - 0.028)
                with spans.span("quant.eq"):
                    with spans.span("eq.dedupe"):
                        clock.at(t - 0.0275)
                    if b == 6:
                        with spans.span("eq.merge"):
                            clock.at(t - 0.0175)
                clock.at(t)
            spans.STORE.add_interval(
                b, round((t - 0.05) * 1e9),
                round((t - 0.05 + 0.001 * (1 + b)) * 1e9))
        clock.at(1.9)
    # set-up after the window is not this run's
    clock.at(2.0)
    with spans.span("index.prep"):
        clock.at(2.5)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_value(fresh, clock, name):
    _record_synthetic(clock)
    got = Registry(REPO).metric_reader(name)(_synthetic_run())
    assert got == pytest.approx(READERS[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_records(fresh, monkeypatch, name):
    read = Registry(REPO).metric_reader(name)
    assert read(_synthetic_run()) is None
    # a program without the store
    import salmon_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "salmon_tpu_torch.utils.spans", None)
    assert read(_synthetic_run()) is None


def test_readers_in_benchmark():
    bench = Registry(REPO).bench
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["source"] == "program_span"
        assert m["workloads"] == ["paralog-vbem.stream",
                                  "paralog-vbem.offtarget"]
