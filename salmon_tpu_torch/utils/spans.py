"""The port's spans and counters, kept in memory.

A span is a named interval of the host's work on time.perf_counter_ns(),
with the id of the batch it belongs to (the mapping loop's submit order,
0-based; -1 outside a batch, and a span opened inside another span of a
batch takes that batch) and the span that was open when it began (its
parent). A counter is a named running sum. Recording is always on: a
span costs a few clock reads and list stores, with no synchronisation
and no device work. While a torch.profiler session is active each span
also enters torch.profiler.record_function(name), so the spans land in
the profiler's trace beside the kernels.

Records go into a ring of `capacity` entries (the newest are kept);
each name's total seconds and calls, and the counters, are kept apart
from the ring and never wrap. The device's side (BatchEvents) adds one
interval a batch: when the card ran the batch's step, on the same host
clock.

    with spans.span("quant.read", batch=b):
        ...
    spans.count("eq_merges")
    spans.records(), spans.totals(), spans.counters(),
    spans.device_intervals()
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

CAPACITY = 1 << 16

Total = collections.namedtuple("Total", "seconds calls")


def _profiling() -> bool:
    """Whether a torch.profiler session is recording (torch's own flag)."""
    flag = getattr(_autograd_profiler, "_is_profiler_enabled", None)
    if flag is None:
        return torch._C._autograd._profiler_enabled()
    return flag


class _Span:
    __slots__ = ("store", "name", "nid", "batch", "seq", "parent", "start",
                 "rf", "th")

    def __init__(self, store, name, nid, batch):
        self.store, self.name, self.nid, self.batch = store, name, nid, batch
        self.rf = None

    def __enter__(self):
        st = self.store
        th = st._thread()
        stack = th.stack
        if stack:
            parent = stack[-1]
            self.parent = parent.seq
            if self.batch < 0:
                self.batch = parent.batch
        else:
            self.parent = -1
        self.th = th
        self.seq = next(st._next)
        stack.append(self)
        if _profiling():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        st, th, seq = self.store, self.th, self.seq
        th.stack.pop()
        tot = th.totals.get(self.nid)
        if tot is None:
            tot = th.totals[self.nid] = [0, 0]
        tot[0] += t - self.start
        tot[1] += 1
        # the record, unless capacity spans began since this one did
        # (its slot is then a newer span's)
        n = st._n
        if seq >= n:
            n = st._n = seq + 1
        if n - seq <= st.capacity:
            st._ring[seq % st.capacity] = (seq, self.nid, self.batch,
                                           self.parent, self.start, t)
        return False


class _Thread:
    """One thread's open spans, totals ([ns, calls] by name id) and
    counters: written by that thread alone, so that recording takes no
    lock."""
    __slots__ = ("stack", "totals", "counters")

    def __init__(self):
        self.stack, self.totals, self.counters = [], {}, {}


class SpanStore:
    """Spans (a ring of `capacity` records), per-name totals, counters
    and per-batch device intervals (a ring of its own). Any thread may
    record; a span's parent is the span its own thread has open. A span
    is recorded when it ends."""

    def __init__(self, capacity: int = CAPACITY):
        if capacity < 1:
            raise ValueError(f"a ring of {capacity} records")
        self.capacity = capacity
        self._lock = threading.Lock()      # names and threads
        self._local = threading.local()
        self._threads: list = []
        self._ids: dict = {}
        self._names: list = []
        self._next = itertools.count()     # seq of the next span
        self._n = 0                        # past the newest seq recorded
        self._ring: list = [None] * capacity
        self._dnext = itertools.count()
        self._dn = 0                       # device intervals added
        self._dring: list = [None] * capacity

    def _id(self, name: str) -> int:
        nid = self._ids.get(name)
        if nid is None:
            with self._lock:
                nid = self._ids.get(name)
                if nid is None:
                    nid = self._ids[name] = len(self._names)
                    self._names.append(name)
        return nid

    def _thread(self) -> _Thread:
        th = getattr(self._local, "th", None)
        if th is None:
            th = self._local.th = _Thread()
            with self._lock:
                self._threads.append(th)
        return th

    def span(self, name: str, batch: int = -1) -> _Span:
        return _Span(self, name, self._id(name), batch)

    def count(self, name: str, n: int = 1) -> None:
        c = self._thread().counters
        c[name] = c.get(name, 0) + n

    def add_interval(self, batch: int, start_ns: int, end_ns: int) -> None:
        """The card's interval of one batch, on the host's clock."""
        i = next(self._dnext)
        self._dring[i % self.capacity] = (i, batch, start_ns, end_ns)
        if i >= self._dn:
            self._dn = i + 1

    def _rows(self, ring: list, n: int, width: int) -> np.ndarray:
        """The ring's rows of the newest `capacity` numbers below n,
        oldest first."""
        lo = max(0, n - self.capacity)
        rows = [r for r in (ring[i % self.capacity] for i in range(lo, n))
                if r is not None and r[0] >= lo]
        rows.sort()
        return np.array(rows, dtype=np.int64).reshape(len(rows), width)

    def records(self) -> dict:
        """The finished spans still in the ring, oldest first: numpy
        arrays name (str), batch, parent (the parent's seq, -1 for
        none), seq (the span's number in the process) and start_ns,
        end_ns (perf_counter_ns)."""
        with self._lock:
            names = np.array(self._names + [""])
        rows = self._rows(self._ring, self._n, 6)
        out = {k: rows[:, i] for i, k in enumerate(
            ("seq", "name", "batch", "parent", "start_ns", "end_ns"))}
        out["name"] = names[out["name"]]
        return out

    def device_intervals(self) -> dict:
        """The device intervals still in the ring, oldest first: numpy
        arrays batch, start_ns, end_ns (perf_counter_ns)."""
        rows = self._rows(self._dring, self._dn, 4)
        return {k: rows[:, i + 1] for i, k in enumerate(
            ("batch", "start_ns", "end_ns"))}

    def totals(self, since: dict | None = None) -> dict:
        """{name: Total(seconds, calls)} of every finished span since the
        process began, or since an earlier totals() `since`."""
        with self._lock:
            names, threads = list(self._names), list(self._threads)
        ns, calls = [0] * len(names), [0] * len(names)
        for th in threads:
            for nid, (v, c) in list(th.totals.items()):
                ns[nid] += v
                calls[nid] += c
        since = since or {}
        zero = Total(0.0, 0)
        return {n: Total(ns[i] * 1e-9 - since.get(n, zero).seconds,
                         calls[i] - since.get(n, zero).calls)
                for i, n in enumerate(names) if calls[i]}

    def counters(self, since: dict | None = None) -> dict:
        """{name: sum} of every counter, or its gain since an earlier
        counters() `since`."""
        with self._lock:
            threads = list(self._threads)
        now = {}
        for th in threads:
            for k, v in list(th.counters.items()):
                now[k] = now.get(k, 0) + v
        since = since or {}
        return {k: v - since.get(k, 0) for k, v in now.items()}


STORE = SpanStore()


def span(name: str, batch: int = -1) -> _Span:
    """A span of the process's store (a context manager)."""
    return STORE.span(name, batch)


def count(name: str, n: int = 1) -> None:
    STORE.count(name, n)


def records() -> dict:
    return STORE.records()


def device_intervals() -> dict:
    return STORE.device_intervals()


def totals(since: dict | None = None) -> dict:
    return STORE.totals(since)


def counters(since: dict | None = None) -> dict:
    return STORE.counters(since)


class BatchEvents:
    """The card's interval of each batch step on the host's clock, from
    a pair of timing events a batch on the device's current stream: one
    recorded just before the step is launched (begin), one just after
    it returns (end: after the step's copy of its outputs). A pool of
    `depth + 2` pairs is reused, so no event is made per batch.

    finish(b) is called once batch b's outputs are on the host, so both
    its events are complete and are read without a synchronisation;
    batches finish in order. The first begin is timed from an anchor
    event that the host's clock reads once, synchronised, at
    construction, and each later begin from the one before: a short
    elapsed time keeps float32's milliseconds fine, and the rounding
    does not add up over a run."""

    def __init__(self, device, depth: int):
        self.stream = torch.cuda.current_stream(device)
        self.pool = [(torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                     for _ in range(depth + 2)]
        self.total_ns = 0
        anchor = torch.cuda.Event(enable_timing=True)
        self.stream.synchronize()
        a = time.perf_counter_ns()
        anchor.record(self.stream)
        b = time.perf_counter_ns()
        anchor.synchronize()
        self._prev = (anchor, (a + b) // 2)

    def begin(self, batch: int) -> None:
        self.pool[batch % len(self.pool)][0].record(self.stream)

    def end(self, batch: int) -> None:
        self.pool[batch % len(self.pool)][1].record(self.stream)

    def finish(self, batch: int) -> None:
        e0, e1 = self.pool[batch % len(self.pool)]
        prev, prev_ns = self._prev
        start = prev_ns + round(prev.elapsed_time(e0) * 1e6)
        dur = round(e0.elapsed_time(e1) * 1e6)
        STORE.add_interval(batch, start, start + dur)
        self.total_ns += dur
        self._prev = (e0, start)
