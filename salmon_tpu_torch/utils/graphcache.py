"""One captured CUDA graph per signature of a batch step.

The port's counterpart of what `jax.jit(..., static_argnums=...)` and
salmon_tpu/utils/aotcache.py do for the JAX package's batch step: the
step is compiled once per signature (input shapes and dtypes, the static
configuration, the Python values the body reads) and every later batch
of that signature runs the compiled program. On the card the program is
a CUDA graph, replayed with one launch in place of the ~1,900 kernel
launches the host issues for an eager step.

A signature's life:
  1. first batch: the step runs eagerly on a side stream. A shape seen
     once (a short last chunk, a one-off call) is never captured, and
     the run warms what capture needs warm (cub's sort workspaces, the
     kernels' lazy module loads).
  2. second batch: static input tensors are made, the step is captured
     into a graph reading them, and the graph is replayed on this batch.
  3. every batch from then on: the batch is copied into the static
     inputs (`_foreach_copy_`) and the graph replayed.
A replay overwrites the graph's static outputs, so each replay's outputs
are copied into the next slot of a ring of `ring` output sets: the
outputs of the `ring - 1` replays before it stay readable. A capture or
replay that fails raises, naming the signature: there is no eager
fallback on the card.

Kernel launch counters (KernelCounter-like: a `by_shape` dict and an
`add(shape_key)` method) count at Python call time, which a replay
skips. The cache records what each counter gained while the step was
captured, takes that back (capture records, it does not launch), and
adds it again at every replay.

Only the caller's tensors go in and out: the cache keeps no reference to
the step function, so what the step closes over (the index tensors) is
freed with its owner.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Sequence

import torch


def tensor_signature(t: torch.Tensor) -> tuple:
    """What a captured graph fixes about one input: shape, dtype, device."""
    return tuple(t.shape), t.dtype, t.device


@dataclasses.dataclass
class SignatureStats:
    """Per signature: batches run eagerly, captures, replays, the capture's
    seconds and the bytes its capture added to the graphs' memory pool."""
    label: str
    eager: int = 0
    captures: int = 0
    replays: int = 0
    capture_seconds: float = 0.0
    pool_bytes: int = 0


class CudaGraphs:
    """The card's side of the cache: eager runs on a side stream, and
    captures into CUDA graphs that share one memory pool. Graphs of one
    cache replay one at a time on one stream and keep their static
    outputs alive, so one pool serves all of them. Each runs on the
    device of its inputs, whichever device is current."""

    def __init__(self):
        self.pool = None
        self.stream = None

    def eager(self, fn: Callable, inputs: list) -> dict:
        with torch.cuda.device(inputs[0].device):
            if self.stream is None:
                self.stream = torch.cuda.Stream()
            main = torch.cuda.current_stream()
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                out = fn(inputs)
            main.wait_stream(self.stream)
        return out

    def capture(self, fn: Callable, inputs: list) -> tuple:
        """(replay, static outputs, bytes the pool grew by)."""
        device = inputs[0].device
        with torch.cuda.device(device):
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            # torch.cuda.graph empties the allocator's cache before it
            # captures; emptying it first makes the reserved bytes after
            # the capture differ from those before by the pool's growth
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                out = fn(inputs)
            grown = torch.cuda.memory_reserved() - before

        def replay():
            with torch.cuda.device(device):
                graph.replay()
        return replay, out, grown


@dataclasses.dataclass
class _Entry:
    inputs: list            # static input tensors the graph reads
    outputs: dict           # static output tensors the graph writes
    replay: Callable
    delta: list             # per counter, {shape_key: launches a replay}
    ring: collections.deque  # output sets, the oldest on the left


class GraphCache:
    """Captured steps by signature. `graphs` does the device's part
    (`eager(fn, inputs)`, `capture(fn, static_inputs)`); the default is
    CudaGraphs, and a test passes a stand-in that runs on the CPU."""

    def __init__(self, counters: Sequence = (), graphs=None):
        self.counters = list(counters)
        self.graphs = graphs if graphs is not None else CudaGraphs()
        self.stats: dict = {}
        self._entries: dict = {}

    def run(self, key, fn: Callable, inputs: list, ring: int = 2,
            label: str | None = None) -> dict:
        """fn(inputs) -> dict of tensors, through the graph of `key`.
        The outputs of the last `ring - 1` calls of this signature stay
        readable; those of older ones are overwritten."""
        if ring < 1:
            raise ValueError(f"a ring of {ring} output sets")
        st = self.stats.get(key)
        if st is None:
            st = self.stats[key] = SignatureStats(label or repr(key))
            st.eager += 1
            return self.graphs.eager(fn, inputs)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = self._capture(key, st, fn, inputs)
        torch._foreach_copy_(entry.inputs, list(inputs))
        try:
            entry.replay()
        except RuntimeError as e:
            raise RuntimeError(f"replay of the captured step {st.label} "
                               f"failed: {e}") from e
        for counter, delta in zip(self.counters, entry.delta):
            for shape_key, n in delta.items():
                for _ in range(n):
                    counter.add(shape_key)
        st.replays += 1
        while len(entry.ring) < ring:
            entry.ring.appendleft({k: torch.empty_like(v)
                                   for k, v in entry.outputs.items()})
        slot = entry.ring.popleft()
        torch._foreach_copy_(list(slot.values()),
                             [entry.outputs[k] for k in slot])
        entry.ring.append(slot)
        return dict(slot)

    def _capture(self, key, st: SignatureStats, fn: Callable,
                 inputs: list) -> _Entry:
        static = [torch.empty_like(t) for t in inputs]
        before = [dict(c.by_shape) for c in self.counters]
        t0 = time.perf_counter()
        try:
            replay, outputs, pool_bytes = self.graphs.capture(fn, static)
        except RuntimeError as e:
            raise RuntimeError(f"capture of the step {st.label} failed: "
                               f"{e}") from e
        delta = []
        for c, b in zip(self.counters, before):
            delta.append({k: n - b.get(k, 0) for k, n in c.by_shape.items()
                          if n != b.get(k, 0)})
            c.by_shape = b
        st.captures += 1
        st.capture_seconds += time.perf_counter() - t0
        st.pool_bytes += pool_bytes
        return _Entry(static, dict(outputs), replay, delta,
                      collections.deque())


def stats_totals(stats) -> dict:
    """SignatureStats summed over signatures."""
    sts = list(stats)
    return {"signatures": len(sts),
            "eager": sum(s.eager for s in sts),
            "captures": sum(s.captures for s in sts),
            "replays": sum(s.replays for s in sts),
            "capture_seconds": sum(s.capture_seconds for s in sts),
            "pool_bytes": sum(s.pool_bytes for s in sts)}
