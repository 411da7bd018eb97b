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
  2. second batch: static input tensors are made (copies of this
     batch), the step is captured into a graph reading them, and the
     graph is replayed on this batch.
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

A loop's step (`step`: the EM's chunk of iterations, a Gibbs sample, a
bias pass's body for one fragment length) has no inputs or outputs of
its own: it reads and updates, in place, tensors that the caller keeps
at their addresses for as long as the cache lives, so its state goes
from one replay to the next without a copy or a host round trip. Its
first step runs eagerly, its second is captured and replayed, and every
later one is replayed: within one call, since the caller knows that the
step repeats. Such a cache (loop_cache) lives for one call of the loop,
and captures through its device's loop_graphs: one side stream and one
memory pool for every loop of the process, so that a capture takes the
blocks that earlier ones freed (the allocator hands a block only to the
stream that freed it) and the pool grows to the largest step's working
set, once a process.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, Sequence

import torch

from salmon_tpu_torch.utils import spans

# the spans of a loop's steps (step, loop_step), by which a profiler's
# trace tells the host's launches of eager, captured and replayed steps
# apart (scripts/bench_graph_post.py)
STEP_SCOPES = {k: f"loop step: {k}" for k in ("eager", "capture", "replay")}


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
        # the last graph captured, kept so that the pool outlives the
        # graphs of the caches that capture through this object
        # (loop_graphs): a pool that no graph holds is released, and
        # cannot be captured into again
        self.last = None
        self.grown = 0      # bytes the captures added to the pool

    def eager(self, fn: Callable, inputs: list, device=None) -> dict:
        with torch.cuda.device(device if device is not None
                               else inputs[0].device):
            if self.stream is None:
                self.stream = torch.cuda.Stream()
            main = torch.cuda.current_stream()
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                out = fn(inputs)
            main.wait_stream(self.stream)
        return out

    def capture(self, fn: Callable, inputs: list, device=None,
                generator: torch.Generator | None = None) -> tuple:
        """(replay, static outputs, bytes the pool grew by). A generator
        that the step draws from is registered with the graph, so that
        each replay advances its Philox offset as an eager run would."""
        device = device if device is not None else inputs[0].device
        with torch.cuda.device(device):
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            if self.stream is None:
                self.stream = torch.cuda.Stream()
            # what torch.cuda.graph does, without emptying the
            # allocator's cache first (which would free its blocks, to
            # be allocated again after the capture: a cost that every
            # loop's capture would pay). A capture allocates in the
            # graphs' private pool only, so the reserved bytes grow by
            # the pool's growth.
            before = torch.cuda.memory_reserved()
            graph = torch.cuda.CUDAGraph()
            if generator is not None:
                graph.register_generator_state(generator)
            main = torch.cuda.current_stream()
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    out = fn(inputs)
                except BaseException:
                    # end the failed capture; its error is fn's
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
            main.wait_stream(self.stream)
            grown = torch.cuda.memory_reserved() - before
            self.grown += grown
            self.last = graph

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
    (`eager(fn, inputs, device=None)`, `capture(fn, static_inputs,
    device=None, generator=None)`); the default is CudaGraphs, and a
    test passes a stand-in that runs on the CPU."""

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
            with spans.span(f"step.eager {st.label}"):
                return self.graphs.eager(fn, inputs)
        entry = self._entries.get(key)
        if entry is None:
            # the static inputs hold this batch while it is captured, so
            # that what runs at capture (a stand-in's step) sees real data
            with spans.span(f"step.capture {st.label}"):
                static = [t.clone() for t in inputs]
                entry = self._entries[key] = self._capture(
                    st, lambda: self.graphs.capture(fn, static), static)
        torch._foreach_copy_(entry.inputs, list(inputs))
        self._replay(st, entry)
        while len(entry.ring) < ring:
            entry.ring.appendleft({k: torch.empty_like(v)
                                   for k, v in entry.outputs.items()})
        slot = entry.ring.popleft()
        torch._foreach_copy_(list(slot.values()),
                             [entry.outputs[k] for k in slot])
        entry.ring.append(slot)
        return dict(slot)

    def step(self, key, fn: Callable, device, label: str | None = None,
             generator: torch.Generator | None = None) -> None:
        """One step of a loop: fn() updates in place tensors that the
        caller keeps alive at their addresses while this cache lives.
        The signature's first step runs eagerly, its second is captured
        (a `generator` that fn draws from is registered with the graph)
        and replayed, every later one replayed."""
        st = self.stats.get(key)
        if st is None:
            st = self.stats[key] = SignatureStats(label or repr(key))
            st.eager += 1
            with spans.span(STEP_SCOPES["eager"]):
                self.graphs.eager(lambda _: fn(), [], device=device)
            return
        entry = self._entries.get(key)
        if entry is None:
            with spans.span(STEP_SCOPES["capture"]):
                entry = self._entries[key] = self._capture(
                    st, lambda: self.graphs.capture(
                        lambda _: fn() or {}, [], device=device,
                        generator=generator), [])
        with spans.span(STEP_SCOPES["replay"]):
            self._replay(st, entry)

    def drop(self, key) -> None:
        """Forget the graph of `key` (its stats stay): a loop that is
        done with a signature frees its graph."""
        self._entries.pop(key, None)

    def _replay(self, st: SignatureStats, entry: "_Entry") -> None:
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

    def _capture(self, st: SignatureStats, capture: Callable,
                 static: list) -> _Entry:
        before = [dict(c.by_shape) for c in self.counters]
        t0 = time.perf_counter()
        try:
            replay, outputs, pool_bytes = capture()
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


def run_compiled(cache: GraphCache | None, key, fn: Callable,
                 inputs: list, label: str) -> dict:
    """fn(inputs) -> dict of tensors as a compiled step: through the
    graph of `key` in `cache`, or, without a cache, fn itself on CPU
    tensors (its plain version). A step on the card needs a cache: there
    is no eager path there."""
    if cache is None:
        if inputs[0].is_cuda:
            raise ValueError(f"{label} runs on the card through a "
                             f"GraphCache")
        return fn(inputs)
    return cache.run(key, fn, inputs, label=label)


def stats_totals(stats) -> dict:
    """SignatureStats summed over signatures."""
    sts = list(stats)
    return {"signatures": len(sts),
            "eager": sum(s.eager for s in sts),
            "captures": sum(s.captures for s in sts),
            "replays": sum(s.replays for s in sts),
            "capture_seconds": sum(s.capture_seconds for s in sts),
            "pool_bytes": sum(s.pool_bytes for s in sts)}


# the loops' CudaGraphs, by device index (loop_graphs)
_LOOP_GRAPHS: dict = {}


def loop_graphs(device) -> CudaGraphs:
    """The CudaGraphs through which every loop's cache on `device`
    captures: one side stream and one memory pool, kept for the process
    (it keeps its last graph). A capture reuses what earlier captures
    freed in the pool, so the pool holds the largest loop step's working
    set, not one per graph; a replay's intermediates live there too, so
    loops run one at a time on a device (one loop's graphs replay only
    while it runs, as the quant's stages do)."""
    device = torch.device(device)
    idx = (device.index if device.index is not None
           else torch.cuda.current_device())
    graphs = _LOOP_GRAPHS.get(idx)
    if graphs is None:
        graphs = _LOOP_GRAPHS[idx] = CudaGraphs()
    return graphs


def loop_cache(device) -> GraphCache | None:
    """A GraphCache for one call of a loop on `device`, capturing through
    loop_graphs; None on the CPU, where the loop runs its eager body."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return GraphCache(graphs=loop_graphs(device))


def loop_step(cache: GraphCache | None, key, fn: Callable, device,
              label: str | None = None,
              generator: torch.Generator | None = None) -> None:
    """cache.step(...), or fn() itself where there is no cache: the
    eager body, which the CPU runs as its plain version."""
    if cache is None:
        with spans.span(STEP_SCOPES["eager"]):
            fn()
    else:
        cache.step(key, fn, device, label, generator)
