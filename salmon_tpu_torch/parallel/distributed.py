"""Multi-process quantification: one process per device.

Counterpart of salmon_tpu/parallel/distributed.py. Where the JAX
package runs one process over a mesh of devices, the port runs one
process (a rank) per device on a torch.distributed group:

  * reads: each reads group streams its own chunk of every step (or its
    own input files), so no rank parses what another maps;
  * fixed-size statistics (counters, FLD, online mass) are all-reduced
    over the world each batch (parallel.quant_step) and come back equal
    on every rank;
  * the variable-size eq-class tables accumulate per rank and are
    gathered once after the stream (allgather_eq_state), so every rank
    ends with the same table, runs the same EM, and rank 0 writes.

Launch: `python -m salmon_tpu_torch.parallel.launch --nprocs N -- quant
...`, or set SALMON_TPU_COORDINATOR (host:port of rank 0),
SALMON_TPU_NUM_PROCS and SALMON_TPU_PROC_ID and run the normal CLI in
every process, as for the JAX package.

Placement decides the collectives' backend, never a failure: the host
collectives (eq tables, bias histograms, has-data flags) always run on
the default gloo group; device tensors (seed hits, batch statistics,
the sharded EM) run on an NCCL group when every rank has a GPU of its
own, and on gloo through host copies when ranks share a GPU or run on
the CPU.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import datetime
import logging
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("salmon_tpu_torch")

ENV_COORD = "SALMON_TPU_COORDINATOR"
ENV_NPROC = "SALMON_TPU_NUM_PROCS"
ENV_PID = "SALMON_TPU_PROC_ID"
# a rank that dies fails its peers' next collective after this long at
# the latest; long enough for the slowest rank's index and shard build
INIT_TIMEOUT = datetime.timedelta(minutes=30)


def layout(rank: int, size: int, n_shards: int) -> tuple:
    """(reads group, kmer index, number of reads groups) of rank `rank`
    of `size` under `n_shards` index shards: rank r sits in reads group
    r // n_shards at kmer index r % n_shards, as the JAX package's
    process-major reshape(n // S, S) mesh places its devices."""
    if size % n_shards:
        raise ValueError(f"{size} devices not divisible by {n_shards} "
                         f"index shards")
    return rank // n_shards, rank % n_shards, size // n_shards


@dataclasses.dataclass
class World:
    """This process's place in a multi-process run."""
    rank: int
    size: int
    device: torch.device
    backend: str                  # of the device collectives
    device_group: object = None   # their group (None: the default one)
    # seconds spent in each collective, by name
    clocks: dict = dataclasses.field(default_factory=dict)
    _events: list = dataclasses.field(default_factory=list)
    _kmer_groups: dict = dataclasses.field(default_factory=dict)

    def layout(self, n_shards: int) -> tuple:
        return layout(self.rank, self.size, n_shards)

    def kmer_group(self, n_shards: int):
        """The group of this rank's reads group (its n_shards ranks, in
        kmer-index order). The first call for a shard count is
        collective: every rank creates every group, and joins its own
        with one small all-reduce, so that no later clock holds the
        set-up."""
        if n_shards not in self._kmer_groups:
            mine = None
            for g in range(self.size // n_shards):
                ranks = list(range(g * n_shards, (g + 1) * n_shards))
                grp = dist.new_group(ranks, timeout=INIT_TIMEOUT,
                                     backend=self.backend)
                if self.rank in ranks:
                    mine = grp
            _warm_up(mine, self._via(torch.zeros(1, device=self.device)))
            self._kmer_groups[n_shards] = mine
        return self._kmer_groups[n_shards]

    @contextlib.contextmanager
    def timed(self, name: str, host: bool = False):
        """Adds the seconds of the block to clocks[name] (read_clocks
        returns them). A block of device work on a GPU is timed by two
        CUDA events on the current stream, so the clock makes the host
        wait for nothing: it reads the device's time from the block's
        start to its end, the work queued before it excluded. `host`:
        the block is host work, timed by the host's clock."""
        if host or self.device.type != "cuda":
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.clocks[name] = (self.clocks.get(name, 0.0)
                                     + time.perf_counter() - t0)
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._events.append((name, start, end))

    def read_clocks(self) -> dict:
        """clocks, after the device has reached every timed block's
        end."""
        for name, start, end in self._events:
            end.synchronize()
            self.clocks[name] = (self.clocks.get(name, 0.0)
                                 + start.elapsed_time(end) / 1e3)
        self._events.clear()
        return self.clocks

    def reset_clocks(self) -> None:
        self.clocks.clear()
        self._events.clear()

    def _via(self, t: torch.Tensor) -> torch.Tensor:
        """`t` where the device collectives' backend takes it."""
        return t if self.backend == "nccl" else t.cpu()

    def all_gather_cat(self, t: torch.Tensor, group=None) -> torch.Tensor:
        """Concatenation over the ranks of `group` (default: the world),
        in group-rank order, of equal-shaped tensors."""
        n = dist.get_world_size(group)
        src = self._via(t.contiguous())
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src,
                        group=group if group is not None
                        else self.device_group)
        return torch.cat(parts).to(t.device)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over the world (a new tensor on t's device)."""
        buf = self._via(t).clone()
        dist.all_reduce(buf, group=self.device_group)
        return buf.to(t.device)


def _warm_up(group, t: torch.Tensor) -> None:
    """One all-reduce on `group`: NCCL sets its communicator up at the
    first collective."""
    dist.all_reduce(t, group=group)


_world: World | None = None


def init(coordinator: str, num_procs: int, proc_id: int,
         device=None) -> World:
    """Join the run's process group (once per process; later calls
    return the same World). `device`: the CUDA device
    cuda:{proc_id % device count} by default, or the one given."""
    global _world
    if _world is not None:
        return _world
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("salmon_tpu_torch needs a CUDA device and "
                               "none is visible")
        device = torch.device("cuda", proc_id % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_procs, rank=proc_id,
                            timeout=INIT_TIMEOUT)
    places = [None] * num_procs
    dist.all_gather_object(places, (socket.gethostname(), device.type,
                                    device.index))
    own_gpu = device.type == "cuda" and len(set(places)) == num_procs
    backend = "nccl" if own_gpu else "gloo"
    group = None
    if own_gpu:
        group = dist.new_group(backend="nccl", timeout=INIT_TIMEOUT)
        _warm_up(group, torch.zeros(1, device=device))
    _world = World(rank=proc_id, size=num_procs, device=device,
                   backend=backend, device_group=group)
    atexit.register(_leave)
    logger.info("process %d/%d on %s; device collectives over %s (%s)",
                proc_id, num_procs, device, backend,
                "one GPU per rank" if own_gpu else
                "ranks share a GPU" if device.type == "cuda" else "CPU")
    return _world


def _leave() -> None:
    """Leave the group at interpreter exit, before finalization: a gloo
    group left to the finalizer aborts the process now and then
    (SIGABRT, "terminate called without an active exception") after its
    work is done, as its threads still run while the interpreter
    finalizes."""
    if dist.is_initialized():
        dist.destroy_process_group()


def init_from_env(device=None) -> World | None:
    """init() from SALMON_TPU_COORDINATOR / _NUM_PROCS / _PROC_ID; None
    when they are absent (a single-process run)."""
    coord = os.environ.get(ENV_COORD)
    if not coord:
        return None
    return init(coord, int(os.environ[ENV_NPROC]),
                int(os.environ[ENV_PID]), device)


def process_info() -> tuple:
    """(rank, number of processes) of this process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _gather_host(a: np.ndarray) -> np.ndarray:
    """(world, *a.shape) stack of every rank's equal-shaped host array,
    in rank order, bit-exact (the default gloo group)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).numpy()


def any_rank(flag: bool) -> bool:
    """Whether `flag` holds on any rank (a has-data vote: per-rank file
    streams end together)."""
    return bool(_gather_host(np.array([int(flag)], np.int32)).sum())


def allgather_eq_state(keys: np.ndarray, counts: np.ndarray,
                       wsum: np.ndarray):
    """Every rank's (collapsed) eq-table rows, concatenated in rank
    order, the same on every rank. Row counts may differ per rank, zero
    included; rows are padded to the largest and trimmed after."""
    n_local = keys.shape[0]
    k_cols = keys.shape[1] if keys.size else 0
    w_cols = wsum.shape[1] if wsum.size else 0
    meta = _gather_host(np.array([n_local, k_cols, w_cols], np.int64))
    n_max = int(meta[:, 0].max())
    kc, wc = int(meta[:, 1].max()), int(meta[:, 2].max())
    if n_max == 0:
        return (np.zeros((0, kc), np.int32), np.zeros(0),
                np.zeros((0, wc)))

    def pad2(a, cols, dtype):
        out = np.zeros((n_max, cols), dtype)
        if a.size:
            out[:a.shape[0], :a.shape[1]] = a
        return out

    keys_g = _gather_host(pad2(keys, kc, np.int32))
    counts_g = _gather_host(np.pad(counts.astype(np.float64),
                                   (0, n_max - n_local)))
    wsum_g = _gather_host(pad2(wsum, wc, np.float64))
    n = meta[:, 0]
    return (np.concatenate([keys_g[p, :n[p]] for p in range(len(n))]),
            np.concatenate([counts_g[p, :n[p]] for p in range(len(n))]),
            np.concatenate([wsum_g[p, :n[p]] for p in range(len(n))]))


def max_over_ranks(value: int) -> int:
    """The largest of every rank's `value`."""
    return int(_gather_host(np.array([value], np.int64)).max())


def allreduce_histograms(arrays):
    """Sum fixed-shape float64 host histograms over the ranks
    (mergeObservedBias analog, WorkerRuntimeContext.hpp:22-70): gathered
    bit-exact, then summed on the host in rank order, so the result is
    bit-equal to the JAX package's."""
    flat = np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in arrays])
    tot = _gather_host(flat).sum(axis=0)
    out, pos = [], 0
    for a in arrays:
        n = int(np.prod(np.shape(a)))
        out.append(tot[pos:pos + n].reshape(np.shape(a)))
        pos += n
    return out
