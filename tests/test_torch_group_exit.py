"""Ranks of the port's gloo groups exit cleanly.

A process that joined a group through parallel.distributed.init and
left the group to the interpreter's finalizer aborted now and then
after its work was done (SIGABRT, "terminate called without an active
exception"), the more often the more groups ran at once: 21 of 96
2-rank groups under 6 concurrent starters on an 8-core host. init now
leaves the group at exit. This runs GROUPS 2-rank groups at once, each
rank joining from the launch variables, one all-reduce, and returning,
and requires every rank to exit with code 0 within the time limit.
This module imports only torch and the port, so that the spawned ranks
start quickly.
"""

import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from salmon_tpu_torch.parallel import distributed
from salmon_tpu_torch.parallel.launch import free_port

GROUPS = 8
LIMIT = 180          # seconds for every group


def _rank(rank, port):
    torch.set_num_threads(1)
    os.environ.update({distributed.ENV_COORD: f"127.0.0.1:{port}",
                       distributed.ENV_NPROC: "2",
                       distributed.ENV_PID: str(rank)})
    world = distributed.init_from_env("cpu")
    t = torch.full((4,), float(world.rank + 1))
    dist.all_reduce(t)
    if t[0].item() != 3.0:
        raise AssertionError(f"all-reduce gave {t}")


def test_concurrent_groups_exit_cleanly():
    ctxs = [mp.start_processes(_rank, args=(free_port(),), nprocs=2,
                               join=False, start_method="spawn")
            for _ in range(GROUPS)]
    procs = [p for c in ctxs for p in c.processes]
    deadline = time.monotonic() + LIMIT
    try:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.1))
        alive = [p.pid for p in procs if p.is_alive()]
        assert not alive, f"ranks still running after {LIMIT} s: {alive}"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * len(procs), codes
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
