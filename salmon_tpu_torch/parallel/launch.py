"""Start the processes of a multi-process quant on this machine.

Counterpart of scripts/launch_multihost.py. Each of N processes runs
the same command line of the port's CLI with SALMON_TPU_COORDINATOR,
SALMON_TPU_NUM_PROCS and SALMON_TPU_PROC_ID set; process p takes GPU
p % (GPUs visible), or the CPU with --device cpu. Rank 0 writes the
output directory.

  python -m salmon_tpu_torch.parallel.launch --nprocs 2 -- \\
      quant -i idx -l A -1 r1.fq -2 r2.fq --indexShards 2 -o out

On several machines, run the CLI in every process with those variables
set instead (the coordinator is host:port of rank 0's machine).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

# a rank's command with --device cpu: the CLI entry with the device the
# Python API takes (the command line itself always asks for CUDA)
_CPU_MAIN = ("import sys; from salmon_tpu_torch import cli; "
             "sys.exit(cli.main(sys.argv[1:], device='cpu'))")


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_commands(nprocs: int, cli_args: list, device: str = "cuda",
                  port: int | None = None) -> list:
    """(argv, environment) of each rank's process."""
    port = port or free_port()
    base = ([sys.executable, "-m", "salmon_tpu_torch"] if device == "cuda"
            else [sys.executable, "-c", _CPU_MAIN])
    out = []
    for pid in range(nprocs):
        env = dict(os.environ)
        env.update({"SALMON_TPU_COORDINATOR": f"127.0.0.1:{port}",
                    "SALMON_TPU_NUM_PROCS": str(nprocs),
                    "SALMON_TPU_PROC_ID": str(pid)})
        out.append((base + list(cli_args), env))
    return out


def run(nprocs: int, cli_args: list, device: str = "cuda",
        port: int | None = None, timeout: float | None = None) -> int:
    """Run the ranks to their end; the first failing rank's exit code
    (the others are stopped then), else 0."""
    procs = [subprocess.Popen(argv, env=env)
             for argv, env in rank_commands(nprocs, cli_args, device, port)]
    deadline = None if timeout is None else time.monotonic() + timeout
    rc = 0
    try:
        while procs and rc == 0:
            for p in list(procs):
                code = p.poll()
                if code is not None:
                    procs.remove(p)
                    rc = rc or code
            if deadline is not None and time.monotonic() > deadline:
                rc = 124
            time.sleep(0.05)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m salmon_tpu_torch.parallel.launch",
        description="run one salmon_tpu_torch command in N processes")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--port", type=int, default=0,
                    help="rank 0's TCP port (0: a free one)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("cli", nargs=argparse.REMAINDER,
                    help="salmon_tpu_torch CLI arguments after --")
    args = ap.parse_args(argv)
    cli = args.cli[1:] if args.cli[:1] == ["--"] else args.cli
    t0 = time.time()
    rc = run(args.nprocs, cli, args.device, args.port or None)
    print(f"launch: {args.nprocs} processes, wall {time.time() - t0:.1f} s, "
          f"rc={rc}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
