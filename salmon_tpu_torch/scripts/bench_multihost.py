"""Multi-process scaling-efficiency harness (BASELINE: >=85% at >=2
hosts).

Counterpart of scripts/bench_multihost.py: quant at 1, 2 and N processes
through the port's launcher (python -m salmon_tpu_torch.parallel.launch:
one process a device on a torch.distributed group, data-parallel over
the reads), the index from the port's own `index`, and the report's
keys:

  {"metric": "multi-host scaling efficiency", "procs": [...],
   "frags_per_s": [...], "efficiency_vs_1": [...], ...}

The port has one process a device, so --devices-per-proc changes
meaning: 0, the default here, runs each rank on a GPU (rank p on
cuda:{p % GPUs visible}, the JAX script's "hardware run"); N > 0 runs
the ranks on the CPU (virtual_cpu_mesh true), whatever N is. A process
count above the GPUs visible shares them, and then the efficiency says
how the ranks share a card, not how they scale. Each run takes rank 0's
port from the launcher's free-port search (the JAX script fixes
8476 + nprocs). The report adds "rank_clocks" to the JAX report's keys:
for each process count, each rank's index load, FASTQ read, mapping
(map_seconds, the read included), EM and collective seconds from the
ranks' logs, one value a rank, sorted (a rank's log lines do not name
it), so that what does not divide over the ranks shows.

Usage: python -m salmon_tpu_torch.scripts.bench_multihost [--procs 1,2,4]
       [--devices-per-proc 0] [--r1 R1 --r2 R2] [--transcripts FASTA]
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from salmon_tpu_torch.scripts import REPO, require_device

DATA = os.path.join(REPO, "tests", "data")
# the ranks' clock lines (cli.py, quant.py) that rank_clocks reads
CLOCK_LINES = ("index load clocks (s): ", "quantify clocks (s): ",
               "multi-process clocks (s): ")


def _env() -> dict:
    prev = os.environ.get("PYTHONPATH", "")
    return dict(os.environ, SALMON_NO_VERSION_CHECK="1",
                PYTHONPATH=REPO + (os.pathsep + prev if prev else ""))


def rank_clocks(log: str) -> dict:
    """Each clock of CLOCK_LINES' dicts in a run's log: its values over
    the ranks, sorted."""
    out = {}
    for ln in log.splitlines():
        for head in CLOCK_LINES:
            if head in ln:
                clocks = ast.literal_eval(ln.split(head, 1)[1].strip())
                for k, v in clocks.items():
                    out.setdefault(k, []).append(v)
    return {k: sorted(v) for k, v in out.items()}


def run_one(nprocs: int, devices_per_proc: int, idx: str, out: str,
            r1: str, r2: str) -> dict:
    """One launcher run of `quant`; its wall seconds, fragments (rank 0's
    meta_info.json), fragments/s and the ranks' clocks."""
    cmd = [sys.executable, "-m", "salmon_tpu_torch.parallel.launch",
           "--nprocs", str(nprocs), "--port", "0",
           *(["--device", "cpu"] if devices_per_proc else []), "--",
           "quant", "-i", idx, "-l", "IU", "-1", r1, "-2", r2,
           "-o", out, "--no-version-check"]
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                         cwd=REPO)
    wall = time.time() - t0
    if res.returncode != 0:
        sys.stderr.write(res.stdout[-2000:] + res.stderr[-2000:])
        raise RuntimeError(f"nprocs={nprocs} failed")
    with open(os.path.join(out, "aux_info", "meta_info.json")) as fh:
        frags = int(json.load(fh)["num_processed"])
    return {"wall_s": round(wall, 2), "frags": frags,
            "frags_per_s": round(frags / wall, 1),
            "rank_clocks": rank_clocks(res.stderr)}


def measure(procs: list, devices_per_proc: int, idx: str, r1: str, r2: str,
            tmp: str) -> list:
    """run_one at each process count (outputs in tmp/out_<n>); the
    records, each with its process count."""
    results = []
    for n in procs:
        r = run_one(n, devices_per_proc, idx, os.path.join(tmp, f"out_{n}"),
                    r1, r2)
        r["procs"] = n
        results.append(r)
        print(f"# procs={n}: {r['frags_per_s']} frags/s "
              f"({r['wall_s']}s, {r['frags']} frags)", file=sys.stderr,
              flush=True)
    return results


def report(results: list, devices_per_proc: int) -> dict:
    """The JAX harness's report of measure's records, and the ranks'
    clocks."""
    base = results[0]["frags_per_s"]
    return {
        "metric": "multi-host scaling efficiency",
        "devices_per_proc": devices_per_proc,
        "virtual_cpu_mesh": devices_per_proc > 0,
        "procs": [r["procs"] for r in results],
        "frags_per_s": [r["frags_per_s"] for r in results],
        "wall_s": [r["wall_s"] for r in results],
        "efficiency_vs_1": [
            round(r["frags_per_s"] / (base * r["procs"]), 3)
            for r in results],
        "note": ("CPU run: the ranks share this host's cores, so "
                 "efficiency underestimates one device a rank"
                 if devices_per_proc else "hardware run"),
        "rank_clocks": [r["rank_clocks"] for r in results],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m salmon_tpu_torch.scripts.bench_multihost")
    ap.add_argument("--procs", default="1,2,4")
    ap.add_argument("--devices-per-proc", type=int, default=0)
    ap.add_argument("--r1", default=os.path.join(DATA, "reads_1.fastq"))
    ap.add_argument("--r2", default=os.path.join(DATA, "reads_2.fastq"))
    ap.add_argument("--transcripts",
                    default=os.path.join(DATA, "transcripts.fasta"))
    args = ap.parse_args(argv)
    if args.devices_per_proc == 0:
        require_device("cuda", "bench_multihost")
    procs = [int(x) for x in args.procs.split(",")]

    tmp = tempfile.mkdtemp(prefix="mh_bench_")
    idx = os.path.join(tmp, "idx")
    subprocess.run([sys.executable, "-m", "salmon_tpu_torch", "index",
                    "-t", args.transcripts, "-i", idx, "-k", "31"],
                   check=True, cwd=REPO, env=_env())
    results = measure(procs, args.devices_per_proc, idx, args.r1, args.r2,
                      tmp)
    print(json.dumps(report(results, args.devices_per_proc)))
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
