#!/usr/bin/env python3
"""Fixed-window quant throughput harness (the analog of the reference's
tests/benchmarks/quant_window.py): run the port's `quant` for at most
--seconds, parse the progress log's "processed N fragments" lines, and
report fragments/s as JSON.

Counterpart of scripts/quant_window.py: the same flags, window, terminate
and kill sequence and six JSON keys; the default command is
`python -m salmon_tpu_torch`, which runs on the GPU (without one, main
raises before it starts anything). --salmon names another command, such
as a wrapper that runs the port's CLI on the CPU. With
--progressUpdateMs 0 after `--` the log has a line after every batch,
so a run that completes reports all its fragments. --seconds takes a
fraction too (the JAX harness takes whole seconds).

Usage:
  python -m salmon_tpu_torch.scripts.quant_window --index IDX -1 R1 -2 R2 \\
      --seconds 120 --out-dir qw_out [-- extra quant flags...]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

from salmon_tpu_torch.scripts import REPO, require_device

PROCESSED_RE = re.compile(r"processed\s+([0-9,]+)\s+fragments",
                          re.IGNORECASE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m salmon_tpu_torch.scripts.quant_window")
    ap.add_argument("--salmon", default=None,
                    help="command (default: python -m salmon_tpu_torch)")
    ap.add_argument("--index", required=True)
    ap.add_argument("-1", dest="mates1", required=True)
    ap.add_argument("-2", dest="mates2", required=True)
    ap.add_argument("--seconds", type=float, default=120)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--out-dir", default="qw_out")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("extra", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if not args.salmon:
        require_device("cuda", "quant_window")

    out_dir = Path(args.out_dir)
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    base = ([args.salmon] if args.salmon
            else [sys.executable, "-m", "salmon_tpu_torch"])
    extra = args.extra[1:] if args.extra[:1] == ["--"] else args.extra
    cmd = base + [
        "quant", "-lA", "-i", args.index, "-1", args.mates1,
        "-2", args.mates2, "--threads", str(args.threads),
        "-o", str(out_dir)] + extra
    # the package from this checkout, and no online version check
    prev = os.environ.get("PYTHONPATH", "")
    env = dict(os.environ, SALMON_NO_VERSION_CHECK="1",
               PYTHONPATH=REPO + (os.pathsep + prev if prev else ""))

    started = time.monotonic()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    captured = ""
    timed_out = False
    try:
        out, _ = proc.communicate(timeout=args.seconds)
        captured = out or ""
    except subprocess.TimeoutExpired:
        timed_out = True
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=15)
            captured = out or ""
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            captured = out or ""
    elapsed = time.monotonic() - started

    matches = PROCESSED_RE.findall(captured)
    processed = int(matches[-1].replace(",", "")) if matches else 0
    result = {
        "command": cmd,
        "timed_out": timed_out,
        "elapsed_seconds": elapsed,
        "processed_fragments": processed,
        "fragments_per_second": processed / elapsed if elapsed else 0.0,
        "exit_code": proc.returncode,
    }
    text = json.dumps(result, indent=2)
    print(text)
    if args.json_out:
        Path(args.json_out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
