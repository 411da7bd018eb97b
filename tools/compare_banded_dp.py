#!/usr/bin/env python3
"""Time builds of the banded-DP kernel against each other on one card.

    git show REV:salmon_tpu_torch/csrc/banded_dp.cu > /some/dir/old.cu
    python tools/compare_banded_dp.py old=/some/dir/old.cu \
        new=salmon_tpu_torch/csrc/banded_dp.cu --float-scores old \
        [-D new:BANDED_DP_LANES_15=2] [--bands 15 80 40 7]

Each NAME=SOURCE is compiled with the port's nvcc flags (all at once),
plus the -D NAME:MACRO=VALUE definitions given for it (the kernel's
lanes per problem at a fixed band, BANDED_DP_LANES_<band>), into
salmon_tpu_torch/_build/ and called through its C interface on
chip_smoke.py's DP inputs for each band (the band's problem count and
placement from chip_smoke.DP_CASES, plain mode). A build that refuses a
band (an older kernel built for one band only) is left out of that
band. Builds of the kernel from before its int32 redesign take float
scores: name them in --float-scores. Every build's scores must equal the
others'. Times are CUDA-event
means over 50 launches, taken in turns A B ... B A, --reps times; the
median and every reading are printed, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def build(sources: dict, defines: dict, float_scores: set) -> dict:
    from salmon_tpu_torch import _cuda
    from salmon_tpu_torch.mapping.align import bind_banded_dp
    os.makedirs(_cuda.BUILD, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        out = os.path.join(_cuda.BUILD, f"libcompare_{name}.so")
        flags = [f"-D{d}" for d in defines.get(name, [])]
        procs[name] = (subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {sources[name]}:\n{log}")
        libs[name] = bind_banded_dp(ctypes.CDLL(out),
                                    float_scores=name in float_scores)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("builds", nargs="+", metavar="NAME=SOURCE")
    ap.add_argument("--bands", type=int, nargs="+",
                    default=[bw for bw, *_ in cs.DP_CASES])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--float-scores", nargs="+", default=[], metavar="NAME",
                    help="builds whose C interface takes float scores")
    ap.add_argument("-D", dest="defines", action="append", default=[],
                    metavar="NAME:MACRO=VALUE")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sources = dict(b.split("=", 1) for b in args.builds)
    print(f"card: {torch.cuda.get_device_name(0)}; "
          + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip(), flush=True)
    defines = {}
    for d in args.defines:
        name, macro = d.split(":", 1)
        defines.setdefault(name, []).append(macro)
    libs = build(sources, defines, set(args.float_scores))
    cases = {bw: (P, jitter) for bw, P, jitter, _ in cs.DP_CASES}
    for bw in args.bands:
        P, jitter = cases.get(bw, (4096, 3))
        inp = cs.dp_inputs(7, False, False, P=P, jitter=jitter)
        outs = {n: torch.empty(P, dtype=torch.float32, device="cuda")
                for n in libs}
        names = [n for n in libs
                 if cs.dp_launch(libs[n], inp, bw, outs[n]) == 0]
        torch.cuda.synchronize()
        for n in names[1:]:
            if not torch.equal(outs[n], outs[names[0]]):
                raise AssertionError(f"bw {bw}: {n} differs from "
                                     f"{names[0]}")
        times = {n: [] for n in names}
        for _ in range(args.reps):
            for n in names + names[::-1]:
                times[n].append(cs._cuda_ms(
                    lambda: cs.dp_launch(libs[n], inp, bw, outs[n]), 50))
        print(f"bw {bw}, P = {P}: " + "; ".join(
            f"{n} {sorted(v)[len(v) // 2]!r} ms (all {v!r})"
            for n, v in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
