#!/usr/bin/env python3
"""SASS instruction counts of the banded-DP kernel's instances.

    python tools/sass_banded_dp.py [--out DIR/banded_dp.sass] \
        [-D BANDED_DP_LANES_15=2 ...]

Builds csrc/banded_dp.cu as the port does (salmon_tpu_torch._cuda), runs
`cuobjdump -sass` on the library and, for every kernel instance, prints
its template arguments (G lanes, C cells, fixed band, softclip), its
instruction count, and for each loop (a backward branch) the basic
blocks inside it: their instruction counts, their DPX add-max count and
their most common opcodes. The row loop's block without the OOB select
is the one a main-path row runs; its count over C is the SASS count per
band cell. -D builds the source with those definitions instead (into
salmon_tpu_torch/_build/libsass_banded_dp.so). The whole listing goes to
--out (default salmon_tpu_torch/_build/banded_dp.sass). Needs the CUDA
toolkit.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                  r"([A-Z][A-Z0-9_.]*)([^;]*);")
TARGET = re.compile(r"0x([0-9a-f]+)")


def instances(listing: str):
    """(function name, [(address, opcode, operands)]) per function."""
    out = []
    for part in re.split(r"\n\s*Function : ", listing)[1:]:
        name, body = part.split("\n", 1)
        out.append((name.strip(), [(int(a, 16), op, rest) for a, op, rest
                                   in INSN.findall(body)]))
    return out


def template_args(name: str) -> str:
    m = re.search(r"banded_dp_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])E",
                  name)
    if not m:
        return name
    g, c, bw, sc = m.groups()
    band = f"bw {bw}" if bw != "0" else "bw at run time"
    return f"G={g} C={c} {band} softclip={sc}"


def loops(code):
    """Blocks of every backward-branch loop: [(start, end, blocks)]."""
    addr = [a for a, _, _ in code]
    found = []
    for k, (a, op, rest) in enumerate(code):
        t = TARGET.search(rest)
        if op.startswith("BRA") and t and int(t.group(1), 16) < a:
            found.append((int(t.group(1), 16), a))
    leaders = {start for start, _ in found}
    for k, (a, op, rest) in enumerate(code):
        t = TARGET.search(rest)
        if op.startswith("BRA") and t:
            leaders.add(int(t.group(1), 16))
            if k + 1 < len(code):
                leaders.add(addr[k + 1])
    result = []
    for start, end in found:
        blocks, cur = [], []
        for a, op, _ in code:
            if a < start or a > end:
                continue
            if a in leaders and cur:
                blocks.append(cur)
                cur = []
            cur.append(op)
        if cur:
            blocks.append(cur)
        result.append((start, end, blocks))
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(
        REPO, "salmon_tpu_torch", "_build", "banded_dp.sass"))
    ap.add_argument("-D", dest="defines", action="append", default=[],
                    metavar="MACRO=VALUE")
    args = ap.parse_args()
    from salmon_tpu_torch import _cuda
    if args.defines:
        lib = os.path.join(_cuda.BUILD, "libsass_banded_dp.so")
        os.makedirs(_cuda.BUILD, exist_ok=True)
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS,
                        *(f"-D{d}" for d in args.defines), "-o", lib,
                        os.path.join(_cuda.CSRC, "banded_dp.cu")],
                       check=True, capture_output=True)
    else:
        _cuda.build(["banded_dp"])
        lib = _cuda.library_path("banded_dp")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    listing = subprocess.run([tool, "-sass", lib], capture_output=True,
                             text=True, check=True).stdout
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write(listing)
    for name, code in instances(listing):
        print(f"{template_args(name)}: {len(code)} instructions")
        for start, end, blocks in loops(code):
            if sum(map(len, blocks)) < 24:
                continue
            print(f"  loop {start:#x}-{end:#x}: "
                  f"{sum(map(len, blocks))} instructions")
            for ops in blocks:
                if len(ops) < 24:
                    continue
                hist = collections.Counter(o.split(".")[0] for o in ops)
                dpx = sum(v for k, v in hist.items() if k.startswith("VI"))
                top = ", ".join(f"{k} {v}" for k, v in hist.most_common(8))
                print(f"    block of {len(ops)}: {dpx} DPX; {top}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
