#!/usr/bin/env python3
"""Reference values of the JAX package, on the CPU, for chip_smoke.py's
5,000-transcript / 200,000-pair synthetic set.

    python tools/jax_reference_5k.py --work-dir DIR [--port]

Makes the set as chip_smoke.py does (scripts/make_synthetic_txome.py),
builds an index with `python -m salmon_tpu index -k 31`, and runs
`quant -l A` in each mode of chip_smoke.py's scale phase that the JAX
package pins: paired, single-end (-r reads_1), paired with
--recoverOrphans, paired with --seqBias --gcBias (bias) and paired with
--numBootstraps 30 (bootstrap); --modes picks some of them. For each it
prints the Spearman of NumReads against the truth in the read names
(computed as chip_smoke.py computes it), the mapping rate and
num_orphans_rescued. chip_smoke.py pins these Spearman values and gates
the port at each minus 0.01. --port also runs the PyTorch port on the
CPU (device="cpu") over the same index, for comparison.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("SALMON_NO_VERSION_CHECK", "1")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import SCALE_PAIRS, SCALE_TXPS, read_truth, spearman  # noqa


def modes(syn: str) -> dict:
    r1, r2 = (os.path.join(syn, f"reads_{i}.fastq") for i in (1, 2))
    return {"paired": ["-1", r1, "-2", r2],
            "single_end": ["-r", r1],
            "recover_orphans": ["-1", r1, "-2", r2, "--recoverOrphans"],
            "bias": ["-1", r1, "-2", r2, "--seqBias", "--gcBias"],
            "bootstrap": ["-1", r1, "-2", r2, "--numBootstraps", "30"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--port", action="store_true",
                    help="also run the PyTorch port on the CPU")
    ap.add_argument("--modes", nargs="+", default=None)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    from salmon_tpu import cli as jcli

    syn = os.path.join(args.work_dir, "syn")
    if not os.path.exists(os.path.join(syn, "reads_2.fastq")):
        subprocess.run([sys.executable,
                        os.path.join(REPO, "scripts",
                                     "make_synthetic_txome.py"),
                        "--out-dir", syn, "--n-txps", str(SCALE_TXPS),
                        "--n-pairs", str(SCALE_PAIRS)], check=True)
    idx = os.path.join(syn, "jax_idx")
    if not os.path.exists(os.path.join(idx, "info.json")):
        assert jcli.main(["index", "-t", os.path.join(syn, "txome.fasta"),
                          "-i", idx, "-k", "31"]) == 0
    truth = read_truth(os.path.join(syn, "reads_1.fastq"))
    runners = [("jax", jcli.main, {})]
    if args.port:
        from salmon_tpu_torch import cli as tcli
        runners.append(("port-cpu", tcli.main, {"device": "cpu"}))
    for mode, flags in modes(syn).items():
        if args.modes and mode not in args.modes:
            continue
        for name, main, kw in runners:
            out = os.path.join(args.work_dir, f"{name}_{mode}")
            t0 = time.perf_counter()
            assert main(["quant", "-i", idx, "-l", "A", *flags, "-o", out,
                         "-q"], **kw) == 0
            sec = time.perf_counter() - t0
            with open(os.path.join(out, "aux_info", "meta_info.json")) as fh:
                meta = json.load(fh)
            rho = spearman(os.path.join(out, "quant.sf"), truth)
            print(json.dumps({
                "package": name, "mode": mode, "spearman": rho,
                "percent_mapped": meta["percent_mapped"],
                "num_orphans_rescued": meta["num_orphans_rescued"],
                "num_eq_classes": meta["num_eq_classes"],
                "library_types": meta["library_types"], "seconds": sec}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
