#!/usr/bin/env python3
"""Reference values of the JAX package, on the CPU, for chip_smoke.py's
5,000-transcript / 200,000-pair synthetic set.

    python tools/jax_reference_5k.py --work-dir DIR [--port]
        [--modes paired single_end recover_orphans bias bootstrap
                 alignment eqclass sparse]

Makes the set as chip_smoke.py does (scripts/make_synthetic_txome.py),
builds an index with `python -m salmon_tpu index -k 31`, and runs
`quant -l A` in each mode of chip_smoke.py's scale phase that the JAX
package pins: paired, single-end (-r reads_1), paired with
--recoverOrphans, paired with --seqBias --gcBias (bias), paired with
--numBootstraps 30 (bootstrap), alignment mode (`-a` on the BAM that
chip_smoke.write_alignment_bam makes, `-t` the set's FASTA), eq-class
mode (`-e` on the output of the JAX package's paired `--dumpEq` run) and
paired with the sparse seed flow (sparse: SALMON_TPU_SPARSE_SEED=1 in
the environment of that run); --modes picks some of them. For each it prints the Spearman of
NumReads against the truth in the read names (computed as chip_smoke.py
computes it), the mapping rate, num_orphans_rescued and
num_em_iterations. chip_smoke.py pins these Spearman values and gates
the port at each minus 0.01. --port also runs the PyTorch port on the
CPU (device="cpu") on the same inputs, for comparison.
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

from chip_smoke import (SCALE_PAIRS, SCALE_TXPS, read_truth,  # noqa
                        spearman, write_alignment_bam)


def modes(syn: str, idx: str) -> dict:
    """Each mode's quant arguments after `-l A`; `{dump}` stands for the
    output directory of the JAX package's paired --dumpEq run."""
    r1, r2 = (os.path.join(syn, f"reads_{i}.fastq") for i in (1, 2))
    pairs = ["-i", idx, "-1", r1, "-2", r2]
    return {"paired": pairs,
            "single_end": ["-i", idx, "-r", r1],
            "recover_orphans": [*pairs, "--recoverOrphans"],
            "bias": [*pairs, "--seqBias", "--gcBias"],
            "bootstrap": [*pairs, "--numBootstraps", "30"],
            "alignment": ["-a", os.path.join(syn, "aln.bam"), "-t",
                          os.path.join(syn, "txome.fasta")],
            "eqclass": ["-e", "{dump}"],
            "sparse": pairs}


# environment variables each mode sets for its runs
MODE_ENV = {"sparse": {"SALMON_TPU_SPARSE_SEED": "1"}}


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
    chosen = {m: f for m, f in modes(syn, idx).items()
              if not args.modes or m in args.modes}
    bam = os.path.join(syn, "aln.bam")
    if "alignment" in chosen and not os.path.exists(bam):
        t0 = time.perf_counter()
        stats = write_alignment_bam(syn, bam)
        print(json.dumps({"alignment_bam": stats,
                          "seconds": time.perf_counter() - t0}), flush=True)
    runners = [("jax", jcli.main, {})]
    if args.port:
        from salmon_tpu_torch import cli as tcli
        runners.append(("port-cpu", tcli.main, {"device": "cpu"}))
    if "eqclass" in chosen:
        # both packages re-quantify the JAX package's dump
        dump = os.path.join(args.work_dir, "jax_paired_dumpEq")
        assert jcli.main(["quant", "-l", "A", *modes(syn, idx)["paired"],
                          "--dumpEq", "-o", dump, "-q"]) == 0
        chosen["eqclass"] = [f.replace("{dump}", dump)
                             for f in chosen["eqclass"]]
    for mode, flags in chosen.items():
        for name, main, kw in runners:
            out = os.path.join(args.work_dir, f"{name}_{mode}")
            env = MODE_ENV.get(mode, {})
            os.environ.update(env)
            t0 = time.perf_counter()
            try:
                assert main(["quant", "-l", "A", *flags, "-o", out, "-q"],
                            **kw) == 0
            finally:
                for k in env:
                    os.environ.pop(k)
            sec = time.perf_counter() - t0
            with open(os.path.join(out, "aux_info", "meta_info.json")) as fh:
                meta = json.load(fh)
            rho = spearman(os.path.join(out, "quant.sf"), truth)
            print(json.dumps({
                "package": name, "mode": mode, "spearman": rho,
                "percent_mapped": meta["percent_mapped"],
                "num_orphans_rescued": meta.get("num_orphans_rescued"),
                "num_eq_classes": meta["num_eq_classes"],
                "num_em_iterations": meta["num_em_iterations"],
                "library_types": meta.get("library_types"),
                "seconds": sec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
