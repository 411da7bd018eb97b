"""Genome-decoy-scale index build (BASELINE config 5).

Counterpart of scripts/build_genome_scale_index.py. Makes a ~3.4 Gb
input, the harness cache's 200,000-transcript synthetic transcriptome
plus random genome-like decoy chromosomes (random sequence is the worst
case: nearly every k-mer unique), builds it with this package's builder
(partitioned from 1.5 Gb of input, table-less past 800 M keys) and
prints the build's wall time, peak RSS, stage seconds and index sizes.
The saved v5 directory loads in either package.

Usage: python -m salmon_tpu_torch.scripts.build_genome_scale_index
       [decoy_gb]
Env: BENCH_CACHE (default ~/.cache/salmon_tpu_bench); the index goes to
$BENCH_CACHE/genome_idx and is deleted after the stats unless
KEEP_GENOME_IDX=1; GENOME_MAX_OCCS (records kept a k-mer, default 64).
"""

from __future__ import annotations

import logging
import os
import resource
import subprocess
import sys
import time

import numpy as np

from salmon_tpu_torch.scripts import REPO, cache_dir, require_device


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_decoys(path, n_gb: float, seed=7):
    """Random decoy chromosomes of 64 MiB each, n_gb GiB in all, from
    `seed`; byte-equal to the counterpart's file. An existing file is
    kept."""
    if os.path.exists(path):
        return
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    chrom_mb = 64
    n_chrom = int(n_gb * 1024 / chrom_mb + 0.5)
    log(f"# writing {n_chrom} x {chrom_mb}Mb decoy chromosomes -> {path}")
    with open(path, "wb") as fh:
        for c in range(n_chrom):
            fh.write(f">decoy_chr{c}\n".encode())
            seq = bases[rng.integers(0, 4, chrom_mb * 1024 * 1024)]
            fh.write(seq.tobytes())
            fh.write(b"\n")
    log(f"# decoys written ({os.path.getsize(path) / 1e9:.2f} GB)")


class _Clocks(logging.Handler):
    """The stage seconds the builder logs (extra={"clocks": ...})."""

    def __init__(self):
        super().__init__()
        self.clocks = {}

    def emit(self, record):
        self.clocks.update(getattr(record, "clocks", {}))


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    require_device(device, "build_genome_scale_index")
    cache = cache_dir()
    decoy_gb = float(argv[0]) if argv else 3.0
    txome = os.path.join(cache, "txome.fasta")
    if not os.path.exists(txome):
        log("# regenerating the 200k-transcript synthetic txome "
            "(scripts/make_synthetic_txome.py, seed 7)")
        subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts",
                                          "make_synthetic_txome.py"),
             "--out-dir", cache, "--no-reads"], check=True)
    decoys = os.path.join(cache, f"decoys_{decoy_gb:g}gb.fasta")
    make_decoys(decoys, decoy_gb)

    from salmon_tpu_torch.index.builder import build_index, save_index

    clocks = _Clocks()
    blog = logging.getLogger("salmon_tpu_torch")
    blog.addHandler(clocks)
    level = blog.level
    blog.setLevel(logging.INFO)
    t0 = time.time()
    # --maxOccsKept: repeat k-mers keep their first N records (the true
    # counts stay in the shard tables for the repetitive filter)
    kept = int(os.environ.get("GENOME_MAX_OCCS", 64))
    try:
        idx = build_index(txome, k=31, decoys_path=decoys,
                          max_occs_kept=kept)
    finally:
        blog.removeHandler(clocks)
        blog.setLevel(level)
    build_s = time.time() - t0
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    total_gb = int(idx.seq_offsets[-1]) / 1e9
    log(f"# build: {total_gb:.2f} Gb input, {idx.info['num_kmers'] / 1e9:.2f}G"
        f" kmers, {idx.info['num_occurrences'] / 1e9:.2f}G occurrences in"
        f" {build_s / 60:.1f} min (peak RSS {rss_gb:.1f} GB); stages "
        f"{clocks.clocks}")

    out = os.path.join(cache, "genome_idx")
    t0 = time.time()
    save_index(idx, out)
    save_s = time.time() - t0
    sz = sum(os.path.getsize(os.path.join(out, f))
             for f in os.listdir(out)) / 1e9
    log(f"# saved {sz:.1f} GB in {save_s / 60:.1f} min -> {out}")
    print({"input_gb": round(total_gb, 2),
           "kmers_g": round(idx.info["num_kmers"] / 1e9, 3),
           "occs_g": round(idx.info["num_occurrences"] / 1e9, 3),
           "decoys": idx.info["num_decoys"],
           "build_min": round(build_s / 60, 1),
           "save_min": round(save_s / 60, 1),
           "peak_rss_gb": round(rss_gb, 1),
           "index_gb": round(sz, 1),
           "tableless": idx.table is None,
           "stage_s": clocks.clocks},
          flush=True)
    if not os.environ.get("KEEP_GENOME_IDX"):
        import shutil
        shutil.rmtree(out)
        log("# index dir removed (set KEEP_GENOME_IDX=1 to keep)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
