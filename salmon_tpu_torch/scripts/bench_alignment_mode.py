"""Alignment-mode (-a BAM) throughput benchmark.

Counterpart of scripts/bench_alignment_mode.py: synthesizes the same BAM
(byte for byte) from the bundled sample's read-name ground truth,
repeated REPS times (default 10 -> 100k fragments / 200k records), then
times the port's native BAM reader alone and the whole
`quantify_alignments` path (reader -> grouping and weighting -> error
model on the device -> EM -> writers), and prints the same JSON line.

Reference yardstick: alignment mode saturates at ~8-12 threads on the
BAM decompress (doc/source/salmon.rst:83-97); there the bottleneck is
htslib inflate, here the same BGZF inflate in the port's native reader
(salmon_tpu_torch/csrc/bamreader.cpp).

Usage: python -m salmon_tpu_torch.scripts.bench_alignment_mode [REPS]
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
import types

from salmon_tpu_torch.scripts import REPO, require_device

DATA = os.path.join(REPO, "tests", "data")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def build_bam(path, reps):
    """The sample pairs as a paired BAM, REPS copies; its fragments."""
    from salmon_tpu_torch.alignment import bamio
    from salmon_tpu_torch.io.fasta import load_transcripts

    records, _ = load_transcripts(
        os.path.join(DATA, "transcripts.fasta"), noclip_polya=True)
    names = [r.name for r in records]
    lens = [r.seq_codes.shape[0] for r in records]
    tid = {nm: i for i, nm in enumerate(names)}

    recs = []
    with open(os.path.join(DATA, "reads_1.fastq")) as f1, \
            open(os.path.join(DATA, "reads_2.fastq")) as f2:
        while True:
            h1 = f1.readline()
            if not h1:
                break
            s1 = f1.readline().strip()
            f1.readline()
            f1.readline()
            f2.readline()
            s2 = f2.readline().strip()
            f2.readline()
            f2.readline()
            name = h1[1:].strip().split()[0]
            parts = name.split(":")
            recs.append((name, parts[1], int(parts[2]), int(parts[3]),
                         s1, s2))

    bam_recs = []
    n_frags = 0
    for rep in range(reps):
        for name, txp, pos, fend, s1, s2 in recs:
            rid = tid[txp]
            L1, L2 = len(s1), len(s2)
            tlen = fend - pos + 1
            p1, p2 = pos, fend - L2 + 1
            nm = f"{rep}:{name}"
            bam_recs.append(dict(
                name=nm, refid=rid, pos=p1, flag=0x1 | 0x40 | 0x20,
                cigar=f"{L1}M", seq=s1, mate_refid=rid, mate_pos=p2,
                tlen=tlen, tags={"AS": 2 * L1, "NM": 0}))
            bam_recs.append(dict(
                name=nm, refid=rid, pos=p2, flag=0x1 | 0x80 | 0x10,
                cigar=f"{L2}M", seq=s2, mate_refid=rid, mate_pos=p1,
                tlen=-tlen, tags={"AS": 2 * L2, "NM": 0}))
            n_frags += 1
    bamio.write_bam(path, names, lens, bam_recs)
    return n_frags


def quant_args(bam: str, out: str) -> types.SimpleNamespace:
    """The CLI's -a arguments at their defaults, as the JAX script sets
    them."""
    return types.SimpleNamespace(
        alignments=[bam], targets=os.path.join(DATA, "transcripts.fasta"),
        libType="IU", output=out, noErrorModel=False, ont=False,
        scoreExp=1.0, numPreAuxModelSamples=5000, dumpEq=False,
        dumpEqWeights=False, geneMap=None, sampleOut=False,
        sampleUnaligned=False, writeUnmappedNames=False, seed=271828)


def bench(reps: int, tmp: str, device) -> dict:
    """Build the BAM in tmp, time the reader and quantify_alignments; the
    JSON line's rates, the BAM's counts, the quant's seconds and its
    output directory (tmp/quant)."""
    from salmon_tpu_torch import _native
    from salmon_tpu_torch.alignment.bamio import BamReader
    from salmon_tpu_torch.alignment.quant import quantify_alignments
    from salmon_tpu_torch.constants import SalmonDefaults

    bam = os.path.join(tmp, "bench.bam")
    t0 = time.perf_counter()
    n_frags = build_bam(bam, reps)
    log(f"# built {bam}: {n_frags} fragments "
        f"({os.path.getsize(bam) / 1e6:.1f} MB BGZF, "
        f"{time.perf_counter() - t0:.1f}s)")

    # --- raw reader throughput; the native library builds at its first
    # use, outside the reader's clock
    _native.lib()
    t0 = time.perf_counter()
    n_rec = 0
    rdr = BamReader(bam)
    try:
        for b in rdr.batches():
            n_rec += b.n
    finally:
        rdr.close()
    dt = time.perf_counter() - t0
    reader_rate = n_rec / dt
    log(f"# reader: {n_rec} records in {dt:.2f}s = "
        f"{reader_rate / 1e6:.2f}M rec/s")

    # --- full quantify_alignments
    out = os.path.join(tmp, "quant")
    t0 = time.perf_counter()
    rc = quantify_alignments(quant_args(bam, out), SalmonDefaults(),
                             {"bench": True}, device)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"quantify_alignments returned {rc}")
    log(f"# quantify_alignments: {n_frags} fragments in {dt:.2f}s")
    return {"value": n_frags / dt, "reader_rec_per_s": reader_rate,
            "n_frags": n_frags, "n_records": n_rec, "seconds": dt,
            "out": out}


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    device = require_device(device, "bench_alignment_mode")
    reps = int(argv[0]) if argv else 10
    rec = bench(reps, tempfile.mkdtemp(prefix="salmon_tpu_torch_abench_"),
                device)
    print(f'{{"metric": "alignment-mode frags/s", '
          f'"value": {rec["value"]:.1f}, "reader_rec_per_s": '
          f'{rec["reader_rec_per_s"]:.0f}}}')
    log(f"alignment-mode throughput: {rec['value'] / 1e3:.1f}k frags/s "
        f"(end-to-end incl. error-model training + EM + writers)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
