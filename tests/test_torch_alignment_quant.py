"""Alignment mode (`quant -a <bam> -t <fasta>`): the port's CLI against
the JAX package's on one BAM.

BAMs: the sample pairs at their true positions (paired and, from read
1, single-end), and a single-end multimapping BAM of 34,000 reads with
every CIGAR kind of test_torch_bamio.mixed_read, each aligned to its
transcript and to a 3 %-diverged paralog. That BAM fills two reader
batches, so the error model trained on the first batch weighs the
alignments of the second, on the grid and on its host path.

Tolerances: quant.sf within the golden tolerance (rtol 5e-3 / atol
0.5); num_processed, num_mapped and lib_format_counts.json equal. The
JAX driver weighs alignments in its native pass (alnweights.group_eq)
and the port in its own copy of that pass; both run float32 EMs over
the same classes, so the classes of --dumpEq are equal and their
weights agree to float32 rounding (rtol 1e-5).
--sampleOut draws at random and is held by structure: one record (pair)
per assigned fragment, ZW in (0, 1].
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from salmon_tpu import cli as jcli
from salmon_tpu.alignment import bamio as jbam
from salmon_tpu_torch import cli
from salmon_tpu_torch.alignment import bamio as tbam
from salmon_tpu_torch.alignment.eqmode import read_eq_classes
from salmon_tpu_torch.io import writers
from test_torch_bamio import (FASTA, decode, mixed_read, targets,
                              truth_records)

torch.set_num_threads(2)

MULTI_READS = 34_000   # 68,000 records: two reader batches of 65,536


def _cigar_mismatches(cigar, read, ref, pos):
    """Mismatches of the read's aligned (M, =, X) columns."""
    import re
    rp, fp, mm = 0, pos, 0
    for n, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar):
        n = int(n)
        if op in "M=X":
            mm += int((read[rp:rp + n] != ref[fp:fp + n]).sum())
        if op in "MIS=X":
            rp += n
        if op in "MDN=X":
            fp += n
    return mm


def _multimapping_bam(d):
    """(BAM, FASTA) of the sample transcripts and a 3 %-diverged
    paralog of each; each read has a record on its transcript (primary)
    and one on the other copy (secondary), on both strands."""
    names, lens, seqs = targets()
    rng = np.random.default_rng(11)
    para = []
    for s in seqs:
        p = s.copy()
        at = rng.choice(p.shape[0], p.shape[0] * 3 // 100, replace=False)
        p[at] = (p[at] + rng.integers(1, 4, at.shape[0])) % 4
        para.append(p)
    all_names = names + [f"{n}_para" for n in names]
    all_seqs = seqs + para
    fasta = os.path.join(d, "multi.fa")
    with open(fasta, "w") as fh:
        for nm, s in zip(all_names, all_seqs):
            fh.write(f">{nm}\n{decode(s)}\n")
    n = len(names)
    abundance = rng.pareto(1.0, 2 * n) + 0.05
    recs = []
    for i in range(MULTI_READS):
        t = int(rng.choice(2 * n, p=abundance / abundance.sum()))
        other = (t + n) % (2 * n)
        rl = int(rng.integers(56, 90))
        pos = int(rng.integers(0, lens[t % n] - rl - 10))
        cig, seq = mixed_read(rng, all_seqs[t], pos, rl, i % 7)
        flag = 0x10 * (i % 2)
        for u, sec in ((t, 0), (other, 0x100)):
            mm = _cigar_mismatches(cig, seq, all_seqs[u], pos)
            recs.append(dict(name=f"m{i}", refid=u, pos=pos,
                             flag=flag | sec, cigar=cig, seq=decode(seq),
                             tags={"AS": 2 * (rl - mm) - 4 * mm, "NM": mm}))
    bam = os.path.join(d, "multi.bam")
    tbam.write_bam(bam, all_names, [s.shape[0] for s in all_seqs], recs)
    return bam, fasta


def _unmapped_bam(d):
    """200 single-end reads at random sample positions and 20 unmapped
    records."""
    names, lens, seqs = targets()
    rng = np.random.default_rng(9)
    recs = []
    for i in range(200):
        t = int(rng.integers(0, len(names)))
        s = int(rng.integers(0, lens[t] - 60))
        recs.append(dict(name=f"a{i}", refid=t, pos=s, flag=0, cigar="60M",
                         seq=decode(seqs[t][s:s + 60]), tags={"AS": 120}))
    for i in range(20):
        recs.append(dict(name=f"un{i}", refid=-1, pos=-1, flag=0x4,
                         cigar="", seq="ACGT" * 15))
    bam = os.path.join(d, "unmapped.bam")
    tbam.write_bam(bam, names, lens, recs)
    return bam


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("aln_bams"))
    names, lens, _ = targets()
    bams = {}
    for kind, recs in (("paired", truth_records(paired=True)),
                       ("single", truth_records(paired=False))):
        bams[kind] = (os.path.join(d, f"{kind}.bam"), FASTA)
        jbam.write_bam(bams[kind][0], names, lens, recs)
    bams["multi"] = _multimapping_bam(d)
    bams["unmapped"] = (_unmapped_bam(d), FASTA)
    return bams


MODES = {
    "paired-dumpEq": ("paired", ["--dumpEq"]),
    "paired-noErrorModel": ("paired", ["--noErrorModel"]),
    "paired-seqBias-gcBias": ("paired", ["--seqBias", "--gcBias"]),
    "single": ("single", []),
    "single-ont": ("single", ["--ont"]),
    "multimapping": ("multi", ["--dumpEq"]),
    "writeUnmappedNames": ("unmapped", ["--writeUnmappedNames"]),
}


class _Clocks(logging.Handler):
    """The stage clocks the port logs (extra={"clocks": ...})."""

    def __init__(self):
        super().__init__()
        self.clocks = {}

    def emit(self, record):
        self.clocks.update(getattr(record, "clocks", {}))


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """run(mode) -> {"port": out_dir, "jax": out_dir, "clocks": the
    port's stage clocks}, once per mode."""
    done = {}

    def run(mode):
        if mode not in done:
            bam_kind, flags = MODES[mode]
            bam, fasta = inputs[bam_kind]
            base = tmp_path_factory.mktemp(mode)
            outs = {}
            clocks = _Clocks()
            log = logging.getLogger("salmon_tpu_torch")
            log.addHandler(clocks)
            try:
                for name, main, kw in (("port", cli.main,
                                        {"device": "cpu"}),
                                       ("jax", jcli.main, {})):
                    outs[name] = str(base / name)
                    assert main(["quant", "-t", fasta, "-l", "A", "-a",
                                 bam, *flags, "-q", "--no-version-check",
                                 "-o", outs[name]], **kw) == 0
            finally:
                log.removeHandler(clocks)
            done[mode] = dict(outs, clocks=clocks.clocks)
        return done[mode]
    return run


def _load(out):
    with open(os.path.join(out, "aux_info", "meta_info.json")) as fh:
        meta = json.load(fh)
    with open(os.path.join(out, "lib_format_counts.json")) as fh:
        fmt = json.load(fh)
    return writers.read_quant_sf(os.path.join(out, "quant.sf")), meta, fmt


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_alignment_mode_matches_jax(runs, mode):
    outs = runs(mode)
    (sf, meta, fmt), (jsf, jmeta, jfmt) = _load(outs["port"]), \
        _load(outs["jax"])
    assert sf["Name"] == jsf["Name"]
    for col in ("Length", "EffectiveLength", "TPM", "NumReads"):
        np.testing.assert_allclose(sf[col], jsf[col], rtol=5e-3, atol=0.5,
                                   err_msg=col)
    for key in ("num_processed", "num_mapped", "mapping_type",
                "library_types", "num_eq_classes", "seq_bias_correct",
                "gc_bias_correct", "num_em_iterations"):
        assert meta[key] == jmeta[key], key
    assert meta["mapping_type"] == "alignment"
    assert fmt == jfmt
    if "--dumpEq" in MODES[mode][1]:
        (_, ge, geq), (_, we, weq) = (read_eq_classes(os.path.join(
            o, "aux_info", "eq_classes.txt.gz")) for o in (outs["port"],
                                                           outs["jax"]))
        for f in ("labels", "offsets", "counts", "class_sizes"):
            np.testing.assert_array_equal(getattr(geq, f), getattr(weq, f))
        np.testing.assert_allclose(geq.weights, weq.weights, rtol=1e-5)
        np.testing.assert_allclose(ge, we, rtol=5e-3, atol=0.5)
    if mode == "writeUnmappedNames":
        got = [open(os.path.join(o, "aux_info", "unmapped_names.txt")).read()
               .split("\n") for o in (outs["port"], outs["jax"])]
        assert set(got[0]) == set(got[1])
        assert {ln.split()[0] for ln in got[0] if ln} == \
            {f"un{i}" for i in range(20)}


def test_multimapping_uses_the_error_model(runs):
    """The multimapping BAM's second batch is weighed by the error model
    (the first batch passed numPreBurninFrags), and the model splits the
    reads between the copies as the JAX package's does: the summed
    NumReads of each transcript and its paralog conserve the reads."""
    outs = runs("multimapping")
    sf, meta, _ = _load(outs["port"])
    assert meta["num_processed"] == MULTI_READS > 65536 // 2
    clocks = outs["clocks"]
    assert clocks["host_path_records"] > 0, clocks
    assert clocks["errmodel_seconds"] > 0 and clocks["em_seconds"] > 0
    assert sf["NumReads"].sum() == pytest.approx(MULTI_READS, abs=1.0)


@pytest.mark.parametrize("bam_kind", ["paired", "unmapped"])
def test_sample_out(inputs, tmp_path, bam_kind):
    """--sampleOut (with --sampleUnaligned on the BAM with unmapped
    records): one record, or record pair, per fragment; ZW in (0, 1] on
    every sampled record."""
    bam, fasta = inputs[bam_kind]
    out = str(tmp_path / "so")
    extra = ["--sampleUnaligned"] if bam_kind == "unmapped" else []
    assert cli.main(["quant", "-t", fasta, "-l", "A", "-a", bam,
                     "--sampleOut", *extra, "-q", "-o", out],
                    device="cpu") == 0
    with open(os.path.join(out, "aux_info", "meta_info.json")) as fh:
        meta = json.load(fh)
    rdr = tbam.BamReader(os.path.join(out, "postSample.bam"),
                         want_names=True)
    batches = list(rdr.batches())
    rdr.close()
    names = [nm for b in batches for nm in b.names]
    zw = np.concatenate([b.zw_tag[:b.n] for b in batches])
    flag = np.concatenate([b.flag[:b.n] for b in batches])
    sampled = (flag & 0x4) == 0
    assert ((zw[sampled] > 0) & (zw[sampled] <= 1)).all()
    if bam_kind == "paired":
        assert len(names) == 2 * meta["num_mapped"] == 20000
        assert names[0::2] == names[1::2]
        assert ((flag[0::2] & 0x40) != 0).all()
        assert ((flag[1::2] & 0x80) != 0).all()
    else:
        assert len(names) == 220 and (~sampled).sum() == 20
        assert np.isnan(zw[~sampled]).all()
