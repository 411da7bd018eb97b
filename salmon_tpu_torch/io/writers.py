"""Output artifact writers (reference: src/output/GZipWriter.cpp).

Artifacts and their reference sources:
  quant.sf            writeAbundances        GZipWriter.cpp:685-739
  lib_format_counts.json                     ReadExperiment / stages
  cmd_info.json       writeCmdInfo
  meta_info.json      writeMeta              GZipWriter.cpp:295-599
  aux_info/fld.gz / flenDist.txt             MappingPipelineStages.cpp:167-173
  aux_info/eq_classes.txt.gz                 writeEquivCounts :65-130
  aux_info/ambig_info.tsv                    :602-608
  aux_info/bootstrap/  writeBootstrap        :766-820
  aux_info/{obs,exp}*_{seq,gc,pos}.gz bias model dumps  :329-487
  quant.sf columns: Name  Length(Complete)  EffectiveLength  TPM  NumReads
  TPM = ((c_i/N)/effLen_i) / sum_j((c_j/N)/effLen_j) * 1e6
"""

from __future__ import annotations

import gzip
import json
import os
import time
from typing import Optional, Sequence

import numpy as np


def compute_tpm(counts: np.ndarray, eff_lens: np.ndarray) -> np.ndarray:
    num_mapped = counts.sum()
    if num_mapped <= 0:
        return np.zeros_like(counts, dtype=np.float64)
    rate = (counts / num_mapped) / np.maximum(eff_lens, 1e-12)
    denom = rate.sum()
    if denom <= 0:
        return np.zeros_like(counts, dtype=np.float64)
    return rate / denom * 1e6


def write_quant_sf(out_dir: str, names: Sequence[str],
                   complete_lengths: np.ndarray, eff_lens: np.ndarray,
                   counts: np.ndarray, sig_digits: int = 3,
                   filename: str = "quant.sf") -> str:
    os.makedirs(out_dir, exist_ok=True)
    tpm = compute_tpm(counts, eff_lens)
    path = os.path.join(out_dir, filename)
    with open(path, "w") as fh:
        fh.write("Name\tLength\tEffectiveLength\tTPM\tNumReads\n")
        for i, nm in enumerate(names):
            fh.write(f"{nm}\t{int(complete_lengths[i])}\t"
                     f"{eff_lens[i]:.{sig_digits}f}\t{tpm[i]:f}\t"
                     f"{counts[i]:.{sig_digits}f}\n")
    return path


def read_quant_sf(path: str) -> dict:
    """Parse a quant.sf into a dict of numpy columns."""
    names, lens, elens, tpms, reads = [], [], [], [], []
    with open(path) as fh:
        fh.readline()
        for line in fh:
            f = line.rstrip("\n").split("\t")
            names.append(f[0])
            lens.append(int(float(f[1])))
            elens.append(float(f[2]))
            tpms.append(float(f[3]))
            reads.append(float(f[4]))
    return {"Name": names, "Length": np.array(lens),
            "EffectiveLength": np.array(elens), "TPM": np.array(tpms),
            "NumReads": np.array(reads)}


def write_lib_format_counts(out_dir: str, expected_format: str,
                            fmt_counts: dict, num_compatible: int,
                            num_processed: int, num_mapped: int) -> str:
    """lib_format_counts.json (reference ReadExperiment.inl:226-345):
    agree/disagree counts and the strand_mapping_bias ratio derived from
    the observed-format histogram against the expected format."""
    total_fmt = sum(fmt_counts.values())
    ef = expected_format.strip().upper()
    paired6 = set(fmt_counts) >= {"ISF", "ISR", "MSF", "MSR"}
    if paired6:
        orient = ef[0] if ef and ef[0] in "IOM" else "I"
        # fmt1/fmt2: the two stranded variants of the expected
        # orientation (SAME/NONE pool to M)
        o_key = orient if orient in "IOM" else "I"
        n_fmt1 = int(fmt_counts.get(o_key + "SF", 0))
        n_fmt2 = int(fmt_counts.get(o_key + "SR", 0))
        stranded = ef.endswith("SF") or ef.endswith("SR")
        if stranded:
            num_agree = int(fmt_counts.get(ef, 0))
        else:
            num_agree = n_fmt1 + n_fmt2
        num_disagree = total_fmt - num_agree
        denom = n_fmt1 + n_fmt2
        ratio = (n_fmt1 / denom) if (num_agree > 0 and denom > 0) else 0.0
    else:
        n_fmt1 = int(fmt_counts.get("SF", 0))
        n_fmt2 = int(fmt_counts.get("SR", 0))
        if ef in ("SF", "SR"):
            num_agree = int(fmt_counts.get(ef, 0))
        else:
            num_agree = n_fmt1 + n_fmt2 + int(fmt_counts.get("U", 0))
        num_disagree = total_fmt - num_agree
        denom = n_fmt1 + n_fmt2
        ratio = (n_fmt1 / denom) if (num_agree > 0 and denom > 0) else 0.0
    doc = {
        "read_files": "",
        "expected_format": expected_format,
        "compatible_fragment_ratio":
            num_compatible / num_mapped if num_mapped else 0.0,
        "num_compatible_fragments": num_compatible,
        "num_assigned_fragments": num_mapped,
        "num_frags_with_concordant_consistent_mappings": num_agree,
        "num_frags_with_inconsistent_or_orphan_mappings":
            num_mapped - num_agree,
        "strand_mapping_bias": ratio,
    }
    for k, v in fmt_counts.items():
        doc[k] = int(v)
    path = os.path.join(out_dir, "lib_format_counts.json")
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=4)
    return path


def write_cmd_info(out_dir: str, args: dict) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "cmd_info.json")
    with open(path, "w") as fh:
        json.dump({k: (v if isinstance(v, (str, int, float, bool, list))
                       else str(v)) for k, v in args.items()}, fh, indent=4)
    return path


def write_meta_info(out_dir: str, aux_dir: str, meta: dict) -> str:
    d = os.path.join(out_dir, aux_dir)
    os.makedirs(d, exist_ok=True)
    base = {
        "salmon_version": "salmon_tpu_torch-0.1.0",
        "samp_type": "none",
        "quant_errors": [],
        "start_time": time.strftime("%a %b %d %H:%M:%S %Y"),
    }
    base.update(meta)
    base.setdefault("end_time", time.strftime("%a %b %d %H:%M:%S %Y"))
    path = os.path.join(d, "meta_info.json")
    with open(path, "w") as fh:
        json.dump(base, fh, indent=4, default=float)
    return path


def write_fld(out_dir: str, aux_dir: str, fld_pmf: np.ndarray,
              seed: int = 271828) -> str:
    """Binary fld.gz: int32 histogram of 10,000 samples drawn from the
    fitted pmf — the layout consumers of the reference's fld.gz parse
    (GZipWriter.cpp:329-333, samplesFromLogPMF: DistributionUtils.cpp:57;
    the reference seeds from /dev/urandom, here the run seed for
    reproducibility) — plus a human-readable flenDist.txt log-pmf."""
    d = os.path.join(out_dir, aux_dir)
    os.makedirs(d, exist_ok=True)
    pmf = np.asarray(fld_pmf, dtype=np.float64)
    pmf = pmf / max(pmf.sum(), 1e-300)
    rng = np.random.default_rng(seed)
    samples = rng.multinomial(10_000, pmf).astype(np.int32)
    with gzip.open(os.path.join(d, "fld.gz"), "wb") as fh:
        fh.write(samples.tobytes())
    path = os.path.join(out_dir, "libParams")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "flenDist.txt"), "w") as fh:
        logp = np.log(np.maximum(fld_pmf, 1e-300))
        fh.write("\t".join(f"{v:.5f}" for v in logp) + "\n")
    return os.path.join(d, "fld.gz")


def write_vestigial_bias_vectors(out_dir: str, aux_dir: str) -> None:
    """expected_bias.gz / observed_bias.gz / observed_bias_3p.gz.

    In the live reference these carry ONLY their initial state — the
    ReadKmerDist update path is dead code (the live sampler feeds the
    SBModel VLMM instead, SalmonQuantify.cpp:2235 uses
    seqBiasModelFW/RC), so observed counts stay at the pseudo-count 1
    (BiasLibraryState.hpp:35 inits expectedSeqBias to 1.0 and
    ReadKmerDist's ctor sets counts[i]=1). Written for artifact-layout
    compatibility: 4096 float64 ones / 4096 int32 ones
    (GZipWriter.cpp:335-351)."""
    d = os.path.join(out_dir, aux_dir)
    os.makedirs(d, exist_ok=True)
    with gzip.open(os.path.join(d, "expected_bias.gz"), "wb") as fh:
        fh.write(np.ones(4096, np.float64).tobytes())
    for nm in ("observed_bias.gz", "observed_bias_3p.gz"):
        with gzip.open(os.path.join(d, nm), "wb") as fh:
            fh.write(np.ones(4096, np.int32).tobytes())


def write_eq_classes(out_dir: str, aux_dir: str, names: Sequence[str],
                     eq, dump_weights: bool = False,
                     eff_lens: Optional[np.ndarray] = None) -> str:
    """eq_classes.txt.gz (reference writeEquivCounts, GZipWriter.cpp:65-130):
      num_txps \n num_classes \n names... \n
      per class: group_size txp_ids... [weights...] count
    Effective lengths, when given, are appended AFTER the class section as
    trailing `name\\tefflen` pairs — the layout
    salmon::utils::readEquivCounts (SalmonUtils.cpp:1026-1119) parses —
    making `quant -e` re-quantification exact in both directions.
    """
    d = os.path.join(out_dir, aux_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "eq_classes.txt.gz")
    with gzip.open(path, "wt") as fh:
        fh.write(f"{len(names)}\n{eq.num_classes}\n")
        for nm in names:
            fh.write(f"{nm}\n")
        for j in range(eq.num_classes):
            lo, hi = eq.offsets[j], eq.offsets[j + 1]
            lab = eq.labels[lo:hi]
            parts = [str(lab.shape[0])] + [str(t) for t in lab]
            if dump_weights:
                parts += [f"{w:.8g}" for w in eq.weights[lo:hi]]
            parts.append(str(int(eq.counts[j])))
            fh.write("\t".join(parts) + "\n")
        if eff_lens is not None:
            for i, nm in enumerate(names):
                fh.write(f"{nm}\t{eff_lens[i]:.6f}\n")
    return path


def write_ambig_info(out_dir: str, aux_dir: str, num_txps: int, eq) -> str:
    """ambig_info.tsv: per-txp unique vs ambiguous eq-class counts
    (reference GZipWriter.cpp:602-608)."""
    uniq = np.zeros(num_txps, dtype=np.int64)
    ambig = np.zeros(num_txps, dtype=np.int64)
    for j in range(eq.num_classes):
        lo, hi = eq.offsets[j], eq.offsets[j + 1]
        lab = eq.labels[lo:hi]
        c = int(eq.counts[j])
        if lab.shape[0] == 1:
            uniq[lab[0]] += c
        else:
            ambig[lab] += c
    d = os.path.join(out_dir, aux_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "ambig_info.tsv")
    with open(path, "w") as fh:
        fh.write("UniqueCount\tAmbigCount\n")
        for i in range(num_txps):
            fh.write(f"{uniq[i]}\t{ambig[i]}\n")
    return path


def write_bootstraps(out_dir: str, aux_dir: str, names: Sequence[str],
                     samples: np.ndarray) -> str:
    """bootstrap/bootstraps.gz (raw little-endian float64, one row of
    num_txps doubles per sample) + names.tsv.gz (reference writeBootstrap,
    GZipWriter.cpp:766-820; TextBootstrapWriter layout)."""
    d = os.path.join(out_dir, aux_dir, "bootstrap")
    os.makedirs(d, exist_ok=True)
    with gzip.open(os.path.join(d, "names.tsv.gz"), "wt") as fh:
        fh.write("\t".join(names) + "\n")
    path = os.path.join(d, "bootstraps.gz")
    with gzip.open(path, "wb") as fh:
        fh.write(np.ascontiguousarray(samples,
                                      dtype=np.float64).tobytes())
    return path


def read_bootstraps(out_dir: str, aux_dir: str = "aux_info"):
    """Read back (names, (S, T) array) from a bootstrap directory."""
    d = os.path.join(out_dir, aux_dir, "bootstrap")
    with gzip.open(os.path.join(d, "names.tsv.gz"), "rt") as fh:
        names = fh.read().strip("\n").split("\t")
    with gzip.open(os.path.join(d, "bootstraps.gz"), "rb") as fh:
        raw = np.frombuffer(fh.read(), dtype=np.float64)
    return names, raw.reshape(-1, len(names))


def _write_matrix_gz(path: str, mat: np.ndarray) -> None:
    """Binary dump: int64 rows, int64 cols, float64 row-major data."""
    m = np.asarray(mat, dtype=np.float64)
    with gzip.open(path, "wb") as fh:
        fh.write(np.array(m.shape, dtype=np.int64).tobytes())
        fh.write(np.ascontiguousarray(m).tobytes())


def read_matrix_gz(path: str) -> np.ndarray:
    with gzip.open(path, "rb") as fh:
        raw = fh.read()
    r, c = np.frombuffer(raw[:16], dtype=np.int64)
    return np.frombuffer(raw[16:], dtype=np.float64).reshape(r, c)


def write_bias_models(out_dir: str, aux_dir: str, bias_state,
                      opts) -> None:
    """Bias model dumps (reference GZipWriter.cpp:329-487: obs5_seq.gz,
    exp5_seq.gz, obs_gc.gz, exp_gc.gz, obs5_pos.gz, ...). The expected
    tables exist once the correction has run its first pass."""
    d = os.path.join(out_dir, aux_dir)
    os.makedirs(d, exist_ok=True)
    obs = bias_state.obs

    def dump(name, mat):
        _write_matrix_gz(os.path.join(d, name), mat)

    if opts.seq_bias_correct:
        dump("obs5_seq.gz", obs.obs5)
        dump("obs3_seq.gz", obs.obs3)
        if bias_state.exp5_counts is not None:
            dump("exp5_seq.gz", bias_state.exp5_counts)
            dump("exp3_seq.gz", bias_state.exp3_counts)
    if opts.gc_bias_correct:
        # at the configured model resolution (numGCBins x
        # conditionalGCBins), like the reference's GCFragModel counts
        dump("obs_gc.gz", obs.gc_obs if bias_state.gc_obs_model is None
             else bias_state.gc_obs_model)
        if bias_state.gc_exp is not None:
            dump("exp_gc.gz", bias_state.gc_exp
                 if bias_state.gc_exp_model is None
                 else bias_state.gc_exp_model)
    if opts.pos_bias_correct:
        dump("obs5_pos.gz", obs.pos5)
        dump("obs3_pos.gz", obs.pos3)
        if bias_state.pos5_exp is not None:
            dump("exp5_pos.gz", bias_state.pos5_exp)
            dump("exp3_pos.gz", bias_state.pos3_exp)


def write_empty_outputs(out_dir: str, aux_dir: str, names: Sequence[str],
                        complete_lengths: np.ndarray,
                        error: str = "insufficient_assigned_fragments"
                        ) -> None:
    """Graceful degradation (reference writeEmptyAbundances/Meta,
    GZipWriter.cpp:663-682,197-214 + SalmonQuantify.cpp:2909-2925)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "quant.sf"), "w") as fh:
        fh.write("Name\tLength\tEffectiveLength\tTPM\tNumReads\n")
        for i, nm in enumerate(names):
            fh.write(f"{nm}\t{int(complete_lengths[i])}\t"
                     f"{float(complete_lengths[i]):.3f}\t0.000000\t0.000\n")
    write_meta_info(out_dir, aux_dir, {"quant_errors": [error],
                                       "num_processed": 0,
                                       "num_mapped": 0,
                                       "percent_mapped": 0.0})


def write_gene_quant(out_dir: str, gene_names: Sequence[str],
                     gene_lens: np.ndarray, gene_eff_lens: np.ndarray,
                     gene_tpm: np.ndarray, gene_counts: np.ndarray,
                     sig_digits: int = 3) -> str:
    """quant.genes.sf (reference GZipWriter::writeAbundances at gene
    level, via aggregateEstimatesToGeneLevel)."""
    path = os.path.join(out_dir, "quant.genes.sf")
    with open(path, "w") as fh:
        fh.write("Name\tLength\tEffectiveLength\tTPM\tNumReads\n")
        for i, nm in enumerate(gene_names):
            fh.write(f"{nm}\t{gene_lens[i]:.{sig_digits}f}\t"
                     f"{gene_eff_lens[i]:.{sig_digits}f}\t"
                     f"{gene_tpm[i]:f}\t{gene_counts[i]:.{sig_digits}f}\n")
    return path
