"""Transcript -> gene mapping and gene-level aggregation.

Host copy of salmon_tpu/utils/genemap.py. Reference: TranscriptGeneMap
(include/salmon/internal/util/TranscriptGeneMap.hpp),
transcriptGeneMapFromGTF / readTranscriptToGeneMap and
aggregateEstimatesToGeneLevel (src/util/SalmonUtils.cpp:1987-2160).

Semantics preserved: gene TPM/NumReads are sums over member transcripts;
gene Length/EffectiveLength are TPM-fraction-weighted averages (uniform
average when the gene has ~zero TPM); transcripts absent from the map
become their own gene (with a warning).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Sequence

import numpy as np

logger = logging.getLogger("salmon_tpu_torch")

_GTF_EXTS = {".gtf", ".gff", ".gff3"}
_ATTR_RE = {
    "gtf": re.compile(r'(\S+)\s+"([^"]*)"'),
    "gff3": re.compile(r"(\S+?)=([^;]*)"),
}


def _parse_gtf_attrs(attrs: str, style: str) -> dict:
    return {m.group(1): m.group(2)
            for m in _ATTR_RE[style].finditer(attrs)}


def transcript_gene_map_from_gtf(path: str, gene_key: str = "gene_id",
                                 txp_key: str = "transcript_id") -> dict:
    """Parse GTF/GFF3 into {transcript_name: gene_name}."""
    import gzip
    opener = gzip.open if path.endswith(".gz") else open
    style = "gff3" if path.rstrip(".gz").lower().endswith(
        (".gff", ".gff3")) else "gtf"
    out: dict[str, str] = {}
    with opener(path, "rt") as fh:
        for line in fh:
            if not line or line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 9:
                continue
            attrs = _parse_gtf_attrs(f[8], style)
            if style == "gff3":
                tid = attrs.get(txp_key) or attrs.get("ID")
                gid = attrs.get(gene_key) or attrs.get("Parent")
            else:
                tid = attrs.get(txp_key)
                gid = attrs.get(gene_key)
            if tid and gid:
                out.setdefault(tid, gid)
    return out


def read_transcript_to_gene_map(path: str) -> dict:
    """Two-column TSV: transcript <tab> gene (reference
    readTranscriptToGeneMap)."""
    out: dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) >= 2 and f[0]:
                out.setdefault(f[0], f[1])
    return out


def load_gene_map(path: str) -> dict:
    ext = os.path.splitext(path.rstrip(".gz") if path.endswith(".gz")
                           else path)[1].lower()
    if ext in _GTF_EXTS:
        return transcript_gene_map_from_gtf(path)
    return read_transcript_to_gene_map(path)


def aggregate_to_gene_level(txp_names: Sequence[str], lengths: np.ndarray,
                            eff_lens: np.ndarray, tpm: np.ndarray,
                            counts: np.ndarray, t2g: dict):
    """Returns (gene_names, g_len, g_efflen, g_tpm, g_counts)."""
    gene_of = []
    missing = 0
    for nm in txp_names:
        g = t2g.get(nm)
        if g is None:
            missing += 1
            g = nm
        gene_of.append(g)
    if missing:
        logger.warning(
            "%d transcripts not in the transcript<->gene map; "
            "returned as their own genes", missing)
    genes = sorted(set(gene_of))
    gidx = {g: i for i, g in enumerate(genes)}
    gi = np.array([gidx[g] for g in gene_of], dtype=np.int64)
    n = len(genes)
    g_tpm = np.bincount(gi, weights=tpm, minlength=n)
    g_counts = np.bincount(gi, weights=counts, minlength=n)
    members = np.bincount(gi, minlength=n).astype(np.float64)

    min_tpm = np.finfo(np.float64).tiny
    # TPM-fraction weights; uniform for unexpressed genes
    denom = np.where(g_tpm[gi] > min_tpm, g_tpm[gi], 1.0)
    frac = np.where(g_tpm[gi] > min_tpm, tpm / denom, 1.0 / members[gi])
    g_len = np.bincount(gi, weights=lengths * frac, minlength=n)
    g_eff = np.bincount(gi, weights=eff_lens * frac, minlength=n)
    return genes, g_len, g_eff, g_tpm, g_counts


def aggregate_quant_sf(quant_sf_path: str, gene_map_path: str) -> str:
    """Reference generateGeneLevelEstimates: read quant.sf, write
    quant.genes.sf next to it."""
    from salmon_tpu_torch.io.writers import read_quant_sf, write_gene_quant

    t2g = load_gene_map(gene_map_path)
    q = read_quant_sf(quant_sf_path)
    genes, g_len, g_eff, g_tpm, g_counts = aggregate_to_gene_level(
        q["Name"], q["Length"].astype(np.float64), q["EffectiveLength"],
        q["TPM"], q["NumReads"], t2g)
    out_dir = os.path.dirname(quant_sf_path)
    return write_gene_quant(out_dir, genes, g_len, g_eff, g_tpm, g_counts)
