"""Alignment-based quantification (`quant -a <bam> -t <fasta>`).

Counterpart of salmon_tpu/alignment/quant.py (reference
salmonAlignmentQuantify / quantifyLibrary / processMiniBatch,
src/alignment/SalmonQuantifyAlignments.cpp:1524,940,126). The BAM is
read on the host (alignment/bamio.py) and fragments are grouped by
read-name adjacency with vectorized numpy, then weighed in one native
pass (alignment/alnweights.py); the per-alignment weights
combine the fragment-length probability, library-format compatibility
and the error model's likelihood (the alignment score before the model
has seen numPreBurninFrags fragments). On `device`: the error model
(errormodel_device.py), the observed bias histograms, the EM/VBEM and,
with a bias flag, the corrected effective lengths and a second EM;
then mapping mode's writers.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from salmon_tpu_torch.alignment.alnweights import group_eq
from salmon_tpu_torch.alignment.bamio import (BamReader, FLAG_PAIRED,
                                              FLAG_READ1, FLAG_READ2,
                                              FLAG_REVERSE, FLAG_UNMAPPED)
from salmon_tpu_torch.alignment.errormodel import (ONTErrorModel,
                                                   clip_counts)
from salmon_tpu_torch.alignment.errormodel_device import \
    DeviceAlignmentErrorModel
from salmon_tpu_torch.inference import em as em_mod
from salmon_tpu_torch.inference.eqclasses import EquivalenceClassAccumulator
from salmon_tpu_torch.io import writers
from salmon_tpu_torch.models.bias import (bias_device_tensors,
                                          collect_bias_observations)
from salmon_tpu_torch.models.bias_correct import BiasState
from salmon_tpu_torch.models.efflen import effective_lengths
from salmon_tpu_torch.models.fld import FragmentLengthDistribution
from salmon_tpu_torch.utils import libformat
from salmon_tpu_torch.utils.graphcache import stats_totals

logger = logging.getLogger("salmon_tpu_torch")

INVALID_TXP = 0x7FFFFFFF


ALIGNER_HINTS = {
    "bowtie2": "Bowtie2", "bowtie": "Bowtie", "bwa": "BWA",
    "star": "STAR", "hisat2": "HISAT2", "hisat": "HISAT",
    "minimap2": "minimap2", "rapmap": "RapMap", "pufferfish":
    "pufferfish", "salmon": "salmon"}


def detect_aligner(header_text: str) -> str:
    """@PG-based aligner detection (reference AlignmentCommon::
    checkHeader, src/alignment/AlignmentCommon.cpp:12-60). Logs what
    produced the BAM; warns when nothing recognizable is found."""
    found = ""
    for line in (header_text or "").splitlines():
        if not line.startswith("@PG"):
            continue
        low = line.lower()
        for key, pretty in ALIGNER_HINTS.items():
            if key in low:
                found = pretty
                break
        if found:
            break
    if found:
        logger.info("alignments produced by %s", found)
    else:
        logger.warning("could not determine the aligner from the BAM "
                       "header (@PG); proceeding anyway")
    return found


def _targets_index(names, tlens, records):
    """A TranscriptomeIndex-shaped shim over the -t FASTA targets so
    alignment mode shares write_outputs and the bias machinery."""
    from salmon_tpu_torch.index.builder import TranscriptomeIndex
    seq_off = np.zeros(len(names) + 1, dtype=np.int64)
    seq_off[1:] = np.cumsum([r.seq_codes.shape[0] for r in records])
    seq = (np.concatenate([r.seq_codes for r in records])
           if records else np.zeros(0, np.uint8))
    lens32 = tlens.astype(np.int32)
    return TranscriptomeIndex(
        k=0, names=list(names), lengths=lens32,
        complete_lengths=lens32, first_decoy_index=len(names),
        kmers=np.zeros(0, np.uint64),
        occ_offsets=np.zeros(1, np.int64),
        occ_txp=np.zeros(0, np.int32), occ_pf=np.zeros(0, np.int32),
        table=None,
        seq_codes=seq, seq_offsets=seq_off, info={})


def _load_targets(fasta_path: str):
    from salmon_tpu_torch.io.fasta import load_transcripts
    records, _ = load_transcripts(fasta_path, noclip_polya=True)
    names = [r.name for r in records]
    lens = np.array([r.seq_codes.shape[0] for r in records],
                    dtype=np.int64)
    return names, lens, records


def _group_fragments(b, paired: bool):
    """Vectorized fragment grouping of one BamBatch.

    Returns (frag_id, keep, txp, flen, obs_code, score, fw, pos, i1, i2)
    per RECORD for single-end, or per R1-RECORD for paired (each R1
    paired with the next record of the same fragment).
    """
    n = b.n
    flag = b.flag[:n].astype(np.int64)
    mapped = (flag & FLAG_UNMAPPED) == 0
    refid = b.refid[:n]
    new_frag = np.ones(n, dtype=bool)
    new_frag[1:] = b.name_hash[1:n] != b.name_hash[:n - 1]
    frag_id = np.cumsum(new_frag) - 1

    if not paired:
        fw = (flag & FLAG_REVERSE) == 0
        obs = np.where(fw, 0, 1)
        keep = mapped & (refid >= 0)
        score = np.where(b.as_tag[:n] > np.iinfo(np.int32).min,
                         b.as_tag[:n], 0)
        idx = np.arange(n)
        return (frag_id, keep, refid, b.read_len[:n].astype(np.int64),
                obs, score, (flag & FLAG_REVERSE) == 0, b.pos[:n],
                idx, idx)

    # paired: R1 record + immediately-following R2 record of the same
    # fragment form one alignment (htslib/BAMQueue pairing convention)
    is_r1 = (flag & FLAG_READ1) != 0
    nxt_same = np.zeros(n, dtype=bool)
    nxt_same[:n - 1] = frag_id[1:] == frag_id[:n - 1]
    nxt_is_r2 = np.zeros(n, dtype=bool)
    nxt_is_r2[:n - 1] = (b.flag[1:n].astype(np.int64) & FLAG_READ2) != 0
    a1 = is_r1 & nxt_same & nxt_is_r2
    i1 = np.nonzero(a1)[0]
    i2 = i1 + 1
    keep = (mapped[i1] & mapped[i2] & (refid[i1] >= 0)
            & (refid[i1] == refid[i2]))
    fw1 = (flag[i1] & FLAG_REVERSE) == 0
    fw2 = (flag[i2] & FLAG_REVERSE) == 0
    p1 = b.pos[i1].astype(np.int64)
    p2 = b.pos[i2].astype(np.int64)
    flen = np.abs(b.tlen[i1].astype(np.int64))
    # observed format code (reference hitType, SalmonUtils.cpp:531-576)
    opp = fw1 != fw2
    obs = np.where(
        opp & fw1, np.where(p1 <= p2, 0, 1),
        np.where(opp, np.where(p2 <= p1, 2, 3), np.where(fw1, 4, 5)))
    s1 = np.where(b.as_tag[i1] > np.iinfo(np.int32).min, b.as_tag[i1], 0)
    s2 = np.where(b.as_tag[i2] > np.iinfo(np.int32).min, b.as_tag[i2], 0)
    return (frag_id[i1], keep, refid[i1], flen, obs, s1 + s2, fw1,
            np.minimum(p1, p2), i1, i2)


def _ont_ll(ont, b, recs):
    fcl, bcl, scl, hcl = clip_counts(b, recs)
    return ont.log_likelihood(b.read_len[recs].astype(np.int64),
                              b.nm_tag[recs].astype(np.int64),
                              fcl, bcl, scl, hcl)


def _ont_update(ont, b, recs, w):
    fcl, bcl, scl, hcl = clip_counts(b, recs)
    ont.update(b.read_len[recs].astype(np.int64),
               b.nm_tag[recs].astype(np.int64), fcl, bcl, scl, hcl, w)


def _weigh_fragments(fid, txp_k, flen_k, obs_k, logw, opts, paired):
    """Per-fragment normalized alignment weights and eq rows (the numpy
    branch of salmon_tpu/alignment/quant.py:552-613): with
    _best_alignments, the plain version of alnweights.group_eq.
    Returns (eq_txp, eq_w, w, valid_w, starts, counts, wn, fld_hist or
    None)."""
    starts = np.concatenate([[0], np.nonzero(fid[1:] != fid[:-1])[0] + 1])
    counts = np.diff(np.concatenate([starts, [fid.shape[0]]]))
    max_w = np.maximum.reduceat(logw, starts)
    w = np.exp(logw - np.repeat(max_w, counts))
    valid_w = w > opts.min_aln_prob

    # fixed-width eq rows (rows = fragments)
    F = starts.shape[0]
    T2 = int(counts.max())
    eq_txp = np.full((F, T2), INVALID_TXP, dtype=np.int32)
    eq_w = np.zeros((F, T2), dtype=np.float32)
    row = np.repeat(np.arange(F), counts)
    col = np.arange(fid.shape[0]) - np.repeat(starts, counts)
    eq_txp[row[valid_w], col[valid_w]] = txp_k[valid_w]
    eq_w[row[valid_w], col[valid_w]] = w[valid_w]
    # collapse duplicate txps within a fragment + sort labels
    # (vectorized run-merge: weights accumulate at run starts)
    o2 = np.argsort(eq_txp, axis=1, kind="stable")
    eq_txp = np.take_along_axis(eq_txp, o2, axis=1)
    eq_w = np.take_along_axis(eq_w, o2, axis=1)
    flat = eq_txp.ravel()
    fw_ = eq_w.ravel().astype(np.float64)
    new = np.ones(F * T2, dtype=bool)
    new[1:] = flat[1:] != flat[:-1]
    new[::T2] = True
    gid = np.cumsum(new) - 1
    sums = np.bincount(gid, weights=fw_)
    fw_out = np.zeros_like(fw_)
    fw_out[new] = sums
    eq_w = fw_out.reshape(F, T2).astype(np.float32)
    eq_txp = np.where(new, flat, INVALID_TXP).reshape(F, T2)
    eq_w[eq_txp == INVALID_TXP] = 0.0
    o3 = np.argsort(eq_txp, axis=1, kind="stable")
    eq_txp = np.take_along_axis(eq_txp, o3, axis=1)
    eq_w = np.take_along_axis(eq_w, o3, axis=1)

    # per-fragment posterior of each alignment (reference
    # processMiniBatch), which weights the FLD and the model update
    wsum_f = np.bincount(row, weights=np.where(valid_w, w, 0.0),
                         minlength=F)
    wn = np.where(valid_w, w, 0.0) / np.maximum(np.repeat(wsum_f, counts),
                                                1e-300)
    hist = None
    if paired:
        good = (obs_k >= 0) & (flen_k > 0) & valid_w
        hist = np.bincount(
            np.clip(flen_k[good], 0, opts.max_frag_length),
            weights=wn[good],
            minlength=opts.max_frag_length + 1).astype(np.float64)
    return eq_txp, eq_w, w, valid_w, starts, counts, wn, hist


def _best_alignments(w, valid_w, starts, counts):
    """Index of each fragment's first max-weight alignment, for the
    fragments with a valid one."""
    F = starts.shape[0]
    wv = np.where(valid_w, w, -1.0)
    frag_of = np.repeat(np.arange(F), counts)
    mx = np.maximum.reduceat(wv, starts)
    bidx = np.nonzero(wv == np.repeat(mx, counts))[0]
    bsel = bidx[np.unique(frag_of[bidx], return_index=True)[1]]
    return bsel[mx[frag_of[bsel]] > 0]


def _posterior_sample_bam(args, opts, out_dir, counts, eff, name_to_id,
                          fld, lib_fmt, paired: bool, err_model=None,
                          ont_model=None) -> None:
    """--sampleOut: re-walk the BAM and emit one posterior-sampled record
    (pair) per fragment as postSample.bam (reference
    salmon::sampler::sampleLibrary, Sampler.hpp:342: the per-alignment
    weight is the full quantifier logProb, abundance/effLen x FLD x
    compat x the trained error-model likelihood)."""
    from salmon_tpu_torch.alignment.sampler import BamWriter, sample_fragments

    rng = np.random.default_rng(getattr(args, "seed", 271828))
    log_alpha = np.log(np.maximum(counts / np.maximum(eff, 1.0), 1e-300))
    log_pmf = fld.log_pmf()
    fmt = libformat.parse_library_format(lib_fmt)
    writer = None
    n_out = 0
    for bam_path in args.alignments:
        rdr = BamReader(bam_path, want_names=True)
        if writer is None:
            writer = BamWriter(os.path.join(out_dir, "postSample.bam"),
                               rdr.ref_names, rdr.ref_lens)
        ref_map = np.array(
            [name_to_id.get(nm, -1) for nm in rdr.ref_names],
            dtype=np.int64)
        for b in rdr.batches():
            (frag_id, keep, refid, flen, obs, score, fw, pos, i1, i2) = \
                _group_fragments(b, paired)
            txp = np.where(keep & (refid >= 0),
                           ref_map[np.clip(refid, 0,
                                           len(ref_map) - 1)], -1)
            keep = keep & (txp >= 0)

            def emit(ridx, zw=None):
                co = b.cigar_op[b.cigar_off[ridx]:
                                b.cigar_off[ridx] + b.cigar_n[ridx]]
                cl = b.cigar_oplen[b.cigar_off[ridx]:
                                   b.cigar_off[ridx] + b.cigar_n[ridx]]
                seq = b.seq_buf[b.seq_off[ridx]:
                                b.seq_off[ridx] + b.read_len[ridx]]
                writer.add_record(
                    b.names[ridx], int(b.refid[ridx]), int(b.pos[ridx]),
                    int(b.flag[ridx]), int(b.mapq[ridx]), co, cl, seq,
                    int(b.mate_refid[ridx]), int(b.mate_pos[ridx]),
                    int(b.tlen[ridx]), zw=zw)

            if getattr(args, "sampleUnaligned", False):
                # pass unassigned fragments through verbatim (reference
                # --sampleUnaligned)
                uniq, first = np.unique(frag_id, return_index=True)
                has_keep = np.zeros(int(frag_id.max()) + 1, bool)
                has_keep[frag_id[keep]] = True
                for s in first[~has_keep[uniq]]:
                    emit(int(i1[s]))
                    if paired:
                        emit(int(i2[s]))

            if not keep.any():
                continue
            k = np.nonzero(keep)[0]
            if paired:
                compat = libformat.paired_compat_table(fmt)[
                    np.clip(obs[k], 0, 5)]
                lf = log_pmf[np.clip(flen[k], 0, opts.max_frag_length)]
            else:
                compat = libformat.single_compat_table(fmt)[
                    np.clip(obs[k], 0, 1)]
                lf = 0.0
            # trained error-model likelihood (the same fg-bg term the
            # quantifier used, Sampler.hpp:342)
            err_ll = 0.0
            if ont_model is not None:
                err_ll = _ont_ll(ont_model, b, i1[k])
                if paired:
                    err_ll = err_ll + _ont_ll(ont_model, b, i2[k])
            elif err_model is not None:
                err_ll = err_model.log_likelihood(b, i1[k], ref_map, 0)
                if paired:
                    err_ll = err_ll + err_model.log_likelihood(
                        b, i2[k], ref_map, 1)
            logw = (log_alpha[txp[k]] + lf + err_ll
                    + np.where(compat, 0.0, -30.0))
            w = np.exp(logw - logw.max())
            # ZW = the sampled alignment's posterior probability within
            # its fragment (reference Sampler ZW tag semantics)
            fidk = frag_id[k]
            _, inv = np.unique(fidk, return_inverse=True)
            tot = np.bincount(inv, weights=w)
            zw_all = w / np.maximum(tot[inv], 1e-300)
            sel = sample_fragments(rng, fidk, w)
            for s in sel:
                emit(int(i1[k[s]]), zw=float(zw_all[s]))
                if paired:
                    emit(int(i2[k[s]]), zw=float(zw_all[s]))
                n_out += 1
        rdr.close()
    if writer is not None:
        writer.close()
    logger.info("posterior-sampled BAM: %d fragments -> %s", n_out,
                os.path.join(out_dir, "postSample.bam"))


def quantify_alignments(args, opts, cmd_args, device) -> int:
    """Alignment-based quantification driver (reference
    salmonAlignmentQuantify, SalmonQuantifyAlignments.cpp:1524), the
    device work on `device`. Logs its stage clocks with
    extra={"clocks": ...}: bam_read_seconds, errmodel_seconds,
    em_seconds, with a bias flag bias_collect_seconds and the pass and
    second-EM clocks, host_path_records (error-model records that
    took the numpy walk) and errmodel_graph_* (the error model's
    compiled steps: signatures, eager runs, captures, replays, capture
    seconds, pool bytes)."""
    t0 = time.time()
    device = torch.device(device)
    if not args.targets:
        logger.error("alignment-based mode requires -t/--targets")
        return 1
    names, tlens, records = _load_targets(args.targets)
    name_to_id = {nm: i for i, nm in enumerate(names)}

    lib_fmt = args.libType.strip().upper()
    auto = lib_fmt == "A"

    acc = EquivalenceClassAccumulator()
    fld = FragmentLengthDistribution(
        max_val=opts.max_frag_length, prior_mu=opts.frag_len_prior_mean,
        prior_sigma=opts.frag_len_prior_sd)
    num_processed = 0
    num_mapped = 0
    fmt_hist = np.zeros(6, dtype=np.int64)
    score_exp = getattr(args, "scoreExp", 1.0) or 1.0
    paired_detect: Optional[bool] = None
    clocks = {"bam_read_seconds": 0.0, "errmodel_seconds": 0.0,
              "host_path_records": 0}

    shim_index = _targets_index(names, tlens, records)

    # bias-model state (shared with mapping mode; the reference enables
    # the same finalize path for alignment inputs,
    # AlignmentPipelineStages.cpp:61-90); observations are collected
    # from paired input only
    bias_state = bdev = None
    if (opts.seq_bias_correct or opts.gc_bias_correct
            or opts.pos_bias_correct):
        bias_state = BiasState(shim_index, opts, device)
        bdev = bias_device_tensors(shim_index, device)
        clocks["bias_collect_seconds"] = 0.0

    use_ont = bool(getattr(args, "ont", False))
    if use_ont:
        # --ont forces noLengthCorrection (ProgramOptionsGenerator:332)
        opts.no_length_correction = True
    use_error_model = not getattr(args, "noErrorModel", False) and \
        not use_ont
    ont = ONTErrorModel() if use_ont else None
    err = (DeviceAlignmentErrorModel(shim_index.seq_codes,
                                     shim_index.seq_offsets, tlens,
                                     device=device)
           if use_error_model else None)
    # the error model trains ONLINE inside the single streaming pass
    # below, like the reference processMiniBatch: its likelihood is used
    # once numPreBurninFrags fragments have been seen and it keeps
    # updating until numBurninFrags (SalmonQuantifyAlignments.cpp:222,
    # 311, 523, 855-863; SalmonDefaults.hpp:73-74)
    err_trained = 0
    pre_burnin = int(opts.num_pre_burnin_frags)
    burnin_cap = int(opts.num_burnin_frags)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # --writeUnmappedNames: fragments with no usable alignment
    # (reference OutputUnmappedFilter role)
    unmapped_fh = None
    if getattr(args, "writeUnmappedNames", False):
        aux = os.path.join(args.output, opts.aux_dir)
        os.makedirs(aux, exist_ok=True)
        unmapped_fh = open(os.path.join(aux, "unmapped_names.txt"), "w")

    try:
        aligner_checked = False
        for bam_path in args.alignments:
            rdr = BamReader(bam_path, want_names=unmapped_fh is not None)
            if not aligner_checked:
                detect_aligner(rdr.header_text)
                aligner_checked = True
            # map BAM refs -> target ids by name (the reference validates
            # the header against the -t FASTA)
            ref_map = np.array([name_to_id.get(nm, -1)
                                for nm in rdr.ref_names], dtype=np.int64)
            if not (ref_map >= 0).any():
                logger.error("no BAM reference names match the target "
                             "FASTA")
                rdr.close()
                return 1
            batches = rdr.batches()
            while True:
                t_read = time.perf_counter()
                b = next(batches, None)
                clocks["bam_read_seconds"] += time.perf_counter() - t_read
                if b is None:
                    break
                if paired_detect is None:
                    paired_detect = bool(b.flag[0] & FLAG_PAIRED)
                    if auto:
                        lib_fmt = "IU" if paired_detect else "U"
                (frag_id, keep, refid, flen, obs, score, fw, pos, i1,
                 i2) = _group_fragments(b, paired_detect)
                txp = np.where(keep & (refid >= 0),
                               ref_map[np.clip(refid, 0, len(ref_map) - 1)],
                               -1)
                keep = keep & (txp >= 0)
                ksel = np.nonzero(keep)[0]

                # error-model log-likelihood per alignment (fg - bg) under
                # the model trained on earlier batches (used once
                # numPreBurninFrags fragments are seen, reference
                # useAuxParams at :222, 311)
                t_err = time.perf_counter()
                model_ready = err_trained >= pre_burnin
                err_ll = np.zeros(len(frag_id))
                # expand this batch's CIGARs once; the keys feed both the
                # likelihood and (during burn-in) the update
                prep = None
                if (err is not None and ksel.size
                        and (model_ready or err_trained < burnin_cap)):
                    prep = err.prepare(b, i1[ksel],
                                       i2[ksel] if paired_detect else None,
                                       ref_map)
                    clocks["host_path_records"] += prep.host_records
                if model_ready and prep is not None:
                    err_ll[ksel] = prep.log_likelihood()
                elif model_ready and ont is not None and ksel.size:
                    ll = _ont_ll(ont, b, i1[ksel])
                    if paired_detect:
                        ll = ll + _ont_ll(ont, b, i2[ksel])
                    err_ll[ksel] = ll
                clocks["errmodel_seconds"] += time.perf_counter() - t_err

                uniq_frags, first_rec = np.unique(frag_id,
                                                  return_index=True)
                num_processed += uniq_frags.shape[0]
                if unmapped_fh is not None:
                    has_keep = np.zeros(int(frag_id.max()) + 1, bool)
                    has_keep[frag_id[keep]] = True
                    for u, fr in zip(uniq_frags, first_rec):
                        if not has_keep[u]:
                            nm = b.names[int(i1[fr])]
                            nm = (nm.decode() if isinstance(nm, bytes)
                                  else nm)
                            unmapped_fh.write(f"{nm} u\n")
                if not ksel.size:
                    continue

                fid = frag_id[keep]
                txp_k = txp[keep]
                flen_k = flen[keep]
                obs_k = obs[keep]
                score_k = score[keep].astype(np.float64)

                # fragment-length probability + compatibility with the
                # expected format
                fmt = libformat.parse_library_format(lib_fmt)
                if paired_detect:
                    compat = libformat.paired_compat_table(fmt)[
                        np.clip(obs_k, 0, 5)]
                    lf = fld.log_pmf()[np.clip(flen_k, 0,
                                               opts.max_frag_length)]
                else:
                    compat = libformat.single_compat_table(fmt)[
                        np.clip(obs_k, 0, 1)]
                    lf = 0.0
                # per-alignment weight: the error model's log-likelihood
                # once trained (reference processMiniBatch), else the
                # AS-based stand-in (the reference's useASWithoutCIGAR
                # -scoreExp*(bestAS-AS))
                if (err is not None or ont is not None) and model_ready:
                    logw = err_ll[keep] + lf
                else:
                    logw = score_exp * score_k + lf
                logw = np.where(compat, logw,
                                logw + (np.log(opts.incompat_prior)
                                        if opts.incompat_prior > 0
                                        else -1e30))

                # fid is a cumsum over the BAM walk: nondecreasing, so
                # each fragment's alignments are one contiguous run, and
                # one native pass weighs them (the native branch of the
                # JAX package's -a; _weigh_fragments and _best_alignments
                # are its plain version)
                eq_txp, eq_w, wn, best, hist, n_map = group_eq(
                    fid, txp_k, flen_k, obs_k, logw, opts.min_aln_prob,
                    paired_detect, opts.max_frag_length)
                F = best.shape[0]
                num_mapped += n_map
                acc.add_batch(eq_txp, eq_w, None)
                if paired_detect:
                    fld.add_observations(hist)

                # online error-model update with this batch's posterior
                # weights (reference :855-863: update sampled with
                # probability exp(logProb) until numBurninFrags)
                if (err is not None or ont is not None) \
                        and err_trained < burnin_cap:
                    t_err = time.perf_counter()
                    if ont is not None:
                        _ont_update(ont, b, i1[ksel], wn)
                        if paired_detect:
                            _ont_update(ont, b, i2[ksel], wn)
                    else:
                        prep.update(wn)
                    clocks["errmodel_seconds"] += (time.perf_counter()
                                                   - t_err)
                    err_trained += F

                bsel = best[best >= 0]
                if paired_detect:
                    # observed-format histogram: one count per fragment
                    fmt_hist += np.bincount(np.clip(obs_k[bsel], 0, 5),
                                            minlength=6)
                # bias observations from each fragment's best alignment
                if bias_state is not None and paired_detect and bsel.size:
                    t_col = time.perf_counter()
                    bs = pos[keep][bsel].astype(np.int32)
                    bias_state.obs.add_batch(collect_bias_observations(
                        bdev, put(txp_k[bsel].astype(np.int32)), put(bs),
                        put((bs + np.maximum(flen_k[bsel], 1)
                             - 1).astype(np.int32)),
                        put(fw[keep][bsel]),
                        put(b.read_len[i1][keep][bsel].astype(np.int32)),
                        put(b.read_len[i2][keep][bsel].astype(np.int32)),
                        put(flen_k[bsel] > 0),
                        put(np.ones(bsel.shape, np.float32))))
                    clocks["bias_collect_seconds"] += (time.perf_counter()
                                                       - t_col)
            rdr.close()
    finally:
        if unmapped_fh is not None:
            unmapped_fh.close()

    if num_mapped < opts.min_assigned_frags:
        writers.write_empty_outputs(args.output, opts.aux_dir, names, tlens)
        logger.error("only %d assigned fragments (min %d)", num_mapped,
                     opts.min_assigned_frags)
        return 1

    eq = acc.finish()
    fld_pmf = fld.pmf()
    eff = effective_lengths(
        tlens, fld_pmf,
        no_length_correction=opts.no_length_correction,
        no_effective_length_correction=opts.no_effective_length_correction)

    t_em = time.perf_counter()
    emc = em_mod.EMConfig(
        use_vbem=opts.use_vb_opt and not opts.use_em,
        vb_prior=opts.vb_prior,
        per_transcript_prior=opts.per_transcript_prior,
        rel_diff_tolerance=opts.relative_diff_tolerance,
        max_iterations=opts.max_em_iterations,
        min_iterations=(opts.min_required_iterations
                        if bias_state is not None
                        else opts.min_em_iterations))
    res = em_mod.optimize(eq, len(names), eff, config=emc, device=device)
    em_runs = [res]
    if bias_state is not None:
        # bias-aware effective-length recompute + re-optimize, as in
        # mapping mode (CollapsedEMOptimizer.cpp:900-928)
        logger.info("recomputing effective lengths with bias models")
        eff2 = bias_state.corrected_effective_lengths(res["alphas"], eff,
                                                      fld_pmf)
        clocks.update({f"bias_{k}_seconds": v
                       for k, v in bias_state.seconds.items()})
        clocks.update(bias_state.graph_clocks(bdev))
        if not np.allclose(eff2, eff):
            eff = eff2
            t_em2 = time.perf_counter()
            res = em_mod.optimize(eq, len(names), eff, config=emc,
                                  device=device)
            em_runs.append(res)
            clocks["em2_seconds"] = time.perf_counter() - t_em2
    clocks["em_seconds"] = time.perf_counter() - t_em
    clocks.update(em_mod.loop_clocks(em_runs))
    # the error model's compiled steps (their graphs on the card; the
    # sampler's later calls not yet counted)
    clocks.update({f"errmodel_graph_{k}": v for k, v in stats_totals(
        err.graphs.stats.values() if err is not None and err.graphs
        else ()).items()})
    logger.info("alignment-mode clocks (s): %s", clocks,
                extra={"clocks": clocks})
    counts = res["alphas"]

    # mapping mode's finalize path (draws, meta, fld, ambig_info, eq
    # dumps); -a counts observed formats under the paired names in both
    # layouts, as the JAX package does, so write_outputs reads them so
    from salmon_tpu_torch.quant import QuantResult, write_outputs
    fmt_counts = {nm: int(fmt_hist[i]) for i, nm in
                  enumerate(libformat.format_names_paired())}
    result = QuantResult(
        names=list(names), counts=counts, eff_lens=eff,
        tpm=writers.compute_tpm(counts, eff),
        num_processed=num_processed, num_mapped=num_mapped,
        num_paired=num_mapped if paired_detect else 0,
        num_orphans=0, em_info=res, fmt_counts=fmt_counts,
        eq_classes=eq, fld=fld, lib_format=lib_fmt, paired=True,
        bias=bias_state)
    out = args.output
    write_outputs(result, shim_index, out, opts=opts, cmd_args=cmd_args,
                  dump_eq=args.dumpEq or args.dumpEqWeights,
                  dump_eq_weights=True,
                  seed=getattr(args, "seed", 271828),
                  device=device, mapping_type="alignment")
    if getattr(args, "sampleOut", False):
        _posterior_sample_bam(args, opts, out, counts, eff, name_to_id,
                              fld, lib_fmt, bool(paired_detect),
                              err_model=err, ont_model=ont)
    if args.geneMap and not opts.skip_quant:
        from salmon_tpu_torch.utils.genemap import aggregate_quant_sf
        aggregate_quant_sf(os.path.join(out, "quant.sf"), args.geneMap)
    logger.info("alignment-mode quantification written to %s (%.1fs)",
                out, time.time() - t0)
    return 0
