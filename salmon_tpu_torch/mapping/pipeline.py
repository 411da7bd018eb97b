"""The per-batch mapping pipeline, paired-end and single-end (the
reference's per-read hot loop, src/quant/SalmonQuantify.cpp:1199-1845
and :1881-2325 processReads + processMiniBatch, as one fixed-shape
tensor program).

Counterpart of salmon_tpu/mapping/pipeline.py. Stages:
  1. canonical k-mer extraction            (mapping.kmers)
  2. two-choice bucket lookup              (mapping.lookup)
  3. occurrence expansion + chain scoring  (mapping.score, dense; or
     mapping.seed_sparse with sparse_seed)
  4. mate pairing / orphan fallback        (mapping.pair)
  5. banded-DP validation                  (mapping.align, CUDA kernel),
     and with --recoverOrphans the rescue of orphans' missing mates
     (the same kernel at the rescue band)
  6. decoy-aware filtering, aux-probability weights and eq-class
     tensor emission (reference SalmonMappingUtils.hpp:82-405,
     SalmonQuantify.cpp:599-857)

Outputs are fixed-shape per-batch tensors on the batch's device; the
host accumulator (inference.eqclasses) merges equivalence classes.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from salmon_tpu_torch.constants import DEFAULTS, SalmonDefaults
from salmon_tpu_torch.index.builder import TranscriptomeIndex
from salmon_tpu_torch.mapping.align import (BANDED_DP,
                                            banded_scores_indexed,
                                            pack_seq4)
from salmon_tpu_torch.mapping.kmers import extract_kmers
from salmon_tpu_torch.mapping.lookup import hash_lookup
from salmon_tpu_torch.mapping.pair import (MS_LEFT_ORPHAN, MS_PAIRED,
                                           MS_RIGHT_ORPHAN, join_pairs,
                                           merge_paired_with_orphans,
                                           observed_paired_code,
                                           orphan_hits)
from salmon_tpu_torch.mapping.seed_sparse import seed_candidates_sparse
from salmon_tpu_torch.mapping.score import (_sort_rows,
                                            candidate_read_start,
                                            diag_bucket_bits_for,
                                            expand_occurrences,
                                            score_candidates,
                                            segment_carry_first,
                                            window_bits_for)
from salmon_tpu_torch.utils import spans
from salmon_tpu_torch.utils.graphcache import GraphCache, tensor_signature

logger = logging.getLogger("salmon_tpu_torch")

INVALID_TXP = 0x7FFFFFFF
LOG_EPSILON = -87.33654475055311  # SalmonMath.hpp LOG_EPSILON

# lead pad before the packed sequence: absorbs ref_base going negative
# by up to (max read length + bandwidth) — flip-based rc problems shift
# ref_base down by up to L (reads bucket up to 1024 bases)
_SEQ4_SHIFT = 1280


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Shape and policy configuration of one mapping run."""
    k: int
    n_slots: int
    max_probes: int
    first_decoy_index: int
    num_txps: int
    max_tpos: int = 1 << 20       # max transcript length (diag-bucket sizing)
    occ_cap: int = DEFAULTS.occ_cap
    max_cands: int = DEFAULTS.max_cands
    max_pair_cands: int = DEFAULTS.max_pair_cands
    max_occs_per_hit: int = DEFAULTS.max_occs_per_hit
    fld_max: int = DEFAULTS.max_frag_length
    consensus_fraction: float = 1.0 - DEFAULTS.consensus_slack
    score_exp: float = DEFAULTS.score_exp
    decoy_threshold: float = DEFAULTS.decoy_threshold
    min_aln_prob: float = DEFAULTS.min_aln_prob
    hard_filter: bool = DEFAULTS.hard_filter
    incompat_prior: float = DEFAULTS.incompat_prior
    allow_dovetail: bool = DEFAULTS.allow_dovetail
    discard_orphans: bool = DEFAULTS.discard_orphans
    range_bins: int = DEFAULTS.range_factorization_bins
    match_score: int = DEFAULTS.match_score
    kmer_stride: int = DEFAULTS.kmer_stride
    validate_mappings: bool = DEFAULTS.validate_mappings
    min_score_fraction: float = DEFAULTS.min_score_fraction
    dp_budget: int = DEFAULTS.dp_budget
    mismatch_penalty: int = DEFAULTS.mismatch_penalty
    gap_open_penalty: int = DEFAULTS.gap_open_penalty
    gap_extend_penalty: int = DEFAULTS.gap_extend_penalty
    dp_bandwidth: int = DEFAULTS.dp_bandwidth
    # orphan rescue (reference recoverOrphans, opt-in)
    recover_orphans: bool = DEFAULTS.recover_orphans
    max_recover_read_occ: int = DEFAULTS.max_recover_read_occ
    rescue_bandwidth: int = DEFAULTS.rescue_bandwidth
    # FLD-quantile positions probed per orphan (1 = mean only)
    rescue_probes: int = DEFAULTS.rescue_probes
    model_single_frag_prob: bool = not DEFAULTS.no_single_frag_prob
    no_frag_length_dist: bool = DEFAULTS.no_frag_length_dist
    softclip: bool = DEFAULTS.softclip
    softclip_overhangs: bool = DEFAULTS.softclip_overhangs
    # --writeOrphanLinks side output (SalmonQuantify.cpp:1409-1421)
    write_orphan_links: bool = DEFAULTS.write_orphan_links
    alignment_cache: bool = DEFAULTS.alignment_cache
    weight_width: int = DEFAULTS.weight_width
    # batch-global sparse seed flow (mapping.seed_sparse) in place of the
    # dense (R, P*C) expansion and per-row sorts
    sparse_seed: bool = DEFAULTS.sparse_seed
    occ_aligned: bool = False
    # table slots carry inlined single-occurrence records: the dense
    # expansion may pool its first-row gather over the other windows
    inline_singles: bool = False
    seed_hits_per_end: int = DEFAULTS.seed_hits_per_end

    @staticmethod
    def from_index(idx: TranscriptomeIndex, opts: SalmonDefaults = DEFAULTS,
                   allow_no_table: bool = False,
                   **overrides) -> "MapperConfig":
        """Configuration for `idx` under `opts`. SALMON_TPU_SPARSE_SEED,
        when set, overrides opts.sparse_seed ("1" turns the sparse seed
        flow on), as in the JAX package. An index without a monolithic
        hash table raises ValueError unless `allow_no_table` (the
        sharded path, which builds a table per shard and sets n_slots
        itself)."""
        if idx.table is None and not allow_no_table:
            raise ValueError(
                "this index has no monolithic hash table (built at "
                "genome-decoy scale); quantify with --indexShards N")
        env_sparse = os.environ.get("SALMON_TPU_SPARSE_SEED")
        cfg = dict(
            k=idx.k,
            n_slots=idx.table.n_slots if idx.table is not None else 0,
            max_probes=(idx.table.max_probes if idx.table is not None
                        else 16),
            first_decoy_index=idx.first_decoy_index,
            num_txps=idx.num_targets,
            max_tpos=int(np.asarray(idx.lengths).max())
            if idx.num_targets else 1,
            occ_cap=opts.occ_cap, max_cands=opts.max_cands,
            max_pair_cands=opts.max_pair_cands,
            max_occs_per_hit=opts.max_occs_per_hit,
            fld_max=opts.max_frag_length,
            consensus_fraction=1.0 - opts.consensus_slack,
            score_exp=opts.score_exp,
            decoy_threshold=opts.decoy_threshold,
            min_aln_prob=opts.min_aln_prob,
            hard_filter=opts.hard_filter,
            incompat_prior=opts.incompat_prior,
            allow_dovetail=opts.allow_dovetail,
            discard_orphans=opts.discard_orphans,
            range_bins=opts.range_factorization_bins,
            match_score=opts.match_score,
            kmer_stride=opts.kmer_stride,
            validate_mappings=opts.validate_mappings,
            min_score_fraction=opts.min_score_fraction,
            dp_budget=opts.dp_budget,
            mismatch_penalty=opts.mismatch_penalty,
            gap_open_penalty=opts.gap_open_penalty,
            gap_extend_penalty=opts.gap_extend_penalty,
            dp_bandwidth=opts.dp_bandwidth,
            recover_orphans=opts.recover_orphans,
            max_recover_read_occ=opts.max_recover_read_occ,
            rescue_bandwidth=opts.rescue_bandwidth,
            rescue_probes=opts.rescue_probes,
            model_single_frag_prob=not opts.no_single_frag_prob,
            no_frag_length_dist=opts.no_frag_length_dist,
            softclip=opts.softclip,
            softclip_overhangs=opts.softclip_overhangs,
            write_orphan_links=opts.write_orphan_links,
            alignment_cache=opts.alignment_cache,
            weight_width=opts.weight_width,
            sparse_seed=(env_sparse == "1" if env_sparse
                         else opts.sparse_seed),
            seed_hits_per_end=opts.seed_hits_per_end,
            occ_aligned=bool(idx.info.get("occ_oct_aligned", False)),
            inline_singles=bool(idx.info.get("table_inline_singles",
                                             False)),
        )
        cfg.update(overrides)
        kept = int(idx.info.get("max_occs_kept", 0) or 0)
        if kept and cfg["occ_cap"] > kept:
            # pruned CSR (--maxOccsKept): gathering past a key's kept
            # records would read the NEXT key's records — clamp
            logger.warning(
                "occ_cap %d exceeds the index's maxOccsKept %d; "
                "clamping (rebuild the index with a larger "
                "--maxOccsKept to raise it)", cfg["occ_cap"], kept)
            cfg["occ_cap"] = kept
        return MapperConfig(**cfg)


def seq4_words(idx: TranscriptomeIndex) -> np.ndarray:
    """(n_rows, 8) uint32 2-bit words of the index's sequence, with the
    _SEQ4_SHIFT lead pad (cached on the index object)."""
    words = getattr(idx, "_seq4_words_cache", None)
    if words is None:
        words, _ = pack_seq4(idx.seq_codes, lead_pad=_SEQ4_SHIFT)
        object.__setattr__(idx, "_seq4_words_cache", words)
    return words


def device_index_tensors(idx: TranscriptomeIndex, device="cuda",
                         planes=None) -> dict:
    """The index as a dict of tensors on `device`.

    Same contents as salmon_tpu.mapping.pipeline.device_index_arrays:
    tab_rows (n_buckets, 8) int32 bucket rows; occ_oct (n_oct, 16) int32
    with eight (txp, pos<<1|fwd) records per row; txp_lens int32;
    seq_off int32, or int64 past 2^31 concatenated bases; seq4, the
    (n_rows, 8) 2-bit sequence words as int32 bit patterns. The
    byte-per-base sequence stays on the host: the DP reads seq4.
    `planes`, (tab_rows, occ_oct), replaces the index's own table and
    occurrences (one shard of a sharded index).

    Spans: index.prep, the host's work (the occ_oct rebuild, seq4, the
    casts and the page-ins of the index's memory maps that they force);
    index.h2d, the copies (index.h2d.<tensor> each, its bytes counted
    by index_h2d_bytes and index_h2d_bytes.<tensor>)."""
    with spans.span("index.prep"):
        if planes is None:
            n_occ = idx.occ_txp.shape[0]
            n_oct = max((n_occ + 7) // 8, 1)
            occ_oct = np.zeros((n_oct * 8, 2), dtype=np.int32)
            occ_oct[:n_occ, 0] = idx.occ_txp
            occ_oct[:n_occ, 1] = idx.occ_pf
            planes = (idx.table.rows, occ_oct.reshape(n_oct, 16))
        total = int(idx.seq_offsets[-1])
        off_dtype = np.int64 if total + _SEQ4_SHIFT + 256 >= 2**31 \
            else np.int32
        host = {
            "tab_rows": planes[0].astype(np.int32, copy=False),
            "occ_oct": planes[1],
            "txp_lens": np.asarray(idx.lengths).astype(np.int32),
            "seq_off": np.asarray(idx.seq_offsets).astype(off_dtype),
            "seq4": seq4_words(idx).view(np.int32),
        }
    out = {}
    with spans.span("index.h2d"):
        for name, a in host.items():
            a = np.asarray(a)
            with spans.span(f"index.h2d.{name}"):
                out[name] = torch.tensor(a, device=device)
            spans.count("index_h2d_bytes", a.nbytes)
            spans.count(f"index_h2d_bytes.{name}", a.nbytes)
    return out


def _end_seeds(codes, lengths, dev: dict, cfg: MapperConfig):
    """Stages 1-2 for one read end: k-mer extraction + hash lookup."""
    km = extract_kmers(codes, lengths, cfg.k)
    if cfg.kmer_stride > 1:
        # seed-skip: query every stride-th window (reference altSkip)
        km = {k: v[:, ::cfg.kmer_stride] for k, v in km.items()}
    lk = hash_lookup(km["hi"], km["lo"], dev["tab_rows"], cfg.n_slots,
                     cfg.max_probes)
    return km, lk


def row_pool_env() -> int:
    """SALMON_TPU_ROWPOOL: the row pool's budget (0 = off)."""
    return int(os.environ.get("SALMON_TPU_ROWPOOL", "0") or 0)


def _dense_candidates(km, lk, dev: dict, cfg: MapperConfig):
    """Stage 3: dense (R, P*C) expansion + per-row sort scoring. With
    SALMON_TPU_ROWPOOL=N on an index with inlined single records, the
    first-row gather is pooled per read row (score.expand_occurrences
    row_pool), as in the JAX package."""
    row_pool = row_pool_env()
    key, rpos, diag, _, n_tail_over = expand_occurrences(
        km, lk, dev["occ_oct"], cfg.occ_cap, cfg.max_occs_per_hit,
        stride=cfg.kmer_stride,
        tail_frac=64 if (cfg.occ_aligned and cfg.occ_cap <= 8) else 8,
        row_pool=row_pool if cfg.inline_singles else 0)
    n_windows = lk[0].shape[1]
    # the window field must hold every window index
    window_bits = window_bits_for(n_windows)
    if window_bits > 12:
        raise ValueError(
            f"{n_windows} seed windows need window_bits={window_bits} "
            f"> 12, which would overflow the diagonal-bucket sort key; "
            f"raise kmer_stride or reduce max_read_len")
    cand = score_candidates(
        key, rpos, diag, cfg.max_cands, stride=cfg.kmer_stride,
        window_bits=window_bits,
        diag_bucket_bits=diag_bucket_bits_for(cfg.max_tpos, window_bits))
    cand["tail_over"] = n_tail_over
    return cand


def _seed_candidates(ends, lengths_per_end, dev: dict, cfg: MapperConfig):
    """Stages 1-3 for each read end -> [(cand, start), ...]."""
    seeded = [_end_seeds(codes, lengths, dev, cfg)
              for codes, lengths in zip(ends, lengths_per_end)]
    if cfg.sparse_seed:
        P = seeded[0][1][0].shape[1]
        cands = seed_candidates_sparse(
            seeded, dev["occ_oct"], occ_cap=cfg.occ_cap,
            max_occs_per_hit=cfg.max_occs_per_hit,
            hits_per_end=cfg.seed_hits_per_end, max_cands=cfg.max_cands,
            stride=cfg.kmer_stride,
            diag_bucket_bits=diag_bucket_bits_for(cfg.max_tpos,
                                                  window_bits_for(P)))
    else:
        cands = [_dense_candidates(km, lk, dev, cfg) for km, lk in seeded]
    return [(cand, candidate_read_start(cand, lengths, cfg.k))
            for cand, lengths in zip(cands, lengths_per_end)]


def _revcomp_flip(codes):
    """Reverse complement as a pure mirror: row content lands at columns
    [L - len, L); the DP reads it with read_starts = L - len."""
    flipped = torch.flip(codes, dims=[1])
    return torch.where(flipped < 4, 3 - flipped, 4).to(codes.dtype)


def _reads_all(codes_l, codes_r):
    """DP read rows by variant: 0 = l fw, 1 = l rc, 2 = r fw, 3 = r rc
    (rc variants are flip-based: content at rows [L-len, L), declared
    via read_starts); variant v of read r is row v * R + r."""
    return torch.cat([codes_l, _revcomp_flip(codes_l),
                      codes_r, _revcomp_flip(codes_r)], dim=0)


def _dp_scores(joined: dict, batch: dict, dev: dict, cfg: MapperConfig,
               single_end: bool = False):
    """Selective-alignment validation: banded affine DP score for the
    joined candidates (reference PuffAligner calculateAlignments,
    SalmonQuantify.cpp:1523-1525). A single-end batch (codes/lengths) is
    its own left end and has one mate per problem. Returns (score,
    perfect) of (R, T2)."""
    if single_end:
        codes_l, len_l = batch["codes"], batch["lengths"]
        codes_r, len_r = codes_l, len_l
    else:
        codes_l, len_l = batch["codes_l"], batch["lengths_l"]
        codes_r, len_r = batch["codes_r"], batch["lengths_r"]
    device = codes_l.device
    R, L = codes_l.shape
    T2 = joined["txp"].shape[1]
    reads_all = _reads_all(codes_l, codes_r)

    txp = joined["txp"]
    fw1 = joined["fw"]
    ms = joined["mate_status"]
    pos = joined["pos"]
    frag_end = pos + joined["frag_len"] - 1
    l1 = len_l[:, None]
    l2 = len_r[:, None]
    is_right_orphan = (ms == MS_RIGHT_ORPHAN)[:, None]
    is_paired = (ms == MS_PAIRED)[:, None] & (not single_end)

    m1_var = torch.where(is_right_orphan, torch.where(fw1, 2, 3),
                         torch.where(fw1, 0, 1))
    m1_pos = torch.where(is_paired,
                         torch.where(fw1, pos, frag_end - l1 + 1), pos)
    m1_len = torch.where(is_right_orphan, l2, l1).expand(R, T2)
    m2_var = torch.where(fw1, 3, 2)
    m2_pos = torch.where(fw1, frag_end - l2 + 1, pos)
    m2_len = l2.expand(R, T2)

    # alignment-cache shortcut (reference useAlignmentCache): a
    # candidate whose chain covers every seed window of its mapped mates
    # is a (near-)exact match and takes the perfect score without DP
    def n_windows(ln):
        return torch.clamp((ln - cfg.k) // cfg.kmer_stride + 1, min=0)

    nw1 = n_windows(len_l)[:, None]
    nw2 = n_windows(len_r)[:, None]
    full_thresh = torch.where(is_paired, nw1 + nw2,
                              torch.where(is_right_orphan, nw2, nw1))
    if cfg.alignment_cache:
        full_cov = joined["valid"] & (joined["score"] >= full_thresh)
    else:
        full_cov = torch.zeros_like(joined["valid"])

    # per-read DP budget: each read keeps its first `budget` needy slots
    # (slots are chain-score-ranked), K = R * budget problems per mate
    budget = (max(2, cfg.dp_budget // 2) if cfg.alignment_cache
              else cfg.dp_budget)
    K = min(R * budget, R * T2)
    need_2d = joined["valid"] & ~full_cov
    keep = (need_2d & (torch.cumsum(need_2d.to(torch.int32), dim=1)
                       <= budget)).reshape(-1)
    # kept slots first, each group in slot order
    sel = torch.argsort((~keep).to(torch.int8), stable=True)[:K]
    sel_valid = keep[sel]
    sel_read = sel // T2

    def mate_params(var, p, ln):
        lo = torch.where((var & 1) == 1, L - ln, 0)
        flat = lambda a: a.expand(R, T2).reshape(-1)[sel]
        return flat(var), flat(p - lo), flat(ln), flat(lo)

    # both mates ride ONE kernel call (concatenated problems); a
    # single-end batch has only the first
    mates = [mate_params(m1_var, m1_pos, m1_len)]
    if not single_end:
        mates.append(mate_params(m2_var, m2_pos, m2_len))
    var, p, n, lo = (torch.cat(a) for a in zip(*mates))
    t_sel = txp.reshape(-1)[sel].repeat(len(mates))
    toff = dev["seq_off"][t_sel.clamp(0, dev["seq_off"].shape[0] - 1)]
    tlen = dev["txp_lens"][t_sel.clamp(0, dev["txp_lens"].shape[0] - 1)]
    ids = (sel_read.repeat(len(mates)) + var * R).to(torch.int32)
    i32 = torch.int32
    scores = banded_scores_indexed(
        reads_all, ids, n.to(i32), p.to(i32), tlen, None, toff,
        cfg.dp_bandwidth, float(cfg.match_score),
        float(cfg.mismatch_penalty), float(cfg.gap_open_penalty),
        float(cfg.gap_extend_penalty), seq_words=dev["seq4"],
        seq_words_shift=_SEQ4_SHIFT, softclip=cfg.softclip,
        softclip_overhangs=cfg.softclip_overhangs, read_starts=lo.to(i32))
    scores = torch.where(sel_valid.repeat(len(mates)), scores, -1e9)

    perfect = torch.where(is_paired, cfg.match_score * (l1 + l2),
                          cfg.match_score * m1_len).to(torch.float32)
    perfect = perfect.expand(R, T2)
    # DP'd slots get their scores scattered in; full-coverage slots take
    # the perfect score
    s1 = torch.full((R * T2,), -1e9, dtype=torch.float32, device=device)
    s1[sel] = scores[:K]
    s1 = s1.reshape(R, T2)
    score = s1
    if not single_end:
        s2 = torch.full((R * T2,), -1e9, dtype=torch.float32,
                        device=device)
        s2[sel] = scores[K:]
        score = torch.where(is_paired, s1 + s2.reshape(R, T2), s1)
    score = torch.where(full_cov, perfect, score)
    return score, perfect


def rescue_probe_lengths(fld_logpmf, n_probes: int) -> torch.Tensor:
    """Fragment lengths at which the rescue probes an orphan's missing
    mate: the FLD's mean (one probe) or its (i + 0.5) / Q quantiles,
    the median first, then the others by distance from it. (Q,) int32.
    The quantiles come from a float32 running sum of the pmf, as in the
    JAX package, so they can differ from it by one position where a
    quantile lands within rounding of a CDF value."""
    pmf = torch.exp(fld_logpmf)
    if n_probes <= 1:
        lengths = torch.arange(pmf.shape[0], dtype=torch.float32,
                               device=pmf.device)
        return torch.round((pmf * lengths).sum()).to(torch.int32)[None]
    cdf = torch.cumsum(pmf, dim=0)
    qs = sorted([(i + 0.5) / n_probes for i in range(n_probes)],
                key=lambda q: abs(q - 0.5))
    return torch.searchsorted(cdf, torch.stack([q * cdf[-1] for q in qs]))\
        .to(torch.int32)


def _rescue_orphans(joined: dict, batch: dict, dev: dict, cfg: MapperConfig,
                    fld_logpmf, aln_score, perfect_score):
    """Orphan rescue (reference recoverOrphans ->
    selective_alignment::utils::recoverOrphans, consumed at
    SalmonQuantify.cpp:1356-1364, edlib-based).

    For each orphan fragment's best candidate, the missing mate is
    DP-aligned at the rescue_probe_lengths positions with the wider
    rescue band, where the reference searches the whole window with
    edlib. (orphan, probe) pairs are compacted into K = R/4 problems of
    one kernel launch, every orphan's median probe before any orphan's
    second probe. A rescued fragment becomes paired, with the rescue
    score added to its first hit. Returns (joined, aln_score,
    perfect_score, number rescued)."""
    codes_l, len_l = batch["codes_l"], batch["lengths_l"]
    codes_r, len_r = batch["codes_r"], batch["lengths_r"]
    device = codes_l.device
    R, L = codes_l.shape
    reads_all = _reads_all(codes_l, codes_r)

    ms = joined["mate_status"]
    txp0 = joined["txp"][:, 0]
    pos0 = joined["pos"][:, 0]
    fw0 = joined["fw"][:, 0]
    # reference gate: no rescue for reads mapping more than
    # maxRecoverReadOcc times (ProgramOptionsGenerator.cpp:493-497)
    n_occ = joined["valid"].sum(dim=1)
    cand_ok = (joined["valid"][:, 0] & (ms != MS_PAIRED)
               & (n_occ <= cfg.max_recover_read_occ))

    Q = max(1, int(cfg.rescue_probes))
    fl_probes = rescue_probe_lengths(fld_logpmf, Q)
    left_orph = ms == MS_LEFT_ORPHAN
    miss_len = torch.where(left_orph, len_r, len_l)
    mapped_len = torch.where(left_orph, len_l, len_r)
    # inward pairing: the missing mate has the other orientation
    var = torch.where(left_orph, torch.where(fw0, 3, 2),
                      torch.where(fw0, 1, 0))
    # (Q, R) predicted leftmost position of the missing mate
    fl = fl_probes[:, None]
    mate_left_q = torch.where(fw0, pos0 + fl - miss_len,
                              pos0 + mapped_len - fl).reshape(-1)

    K = max(1, R // 4)
    orph_idx = torch.arange(R, device=device).repeat(Q)      # (Q*R,)
    q_idx = torch.arange(Q, device=device).repeat_interleave(R)
    cand_tile = cand_ok.repeat(Q)
    prio = torch.where(cand_tile, q_idx * R + orph_idx, 0xFFFFFFFF)
    sel_flat = torch.argsort(prio, stable=True)[:K]
    sel = orph_idx[sel_flat]                                  # orphan row
    s_ok = cand_tile[sel_flat]
    s_txp = txp0[sel]
    toff = dev["seq_off"][s_txp.clamp(0, dev["seq_off"].shape[0] - 1)]
    tlen = dev["txp_lens"][s_txp.clamp(0, dev["txp_lens"].shape[0] - 1)]
    s_var = var[sel]
    s_len = miss_len[sel]
    s_lo = torch.where((s_var & 1) == 1, L - s_len, 0)
    ml_flat = mate_left_q[sel_flat]
    i32 = torch.int32
    scores = banded_scores_indexed(
        reads_all, (sel + s_var * R).to(i32), s_len.to(i32),
        (ml_flat - s_lo).to(i32), tlen, None, toff, cfg.rescue_bandwidth,
        float(cfg.match_score), float(cfg.mismatch_penalty),
        float(cfg.gap_open_penalty), float(cfg.gap_extend_penalty),
        seq_words=dev["seq4"], seq_words_shift=_SEQ4_SHIFT,
        softclip=cfg.softclip, softclip_overhangs=cfg.softclip_overhangs,
        read_starts=s_lo.to(i32))
    good = s_ok & (scores >= cfg.min_score_fraction * cfg.match_score
                   * s_len.to(torch.float32))
    # per orphan, the best of its probes wins; the winning probe's mate
    # position makes the pair
    resc = torch.zeros(R, dtype=i32, device=device).scatter_reduce_(
        0, sel, good.to(i32), "amax").to(torch.bool)
    resc_score = torch.zeros(R, dtype=torch.float32,
                             device=device).scatter_reduce_(
        0, sel, torch.where(good, scores, 0.0), "amax")
    is_win = good & (scores >= resc_score[sel])
    int_min = torch.iinfo(i32).min
    mate_left = torch.full((R,), int_min, dtype=i32,
                           device=device).scatter_reduce_(
        0, sel, torch.where(is_win, ml_flat, int_min).to(i32), "amax")
    mate_left = torch.where(resc, mate_left, 0)

    # column 0 carries the rescued pair
    s1, s2 = pos0, mate_left
    new_flen = torch.abs(torch.maximum(s1 + mapped_len, s2 + miss_len)
                         - torch.minimum(s1, s2))
    joined = dict(joined)
    joined["mate_status"] = torch.where(resc, MS_PAIRED, ms).to(ms.dtype)
    joined["frag_len"] = torch.where(resc[:, None], new_flen[:, None],
                                     joined["frag_len"]).to(
                                         joined["frag_len"].dtype)

    def set_col0(a, v):
        a = a.clone()
        a[:, 0] = torch.where(resc, v, a[:, 0]).to(a.dtype)
        return a

    joined["obs_code"] = set_col0(joined["obs_code"],
                                  observed_paired_code(s1, fw0, s2, ~fw0))
    joined["pos"] = set_col0(joined["pos"], torch.minimum(s1, s2))
    if aln_score is not None:
        aln_score = set_col0(aln_score,
                             aln_score[:, 0] + torch.where(resc, resc_score,
                                                           0.0))
        perfect_score = torch.where(
            resc[:, None],
            (cfg.match_score * (len_l + len_r)[:, None]).to(torch.float32),
            perfect_score)
    return joined, aln_score, perfect_score, resc.sum(dtype=i32)


def _fld_inputs(fld):
    """(logpmf, logcmf, mode) from a dict with those keys, or from a bare
    (M+1,) log-pmf, whose log-CMF is derived here (mode 1). mode: 0 =
    ignore the FLD, 1 = unconditional pmf, 2 = pmf conditioned on the
    transcript length (burned in; reference SalmonQuantify.cpp:661-668)."""
    if isinstance(fld, dict):
        return fld["logpmf"], fld["logcmf"], fld["mode"]
    logcmf = torch.log(torch.clamp(torch.cumsum(torch.exp(fld), 0),
                                   min=1e-30))
    return fld, logcmf, 1


def _filter_and_weight(joined: dict, fld, compat_paired,
                       compat_orphan, cfg: MapperConfig, aln_score=None,
                       perfect_score=None, tlen=None, rlen_mapped=None,
                       single_end: bool = False):
    """Stages 5-6: decoy-aware filtering and aux-probability weights.

    joined: dict of (R, W) hits plus (R,) mate_status. fld: see
    _fld_inputs.
    compat_paired: (6,) bool; compat_orphan: (2, 2) bool. A single-end
    batch has no pairs: its hits take the ambiguous-length probability
    of orphans (0 where the FLD is not modelled).
    Returns (eq_txp, eq_weight, frag_ok, aln_valid, wn, eq_bins, extras).
    """
    txp = joined["txp"]
    score = joined["score"]
    valid = joined["valid"]
    valid_pre = valid
    ms = joined["mate_status"]
    NEG = -1e30

    if aln_score is not None:
        # DP-validated score + minScoreFraction gate (reference
        # filterAndCollectAlignments, SalmonMappingUtils.hpp:283-405)
        s = aln_score
        valid = valid & (s >= cfg.min_score_fraction * perfect_score)
    else:
        # coverage score scaled by the per-base match bonus
        s = score.to(torch.float32) * float(cfg.match_score)
    is_decoy = valid & (txp >= cfg.first_decoy_index)
    real = valid & ~is_decoy
    best_real = torch.where(real, s, NEG).amax(dim=1, keepdim=True)
    best_decoy = torch.where(is_decoy, s, NEG).amax(dim=1, keepdim=True)

    # decoy soft filter: keep real hits >= decoyThreshold * bestDecoy
    decoy_thresh = torch.where(best_decoy > NEG / 2,
                               cfg.decoy_threshold * best_decoy, NEG)
    keep = real & (s >= decoy_thresh)
    # estAlnProb = exp(-scoreExp * (best - score)); drop < minAlnProb
    aln_logprob = -cfg.score_exp * (best_real - s)
    keep = keep & (aln_logprob >= math.log(cfg.min_aln_prob))
    if cfg.hard_filter:
        keep = keep & (s >= best_real)
    # consensus fraction on coverage scores
    keep = keep & (score.to(torch.float32)
                   >= cfg.consensus_fraction
                   * torch.where(real, score, 0).amax(
                       dim=1, keepdim=True).to(torch.float32))

    # --- aux probabilities (processMiniBatch, SalmonQuantify.cpp:599-803)
    logpmf, logcmf, fld_mode = _fld_inputs(fld)
    M = cfg.fld_max
    n_tab = logpmf.shape[0]
    flen = joined["frag_len"].clamp(0, M)
    is_pair_row = (ms[:, None] == MS_PAIRED) & (not single_end)
    if cfg.no_frag_length_dist:
        # --noFragLengthDist: pairs and single-end hits get LOG_1;
        # orphans a fixed penalty
        log_flen_prob = torch.where(is_pair_row | single_end, 0.0,
                                    LOG_EPSILON)
    else:
        tl = tlen.clamp(min=0)
        logcmf_t = logcmf[tl.clamp(max=M).clamp(max=n_tab - 1)]
        cmf_ok = logcmf_t > LOG_EPSILON
        if cfg.model_single_frag_prob:
            # ambiguous-length prob for orphan hits
            # (LogCMFCache::getAmbigFragLengthProb): mass of fragments no
            # longer than the room left in the virtual mate's direction
            pos = joined["pos"]
            rl = rlen_mapped[:, None]
            maxfl = torch.where(joined["fw"], tl - torch.minimum(
                pos.clamp(min=0), tl), torch.minimum((pos + rl).clamp(
                    min=0), tl))
            idx_main = torch.where(is_pair_row, flen, maxfl.clamp(0, M))
        else:
            idx_main = flen
        idx_main = idx_main.clamp(0, n_tab - 1)
        lenprob = logpmf[idx_main]
        # paired pmf, conditioned on txp length once burned in
        cond_ok = cmf_ok & (joined["frag_len"] < tl)
        if fld_mode >= 2:
            paired_prob = torch.where(cond_ok, lenprob - logcmf_t,
                                      LOG_EPSILON)
        elif fld_mode == 1:
            paired_prob = lenprob
        else:
            paired_prob = torch.zeros_like(lenprob)
        if cfg.model_single_frag_prob:
            ambig = torch.where(cmf_ok, logcmf[idx_main] - logcmf_t,
                                LOG_EPSILON)
        else:
            ambig = torch.full_like(lenprob,
                                    0.0 if single_end else LOG_EPSILON)
        log_flen_prob = torch.where(is_pair_row, paired_prob, ambig)

    # library-format compatibility
    obs = joined["obs_code"]
    paired_compat = compat_paired[obs.clamp(0, 5)] & (obs >= 0)
    orph_left = (ms == MS_LEFT_ORPHAN)[:, None]
    fwc = joined["fw"]
    orph_compat = compat_orphan[(~orph_left).to(torch.int64),
                                (~fwc).to(torch.int64)]
    compat = torch.where(ms[:, None] == MS_PAIRED, paired_compat,
                         orph_compat)
    log_compat = torch.where(
        compat, 0.0,
        math.log(cfg.incompat_prior) if cfg.incompat_prior > 0 else NEG)

    logw = aln_logprob + log_flen_prob + log_compat
    keep = keep & (logw > NEG / 2)
    # re-normalize per fragment for numerical sanity
    logw_max = torch.where(keep, logw, NEG).amax(dim=1, keepdim=True)
    w = torch.where(keep, torch.exp(
        logw - torch.where(logw_max > NEG / 2, logw_max, 0.0)), 0.0)

    # --- collapse per transcript (sum weights of hits to one txp)
    txp_key = torch.where(keep, txp, INVALID_TXP)
    txp_s, w_s = _sort_rows(txp_key, w)
    R = txp_s.shape[0]
    col = torch.full((R, 1), INVALID_TXP, dtype=txp_s.dtype,
                     device=txp_s.device)
    prev = torch.cat([torch.full_like(col, -1), txp_s[:, :-1]], dim=1)
    nxt = torch.cat([txp_s[:, 1:], col], dim=1)
    v = txp_s != INVALID_TXP
    rs = v & (txp_s != prev)
    re = v & (txp_s != nxt)
    cw = torch.cumsum(w_s, dim=1)
    run_w = cw - segment_carry_first(cw, rs) + segment_carry_first(w_s, rs)
    eq_txp = torch.where(re, txp_s, INVALID_TXP)
    eq_w = torch.where(re, run_w, 0.0)
    # compact labels to the left, ascending txp
    eq_txp, eq_w = _sort_rows(eq_txp, eq_w)
    aln_valid = eq_txp != INVALID_TXP
    frag_ok = aln_valid.any(dim=1)

    # normalized per-fragment posteriors + range-factorization bins
    # (reference SalmonQuantify.cpp:845-853)
    wsum = eq_w.sum(dim=1, keepdim=True)
    wn = torch.where(wsum > 0, eq_w / wsum.clamp(min=1e-30), 0.0)
    n_valid = aln_valid.sum(dim=1, keepdim=True).to(torch.float32)
    range_count = torch.sqrt(n_valid) + float(cfg.range_bins)
    eq_bins = torch.where(aln_valid & (cfg.range_bins > 0),
                          (wn * range_count).to(torch.int32), -1)
    extras = {
        "decoy_frag": is_decoy.any(dim=1)
        & (best_decoy > torch.clamp(best_real, min=NEG / 2))[:, 0],
        "below_thresh": (valid_pre & ~valid
                         & (txp < cfg.first_decoy_index)).sum(
                             dim=1, dtype=torch.int32),
        "had_pre": valid_pre.any(dim=1),
    }
    return eq_txp, eq_w, frag_ok, aln_valid, wn, eq_bins, extras


def _weigh_and_emit(joined: dict, aln_score, perfect, real_row, dev: dict,
                    cfg: MapperConfig, fld, compat_paired, compat_orphan,
                    rlen_mapped, single_end: bool = False) -> dict:
    """Stages 5-6 on the top weight_width joined hits, padding rows
    dropped: the eq-class tensors, the online per-transcript mass (EM
    initialization) and the counters both read layouts share."""
    W = min(cfg.weight_width, joined["txp"].shape[1])
    joined_w = {k: (v[:, :W] if v.dim() == 2 else v)
                for k, v in joined.items()}
    n_t = dev["txp_lens"].shape[0]
    tlen = dev["txp_lens"][joined_w["txp"].clamp(
        0, min(cfg.num_txps, n_t) - 1)]
    eq_txp, eq_w, frag_ok, aln_valid, wn, eq_bins, fextras = \
        _filter_and_weight(
            joined_w, fld, compat_paired, compat_orphan, cfg,
            aln_score=None if aln_score is None else aln_score[:, :W],
            perfect_score=None if perfect is None else perfect[:, :W],
            tlen=tlen, rlen_mapped=rlen_mapped, single_end=single_end)
    frag_ok = frag_ok & real_row
    aln_valid = aln_valid & real_row[:, None]
    eq_txp = torch.where(aln_valid, eq_txp, INVALID_TXP)
    txp_mass = torch.zeros(cfg.num_txps, dtype=torch.float32,
                           device=eq_w.device).index_add_(
        0, eq_txp.clamp(0, cfg.num_txps - 1).reshape(-1).to(torch.int64),
        torch.where(aln_valid, wn, 0.0).reshape(-1))
    i32 = torch.int32
    return {
        "eq_txp": eq_txp,
        "eq_weight": torch.where(aln_valid, eq_w, 0.0),
        "eq_bins": torch.where(aln_valid, eq_bins, -1),
        "frag_ok": frag_ok,
        "txp_mass": txp_mass,
        "num_processed": real_row.sum(dtype=i32),
        "num_mapped": frag_ok.sum(dtype=i32),
        "num_decoy_fragments": (fextras["decoy_frag"] & real_row).sum(
            dtype=i32),
        "num_frags_filtered_vm": (
            fextras["had_pre"] & ~frag_ok & ~fextras["decoy_frag"]
            & real_row).sum(dtype=i32),
        "num_alns_below_threshold": torch.where(
            frag_ok, fextras["below_thresh"], 0).sum(dtype=i32),
    }


def map_paired_batch_impl(batch: dict, dev: dict, cfg: MapperConfig,
                          fld: dict, compat_paired, compat_orphan) -> dict:
    """Map one paired-end batch end to end, eagerly.

    batch: codes_l/codes_r (R, L) uint8 and lengths_l/lengths_r (R,)
    int32, on the device of `dev`. fld: see _filter_and_weight.
    Returns a dict of eq-class tensors, FLD histogram contribution and
    counters (all fixed-shape).
    """
    cands = _seed_candidates(
        [batch["codes_l"], batch["codes_r"]],
        [batch["lengths_l"], batch["lengths_r"]], dev, cfg)
    return map_paired_from_cands(cands, batch, dev, cfg, fld,
                                 compat_paired, compat_orphan)


def map_paired_from_cands(cands, batch: dict, dev: dict, cfg: MapperConfig,
                          fld: dict, compat_paired, compat_orphan) -> dict:
    """Stages 4-6 of the paired pipeline from scored seed candidates."""
    (cand_l, start_l), (cand_r, start_r) = cands
    len_l, len_r = batch["lengths_l"], batch["lengths_r"]
    zero = torch.zeros((), dtype=torch.int32, device=len_l.device)
    # the sparse flow has no tail budget
    seed_tail_over = cand_l.pop("tail_over", zero) + cand_r.pop(
        "tail_over", zero)

    paired = join_pairs(cand_l, cand_r, start_l, start_r, len_l, len_r,
                        cfg.max_pair_cands, cfg.fld_max, cfg.allow_dovetail)
    orph_l = orphan_hits(cand_l, start_l, MS_LEFT_ORPHAN, cfg.max_pair_cands)
    orph_r = orphan_hits(cand_r, start_r, MS_RIGHT_ORPHAN,
                         cfg.max_pair_cands)
    joined = merge_paired_with_orphans(paired, orph_l, orph_r,
                                       cfg.discard_orphans)

    aln_score = perfect = None
    n_rescued = torch.zeros((), dtype=torch.int32, device=len_l.device)
    if cfg.validate_mappings:
        aln_score, perfect = _dp_scores(joined, batch, dev, cfg)
        if cfg.recover_orphans:
            joined, aln_score, perfect, n_rescued = _rescue_orphans(
                joined, batch, dev, cfg, _fld_inputs(fld)[0], aln_score,
                perfect)

    real_row = len_l > 0  # padding rows never count
    left_orph = joined["mate_status"] == MS_LEFT_ORPHAN
    out = _weigh_and_emit(joined, aln_score, perfect, real_row, dev, cfg,
                          fld, compat_paired, compat_orphan,
                          torch.where(left_orph, len_l, len_r))
    frag_ok = out["frag_ok"]
    device = frag_ok.device

    # FLD observation: the best paired hit's fragment length
    is_paired = (joined["mate_status"] == MS_PAIRED) & frag_ok
    best_i = torch.argmax(joined["score"], dim=1, keepdim=True)

    def take_best(a):
        return torch.gather(a, 1, best_i)[:, 0]

    best_flen = take_best(joined["frag_len"])
    fld_hist = torch.zeros(cfg.fld_max + 1, dtype=torch.float32,
                           device=device).index_add_(
        0, best_flen.clamp(0, cfg.fld_max).to(torch.int64),
        is_paired.to(torch.float32))

    # observed library-format counts over fragments with a concordant
    # mapping, before the compat filter
    obs_best = take_best(joined["obs_code"])
    is_paired_obs = ((joined["mate_status"] == MS_PAIRED)
                     & joined["valid"][:, 0] & real_row)
    fmt_hist = torch.zeros(6, dtype=torch.int32, device=device).index_add_(
        0, obs_best.clamp(0, 5).to(torch.int64),
        is_paired_obs.to(torch.int32))

    i32 = torch.int32
    out.update({
        "num_orphans_rescued": n_rescued,
        "best_txp": take_best(joined["txp"]),
        "best_pos": take_best(joined["pos"]),
        "best_flen": best_flen,
        "best_fw": take_best(joined["fw"]),
        "best_is_paired": is_paired,
        "num_paired": is_paired.sum(dtype=i32),
        "num_orphans": (frag_ok & (joined["mate_status"] != MS_PAIRED)).sum(
            dtype=i32),
        "num_dovetail_fragments": (
            paired["has_dovetail_only"] & ~frag_ok & real_row).sum(
                dtype=i32),
        "seed_tail_over": seed_tail_over,
        "fld_hist": fld_hist,
        "fmt_hist": fmt_hist,
    })
    if cfg.write_orphan_links:
        # orphaned mappings of both ends of fragments without a
        # concordant pair (--writeOrphanLinks; the host formats the
        # `txp,pos\t...:txp,pos\t...` lines)
        out.update({
            "orph_link_row": ~paired["has_pair"] & real_row,
            "orphl_txp": torch.where(orph_l["valid"], orph_l["txp"], -1),
            "orphl_pos": orph_l["pos"],
            "orphr_txp": torch.where(orph_r["valid"], orph_r["txp"], -1),
            "orphr_pos": orph_r["pos"],
        })
    return out


def map_single_batch_impl(batch: dict, dev: dict, cfg: MapperConfig, fld,
                          compat_single) -> dict:
    """Map one single-end batch end to end, eagerly (reference:
    processReads, single-end overload, SalmonQuantify.cpp:1881-2325).

    batch: codes (R, L) uint8 and lengths (R,) int32 on the device of
    `dev`. compat_single: (2,) bool over observed (fw, rc) hits.
    Returns the eq-class tensors, counters and histograms of
    map_paired_batch without its best-hit keys; fld_hist is all zero (a
    single read observes no fragment length) and fmt_hist counts SF (0)
    and SR (1) hits.
    """
    cands = _seed_candidates([batch["codes"]], [batch["lengths"]], dev, cfg)
    return map_single_from_cands(cands, batch, dev, cfg, fld, compat_single)


def map_single_from_cands(cands, batch: dict, dev: dict, cfg: MapperConfig,
                          fld, compat_single) -> dict:
    """Single-end stages 4-6 from scored seed candidates: each read's
    candidates become its hits, held as paired-status hits whose
    observed code is 0 (fw) or 1 (rc) against a 6-wide table padded with
    False."""
    [(cand, start)] = cands
    lengths = batch["lengths"]
    R = lengths.shape[0]
    device = lengths.device
    seed_tail_over = cand.pop("tail_over", torch.zeros(
        (), dtype=torch.int32, device=device))
    joined = orphan_hits(cand, start, MS_PAIRED, cfg.max_pair_cands)
    joined["mate_status"] = torch.full((R,), MS_PAIRED, dtype=torch.int32,
                                       device=device)
    joined["obs_code"] = torch.where(joined["fw"], 0, 1).to(torch.int32)
    compat6 = torch.cat([compat_single.to(torch.bool),
                         torch.zeros(4, dtype=torch.bool, device=device)])

    aln_score = perfect = None
    if cfg.validate_mappings:
        aln_score, perfect = _dp_scores(joined, batch, dev, cfg,
                                        single_end=True)
    out = _weigh_and_emit(
        joined, aln_score, perfect, lengths > 0, dev, cfg, fld, compat6,
        torch.ones((2, 2), dtype=torch.bool, device=device), lengths,
        single_end=True)

    # observed strand of each mapped read's best hit (SF = 0, SR = 1)
    best_i = torch.argmax(joined["score"], dim=1, keepdim=True)
    fw_best = torch.gather(joined["fw"], 1, best_i)[:, 0]
    fmt_hist = torch.zeros(6, dtype=torch.int32, device=device).index_add_(
        0, torch.where(fw_best, 0, 1), out["frag_ok"].to(torch.int32))

    zero = torch.zeros((), dtype=torch.int32, device=device)
    out.update({
        "num_paired": zero,
        "num_orphans": zero,
        "num_orphans_rescued": zero,
        "num_dovetail_fragments": zero,
        "seed_tail_over": seed_tail_over,
        "fld_hist": torch.zeros(cfg.fld_max + 1, dtype=torch.float32,
                                device=device),
        "fmt_hist": fmt_hist,
    })
    return out


# ---------------------------------------------------------------------------
# The compiled step: the counterpart of the JAX package's
# jax.jit(map_paired_batch_impl / map_single_batch_impl, static cfg).
# CUDA tensors go through one captured CUDA graph per batch signature
# (utils.graphcache); CPU tensors run the eager step, the plain version.

# one cache per index on the card, dropped with the index's tensors
_GRAPHS = WeakIdKeyDictionary()


def graph_cache(dev: dict) -> GraphCache:
    """The graph cache of the index tensors `dev` (made at first use)."""
    cache = _GRAPHS.get(dev["tab_rows"])
    if cache is None:
        cache = _GRAPHS[dev["tab_rows"]] = GraphCache([BANDED_DP])
    return cache


def graph_stats(dev: dict) -> list:
    """The graph cache's SignatureStats of `dev`, one per signature
    (none where no step of `dev` ran on the card)."""
    cache = _GRAPHS.get(dev["tab_rows"])
    return list(cache.stats.values()) if cache is not None else []


def _fld_parts(fld) -> tuple:
    """(mode, tensors) of the step's FLD input: a dict's mode and
    (logpmf, logcmf), or None and the bare log-pmf (see _fld_inputs)."""
    if isinstance(fld, dict):
        return fld["mode"], [fld["logpmf"], fld["logcmf"]]
    return None, [fld]


def step_signature(kind: str, batch: dict, dev: dict, cfg: MapperConfig,
                   fld, compat) -> tuple:
    """Everything the step reads as a Python value, so that a graph is
    replayed only on inputs it was captured for: the batch's, FLD's and
    compat tables' shapes and dtypes, the index tensors' addresses and
    shapes (the graph reads them in place), the frozen config, the FLD
    mode (None for a bare log-pmf) and SALMON_TPU_ROWPOOL."""
    mode, fld_t = _fld_parts(fld)
    return (kind,
            tuple((k, tensor_signature(batch[k])) for k in sorted(batch)),
            tuple(tensor_signature(t) for t in fld_t),
            tuple(tensor_signature(t) for t in compat),
            tuple((k, v.data_ptr(), tensor_signature(v))
                  for k, v in sorted(dev.items())),
            cfg, mode, row_pool_env())


def _graphed(kind: str, impl, batch: dict, dev: dict, cfg: MapperConfig,
             fld, compat: tuple, in_flight: int) -> dict:
    key = step_signature(kind, batch, dev, cfg, fld, compat)
    names = sorted(batch)
    mode, fld_t = _fld_parts(fld)
    nb, nf = len(names), len(fld_t)

    def step(ts):
        f = ({"logpmf": ts[nb], "logcmf": ts[nb + 1], "mode": mode}
             if mode is not None else ts[nb])
        return impl(dict(zip(names, ts[:nb])), dev, cfg, f, *ts[nb + nf:])

    R, L = batch[names[0]].shape
    return graph_cache(dev).run(
        key, step, [batch[k] for k in names] + fld_t + list(compat),
        ring=in_flight + 1, label=f"{kind} R={R} L={L} fld_mode={mode}")


def map_paired_batch(batch: dict, dev: dict, cfg: MapperConfig, fld: dict,
                     compat_paired, compat_orphan, *,
                     in_flight: int = 1) -> dict:
    """map_paired_batch_impl, compiled: on CUDA tensors through one CUDA
    graph per step_signature (the first batch of a signature runs
    eagerly, the second captures, every later one replays), on CPU
    tensors the eager step itself. On the card the outputs of the
    `in_flight` calls of the same signature before this one stay
    readable; older ones are overwritten."""
    if not batch["codes_l"].is_cuda:
        return map_paired_batch_impl(batch, dev, cfg, fld, compat_paired,
                                     compat_orphan)
    return _graphed("paired", map_paired_batch_impl, batch, dev, cfg, fld,
                    (compat_paired, compat_orphan), in_flight)


def map_single_batch(batch: dict, dev: dict, cfg: MapperConfig, fld,
                     compat_single, *, in_flight: int = 1) -> dict:
    """map_single_batch_impl, compiled as map_paired_batch is."""
    if not batch["codes"].is_cuda:
        return map_single_batch_impl(batch, dev, cfg, fld, compat_single)
    return _graphed("single", map_single_batch_impl, batch, dev, cfg, fld,
                    (compat_single,), in_flight)
