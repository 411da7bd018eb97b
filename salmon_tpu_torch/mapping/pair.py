"""Mate pairing and library-format compatibility.

Counterpart of salmon_tpu/mapping/pair.py (pufferfish joinReadsAndFilter,
consumed at src/quant/SalmonQuantify.cpp:1339-1341, plus the observed
format of SalmonUtils.cpp:531-576 hitType): a sort-merge join over both
ends' candidates, reduced to the top T2 joined hits per fragment.

Orphan semantics follow the reference: orphaned ends are only considered
for a fragment when it has no concordant mapping at all
(SalmonQuantify.cpp:1344-1420). Sorts are stable (see mapping.score).
"""

from __future__ import annotations

import torch

from salmon_tpu_torch.mapping.score import _sort_rows
from salmon_tpu_torch.utils.u32 import MASK32

# mate-status codes for joined hits
MS_PAIRED = 0
MS_LEFT_ORPHAN = 1
MS_RIGHT_ORPHAN = 2

# observed paired orientation codes (must match utils.libformat OBS_*)
OBS_ISF, OBS_OSF, OBS_ISR, OBS_OSR, OBS_MSF, OBS_MSR = range(6)

BIG = 0xFFFFFFFF


def observed_paired_code(s1, fw1, s2, fw2):
    """Observed library-format code (reference hitType,
    SalmonUtils.cpp:531-576), int32."""
    opp = fw1 != fw2
    code = torch.where(
        opp & fw1, torch.where(s1 <= s2, OBS_ISF, OBS_OSF),
        torch.where(opp, torch.where(s2 <= s1, OBS_ISR, OBS_OSR),
                    torch.where(fw1, OBS_MSF, OBS_MSR)))
    return code.to(torch.int32)


def _fit(a: torch.Tensor, T2: int, fill=0):
    """First T2 columns, padded with `fill` when the input is narrower."""
    if a.shape[1] >= T2:
        return a[:, :T2]
    pad = torch.full((a.shape[0], T2 - a.shape[1]), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad], dim=1)


def _next(a: torch.Tensor, fill):
    """Each row shifted left by one, `fill` entering at the end."""
    pad = torch.full((a.shape[0], 1), fill, dtype=a.dtype, device=a.device)
    return torch.cat([a[:, 1:], pad], dim=1)


def join_pairs(cand_l: dict, cand_r: dict, start_l, start_r,
               len_l, len_r, max_pair_cands: int, fld_max: int,
               allow_dovetail: bool = False, with_cut: bool = False):
    """Join left/right candidate sets into fragment-level hits.

    Every candidate is keyed by (txp, normalized orientation, side) so
    that opposite-strand mates forming a fragment sort adjacent, left
    first; one sort + adjacency test replaces the T x T outer product.
    Same-orientation pairings are not formed.

    Args:
      cand_l/cand_r: dicts from score_candidates, each (R, T).
      start_l/start_r: (R, T) inferred read-start positions on the txp.
      len_l/len_r: (R,) read lengths.
      max_pair_cands: T2 hits kept per fragment.
      fld_max: maximum plausible fragment length.

    Returns dict of (R, T2): txp, score, frag_len, pos (fragment
    leftmost), obs_code, fw, valid, plus (R,) has_pair and
    has_dovetail_only; with `with_cut` also cut (R,), the rows that
    formed more than T2 pairs.
    """
    def keyed(cand, start, is_left):
        o = cand["is_fw"].to(torch.int64)
        if not is_left:
            o = 1 - o
        key = (((((cand["txp"].to(torch.int64) & MASK32) << 1) | o) << 1)
               & MASK32) | (0 if is_left else 1)
        key = torch.where(cand["valid"], key, BIG)
        return key, cand["score"], start, cand["is_fw"].to(torch.int32)

    kl = keyed(cand_l, start_l, True)
    kr = keyed(cand_r, start_r, False)
    key, score, start, isfw = (torch.cat([a, b], dim=1)
                               for a, b in zip(kl, kr))
    key_s, score_s, start_s, isfw_s = _sort_rows(key, score, start, isfw)

    # slot i is a pair iff the next slot has the same high bits and
    # this slot is the left (even) tag
    nkey = _next(key_s, BIG)
    is_pair = (((key_s | 1) == (nkey | 1)) & ((key_s & 1) == 0)
               & ((nkey & 1) == 1) & (key_s != BIG) & (nkey != BIG))

    s1 = start_s
    s2 = _next(start_s, 0)
    fw1 = isfw_s.to(torch.bool)
    fw2 = _next(isfw_s, 0).to(torch.bool)
    e1 = s1 + len_l[:, None]
    e2 = s2 + len_r[:, None]
    frag_start = torch.minimum(s1, s2)
    frag_len = torch.maximum(e1, e2) - frag_start

    # dovetail: a mate starts before its partner in an inward pair
    # (reference MappingConstraintPolicy.noDovetail, default true)
    dovetail = torch.where(fw1 & ~fw2, s2 < s1, (fw2 & ~fw1) & (s1 < s2))
    geom_ok = (frag_len > 0) & (frag_len <= fld_max)
    if not allow_dovetail:
        geom_ok = geom_ok & ~dovetail

    ok = is_pair & geom_ok
    obs = observed_paired_code(s1, fw1, s2, fw2)
    pair_score = torch.where(ok, score_s + _next(score_s, 0), 0)

    dove_rej = (is_pair & dovetail & (frag_len > 0) & (frag_len <= fld_max)
                & ~ok)
    has_dovetail_only = dove_rej.any(dim=1) & ~ok.any(dim=1)

    T2 = max_pair_cands
    _, t_score, t_key, t_flen, t_pos, t_obs, t_fw = _sort_rows(
        -pair_score, pair_score, key_s, frag_len, frag_start, obs,
        fw1.to(torch.int32))
    valid_out = t_score[:, :T2] > 0
    out = {
        "txp": _fit((t_key >> 2).to(torch.int32), T2),
        "score": _fit(t_score, T2),
        "frag_len": _fit(t_flen, T2),
        "pos": _fit(t_pos, T2),
        "obs_code": _fit(t_obs, T2),
        "fw": _fit(t_fw, T2).to(torch.bool),
        "valid": _fit(valid_out, T2),
        "has_pair": valid_out.any(dim=1),
        "has_dovetail_only": has_dovetail_only,
    }
    if with_cut:
        out["cut"] = ok.sum(dim=1) > T2
    return out


def orphan_hits(cand: dict, start, mate_status: int, max_pair_cands: int):
    """Format one end's candidates as orphan fragment hits (used when the
    fragment has no concordant pair)."""
    T2 = max_pair_cands
    s = torch.where(cand["valid"], cand["score"], 0)
    _, score, txp, pos, fw = _sort_rows(
        -s, s, cand["txp"], start, cand["is_fw"].to(torch.int32))
    score = _fit(score, T2)
    return {
        "txp": _fit(txp, T2),
        "score": score,
        "frag_len": torch.zeros_like(score),
        "pos": _fit(pos, T2),
        "obs_code": torch.full_like(score, -1),
        "fw": _fit(fw, T2).to(torch.bool),
        "valid": score > 0,
        "mate_status": mate_status,
    }


_JOINED_KEYS = ("txp", "score", "frag_len", "pos", "obs_code", "fw",
                "valid")


def merge_paired_with_orphans(paired: dict, orph_l: dict, orph_r: dict,
                              discard_orphans: bool):
    """Fragment-level selection: paired hits when any exist, else the
    better orphan set (reference MergeResult semantics).

    Returns joined dict of (R, T2) plus mate_status (R,) int32.
    """
    has_pair = paired["has_pair"]
    l_best = torch.where(orph_l["valid"], orph_l["score"], 0).amax(dim=1)
    r_best = torch.where(orph_r["valid"], orph_r["score"], 0).amax(dim=1)
    use_left = l_best >= r_best
    if discard_orphans:
        sel_orph = {k: torch.zeros_like(orph_l[k]) for k in _JOINED_KEYS}
        ms_orph = torch.zeros_like(l_best)
    else:
        sel_orph = {k: torch.where(use_left[:, None], orph_l[k], orph_r[k])
                    for k in _JOINED_KEYS}
        ms_orph = torch.where(use_left, MS_LEFT_ORPHAN, MS_RIGHT_ORPHAN)
    out = {k: torch.where(has_pair[:, None], paired[k], sel_orph[k])
           for k in _JOINED_KEYS}
    out["mate_status"] = torch.where(has_pair, MS_PAIRED,
                                     ms_orph).to(torch.int32)
    return out
