"""Batch-global sparse seed flow: a compacted hit list and 1-D sorts.

Counterpart of salmon_tpu/mapping/seed_sparse.py (pufferfish
MemCollector hit projection + MemChainer co-linear chaining, consumed at
src/quant/SalmonQuantify.cpp:1266-1288). Where the dense path
(mapping.score) materializes every (window, occurrence) slot as an
(R, P*C) tensor and sorts each read's row, this flow is sized by a
fixed hit budget H = (#ends) * R * B:

  1. ragged expansion by scatter + carry: each usable window's
     occurrence range is written once as a header row at its exclusive-
     cumsum destination; a segment-carry scan along dim 0 fills every
     slot of H with its governing header, and c = slot - dest recovers
     the occurrence offset;
  2. one oct-row gather fetches each hit's (txp, pos<<1|fwd) record;
  3. one global sort by (read end, candidate key, diagonal bucket |
     window) groups co-linear runs, and flat segmented scans score them
     (distinct supporting windows per diagonal band, as in the dense
     path);
  4. one global sort by (read end, descending score, key, min_diag)
     ranks candidates per read end; a row scatter emits the per-end
     top-T candidate dicts that mapping.pair takes unchanged.

Every read end gets the same hit budget B (`seed_hits_per_end`); within
an end, earlier windows win, and each window is still capped at
`occ_cap` occurrences with the `max_occs_per_hit` repetitive-seed skip.

torch.sort takes one key, so each multi-key sort of the JAX package
(jax.lax.sort with num_keys > 1) is a chain of stable sorts, least
significant key first (`_lexsort`). Every order-sensitive reduction
here is keyed fully, so the candidates equal the JAX package's element
for element. u32 values follow salmon_tpu_torch.utils.u32.
"""

from __future__ import annotations

import numpy as np
import torch

from salmon_tpu_torch.mapping.lookup import fingerprint30
from salmon_tpu_torch.mapping.score import (DIAG_OFFSET, INVALID_KEY,
                                            _segmented_min, gather_occ_oct,
                                            segment_carry_first,
                                            window_bits_for)
from salmon_tpu_torch.utils.u32 import MASK32


def _ceil_log2(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """Indices that sort stably by keys[0], then keys[1], ... (1-D)."""
    order = torch.argsort(keys[-1], stable=True)
    for k in keys[-2::-1]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _prev(a: torch.Tensor, fill: int) -> torch.Tensor:
    return torch.cat([a.new_full((1,), fill), a[:-1]])


def _next(a: torch.Tensor, fill: int) -> torch.Tensor:
    return torch.cat([a[1:], a.new_full((1,), fill)])


def seed_candidates_sparse(ends, occ_oct: torch.Tensor, *, occ_cap: int,
                           max_occs_per_hit: int, hits_per_end: int,
                           max_cands: int, stride: int = 1,
                           diag_bucket_bits: int = 5):
    """Score seed candidates for one or two read ends in one global flow.

    ends: list of (km, lookup) per read end, km from extract_kmers
    (already strided) and lookup hash_lookup's (start, count, found, inl,
    itxp, ipf), all (R, P). occ_oct: (n_oct, 16) int32 oct-packed
    occurrence matrix. occ_cap: occurrences gathered per window;
    hits_per_end: B, the hit budget per read end; max_cands: T,
    candidates kept per read end.

    Returns one candidate dict (txp, is_fw, score, min_diag, valid),
    each (R, T), per end: the contract of score.score_candidates."""
    R, P = ends[0][1][0].shape
    hits = collect_hits_sparse(
        ends, occ_oct, occ_cap=occ_cap, max_occs_per_hit=max_occs_per_hit,
        hits_per_end=hits_per_end, stride=stride,
        diag_bucket_bits=diag_bucket_bits)
    return rank_hits(hits, R=R, E=len(ends), P=P, max_cands=max_cands)


def collect_hits_sparse(ends, occ_oct: torch.Tensor, *, occ_cap: int,
                        max_occs_per_hit: int, hits_per_end: int,
                        stride: int = 1, diag_bucket_bits: int = 5):
    """Steps 1-2: expand each end's found k-mer windows into a flat
    budgeted hit list. Returns (rid, key, key2, diag), each (H,): rid,
    key and key2 u32 (INVALID_KEY on empty slots), diag int32, in global
    coordinates (transcript ids and positions), so hit lists of disjoint
    k-mer shards of one index can be concatenated before ranking."""
    E = len(ends)
    R, P = ends[0][1][0].shape
    dev = occ_oct.device
    NE = E * R                       # read-end count
    B = min(hits_per_end, P * occ_cap)
    H = NE * B

    def flat(get):
        """Per-window values in (read, end, window) order."""
        parts = [get(km, lk).to(torch.int64) for km, lk in ends]
        return torch.stack(parts, dim=1).reshape(-1)

    start = flat(lambda km, lk: lk[0])
    count = flat(lambda km, lk: lk[1])
    found = flat(lambda km, lk: lk[2]).to(torch.bool)
    # inlined single-occurrence slots: start = -2 marks them, and the
    # record rides the header instead of being gathered from the CSR
    itxp = flat(lambda km, lk: lk[4])
    ipf = flat(lambda km, lk: lk[5])
    qfw = flat(lambda km, lk: km["is_fw"])
    kval = flat(lambda km, lk: km["valid"]).to(torch.bool)
    qfp30 = flat(lambda km, lk: fingerprint30(km["hi"], km["lo"]))

    usable = found & kval & (count <= max_occs_per_hit)
    n = torch.where(usable, torch.clamp(count, max=occ_cap), 0)

    # per-end budget: leftmost windows first until B hits are spent
    n2 = n.reshape(NE, P)
    cum_in = torch.cumsum(n2, dim=1)
    n_used = torch.minimum(torch.clamp(B - (cum_in - n2), min=0),
                           n2).reshape(-1)

    # ragged expansion: header scatter + carry scan along dim 0; windows
    # without hits write the drop row H
    dest = torch.cumsum(n_used, dim=0) - n_used         # exclusive
    W = NE * P
    w_idx = torch.arange(W, dtype=torch.int64, device=dev)
    hdr = torch.stack([start, (w_idx << 1) | qfw, n_used, dest, qfp30,
                       itxp, ipf], dim=1)               # (W, 7)
    keep = n_used > 0
    dest_w = torch.where(keep, dest, H)
    slots = torch.zeros((H + 1, 7), dtype=torch.int64, device=dev)
    slots[dest_w] = hdr
    flags = torch.zeros(H + 1, dtype=torch.bool, device=dev)
    flags[dest_w] = keep
    hdrf = segment_carry_first(slots[:H], flags[:H, None], dim=0)

    c = torch.arange(H, dtype=torch.int64, device=dev) - hdrf[:, 3]
    hit_ok = c < hdrf[:, 2]                             # n=0 before 1st hdr
    occ = gather_occ_oct(occ_oct, hdrf[:, 0] + c, 1)[:, 0, :].to(
        torch.int64)                                    # (H, 2)
    is_inl = hdrf[:, 0] == -2
    txp = torch.where(is_inl, hdrf[:, 5], occ[:, 0])
    pf = torch.where(is_inl, hdrf[:, 6], occ[:, 1])
    tpos = pf >> 1
    tfwd = (pf & 1).to(torch.bool)

    # shadow-merged blocks: separator records (txp = -1) open a
    # sub-segment tagged with its key's fingerprint30; rows past a
    # separator count only for the query whose fingerprint matches
    is_sep = txp == -1
    seg_set = is_sep | (c == 0)
    seg_vals = torch.stack([torch.where(is_sep, tpos, 0),
                            is_sep.to(torch.int64)], dim=1)     # (H, 2)
    carried = segment_carry_first(seg_vals, seg_set[:, None], dim=0)
    seg_ok = (carried[:, 1] == 0) | (carried[:, 0] == hdrf[:, 4])
    hit_ok = hit_ok & ~is_sep & seg_ok

    wcol = hdrf[:, 1]
    q_is_fw = (wcol & 1).to(torch.bool)
    w = wcol >> 1
    rid = w // P                                        # read-end id
    p = w - rid * P
    rpos = p * stride

    orient_fw = q_is_fw == tfwd
    key = (((txp & MASK32) << 1) & MASK32) | orient_fw.to(torch.int64)
    key = torch.where(hit_ok, key, INVALID_KEY)
    diag = torch.where(orient_fw, tpos - rpos, tpos + rpos).to(torch.int32)
    rid_u = torch.where(hit_ok, rid, INVALID_KEY)

    window_bits = window_bits_for(P)
    if window_bits > 12:
        raise ValueError(
            f"{P} seed windows need window_bits={window_bits} > 12, "
            "which would overflow the diagonal-bucket sort key; raise "
            "kmer_stride or reduce max_read_len")
    db = ((diag.to(torch.int64) + DIAG_OFFSET) & MASK32) >> diag_bucket_bits
    key2 = ((db << window_bits) & MASK32) | p
    key2 = torch.where(hit_ok, key2, INVALID_KEY)
    return rid_u, key, key2, diag


def rebudget_hits(hits, *, P: int, hits_per_end: int):
    """Re-apply the per-end hit budget over a concatenated hit list (the
    sharded-index path's union of per-shard lists): keep each read end's
    leftmost `hits_per_end` hits, windows first and input order within a
    window, by one stable sort by (read end, window)."""
    rid_u, key, key2, diag = hits
    H = rid_u.shape[0]
    p = key2 & ((1 << window_bits_for(P)) - 1)
    order = _lexsort(rid_u, p)
    rid_s, key_s, key2_s, diag_s = (a[order] for a in (rid_u, key, key2,
                                                        diag))
    pos_idx = torch.arange(H, dtype=torch.int64, device=rid_u.device)
    seg = rid_s != _prev(rid_s, INVALID_KEY)
    rank = pos_idx - segment_carry_first(pos_idx, seg, dim=0)
    keep = (rid_s != INVALID_KEY) & (rank < hits_per_end)
    return (torch.where(keep, rid_s, INVALID_KEY),
            torch.where(keep, key_s, INVALID_KEY),
            torch.where(keep, key2_s, INVALID_KEY), diag_s)


def rank_hits(hits, *, R: int, E: int, P: int, max_cands: int):
    """Steps 3-4: co-linear run scoring and per-end top-T ranking over a
    flat hit list from collect_hits_sparse (or a concatenation of
    several). Returns the per-end candidate dicts."""
    rid_u, key, key2, diag = hits
    dev = rid_u.device
    NE = E * R
    H = rid_u.shape[0]
    window_bits = window_bits_for(P)

    # global co-linear run scoring: sort by (rid, key, key2). diag rides
    # unkeyed in the JAX package; equal keys are hits of one window and
    # diagonal bucket, whose reductions below ignore their order
    order = _lexsort(rid_u, key, key2)
    rid_s, key_s, key2_s, diag_s = (a[order] for a in (rid_u, key, key2,
                                                        diag))
    bucket_s = key2_s >> window_bits
    valid = rid_s != INVALID_KEY

    p_key2 = _prev(key2_s, INVALID_KEY)
    run_start = valid & ((rid_s != _prev(rid_s, INVALID_KEY))
                         | (key_s != _prev(key_s, INVALID_KEY))
                         | (bucket_s != (p_key2 >> window_bits)))
    run_end = valid & ((rid_s != _next(rid_s, INVALID_KEY))
                       | (key_s != _next(key_s, INVALID_KEY))
                       | (bucket_s != _next(bucket_s, INVALID_KEY)))
    uniq = valid & (run_start | (key2_s != p_key2))

    cum = torch.cumsum(uniq.to(torch.int64), dim=0)
    score = cum - segment_carry_first(cum, run_start, dim=0) + 1
    min_diag = _segmented_min(diag_s, run_start, dim=0)

    # per-read-end top-T ranking: (rid << sbits | ~score) then the
    # candidate key and the diagonal, all three as keys, so that a
    # read's top T does not depend on the rest of the batch
    sbits = _ceil_log2(P + 2)
    smax = (1 << sbits) - 1
    if _ceil_log2(NE) + sbits > 32:
        raise ValueError("read-end/score packing exceeds 32 bits; "
                         "reduce the batch size")
    rank_key = (rid_s << sbits) | (smax - torch.clamp(score, 0, smax))
    rank_key = torch.where(run_end, rank_key, INVALID_KEY)
    order = _lexsort(rank_key, key_s, min_diag)
    rk_s, keyc, diagc = rank_key[order], key_s[order], min_diag[order]
    ridc = rk_s >> sbits
    seg = ridc != _prev(ridc, INVALID_KEY)
    pos_idx = torch.arange(H, dtype=torch.int64, device=dev)
    rank = pos_idx - segment_carry_first(pos_idx, seg, dim=0)
    T = max_cands
    keepc = (rk_s != INVALID_KEY) & (rank < T)
    dest2 = torch.where(keepc, ridc * T + rank, NE * T)
    scorec = smax - (rk_s & smax)
    rows = torch.stack([keyc, scorec, diagc.to(torch.int64)], dim=1)
    out = torch.zeros((NE * T + 1, 3), dtype=torch.int64, device=dev)
    out[dest2] = rows
    out = out[:NE * T].reshape(R, E, T, 3)

    cands = []
    for e in range(E):
        keye = out[:, e, :, 0]
        sc = out[:, e, :, 1].to(torch.int32)
        cands.append({
            "txp": (keye >> 1).to(torch.int32),
            "is_fw": (keye & 1).to(torch.bool),
            "score": sc,
            "min_diag": out[:, e, :, 2].to(torch.int32),
            "valid": sc > 0,
        })
    return cands
