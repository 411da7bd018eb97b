"""Hit collection and per-(transcript, orientation) chain scoring.

Counterpart of salmon_tpu/mapping/score.py (pufferfish MemCollector /
MemChainer hit projection + chaining, consumed at
src/quant/SalmonQuantify.cpp:1266-1288): every (window, occurrence) hit
in the batch is materialized into a fixed (R, P*C) tensor, sorted per
read by (candidate key, diagonal bucket, window), and reduced to
run-length scores with segmented scans. Score = number of distinct
k-mer positions supporting one (transcript, orientation, diagonal band)
candidate.

The first oct row of each window comes from one gather per window, or
from a pool: per read row (row_pool, the SALMON_TPU_ROWPOOL switch) or
batch-global (inline_pool), over the windows whose records are not
inlined in the table; the budgeted tail pool fetches the rows after it.
Every sort is stable, so ties keep their input order; the JAX package
sorts with is_stable=False, and ROADMAP queue 3 lists where that order
shows. The pools' sorts key unique values, so there the two agree. u32
values follow salmon_tpu_torch.utils.u32.
"""

from __future__ import annotations

import numpy as np
import torch

from salmon_tpu_torch.mapping.lookup import fingerprint30
from salmon_tpu_torch.utils.u32 import MASK32

INVALID_KEY = 0xFFFFFFFF


def gather_occ_oct(occ_oct: torch.Tensor, start: torch.Tensor, C: int):
    """Fetch C consecutive occurrence records starting at flat index
    `start` from the oct-packed (n_oct, 16) int32 occurrence matrix
    (eight (txp, pos<<1|fwd) records per row). Negative starts clip to
    row 0; the caller masks their records. Returns (..., C, 2) int32."""
    nrows = (C + 14) // 8                    # ceil((C + 7) / 8)
    q0 = start.to(torch.int64) >> 3
    off = start.to(torch.int64) & 7
    ridx = q0[..., None] + torch.arange(nrows, device=start.device)
    rows = occ_oct[ridx.clamp(0, occ_oct.shape[0] - 1)]
    occ_all = rows.reshape(rows.shape[:-2] + (nrows * 8, 2))
    idx = off[..., None] + torch.arange(C, device=start.device)
    idx = idx[..., None].expand(idx.shape + (2,))
    return torch.gather(occ_all, -2, idx)


def segment_carry_first(values: torch.Tensor, seg_start: torch.Tensor,
                        dim: int = 1):
    """For each element, the value at the last segment start at or
    before it along `dim` (the first element's value before any).
    seg_start broadcasts against values: a (H, 1) flag column carries
    whole rows along dim 0. The running max of start positions is taken
    over seg_start's own shape, along its innermost dimension (torch's
    scan along an outer dimension of a 2-D tensor walks each column in
    one thread: ~86 ms for 262,144 rows on an H100)."""
    n = values.shape[dim]
    shape = [1] * values.dim()
    shape[dim] = n
    pos = torch.arange(n, device=values.device).reshape(shape)
    last = torch.where(seg_start, pos, 0).movedim(dim, -1).cummax(
        dim=-1).values.movedim(-1, dim)
    return torch.gather(values, dim, last.expand_as(values))


def _segmented_min(values: torch.Tensor, seg_start: torch.Tensor,
                   dim: int = 1):
    """Running minimum along `dim` that restarts at every segment start.

    Each later segment is shifted down by more than the value range, so
    one plain cummin never reaches back across a segment start."""
    v = values.to(torch.int64)
    seg = torch.cumsum(seg_start.to(torch.int64), dim=dim)
    big = 1 << 33                            # > the int32 value range
    return (torch.cummin(v - seg * big, dim=dim).values
            + seg * big).to(values.dtype)


def _sort_rows(key: torch.Tensor, *payloads: torch.Tensor):
    """Stable ascending sort of each row by `key`, carrying payloads."""
    order = torch.argsort(key, dim=1, stable=True)
    return (torch.gather(key, 1, order),) + tuple(
        torch.gather(p, 1, order) for p in payloads)


def expand_occurrences(km: dict, lk, occ_oct: torch.Tensor,
                       occ_cap: int, max_occs_per_hit: int,
                       stride: int = 1, tail_frac: int = 8,
                       inline_pool: bool = False, row_pool: int = 0,
                       with_cut: bool = False):
    """Gather up to C occurrences per found k-mer window.

    `lk` is hash_lookup's (start, count, found, inl, itxp, ipf); window p
    sits at read position p*stride. Each window's first oct row comes
    from one gather per window, or with row_pool = N (and not
    inline_pool) from a per-read-row pool: each read's first N windows
    that need the CSR (usable, not inlined), leftmost first, fetch their
    row; with inline_pool from one batch-global pool of
    K0 = max(4096, F // 3) such windows, by flat index. Windows past a
    pool budget keep no first-row records. Windows whose records spill
    past the first row (count + offset > 8) are batch-globally compacted
    into K = max(1024, F // tail_frac) slots that fetch the following
    ceil((C - 1) / 8) rows, the first K such windows by flat index
    winning; windows past that budget keep their first-row records.
    `n_tail_over` counts the windows past either budget, as the JAX
    package does (a pooled window past its budget that the tail still
    serves takes the pool's zero row for its first records, there as
    here).

    With `with_cut`, a sixth value marks each read row (R,) bool that a
    budget cut: a window with more than C occurrences, or past the
    tail or a pool budget.

    The shadow-merge separator scan runs on every batch: the JAX package
    gates it behind an any-separator test, which gives identical results
    and here would cost a host sync.

    Returns (key, rpos, diag, valid, n_tail_over); the first four are
    (R, N = P*C) — lane n = window (n // C), record (n % C):
      key  = txp*2 + orient (u32; orient=1 read maps forward),
      rpos = read window position (in bases), int32,
      diag = tpos - rpos (fw) or tpos + rpos (rc), int32.
    """
    start, count, found, inl, itxp, ipf = lk
    dev = start.device
    R, P = start.shape
    C = occ_cap
    F = R * P
    N = P * C
    n_oct = occ_oct.shape[0]
    usable = found & km["valid"] & (count <= max_occs_per_hit)

    start_f = start.reshape(F).to(torch.int64)
    q0 = start_f >> 3
    off = start_f & 7
    cnt_c = torch.clamp(count.reshape(F), max=C)
    use_f = usable.reshape(F)
    inl_f = inl.reshape(F) & use_f

    def rows_at(q):
        return occ_oct[q.clamp(0, n_oct - 1)]

    n_pool_over = torch.zeros((), dtype=torch.int64, device=dev)
    pool_over = torch.zeros(F, dtype=torch.bool, device=dev)
    if row_pool and not inline_pool:
        # per read row: the needy windows first, each group in column
        # order (the JAX package's packed (flag, column) sort keys unique
        # values); the pooled rows go back to their columns, the rest
        # stay zero
        p_need = min(row_pool, P)
        need2 = (use_f & ~inl_f).reshape(R, P)
        psel = torch.argsort((~need2).to(torch.int8), dim=1,
                             stable=True)[:, :p_need]
        qsel = torch.gather(q0.reshape(R, P), 1, psel)
        row0 = torch.zeros((R, P, 16), dtype=occ_oct.dtype, device=dev)
        row0.scatter_(1, psel[:, :, None].expand(R, p_need, 16),
                      rows_at(qsel))
        row0 = row0.reshape(F, 16)
        incl = torch.cumsum(need2.to(torch.int32), dim=1) <= p_need
        got_row0 = (need2 & incl).reshape(F)
        pool_over = (need2 & ~incl).reshape(F)
        n_pool_over = pool_over.sum()
    elif inline_pool:
        need_row = use_f & ~inl_f
        K0 = min(F, max(4096, F // 3))
        psel = torch.argsort((~need_row).to(torch.int8), stable=True)[:K0]
        row0 = torch.zeros((F, 16), dtype=occ_oct.dtype, device=dev)
        row0[psel] = rows_at(q0[psel])
        got_row0 = need_row & (torch.cumsum(need_row.to(torch.int32), 0)
                               <= K0)
        pool_over = need_row & ~got_row0
        n_pool_over = torch.clamp(need_row.sum() - K0, min=0)
    else:
        row0 = rows_at(q0)                                 # (F, 16)
        got_row0 = use_f

    tail_n = max(1, -(-(C - 1) // 8))
    need = use_f & (cnt_c + off > 8)
    K = min(F, max(1024, F // tail_frac))
    # needy windows first, each group in flat-index order
    sel = torch.argsort((~need).to(torch.int8), stable=True)[:K]
    sel_need = need[sel]
    ridx = (q0[sel].clamp(min=0)[:, None]
            + torch.arange(1, tail_n + 1, device=dev))
    tail = occ_oct[ridx.clamp(0, n_oct - 1)]               # (K, tail_n, 16)
    tail = torch.where(sel_need[:, None, None], tail, 0)
    tail_buf = torch.zeros((F, tail_n * 16), dtype=occ_oct.dtype,
                           device=dev)
    tail_buf[sel] = tail.reshape(K, tail_n * 16)
    got_tail = need & (torch.cumsum(need.to(torch.int32), 0) <= K)

    flat = torch.cat([row0, tail_buf], dim=1)          # (F, 16+16*tail_n)
    lane = off[:, None] + torch.arange(C, device=dev)
    txp_f = torch.gather(flat[:, 0::2], 1, lane)
    pf_f = torch.gather(flat[:, 1::2], 1, lane)
    # inlined single-occurrence slots: the record rode in the lookup
    txp_f = torch.where(inl_f[:, None], itxp.reshape(F)[:, None], txp_f)
    pf_f = torch.where(inl_f[:, None], ipf.reshape(F)[:, None], pf_f)

    c_idx = torch.arange(C, device=dev)
    lane_src = (((c_idx[None, :] < 8 - off[:, None]) & got_row0[:, None])
                | got_tail[:, None] | inl_f[:, None])
    ovalid = (use_f[:, None] & (c_idx[None, :] < cnt_c[:, None])
              & lane_src).reshape(R, N)

    txp = txp_f.reshape(R, N)
    tpos = (pf_f >> 1).reshape(R, N)
    tfwd = (pf_f & 1).to(torch.bool).reshape(R, N)

    # shadow-merged blocks: a separator record (txp = -1) opens a
    # sub-segment tagged with its key's fingerprint30 (+1; 0 marks a
    # window start); rows past it count only for the matching query
    is_sep = ovalid & (txp == -1)
    lane0 = (torch.arange(N, device=dev) % C == 0).expand(R, N)
    carried = segment_carry_first(torch.where(is_sep, tpos + 1, 0),
                                  is_sep | lane0)
    qfp30 = fingerprint30(km["hi"], km["lo"]).reshape(R, P)
    qfp30_l = torch.repeat_interleave(qfp30, C, dim=1)
    seg_ok = (carried == 0) | (carried == qfp30_l + 1)
    ovalid = ovalid & ~is_sep & seg_ok

    orient_fw = torch.repeat_interleave(
        km["is_fw"].reshape(R, P), C, dim=1) == tfwd
    key = (((txp.to(torch.int64) & MASK32) << 1) & MASK32) | \
        orient_fw.to(torch.int64)
    key = torch.where(ovalid, key, INVALID_KEY)
    rpos = torch.repeat_interleave(
        torch.arange(P, dtype=torch.int32, device=dev) * stride,
        C).expand(R, N)
    diag = torch.where(orient_fw, tpos - rpos, tpos + rpos)
    n_tail_over = (torch.clamp(need.sum() - K, min=0)
                   + n_pool_over).to(torch.int32)
    if not with_cut:
        return key, rpos, diag, ovalid, n_tail_over
    cut = use_f & ((count.reshape(F) > C) | (need & ~got_tail) | pool_over)
    return key, rpos, diag, ovalid, n_tail_over, cut.reshape(R, P).any(1)


DIAG_OFFSET = 4096  # diag >= -max_read_len, so +4096 keeps buckets >= 0


def window_bits_for(n_windows: int) -> int:
    """Bits of the window field of the chain sort key (>= 8)."""
    return max(8, int(np.ceil(np.log2(max(n_windows, 2)))))


def diag_bucket_bits_for(max_tpos: int, window_bits: int,
                         min_bits: int = 5) -> int:
    """Smallest diagonal-bucket shift such that
    (max_diag + DIAG_OFFSET) >> bits fits the 32 - window_bits key bits
    above the window field (huge transcripts coarsen the chain bands
    instead of wrapping the packed sort key)."""
    need = int(np.ceil(np.log2(max(max_tpos + DIAG_OFFSET + 1, 2))))
    return max(min_bits, need - (32 - window_bits))


def score_candidates(key, rpos, diag, max_cands: int, stride: int = 1,
                     window_bits: int = 8, diag_bucket_bits: int = 5,
                     with_cut: bool = False):
    """Sort hits per read and reduce co-linear runs to top-T candidates.

    Hits sort by (candidate key, key2 = diag_bucket << window_bits |
    window); a candidate's score is the number of distinct windows
    supporting one diagonal band, and its min_diag the smallest diagonal
    in the run. The top T runs by score are kept; equal scores keep run
    order (ascending key).

    Args:
      key/rpos/diag: (R, N) hit tensors from expand_occurrences.
      max_cands: T — candidates kept per read end.
      stride: window spacing in bases (rpos = window * stride).

    Returns dict of (R, T): txp (int32), is_fw (bool), score (int32),
    min_diag (int32), valid (bool); with `with_cut` also cut (R,) bool,
    the rows that had more than T runs.
    """
    window = (rpos // stride).to(torch.int64)
    db = ((diag.to(torch.int64) + DIAG_OFFSET) & MASK32) >> diag_bucket_bits
    key2 = ((db << window_bits) & MASK32) | window
    key2 = torch.where(key == INVALID_KEY, INVALID_KEY, key2)
    # lexicographic (key, key2): stable sort by the minor key first
    key2_s, key_s, diag_s = _sort_rows(key2, key, diag)
    key_s, key2_s, diag_s = _sort_rows(key_s, key2_s, diag_s)
    bucket_s = key2_s >> window_bits

    R = key.shape[0]
    inv = torch.full((R, 1), INVALID_KEY, dtype=torch.int64,
                     device=key.device)
    valid = key_s != INVALID_KEY
    prev_key = torch.cat([inv, key_s[:, :-1]], dim=1)
    prev_key2 = torch.cat([inv, key2_s[:, :-1]], dim=1)
    prev_bucket = prev_key2 >> window_bits
    next_key = torch.cat([key_s[:, 1:], inv], dim=1)
    next_bucket = torch.cat([bucket_s[:, 1:], inv], dim=1)

    run_start = valid & ((key_s != prev_key) | (bucket_s != prev_bucket))
    run_end = valid & ((key_s != next_key) | (bucket_s != next_bucket))
    uniq = valid & (run_start | (key2_s != prev_key2))

    cum = torch.cumsum(uniq.to(torch.int32), dim=1, dtype=torch.int32)
    run_score = cum - segment_carry_first(cum, run_start) + 1
    min_diag = _segmented_min(diag_s, run_start)

    end_score = torch.where(run_end, run_score, 0)
    neg_s, top_key, top_diag = _sort_rows(-end_score, key_s, min_diag)
    top_score = -neg_s[:, :max_cands]
    top_key = top_key[:, :max_cands]
    out = {
        "txp": (top_key >> 1).to(torch.int32),
        "is_fw": (top_key & 1).to(torch.bool),
        "score": top_score,
        "min_diag": top_diag[:, :max_cands],
        "valid": top_score > 0,
    }
    if with_cut:
        out["cut"] = run_end.sum(dim=1) > max_cands
    return out


def candidate_read_start(cand: dict, read_len, k: int):
    """Inferred read start position on the transcript for each candidate.

    fw: start = min(tpos - rpos); rc: start = min(tpos + rpos) + k - len.
    """
    return torch.where(cand["is_fw"], cand["min_diag"],
                       cand["min_diag"] + k - read_len[:, None])
