"""Alignment mode's per-fragment weights and eq rows in one native pass
(csrc/alnweights.cpp through `_native.py`): weight normalization,
equivalence-row emission, best alignment and FLD histogram, one OpenMP
sweep over the fragments.

Counterpart of salmon_tpu/alignment/alnweights.py (reference role:
processMiniBatch's per-fragment loop,
src/alignment/SalmonQuantifyAlignments.cpp:940-1213). The plain version
is numpy: alignment/quant.py `_weigh_fragments` and `_best_alignments`.
"""

from __future__ import annotations

import numpy as np

from salmon_tpu_torch import _native


def group_eq(fid, txp, flen, obs, logw, min_aln_prob: float,
             paired: bool, max_flen: int) -> tuple:
    """One pass over fragment-grouped records; fid must be nondecreasing
    (frag ids are a cumsum over the BAM walk, so each fragment's records
    are one run).

    Returns (eq_txp (F, T2) i32, eq_w (F, T2) f32, wn (n,) f64 posteriors,
    best (F,) i64 record index of each fragment's first max-weight
    alignment or -1, fld_hist (max_flen + 1,) f64, n_mapped): w =
    exp(logw - the fragment's max), valid = w > min_aln_prob; an eq row
    holds the ascending unique transcripts of the valid records, their
    weights summed, INVALID_TXP padding; wn = w / the fragment's valid
    sum (0 where not valid); fld_hist sums wn over the valid paired
    records with obs >= 0 and flen > 0 by min(flen, max_flen)."""
    lib = _native.lib()
    fid = np.ascontiguousarray(fid, np.int64)
    n = fid.shape[0]
    starts = np.empty(n + 1, np.int64)
    F = int(lib.aln_frag_starts(fid, n, starts))
    starts = np.ascontiguousarray(starts[:F + 1])
    T2 = int(np.diff(starts).max()) if F else 1
    eq_txp = np.empty((F, T2), np.int32)
    eq_w = np.empty((F, T2), np.float32)
    wn = np.empty(n, np.float64)
    best = np.empty(F, np.int64)
    fld_hist = np.empty(max_flen + 1, np.float64)
    n_mapped = int(lib.aln_group_eq(
        starts, F, n, np.ascontiguousarray(txp, np.int32),
        np.ascontiguousarray(flen, np.int64),
        np.ascontiguousarray(obs, np.int64),
        np.ascontiguousarray(logw, np.float64), float(min_aln_prob), T2,
        1 if paired else 0, max_flen, eq_txp, eq_w, wn, best, fld_hist))
    return eq_txp, eq_w, wn, best, fld_hist, n_mapped
