"""Plain reference of equivalence-class accumulation: every fragment's
label (its transcripts and their range-factorisation bins, as the batch
step emitted them) counted, and its weights summed, by class. No code
of the program is imported; plain torch on any device.

A batch is given as flat arrays of its mapped fragments: `sizes` (the
number of transcripts of each fragment's label), then the label's
transcript ids, weights and bins, fragment after fragment.

`aggregate` returns the classes: one row per distinct (transcripts,
bins), its transcripts (padded with -1), its count and the sums of its
weights by position, in `dtype`. `class_gap` compares them with the
classes the program hands its EM, which carry no bins: per label, the
classes sorted by (count, weight sums) are paired up.
"""

from __future__ import annotations

import numpy as np
import torch


def _concat(batches):
    sizes = np.concatenate([b[0] for b in batches]).astype(np.int64)
    txp = np.concatenate([b[1] for b in batches]).astype(np.int64)
    w = np.concatenate([b[2] for b in batches])
    bins = (np.concatenate([b[3] for b in batches]).astype(np.int64)
            if batches[0][3] is not None else np.zeros_like(txp))
    return sizes, txp, w, bins


def aggregate(batches, device="cpu", dtype=torch.float64):
    """(labels (n, W) int64 padded with -1, counts (n,), weight sums
    (n, W)) of the classes of the fragments of `batches`, counts and
    sums accumulated in `dtype`, returned as float64 numpy arrays."""
    dev = torch.device(device)
    sizes, txp, w, bins = _concat(batches)
    n = sizes.shape[0]
    if n == 0:
        return (np.zeros((0, 1), np.int64), np.zeros(0), np.zeros((0, 1)))
    W = int(sizes.max())
    row = torch.as_tensor(np.repeat(np.arange(n), sizes), device=dev)
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    col = torch.as_tensor(np.arange(txp.shape[0]) - np.repeat(start, sizes),
                          device=dev)
    key = torch.full((n, 2 * W), -1, dtype=torch.int64, device=dev)
    key[row, col] = torch.as_tensor(txp, device=dev)
    key[row, W + col] = torch.as_tensor(bins, device=dev)
    uniq, inv = torch.unique(key, dim=0, return_inverse=True)
    m = uniq.shape[0]
    counts = torch.zeros(m, dtype=dtype, device=dev).index_add_(
        0, inv, torch.ones(n, dtype=dtype, device=dev))
    wsum = torch.zeros(m * W, dtype=dtype, device=dev).index_add_(
        0, inv[row] * W + col, torch.as_tensor(w, device=dev).to(dtype))
    return (uniq[:, :W].cpu().numpy(),
            counts.to(torch.float64).cpu().numpy(),
            wsum.reshape(m, W).to(torch.float64).cpu().numpy())


def _rows(labels, counts, wsum, W):
    """Rows [label padded with -1 | count | weight sums padded with 0],
    sorted, as float64."""
    n, w = labels.shape
    out = np.zeros((n, 2 * W + 1))
    out[:, :W] = -1
    out[:, :w] = labels
    out[:, W] = counts
    out[:, W + 1:W + 1 + wsum.shape[1]] = wsum
    return out[np.lexsort(out.T[::-1])] if n else out


def class_gap(program_eq, ref_classes) -> float:
    """(sum of |count gaps| + sum of |weight-sum gaps|) / (sum of the
    reference's counts + weight sums), classes paired per label in
    sorted order; 1.0 where the two sets of classes differ in their
    labels (a class missing, added or split). `program_eq`: the
    program's classes (labels, offsets, counts, normalised weights),
    transcripts numbered as in the labels the reference counted."""
    labels, offsets, counts, weights = program_eq
    sizes = np.diff(np.asarray(offsets))
    n = sizes.shape[0]
    Wp = int(sizes.max()) if n else 1
    row = np.repeat(np.arange(n), sizes)
    col = np.arange(labels.shape[0]) - np.repeat(offsets[:-1], sizes)
    lab_p = np.full((n, Wp), -1, np.int64)
    lab_p[row, col] = np.asarray(labels)
    ws_p = np.zeros((n, Wp))
    ws_p[row, col] = np.asarray(weights) * np.asarray(counts)[row]
    lab_r, cnt_r, ws_r = ref_classes
    W = max(Wp, lab_r.shape[1])
    a = _rows(lab_p, np.asarray(counts, np.float64), ws_p, W)
    b = _rows(lab_r, cnt_r, ws_r, W)
    if a.shape != b.shape or not np.array_equal(a[:, :W], b[:, :W]):
        return 1.0
    return float(np.abs(a[:, W:] - b[:, W:]).sum()
                 / max(np.abs(b[:, W:]).sum(), 1e-300))


def to_packed(ref_classes):
    """The reference's classes as (labels, offsets, counts, normalised
    weights) for the reference VBEM."""
    lab, cnt, ws = ref_classes
    ok = lab >= 0
    sizes = ok.sum(1)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return (lab[ok], offsets, cnt, (ws / cnt[:, None])[ok])
