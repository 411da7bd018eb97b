"""Equivalence-class accumulation and CSR packing.

The reference keeps its classes in a concurrent cuckoo hash map
(include/salmon/internal/quant/EquivalenceClassBuilder.hpp:237-272);
so does this module, in the port's host library (`csrc/eqtable.cpp`):
an open-addressing hash table keyed on the whole row. The device emits
fixed-shape (R, T2) label/weight tensors per batch; the host dedupes a
batch's valid rows through a table of the batch's own size, buffers the
deduped batches, and merges them into the global table once a few
batches are pending. A merge costs work in proportion to the pending
rows and never passes over the table; the one sort, of the table's
unique rows by their bytes (the class order of the JAX package's
sort-based accumulator, so `--dumpEq` outputs agree class for class),
runs when the table is read out.

Rich equivalence classes: the per-fragment aux weights are accumulated
(summed in float64, in arrival order) per class and normalized by the
class count at finish() (reference TGValue::normalizeAux semantics).
Range factorization (SalmonQuantify.cpp:845-853) extends the label with
per-transcript conditional-probability bin ids; those ride along as
extra int32 columns. The table adapts to the key's width: labels alone
(alignment mode) or labels and bins; and to the labels' width, which may
differ from batch to batch (the batch step's wide pass widens a batch to
its widest label): a narrower batch is padded to the table's width, a
wider one widens the table (every key re-padded, once per widening). A
label's columns are padded with INVALID_TXP and its bins with -1, as the
batch step pads them, so a class's key does not depend on the width it
arrived at, nor does the class order.

Spans (utils.spans): eq.dedupe, a batch's native dedupe; eq.merge, the
merge of the pending batches into the table, counted by eq_merges,
eq_rows_merged (the pending rows it took in) and eq_rows_new (the rows
that opened a class; 1 - eq_rows_new / eq_rows_merged is the share of
merged rows that found their class in the table).
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np

from salmon_tpu_torch import _native
from salmon_tpu_torch.utils import spans

INVALID_TXP = 0x7FFFFFFF
# the pad of each group of a key's columns: the labels, the bins
_PADS = (INVALID_TXP, -1)


@dataclasses.dataclass
class PackedEqClasses:
    """CSR-packed equivalence classes ready for the jitted EM."""
    labels: np.ndarray    # (n_entries,) int32 transcript ids
    weights: np.ndarray   # (n_entries,) float64 normalized aux weights
    offsets: np.ndarray   # (n_classes + 1,) int64
    counts: np.ndarray    # (n_classes,) float64 fragment counts
    class_sizes: np.ndarray  # (n_classes,) int32

    @property
    def num_classes(self) -> int:
        return self.counts.shape[0]

    @property
    def num_fragments(self) -> float:
        return float(self.counts.sum())


def _pad_groups(a: np.ndarray, groups: int, t2: int, fill) -> np.ndarray:
    """Rows of `groups` column groups each padded to t2 columns with
    fill[g] (a scalar fill pads every group with it)."""
    m, n = a.shape
    w = n // groups
    if w == t2:
        return a
    out = np.empty((m, groups * t2), a.dtype)
    for g in range(groups):
        out[:, g * t2:g * t2 + w] = a[:, g * w:(g + 1) * w]
        out[:, g * t2 + w:(g + 1) * t2] = (fill[g] if np.ndim(fill)
                                            else fill)
    return out


def _dedupe(keys: np.ndarray, w: np.ndarray):
    """One batch's rows (int32 keys, float32 weights; a fragment each)
    -> (unique keys, counts, float64 weight sums) in order of first
    appearance."""
    m, ncols = keys.shape
    t2 = w.shape[1]
    if w.shape[0] != m:
        raise ValueError(f"{m} eq rows with {w.shape[0]} rows of weights")
    out_k = np.empty((m, ncols), np.int32)
    out_c = np.empty(m, np.float64)
    out_w = np.empty((m, t2), np.float64)
    n = _native.lib().eqt_dedupe(keys, w, m, ncols, t2, out_k, out_c, out_w)
    if n < 0:
        raise MemoryError("eq-class dedupe: out of memory")
    return out_k[:n], out_c[:n], out_w[:n]


class _Table:
    """The native table of classes (csrc/eqtable.cpp), with room for
    n_rows classes (2^16 slots) before it first grows."""

    def __init__(self, ncols: int, t2: int, n_rows: int = 1 << 15):
        lib = _native.lib()
        self._lib = lib
        self._h = lib.eqt_new(ncols, t2, n_rows)
        if not self._h:
            raise MemoryError("eq-class table: out of memory")
        weakref.finalize(self, lib.eqt_free, self._h)
        self.ncols, self.t2 = ncols, t2
        self.groups = ncols // t2

    def widen(self, t2: int) -> None:
        """Every key padded to `groups` groups of t2 columns."""
        if t2 <= self.t2:
            return
        pad = np.array(_PADS[:self.groups], np.int32)
        if self._lib.eqt_widen(self._h, self.groups, t2, pad) < 0:
            raise MemoryError("eq-class table: out of memory")
        self.t2, self.ncols = t2, self.groups * t2

    @property
    def size(self) -> int:
        return self._lib.eqt_size(self._h)

    def merge(self, keys: np.ndarray, counts: np.ndarray,
              wsum: np.ndarray) -> int:
        """Add rows into their classes; returns the rows that opened
        one."""
        m = keys.shape[0]
        if (keys.shape != (m, self.ncols) or counts.shape != (m,)
                or wsum.shape != (m, self.t2)):
            raise ValueError(
                f"eq rows of shapes {keys.shape}, {counts.shape}, "
                f"{wsum.shape} for a table of {self.ncols} key columns "
                f"and {self.t2} weights")
        new = self._lib.eqt_merge(
            self._h, np.ascontiguousarray(keys, np.int32),
            np.ascontiguousarray(counts, np.float64),
            np.ascontiguousarray(wsum, np.float64), m)
        if new < 0:
            raise MemoryError("eq-class table: out of memory")
        return new

    def export(self):
        """(keys, counts, wsum) ascending by the keys' bytes."""
        n = self.size
        keys = np.empty((n, self.ncols), np.int32)
        counts = np.empty(n, np.float64)
        wsum = np.empty((n, self.t2), np.float64)
        if self._lib.eqt_export(self._h, keys, counts, wsum) < 0:
            raise MemoryError("eq-class table: out of memory")
        return keys, counts, wsum


class EquivalenceClassAccumulator:
    """Accumulates per-batch eq-class tensors into a global table."""

    def __init__(self, merge_buffer_rows: int = 1 << 14):
        self._chunks: list[tuple] = []   # pending: (keys, counts, wsum)
        self._buffered = 0
        self._merge_buffer_rows = merge_buffer_rows
        self._table: _Table | None = None

    def add_batch(self, eq_txp: np.ndarray, eq_weight: np.ndarray,
                  eq_bins: np.ndarray | None = None) -> None:
        """eq_txp: (R, T2) int32 sorted labels padded with INVALID_TXP;
        eq_weight: (R, T2) float32 aux weights; eq_bins: optional (R, T2)
        int32 range-factorization bins (part of the label), padded with
        -1. T2 may differ from batch to batch."""
        valid_rows = eq_txp[:, 0] != INVALID_TXP
        if not valid_rows.any():
            return
        txp = eq_txp[valid_rows]
        w = np.ascontiguousarray(eq_weight[valid_rows], np.float32)
        t2 = txp.shape[1]
        groups = 1 if eq_bins is None else 2
        if self._table is None:
            self._table = _Table(groups * t2, t2)
        elif groups != self._table.groups:
            raise ValueError(
                f"eq rows with{'out' if eq_bins is None else ''} bins for "
                f"a table keyed on {self._table.groups} column groups")
        elif t2 > self._table.t2:
            self._table.widen(t2)
        elif t2 < self._table.t2:
            t2 = self._table.t2
            txp = _pad_groups(txp, 1, t2, INVALID_TXP)
            w = _pad_groups(w, 1, t2, 0)
        if eq_bins is not None:
            bins = _pad_groups(eq_bins[valid_rows], 1, t2, -1)
            key_mat = np.concatenate([txp, bins], axis=1)
        else:
            key_mat = txp
        key_mat = np.ascontiguousarray(key_mat, np.int32)

        with spans.span("eq.dedupe"):
            chunk = _dedupe(key_mat, w)
        self._chunks.append(chunk)
        self._buffered += chunk[0].shape[0]
        if (len(self._chunks) > 1
                and self._buffered >= self._merge_buffer_rows):
            self._collapse()

    def _collapse(self) -> None:
        """Merge the pending batches into the table."""
        if not self._chunks:
            return
        rows = new = 0
        tab = self._table
        with spans.span("eq.merge"):
            for keys, counts, wsum in self._chunks:
                # a batch deduped before the table last widened
                keys = _pad_groups(keys, tab.groups, tab.t2, _PADS)
                wsum = _pad_groups(wsum, 1, tab.t2, 0.0)
                new += tab.merge(keys, counts, wsum)
                rows += keys.shape[0]
            self._chunks = []
            self._buffered = 0
        spans.count("eq_merges")
        spans.count("eq_rows_merged", rows)
        spans.count("eq_rows_new", new)

    def collapsed(self) -> tuple:
        """(keys, counts, wsum) of the table so far, one row per class,
        ascending by the keys' bytes."""
        self._collapse()
        if self._table is not None and self._table.size:
            return self._table.export()
        return np.zeros((0, 0), np.int32), np.zeros(0), np.zeros((0, 0))

    def replace_rows(self, keys: np.ndarray, counts: np.ndarray,
                     wsum: np.ndarray, t2: int) -> None:
        """Make the table the classes of these rows (the tables of
        several accumulators, concatenated); t2: the label columns of a
        key."""
        self._chunks, self._buffered = [], 0
        self._table = None
        if keys.size:
            self._table = _Table(keys.shape[1], t2)
            self._table.merge(keys, counts, wsum)

    @property
    def label_width(self) -> int:
        """The label columns of the table's keys (0 before a class)."""
        return self._table.t2 if self._table is not None else 0

    def widen(self, t2: int) -> None:
        """Pad the table's labels to t2 columns (the pending batches
        follow at the next merge)."""
        if self._table is not None:
            self._table.widen(t2)

    @property
    def num_classes(self) -> int:
        self._collapse()
        return self._table.size if self._table is not None else 0

    def finish(self) -> PackedEqClasses:
        """Normalize aux weights by class count and pack to CSR
        (reference EquivalenceClassBuilder::finish,
        EquivalenceClassBuilder.hpp:165-181). Fully vectorized."""
        keys, counts, wsum = self.collapsed()
        if not counts.shape[0]:
            return PackedEqClasses(
                labels=np.zeros(0, np.int32), weights=np.zeros(0),
                offsets=np.zeros(1, np.int64), counts=np.zeros(0),
                class_sizes=np.zeros(0, np.int32))
        txps = keys[:, :self._table.t2]
        m = txps != INVALID_TXP
        sizes = m.sum(axis=1).astype(np.int32)
        labels = txps[m].astype(np.int32)
        weights = (wsum / counts[:, None])[m]
        offsets = np.zeros(sizes.shape[0] + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(sizes)
        return PackedEqClasses(
            labels=labels, weights=weights, offsets=offsets,
            counts=counts.astype(np.float64), class_sizes=sizes)
