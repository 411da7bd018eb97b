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
(alignment mode) or labels and bins.

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
        int32 range-factorization bins (part of the label)."""
        valid_rows = eq_txp[:, 0] != INVALID_TXP
        if not valid_rows.any():
            return
        txp = eq_txp[valid_rows]
        w = np.ascontiguousarray(eq_weight[valid_rows], np.float32)
        if eq_bins is not None:
            key_mat = np.concatenate([txp, eq_bins[valid_rows]], axis=1)
        else:
            key_mat = txp
        key_mat = np.ascontiguousarray(key_mat, np.int32)
        if self._table is None:
            self._table = _Table(key_mat.shape[1], txp.shape[1])

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
        with spans.span("eq.merge"):
            for keys, counts, wsum in self._chunks:
                new += self._table.merge(keys, counts, wsum)
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
