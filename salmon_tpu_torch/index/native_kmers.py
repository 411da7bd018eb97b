"""The index build's host hot paths on the port's native library
(`csrc/kmersort.cpp` through `_native.py`): canonical k-mer enumeration
with a parallel radix sort, flat or per partition of the canonical top
bits, the two-choice bucket placement with the table's passes over the
placed keys (bucket rows, the shadow check's first fingerprint match,
inlined records), the oct-row pads and a parallel row gather.

Counterpart of salmon_tpu/index/native_kmers.py. The plain versions,
which the tests hold these to, are numpy: `builder._enumerate_sorted_
records`, `kmer_enum`, `hashtable._place_keys_numpy`,
`hashtable._first_match_numpy`, `_fill_rows_numpy`, `_inline_numpy`,
`diskfmt._oct_align_pads_py` and fancy indexing.
"""

from __future__ import annotations

import numpy as np

from salmon_tpu_torch import _native


def _inputs(seq_codes, seq_offsets):
    seq = np.ascontiguousarray(seq_codes, np.uint8)
    off = np.ascontiguousarray(seq_offsets, np.int64)
    return seq, off, off.shape[0] - 1


def _starts(counts, n_txps):
    starts = np.zeros(n_txps, np.int64)
    starts[1:] = np.cumsum(counts[:n_txps])[:-1]
    return starts


def enumerate_sorted(seq_codes: np.ndarray, seq_offsets: np.ndarray,
                     k: int) -> tuple:
    """Every canonical k-mer of the records, sorted by k-mer (stable:
    occurrences stay in (transcript, position) order): (kmers u64, txp
    i32, pos i32, fwd bool)."""
    lib = _native.lib()
    seq, off, n_txps = _inputs(seq_codes, seq_offsets)
    counts = np.zeros(max(n_txps, 1), np.int64)
    total = int(lib.kmer_count(seq, off, n_txps, k, counts))
    keys = np.empty(total, np.uint64)
    payload = np.empty(total, np.uint64)
    if total:
        lib.kmer_enumerate(seq, off, n_txps, k, _starts(counts, n_txps),
                           keys, payload)
        lib.radix_sort_u64(keys, payload, total, 2 * k,
                           np.empty(total, np.uint64),
                           np.empty(total, np.uint64))
    tx = np.empty(total, np.int32)
    po = np.empty(total, np.int32)
    fw8 = np.empty(total, np.uint8)
    if total:
        lib.kmer_decode_payload(payload, total, tx, po, fw8)
    return keys, tx, po, fw8.view(bool)


def count_total(seq_codes: np.ndarray, seq_offsets: np.ndarray,
                k: int) -> int:
    """Total valid k-mer windows (windows with no base coded >= 4)."""
    seq, off, n_txps = _inputs(seq_codes, seq_offsets)
    counts = np.zeros(max(n_txps, 1), np.int64)
    return int(_native.lib().kmer_count(seq, off, n_txps, k, counts))


def enumerate_sorted_partitioned(seq_codes: np.ndarray,
                                 seq_offsets: np.ndarray, k: int,
                                 part_bits: int):
    """Generator over (keys u64, txp i32, pf i32) per canonical top
    `part_bits` bits, ascending, each sorted by key with (txp, pos) order
    kept within a key; concatenated, the partitions are enumerate_sorted's
    output. pf = pos << 1 | fwd. Each partition enumerates the whole
    input again and keeps its own windows, so the buffers are one
    partition's."""
    lib = _native.lib()
    seq, off, n_txps = _inputs(seq_codes, seq_offsets)
    for part in range(1 << part_bits):
        counts = np.zeros(max(n_txps, 1), np.int64)
        total = int(lib.kmer_count_part(seq, off, n_txps, k, counts,
                                        part_bits, part))
        keys = np.empty(total, np.uint64)
        payload = np.empty(total, np.uint64)
        tx = np.empty(total, np.int32)
        pf = np.empty(total, np.int32)
        if total:
            lib.kmer_enumerate_part(seq, off, n_txps, k,
                                    _starts(counts, n_txps), keys, payload,
                                    part_bits, part)
            # the top part_bits are constant within a partition: sort
            # the low bits only
            lib.radix_sort_u64(keys, payload, total, 2 * k - part_bits,
                               np.empty(total, np.uint64),
                               np.empty(total, np.uint64))
            lib.kmer_decode_payload_pf(payload, total, tx, pf)
        del payload
        yield keys, tx, pf


def table_place(keys_u64: np.ndarray, counts: np.ndarray,
                n_buckets: int) -> tuple:
    """Two-choice placement of unique keys into n_buckets 4-slot buckets
    (hashtable.build_hash_table rounds 1-3): (slot_key (n_buckets, 4)
    int32, the key index per slot or -1, n_evicted)."""
    if keys_u64.shape[0] >= 2**31:
        # slot_key holds int32 key indices
        raise ValueError(
            f"{keys_u64.shape[0]} keys exceed the int32 placement range "
            "of one table; raise --indexShards")
    keys = np.ascontiguousarray(keys_u64, np.uint64)
    slot_key = np.empty(n_buckets * 4, np.int32)
    n_evicted = int(_native.lib().table_place(
        keys, np.ascontiguousarray(counts, np.uint32), keys.shape[0],
        n_buckets, slot_key))
    return slot_key.reshape(n_buckets, 4), n_evicted


def table_slot_ranks(slot_key: np.ndarray) -> np.ndarray:
    """Per bucket, the held slots (slot_key >= 0) of the buckets before
    it: the first placed-entry id of each bucket."""
    slot_key = np.ascontiguousarray(slot_key, np.int32)
    ent_base = np.empty(slot_key.shape[0], np.int64)
    _native.lib().table_slot_ranks(slot_key, slot_key.shape[0], ent_base)
    return ent_base


def table_first_match(rows: np.ndarray, slot_key: np.ndarray,
                      fp_q: np.ndarray, *buckets: np.ndarray,
                      ent_base: np.ndarray | None = None) -> list:
    """For each array of query buckets, (probe slot, placed-entry id) of
    the lowest held slot of the query's bucket whose stored fingerprint
    is the query's (fp_q), or (8, -1); the placed-entry id is the slot's
    rank in np.nonzero(slot_key >= 0) order. ent_base:
    table_slot_ranks(slot_key), for a caller that queries one table in
    several calls. hashtable._first_match_numpy is the plain version."""
    lib = _native.lib()
    rows = np.ascontiguousarray(rows, np.int32)
    slot_key = np.ascontiguousarray(slot_key, np.int32)
    if ent_base is None:
        ent_base = table_slot_ranks(slot_key)
    fq = np.ascontiguousarray(fp_q, np.uint32)
    out = []
    for bq in buckets:
        bq = np.ascontiguousarray(bq, np.int64)
        if bq.size and (int(bq.min()) < 0
                        or int(bq.max()) >= slot_key.shape[0]):
            raise IndexError("table_first_match: a bucket is out of range")
        slot = np.empty(bq.shape[0], np.int64)
        ent = np.empty(bq.shape[0], np.int64)
        lib.table_first_match(rows, slot_key, ent_base, bq, fq,
                              bq.shape[0], slot, ent)
        out.append((slot, ent))
    return out


def table_fill_rows(slot_key: np.ndarray, fpcnt: np.ndarray,
                    starts: np.ndarray) -> np.ndarray:
    """The table's (n_buckets, 8) int32 bucket rows: (fpcnt, start) of
    the key held in each slot, zeros in empty slots.
    hashtable._fill_rows_numpy is the plain version."""
    slot_key = np.ascontiguousarray(slot_key, np.int32)
    rows = np.zeros((slot_key.shape[0], 8), np.int32)
    _native.lib().table_fill_rows(
        slot_key, slot_key.shape[0], np.ascontiguousarray(fpcnt, np.int32),
        np.ascontiguousarray(starts, np.int32), rows)
    return rows


def table_inline(rows: np.ndarray, slot_key: np.ndarray,
                 counts: np.ndarray, pay_counts: np.ndarray,
                 starts: np.ndarray, otx: np.ndarray, opf: np.ndarray,
                 fp: np.ndarray) -> int:
    """Rewrite in `rows` the slots of single-record keys to hold the
    record itself (hashtable.build_hash_table's inline_records); returns
    how many. hashtable._inline_numpy is the plain version."""
    if rows.dtype != np.int32 or not rows.flags.c_contiguous:
        raise ValueError("table_inline: rows must be C-contiguous int32")
    slot_key = np.ascontiguousarray(slot_key, np.int32)
    otx = np.ascontiguousarray(otx, np.int32)
    return int(_native.lib().table_inline(
        slot_key, slot_key.shape[0], np.ascontiguousarray(counts, np.int64),
        np.ascontiguousarray(pay_counts, np.int64),
        np.ascontiguousarray(starts, np.int32), otx,
        np.ascontiguousarray(opf, np.int32), otx.shape[0],
        np.ascontiguousarray(fp, np.uint32), rows))


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """src[idx] along the first axis, any dtype, gathered in parallel
    (a memmapped src is read in place)."""
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, np.int64)
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= src.shape[0]):
        raise IndexError("gather_rows: an index is out of range")
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:]))
    dst = np.empty((idx.shape[0],) + src.shape[1:], src.dtype)
    _native.lib().gather_rows(src.view(np.uint8).reshape(-1), idx,
                              idx.shape[0], row_bytes,
                              dst.view(np.uint8).reshape(-1))
    return dst


def oct_align_pads(counts: np.ndarray, cap: int) -> np.ndarray:
    """Per-key pad records so that min(count, cap) leading records never
    cross an 8-record row (diskfmt.oct_align_csr): the greedy phase
    chain."""
    counts = np.ascontiguousarray(counts, np.int64)
    pads = np.empty(counts.shape[0], np.int64)
    _native.lib().oct_align_pads(counts, counts.shape[0], cap, pads)
    return pads
