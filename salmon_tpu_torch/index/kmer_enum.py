"""Canonical k-mer enumeration for the index build, in numpy, partitioned
by the top bits of the canonical k-mer.

The plain version of the port's native enumeration, which the index
build calls: `index/native_kmers.py::count_total`, `::enumerate_sorted`
and `::enumerate_sorted_partitioned` (over csrc/kmersort.cpp, the copy
of the JAX package's source); the tests hold the two equal. The k-mer
convention is `utils.dna`'s, bit for
bit: the k-mer at position p is the big-endian 2-bit packing of bases
p .. p + k - 1, canonical = min(fwd, revcomp), fwd flag = (fwd <=
revcomp), and a window that holds a base coded >= 4 (N) is no k-mer.
Records follow one another in `seq_codes`; no window spans two.

Memory. `utils.dna.kmers_of` multiplies an (n, k) u64 window view of a
whole record by a power vector: n * k * 8 bytes of scratch, 62 GB for a
250 Mb chromosome. Here the sequence is read in chunks of at most
CHUNK_BASES window starts: a chunk is a run of whole records, or a
piece of one record longer than that, and the pieces of a record
overlap by k - 1 bases. A chunk's k-mers come from log2(k) doublings
of its 2-bit codes (a block of 2m bases is two blocks of m), so its
scratch is a handful of u64 planes of its length. Peak scratch is one
chunk plus one partition; no pass holds n * k of a record or the keys
of the whole input.

Design, between the two ways to partition:

- re-enumerate the whole sequence once per partition, keeping that
  partition's windows: 2^bits enumeration passes (64 at the default
  6 bits), each as costly as the count;
- one pass that scatters each chunk's records into their partition's
  slice of the final (txp, pf) buffers, sized by a first counting pass,
  then per partition a rebuild of the keys by a gather of k bases from
  `seq_codes` at each record's (txp, pos).

This module takes the second: two enumeration passes whatever the
partition count, and k u8 gathers per record, which at 6 bits cost far
less than 62 more passes. Scatter order is chunk order and, inside a
chunk, window order, so each partition's records stay in (txp, pos)
order, and a stable sort by key keeps that order within a key, as the
native radix sort does.
"""

from __future__ import annotations

import numpy as np

from salmon_tpu_torch.utils.dna import revcomp_kmers

# window starts per chunk (a module constant so that tests can make
# chunk seams fall inside short records)
CHUNK_BASES = 1 << 20


def _chunks(seq_offsets: np.ndarray, k: int, chunk: int):
    """(lo, hi, first record) base ranges of seq_codes: runs of whole
    records holding at most `chunk` bases, or pieces of one longer
    record with `chunk` window starts each (k - 1 bases of overlap)."""
    off = seq_offsets
    n_rec = off.shape[0] - 1
    i = 0
    while i < n_rec:
        lo = int(off[i])
        j = int(np.searchsorted(off, lo + chunk, side="right")) - 1
        if j > i:
            yield lo, int(off[j]), i
            i = j
            continue
        end = int(off[i + 1])
        for s in range(lo, max(end - k + 1, lo + 1), chunk):
            yield s, min(s + chunk + k - 1, end), i
        i += 1


def _chunk_kmers(seq_codes: np.ndarray, seq_offsets: np.ndarray, k: int,
                 lo: int, hi: int, first: int):
    """The valid windows of bases [lo, hi): (canonical u64, fwd bool,
    txp i32, pos i32), in position order."""
    codes = seq_codes[lo:hi]
    n = codes.shape[0]
    m = n - k + 1
    if m <= 0:
        return None
    c = np.minimum(codes, 3).astype(np.uint64)
    # fw/rc of the first `a` bases of each window, grown by blocks of
    # q = 1, 2, 4, ... bases (the bits of k), fq/rq holding each block
    fq, rq = c, np.uint64(3) - c
    fw = rc = None
    a, q = 0, 1
    while True:
        if k & q:
            blk_f, blk_r = fq[a:a + m], rq[a:a + m]
            if fw is None:
                fw, rc = blk_f.copy(), blk_r.copy()
            else:
                fw <<= np.uint64(2 * q)
                fw |= blk_f
                rc |= blk_r << np.uint64(2 * a)
            a += q
        if 2 * q > k:
            break
        s = np.uint64(2 * q)
        fq = (fq[:-q] << s) | fq[q:]
        rq = rq[:-q] | (rq[q:] << s)
        q *= 2
    del fq, rq, c
    # windows inside one record, with no N
    rec_rel = seq_offsets[first + 1:np.searchsorted(seq_offsets, hi)] - lo
    ok = None
    if rec_rel.shape[0]:
        # bincount, not a scatter of ones: empty records share a start
        rid = np.cumsum(np.bincount(rec_rel, minlength=n), dtype=np.int32)
        ok = rid[:m] == rid[k - 1:]
        txp = rid[:m]
    else:
        txp = np.zeros(m, np.int32)
    bad = codes >= 4
    if bad.any():
        nb = np.zeros(n + 1, np.int32)
        np.cumsum(bad, out=nb[1:])
        no_n = nb[k:] == nb[:m]
        ok = no_n if ok is None else ok & no_n
    fwd = fw <= rc
    np.minimum(fw, rc, out=fw)
    del rc
    starts = np.arange(lo, lo + m, dtype=np.int64)
    if ok is not None:
        fw, fwd, txp, starts = fw[ok], fwd[ok], txp[ok], starts[ok]
    txp = txp + np.int32(first)
    pos = (starts - seq_offsets[txp]).astype(np.int32)
    return fw, fwd, txp, pos


def _windows(seq_codes, seq_offsets, k):
    seq_codes = np.asarray(seq_codes, np.uint8)
    seq_offsets = np.asarray(seq_offsets, np.int64)
    for lo, hi, first in _chunks(seq_offsets, k, CHUNK_BASES):
        got = _chunk_kmers(seq_codes, seq_offsets, k, lo, hi, first)
        if got is not None:
            yield got


def count_partitions(seq_codes: np.ndarray, seq_offsets: np.ndarray,
                     k: int, part_bits: int) -> np.ndarray:
    """Valid windows per partition (int64, 2^part_bits entries), exact:
    the first enumeration pass."""
    shift = np.uint64(2 * k - part_bits)
    counts = np.zeros(1 << part_bits, np.int64)
    for canon, _, _, _ in _windows(seq_codes, seq_offsets, k):
        counts += np.bincount((canon >> shift).astype(np.int64),
                              minlength=1 << part_bits)
    return counts


def count_total(seq_codes: np.ndarray, seq_offsets: np.ndarray,
                k: int) -> int:
    """Total valid k-mer windows, exact (the native count's value)."""
    return int(count_partitions(seq_codes, seq_offsets, k, 0)[0])


def scatter_partitions(seq_codes: np.ndarray, seq_offsets: np.ndarray,
                       k: int, part_bits: int, counts: np.ndarray,
                       txp_out: np.ndarray, pf_out: np.ndarray) -> None:
    """The second enumeration pass: each chunk's records (txp, pos << 1 |
    fwd) land in their partition's slice of txp_out / pf_out (sized
    counts.sum(); partition p from counts[:p].sum()), in (txp, pos)
    order within a partition."""
    shift = np.uint64(2 * k - part_bits)
    cursor = np.zeros(1 << part_bits, np.int64)
    np.cumsum(counts[:-1], out=cursor[1:])
    for canon, fwd, txp, pos in _windows(seq_codes, seq_offsets, k):
        # u16: numpy's stable sort is a radix sort up to 16 bits
        part = (canon >> shift).astype(np.uint16)
        del canon
        order = np.argsort(part, kind="stable")
        n_part = np.bincount(part, minlength=1 << part_bits)
        first = np.zeros_like(n_part)
        np.cumsum(n_part[:-1], out=first[1:])
        ps = part[order]
        dest = cursor[ps] + np.arange(ps.shape[0]) - first[ps]
        txp_out[dest] = txp[order]
        pf_out[dest] = (pos[order] << 1) | fwd[order]
        cursor += n_part


def sorted_partitions(seq_codes: np.ndarray, seq_offsets: np.ndarray,
                      k: int, counts: np.ndarray, txp: np.ndarray,
                      pf: np.ndarray):
    """Per partition, in ascending order: rebuild its keys from
    seq_codes at each record's (txp, pos), sort the partition's slice of
    txp / pf by key IN PLACE (stable), and yield (keys u64, txp view,
    pf view)."""
    seq_codes = np.asarray(seq_codes, np.uint8)
    seq_offsets = np.asarray(seq_offsets, np.int64)
    base = 0
    for n in counts.tolist():
        tx_p, pf_p = txp[base:base + n], pf[base:base + n]
        base += n
        g = seq_offsets[tx_p] + (pf_p >> 1)
        keys = np.zeros(n, np.uint64)
        for j in range(k):
            keys <<= np.uint64(2)
            keys |= seq_codes[g + j]
        del g
        rc = (pf_p & 1) == 0
        keys[rc] = revcomp_kmers(keys[rc], k)
        del rc
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        tx_p[:] = tx_p[order]
        pf_p[:] = pf_p[order]
        del order
        yield keys, tx_p, pf_p


def enumerate_sorted_partitioned(seq_codes: np.ndarray,
                                 seq_offsets: np.ndarray, k: int,
                                 part_bits: int):
    """Generator over (keys u64, txp i32, pf i32) per canonical top
    `part_bits` bits, ascending, each sorted by key with (txp, pos)
    order kept within a key; concatenated, the partitions are the whole
    sorted enumeration. pf = pos << 1 | fwd. The records live in two
    buffers at the exact total, which the yielded planes are views of."""
    counts = count_partitions(seq_codes, seq_offsets, k, part_bits)
    total = int(counts.sum())
    txp, pf = np.empty(total, np.int32), np.empty(total, np.int32)
    scatter_partitions(seq_codes, seq_offsets, k, part_bits, counts, txp,
                       pf)
    yield from sorted_partitions(seq_codes, seq_offsets, k, counts, txp, pf)


def enumerate_sorted(seq_codes: np.ndarray, seq_offsets: np.ndarray,
                     k: int) -> tuple:
    """Every canonical k-mer, sorted by k-mer (stable: records stay in
    (txp, pos) order): (kmers u64, txp i32, pos i32, fwd bool), as the
    native enumerate_sorted returns them."""
    (keys, txp, pf), = enumerate_sorted_partitioned(seq_codes, seq_offsets,
                                                     k, 0)
    return keys, txp, (pf >> 1).astype(np.int32), (pf & 1).astype(bool)
