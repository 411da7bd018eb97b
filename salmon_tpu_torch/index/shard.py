"""K-mer-range sharding of the occurrence index across devices.

Counterpart of salmon_tpu/index/shard.py (host numpy, no device code).
At genome-decoy scale (BASELINE config 5: human gencode + GRCh38 decoy,
~3.4 Gb of concatenated sequence) the occurrence CSR is ~3.2G records
and the bucket table another ~2^31 slots, past one device's memory. The
dictionary is therefore SHARDED:

  * every unique canonical k-mer has one OWNER shard, chosen by the top
    bits of its second bucket hash (mix32b, whose low bits the bucket
    indices use, so owner and in-shard placement stay independent);
  * each shard holds a complete two-choice bucket table over its own
    keys (a slot count common to all shards) and a contiguous local
    slice of the occurrence CSR; slot payloads point into the LOCAL
    slice, while the records keep global (transcript, position,
    orientation) coordinates;
  * at query time each device probes only its shard (parallel.sharded
    masks queries it does not own), expands its occurrences into the
    sparse seed flow's flat hit list, and the shards' hit lists are
    gathered before ranking.

A process may build only the shards it serves (`shards=`); the common
slot count comes from the populations of all shards, so a shard built
alone equals its row of the full build.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from salmon_tpu_torch.index import native_kmers
from salmon_tpu_torch.index.builder import TranscriptomeIndex
from salmon_tpu_torch.index.hashtable import (appendix_plan, build_hash_table,
                                              mix32b, split_u64,
                                              table_n_slots)


def shard_owner(hi: np.ndarray, lo: np.ndarray, shard_bits: int):
    """Owner shard of each key: the top `shard_bits` bits of the second
    bucket mix. Must match the device twin in parallel.sharded."""
    if shard_bits == 0:
        return np.zeros(np.shape(hi), np.uint32)
    return mix32b(hi, lo) >> np.uint32(32 - shard_bits)


@dataclasses.dataclass
class ShardedIndexArrays:
    """Stacked per-shard device planes (leading axis: the built shards,
    in the order of `shards`)."""
    n_shards: int
    shard_bits: int
    n_slots: int                 # per-shard table slots (common)
    tab_rows: np.ndarray         # (len(shards), n_buckets, 8) int32
    occ_oct: np.ndarray          # (len(shards), n_oct, 16) int32
    n_evicted: int
    shards: tuple = ()


def _shard_bits(n_shards: int) -> int:
    if n_shards < 1 or n_shards & (n_shards - 1):
        raise ValueError(f"n_shards must be a power of two, got {n_shards}")
    return int(n_shards).bit_length() - 1


def _with_appendix(tab, txp_s, pf_s):
    """A shard's occurrence planes plus its fingerprint-shadow merge
    blocks (hashtable doc)."""
    if not tab.n_shadowed:
        return txp_s, pf_s
    is_sep, gi, sep_fp = appendix_plan(tab)
    return (np.concatenate(
        [txp_s, np.where(is_sep, -1, txp_s[gi]).astype(np.int32)]),
        np.concatenate(
        [pf_s, np.where(is_sep, sep_fp << 1, pf_s[gi]).astype(np.int32)]))


def shard_index_arrays(idx: TranscriptomeIndex, n_shards: int,
                       shards=None) -> ShardedIndexArrays:
    """Partition the index's dictionary and occurrence CSR into
    `n_shards` (a power of two) self-contained shards and build those
    listed in `shards` (default: all). The occurrence plane is padded to
    the longest built shard; with every shard built, the planes equal
    the JAX package's shard_index_arrays."""
    shard_bits = _shard_bits(n_shards)
    shards = tuple(range(n_shards)) if shards is None else tuple(shards)
    hi, lo = split_u64(np.asarray(idx.kmers))
    owner = shard_owner(hi, lo, shard_bits).astype(np.int64)
    del hi, lo
    # NOT diff(offsets): the CSR may carry oct-alignment pads between
    # keys (diskfmt.oct_align_csr)
    counts = np.asarray(idx.occ_counts)
    pop = np.bincount(owner, minlength=n_shards)
    n_slots = table_n_slots(int(pop.max()) if pop.size else 1)

    occ_pf = np.asarray(idx.occ_pf)
    tabs, occ_parts = [], []
    n_evicted = 0
    for s in shards:
        m = owner == s
        keys_s = np.asarray(idx.kmers)[m]
        cnt_s = counts[m]
        off_s = np.zeros(cnt_s.shape[0] + 1, np.int64)
        np.cumsum(cnt_s, out=off_s[1:])
        total_s = int(off_s[-1])
        # contiguous local slice: global records gathered in shard key
        # order
        gidx = (np.repeat(np.asarray(idx.occ_offsets)[:-1][m], cnt_s)
                + np.arange(total_s, dtype=np.int64)
                - np.repeat(off_s[:-1], cnt_s))
        txp_s, pf_s = np.asarray(idx.occ_txp)[gidx], occ_pf[gidx]
        tab = build_hash_table(
            keys_s, occ_offsets=off_s, n_slots=n_slots,
            filter_counts=(np.asarray(idx.occ_true_counts)[m]
                           if idx.occ_true_counts is not None else None),
            inline_records=(txp_s, pf_s))
        occ_parts.append(_with_appendix(tab, txp_s, pf_s))
        n_evicted += tab.n_evicted
        tabs.append(tab)

    max_occ = max((t.shape[0] for t, _ in occ_parts), default=0)
    n_oct = max(-(-max_occ // 8), 1)
    occ_oct = np.zeros((len(shards), n_oct * 8, 2), np.int32)
    for i, (txp_s, pf_s) in enumerate(occ_parts):
        occ_oct[i, :txp_s.shape[0], 0] = txp_s
        occ_oct[i, :txp_s.shape[0], 1] = pf_s
    return ShardedIndexArrays(
        n_shards=n_shards, shard_bits=shard_bits, n_slots=n_slots,
        tab_rows=np.stack([t.rows for t in tabs]),
        occ_oct=occ_oct.reshape(len(shards), n_oct, 16),
        n_evicted=n_evicted, shards=shards)


# ---------------------------------------------------------------------------
# streamed sharding straight from the on-disk v5 planes (genome scale)
# ---------------------------------------------------------------------------

_STREAM_CHUNK = 1 << 27


def _stream_keys(index_dir: str, meta: dict, chunk: int = _STREAM_CHUNK):
    """Yield (start, keys_u64) chunks of the absolute sorted keys decoded
    from the v5 key plane (delta32, Elias-Fano or raw) without a
    full-size decode transient."""
    from salmon_tpu_torch.index import diskfmt

    def z(name):
        return np.load(os.path.join(index_dir, f"{name}.npy"),
                       mmap_mode="r")

    mode = meta.get("kmer_mode", "raw")
    if mode == "ef":
        yield from diskfmt.iter_keys_ef(
            {"ef_low": z("kmer_ef_low"), "ef_high": z("kmer_ef_high"),
             "ef_l": meta["kmer_ef_l"], "ef_n": meta["kmer_ef_n"]},
            chunk=chunk)
        return
    if mode != "delta32":
        km = z("kmers")
        for i in range(0, km.shape[0], chunk):
            yield i, np.asarray(km[i:i + chunk], np.uint64)
        return
    d32 = z("kmer_d32")
    esc_idx = np.asarray(z("kmer_esc_idx"))
    esc_val = np.asarray(z("kmer_esc_val"))
    n = d32.shape[0]
    carry = np.uint64(0)
    for i in range(0, n, chunk):
        j = min(i + chunk, n)
        d = np.asarray(d32[i:j]).astype(np.uint64)
        lo = np.searchsorted(esc_idx, i)
        hi = np.searchsorted(esc_idx, j)
        if hi > lo:
            d[esc_idx[lo:hi] - i] = esc_val[lo:hi]
        keys = np.cumsum(d, dtype=np.uint64)
        keys += carry
        carry = keys[-1]
        yield i, keys


def iter_shard_arrays(index_dir: str, n_shards: int,
                      load_factor: float = 0.7,
                      max_load_factor: float = 0.8, shards=None):
    """Generator over per-shard planes built straight from a saved v5
    table-less index: the genome-scale load path. It streams the key
    plane per shard and gathers each shard's occurrence slice from the
    memmapped occurrence plane, so peak host memory is one shard's
    arrays plus the shared counts/starts/owner planes, where
    shard_index_arrays needs the whole index loaded. The gathers run on
    the native library (native_kmers.gather_rows), as in the JAX
    package.

    Yields (shard_id, info.json dict, shard dict) for each shard of
    `shards` (default: all), where the shard dict has tab_rows
    (n_buckets, 8) int32, occ_txp / occ_pf (n_s,) int32 (with the
    shadow-merge appendix), n_slots, shard_bits, n_evicted and n_keys."""
    shard_bits = _shard_bits(n_shards)
    with open(os.path.join(index_dir, "info.json")) as fh:
        meta = json.load(fh)
    from salmon_tpu_torch.index import diskfmt

    def z(name):
        return np.load(os.path.join(index_dir, f"{name}.npy"),
                       mmap_mode="r")

    if os.path.exists(os.path.join(index_dir, "occ_pad8.npy")):
        raise ValueError(
            "iter_shard_arrays expects a table-less (unaligned) CSR; "
            "this index is oct-aligned — use shard_index_arrays after "
            "load_index")
    counts = diskfmt.unpack_counts(
        {"occ_cnt8": z("occ_cnt8"),
         "occ_cnt_esc_idx": z("occ_cnt_esc_idx"),
         "occ_cnt_esc_val": z("occ_cnt_esc_val")}).astype(np.int32)
    n = counts.shape[0]
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])

    # pass 1: owner per key (u8)
    owner = np.empty(n, np.uint8)
    for i, keys in _stream_keys(index_dir, meta):
        hi, lo = split_u64(keys)
        owner[i:i + keys.shape[0]] = shard_owner(
            hi, lo, shard_bits).astype(np.uint8)
    pop = np.bincount(owner, minlength=n_shards)
    n_slots = table_n_slots(int(pop.max()) if pop.size else 1,
                            load_factor, max_load_factor)

    # sparse true-count escapes (pruned indexes)
    tc_idx = tc_val = None
    if meta.get("has_true_counts"):
        tc_idx = np.asarray(z("occ_true_esc_idx"))
        tc_val = np.asarray(z("occ_true_esc_val"))

    occ48 = meta.get("occ_mode", "raw") == "occ48"
    if occ48:
        occ_packed = z("occ48")
    else:
        occ_txp_mm, occ_pf_mm = z("occ_txp"), z("occ_pf")

    for s in (range(n_shards) if shards is None else shards):
        ns = int(pop[s])
        keys_s = np.empty(ns, np.uint64)
        midx = np.empty(ns, np.int64)
        w = 0
        for i, keys in _stream_keys(index_dir, meta):
            m = owner[i:i + keys.shape[0]] == s
            k = int(m.sum())
            keys_s[w:w + k] = keys[m]
            midx[w:w + k] = np.nonzero(m)[0] + i
            w += k
        cnt_s = counts[midx].astype(np.int64)
        off_s = np.zeros(ns + 1, np.int64)
        np.cumsum(cnt_s, out=off_s[1:])
        total_s = int(off_s[-1])
        gidx = (np.repeat(starts[midx], cnt_s)
                + np.arange(total_s, dtype=np.int64)
                - np.repeat(off_s[:-1], cnt_s))
        if occ48:
            txp_s, pf_s = diskfmt.unpack_occ48(
                native_kmers.gather_rows(occ_packed, gidx),
                sep_halved=meta.get("occ48_sep_halved", False))
        else:
            txp_s = native_kmers.gather_rows(occ_txp_mm, gidx)
            pf_s = native_kmers.gather_rows(occ_pf_mm, gidx)
        del gidx
        tc_s = None
        if tc_idx is not None:
            pos = np.searchsorted(midx, tc_idx)
            sel = (pos < ns) & (midx[np.minimum(pos, ns - 1)] == tc_idx)
            if sel.any():
                tc_s = cnt_s.copy()
                tc_s[pos[sel]] = tc_val[sel]
        tab = build_hash_table(
            keys_s, occ_offsets=off_s, n_slots=n_slots,
            filter_counts=tc_s, inline_records=(txp_s, pf_s))
        del keys_s, midx
        txp_s, pf_s = _with_appendix(tab, txp_s, pf_s)
        yield s, meta, {
            "tab_rows": tab.rows, "occ_txp": txp_s, "occ_pf": pf_s,
            "n_slots": n_slots, "shard_bits": shard_bits,
            "n_evicted": tab.n_evicted, "n_keys": ns,
        }
