"""Host-side index construction (reference analog: `salmon index` —
src/index/BuildSalmonIndex.cpp + external pufferfish fixFasta/TwoPaCo/SSHash;
see SURVEY.md §2.3/§3.1).

Instead of a compacted de Bruijn graph + MPHF, the index is:
  canonical k-mer -> CSR occurrence list of (transcript, position, orient)
with a bounded-probe hash table for device lookup. This trades some memory
for a branch-free gather-only query path.

Decoy sequences (reference: --decoys / firstDecoyIndex semantics,
ReadExperiment.inl:156-158) are appended after valid targets and share the
same table; mapping-time decoy logic keys off txp_id >= first_decoy_index.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Optional

import numpy as np

logger = logging.getLogger("salmon_tpu_torch")

from salmon_tpu_torch.constants import DEFAULTS
from salmon_tpu_torch.index import native_kmers
from salmon_tpu_torch.index.hashtable import (KmerHashTable, build_hash_table,
                                        SLOTS_PER_BUCKET as
                                        HT_SLOTS_PER_BUCKET)
from salmon_tpu_torch.io.fasta import load_transcripts
from salmon_tpu_torch.utils import spans
from salmon_tpu_torch.utils.dna import canonical_kmers, kmers_of

# v4: 4-slot (n_buckets, 8) rows (v3 was 8-slot 16-wide);
# v5: same logical index, compact disk planes (index.diskfmt) — loader
# accepts both, writer emits v5
INDEX_FORMAT_VERSION = 5
LOADABLE_FORMAT_VERSIONS = (4, 5)


@dataclasses.dataclass
class TranscriptomeIndex:
    """The full on-host index; device planes are materialized by the mapper."""
    k: int
    names: list
    lengths: np.ndarray           # (T,) int32 post-polyA-clip lengths
    complete_lengths: np.ndarray  # (T,) int32 original lengths
    first_decoy_index: int        # T_valid; decoys occupy [T_valid, T)
    # unique canonical k-mers, sorted ascending (uint64)
    kmers: np.ndarray
    # CSR over unique k-mers (STORED records; see occ_true_counts).
    # occ_offsets[i] is key i's start, occ_offsets[-1] the total stored
    # record count. When the CSR is oct-aligned (diskfmt.oct_align_csr,
    # pad records between keys so no key's leading records straddle an
    # 8-record row), diff(occ_offsets) != per-key counts — use
    # occ_counts, which is always the stored count per key.
    occ_offsets: np.ndarray       # (n_kmers + 1,) int64
    occ_txp: np.ndarray           # (n_occs,) int32
    # pos << 1 | fwd — exactly the device occ_quad payload (fwd: the
    # transcript k-mer equals the canonical form); separator records of
    # shadow-merged blocks carry sep_fp30 << 1 here (hashtable doc)
    occ_pf: np.ndarray            # (n_occs,) int32
    table: KmerHashTable
    # per-base transcript codes 0..4, concatenated (DP extension / GC)
    seq_codes: np.ndarray         # (total_len,) uint8 codes
    seq_offsets: np.ndarray       # (T + 1,) int64
    info: dict
    # TRUE per-key occurrence counts when the stored CSR was pruned at
    # build time (--maxOccsKept); None = stored counts are true counts.
    # The repetitive-seed filter (max_occs_per_hit) must see these.
    occ_true_counts: np.ndarray | None = None
    # stored records per key; None in the constructor means the CSR is
    # dense (no alignment pads) and counts = diff(occ_offsets)
    occ_counts: np.ndarray | None = None

    def __post_init__(self):
        if self.occ_counts is None:
            self.occ_counts = np.diff(
                np.asarray(self.occ_offsets, np.int64))

    @property
    def num_targets(self) -> int:
        return len(self.names)

    @property
    def num_valid_targets(self) -> int:
        return self.first_decoy_index

    @property
    def occ_pos(self) -> np.ndarray:
        """Derived (cached) position plane — prefer occ_pf in new code."""
        c = getattr(self, "_occ_pos_cache", None)
        if c is None:
            c = (np.asarray(self.occ_pf) >> 1).astype(np.int32)
            object.__setattr__(self, "_occ_pos_cache", c)
        return c

    @property
    def occ_fwd(self) -> np.ndarray:
        """Derived (cached) orientation plane — prefer occ_pf."""
        c = getattr(self, "_occ_fwd_cache", None)
        if c is None:
            c = (np.asarray(self.occ_pf) & 1).astype(bool)
            object.__setattr__(self, "_occ_fwd_cache", c)
        return c

    def transcript_codes(self, i: int) -> np.ndarray:
        return self.seq_codes[self.seq_offsets[i]:self.seq_offsets[i + 1]]


def _pf_chunked(po: np.ndarray, fw: np.ndarray,
                chunk: int = 1 << 27) -> np.ndarray:
    """pos << 1 | fwd as int32, computed in bounded chunks (a whole-array
    int64 intermediate is a ~28 GB transient at genome scale)."""
    n = po.shape[0]
    pf = np.empty(n, np.int32)
    for i in range(0, n, chunk):
        j = min(i + chunk, n)
        pf[i:j] = ((po[i:j].astype(np.int64) << 1)
                   | fw[i:j]).astype(np.int32)
    return pf


def _counts_chunked(offsets: np.ndarray,
                    chunk: int = 1 << 27) -> np.ndarray:
    """diff(offsets) as int32 (per-key counts are far below 2^31); a
    plain np.diff allocates int64 — 26 GB at genome scale."""
    n = offsets.shape[0] - 1
    out = np.empty(n, np.int32)
    for i in range(0, n, chunk):
        j = min(i + chunk, n)
        out[i:j] = (offsets[i + 1:j + 1] - offsets[i:j]).astype(np.int32)
    return out


PARTITIONED_BUILD_BASES = 1_500_000_000   # switch to the partitioned build
TABLE_DIRECT_MAX_KEYS = 800_000_000       # past this, tables are per-shard


def _enumerate_sorted_records(seq_codes: np.ndarray,
                              seq_offsets: np.ndarray, k: int) -> tuple:
    """Plain version of native_kmers.enumerate_sorted: each record's
    canonical k-mers in numpy, then one stable sort by k-mer (records stay
    in (txp, pos) order within a k-mer). Returns (kmers u64, txp i32, pos
    i32, fwd bool)."""
    all_kmers, all_txp, all_pos, all_fwd = [], [], [], []
    for tid in range(seq_offsets.shape[0] - 1):
        kms, valid_mask = kmers_of(
            seq_codes[seq_offsets[tid]:seq_offsets[tid + 1]], k)
        if kms.shape[0] == 0:
            continue
        canon, fwd = canonical_kmers(kms, k)
        canon = canon[valid_mask]
        fwd = fwd[valid_mask]
        pos = np.nonzero(valid_mask)[0].astype(np.int32)
        all_kmers.append(canon)
        all_txp.append(np.full(canon.shape[0], tid, dtype=np.int32))
        all_pos.append(pos)
        all_fwd.append(fwd)

    if all_kmers:
        km = np.concatenate(all_kmers)
        tx = np.concatenate(all_txp)
        po = np.concatenate(all_pos)
        fw = np.concatenate(all_fwd)
    else:
        km = np.zeros(0, dtype=np.uint64)
        tx = po = np.zeros(0, dtype=np.int32)
        fw = np.zeros(0, dtype=bool)

    # stable sort keeps (txp,pos) order within a k-mer
    order = np.argsort(km, kind="stable")
    km, tx, po, fw = km[order], tx[order], po[order], fw[order]
    return km, tx, po, fw


def build_index(
    transcripts_path: str,
    k: int = DEFAULTS.kmer_len,
    decoys_path: Optional[str] = None,
    decoy_names_path: Optional[str] = None,
    gencode: bool = False,
    keep_duplicates: bool = True,
    noclip_polya: bool = False,
    partition_bits: Optional[int] = None,
    max_occs_kept: int = 0,
) -> TranscriptomeIndex:
    """Build the index from a transcript FASTA (+ optional decoy FASTA).

    Reference CLI contract: k odd and <= 31 (BuildSalmonIndex.cpp:70-100).
    `decoy_names_path` mimics `-d decoys.txt` with a combined FASTA: names
    listed there are treated as decoys (they must come last).

    Genome-decoy scale (BASELINE config 5, 3 Gb+ of concatenated
    input): the enumeration runs per canonical top-bits partition
    (`partition_bits`, 6 from PARTITIONED_BUILD_BASES on, else 0) with
    partition-sized buffers (native_kmers), and past TABLE_DIRECT_MAX_KEYS no
    monolithic hash table is built: such indexes are quantified with
    --indexShards, which builds self-contained per-shard tables.
    """
    if k % 2 == 0 or k > 31 or k < 5:
        raise ValueError(f"k must be odd and in [5, 31], got {k}")

    records, info = load_transcripts(
        transcripts_path, gencode=gencode, keep_duplicates=keep_duplicates,
        noclip_polya=noclip_polya)
    decoy_names: set = set()
    if decoy_names_path:
        with open(decoy_names_path) as fh:
            decoy_names = {ln.strip() for ln in fh if ln.strip()}
    # order: valid targets first, then decoys (reference firstDecoyIndex)
    valid = [r for r in records if r.name not in decoy_names]
    decoy = [r for r in records if r.name in decoy_names]
    if decoys_path:
        drecs, dinfo = load_transcripts(decoys_path, gencode=gencode,
                                        noclip_polya=noclip_polya)
        decoy.extend(drecs)
        info["DecoySeqHash"] = dinfo["SeqHash"]
        info["DecoyNameHash"] = dinfo["NameHash"]
        del drecs
    records = valid + decoy
    first_decoy_index = len(valid)

    names = [r.name for r in records]
    lengths = np.array([r.seq_codes.shape[0] for r in records],
                       dtype=np.int32)
    complete_lengths = np.array([r.complete_length for r in records],
                                dtype=np.int32)

    seq_offsets = np.zeros(len(records) + 1, dtype=np.int64)
    seq_offsets[1:] = np.cumsum(lengths.astype(np.int64))
    seq_codes = (np.concatenate([r.seq_codes for r in records])
                 if records else np.zeros(0, dtype=np.uint8))

    # --- enumerate (canonical kmer, txp, pos, fwd), sorted by k-mer ------
    if partition_bits is None:
        partition_bits = 6 if int(seq_offsets[-1]) >= \
            PARTITIONED_BUILD_BASES else 0
    if not 0 <= partition_bits <= 16:
        raise ValueError(f"partition_bits must be in [0, 16], got "
                         f"{partition_bits}")
    if partition_bits:
        complete_lengths_l = [r.complete_length for r in records]
        # free the per-record sequence copies before the partitioned
        # passes: seq_codes holds the concatenation
        del records, valid, decoy
        return _build_partitioned(names, complete_lengths_l, info, k,
                                  first_decoy_index, seq_codes,
                                  seq_offsets, partition_bits,
                                  keep_duplicates, max_occs_kept)
    # OpenMP enumeration + parallel radix sort on the native library;
    # _enumerate_sorted_records is its plain version
    t0 = time.perf_counter()
    km, tx, po, fw = native_kmers.enumerate_sorted(seq_codes, seq_offsets, k)
    t1 = time.perf_counter()
    uniq, starts = np.unique(km, return_index=True)
    offsets = np.concatenate([starts.astype(np.int64),
                              np.array([km.shape[0]], dtype=np.int64)])

    true_counts = None
    if max_occs_kept:
        from salmon_tpu_torch.index.diskfmt import prune_occurrences
        offsets, (tx, po, fw), tc = prune_occurrences(
            offsets, (tx, po, fw), max_occs_kept)
        if int(tc.max(initial=0)) > max_occs_kept:
            true_counts = tc
    # oct-align so no key's leading records straddle an 8-record row:
    # the dense expand serves every ordinary window from ONE row gather
    # (pads: txp = -1, masked like separator records)
    from salmon_tpu_torch.index.diskfmt import oct_align_csr
    counts_kept = _counts_chunked(offsets)
    offsets, (tx, po, fw) = oct_align_csr(
        offsets, (tx, po, fw), (np.int32(-1), np.int32(0), False))
    info["occ_oct_aligned"] = True
    t2 = time.perf_counter()
    clocks = {"index_enumerate_seconds": t1 - t0,
              "index_csr_seconds": t2 - t1}
    # logged before the table too, so that a build cut short there
    # still tells its earlier stages' seconds
    logger.info("flat build: enumeration %.3f s, CSR %.3f s; placing %d "
                "keys", t1 - t0, t2 - t1, uniq.shape[0])
    table = build_hash_table(
        uniq, occ_offsets=offsets, counts=counts_kept,
        filter_counts=true_counts,
        inline_records=(tx, ((po.astype(np.int64) << 1) | fw)
                        .astype(np.int32)))
    clocks["index_table_seconds"] = time.perf_counter() - t2
    logger.info("flat build clocks: %s", clocks, extra={"clocks": clocks})
    info["table_inline_singles"] = True
    if table.n_shadowed:
        # fingerprint-shadow merge blocks: append the merged slots'
        # occurrence records + separators past the CSR (hashtable doc)
        from salmon_tpu_torch.index.hashtable import appendix_plan
        is_sep, gi, sep_fp = appendix_plan(table)
        tx = np.concatenate([tx, np.where(is_sep, -1, tx[gi])
                             .astype(np.int32)])
        po = np.concatenate([po, np.where(is_sep, sep_fp, po[gi])
                             .astype(np.int32)])
        fw = np.concatenate([fw, np.where(is_sep, False, fw[gi])])

    info.update({
        "index_format_version": INDEX_FORMAT_VERSION,
        "k": k,
        "num_targets": len(records),
        "num_decoys": len(records) - first_decoy_index,
        "num_kmers": int(uniq.shape[0]),
        "num_occurrences": int(tx.shape[0]),  # incl. shadow-merge appendix
        "keep_duplicates": keep_duplicates,
        "max_occs_kept": int(max_occs_kept),
    })
    pf = _pf_chunked(po, fw)
    del po, fw
    return TranscriptomeIndex(
        k=k, names=names, lengths=lengths,
        complete_lengths=complete_lengths,
        first_decoy_index=first_decoy_index,
        kmers=uniq, occ_offsets=offsets, occ_txp=tx, occ_pf=pf,
        table=table, seq_codes=seq_codes, seq_offsets=seq_offsets,
        info=info, occ_true_counts=true_counts,
        occ_counts=counts_kept)


def _build_partitioned(names, complete_lengths_l, info, k,
                       first_decoy_index, seq_codes,
                       seq_offsets, partition_bits,
                       keep_duplicates,
                       max_occs_kept: int = 0) -> TranscriptomeIndex:
    """Memory-bounded build: per canonical-top-bits partition, enumerate,
    sort and extract unique keys on the native library
    (native_kmers.enumerate_sorted_partitioned; index.kmer_enum is its
    plain version), writing into buffers at the exact record count (the
    native count). Output is bit-identical to the flat path; only peak
    memory differs (partition-sized sort buffers instead of whole-input
    ones). Logs as clocks the seconds of the count, the enumeration (the
    partitions' enumeration, sort and decode), the CSR (the copies and
    unique keys) and the table, if one is built."""
    lengths = np.diff(seq_offsets).astype(np.int32)
    complete_lengths = np.array(complete_lengths_l, np.int32)
    t0 = time.perf_counter()
    total = native_kmers.count_total(seq_codes, seq_offsets, k)
    t1 = time.perf_counter()
    logger.info("partitioned index build: %d records over %d partitions",
                total, 1 << partition_bits)
    # the record planes, and unique-key buffers at the record-count upper
    # bound (trimmed by view at the end), are allocated once the first
    # partition is out: an enumeration may hold whole-input scratch
    # before it (the plain version's scatter pass)
    tx = pf = uniq_buf = off_buf = None
    base = 0
    nu = 0
    t_enum = 0.0
    parts = native_kmers.enumerate_sorted_partitioned(
        seq_codes, seq_offsets, k, partition_bits)
    while True:
        t = time.perf_counter()
        part = next(parts, None)
        t_enum += time.perf_counter() - t
        if tx is None:
            tx, pf = np.empty(total, np.int32), np.empty(total, np.int32)
            uniq_buf = np.empty(total, np.uint64)
            off_buf = np.empty(total + 1, np.int64)
        if part is None:
            break
        kmp, txp_, pfp_ = part
        n = kmp.shape[0]
        if not n:
            continue
        tx[base:base + n] = txp_
        pf[base:base + n] = pfp_
        up, sp = np.unique(kmp, return_index=True)
        m = up.shape[0]
        uniq_buf[nu:nu + m] = up
        off_buf[nu:nu + m] = sp.astype(np.int64) + base
        nu += m
        base += n
        del part, kmp, txp_, pfp_
    off_buf[nu] = total
    uniq = uniq_buf[:nu]
    offsets = off_buf[:nu + 1]
    clocks = {"index_count_seconds": t1 - t0,
              "index_enumerate_seconds": t_enum,
              "index_csr_seconds": time.perf_counter() - t1 - t_enum}

    true_counts = None
    if max_occs_kept:
        from salmon_tpu_torch.index.diskfmt import prune_occurrences
        offsets, (tx, pf), tc = prune_occurrences(
            offsets, (tx, pf), max_occs_kept)
        if int(tc.max(initial=0)) > max_occs_kept:
            true_counts = tc
        logger.info("pruned occurrence CSR to <= %d records/key: "
                    "%d -> %d records", max_occs_kept, total,
                    int(offsets[-1]))

    counts_kept = _counts_chunked(offsets)
    if nu <= TABLE_DIRECT_MAX_KEYS:
        # oct-align only when a monolithic table exists: the dense
        # expand is the only consumer of alignment, and table-less
        # (--indexShards-only) indexes would pay the pad plane on disk
        # for nothing
        from salmon_tpu_torch.index.diskfmt import oct_align_csr
        offsets, (tx, pf) = oct_align_csr(
            offsets, (tx, pf), (np.int32(-1), np.int32(0)))
        info["occ_oct_aligned"] = True
        t3 = time.perf_counter()
        table = build_hash_table(
            uniq, occ_offsets=offsets, counts=counts_kept,
            filter_counts=true_counts, inline_records=(tx, pf))
        clocks["index_table_seconds"] = time.perf_counter() - t3
        info["table_inline_singles"] = True
        if table.n_shadowed:
            from salmon_tpu_torch.index.hashtable import appendix_plan
            is_sep, gi, sep_fp = appendix_plan(table)
            tx = np.concatenate([tx, np.where(is_sep, -1, tx[gi])
                                 .astype(np.int32)])
            pf = np.concatenate([pf, np.where(is_sep, sep_fp << 1,
                                              pf[gi]).astype(np.int32)])
    else:
        table = None
        info["requires_shards"] = True
        logger.info("index has %d keys: skipping the monolithic table "
                    "(quantify with --indexShards; per-shard tables are "
                    "built at load)", nu)
    logger.info("partitioned build clocks: %s", clocks,
                extra={"clocks": clocks})

    info.update({
        "index_format_version": INDEX_FORMAT_VERSION,
        "k": k,
        "num_targets": len(names),
        "num_decoys": len(names) - first_decoy_index,
        "num_kmers": int(nu),
        "num_occurrences": int(tx.shape[0]),  # incl. shadow-merge appendix
        "keep_duplicates": keep_duplicates,
        "max_occs_kept": int(max_occs_kept),
    })
    return TranscriptomeIndex(
        k=k, names=names, lengths=lengths,
        complete_lengths=complete_lengths,
        first_decoy_index=first_decoy_index,
        kmers=uniq, occ_offsets=offsets, occ_txp=tx, occ_pf=pf,
        table=table, seq_codes=seq_codes,
        seq_offsets=seq_offsets, info=info,
        occ_true_counts=true_counts, occ_counts=counts_kept)


def save_index(idx: TranscriptomeIndex, out_dir: str) -> None:
    """One raw .npy per array: multi-GB members load with mmap_mode='r'
    (lazy page-in; arrays the caller never touches are never read),
    where a .npz member access always costs a full eager copy. zlib
    compression is skipped outright — it costs tens of minutes
    single-threaded on the occurrence arrays."""
    os.makedirs(out_dir, exist_ok=True)
    from salmon_tpu_torch.index import diskfmt

    # write-as-you-pack: each encoded plane is saved and freed before
    # the next is built, and the multi-GB planes stream through chunked
    # memmapped writers — genome-scale saves stay within ~10 GB of the
    # index's own footprint (a collect-then-write dict OOMed at 130 GB)
    def w(name, arr):
        np.save(os.path.join(out_dir, f"{name}.npy"), arr)

    w("lengths", idx.lengths)
    w("complete_lengths", idx.complete_lengths)
    w("table_rows", (idx.table.rows if idx.table is not None
                     else np.zeros((0, 8), np.int32)))
    w("seq_offsets", idx.seq_offsets)
    if diskfmt.occ48_applicable(idx.occ_txp, idx.occ_pf):
        occ_mode = "occ48"     # 6 B/record instead of 8
        idx.info["occ48_sep_halved"] = True   # r5 separator encoding
        diskfmt.write_occ48_npy(out_dir, idx.occ_txp, idx.occ_pf)
    else:
        occ_mode = "raw"
        w("occ_txp", idx.occ_txp)
        w("occ_pf", idx.occ_pf)
    kmer_mode, kmer_extra = diskfmt.write_keys_npy(
        out_dir, np.asarray(idx.kmers))
    idx.info.update(kmer_extra)
    counts = np.asarray(idx.occ_counts)
    for name, arr in diskfmt.pack_counts(counts).items():
        w(name, arr)
    # alignment pads (0..7) reconstruct the padded starts at load:
    # pads[i] = start[i] - (start[i-1] + counts[i-1]); table-less CSRs
    # are never aligned — skip even the transient
    off = np.asarray(idx.occ_offsets, np.int64)
    if idx.info.get("occ_oct_aligned") and off.shape[0] > 1:
        prev_end = np.concatenate([[0], off[:-2] + counts[:-1]])
        pads = (off[:-1] - prev_end).astype(np.uint8)
        # unaligned (table-less) CSRs have no pads — skip the plane
        if pads.any():
            w("occ_pad8", pads)
        del prev_end, pads
    for name, arr in diskfmt.pack_seq2(idx.seq_codes).items():
        w(name, arr)
    if idx.occ_true_counts is not None:
        # sparse exceptions: keys whose TRUE count differs from stored
        exc = np.nonzero(np.asarray(idx.occ_true_counts) != counts)[0]
        w("occ_true_esc_idx", exc.astype(np.int64))
        w("occ_true_esc_val",
          np.asarray(idx.occ_true_counts)[exc].astype(np.int64))
    meta = dict(idx.info)
    meta.update({
        "index_format_version": INDEX_FORMAT_VERSION,
        "k": idx.k,
        "first_decoy_index": idx.first_decoy_index,
        "kmer_mode": kmer_mode,
        "occ_mode": occ_mode,
        "has_true_counts": idx.occ_true_counts is not None,
        "table_n_slots": (idx.table.n_slots if idx.table is not None
                          else 0),
        "table_max_probes": (idx.table.max_probes
                             if idx.table is not None else 0),
    })
    with open(os.path.join(out_dir, "info.json"), "w") as fh:
        json.dump(meta, fh, indent=2, default=str)
    with open(os.path.join(out_dir, "ref_names.txt"), "w") as fh:
        fh.write("\n".join(idx.names) + ("\n" if idx.names else ""))


def _load_table(index_dir, meta, rows):
    if not int(meta.get("table_n_slots", 0)):
        return None
    n_slots = int(meta["table_n_slots"])
    want = (n_slots // HT_SLOTS_PER_BUCKET, 2 * HT_SLOTS_PER_BUCKET)
    if tuple(rows.shape) != want:
        raise ValueError(
            f"index at {index_dir}: table_rows shape "
            f"{tuple(rows.shape)} does not match the "
            f"{HT_SLOTS_PER_BUCKET}-slot bucket geometry {want}; "
            f"please rebuild")
    return KmerHashTable(rows=rows, n_slots=n_slots,
                         max_probes=int(meta["table_max_probes"]))


def load_index(index_dir: str) -> TranscriptomeIndex:
    """The index at `index_dir`: raw planes memory-mapped, packed ones
    decoded. Spans: index.load, and inside it index.load.<plane> for
    each plane that is decoded (mapped planes are read at first use)."""
    with spans.span("index.load"):
        return _load_index(index_dir)


def _load_index(index_dir: str) -> TranscriptomeIndex:
    with open(os.path.join(index_dir, "info.json")) as fh:
        meta = json.load(fh)
    ver = meta.get("index_format_version")
    if ver not in LOADABLE_FORMAT_VERSIONS:
        raise ValueError(
            f"index at {index_dir} has format version {ver}, expected "
            f"one of {LOADABLE_FORMAT_VERSIONS}; please rebuild")
    with open(os.path.join(index_dir, "ref_names.txt")) as fh:
        names = [ln.rstrip("\n") for ln in fh if ln.rstrip("\n")]

    def z(name):
        # raw .npy per array: mmap so untouched planes never hit disk
        return np.load(os.path.join(index_dir, f"{name}.npy"),
                       mmap_mode="r")

    if ver == 4:
        # v4 raw layout: derive pf from the pos/fwd planes
        pf = ((z("occ_pos").astype(np.int64) << 1)
              | z("occ_fwd")).astype(np.int32)
        return TranscriptomeIndex(
            k=int(meta["k"]), names=names, lengths=z("lengths"),
            complete_lengths=z("complete_lengths"),
            first_decoy_index=int(meta["first_decoy_index"]),
            kmers=z("kmers"), occ_offsets=z("occ_offsets"),
            occ_txp=z("occ_txp"), occ_pf=pf,
            table=_load_table(index_dir, meta, z("table_rows")),
            seq_codes=z("seq_codes"), seq_offsets=z("seq_offsets"),
            info=meta)

    from salmon_tpu_torch.index import diskfmt
    kmer_mode = meta.get("kmer_mode", "raw")
    with spans.span("index.load.kmers"):
        if kmer_mode == "raw":
            kmers = z("kmers")
        elif kmer_mode == "ef":
            kmers = diskfmt.unpack_keys(
                {"mode": "ef", "ef_low": z("kmer_ef_low"),
                 "ef_high": z("kmer_ef_high"),
                 "ef_l": meta["kmer_ef_l"], "ef_n": meta["kmer_ef_n"]})
        else:
            kmers = diskfmt.unpack_keys(
                {"mode": kmer_mode, "kmer_d32": z("kmer_d32"),
                 "kmer_esc_idx": z("kmer_esc_idx"),
                 "kmer_esc_val": z("kmer_esc_val")})
    with spans.span("index.load.counts"):
        counts = diskfmt.unpack_counts(
            {"occ_cnt8": z("occ_cnt8"),
             "occ_cnt_esc_idx": z("occ_cnt_esc_idx"),
             "occ_cnt_esc_val": z("occ_cnt_esc_val")})
        n = counts.shape[0]
        pad_path = os.path.join(index_dir, "occ_pad8.npy")
        pads = (np.asarray(z("occ_pad8"), np.int64)
                if os.path.exists(pad_path) else np.zeros(n, np.int64))
        cs = np.cumsum(counts + pads)
        occ_offsets = np.empty(n + 1, np.int64)
        occ_offsets[:-1] = cs - counts            # padded starts
        occ_offsets[-1] = cs[-1] if n else 0
    with spans.span("index.load.seq"):
        seq_codes = diskfmt.unpack_seq2(
            {"seq2": z("seq2"), "seq2_n": z("seq2_n"),
             "seq2_len": np.load(os.path.join(index_dir, "seq2_len.npy"))})
    true_counts = None
    if meta.get("has_true_counts"):
        with spans.span("index.load.true_counts"):
            true_counts = counts.copy()
            true_counts[z("occ_true_esc_idx")] = z("occ_true_esc_val")
    with spans.span("index.load.occ"):
        if meta.get("occ_mode", "raw") == "occ48":
            occ_txp, occ_pf = diskfmt.unpack_occ48(
                z("occ48"), sep_halved=meta.get("occ48_sep_halved", False))
        else:
            occ_txp, occ_pf = z("occ_txp"), z("occ_pf")
    return TranscriptomeIndex(
        k=int(meta["k"]), names=names, lengths=z("lengths"),
        complete_lengths=z("complete_lengths"),
        first_decoy_index=int(meta["first_decoy_index"]),
        kmers=kmers, occ_offsets=occ_offsets,
        occ_txp=occ_txp, occ_pf=occ_pf,
        table=_load_table(index_dir, meta, z("table_rows")),
        seq_codes=seq_codes, seq_offsets=z("seq_offsets"),
        info=meta, occ_true_counts=true_counts, occ_counts=counts)
