"""Two-choice bucketized k-mer hash table, built on host, probed on device.

Replaces the reference's SSHash minimizer dictionary (external pufferfish;
see SURVEY.md §2.3). An MPHF is pointer-chasing and build-heavy; on the device we
want a branch-free, fixed-gather lookup. Design:

- the table is an array of BUCKETS of 4 compact slots. Every key has TWO
  candidate buckets (independent 32-bit mixes of its (hi, lo) planes);
  the build places it in its first bucket, falling back to the second on
  overflow (vectorized two-round placement). Lookup gathers BOTH bucket
  rows — two (8 x int32) ROW gathers per query — and 8 branch-free
  fingerprint compares select the hit. The 32-byte interleaved
  [fpcnt, start] bucket row is load-bearing twice over: 32 bytes is
  exactly this backend's efficient gather granule (8-wide i32 rows
  gather at ~3-15 ns/row while 16-wide rows jump to ~23 ns), and
  keeping each slot's CSR start IN the bucket row means the whole
  query — membership, count, AND occurrence offset — costs two row
  gathers total (the previous 8-slot/two-plane layout needed a third
  gather into a separate start plane, measured +50% lookup time at
  human scale where every random row fetch is ~15 ns of HBM latency).
- COMPACT 8-byte slots: (fpcnt, start) int32 pairs where fpcnt packs a
  16-bit key fingerprint with the 16-bit-saturated occurrence count, and
  start is the occurrence-CSR offset. The fingerprint comes from a THIRD
  independent mix — never from a bucket hash, whose low bits equal the
  bucket index at human-scale bucket counts and would collapse the
  in-bucket discrimination to a couple of bits. A ~1/65k false positive
  yields occurrences of a different k-mer, which the chaining filter and
  DP validation discard — the same grace the reference extends to
  multimapping noise.
- keys overflowing BOTH buckets (rare at the default load <= 0.62;
  4-slot buckets overflow more often than 8-slot ones but the kick
  walk below keeps the table total)
  are placed by DETERMINISTIC CUCKOO KICKS (bounded random-walk,
  host-side over the tiny tail) so the dictionary is total like the
  reference's pufferfish MPHF — a query for any indexed k-mer always
  resolves. Only walk exhaustion at extreme load still drops a key
  (recorded in n_evicted; practically zero below ~0.9 load).
- SHADOW RESOLUTION: lookup takes the FIRST fingerprint match in the
  8-slot probe window, so a stored key whose window contains an
  earlier slot with the same fingerprint would silently resolve to that
  other key's occurrences — a lost true seed (the reference's
  pufferfish lookups are exact: RefSeqConstructor validates hits
  against the sequence). The build detects every shadowed stored key
  (expected ~1.2e-4 of keys: 8 slots x 2^-16) and rewrites the
  shadowing slot to a MERGED occurrence block appended past the
  caller's CSR (resident's records first, then each shadowed key's;
  `appendix` segments). Every segment is preceded by a SEPARATOR
  record (txp = -1) carrying the segment key's 30-bit secondary
  fingerprint; the seed flow compares it against the query's
  fingerprint30 with one segment-carry scan over the gathered rows and
  masks foreign segments — so merged-slot lookups stay EXACT (to
  2^-30 conditional on a 2^-16 collision) with no extra gathers, and
  true hits are never lost (up to the downstream occ_cap gather
  truncation, which prefers the resident's records).

Build cost: the placement's radix sorts, then a few O(n) passes over the
placed keys (bucket rows, each key's first fingerprint match in its two
buckets, inlined records), all on the native library and, for the
shadow check, in bucket chunks, so that no per-key temporary spans a
genome-scale table. Half the HBM of the previous 2-slot-row
linear-probe layout at equal key count (312M-kmer human transcriptome:
~4.3 GB).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from salmon_tpu_torch.index import native_kmers

SLOTS_PER_BUCKET = 4


def split_u64(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split uint64 keys into (hi, lo) int32 planes (bit patterns)."""
    return ((keys >> np.uint64(32)).astype(np.uint32).view(np.int32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32))


def mix32(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """First bucket hash (murmur3 finalizer over the key planes).

    Must match the device-side implementation in salmon_tpu_torch.mapping.lookup.
    """
    hi = np.asarray(hi).astype(np.uint32)
    lo = np.asarray(lo).astype(np.uint32)
    x = lo ^ (hi * np.uint32(0x9E3779B9)) ^ np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def mix32b(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Second (alternate) bucket hash — independent constants."""
    hi = np.asarray(hi).astype(np.uint32)
    lo = np.asarray(lo).astype(np.uint32)
    x = hi ^ (lo * np.uint32(0x85EBCA77)) ^ np.uint32(0xC2B2AE3D)
    x ^= x >> np.uint32(17)
    x *= np.uint32(0xED5AD4BB)
    x ^= x >> np.uint32(11)
    x *= np.uint32(0xAC4C1B51)
    x ^= x >> np.uint32(15)
    return x


def fingerprint16(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """16-bit verification fingerprint from a third independent mix (no
    bit shared with either bucket index)."""
    hi = np.asarray(hi).astype(np.uint32)
    lo = np.asarray(lo).astype(np.uint32)
    x = hi ^ (lo * np.uint32(0xCC9E2D51)) ^ np.uint32(0x1B873593)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0xD168AAAD)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0xAF723597)
    x ^= x >> np.uint32(15)
    return (x >> np.uint32(16)).astype(np.uint32)


def fingerprint30(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """30-bit segment fingerprint (fourth independent mix) carried by
    the separator records of shadow-merged occurrence blocks; 30 bits so
    pos<<1 packing stays within int32. Device twin:
    salmon_tpu_torch.mapping.lookup.fingerprint30."""
    hi = np.asarray(hi).astype(np.uint32)
    lo = np.asarray(lo).astype(np.uint32)
    x = lo ^ (hi * np.uint32(0x27D4EB2F)) ^ np.uint32(0x165667B1)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return (x >> np.uint32(2)).astype(np.uint32)


@dataclasses.dataclass
class KmerHashTable:
    """Two-choice bucket table: canonical k-mer -> occurrence CSR range."""
    rows: np.ndarray         # (n_buckets, 8) int32: 4 x (fpcnt, start)
    n_slots: int             # total slots = n_buckets * 4 (power of two)
    max_probes: int = 2 * SLOTS_PER_BUCKET   # slots examined per query
    n_evicted: int = 0       # keys dropped (overflowed both buckets)
    # fingerprint-shadow merge segments: (m, 3) int64 rows
    # (src_start, src_len, sep_fp30). Each segment materializes as ONE
    # separator record (txp = -1, pos = sep_fp30, fwd = 0) followed by
    # `src_len` records copied from the caller's occurrence arrays at
    # `src_start`; segments are appended after the original CSR in
    # order (the merged slots already point there). Use appendix_plan()
    # to expand into per-row copy instructions.
    appendix: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), np.int64))
    n_shadowed: int = 0      # stored keys merged into a foreign slot
    # single-occurrence records inlined into their slot (start-lane
    # bit 31 set; payload47 = txp << 29 | pf across the count16 field +
    # the start lane's low 31 bits) — the query needs no CSR gather
    n_inlined: int = 0

    @property
    def n_buckets(self) -> int:
        return self.n_slots // SLOTS_PER_BUCKET

    @property
    def mask(self) -> int:
        return self.n_buckets - 1


def _rank_in_bucket(bucket: np.ndarray, counts: np.ndarray):
    """Per-key rank within its bucket, lowest occurrence count first
    (ties by input order). Returns the per-key rank aligned with the
    input order."""
    n = bucket.shape[0]
    order = np.lexsort((counts, bucket))
    b_sorted = bucket[order]
    run_start = np.ones(n, dtype=bool)
    if n:
        run_start[1:] = b_sorted[1:] != b_sorted[:-1]
    first_idx = np.maximum.accumulate(
        np.where(run_start, np.arange(n, dtype=np.int64), 0))
    rank_sorted = np.arange(n, dtype=np.int64) - first_idx
    rank = np.empty(n, dtype=np.int64)
    rank[order] = rank_sorted
    return rank


def _place_keys_numpy(b1: np.ndarray, b2: np.ndarray, counts: np.ndarray,
                      n_buckets: int) -> tuple:
    """Two-choice placement of the keys whose candidate buckets are b1
    and b2 (build_hash_table rounds 1-3): (slot_key (n_buckets, 4) int64,
    the key index per slot or -1, n_evicted). The plain version of
    native_kmers.table_place, equal to it slot for slot."""
    counts = np.asarray(counts, np.int64)
    # balanced first choice (power of two choices): each key
    # prefers the candidate bucket with lower total candidate
    # pressure, which evens bucket fills and collapses the
    # overflow tail
    cand1 = np.bincount(b1, minlength=n_buckets)
    cand2 = np.bincount(b2, minlength=n_buckets)
    prefer1 = cand1[b1] <= cand2[b2]
    first = np.where(prefer1, b1, b2)
    second = np.where(prefer1, b2, b1)

    # round 1: place in the preferred bucket, lowest-count keys win
    rank1 = _rank_in_bucket(first, counts)
    placed1 = rank1 < SLOTS_PER_BUCKET
    used = np.bincount(first[placed1], minlength=n_buckets)

    # round 2: overflow keys fall back to the alternate's remaining
    # capacity
    idx2 = np.nonzero(~placed1)[0]
    rank2 = _rank_in_bucket(second[idx2], counts[idx2])
    cap2 = SLOTS_PER_BUCKET - used
    placed2 = rank2 < cap2[second[idx2]]

    slot_key = np.full((n_buckets, SLOTS_PER_BUCKET), -1, np.int64)
    k1 = np.nonzero(placed1)[0]
    slot_key[first[k1], rank1[k1]] = k1
    k2 = idx2[placed2]
    slot2 = (used[second[k2]] + rank2[placed2]).astype(np.int64)
    slot_key[second[k2], slot2] = k2

    # round 3: deterministic cuckoo kicks for the overflow tail
    # (~1e-4 of keys at the default load) — the reference's
    # pufferfish dictionary is total, so routine evictions would
    # silently drop seeds; a bounded random-walk reduces evictions
    # to (practically) zero below ~0.9 load, with
    # drop-on-walk-exhaustion as the extreme-load fallback
    n_evicted = 0
    for u in idx2[~placed2]:
        key = int(u)
        done = False
        for t in range(64):
            for b in (int(b1[key]), int(b2[key])):
                free = np.nonzero(slot_key[b] < 0)[0]
                if free.size:
                    slot_key[b, free[0]] = key
                    done = True
                    break
            if done:
                break
            b = int(b1[key]) if t % 2 == 0 else int(b2[key])
            v = (key * 7 + t * 5 + 3) % SLOTS_PER_BUCKET
            victim = int(slot_key[b, v])
            slot_key[b, v] = key
            key = victim
        if not done:
            n_evicted += 1    # the last displaced key is dropped
    return slot_key, n_evicted


def _first_match_numpy(rows: np.ndarray, slot_key: np.ndarray,
                       fp_q: np.ndarray, *buckets: np.ndarray,
                       ent_base=None) -> list:
    """For each array of query buckets, (probe slot, placed-entry id) of
    the minimal-slot stored fingerprint match of each query in its
    bucket, or (8, -1): two binary searches a query over the held slots
    sorted by (bucket, fingerprint, slot). The plain version of
    native_kmers.table_first_match, equal to it element for element
    (`ent_base`, the native route's slot ranks, is not needed here)."""
    pbucket, pslot = np.nonzero(slot_key >= 0)
    fp_s = (rows[pbucket, 2 * pslot].view(np.uint32)
            >> np.uint32(16)).astype(np.uint64)
    packed = ((pbucket.astype(np.uint64) << np.uint64(20))
              | (fp_s << np.uint64(4)) | pslot.astype(np.uint64))
    order = np.argsort(packed)
    packed_s = packed[order]
    out = []
    for bucket_q in buckets:
        base = ((np.asarray(bucket_q).astype(np.uint64) << np.uint64(20))
                | (np.asarray(fp_q).astype(np.uint64) << np.uint64(4)))
        j = np.searchsorted(packed_s, base, side="left")
        j_end = np.searchsorted(packed_s, base + np.uint64(16),
                                side="left")
        hasm = j < j_end
        if not packed_s.size:
            out.append((np.full(j.shape, 2 * SLOTS_PER_BUCKET, np.int64),
                        np.full(j.shape, -1, np.int64)))
            continue
        jc = np.minimum(j, packed_s.shape[0] - 1)
        slot_q = np.where(
            hasm, (packed_s[jc] & np.uint64(15)).astype(np.int64),
            2 * SLOTS_PER_BUCKET)
        out.append((slot_q, np.where(hasm, order[jc], -1)))
    return out


# buckets a chunk of build_hash_table's passes over the placed keys
_CHUNK_BUCKETS = 1 << 20


def _placed_chunks(slot_key: np.ndarray):
    """(bucket, slot, key index, first placed-entry id) of the held
    slots, in chunks of _CHUNK_BUCKETS buckets, row-major: entry ids
    follow np.nonzero(slot_key >= 0)."""
    chunk = _CHUNK_BUCKETS
    ent0 = 0
    for b0 in range(0, slot_key.shape[0], chunk):
        sk = slot_key[b0:b0 + chunk]
        pbucket, pslot = np.nonzero(sk >= 0)
        pk = sk[pbucket, pslot].astype(np.int64)
        yield pbucket + b0, pslot, pk, ent0
        ent0 += pbucket.shape[0]


def _fill_rows_numpy(slot_key: np.ndarray, fpcnt: np.ndarray,
                     starts: np.ndarray) -> np.ndarray:
    """(fpcnt, start) of the key held in each slot as (n_buckets, 8)
    int32 rows. The plain version of native_kmers.table_fill_rows."""
    rows = np.zeros((slot_key.shape[0], 2 * SLOTS_PER_BUCKET), np.int32)
    for pbucket, pslot, pk, _ in _placed_chunks(slot_key):
        rows[pbucket, 2 * pslot] = fpcnt[pk]
        rows[pbucket, 2 * pslot + 1] = starts[pk]
    return rows


def _inline_numpy(rows: np.ndarray, slot_key: np.ndarray,
                  counts: np.ndarray, pay_counts: np.ndarray,
                  starts: np.ndarray, otx: np.ndarray, opf: np.ndarray,
                  fp: np.ndarray) -> int:
    """Slots of single-record keys rewritten in `rows` to hold the
    record (build_hash_table's inline_records); returns how many. The
    plain version of native_kmers.table_inline."""
    otx, opf = np.asarray(otx), np.asarray(opf)
    n_inlined = 0
    for pbucket, pslot, pk, _ in _placed_chunks(slot_key):
        # current count16 per placed slot: shadow-merge owners were
        # rewritten to block totals (>= 3), so requiring exactly 1
        # excludes them automatically
        cur_cnt = (rows[pbucket, 2 * pslot].view(np.uint32)
                   & np.uint32(0xFFFF))
        cand = ((cur_cnt == 1) & (counts[pk] == 1)
                & (pay_counts[pk] == 1))
        st = starts[pk].astype(np.int64)
        cand &= st < otx.shape[0]
        st = np.where(cand, st, 0)
        txr = otx[st].astype(np.int64)
        pfr = opf[st].astype(np.int64)
        cand &= (txr >= 0) & (txr < (1 << 18))
        cand &= (pfr >= 0) & (pfr < (1 << 29) - 1)
        payload_hi = (txr >> 2).astype(np.uint32)       # txp bits 2..17
        low31 = (((txr & 3).astype(np.uint32) << np.uint32(29))
                 | pfr.astype(np.uint32))
        fpcnt_new = (fp[pk] << np.uint32(16)) | payload_hi
        cand &= fpcnt_new != 0          # would read as an empty slot
        w = np.nonzero(cand)[0]
        rows[pbucket[w], 2 * pslot[w]] = fpcnt_new[w].view(np.int32)
        rows[pbucket[w], 2 * pslot[w] + 1] = (
            np.uint32(0x80000000) | low31[w]).view(np.int32)
        n_inlined += int(w.shape[0])
    return n_inlined


def table_n_slots(n_keys: int, load_factor: float = 0.5,
                  max_load_factor: float = 0.62) -> int:
    """Power-of-two slot count for `n_keys`: targets `load_factor` but
    halves while the load stays under `max_load_factor`."""
    h = 1 << max(6, int(np.ceil(np.log2(max(n_keys, 1) / load_factor))))
    while (h >= SLOTS_PER_BUCKET * 2
           and n_keys / (h // 2) <= max_load_factor):
        h //= 2
    return h


def build_hash_table(keys_u64: np.ndarray,
                     occ_offsets: np.ndarray | None = None,
                     load_factor: float = 0.5,
                     max_load_factor: float = 0.62,
                     n_slots: int | None = None,
                     filter_counts: np.ndarray | None = None,
                     counts: np.ndarray | None = None,
                     inline_records: tuple | None = None
                     ) -> KmerHashTable:
    """Build the two-choice bucket table for *unique* uint64 keys.

    occ_offsets: (n + 1,) CSR offsets aligned with the sorted-unique key
    order; slot payload becomes (start, count). When None, payload is
    (rank, 1) — the key's index in the input order.

    counts: explicit stored record counts per key — REQUIRED when the
    CSR is oct-aligned (pad records between keys make diff(occ_offsets)
    overcount); defaults to diff(occ_offsets).

    inline_records: (occ_txp, occ_pf) CSR planes. When given, slots of
    single-occurrence keys (the vast majority of a transcriptome) store
    the record ITSELF instead of a CSR pointer: start-lane bit 31 set,
    payload47 = txp << 29 | pf split across the count16 field (high 16)
    and the start lane's low 31 bits. Queries for such keys need no
    occurrence gather at all. Keys with txp >= 2^18, pf >= 2^29 - 1, a
    pruned true count > 1, or an all-zero encoded fpcnt lane (would
    read as an empty slot) stay pointer slots; shadow-merge owners
    always keep their block pointer (a count-1 key can never own a
    block, so this is automatic).

    filter_counts: per-key TRUE occurrence counts when the CSR was
    pruned at build time (--maxOccsKept): these feed the count16 slot
    payload so the query-time repetitive-seed filter
    (count <= max_occs_per_hit) still sees the real multiplicity; the
    stored offsets keep defining the gatherable record range.

    Sizing: the power-of-two slot count targets `load_factor` but is
    halved while the load stays under `max_load_factor` — a 312M-kmer
    human transcriptome lands at 2^29 slots = 2^27 buckets (4.3 GB).
    `n_slots` overrides the sizing (the sharded index forces one common
    size across shards so the stacked tables tile a mesh axis).
    """
    n = int(keys_u64.shape[0])
    h = n_slots or table_n_slots(n, load_factor, max_load_factor)
    n_buckets = h // SLOTS_PER_BUCKET
    hi, lo = split_u64(keys_u64)
    mask = np.uint32(n_buckets - 1)
    fp = fingerprint16(hi, lo)

    if occ_offsets is None:
        starts = np.arange(n, dtype=np.int32)
        counts = np.ones(n, dtype=np.int64)
    else:
        if int(occ_offsets[-1]) >= 2**31:
            # slot starts are int32 by design (8-byte device slots);
            # past 2^31 records the index must be built table-less and
            # quantified with --indexShards (per-shard local offsets)
            raise ValueError(
                f"{int(occ_offsets[-1])} occurrence records exceed the "
                "int32 slot-offset range; use a sharded index "
                "(--indexShards)")
        starts = occ_offsets[:-1].astype(np.int32)
        counts = (np.asarray(counts, np.int64) if counts is not None
                  else np.diff(occ_offsets))
    # `counts` (stored records) governs gatherable ranges: appendix
    # segment lengths and merged-block totals. `pay_counts` is what the
    # query-time repetitive filter compares — the TRUE multiplicity.
    pay_counts = (np.asarray(filter_counts, np.int64)
                  if filter_counts is not None else counts)

    # rounds 1-3 of the placement on the native library
    # (native_kmers.table_place); _place_keys_numpy is its plain version
    slot_key, n_evicted = native_kmers.table_place(keys_u64, counts,
                                                   n_buckets)

    counts16 = np.minimum(pay_counts, 0xFFFF).astype(np.uint32)
    fpcnt = ((fp << np.uint32(16)) | counts16).view(np.int32)
    del counts16

    # the bucket rows on the native library (_fill_rows_numpy is the
    # plain version)
    rows = native_kmers.table_fill_rows(slot_key, fpcnt, starts)

    # ---- fingerprint-shadow resolution (see module docstring) ----------
    # per shadowed key: its placed entry and key, and its owner's placed
    # entry, bucket and slot
    found = [[] for _ in range(5)]
    ent_base = native_kmers.table_slot_ranks(slot_key)
    for pbucket, pslot, pk, ent0 in _placed_chunks(slot_key):
        b1 = (mix32(hi[pk], lo[pk]) & mask).astype(np.int64)
        b2 = (mix32b(hi[pk], lo[pk]) & mask).astype(np.int64)
        own_pos = pslot + np.where(pbucket == b1, 0, SLOTS_PER_BUCKET)
        # the first stored fp match of each placed key in each of its
        # buckets, on the native library (_first_match_numpy is its
        # plain version)
        (s1q, e1q), (s2q, e2q) = native_kmers.table_first_match(
            rows, slot_key, fp[pk], b1, b2, ent_base=ent_base)
        pos2 = np.where(s2q < 2 * SLOTS_PER_BUCKET,
                        s2q + SLOTS_PER_BUCKET, 2 * SLOTS_PER_BUCKET)
        take1 = s1q <= pos2
        sh = np.nonzero(np.where(take1, s1q, pos2) < own_pos)[0]
        t1 = take1[sh]
        for out, part in zip(found, (
                sh + ent0, pk[sh], np.where(t1, e1q[sh], e2q[sh]),
                np.where(t1, b1[sh], b2[sh]),
                np.where(t1, s1q[sh], s2q[sh]))):
            out.append(part)
    sh_ent, sh_key, own_ent, own_b, own_s = (
        np.concatenate(part) if part else np.zeros(0, np.int64)
        for part in found)
    n_shadowed = int(sh_ent.shape[0])
    appendix = np.zeros((0, 3), np.int64)
    if n_shadowed:
        # group shadowed keys by owner entry, residents first
        grp = np.argsort(own_ent, kind="stable")
        own_sorted = own_ent[grp]
        sh_keys = sh_key[grp].astype(np.int64)
        gstart = np.ones(own_sorted.shape[0], bool)
        gstart[1:] = own_sorted[1:] != own_sorted[:-1]
        ob, os_ = own_b[grp][gstart], own_s[grp][gstart]
        res_keys = slot_key[ob, os_].astype(np.int64)
        # appendix segments: per owner block, a separator record
        # (carrying the segment key's 30-bit fingerprint) + the key's
        # range — resident first, then each shadowed key in
        # deterministic (key) order
        blk_of = np.cumsum(gstart) - 1
        n_blk = res_keys.shape[0]
        blk_total = (counts[res_keys] + np.bincount(
            blk_of, weights=counts[sh_keys].astype(np.float64),
            minlength=n_blk).astype(np.int64)
            + 1 + np.bincount(blk_of, minlength=n_blk))
        bounds = np.concatenate([np.nonzero(gstart)[0],
                                 [sh_keys.shape[0]]])
        seg_key = np.concatenate([
            np.concatenate([[res_keys[g]],
                            np.sort(sh_keys[bounds[g]:bounds[g + 1]])])
            for g in range(n_blk)]).astype(np.int64)
        appendix = np.stack([
            starts[seg_key].astype(np.int64), counts[seg_key],
            fingerprint30(hi[seg_key], lo[seg_key]).astype(np.int64)],
            axis=1)
        base_off = int(occ_offsets[-1]) if occ_offsets is not None \
            else n
        blk_start = base_off + np.concatenate(
            [[0], np.cumsum(blk_total)[:-1]]).astype(np.int64)
        # rewrite the owner slots to the merged blocks
        mcnt = np.minimum(blk_total, 0xFFFF).astype(np.uint32)
        rows[ob, 2 * os_] = ((fp[res_keys] << np.uint32(16))
                             | mcnt).view(np.int32)
        rows[ob, 2 * os_ + 1] = blk_start.astype(np.int32)

    n_inlined = 0
    if inline_records is not None:
        # on the native library (_inline_numpy is the plain version)
        n_inlined = native_kmers.table_inline(
            rows, slot_key, counts, pay_counts, starts, *inline_records, fp)

    return KmerHashTable(rows, h, 2 * SLOTS_PER_BUCKET, n_evicted,
                         appendix=appendix, n_shadowed=n_shadowed,
                         n_inlined=n_inlined)


def appendix_plan(tab: KmerHashTable):
    """Row-level expansion of the shadow-merge appendix.

    Returns (is_sep, src_idx, sep_fp30): for row r of the appended
    region, is_sep[r] selects a separator record (txp = -1,
    pos = sep_fp30[r], fwd = False); otherwise the row copies the
    caller's occurrence record at src_idx[r]. The merged slots already
    point past the original CSR end."""
    if tab.appendix.shape[0] == 0:
        z = np.zeros(0, np.int64)
        return np.zeros(0, bool), z, z
    src, ln, fp30 = (tab.appendix[:, 0], tab.appendix[:, 1],
                     tab.appendix[:, 2])
    row_len = ln + 1                       # sep + records per segment
    total = int(row_len.sum())
    seg_of = np.repeat(np.arange(ln.shape[0]), row_len)
    off_in_seg = (np.arange(total, dtype=np.int64)
                  - np.repeat(np.cumsum(row_len) - row_len, row_len))
    is_sep = off_in_seg == 0
    src_idx = np.where(is_sep, 0, src[seg_of] + off_in_seg - 1)
    return is_sep, src_idx, fp30[seg_of]

