"""The port's native host library (salmon_tpu_torch/_native.py over
csrc/{bamreader,fastqreader,kmersort,alnweights}.cpp) against the
port's plain versions and the JAX package's functions, on inputs made
with numpy from a seed.

Integer outputs (BAM batches, padded grids, FASTQ chunks, k-mers and
their records, slot placements, pads, gathered rows, eq labels, best
alignments) must be equal. Floats: alignment-mode eq weights within
rtol 1e-5 of the numpy branch (the native pass sums a fragment's
weights in float64 and rounds once, numpy rounds each weight to float32
first), posteriors and the FLD histogram within rtol 1e-12 (the same
float64 sums in another order), and equal to the JAX package's native
pass to the bit where its order is the same (eq weights, posteriors).
"""

import gzip
import os
import struct
import tracemalloc

import numpy as np
import pytest

from salmon_tpu.alignment import alnweights as jaln
from salmon_tpu.alignment import bamio as jbam
from salmon_tpu.alignment import errormodel_device as jerr
from salmon_tpu.index import native_kmers as jnative
from salmon_tpu.io import fastq as jfastq
from salmon_tpu_torch.alignment import alnweights, bamio
from salmon_tpu_torch.alignment import errormodel_device as terr
from salmon_tpu_torch.alignment import quant as tquant
from salmon_tpu_torch.index import builder, diskfmt, hashtable, kmer_enum
from salmon_tpu_torch.index import native_kmers
from salmon_tpu_torch.io import fastq
from test_torch_bamio import (decode, mixed_records, targets,
                              truth_records)

INVALID_TXP = 0x7FFFFFFF


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    """Paired truth pairs, their single-end read 1 and mixed CIGARs (more
    than 16 ops, indels, clips, unmapped records, and spliced records
    whose N runs overflow the error model's columns), written by the JAX
    package's writer."""
    names, lens, seqs = targets()
    rng = np.random.default_rng(3)
    spliced = []
    for i in range(40):
        t = int(np.argmax(lens))
        pos = int(rng.integers(0, lens[t] - 400))
        seq = np.concatenate([seqs[t][pos:pos + 30],
                              seqs[t][pos + 330:pos + 360]])
        spliced.append(dict(name=f"s{i}", refid=t, pos=pos, flag=0,
                            cigar="30M300N30M", seq=decode(seq),
                            tags={"AS": 120, "NM": 0}))
    d = tmp_path_factory.mktemp("native_bams")
    out = {}
    for kind, recs in (("paired", truth_records()),
                       ("single", truth_records(paired=False)),
                       ("mixed", mixed_records() + spliced)):
        out[kind] = str(d / f"{kind}.bam")
        jbam.write_bam(out[kind], names, lens, recs)
    return out


def _n_bgzf_blocks(path):
    with open(path, "rb") as fh:
        data = fh.read()
    n = i = 0
    while i < len(data):
        i += struct.unpack_from("<H", data, i + 16)[0] + 1
        n += 1
    return n


BAM_FIELDS = ("refid", "pos", "flag", "mapq", "mate_refid", "mate_pos",
              "tlen", "read_len", "seq_off", "cigar_off", "cigar_n",
              "as_tag", "nm_tag", "name_hash", "seq_buf", "cigar_op",
              "cigar_oplen")


def _assert_bam_batches(got, want):
    """got's arrays hold its own records only; want's may be longer."""
    assert got.n == want.n
    for f in BAM_FIELDS:
        g = getattr(got, f)
        np.testing.assert_array_equal(g, getattr(want, f)[:g.size], f)
    np.testing.assert_array_equal(got.zw_tag, want.zw_tag[:got.n])
    assert (got.names is None) == (want.names is None)
    if got.names is not None:
        assert list(got.names) == list(want.names)[:got.n]


@pytest.mark.parametrize("names", [True, False], ids=["names", "nonames"])
@pytest.mark.parametrize("kind", ["paired", "single", "mixed"])
def test_bam_reader_matches_plain_and_jax(bams, kind, names):
    """Batch for batch, at a cap that puts boundaries inside read-name
    groups: the native reader equals the port's _PyBam, and the JAX
    package's native reader and _PyBam."""
    path = bams[kind]
    cap = 64 if kind == "mixed" else 1000
    assert _n_bgzf_blocks(path) >= (20 if kind == "paired" else 2)
    rdr = bamio.BamReader(path, batch_records=cap, want_names=names)
    got = list(rdr.batches())
    plain = bamio._PyBam(path)
    assert (rdr.ref_names, rdr.header_text) == \
        (plain.ref_names, plain.header_text)
    want = list(plain.batches(cap, names))
    jr = jbam.BamReader(path, batch_records=cap, want_names=names)
    assert jr._lib is not None, "the JAX package's native reader"
    jn = list(jr.batches())
    jp = list(jbam._PyBam(path).batches(cap, names))
    rdr.close()
    plain.close()
    jr.close()
    assert len(got) == len(want) == len(jn) == len(jp) > 1
    for g, w, a, b in zip(got, want, jn, jp):
        _assert_bam_batches(g, w)
        _assert_bam_batches(g, a)
        _assert_bam_batches(g, b)
    if kind == "mixed":
        assert max(int(b.cigar_n.max()) for b in got) > terr.MAXOPS


@pytest.mark.parametrize("rl_cap", [64, 512])
def test_pad_batch_matches_plain_and_jax(bams, rl_cap):
    """bam_pad_batch on the mixed BAM (the read grid 64 or 128 wide,
    rows past 16 ops, longer reads and N runs past the column slack)
    equals the numpy repack; the JAX package's _pack on its native pass
    gives the same fits, read grid and, on the rows that fit, ops."""
    b = next(bamio.BamReader(bams["mixed"]).batches())
    rng = np.random.default_rng(1)
    sel = np.sort(rng.choice(b.n, size=b.n * 3 // 4, replace=False))
    rl = min(int(b.read_len[sel].max()), rl_cap)
    RL = -(-rl // 64) * 64
    got = terr.pad_records(b, sel, RL)
    want = terr.pad_records_numpy(b, sel, RL)
    for g, w, name in zip(got, want, ("ops", "oplens", "rseq", "fits")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, name)
    fits = got[3]
    assert 0 < fits.sum() < sel.size
    names, lens, seqs = targets()
    off = np.concatenate([[0], np.cumsum(lens)])
    jm = jerr.DeviceAlignmentErrorModel(np.concatenate(seqs), off,
                                        np.array(lens),
                                        read_len_cap=rl_cap)
    p, jfits, n = jm._pack(b, sel, np.arange(len(names)))
    assert n == sel.size
    np.testing.assert_array_equal(jfits, fits)
    np.testing.assert_array_equal(np.asarray(p["rseq"])[:n].view(np.uint8),
                                  got[2])
    for key, g in zip(("ops", "oplens"), got[:2]):
        np.testing.assert_array_equal(np.asarray(p[key])[:n][fits],
                                      g[fits], key)


def _fastq_text(rng, n, read_len, fasta=False, long_names=0, ns=0.0,
                tag="r"):
    """n records of random bases (lengths read_len +- 20), names with a
    comment after them; every long_names-th name is 300 characters."""
    out = []
    for i in range(n):
        L = int(rng.integers(read_len - 20, read_len + 21))
        codes = rng.integers(0, 4, L)
        if ns:
            codes[rng.random(L) < ns] = 4
        seq = "".join("ACGTN"[c] for c in codes)
        name = f"{tag}{i}"
        if long_names and i % long_names == 0:
            name = name + "x" * (300 - len(name))
        if fasta:
            out.append(f">{name} c\n{seq[:L // 2]}\n{seq[L // 2:]}\n")
        else:
            out.append(f"@{name} c\n{seq}\n+\n{'I' * L}\n")
    return "".join(out)


FASTQ_CASES = {
    # name: (files per mate, reads per file, read length, options)
    "plain": (2, 1500, 100, {}),
    "gz": (1, 2500, 100, {"gz": True}),
    "fasta": (1, 1200, 100, {"fasta": True}),
    "n-bases": (1, 1000, 100, {"ns": 0.05}),
    "longer-than-max-len": (1, 1000, 300, {}),
    "long-names": (1, 1000, 80, {"long_names": 7}),
    "long-names-all": (1, 1000, 80, {"long_names": 1}),
}


@pytest.fixture(scope="module")
def fastqs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fastq")
    rng = np.random.default_rng(11)
    out = {}
    for case, (n_files, n, rl, o) in FASTQ_CASES.items():
        files = []
        for mate in (1, 2):
            ps = []
            for f in range(n_files):
                text = _fastq_text(rng, n, rl, o.get("fasta", False),
                                   o.get("long_names", 0), o.get("ns", 0.0),
                                   tag=f"f{f}r")
                ext = ".fa" if o.get("fasta") else ".fq"
                p = str(d / f"{case}_{f}_{mate}{ext}")
                if o.get("gz"):
                    p += ".gz"
                    with gzip.open(p, "wt") as fh:
                        fh.write(text)
                else:
                    with open(p, "w") as fh:
                        fh.write(text)
                ps.append(p)
            files.append(ps)
        out[case] = files
    return out


def _assert_chunks(got, want, names=True):
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        for gc, wc in ((g.left, w.left), (g.right, w.right)) \
                if hasattr(g, "left") else ((g, w),):
            assert gc.n_valid == wc.n_valid
            np.testing.assert_array_equal(gc.codes, wc.codes)
            np.testing.assert_array_equal(gc.lengths, wc.lengths)
            if names:
                assert (gc.names is None) == (wc.names is None)
                if gc.names is not None:
                    assert list(gc.names) == list(wc.names)


@pytest.mark.parametrize("pick", [None, "odd"])
@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
@pytest.mark.parametrize("case", list(FASTQ_CASES))
def test_fastq_reader_matches_plain_and_jax(fastqs, case, paired, pick):
    """Chunks of 512 reads, 256 bases at most, with names: the native
    chunker equals the Python one (a chunk runs on into the next file);
    with pick, the other chunks come as None. On one file per mate the
    JAX package's native chunker gives the same chunks."""
    (r1, r2) = fastqs[case]
    sel = None if pick is None else (lambda i: i % 2 == 1)
    args = (512, 256, True, sel)
    if paired:
        got = list(fastq.iter_paired_chunks(r1, r2, *args))
        want = list(fastq._iter_paired_chunks_py(r1, r2, *args))
    else:
        got = list(fastq.iter_single_chunks(r1, *args))
        want = list(fastq._iter_single_chunks_py(r1, *args))
    long_names = case == "long-names-all"
    _assert_chunks(got, want, names=not long_names)
    if len(r1) == 1 and pick is None:
        assert jfastq._native_lib() is not None
        jn = list(jfastq.iter_paired_chunks(r1, r2, 512, 256, True)
                  if paired else
                  jfastq.iter_single_chunks(r1, 512, 256, True))
        _assert_chunks(got, jn)
    if long_names:
        # 512 x 256 bytes of names a chunk: past them names come back
        # empty, as from the JAX package's native reader; the names that
        # fit are the plain reader's
        n_empty = 0
        for g, w in zip(got, want):
            if g is None:
                continue
            gn, wn = list(g.left.names if paired else g.names), \
                list(w.left.names if paired else w.names)
            assert len(gn) == len(wn)
            assert all(a in (b, b"") for a, b in zip(gn, wn))
            n_empty += gn.count(b"")
        assert n_empty > 0


def test_fastq_errors(tmp_path):
    """Mate files of unequal length and a malformed record raise
    IOError; a missing file too."""
    rng = np.random.default_rng(2)
    a, b, bad = (str(tmp_path / n) for n in ("a.fq", "b.fq", "bad.fq"))
    with open(a, "w") as fh:
        fh.write(_fastq_text(rng, 100, 50))
    with open(b, "w") as fh:
        fh.write(_fastq_text(rng, 99, 50))
    with open(bad, "w") as fh:
        fh.write(_fastq_text(rng, 10, 50) + "junk\nACGT\n")
    with pytest.raises(IOError, match="differ in length"):
        list(fastq.iter_paired_chunks([a], [b], 64, 128))
    with pytest.raises(IOError, match="malformed"):
        list(fastq.iter_single_chunks([bad], 64, 128))
    with pytest.raises(IOError, match="cannot open"):
        list(fastq.iter_single_chunks([str(tmp_path / "none.fq")], 64, 128))


def _random_records(seed, n_rec=40, n_frac=0.01):
    """Concatenated random records of 0-3,000 bases (some shorter than
    k) with Ns, as (seq_codes, seq_offsets)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 3000, n_rec)
    lens[:3] = (0, 10, 31)
    seq = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
    seq[rng.random(seq.size) < n_frac] = 4
    return seq, np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


@pytest.mark.parametrize("k", [15, 31])
def test_enumerate_sorted_matches_plain_and_jax(k):
    seq, off = _random_records(5)
    got = native_kmers.enumerate_sorted(seq, off, k)
    total = native_kmers.count_total(seq, off, k)
    assert total == got[0].shape[0] == kmer_enum.count_total(seq, off, k) \
        == jnative.count_total(seq, off, k)
    for want in (builder._enumerate_sorted_records(seq, off, k),
                 kmer_enum.enumerate_sorted(seq, off, k),
                 jnative.enumerate_sorted(seq, off, k)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bits", [0, 2, 6])
def test_enumerate_partitioned_matches_plain_and_jax(bits):
    seq, off = _random_records(6)
    k = 25
    got = list(native_kmers.enumerate_sorted_partitioned(seq, off, k, bits))
    assert len(got) == 1 << bits
    for want in (kmer_enum.enumerate_sorted_partitioned(seq, off, k, bits),
                 jnative.enumerate_sorted_partitioned(seq, off, k, bits)):
        want = list(want)
        assert len(want) == len(got)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    keys, tx, po, fw = native_kmers.enumerate_sorted(seq, off, k)
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got]), keys)
    np.testing.assert_array_equal(np.concatenate([g[2] for g in got]),
                                  (po << 1) | fw)


@pytest.mark.parametrize("load", [0.5, 0.97], ids=["default", "tail"])
def test_table_place_matches_plain_and_jax(load):
    """Placement of 200,000 random keys at the default load and at one
    whose overflow reaches the cuckoo walk: slot for slot and eviction
    count equal to the numpy rounds and the JAX package's."""
    rng = np.random.default_rng(9)
    n = 200_000
    keys = np.unique(rng.integers(0, 1 << 62, n, dtype=np.int64)
                     .astype(np.uint64))
    counts = rng.integers(1, 6, keys.shape[0]).astype(np.int64)
    n_buckets = (hashtable.table_n_slots(keys.shape[0]) // 4
                 if load == 0.5 else
                 int(2 ** np.ceil(np.log2(keys.shape[0] / 4 / load))))
    if load != 0.5:
        keys, counts = keys[:int(load * 4 * n_buckets)], \
            counts[:int(load * 4 * n_buckets)]
    hi, lo = hashtable.split_u64(keys)
    mask = np.uint32(n_buckets - 1)
    b1 = (hashtable.mix32(hi, lo) & mask).astype(np.int64)
    b2 = (hashtable.mix32b(hi, lo) & mask).astype(np.int64)
    slot_key, n_ev = native_kmers.table_place(keys, counts, n_buckets)
    want, want_ev = hashtable._place_keys_numpy(b1, b2, counts, n_buckets)
    np.testing.assert_array_equal(slot_key, want)
    assert n_ev == want_ev
    j_slot, j_ev = jnative.table_place_native(keys, counts, n_buckets)
    np.testing.assert_array_equal(slot_key, j_slot)
    assert n_ev == j_ev
    placed = slot_key[slot_key >= 0]
    assert np.unique(placed).size == placed.size == keys.shape[0] - n_ev
    # keys that rounds 1-2 leave over, for the cuckoo walk: about 1e-5 of
    # them at the default load, far more at the tail load
    cand1, cand2 = (np.bincount(b, minlength=n_buckets) for b in (b1, b2))
    first = np.where(cand1[b1] <= cand2[b2], b1, b2)
    second = np.where(first == b1, b2, b1)
    placed1 = hashtable._rank_in_bucket(first, counts) < 4
    used = np.bincount(first[placed1], minlength=n_buckets)
    idx2 = np.nonzero(~placed1)[0]
    left = (hashtable._rank_in_bucket(second[idx2], counts[idx2])
            >= 4 - used[second[idx2]]).sum()
    assert (left < 1e-4 * keys.shape[0]) == (load == 0.5) and left > 0, \
        left


@pytest.mark.parametrize("cap", [4, 8, 16])
def test_oct_align_pads_matches_plain_and_jax(cap):
    rng = np.random.default_rng(cap)
    counts = rng.integers(0, 20, 50_000).astype(np.int64)
    counts[rng.random(counts.size) < 0.6] = 1
    got = native_kmers.oct_align_pads(counts, cap)
    np.testing.assert_array_equal(got, diskfmt._oct_align_pads_py(counts,
                                                                   cap))
    want = np.zeros_like(got)
    assert jnative.oct_align_pads_native(counts, cap, want)
    np.testing.assert_array_equal(got, want)
    assert got.any() and (got <= 8).all()


@pytest.mark.parametrize("layout", ["u8x6", "i32", "memmap"])
def test_gather_rows_matches_plain_and_jax(tmp_path, layout):
    rng = np.random.default_rng(4)
    if layout == "u8x6":
        src = rng.integers(0, 256, (30_000, 6)).astype(np.uint8)
    else:
        src = rng.integers(-2**31, 2**31, 30_000).astype(np.int32)
    if layout == "memmap":
        np.save(tmp_path / "src.npy", src)
        src = np.load(tmp_path / "src.npy", mmap_mode="r")
    idx = rng.integers(0, src.shape[0], 100_000)
    got = native_kmers.gather_rows(src, idx)
    np.testing.assert_array_equal(got, np.asarray(src)[idx])
    np.testing.assert_array_equal(got, jnative.gather_rows_native(src, idx))
    with pytest.raises(IndexError):
        native_kmers.gather_rows(src, np.array([src.shape[0]]))


def _fragments(seed, n_frag, paired):
    """Fragment-grouped alignments: 1-6 a fragment over 50 transcripts
    (duplicates within a fragment included), log-weights with ties and
    with values far below the fragment's best."""
    rng = np.random.default_rng(seed)
    per = rng.integers(1, 7, n_frag)
    fid = np.repeat(np.arange(n_frag), per)
    n = fid.size
    txp = rng.integers(0, 50, n).astype(np.int32)
    logw = rng.choice([0.0, -1.0, -2.5, -40.0, -1e30], n) \
        + rng.normal(0, 1, n) * (rng.random(n) < 0.5)
    flen = rng.integers(-5, 1200, n) if paired else rng.integers(30, 150, n)
    obs = rng.integers(-1, 6, n) if paired else rng.integers(0, 2, n)
    return fid, txp, flen.astype(np.int64), obs.astype(np.int64), logw


class _Opts:
    min_aln_prob = 1e-5
    max_frag_length = 1000


@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
def test_group_eq_matches_plain_and_jax(paired):
    fid, txp, flen, obs, logw = _fragments(8, 20_000, paired)
    o = _Opts()
    eq_txp, eq_w, wn, best, hist, n_mapped = alnweights.group_eq(
        fid, txp, flen, obs, logw, o.min_aln_prob, paired,
        o.max_frag_length)
    (p_txp, p_w, w, valid_w, starts, counts, p_wn,
     p_hist) = tquant._weigh_fragments(fid, txp, flen, obs, logw, o, paired)
    np.testing.assert_array_equal(eq_txp, p_txp)
    np.testing.assert_allclose(eq_w, p_w, rtol=1e-5, atol=0)
    np.testing.assert_allclose(wn, p_wn, rtol=1e-12, atol=0)
    assert n_mapped == int((p_txp[:, 0] != INVALID_TXP).sum()) == \
        best.shape[0]
    np.testing.assert_array_equal(best[best >= 0],
                                  tquant._best_alignments(w, valid_w,
                                                          starts, counts))
    if paired:
        np.testing.assert_allclose(hist, p_hist, rtol=1e-12, atol=1e-12)
        assert hist.sum() > 0
    j = jaln.group_eq(fid, txp, flen, obs, logw, o.min_aln_prob, paired,
                      o.max_frag_length)
    assert j is not None, "the JAX package's native pass"
    for g, w_, name in zip((eq_txp, eq_w, wn, best), j[:4],
                           ("eq_txp", "eq_w", "wn", "best")):
        np.testing.assert_array_equal(g, w_, name)
    np.testing.assert_allclose(hist, j[4], rtol=1e-12, atol=1e-12)
    assert n_mapped == j[5]
    # some fragments hold duplicate valid transcripts, merged into one
    # label
    labels = (p_txp != INVALID_TXP).sum(axis=1)
    assert (labels < np.add.reduceat(valid_w.astype(np.int64),
                                     starts)).any()


# Native partitioned build, reckoned per partition record (bytes): its
# keys and payload, the radix sort's two scratch planes, its decoded txp
# and pf, then np.unique's permutation and sorted copy; after the
# partitions, the kept counts' chunk (an int64 difference and its int32
# copy, 12 bytes a key)
NATIVE_PART_BYTES = 8 + 8 + 8 + 8 + 4 + 4 + 8 + 8
COUNTS_CHUNK_BYTES = 12
# small arrays and Python objects, whatever the input's size
FIXED_BYTES = 1 << 20


def test_native_partitioned_build_memory_is_bounded(monkeypatch):
    """On a random ~4 Mb record, the native partitioned build up to the
    CSR (table-less) peaks at most at its output planes plus the larger
    of one partition's buffers and the kept counts' chunk, reckoned
    above: no whole-input enumeration scratch."""
    rng = np.random.default_rng(5)
    n, k, bits = 4_000_000, 31, 6
    seq = rng.integers(0, 4, n).astype(np.uint8)
    seq[rng.integers(0, n, 400)] = 4
    off = np.array([0, n], np.int64)
    monkeypatch.setattr(builder, "TABLE_DIRECT_MAX_KEYS", 0)
    part_max = max(g[0].shape[0] for g in
                   native_kmers.enumerate_sorted_partitioned(seq, off, k,
                                                             bits))
    tracemalloc.start()
    try:
        idx = builder._build_partitioned(
            ["chr"], [n], {}, k, 1, seq, off, bits, True)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    total = int(idx.occ_offsets[-1])
    assert idx.table is None
    planes = 24 * total + 4 * idx.kmers.shape[0]
    scratch = FIXED_BYTES + max(
        NATIVE_PART_BYTES * part_max,
        COUNTS_CHUNK_BYTES * min(idx.kmers.shape[0], 1 << 27))
    assert peak <= planes + scratch, (peak, planes, scratch)


DATA = os.path.join(os.path.dirname(__file__), "data")
FASTA = os.path.join(DATA, "transcripts.fasta")
READS = [os.path.join(DATA, f"reads_{i}.fastq") for i in (1, 2)]
# the plain versions, which no entry point may reach
PLAIN = [(bamio, "_PyBam"), (terr, "pad_records_numpy"),
         (tquant, "_weigh_fragments"), (tquant, "_best_alignments"),
         (fastq, "_iter_single_chunks_py"), (fastq, "_iter_paired_chunks_py"),
         (builder, "_enumerate_sorted_records"),
         (kmer_enum, "count_partitions"), (kmer_enum, "count_total"),
         (kmer_enum, "enumerate_sorted"),
         (kmer_enum, "enumerate_sorted_partitioned"),
         (hashtable, "_place_keys_numpy"), (diskfmt, "_oct_align_pads_py")]
# the native calls each entry point must make
NATIVE = [(bamio, "_trimmed"), (terr, "pad_records"), (tquant, "group_eq"),
          (fastq, "_native_batches"), (native_kmers, "enumerate_sorted"),
          (native_kmers, "count_total"),
          (native_kmers, "enumerate_sorted_partitioned"),
          (native_kmers, "table_place"), (native_kmers, "oct_align_pads"),
          (native_kmers, "gather_rows")]


def test_entry_points_take_the_native_paths(monkeypatch, tmp_path, bams):
    """`index` (flat, and partitioned table-less with its shard planes),
    paired `quant` and `quant -a` on the CPU call the native functions
    and never a plain version."""
    import collections

    import torch

    from salmon_tpu_torch import cli
    from salmon_tpu_torch.index import shard

    torch.set_num_threads(2)
    calls = collections.Counter()

    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"an entry point reached {name}")
        return fn

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for mod, name in PLAIN:
        monkeypatch.setattr(mod, name, refuse(name))
    for mod, name in NATIVE:
        monkeypatch.setattr(mod, name, count(name, getattr(mod, name)))
    idx = str(tmp_path / "idx")
    assert cli.main(["index", "-t", FASTA, "-i", idx, "-k", "31"]) == 0
    monkeypatch.setattr(builder, "TABLE_DIRECT_MAX_KEYS", 0)
    tl = str(tmp_path / "tableless")
    builder.save_index(builder.build_index(FASTA, k=31, partition_bits=2),
                       tl)
    assert len(list(shard.iter_shard_arrays(tl, 2))) == 2
    assert cli.main(["quant", "-i", idx, "-l", "IU", "-1", READS[0], "-2",
                     READS[1], "-o", str(tmp_path / "q"), "-q"],
                    device="cpu") == 0
    assert cli.main(["quant", "-t", FASTA, "-a", bams["paired"], "-l", "A",
                     "-o", str(tmp_path / "a"), "-q"], device="cpu") == 0
    assert set(calls) == {name for _, name in NATIVE}, calls
