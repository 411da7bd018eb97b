"""The port's partitioned index build (builder._build_partitioned, on the
port's native library, and on index/kmer_enum.py, its plain version)
against the port's flat build and the JAX package's partitioned build on
its native library, all exact:
every partition width, with and without the table (the table-less
layout forced at toy scale through each package's
TABLE_DIRECT_MAX_KEYS), with --maxOccsKept pruning, with decoys given
by name and by FASTA, across enumeration chunk seams that fall inside a
record and on its Ns; the save/load round trip, the shard planes of the
table-less index, the automatic switch, and the memory bound the
chunked enumeration exists for."""

import os
import tracemalloc

import numpy as np
import pytest

from salmon_tpu.index import builder as jbuilder
from salmon_tpu.index import native_kmers
from salmon_tpu.index import shard as jshard
from salmon_tpu_torch.index import builder, kmer_enum, shard
from salmon_tpu_torch.index import native_kmers as port_native
from salmon_tpu_torch.utils.dna import kmers_of

FASTA = os.path.join(os.path.dirname(__file__), "data", "transcripts.fasta")
K = 25
ARRAYS = ("kmers", "occ_offsets", "occ_txp", "occ_pf", "occ_counts",
          "lengths", "complete_lengths", "seq_codes", "seq_offsets")


@pytest.fixture(autouse=True)
def _native():
    if not native_kmers.available():
        pytest.fail("the JAX package's native library did not build")


def _tableless(mp):
    """Both packages skip the monolithic table at any key count."""
    mp.setattr(builder, "TABLE_DIRECT_MAX_KEYS", 0)
    mp.setattr(jbuilder, "TABLE_DIRECT_MAX_KEYS", 0)


class _PlainEnumeration:
    """The builder's native enumeration replaced by its plain version,
    index.kmer_enum."""
    count_total = staticmethod(kmer_enum.count_total)
    enumerate_sorted = staticmethod(kmer_enum.enumerate_sorted)
    enumerate_sorted_partitioned = staticmethod(
        kmer_enum.enumerate_sorted_partitioned)


def assert_same_index(got, want):
    for f in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (got.occ_true_counts is None) == (want.occ_true_counts is None)
    if got.occ_true_counts is not None:
        np.testing.assert_array_equal(got.occ_true_counts,
                                      want.occ_true_counts)
    assert (got.table is None) == (want.table is None)
    if got.table is not None:
        np.testing.assert_array_equal(got.table.rows, want.table.rows)
        assert (got.table.n_slots, got.table.max_probes) == \
            (want.table.n_slots, want.table.max_probes)
    assert got.info == want.info
    assert (got.names, got.first_decoy_index) == \
        (want.names, want.first_decoy_index)


def assert_equals_flat_records(got, flat):
    """A table-less index against the flat build: the same keys, counts
    and records once the flat CSR's oct-alignment pads (and shadow-merge
    appendix) are dropped."""
    np.testing.assert_array_equal(got.kmers, flat.kmers)
    np.testing.assert_array_equal(got.occ_counts, flat.occ_counts)
    off, cnt = np.asarray(flat.occ_offsets), np.asarray(flat.occ_counts)
    keep = np.repeat(off[:-1], cnt) + (np.arange(int(cnt.sum()))
                                       - np.repeat(np.cumsum(cnt) - cnt, cnt))
    np.testing.assert_array_equal(got.occ_txp, flat.occ_txp[keep])
    np.testing.assert_array_equal(got.occ_pf, flat.occ_pf[keep])
    np.testing.assert_array_equal(got.occ_offsets,
                                  np.concatenate([[0], np.cumsum(cnt)]))
    for f in ("seq_codes", "seq_offsets", "lengths", "complete_lengths"):
        np.testing.assert_array_equal(getattr(got, f), getattr(flat, f))
    assert got.info["requires_shards"] and "occ_oct_aligned" not in got.info
    assert {k: v for k, v in got.info.items()
            if k not in ("requires_shards", "num_occurrences")} == \
        {k: v for k, v in flat.info.items()
         if k not in ("occ_oct_aligned", "table_inline_singles",
                      "num_occurrences")}


@pytest.mark.parametrize("max_occs_kept", [0, 4], ids=["all", "kept4"])
@pytest.mark.parametrize("table", [True, False], ids=["table", "tableless"])
@pytest.mark.parametrize("bits", [1, 2, 3, 6])
def test_partitioned_equals_flat_and_jax(monkeypatch, bits, table,
                                         max_occs_kept):
    flat = builder.build_index(FASTA, k=K, max_occs_kept=max_occs_kept)
    if not table:
        _tableless(monkeypatch)
    got = builder.build_index(FASTA, k=K, partition_bits=bits,
                              max_occs_kept=max_occs_kept)
    want = jbuilder.build_index(FASTA, k=K, partition_bits=bits,
                                max_occs_kept=max_occs_kept)
    assert_same_index(got, want)
    if table:
        assert_same_index(got, flat)
    else:
        assert got.table is None
        assert_equals_flat_records(got, flat)
    if max_occs_kept:
        assert got.occ_true_counts is not None
        assert int(np.asarray(got.occ_counts).max()) == max_occs_kept


def _write_fasta(path, recs):
    with open(path, "w") as fh:
        for name, seq in recs:
            fh.write(f">{name}\n{seq}\n")


def _random_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


@pytest.fixture(scope="module")
def decoy_inputs(tmp_path_factory):
    """The sample transcripts plus two random decoys (seed 7): as a
    decoy FASTA, and as one FASTA whose decoys a names file lists."""
    base = tmp_path_factory.mktemp("decoys")
    rng = np.random.default_rng(7)
    decoys = [(f"decoy_chr{i}", _random_seq(rng, 3000)) for i in range(2)]
    dfa, names = str(base / "decoys.fa"), str(base / "decoys.txt")
    _write_fasta(dfa, decoys)
    with open(FASTA) as fh:
        txome = fh.read()
    comb = str(base / "combined.fa")
    with open(comb, "w") as fh:
        fh.write(txome.rstrip("\n") + "\n")
    with open(comb, "a") as fh:
        for name, seq in decoys:
            fh.write(f">{name}\n{seq}\n")
    with open(names, "w") as fh:
        fh.write("decoy_chr0\ndecoy_chr1\n")
    return {"names": (comb, {"decoy_names_path": names}),
            "fasta": (FASTA, {"decoys_path": dfa})}


@pytest.mark.parametrize("table", [True, False], ids=["table", "tableless"])
@pytest.mark.parametrize("how", ["names", "fasta"])
def test_decoys(monkeypatch, decoy_inputs, how, table):
    path, kw = decoy_inputs[how]
    flat = builder.build_index(path, k=K, **kw)
    if not table:
        _tableless(monkeypatch)
    got = builder.build_index(path, k=K, partition_bits=3, **kw)
    want = jbuilder.build_index(path, k=K, partition_bits=3, **kw)
    assert got.num_targets - got.first_decoy_index == 2
    assert got.names[-2:] == ["decoy_chr0", "decoy_chr1"]
    assert_same_index(got, want)
    if table:
        assert_same_index(got, flat)
    else:
        assert_equals_flat_records(got, flat)


@pytest.fixture(scope="module")
def seam_fasta(tmp_path_factory):
    """Short records around one of 2,000 bases whose Ns sit on and
    across the seams of 200-window chunks (k 25: each seam's overlap is
    24 bases), a record of all N and one shorter than k."""
    rng = np.random.default_rng(11)
    long = np.array(list(_random_seq(rng, 2000)))
    for p in (199, 200, 223, 224, 401, 620, 799, 1000, 1224, 1999):
        long[p] = "N"
    recs = [("short0", _random_seq(rng, 150)), ("long", "".join(long)),
            ("allN", "N" * 60), ("tiny", _random_seq(rng, 20)),
            ("short1", _random_seq(rng, 330))]
    path = str(tmp_path_factory.mktemp("seam") / "seam.fa")
    _write_fasta(path, recs)
    return path


@pytest.mark.parametrize("table", [True, False], ids=["table", "tableless"])
def test_chunk_seams_and_ns(monkeypatch, seam_fasta, table):
    """The build on the plain enumeration (kmer_enum in place of the
    native library) with chunk seams on and across Ns."""
    monkeypatch.setattr(kmer_enum, "CHUNK_BASES", 200)
    monkeypatch.setattr(builder, "native_kmers", _PlainEnumeration)
    flat = builder.build_index(seam_fasta, k=K)
    if not table:
        _tableless(monkeypatch)
    got = builder.build_index(seam_fasta, k=K, partition_bits=2)
    want = jbuilder.build_index(seam_fasta, k=K, partition_bits=2)
    assert_same_index(got, want)
    if table:
        assert_same_index(got, flat)
    else:
        assert_equals_flat_records(got, flat)


@pytest.mark.parametrize("chunk", [64, 200, 1 << 20])
@pytest.mark.parametrize("k", [5, 25, 31])
def test_enumeration_matches_native(monkeypatch, seam_fasta, chunk, k):
    """count_total is the native count (exact, not numpy's upper bound),
    and the sorted enumeration, flat and per partition, is the native
    one, with chunk seams inside records."""
    monkeypatch.setattr(kmer_enum, "CHUNK_BASES", chunk)
    idx = builder.build_index(seam_fasta, k=K)
    seq, off = np.asarray(idx.seq_codes), np.asarray(idx.seq_offsets)
    total = kmer_enum.count_total(seq, off, k)
    assert total == native_kmers.count_total(seq, off, k)
    assert total < int(np.maximum(np.diff(off) - (k - 1), 0).sum())
    for got, want in zip(kmer_enum.enumerate_sorted(seq, off, k),
                         native_kmers.enumerate_sorted(seq, off, k)):
        np.testing.assert_array_equal(got, want)
    got = list(kmer_enum.enumerate_sorted_partitioned(seq, off, k, 3))
    want = list(native_kmers.enumerate_sorted_partitioned(seq, off, k, 3))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def tableless_dirs(tmp_path_factory):
    """The sample's table-less pruned index (k 25, 2 partition bits),
    saved by each package's partitioned build."""
    mp = pytest.MonkeyPatch()
    _tableless(mp)
    try:
        got = builder.build_index(FASTA, k=K, partition_bits=2,
                                  max_occs_kept=4)
        want = jbuilder.build_index(FASTA, k=K, partition_bits=2,
                                    max_occs_kept=4)
    finally:
        mp.undo()
    base = tmp_path_factory.mktemp("tl")
    dirs = str(base / "port"), str(base / "jax")
    builder.save_index(got, dirs[0])
    jbuilder.save_index(want, dirs[1])
    return got, dirs


def test_save_load_round_trip(tableless_dirs):
    idx, (port_dir, jax_dir) = tableless_dirs
    back = builder.load_index(port_dir)
    assert back.table is None and back.info["requires_shards"]
    for f in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(idx, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(back.occ_true_counts, idx.occ_true_counts)
    assert not os.path.exists(os.path.join(port_dir, "occ_pad8.npy"))
    # the same files as the JAX package writes
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    for name in os.listdir(port_dir):
        if name.endswith(".npy"):
            np.testing.assert_array_equal(
                np.load(os.path.join(port_dir, name)),
                np.load(os.path.join(jax_dir, name)), err_msg=name)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shards_of_port_built_index_match_jax(tableless_dirs, n_shards):
    """iter_shard_arrays and shard_index_arrays on the port-built
    table-less index equal the JAX functions on the JAX-built one."""
    _, (port_dir, jax_dir) = tableless_dirs
    got = list(shard.iter_shard_arrays(port_dir, n_shards, load_factor=0.5,
                                       max_load_factor=0.62))
    want = list(jshard.iter_shard_arrays(jax_dir, n_shards,
                                         load_factor=0.5,
                                         max_load_factor=0.62))
    assert len(got) == len(want) == n_shards
    for (s, meta, g), (ws, wmeta, w) in zip(got, want):
        assert s == ws and meta == wmeta and g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    got = shard.shard_index_arrays(builder.load_index(port_dir), n_shards)
    want = jshard.shard_index_arrays(jbuilder.load_index(jax_dir), n_shards)
    assert (got.n_slots, got.n_evicted) == (want.n_slots, want.n_evicted)
    np.testing.assert_array_equal(got.tab_rows, want.tab_rows)
    np.testing.assert_array_equal(got.occ_oct, want.occ_oct)


def test_auto_rule_takes_the_partitioned_path(monkeypatch):
    """partition_bits=None partitions (6 bits) from
    PARTITIONED_BUILD_BASES on, as the JAX package does, and the
    no-argument build still equals the JAX one."""
    seen = []
    real = port_native.enumerate_sorted_partitioned

    def spy(seq, off, k, bits):
        seen.append(bits)
        return real(seq, off, k, bits)

    monkeypatch.setattr(port_native, "enumerate_sorted_partitioned", spy)
    flat = builder.build_index(FASTA, k=K)
    assert seen == []
    monkeypatch.setattr(builder, "PARTITIONED_BUILD_BASES", 1000)
    monkeypatch.setattr(jbuilder, "PARTITIONED_BUILD_BASES", 1000)
    got = builder.build_index(FASTA, k=K)
    assert seen == [6]
    assert_same_index(got, jbuilder.build_index(FASTA, k=K))
    assert_same_index(got, flat)
    with pytest.raises(ValueError, match="partition_bits"):
        builder.build_index(FASTA, k=K, partition_bits=17)


# Scratch of the partitioned enumeration, reckoned plane by plane (bytes):
# a chunk of C window starts holds at most 8 u64 planes of C at once
# (the codes, the forward and reverse doubling blocks with the next
# level's and its shifted copy, fw and rc; later the starts, the masked
# copies and the scatter's order and destinations, fewer), and a
# partition of P records 10 u64 planes of P (positions, keys and a
# gather temporary, the revcomp temporaries, the sort order, the sorted
# keys, np.unique's permutation and copy).
CHUNK_PLANE_BYTES = 8 * 8
PART_PLANE_BYTES = 10 * 8


def test_partitioned_enumeration_memory_is_bounded(monkeypatch):
    """On a random ~4 Mb record, the partitioned build on the plain
    enumeration (kmer_enum in place of the native library) up to the CSR
    (table-less: no table is built) peaks at most at its output planes
    plus the chunk and partition scratch reckoned above; kmers_of on the
    same record alone needs more than that scratch (n * k * 8 bytes).
    The native build's bound: tests/test_torch_native.py."""
    rng = np.random.default_rng(5)
    n, k, bits = 4_000_000, 31, 6
    seq = rng.integers(0, 4, n).astype(np.uint8)
    seq[rng.integers(0, n, 400)] = 4
    off = np.array([0, n], np.int64)
    _tableless(monkeypatch)
    monkeypatch.setattr(builder, "native_kmers", _PlainEnumeration)
    counts = kmer_enum.count_partitions(seq, off, k, bits)
    total = int(counts.sum())
    scratch = (CHUNK_PLANE_BYTES * (kmer_enum.CHUNK_BASES + k)
               + PART_PLANE_BYTES * int(counts.max()))
    tracemalloc.start()
    try:
        idx = builder._build_partitioned(
            ["chr"], [n], {}, k, 1, seq, off, bits, True)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert idx.table is None and int(idx.occ_offsets[-1]) == total
    # txp + pf (4 + 4), the unique-key and offset buffers at the record
    # count (8 + 8), the kept counts (4 a key)
    planes = 24 * total + 4 * idx.kmers.shape[0]
    assert peak <= planes + scratch, (peak, planes, scratch)
    del idx
    tracemalloc.start()
    try:
        kmers_of(seq, k)
        _, flat_peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert flat_peak >= n * k * 8 > scratch, (flat_peak, scratch)
