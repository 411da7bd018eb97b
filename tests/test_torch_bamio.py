"""The port's BAM reader and writers against the JAX package's.

The port reads BAM with its own copy of the JAX package's native reader
(BamReader on csrc/bamreader.cpp; tests/test_torch_native.py holds it to
its plain version, the port's copy of the pure-Python _PyBam); its
batches must equal, field by field, both the JAX _PyBam's and the JAX
native reader's on the sample truth BAM and on a mixed-CIGAR BAM
(indels, clips, =/X runs past the error model's 16-op grid,
reverse-strand and unmapped records).
write_bam and the --sampleOut BamWriter must write the JAX package's
bytes. The helpers here also make the BAMs of test_torch_errormodel.py
and test_torch_alignment_quant.py.
"""

import os

import numpy as np
import pytest

from salmon_tpu.alignment import bamio as jbam
from salmon_tpu.alignment import sampler as jsampler
from salmon_tpu_torch.alignment import bamio as tbam
from salmon_tpu_torch.alignment import sampler as tsampler
from salmon_tpu_torch.io.fasta import load_transcripts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
FASTA = os.path.join(DATA, "transcripts.fasta")

BATCH_FIELDS = ("refid", "pos", "flag", "mapq", "mate_refid", "mate_pos",
                "tlen", "read_len", "seq_off", "cigar_off", "cigar_n",
                "as_tag", "nm_tag", "name_hash")


def targets():
    """(names, lengths, per-target base codes) of the sample FASTA."""
    records, _ = load_transcripts(FASTA, noclip_polya=True)
    return ([r.name for r in records],
            [int(r.seq_codes.shape[0]) for r in records],
            [r.seq_codes for r in records])


def decode(codes) -> str:
    return "".join("ACGTN"[int(c)] for c in codes)


def truth_pairs():
    """(name, txp, start, end, read 1, read 2) of every sample pair, from
    the read names (readnum:txp:start:fragment end)."""
    out = []
    with open(os.path.join(DATA, "reads_1.fastq")) as f1, \
            open(os.path.join(DATA, "reads_2.fastq")) as f2:
        l1, l2 = f1.read().split("\n"), f2.read().split("\n")
    for i in range(0, len(l1) - 3, 4):
        name = l1[i][1:].split()[0]
        _, txp, start, end = name.split(":")
        out.append((name, txp, int(start), int(end), l1[i + 1].strip(),
                    l2[i + 1].strip()))
    return out


def truth_records(paired=True):
    """Perfect alignments of the sample reads at their true positions
    (tests/test_alignment_mode.py's truth BAM); single-end keeps read 1."""
    names, _, _ = targets()
    tid = {nm: i for i, nm in enumerate(names)}
    recs = []
    for name, txp, pos, fend, s1, s2 in truth_pairs():
        rid = tid[txp]
        tlen = fend - pos + 1
        p2 = fend - len(s2) + 1
        if not paired:
            recs.append(dict(name=name, refid=rid, pos=pos, flag=0,
                             cigar=f"{len(s1)}M", seq=s1,
                             tags={"AS": 2 * len(s1), "NM": 0}))
            continue
        recs.append(dict(name=name, refid=rid, pos=pos,
                         flag=0x1 | 0x40 | 0x20, cigar=f"{len(s1)}M",
                         seq=s1, mate_refid=rid, mate_pos=p2, tlen=tlen,
                         tags={"AS": 2 * len(s1), "NM": 0}))
        recs.append(dict(name=name, refid=rid, pos=p2,
                         flag=0x1 | 0x80 | 0x10, cigar=f"{len(s2)}M",
                         seq=s2, mate_refid=rid, mate_pos=pos, tlen=-tlen,
                         tags={"AS": 2 * len(s2), "NM": 0}))
    return recs


def _mutate(rng, codes, n):
    out = codes.copy()
    at = rng.integers(0, out.shape[0], n)
    out[at] = (out[at] + rng.integers(1, 4, n)) % 4
    return out


def mixed_read(rng, ref, pos, rl, kind):
    """(cigar, read codes) of one alignment of kind 0-6 at ref[pos:]:
    mismatches only, a deletion, an insertion, soft clips at both ends,
    a hard clip, =/X runs (more than 16 ops once it has 8 mismatches),
    or 21 ops of 5M1I."""
    if kind == 0:
        return f"{rl}M", _mutate(rng, ref[pos:pos + rl], 3)
    if kind == 1:
        d = int(rng.integers(1, 5))
        h = rl // 2
        return f"{h}M{d}D{rl - h}M", np.concatenate(
            [ref[pos:pos + h], ref[pos + h + d:pos + rl + d]])
    if kind == 2:
        ins = int(rng.integers(1, 5))
        h = rl // 2
        return f"{h}M{ins}I{rl - h - ins}M", np.concatenate(
            [ref[pos:pos + h], rng.integers(0, 4, ins).astype(np.uint8),
             ref[pos + h:pos + rl - ins]])
    if kind == 3:
        sc = int(rng.integers(1, 8))
        return f"{sc}S{rl - 2 * sc}M{sc}S", np.concatenate(
            [rng.integers(0, 4, sc).astype(np.uint8),
             ref[pos:pos + rl - 2 * sc],
             rng.integers(0, 4, sc).astype(np.uint8)])
    if kind == 4:
        return f"5H{rl}M", ref[pos:pos + rl].copy()
    if kind == 5:
        seq = _mutate(rng, ref[pos:pos + rl], int(rng.integers(0, 12)))
        mm = seq != ref[pos:pos + rl]
        edges = np.flatnonzero(np.diff(mm.astype(np.int8))) + 1
        bounds = np.concatenate([[0], edges, [rl]])
        return "".join(f"{b - a}{'X' if mm[a] else '='}"
                       for a, b in zip(bounds[:-1], bounds[1:])), seq
    parts = []
    for j in range(10):
        parts += [ref[pos + 5 * j:pos + 5 * j + 5],
                  rng.integers(0, 4, 1).astype(np.uint8)]
    return "5M1I" * 10 + "5M", np.concatenate(parts + [ref[pos + 50:
                                                           pos + 55]])


def mixed_records(seed=7, n=300):
    """Single-end records with every CIGAR kind of mixed_read, some on
    the reverse strand, plus a few unmapped records."""
    names, lens, seqs = targets()
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        t = int(rng.integers(0, len(names)))
        rl = int(rng.integers(56, 90))
        pos = int(rng.integers(0, lens[t] - rl - 10))
        cig, seq = mixed_read(rng, seqs[t], pos, rl, i % 7)
        recs.append(dict(name=f"r{i}", refid=t, pos=pos,
                         flag=0x10 * int(rng.integers(0, 2)), cigar=cig,
                         seq=decode(seq), tags={"AS": 2 * rl, "NM": 3}))
    for i in range(5):
        recs.append(dict(name=f"u{i}", refid=-1, pos=-1, flag=0x4,
                         cigar="", seq="ACGT" * 15))
    return recs


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    names, lens, _ = targets()
    d = tmp_path_factory.mktemp("bams")
    out = {}
    for kind, recs in (("truth", truth_records()),
                       ("mixed", mixed_records())):
        out[kind] = str(d / f"{kind}.bam")
        jbam.write_bam(out[kind], names, lens, recs)
    return out


def _assert_batches_equal(got, want, n_check=None):
    n = got.n
    assert n == want.n
    for f in BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(got, f)[:n],
                                      getattr(want, f)[:n], f)
    np.testing.assert_array_equal(got.zw_tag[:n], want.zw_tag[:n])
    last = n - 1
    seq_end = int(got.seq_off[last] + got.read_len[last])
    cig_end = int(got.cigar_off[last] + got.cigar_n[last])
    assert got.seq_buf.size == seq_end and got.cigar_op.size == cig_end
    np.testing.assert_array_equal(got.seq_buf, want.seq_buf[:seq_end])
    np.testing.assert_array_equal(got.cigar_op, want.cigar_op[:cig_end])
    np.testing.assert_array_equal(got.cigar_oplen,
                                  want.cigar_oplen[:cig_end])
    if want.names is not None:
        assert [bytes(x) for x in got.names] == \
            [bytes(x) for x in want.names[:n]]


@pytest.mark.parametrize("kind", ["truth", "mixed"])
def test_reader_matches_jax_python_reader(bams, kind):
    """Batch for batch, at a cap that puts boundaries inside name
    groups, the port equals the JAX _PyBam."""
    rdr = tbam.BamReader(bams[kind], batch_records=4096, want_names=True)
    jpy = jbam._PyBam(bams[kind])
    assert rdr.ref_names == jpy.ref_names
    assert rdr.header_text == jpy.header_text
    got = list(rdr.batches())
    want = list(jpy.batches(4096, want_names=True))
    rdr.close()
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


@pytest.mark.parametrize("kind", ["truth", "mixed"])
def test_reader_matches_jax_native_reader(bams, kind):
    """One batch of the whole file: the port equals the JAX package's
    native reader (native/bamreader.cpp) where that library builds."""
    jr = jbam.BamReader(bams[kind], want_names=True)
    if jr._lib is None:
        pytest.skip("the JAX package's native BAM reader did not build")
    want = list(jr.batches())
    jr.close()
    rdr = tbam.BamReader(bams[kind], want_names=True)
    got = list(rdr.batches())
    rdr.close()
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(rdr.ref_lens, jr.ref_lens)
    _assert_batches_equal(got[0], want[0])


@pytest.mark.parametrize("kind", ["truth", "mixed", "empty"])
def test_write_bam_byte_equal(tmp_path, kind):
    names, lens, _ = targets()
    recs = {"truth": truth_records()[:2000], "mixed": mixed_records(),
            "empty": []}[kind]
    tbam.write_bam(str(tmp_path / "t.bam"), names, lens, recs)
    jbam.write_bam(str(tmp_path / "j.bam"), names, lens, recs)
    assert (tmp_path / "t.bam").read_bytes() == \
        (tmp_path / "j.bam").read_bytes()


def test_bam_writer_byte_equal(tmp_path, bams):
    """--sampleOut's streaming writer: the records of the mixed BAM
    written back, with and without a ZW tag, in both packages."""
    b = next(tbam.BamReader(bams["mixed"], want_names=True).batches())
    rdr = tbam.BamReader(bams["mixed"])
    writers = [tsampler.BamWriter(str(tmp_path / "t.bam"), rdr.ref_names,
                                  rdr.ref_lens),
               jsampler.BamWriter(str(tmp_path / "j.bam"), rdr.ref_names,
                                  rdr.ref_lens)]
    rdr.close()
    for i in range(b.n):
        c0, c1 = b.cigar_off[i], b.cigar_off[i] + b.cigar_n[i]
        seq = b.seq_buf[b.seq_off[i]:b.seq_off[i] + b.read_len[i]]
        for w in writers:
            w.add_record(b.names[i], int(b.refid[i]), int(b.pos[i]),
                         int(b.flag[i]), int(b.mapq[i]),
                         b.cigar_op[c0:c1], b.cigar_oplen[c0:c1], seq,
                         zw=None if i % 3 else i / b.n)
    for w in writers:
        w.close()
    assert (tmp_path / "t.bam").read_bytes() == \
        (tmp_path / "j.bam").read_bytes()
    back = next(tbam.BamReader(str(tmp_path / "t.bam")).batches())
    assert back.n == b.n
    np.testing.assert_allclose(back.zw_tag[::3],
                               np.arange(0, b.n, 3) / b.n, rtol=1e-6)


def test_name_groups_stay_whole(tmp_path):
    """A read-name group never straddles a batch boundary (reference
    BAMQueue); 40 fragments of 3 records each at a cap of 32."""
    names, lens, seqs = targets()
    rng = np.random.default_rng(7)
    recs = []
    for i in range(40):
        for _ in range(3):
            t = int(rng.integers(0, len(names)))
            s = int(rng.integers(0, lens[t] - 60))
            recs.append(dict(name=f"g{i}", refid=t, pos=s, flag=0,
                             cigar="60M", seq=decode(seqs[t][s:s + 60])))
    path = str(tmp_path / "g.bam")
    tbam.write_bam(path, names, lens, recs)
    batches = list(tbam.BamReader(path, batch_records=32).batches())
    assert sum(b.n for b in batches) == 120
    for b in batches:
        _, counts = np.unique(b.name_hash, return_counts=True)
        assert (counts == 3).all()
    for a, b in zip(batches, batches[1:]):
        assert a.name_hash[a.n - 1] != b.name_hash[0]


def test_sample_fragments_matches_jax():
    rng = np.random.default_rng(3)
    fid = np.sort(rng.integers(0, 500, 3000))
    w = rng.random(3000)
    np.testing.assert_array_equal(
        tsampler.sample_fragments(np.random.default_rng(5), fid, w),
        jsampler.sample_fragments(np.random.default_rng(5), fid, w))
