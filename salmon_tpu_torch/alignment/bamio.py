"""BAM input and output on the host.

Counterpart of salmon_tpu/alignment/bamio.py (reference analog: htslib
+ the BAMQueue producer thread,
include/salmon/internal/alignment/BAMQueue.hpp/.tpp). BamReader reads
through the port's native library (csrc/bamreader.cpp: BGZF blocks
inflated on a pool of SALMON_TPU_BAM_THREADS threads, 4 at most by
default); _PyBam, in pure Python, is its plain version. Records are
streamed as flat numpy arrays and grouped into fragments by read-name
hash adjacency (the reference likewise requires all records of a read
to be contiguous); a batch never splits a read-name group. name_hash is
the FNV-1a 64 of the read name, as in the JAX package: fragment grouping
rests on it.
"""

from __future__ import annotations

import dataclasses
import gzip
import re
import struct
import zlib
from typing import Iterator

import numpy as np

from salmon_tpu_torch import _native

# BAM flags
FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100

CIGAR_OPS = "MIDNSHP=X"


@dataclasses.dataclass
class BamBatch:
    """One flat batch of records + the shared seq/cigar pools."""
    refid: np.ndarray
    pos: np.ndarray
    flag: np.ndarray
    mapq: np.ndarray
    mate_refid: np.ndarray
    mate_pos: np.ndarray
    tlen: np.ndarray
    read_len: np.ndarray
    seq_off: np.ndarray
    cigar_off: np.ndarray
    cigar_n: np.ndarray
    as_tag: np.ndarray
    nm_tag: np.ndarray
    # ZW:f posterior weight (NaN when absent; written by --sampleOut)
    zw_tag: np.ndarray
    name_hash: np.ndarray
    seq_buf: np.ndarray
    cigar_op: np.ndarray
    cigar_oplen: np.ndarray
    n: int
    names: list = None


# per-record capacity of a batch's pools: read bases, CIGAR ops and name
# bytes (the JAX package's sizes)
SEQ_CAP, CIGAR_CAP, NAME_CAP = 512, 16, 256


class BamReader:
    """Streaming BAM reader on the native library."""

    def __init__(self, path: str, batch_records: int = 65536,
                 want_names: bool = False):
        self.path = path
        self.batch_records = batch_records
        self.want_names = want_names
        self._lib = _native.lib()
        self._h = self._lib.bam_open(str(path).encode())
        if not self._h:
            raise IOError(f"failed to open BAM {path}")
        n = self._lib.bam_n_refs(self._h)
        self.ref_names = [self._lib.bam_ref_name(self._h, i).decode()
                          for i in range(n)]
        self.ref_lens = np.array(
            [self._lib.bam_ref_len(self._h, i) for i in range(n)],
            dtype=np.int32)
        self.header_text = self._lib.bam_text_header(self._h).decode(
            errors="replace")

    def close(self):
        if self._h:
            self._lib.bam_close(self._h)
            self._h = None

    def batches(self) -> Iterator[BamBatch]:
        """Batches of up to batch_records records; each array holds the
        batch's own records (and pool entries) only."""
        cap = self.batch_records
        seq_cap, cigar_cap = cap * SEQ_CAP, cap * CIGAR_CAP

        def i32():
            return np.zeros(cap, np.int32)

        while True:
            b = BamBatch(
                refid=i32(), pos=i32(), flag=np.zeros(cap, np.uint16),
                mapq=np.zeros(cap, np.uint8), mate_refid=i32(),
                mate_pos=i32(), tlen=i32(), read_len=i32(),
                seq_off=np.zeros(cap, np.int64),
                cigar_off=np.zeros(cap, np.int64), cigar_n=i32(),
                as_tag=i32(), nm_tag=i32(),
                zw_tag=np.zeros(cap, np.float32),
                name_hash=np.zeros(cap, np.uint64),
                seq_buf=np.zeros(seq_cap, np.uint8),
                cigar_op=np.zeros(cigar_cap, np.uint8),
                cigar_oplen=np.zeros(cigar_cap, np.uint32), n=0)
            names_buf = np.zeros(cap * NAME_CAP if self.want_names else 0,
                                 np.uint8)
            n = int(self._lib.bam_next_batch(
                self._h, cap, seq_cap, cigar_cap, b.refid, b.pos, b.flag,
                b.mapq, b.mate_refid, b.mate_pos, b.tlen, b.read_len,
                b.seq_off, b.cigar_off, b.cigar_n, b.as_tag, b.nm_tag,
                b.zw_tag, b.name_hash, b.seq_buf, b.cigar_op,
                b.cigar_oplen, names_buf, names_buf.shape[0]))
            if n < 0:
                raise IOError(f"{self.path}: a BAM record larger than the "
                              f"batch buffers")
            if n == 0:
                return
            yield _trimmed(b, n, names_buf if self.want_names else None)


def _trimmed(b: BamBatch, n: int, names_buf) -> BamBatch:
    """Views of b's first n records and of the pool entries they use."""
    for f in ("refid", "pos", "flag", "mapq", "mate_refid", "mate_pos",
              "tlen", "read_len", "seq_off", "cigar_off", "cigar_n",
              "as_tag", "nm_tag", "zw_tag", "name_hash"):
        setattr(b, f, getattr(b, f)[:n])
    n_seq = int(b.seq_off[-1] + b.read_len[-1])
    n_cig = int(b.cigar_off[-1] + b.cigar_n[-1])
    b.seq_buf = b.seq_buf[:n_seq]
    b.cigar_op = b.cigar_op[:n_cig]
    b.cigar_oplen = b.cigar_oplen[:n_cig]
    b.n = n
    if names_buf is not None:
        b.names = names_buf.tobytes().split(b"\0")[:n]
        b.names += [b""] * (n - len(b.names))
    return b


# 4-bit BAM base code -> 0..3 (A, C, G, T), anything else 4 (N)
_SEQ4 = np.full(16, 4, dtype=np.uint8)
for _i, _b in [(1, 0), (2, 1), (4, 2), (8, 3)]:
    _SEQ4[_i] = _b


class _PyBam:
    def __init__(self, path: str):
        self._fh = gzip.open(path, "rb")  # gzip handles BGZF members
        magic = self._fh.read(4)
        if magic != b"BAM\x01":
            self._fh.close()
            raise IOError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", self._fh.read(4))
        self.header_text = self._fh.read(l_text).rstrip(
            b"\x00").decode(errors="replace")
        (n_ref,) = struct.unpack("<i", self._fh.read(4))
        self.ref_names, self.ref_lens = [], []
        for _ in range(n_ref):
            (ln,) = struct.unpack("<i", self._fh.read(4))
            nm = self._fh.read(ln)[:-1].decode()
            (lr,) = struct.unpack("<i", self._fh.read(4))
            self.ref_names.append(nm)
            self.ref_lens.append(lr)

    def close(self):
        self._fh.close()

    def _records(self):
        """Yield (row_tuple, hash, rname, seq, cigar, zw) per record."""
        while True:
            hdr = self._fh.read(4)
            if len(hdr) < 4:
                return
            (bs,) = struct.unpack("<i", hdr)
            rec = self._fh.read(bs)
            (refid, pos, lrn, mapq, _bin, ncig, flag, lseq, nrefid,
             npos, tlen) = struct.unpack("<iiBBHHHiiii", rec[:32])
            rname = rec[32:32 + lrn - 1]
            cig_at = 32 + lrn
            seq_at = cig_at + ncig * 4
            qual_at = seq_at + (lseq + 1) // 2
            tags_at = qual_at + lseq
            cig = np.frombuffer(rec[cig_at:seq_at], dtype=np.uint32)
            s4 = np.frombuffer(rec[seq_at:qual_at], dtype=np.uint8)
            hi = _SEQ4[s4 >> 4]
            lo = _SEQ4[s4 & 0xF]
            seq = np.empty(hi.size * 2, dtype=np.uint8)
            seq[0::2] = hi
            seq[1::2] = lo
            seq = seq[:lseq]
            as_v, nm_v, zw_v = self._tags(rec[tags_at:])
            # FNV-1a 64 of the read name
            h = 1469598103934665603
            for ch in rname:
                h = ((h ^ ch) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
            yield ((refid, pos, flag, mapq, nrefid, npos, tlen,
                    lseq, as_v, nm_v), h, bytes(rname), seq, cig, zw_v)

    def batches(self, cap: int,
                want_names: bool = False) -> Iterator[BamBatch]:
        it = self._records()
        carry = []  # deferred records (a name group moved whole)
        eof = False
        while not eof:
            items = carry
            carry = []
            while len(items) < cap:
                nxt = next(it, None)
                if nxt is None:
                    eof = True
                    break
                items.append(nxt)
            if not eof and len(items) == cap:
                # never split a read-name group across batches (the
                # reference BAMQueue keeps a read's records together)
                nxt = next(it, None)
                if nxt is None:
                    eof = True
                elif nxt[1] == items[-1][1]:
                    gh = items[-1][1]
                    gstart = len(items)
                    while gstart > 0 and items[gstart - 1][1] == gh:
                        gstart -= 1
                    if gstart > 0:
                        carry = items[gstart:] + [nxt]
                        items = items[:gstart]
                    else:  # whole batch is one group: split anyway
                        carry = [nxt]
                else:
                    carry = [nxt]
            if not items:
                return
            rows = [x[0] for x in items]
            hashes = [x[1] for x in items]
            names = [x[2] for x in items] if want_names else []
            seqs = [x[3] for x in items]
            cigars = [x[4] for x in items]
            zws = np.array([x[5] for x in items], np.float32)
            n = len(rows)
            arr = np.array(rows, dtype=np.int64)
            seq_off = np.zeros(n, np.int64)
            seq_off[1:] = np.cumsum([s.size for s in seqs[:-1]])
            cigar_off = np.zeros(n, np.int64)
            cigar_off[1:] = np.cumsum([c.size for c in cigars[:-1]])
            cig_all = (np.concatenate(cigars) if cigars
                       else np.zeros(0, np.uint32))
            yield BamBatch(
                refid=arr[:, 0].astype(np.int32),
                pos=arr[:, 1].astype(np.int32),
                flag=arr[:, 2].astype(np.uint16),
                mapq=arr[:, 3].astype(np.uint8),
                mate_refid=arr[:, 4].astype(np.int32),
                mate_pos=arr[:, 5].astype(np.int32),
                tlen=arr[:, 6].astype(np.int32),
                read_len=arr[:, 7].astype(np.int32),
                seq_off=seq_off,
                cigar_off=cigar_off,
                cigar_n=np.array([c.size for c in cigars], np.int32),
                as_tag=arr[:, 8].astype(np.int32),
                nm_tag=arr[:, 9].astype(np.int32),
                zw_tag=zws,
                name_hash=np.array(hashes, dtype=np.uint64),
                names=names if want_names else None,
                seq_buf=(np.concatenate(seqs) if seqs
                         else np.zeros(0, np.uint8)),
                cigar_op=(cig_all & 0xF).astype(np.uint8),
                cigar_oplen=(cig_all >> 4).astype(np.uint32),
                n=n)

    @staticmethod
    def _tags(buf: bytes):
        as_v, nm_v = np.iinfo(np.int32).min, np.iinfo(np.int32).min
        zw_v = float("nan")
        t = 0
        sizes = {"A": 1, "c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4,
                 "f": 4}
        fmts = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
                "I": "<I"}
        while t + 3 <= len(buf):
            t1, t2, ty = chr(buf[t]), chr(buf[t + 1]), chr(buf[t + 2])
            t += 3
            if ty in ("Z", "H"):
                end = buf.index(b"\0", t)
                t = end + 1
                continue
            if ty == "B":
                el = chr(buf[t])
                (cnt,) = struct.unpack("<i", buf[t + 1:t + 5])
                t += 5 + cnt * sizes.get(el, 4)
                continue
            sz = sizes.get(ty)
            if sz is None or t + sz > len(buf):
                break
            if ty in fmts:
                (val,) = struct.unpack(fmts[ty], buf[t:t + sz])
                if t1 == "A" and t2 == "S":
                    as_v = int(val)
                if t1 == "N" and t2 == "M":
                    nm_v = int(val)
            elif ty == "f" and t1 == "Z" and t2 == "W":
                (zw_v,) = struct.unpack("<f", buf[t:t + sz])
            t += sz
        return as_v, nm_v, zw_v


# ---------------------------------------------------------------------------
# Minimal BAM writer (tests, the scale BAM of chip_smoke.py, --sampleOut)

# ASCII base -> 4-bit BAM code (A C G T N; anything else is N)
_CODE4_OF_ASCII = np.full(256, 15, dtype=np.uint8)
for _c, _v in zip(b"ACGTN", (1, 2, 4, 8, 15)):
    _CODE4_OF_ASCII[_c] = _v


def pack_seq4(code4: np.ndarray) -> bytes:
    """4-bit BAM codes, two bases a byte, high nibble first; an odd
    length ends in a zero low nibble."""
    c = np.asarray(code4, np.uint8)
    if c.size % 2:
        c = np.append(c, np.uint8(0))
    return ((c[0::2] << 4) | c[1::2]).astype(np.uint8).tobytes()


def bam_header(ref_names, ref_lens) -> bytearray:
    """Magic, @SQ text and the binary reference list."""
    body = bytearray(b"BAM\x01")
    text = "".join(f"@SQ\tSN:{n}\tLN:{l}\n"
                   for n, l in zip(ref_names, ref_lens)).encode()
    body += struct.pack("<i", len(text)) + text
    body += struct.pack("<i", len(ref_names))
    for n, l in zip(ref_names, ref_lens):
        nb = n.encode() + b"\0"
        body += struct.pack("<i", len(nb)) + nb + struct.pack("<i", int(l))
    return body


def write_bam(path: str, ref_names, ref_lens, records) -> None:
    """records: iterable of dicts with keys name, refid, pos, flag, mapq,
    seq (str), cigar (str like '76M'), mate_refid, mate_pos, tlen,
    optional tags {'AS': int, 'NM': int}."""
    body = bam_header(ref_names, ref_lens)
    for r in records:
        name = r["name"].encode() + b"\0"
        cig_ops = [(int(m.group(1)) << 4) | CIGAR_OPS.index(m.group(2))
                   for m in re.finditer(r"(\d+)([MIDNSHP=X])",
                                        r.get("cigar", ""))]
        seq = r.get("seq", "").encode()
        s4 = pack_seq4(_CODE4_OF_ASCII[np.frombuffer(seq, np.uint8)])
        qual = b"\xff" * len(seq)
        tags = bytearray()
        for tag, val in (r.get("tags") or {}).items():
            tags += tag.encode() + b"i" + struct.pack("<i", int(val))
        rec = struct.pack(
            "<iiBBHHHiiii", r["refid"], r["pos"], len(name),
            r.get("mapq", 60), 0, len(cig_ops), r.get("flag", 0),
            len(seq), r.get("mate_refid", -1), r.get("mate_pos", -1),
            r.get("tlen", 0))
        rec += name
        rec += struct.pack(f"<{len(cig_ops)}I", *cig_ops)
        rec += s4 + qual + bytes(tags)
        body += struct.pack("<i", len(rec)) + rec

    with open(path, "wb") as fh:
        data = bytes(body)
        for i in range(0, len(data), 60000):
            fh.write(_bgzf_block(data[i:i + 60000]))
        fh.write(_bgzf_block(b""))  # EOF marker


def _bgzf_block(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    bsize = len(cdata) + 25 + 1
    hdr = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
           + struct.pack("<H", 6)  # xlen
           + b"BC" + struct.pack("<H", 2) + struct.pack("<H", bsize - 1))
    tail = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return hdr + cdata + tail
