"""Host FASTQ streaming into fixed-shape encoded batches.

Reference analog: the FQFeeder FastxParser producer threads feeding
5k-50k-read chunks to workers (src/quant/SalmonQuantify.cpp:2418-2443,
computeReadMiniBatchSize :157-184). Here the producer yields padded
(R, L) uint8 code arrays ready for host->device transfer; raggedness is
resolved on the host so the device work is fixed-shape.

The entry points read through the port's native library
(csrc/fastqreader.cpp: plain or gzipped FASTQ or FASTA, via zlib); the
Python reader (`_iter_single_chunks_py`, `_iter_paired_chunks_py`) is
their plain version.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
from typing import Iterator, Optional, Sequence

import numpy as np

from salmon_tpu_torch import _native
from salmon_tpu_torch.utils.dna import encode_seq


@dataclasses.dataclass
class ReadChunk:
    """One fixed-shape chunk of encoded reads (padded with invalid=4)."""
    codes: np.ndarray            # (R, L) uint8
    lengths: np.ndarray          # (R,) int32; 0 for padding rows
    n_valid: int = 0             # number of real reads in this chunk
    names: Optional[list] = None  # their names (bytes), when asked for


@dataclasses.dataclass
class PairedChunk:
    left: ReadChunk
    right: ReadChunk

    @property
    def n_valid(self) -> int:
        return self.left.n_valid


def _open_maybe_gz(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _iter_fastq_seqs(path: str, want_names: bool = False):
    """Yield the sequence bytes of each record of a FASTQ/FASTA file, or
    (name, sequence) with want_names (the name is the header's first
    word)."""
    with _open_maybe_gz(path) as fh:
        first = fh.read(1)
        fh.seek(0)
        if first == b">":  # FASTA reads
            name, chunks = None, []
            for line in fh:
                line = line.rstrip()
                if line.startswith(b">"):
                    if name is not None:
                        seq = b"".join(chunks)
                        yield (name, seq) if want_names else seq
                    name = line[1:].split()[0]
                    chunks = []
                else:
                    chunks.append(line)
            if name is not None:
                seq = b"".join(chunks)
                yield (name, seq) if want_names else seq
            return
        while True:
            hdr = fh.readline()
            if not hdr:
                return
            seq = fh.readline().rstrip()
            fh.readline()  # '+'
            fh.readline()  # quals
            if want_names:
                yield hdr[1:].rstrip().split()[0], seq
            else:
                yield seq


#: length buckets so batch shapes take only a handful of values per run
LEN_BUCKETS = (64, 96, 128, 160, 192, 256, 384, 512, 1024)


def bucket_len(n: int, cap: int) -> int:
    """Smallest bucketed length >= n (capped)."""
    for b in LEN_BUCKETS:
        if b >= min(n, cap):
            return min(b, cap)
    return cap


def pack_seqs(seqs: Sequence[bytes], batch_size: int, max_len: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """Pack a list of byte sequences into a padded (R, L) code array."""
    n = len(seqs)
    lens = np.fromiter((min(len(s), max_len) for s in seqs), dtype=np.int32,
                       count=n)
    out = np.full((batch_size, max_len), 4, dtype=np.uint8)
    if n:
        flat = encode_seq(b"".join(s[:max_len] for s in seqs))
        mask = np.arange(max_len, dtype=np.int32)[None, :] < lens[:, None]
        full_mask = np.zeros((batch_size, max_len), dtype=bool)
        full_mask[:n] = mask
        out[full_mask] = flat
    full_lens = np.zeros(batch_size, dtype=np.int32)
    full_lens[:n] = lens
    return out, full_lens


# bytes of name buffer a read, as in the JAX package's native reader: a
# call's names past (reads x NAME_BYTES) bytes come back empty
NAME_BYTES = 256


class NativeFastqReader:
    """One FASTQ/FASTA file (plain or gzipped) read in batches by the
    native library."""

    def __init__(self, path: str, max_len: int, want_names: bool = False):
        self._lib = _native.lib()
        self._h = self._lib.fastq_open(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open {path}")
        self.path = path
        self.max_len = max_len
        self.want_names = want_names

    def read_into(self, codes: np.ndarray, lens: np.ndarray):
        """Fill up to codes.shape[0] rows of codes (uint8, max_len wide;
        every row first set to 4) and lens (int32, each read's length
        cut at max_len). Returns (n, names or None); n = 0 at the end."""
        rows = codes.shape[0]
        names_buf = np.zeros(rows * NAME_BYTES if self.want_names else 0,
                             np.uint8)
        n = int(self._lib.fastq_next_batch(
            self._h, rows, self.max_len, codes, lens, names_buf,
            names_buf.shape[0]))
        if n < 0:
            raise IOError(f"{self.path}: malformed FASTQ/FASTA record")
        np.minimum(lens[:n], self.max_len, out=lens[:n])
        names = None
        if self.want_names:
            names = names_buf.tobytes().split(b"\0")[:n]
            names += [b""] * (n - len(names))
        return n, names

    def close(self):
        if self._h:
            self._lib.fastq_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _native_batches(paths: Sequence[str], batch_size: int, max_len: int,
                    want_names: bool, paths2=None):
    """Chunks of batch_size reads (the last may be short) over the files
    in turn, a chunk running on into the next file as the plain reader's
    do: yields (n, [(codes (batch_size, max_len), lens) per mate], names
    or None). With paths2, mates are read in step from the second
    list."""
    mates = 1 if paths2 is None else 2

    def fresh():
        return [(np.empty((batch_size, max_len), np.uint8),
                 np.zeros(batch_size, np.int32)) for _ in range(mates)]

    bufs, names, n = fresh(), [], 0
    for files in zip(paths, *([paths2] if mates == 2 else [])):
        with contextlib.ExitStack() as stack:
            rdrs = [stack.enter_context(
                NativeFastqReader(f, max_len, want_names and m == 0))
                for m, f in enumerate(files)]
            while True:
                got = [r.read_into(c[n:], ln[n:])
                       for r, (c, ln) in zip(rdrs, bufs)]
                if len({g for g, _ in got}) != 1:
                    raise IOError(f"paired files {files[0]}/{files[1]} "
                                  f"differ in length")
                g, nm = got[0]
                if g == 0:
                    break
                if want_names:
                    names += nm
                n += g
                if n == batch_size:
                    yield n, bufs, names if want_names else None
                    bufs, names, n = fresh(), [], 0
    if n:
        yield n, bufs, names if want_names else None


def iter_single_chunks(paths: Sequence[str], batch_size: int, max_len: int,
                       want_names: bool = False,
                       pick=None) -> Iterator[Optional[ReadChunk]]:
    """Stream single-end reads as fixed-shape chunks; with want_names
    each chunk carries its reads' names. With `pick`, chunk i is packed
    only where pick(i) holds, and is None elsewhere (a chunk that
    another process of a multi-process run maps)."""
    for i, (n, [(codes, lens)], names) in enumerate(
            _native_batches(paths, batch_size, max_len, want_names)):
        if pick is not None and not pick(i):
            yield None
            continue
        L = bucket_len(int(lens.max()), max_len)
        yield ReadChunk(np.ascontiguousarray(codes[:, :L]), lens, n, names)


def iter_paired_chunks(paths1: Sequence[str], paths2: Sequence[str],
                       batch_size: int, max_len: int,
                       want_names: bool = False,
                       pick=None) -> Iterator[Optional[PairedChunk]]:
    """Stream paired-end reads as fixed-shape chunk pairs, one width for
    both mates; with want_names the left chunk carries the names of the
    first reads. `pick` as in iter_single_chunks. Mate files that differ
    in length raise IOError."""
    if len(paths1) != len(paths2):
        raise ValueError("paired-end file lists must have equal length")
    for i, (n, [(c1, l1), (c2, l2)], names) in enumerate(
            _native_batches(paths1, batch_size, max_len, want_names,
                            paths2)):
        if pick is not None and not pick(i):
            yield None
            continue
        L = bucket_len(max(int(l1.max()), int(l2.max())), max_len)
        yield PairedChunk(
            ReadChunk(np.ascontiguousarray(c1[:, :L]), l1, n, names),
            ReadChunk(np.ascontiguousarray(c2[:, :L]), l2, n))


def _iter_single_chunks_py(paths: Sequence[str], batch_size: int,
                           max_len: int, want_names: bool = False,
                           pick=None) -> Iterator[Optional[ReadChunk]]:
    """Plain version of iter_single_chunks, in Python."""
    seqs: list[bytes] = []
    names: list[bytes] = []
    n_chunks = 0

    def chunk() -> Optional[ReadChunk]:
        nonlocal n_chunks
        n_chunks += 1
        if pick is not None and not pick(n_chunks - 1):
            return None
        L = bucket_len(max(len(x) for x in seqs), max_len)
        return ReadChunk(*pack_seqs(seqs, batch_size, L), len(seqs),
                         names if want_names else None)

    for path in paths:
        for rec in _iter_fastq_seqs(path, want_names):
            if want_names:
                nm, rec = rec
                names.append(nm)
            seqs.append(rec)
            if len(seqs) == batch_size:
                yield chunk()
                seqs, names = [], []
    if seqs:
        yield chunk()


def _iter_paired_chunks_py(paths1: Sequence[str], paths2: Sequence[str],
                           batch_size: int, max_len: int,
                           want_names: bool = False,
                           pick=None) -> Iterator[Optional[PairedChunk]]:
    """Plain version of iter_paired_chunks, in Python."""
    if len(paths1) != len(paths2):
        raise ValueError("paired-end file lists must have equal length")
    s1: list[bytes] = []
    s2: list[bytes] = []
    names: list[bytes] = []
    n_chunks = 0

    def chunk() -> Optional[PairedChunk]:
        nonlocal n_chunks
        n_chunks += 1
        if pick is not None and not pick(n_chunks - 1):
            return None
        L = bucket_len(max(max(len(x) for x in s1), max(len(x) for x in s2)),
                       max_len)
        c1, l1 = pack_seqs(s1, batch_size, L)
        c2, l2 = pack_seqs(s2, batch_size, L)
        n = len(s1)
        return PairedChunk(ReadChunk(c1, l1, n,
                                     names if want_names else None),
                           ReadChunk(c2, l2, n))

    for p1, p2 in zip(paths1, paths2):
        for a, b in zip(_iter_fastq_seqs(p1, want_names),
                        _iter_fastq_seqs(p2)):
            if want_names:
                nm, a = a
                names.append(nm)
            s1.append(a)
            s2.append(b)
            if len(s1) == batch_size:
                yield chunk()
                s1, s2, names = [], [], []
    if s1:
        yield chunk()
