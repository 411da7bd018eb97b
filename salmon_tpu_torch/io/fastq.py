"""Host FASTQ streaming into fixed-shape encoded batches.

Reference analog: the FQFeeder FastxParser producer threads feeding
5k-50k-read chunks to workers (src/quant/SalmonQuantify.cpp:2418-2443,
computeReadMiniBatchSize :157-184). Here the producer yields padded
(R, L) uint8 code arrays ready for host->device transfer; raggedness is
resolved on the host so the device work is fixed-shape.

Pure-Python reader: the port loads no native library.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Iterator, Optional, Sequence

import numpy as np

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


def iter_single_chunks(paths: Sequence[str], batch_size: int, max_len: int,
                       want_names: bool = False,
                       pick=None) -> Iterator[Optional[ReadChunk]]:
    """Stream single-end reads as fixed-shape chunks; with want_names
    each chunk carries its reads' names. With `pick`, chunk i is packed
    only where pick(i) holds, and is None elsewhere (a chunk that
    another process of a multi-process run maps)."""
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


def iter_paired_chunks(paths1: Sequence[str], paths2: Sequence[str],
                       batch_size: int, max_len: int,
                       want_names: bool = False,
                       pick=None) -> Iterator[Optional[PairedChunk]]:
    """Stream paired-end reads as fixed-shape chunk pairs; with
    want_names the left chunk carries the names of the first reads.
    `pick` as in iter_single_chunks."""
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
