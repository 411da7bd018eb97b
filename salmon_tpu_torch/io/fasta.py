"""Host FASTA reading (reference analog: src/io/FASTAParser.cpp, plus the
fixFasta preprocessing done by pufferfish during index build: poly-A clipping,
duplicate handling, gencode '|' name splitting).
"""

from __future__ import annotations

import dataclasses
import gzip
import hashlib
from typing import Iterator

import numpy as np

from salmon_tpu_torch.utils.dna import encode_seq


@dataclasses.dataclass
class TranscriptRecord:
    name: str
    seq_codes: np.ndarray  # uint8 2-bit codes (4 = N)
    complete_length: int


def _open_maybe_gz(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def iter_fasta(path: str, gencode: bool = False) -> Iterator[tuple[str, str]]:
    """Yield (name, sequence) from a (possibly gzipped) FASTA file.

    Name = first whitespace token of the header; if gencode, additionally
    truncated at the first '|' (reference: FASTAParser.cpp:16-30 and
    BuildSalmonIndex.cpp --gencode handling).
    """
    name = None
    chunks: list[str] = []
    with _open_maybe_gz(path) as fh:
        for line in fh:
            line = line.rstrip()
            if not line:
                continue
            if line[0] == ">":
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                if gencode:
                    name = name.split("|")[0]
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, "".join(chunks)


def clip_polya(codes: np.ndarray, min_tail: int = 10) -> np.ndarray:
    """Clip a trailing poly-A tail (reference: pufferfish fixFasta behavior;
    salmon exposes --no-clip-polya / IndexOptions.noclip_polya)."""
    n = codes.shape[0]
    i = n
    while i > 0 and codes[i - 1] == 0:  # A == 0
        i -= 1
    if n - i >= min_tail:
        return codes[:i]
    return codes


def load_transcripts(
    path: str,
    gencode: bool = False,
    noclip_polya: bool = False,
    keep_duplicates: bool = True,
) -> tuple[list[TranscriptRecord], dict]:
    """Load and preprocess transcripts for indexing/quantification.

    Returns (records, info) where info carries SHA-256 hashes of the
    concatenated sequences and names (reference: info.json SeqHash256 /
    NameHash256 fields written by pufferfish; checked at load in
    SalmonIndex.hpp) and the list of removed duplicate names.
    """
    records: list[TranscriptRecord] = []
    seq_hasher = hashlib.sha256()
    name_hasher = hashlib.sha256()
    seq_hasher512 = hashlib.sha512()
    name_hasher512 = hashlib.sha512()
    seen: dict[bytes, str] = {}
    dups: list[tuple[str, str]] = []
    seen_names: set[str] = set()
    for name, seq in iter_fasta(path, gencode=gencode):
        if name in seen_names:
            raise ValueError(f"duplicate transcript name '{name}' in {path}")
        seen_names.add(name)
        seq_hasher.update(seq.encode("ascii"))
        name_hasher.update(name.encode("ascii"))
        seq_hasher512.update(seq.encode("ascii"))
        name_hasher512.update(name.encode("ascii"))
        codes = encode_seq(seq)
        complete_length = codes.shape[0]
        if not noclip_polya:
            codes = clip_polya(codes)
        if not keep_duplicates:
            key = hashlib.sha1(codes.tobytes()).digest()
            if key in seen:
                dups.append((name, seen[key]))
                continue
            seen[key] = name
        records.append(TranscriptRecord(name, codes, complete_length))
    # key names follow the reference's info.json schema
    # (SalmonIndex.hpp:139-144)
    info = {
        "SeqHash": seq_hasher.hexdigest(),
        "NameHash": name_hasher.hexdigest(),
        "SeqHash512": seq_hasher512.hexdigest(),
        "NameHash512": name_hasher512.hexdigest(),
        "SeqHash256": seq_hasher.hexdigest(),
        "NameHash256": name_hasher.hexdigest(),
        "duplicates_removed": dups,
    }
    return records, info
