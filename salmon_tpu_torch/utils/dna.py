"""Host-side DNA sequence encoding and k-mer utilities (numpy).

2-bit base encoding A=0 C=1 G=2 T=3 (reference analog:
include/salmon/internal/util/UtilityFunctions.hpp indexForKmer/kmerForIndex).
Invalid bases (N etc.) encode to 4 and poison any k-mer containing them.

K-mer convention: the k-mer starting at position p of a sequence s is the
big-endian 2-bit packing  sum_i s[p+i] * 4^(k-1-i)  held in a uint64
(k <= 31 => <= 62 bits). The canonical k-mer is min(fwd, revcomp).
"""

from __future__ import annotations

import numpy as np

# Fast ASCII -> 2-bit code translation table.
_ENCODE_LUT = np.full(256, 4, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3),
                   ("a", 0), ("c", 1), ("g", 2), ("t", 3)):
    _ENCODE_LUT[ord(_ch)] = _code
_DECODE_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode_seq(seq: str | bytes) -> np.ndarray:
    """Encode an ASCII DNA string to uint8 codes (A=0,C=1,G=2,T=3,other=4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _ENCODE_LUT[raw]


def decode_seq(codes: np.ndarray) -> str:
    """Inverse of encode_seq (invalid -> 'N')."""
    return _DECODE_LUT[np.minimum(codes, 4)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of encoded bases; invalid stays invalid."""
    out = codes[::-1].copy()
    valid = out < 4
    out[valid] = 3 - out[valid]
    return out


def kmers_of(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All forward k-mers of an encoded sequence.

    Returns (kmers uint64 of shape [n-k+1], valid bool mask). K-mers
    containing an invalid base are masked out (value undefined).
    """
    n = codes.shape[0]
    if n < k:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)
    npos = n - k + 1
    c64 = codes.astype(np.uint64)
    # rolling pack: kmer[p] = (kmer[p-1] << 2 | c[p+k-1]) & mask, vectorized
    # via strided windows for clarity; n is transcript-scale so this is cheap.
    windows = np.lib.stride_tricks.sliding_window_view(c64, k)
    powers = (np.uint64(1) << (np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64)))
    kmers = (windows * powers[None, :]).sum(axis=1, dtype=np.uint64)
    invalid = codes >= 4
    if invalid.any():
        bad_window = (np.lib.stride_tricks.sliding_window_view(invalid, k)).any(axis=1)
        valid = ~bad_window
    else:
        valid = np.ones(npos, dtype=bool)
    return kmers, valid


def revcomp_kmers(kmers: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of packed k-mers (vectorized uint64 bit tricks)."""
    x = (~kmers) & np.uint64((1 << (2 * k)) - 1)  # complement each base (3-b)
    # reverse 2-bit groups within 64 bits
    x = ((x & np.uint64(0x3333333333333333)) << np.uint64(2)) | \
        ((x & np.uint64(0xCCCCCCCCCCCCCCCC)) >> np.uint64(2))
    x = ((x & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4)) | \
        ((x & np.uint64(0xF0F0F0F0F0F0F0F0)) >> np.uint64(4))
    x = ((x & np.uint64(0x00FF00FF00FF00FF)) << np.uint64(8)) | \
        ((x & np.uint64(0xFF00FF00FF00FF00)) >> np.uint64(8))
    x = ((x & np.uint64(0x0000FFFF0000FFFF)) << np.uint64(16)) | \
        ((x & np.uint64(0xFFFF0000FFFF0000)) >> np.uint64(16))
    x = (x << np.uint64(32)) | (x >> np.uint64(32))
    # shift down so the k bases sit in the low 2k bits
    return x >> np.uint64(64 - 2 * k)


def canonical_kmers(kmers: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Canonicalize packed k-mers. Returns (canonical, is_forward)."""
    rc = revcomp_kmers(kmers, k)
    fw = kmers <= rc
    return np.where(fw, kmers, rc), fw
