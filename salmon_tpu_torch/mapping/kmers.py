"""Canonical k-mer extraction over fixed-shape read batches.

Every window of every read in an (R, L) batch is packed into two u32
planes (hi, lo), canonicalized against its reverse complement, and
masked for validity (N bases, read bounds). Counterpart of
salmon_tpu/mapping/kmers.py; u32 values follow salmon_tpu_torch.utils.u32.

Packing convention matches salmon_tpu_torch.utils.dna: kmer = big-endian
2-bit codes; hi = first k-16 bases, lo = last 16 bases (hi = 0 when
k <= 16).
"""

from __future__ import annotations

import torch

from salmon_tpu_torch.utils.u32 import MASK32


def extract_kmers(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Extract canonical k-mers for every window of a read batch.

    Args:
      codes: (R, L) uint8 base codes (A=0..T=3, >=4 invalid/pad).
      lengths: (R,) int32 actual read lengths.
      k: k-mer length (odd, <= 31).

    Returns dict of (R, P) tensors with P = L - k + 1:
      hi, lo: int64 u32 canonical k-mer planes,
      is_fw:  bool — True if the forward-strand window equals the canonical,
      valid:  bool — window inside the read and free of invalid bases.
    """
    R, L = codes.shape
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"max read length {L} shorter than k={k}")
    c = codes.to(torch.int64)
    n_lo = min(k, 16)
    n_hi = k - n_lo

    def pack(js, complement: bool):
        """Bases at window offsets `js`, most significant first."""
        acc = torch.zeros((R, P), dtype=torch.int64, device=codes.device)
        for j in js:
            b = c[:, j:j + P]
            if complement:
                b = (3 - b) & MASK32
            acc = ((acc << 2) | b) & MASK32
        return acc

    zeros = torch.zeros((R, P), dtype=torch.int64, device=codes.device)
    fw_hi = pack(range(0, n_hi), False) if n_hi else zeros
    fw_lo = pack(range(n_hi, k), False)
    # base i of the reverse complement is 3 - window[k-1-i]
    rc_hi = pack(range(k - 1, k - 1 - n_hi, -1), True) if n_hi else zeros
    rc_lo = pack(range(k - 1 - n_hi, -1, -1), True)

    fw_le = (fw_hi < rc_hi) | ((fw_hi == rc_hi) & (fw_lo <= rc_lo))
    hi = torch.where(fw_le, fw_hi, rc_hi)
    lo = torch.where(fw_le, fw_lo, rc_lo)

    pos = torch.arange(P, dtype=torch.int32, device=codes.device)[None, :]
    in_read = pos + k <= lengths[:, None]
    bad = (codes >= 4).to(torch.int32)
    cum = torch.cat([torch.zeros((R, 1), dtype=torch.int32,
                                 device=codes.device),
                     torch.cumsum(bad, dim=1, dtype=torch.int32)], dim=1)
    window_bad = (cum[:, k:k + P] - cum[:, 0:P]) > 0
    valid = in_read & ~window_bad
    return {"hi": hi, "lo": lo, "is_fw": fw_le, "valid": valid}
