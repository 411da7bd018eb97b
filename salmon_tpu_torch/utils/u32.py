"""Unsigned 32-bit arithmetic on torch tensors — one rule for the port.

A u32 VALUE (k-mer planes, hashes, fingerprints, packed sort keys) is an
int64 tensor holding [0, 2**32). With that carrier, >>, <<, &, |, ^ and
the comparisons mean exactly what they mean on uint32 (torch.uint32 has
no shifts or ordering on the CPU, and int32 would need emulated logical
shifts). Only products and left shifts can leave the range: mask them
with MASK32, and multiply through mul32, which keeps every partial
product below 2**49 so nothing wraps int64.

Bit-pattern PLANES that are only stored and gathered (the bucket table
rows, the occurrence records, the 2-bit sequence words) stay int32: the
same 32 bits, viewed signed. to_u32 turns such a lane into a value.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for u32 values x and a constant c."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def to_u32(t: torch.Tensor) -> torch.Tensor:
    """An int32 bit-pattern lane (or any integer tensor) as u32 values."""
    return t.to(torch.int64) & MASK32
