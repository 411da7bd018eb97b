"""Two-choice bucket hash lookup of canonical k-mers.

The table is built on the host by salmon_tpu_torch.index.hashtable: one
(8 x int32) row per 4-slot bucket, [fpcnt, start] interleaved per slot,
each key living in one of its two candidate buckets. A query is two row
gathers plus eight fingerprint compares. Counterpart of
salmon_tpu/mapping/lookup.py; the hashes must match
index.hashtable bit for bit. u32 values follow salmon_tpu_torch.utils.u32.
"""

from __future__ import annotations

import torch

from salmon_tpu_torch.utils.u32 import mul32, to_u32

SLOTS_PER_BUCKET = 4


def mix32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """First bucket hash (hashtable.mix32)."""
    x = lo ^ mul32(hi, 0x9E3779B9) ^ 0x85EBCA6B
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def mix32b(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Second bucket hash (hashtable.mix32b)."""
    x = hi ^ mul32(lo, 0x85EBCA77) ^ 0xC2B2AE3D
    x = x ^ (x >> 17)
    x = mul32(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = mul32(x, 0xAC4C1B51)
    return x ^ (x >> 15)


def fingerprint16(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Third-mix 16-bit fingerprint (hashtable.fingerprint16)."""
    x = hi ^ mul32(lo, 0xCC9E2D51) ^ 0x1B873593
    x = x ^ (x >> 15)
    x = mul32(x, 0xD168AAAD)
    x = x ^ (x >> 15)
    x = mul32(x, 0xAF723597)
    x = x ^ (x >> 15)
    return x >> 16


def fingerprint30(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Fourth-mix 30-bit segment fingerprint (hashtable.fingerprint30),
    compared against separator records of shadow-merged blocks."""
    x = lo ^ mul32(hi, 0x27D4EB2F) ^ 0x165667B1
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >> 2


def hash_lookup(hi: torch.Tensor, lo: torch.Tensor, tab_rows: torch.Tensor,
                n_slots: int, max_probes: int = 2 * SLOTS_PER_BUCKET):
    """Look up canonical k-mers in the two-choice bucket table.

    Args:
      hi, lo: (...,) u32 query key planes (int64 carriers).
      tab_rows: (n_buckets, 8) int32 bucket rows
        (slot s at lanes [2s] = fp16<<16 | count16, [2s+1] = CSR start).
      n_slots: total slot count = n_buckets * 4.
      max_probes: slots examined per query (8 = both buckets).

    Returns (start, count, found, inl, itxp, ipf), int32/bool:
      start/count: occurrence CSR range (start=-1/count=0 when not
        found; start=-2 for inlined slots);
      inl: slot stores its single record inline (start-lane bit 31);
      itxp/ipf: the decoded inline record (undefined when ~inl).
    """
    mask = n_slots // SLOTS_PER_BUCKET - 1
    b1 = mix32(hi, lo) & mask
    b2 = mix32b(hi, lo) & mask
    fp = fingerprint16(hi, lo)
    r1 = to_u32(tab_rows[b1])
    r2 = to_u32(tab_rows[b2])
    f1 = r1[..., 0::2]
    f2 = r2[..., 0::2]
    m1 = ((f1 >> 16) == fp[..., None]) & (f1 != 0)
    m2 = ((f2 >> 16) == fp[..., None]) & (f2 != 0)
    in1 = m1.any(dim=-1)
    found = in1 | m2.any(dim=-1)
    row = torch.where(in1[..., None], r1, r2)
    match = torch.where(in1[..., None], m1, m2)
    fpcnt = row[..., 0::2]
    st = row[..., 1::2]
    start = torch.full_like(b1, -1)
    count = torch.zeros_like(b1)
    inl = torch.zeros_like(found)
    itxp = torch.zeros_like(b1)
    ipf = torch.zeros_like(b1)
    # first matching slot wins: walk the slots last to first
    for p in range(min(max_probes, SLOTS_PER_BUCKET) - 1, -1, -1):
        m = match[..., p]
        stp = st[..., p]
        fcp = fpcnt[..., p]
        is_inl = (stp >> 31) == 1
        low31 = stp & 0x7FFFFFFF
        hi16 = fcp & 0xFFFF
        start = torch.where(m, torch.where(is_inl, -2, stp), start)
        count = torch.where(m, torch.where(is_inl, 1, hi16), count)
        inl = torch.where(m, is_inl, inl)
        itxp = torch.where(m & is_inl, (hi16 << 2) | (low31 >> 29), itxp)
        ipf = torch.where(m & is_inl, low31 & ((1 << 29) - 1), ipf)
    i32 = torch.int32
    return (start.to(i32), count.to(i32), found, inl, itxp.to(i32),
            ipf.to(i32))
