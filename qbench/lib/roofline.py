"""Peaks of the card and the least time of the banded DP's work, frozen
copies kept with the benchmark for the kernel's roofline metric, which
waits for per-launch counts from inside the captured batch step (no
metric reads this module yet).

PEAKS: NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense
rates. The DP is counted as the repository's chip_smoke.dp_bound_ms
counts it: DP_OPS_PER_CELL operations a band cell, divided by the fp32
rate outside the tensor cores. The kernel computes in int32 on DPX
add-max since it was redesigned, so the label says which peak divides:
a share against the fp32 peak is not a share of the int32 one.
"""

from __future__ import annotations

PEAKS = {
    "fp32_flops": 67e12,          # outside the tensor cores
    "hbm_bytes_per_s": 3.35e12,
}
PEAK_LABEL = "H100 SXM data sheet, fp32 (non-tensor) 67 TFLOP/s, HBM3 3.35 TB/s"
DP_OPS_PER_CELL = 12


def dp_bound_s(rows: int, problems: int, reads_bytes: int, read_len: int,
               bw: int, seq_off_bytes: int = 4, softclip: bool = False):
    """(least seconds, "operations" or "bytes") of one banded-DP launch:
    `rows` read rows aligned over all problems (each B = 2 bw + 1 band
    cells), against the bytes each input must be read once (the reads,
    five int32 vectors and the offset per problem, each problem's 2-bit
    window) and the scores written."""
    B = 2 * bw + 1
    ops = rows * B * (DP_OPS_PER_CELL + int(softclip))
    window_words = (read_len + B - 1 + 15) // 16 + 1
    nbytes = (reads_bytes + problems * (5 * 4 + seq_off_bytes)
              + problems * window_words * 4 + problems * 4)
    t_ops = ops / PEAKS["fp32_flops"]
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
