"""The port's scripts at genome-decoy and human scale, the counterparts
of the repository's scripts/ (BASELINE config 5 and the human-scale
accuracy checks):

    python -m salmon_tpu_torch.scripts.build_genome_scale_index [decoy_gb]
    python -m salmon_tpu_torch.scripts.demo_config5_quant [n_shards] [max_frags]
    python -m salmon_tpu_torch.scripts.check_hs_accuracy [n_batches]
    python -m salmon_tpu_torch.scripts.eval_hs_accuracy [out_dir]

Each takes the argv, environment variables and printed keys of its
counterpart, runs on the GPU, and has main(argv=None, device="cuda"),
which the tests call with device="cpu".
"""

from __future__ import annotations

import os

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """BENCH_CACHE, by default ~/.cache/salmon_tpu_bench (the harness's
    cache: txome, reads_{1,2}.fastq, hs_idx, genome_idx)."""
    return os.environ.get(
        "BENCH_CACHE", os.path.join(os.path.expanduser("~"), ".cache",
                                    "salmon_tpu_bench"))


def require_device(device, prog: str) -> torch.device:
    """`device` as a torch device; a CUDA device that is not there
    raises (these scripts have no CPU fallback: the CPU runs only when the
    caller asks for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{prog} runs on the GPU and no CUDA device is "
                           "visible (main(device='cpu') runs it on the "
                           "CPU)")
    return device
