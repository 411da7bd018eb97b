"""The port's drivers, the counterparts of the repository's scripts/.

BASELINE config 5 and the human-scale accuracy checks:

    python -m salmon_tpu_torch.scripts.build_genome_scale_index [decoy_gb]
    python -m salmon_tpu_torch.scripts.demo_config5_quant [n_shards] [max_frags]
    python -m salmon_tpu_torch.scripts.check_hs_accuracy [n_batches]
    python -m salmon_tpu_torch.scripts.eval_hs_accuracy [out_dir]

The throughput harnesses:

    python -m salmon_tpu_torch.scripts.quant_window --index IDX -1 R1 -2 R2 ...
    python -m salmon_tpu_torch.scripts.bench_multihost [--procs 1,2,4] ...
    python -m salmon_tpu_torch.scripts.bench_alignment_mode [REPS]

The truth simulations:

    python -m salmon_tpu_torch.scripts.sim_seqbias
    python -m salmon_tpu_torch.scripts.sim_gcbias
    python -m salmon_tpu_torch.scripts.sim_posbias
    python -m salmon_tpu_torch.scripts.sim_paralog_gate [occ_cap=N ...]
    python -m salmon_tpu_torch.scripts.sim_rescue_recall

Each takes the argv, environment variables and printed keys of its
counterpart and runs on the GPU. Those that run the port in their own
process have main(argv=None, device="cuda"), which the tests call with
device="cpu"; the simulations write their data byte for byte as their
counterparts do, from the same seeds. quant_window and bench_multihost
start the port's CLI in subprocesses: quant_window's --salmon names
another command, and bench_multihost's --devices-per-proc N > 0 runs
CPU ranks.
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
