"""The merge of the data-parallel mapping step over the ranks of a
multi-process run.

Counterpart of salmon_tpu/parallel/quant_step.py. The reference runs N
worker threads over disjoint read batches sharing one read-only index
(SURVEY.md §2.11 item 2, src/quant/SalmonQuantify.cpp:2460-2468); here
each rank maps its own chunk with the single-device pipeline against its
own copy of the index, and the fixed-size statistics of the batch are
summed over the world (merge_stats), the collective that replaces the
reference's merge of thread-local state (WorkerRuntimeContext.hpp:
22-70). The
variable eq-class tensors stay with the rank that mapped them.
"""

from __future__ import annotations

import torch

from salmon_tpu_torch.parallel.distributed import World

# per-batch outputs that are fixed-size statistics -> summed over ranks
_PSUM_KEYS = ("txp_mass", "fld_hist", "fmt_hist", "num_processed",
              "num_mapped", "num_paired", "num_orphans",
              "num_orphans_rescued", "num_decoy_fragments",
              "num_dovetail_fragments", "num_frags_filtered_vm",
              "num_alns_below_threshold", "seed_tail_over")


def merge_stats(world: World, out: dict) -> dict:
    """`out` with its _PSUM_KEYS summed over the world: one all-reduce
    of every statistic packed as float64 (exact for the counters; the
    float32 masses are summed in float64 and rounded once)."""
    keys = [k for k in _PSUM_KEYS if k in out]
    flat = torch.cat([out[k].reshape(-1).to(torch.float64) for k in keys])
    with world.timed("stats_allreduce"):
        flat = world.all_reduce_sum(flat)
    merged, pos = dict(out), 0
    for k in keys:
        n = out[k].numel()
        merged[k] = flat[pos:pos + n].reshape(out[k].shape).to(
            out[k].dtype)
        pos += n
    return merged

