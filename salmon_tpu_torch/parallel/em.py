"""Eq-class-sharded collapsed EM/VBEM over the ranks of a run.

Counterpart of salmon_tpu/parallel/em.py. The reference's offline EM
parallelizes with a TBB task_arena over equivalence classes (SURVEY.md
§2.11 item 5, src/inference/CollapsedEMOptimizer.cpp:187-233). Here the
CSR entry arrays are split over the ranks along the entries axis; each
iteration

  1. every rank computes per-class partial denominators from its own
     entries over GLOBAL class ids, and a sum over the ranks completes
     them (a class may straddle two ranks; the sum makes that
     irrelevant);
  2. each rank scatters its entries' contributions into a full-size
     alpha vector, and a second sum gives every rank the same new alpha.

alpha stays replicated (one float per transcript), so the stopping rule
reads the same value on every rank. A singleton class has one entry and
so lives on one rank: its full count is added once.
"""

from __future__ import annotations

import torch

from salmon_tpu_torch.constants import DEFAULTS
from salmon_tpu_torch.inference.em import DIGAMMA_MIN, MIN_EQ_WEIGHT, _seg_sum
from salmon_tpu_torch.parallel.distributed import World


def run_em_sharded(world: World, labels: torch.Tensor, seg: torch.Tensor,
                   counts: torch.Tensor, aux: torch.Tensor,
                   class_sizes: torch.Tensor, alpha0: torch.Tensor,
                   prior: torch.Tensor, eff_lens: torch.Tensor,
                   num_txps: int, use_vbem: bool, tol: float,
                   min_iter: int, max_iter: int,
                   alpha_cutoff: float = DEFAULTS.alpha_check_cutoff):
    """Sharded counterpart of inference.em.run_em, convergence tested
    every iteration as the JAX package's run_em_sharded does.

    Every rank passes the whole problem (the arguments of run_em, on its
    device) and works on its block of the entries. Returns (alpha,
    iterations, max_rel_diff), the same on every rank."""
    n_cl = counts.shape[0]
    n = labels.shape[0]
    per = -(-n // world.size)
    lo, hi = min(world.rank * per, n), min((world.rank + 1) * per, n)
    labels, seg, aux = labels[lo:hi], seg[lo:hi], aux[lo:hi]

    def psum(t):
        return world.all_reduce_sum(t)

    el = torch.clamp(eff_lens[labels], min=1.0)
    w = counts[seg] * aux / el
    denom_w = psum(_seg_sum(w, seg, n_cl))[seg]
    cw = torch.where(denom_w > 0, w / denom_w, 0.0)

    # markDegenerateClasses (parity with inference.em.run_em): the sum
    # is the same on every rank, and so is the mask
    denom0 = psum(_seg_sum(alpha0[labels] * cw, seg, n_cl))
    degenerate = (denom0 <= MIN_EQ_WEIGHT) & (class_sizes > 0)
    count_e = torch.where(degenerate, 0.0, counts)[seg]
    singleton = class_sizes[seg] == 1

    def step(alpha):
        if use_vbem:
            ap = alpha + prior
            log_norm = torch.digamma(ap.sum())
            base = torch.where(
                ap > DIGAMMA_MIN,
                torch.exp(torch.digamma(torch.clamp(ap, min=DIGAMMA_MIN))
                          - log_norm), 0.0)
        else:
            base = alpha
        gamma = base[labels] * cw
        d = psum(_seg_sum(gamma, seg, n_cl))[seg]
        contrib = torch.where(
            d > MIN_EQ_WEIGHT,
            count_e * gamma / torch.clamp(d, min=MIN_EQ_WEIGHT), 0.0)
        contrib = torch.where(singleton, count_e, contrib)
        return psum(_seg_sum(contrib, labels, num_txps))

    alpha, it, mrd, converged = alpha0, 0, float("inf"), False
    while it < min_iter or (it < max_iter and not converged):
        alpha_p = step(alpha)
        rel = torch.where(alpha_p > alpha_cutoff,
                          (alpha - alpha_p).abs()
                          / torch.clamp(alpha_p, min=1e-30), 0.0)
        mrd = float(rel.max()) if rel.numel() else 0.0
        converged = mrd <= tol
        alpha = alpha_p
        it += 1
    return alpha, it, mrd
