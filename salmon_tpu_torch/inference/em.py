"""Collapsed EM / VBEM over CSR-packed equivalence classes.

Counterpart of salmon_tpu/inference/em.py (reference
src/inference/CollapsedEMOptimizer.cpp — EMUpdate_ :179-234, VBEMUpdate_
:242-328, optimize :733-1040, populatePriorAlphas_ :82-99).

One iteration is a gather of alpha by entry label, a per-class
index_add_ for the denominators, and a per-transcript index_add_ for
the new alphas — at every size. (The JAX package switches to a
sort-routed layout at 65,536 entries because gathers are dear on the
TPU; this port keeps one formulation.) float32 on the device; the
convergence test runs on the host. Below ROUTED_MIN_ENTRIES it runs
after every iteration, as the reference checks every iteration; from
ROUTED_MIN_ENTRIES on it runs after each chunk of EM_CHUNK iterations,
as the JAX package's routed engine does, so that both stop after the
same number of iterations.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from salmon_tpu_torch.constants import DEFAULTS
from salmon_tpu_torch.inference.eqclasses import PackedEqClasses

MIN_EQ_WEIGHT = 1e-30     # minEQClassWeight analog
DIGAMMA_MIN = 1e-10
# From this many eq-class entries on, the JAX package runs its routed
# engine, which tests convergence only after each chunk of EM_CHUNK
# iterations (salmon_tpu/inference/fastem.py:285, :399-408); the port
# keeps its formulation and takes the same stopping rule there.
ROUTED_MIN_ENTRIES = 65_536
EM_CHUNK = 100


@dataclasses.dataclass
class EMConfig:
    use_vbem: bool = not DEFAULTS.use_em
    vb_prior: float = DEFAULTS.vb_prior
    per_transcript_prior: bool = DEFAULTS.per_transcript_prior
    rel_diff_tolerance: float = DEFAULTS.relative_diff_tolerance
    max_iterations: int = DEFAULTS.max_em_iterations
    min_iterations: int = DEFAULTS.min_required_iterations
    alpha_check_cutoff: float = DEFAULTS.alpha_check_cutoff
    min_alpha: float = DEFAULTS.min_alpha


def _seg_sum(values: torch.Tensor, index: torch.Tensor, n: int):
    return torch.zeros(n, dtype=values.dtype,
                       device=values.device).index_add_(0, index, values)


def run_em(labels: torch.Tensor, seg: torch.Tensor, counts: torch.Tensor,
           aux: torch.Tensor, class_sizes: torch.Tensor,
           alpha0: torch.Tensor, prior: torch.Tensor,
           eff_lens: torch.Tensor, num_txps: int, use_vbem: bool,
           tol: float, min_iter: int, max_iter: int,
           alpha_cutoff: float = DEFAULTS.alpha_check_cutoff):
    """The optimization loop.

    labels/seg/aux: (E,) per-entry transcript, class and aux weight;
    counts/class_sizes: (Cl,) per class. Returns (alpha, n_iters,
    max_rel_diff, n_degenerate, available)."""
    n_cl = counts.shape[0]
    # combinedWeights (reference optimize :830-873): count * aux /
    # effLen, normalized within each class
    el = torch.clamp(eff_lens[labels], min=1.0)
    w = counts[seg] * aux / el
    denom_w = _seg_sum(w, seg, n_cl)[seg]
    cw = torch.where(denom_w > 0, w / denom_w, 0.0)

    # markDegenerateClasses (reference :331-394): classes whose initial
    # combined weight is ~0 drop out of every update
    denom0 = _seg_sum(alpha0[labels] * cw, seg, n_cl)
    degenerate = (denom0 <= MIN_EQ_WEIGHT) & (class_sizes > 0)
    counts = torch.where(degenerate, 0.0, counts)
    # transcripts in surviving classes
    available = _seg_sum((~degenerate[seg]).to(torch.float32), labels,
                         num_txps) > 0

    count_e = counts[seg]
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
        d = _seg_sum(gamma, seg, n_cl)[seg]
        contrib = torch.where(
            d > MIN_EQ_WEIGHT,
            count_e * gamma / torch.clamp(d, min=MIN_EQ_WEIGHT), 0.0)
        # singleton classes always get their full count (reference
        # :225-227)
        contrib = torch.where(singleton, count_e, contrib)
        return _seg_sum(contrib, labels, num_txps)

    def max_rel_diff(alpha, alpha_p):
        rel = torch.where(alpha_p > alpha_cutoff,
                          (alpha - alpha_p).abs()
                          / torch.clamp(alpha_p, min=1e-30), 0.0)
        return float(rel.max()) if rel.numel() else 0.0

    alpha = alpha0
    it = 0
    mrd = float("inf")
    if labels.shape[0] >= ROUTED_MIN_ENTRIES:
        # chunked stopping rule: the relative difference of each chunk's
        # last iteration, read after the chunk
        while it < max_iter:
            for _ in range(min(EM_CHUNK, max_iter - it)):
                alpha_prev, alpha = alpha, step(alpha)
                it += 1
            mrd = max_rel_diff(alpha_prev, alpha)
            if it >= min_iter and mrd <= tol:
                break
    else:
        converged = False
        while it < min_iter or (it < max_iter and not converged):
            alpha_p = step(alpha)
            mrd = max_rel_diff(alpha, alpha_p)
            converged = mrd <= tol
            alpha = alpha_p
            it += 1
    return alpha, it, mrd, int(degenerate.sum()), available


def initial_alphas(num_txps: int, online_mass: Optional[np.ndarray],
                   total_mapped: float, init_uniform: bool = False,
                   num_required_frags: float = 5e7,
                   alt_init: bool = False) -> np.ndarray:
    """Linear blend of online estimates and uniform (reference optimize
    :800-823); alt_init blends with a per-transcript mass of 1.0."""
    if online_mass is None or init_uniform:
        return np.full(num_txps, max(total_mapped, 1.0) / max(num_txps, 1))
    frac = min(0.999, total_mapped / max(num_required_frags, 1.0))
    uniform = 1.0 if alt_init else total_mapped / max(num_txps, 1)
    return online_mass * frac + uniform * (1.0 - frac)


def prior_alphas(num_txps: int, eff_lens: np.ndarray, prior_value: float,
                 per_transcript: bool) -> np.ndarray:
    """Reference populatePriorAlphas_ (:82-99)."""
    if per_transcript:
        return np.full(num_txps, prior_value)
    return prior_value * eff_lens


def optimize(eq: PackedEqClasses, num_txps: int, eff_lens: np.ndarray,
             online_mass: Optional[np.ndarray] = None,
             total_mapped: Optional[float] = None,
             config: EMConfig = EMConfig(),
             init_uniform: bool = False,
             num_required_frags: float = 5e7,
             alt_init: bool = False, device="cuda") -> dict:
    """Host-facing optimize on `device`. Returns dict with alphas
    (estimated read counts, float64), iterations, max_rel_diff,
    converged, num_degenerate_classes and available."""
    if total_mapped is None:
        total_mapped = eq.num_fragments
    a0 = initial_alphas(num_txps, online_mass, total_mapped, init_uniform,
                        num_required_frags, alt_init)
    pri = prior_alphas(num_txps, eff_lens, config.vb_prior,
                       config.per_transcript_prior)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    f32, i64 = torch.float32, torch.int64
    seg = np.repeat(np.arange(eq.num_classes), eq.class_sizes)
    alpha, iters, mrd, n_degen, available = run_em(
        put(eq.labels, i64), put(seg, i64), put(eq.counts, f32),
        put(eq.weights, f32), put(eq.class_sizes, i64), put(a0, f32),
        put(pri, f32), put(eff_lens, f32), num_txps, config.use_vbem,
        config.rel_diff_tolerance, config.min_iterations,
        config.max_iterations, config.alpha_check_cutoff)
    alphas = alpha.cpu().numpy().astype(np.float64)
    # truncate tiny values (reference :1004-1014)
    alphas[alphas < config.min_alpha] = 0.0
    return {
        "alphas": alphas,
        "iterations": iters,
        "max_rel_diff": mrd,
        "converged": mrd <= config.rel_diff_tolerance,
        "num_degenerate_classes": n_degen,
        "available": available.cpu().numpy(),
    }
