"""Collapsed EM / VBEM over CSR-packed equivalence classes.

Counterpart of salmon_tpu/inference/em.py (reference
src/inference/CollapsedEMOptimizer.cpp — EMUpdate_ :179-234, VBEMUpdate_
:242-328, optimize :733-1040, populatePriorAlphas_ :82-99).

One iteration is a gather of alpha by entry label, a per-class
index_add_ for the denominators, and a per-transcript index_add_ for
the new alphas — at every size. (The JAX package switches to a
sort-routed layout at 65,536 entries because gathers are dear on the
TPU; this port keeps one formulation.) float32 on the device.

The convergence loop is the counterpart of the JAX package's
`jax.lax.while_loop` (salmon_tpu/inference/em.py:108, :151-167): its
state (alpha, the iteration count, the converged flag, the last
largest relative change) lives on the device, and the loop runs in
chunks of EM_GRAPH_CHUNK iterations, each of which runs only while the
stopping rule says go on (masked_loop). The host reads one flag a
chunk. On CUDA tensors a chunk is a captured CUDA graph replayed with
one launch (utils/graphcache.py); on CPU tensors it runs eagerly.
Below ROUTED_MIN_ENTRIES the rule tests every iteration, as the
reference does; from ROUTED_MIN_ENTRIES on it tests the last iteration
of each chunk of EM_CHUNK iterations, as the JAX package's routed
engine does, so that both stop after the same number of iterations.
run_em's `chunked` picks the rule at any size, for callers of the
routed engine whatever the size (the shard-serial quant of
scripts/demo_config5_quant.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from salmon_tpu_torch.constants import DEFAULTS
from salmon_tpu_torch.inference.eqclasses import PackedEqClasses
from salmon_tpu_torch.utils.graphcache import (GraphCache, loop_cache,
                                               loop_step, stats_totals)

MIN_EQ_WEIGHT = 1e-30     # minEQClassWeight analog
DIGAMMA_MIN = 1e-10
# From this many eq-class entries on, the JAX package runs its routed
# engine, which tests convergence only after each chunk of EM_CHUNK
# iterations (salmon_tpu/inference/fastem.py:285, :399-408); the port
# keeps its formulation and takes the same stopping rule there.
ROUTED_MIN_ENTRIES = 65_536
EM_CHUNK = 100
# iterations of one captured chunk of the loop. A chunk runs whole:
# iterations after the stop are masked (each costs what a live one does
# and changes nothing), at most EM_GRAPH_CHUNK - 1 of them, against one
# host read and one graph launch a chunk in place of ~50 launches and,
# under the per-iteration rule, one read an iteration. The capture costs
# about what the chunk's iterations cost eagerly, and the first chunk
# runs eagerly, so the chunk is short enough to pay back within a loop
# of 50 iterations (PERF.md §6). It divides EM_CHUNK, so that the
# chunked rule stops at the end of a chunk.
EM_GRAPH_CHUNK = 5


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


def max_rel_diff(alpha: torch.Tensor, alpha_p: torch.Tensor,
                 cutoff: float) -> torch.Tensor:
    """The largest |alpha - alpha_p| / alpha_p over entries with
    alpha_p > cutoff, as a 0-d tensor (0 for no entries)."""
    rel = torch.where(alpha_p > cutoff, (alpha - alpha_p).abs()
                      / torch.clamp(alpha_p, min=1e-30), 0.0)
    return rel.max() if rel.numel() else rel.new_zeros(())


def run_chunks(cache: GraphCache | None, key, chunk, more: torch.Tensor,
               device, label: str) -> int:
    """chunk() through `cache` (loop_step) until the device flag `more`,
    which each chunk sets, reads false: the host's one read a chunk.
    Returns the chunks run."""
    chunks = 0
    while True:
        loop_step(cache, key, chunk, device, label)
        chunks += 1
        if not bool(more):
            return chunks


def masked_loop(step, x: torch.Tensor, tol: float, min_iter: int,
                max_iter: int, chunked: bool, cutoff: float,
                cache: GraphCache | None, key, label: str) -> dict:
    """x <- step(x), in place on x's device, until the stopping rule
    ends the loop; the JAX package's while_loop cond/body
    (salmon_tpu/inference/em.py:151-167) or, `chunked`, its routed
    engine's rule.

    Each iteration runs only where it is active: under the
    per-iteration rule while it < min_iter or (it < max_iter and not
    converged), converged being the last iteration's largest relative
    change <= tol; under the chunked rule while it < max_iter and not
    converged, converged being that change <= tol at an iteration count
    that ends a chunk of EM_CHUNK and is >= min_iter. The iterations run
    in chunks of EM_GRAPH_CHUNK through `cache` (loop_step: eagerly
    where cache is None); the host reads once a chunk whether the next
    iteration is active. Returns {"iterations", "max_rel_diff" (of the
    last live iteration; inf before any), "chunks",
    "masked_iterations"}."""
    dev = x.device
    it = torch.zeros((), dtype=torch.int32, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    mrd = torch.full((), float("inf"), dtype=torch.float32, device=dev)

    def active():
        live = (it < max_iter) & ~converged
        return live if chunked else (it < min_iter) | live

    more = active()

    def chunk():
        for _ in range(EM_GRAPH_CHUNK):
            act = active()
            x_p = step(x)
            m = max_rel_diff(x, x_p, cutoff)
            it_n = it + act.to(torch.int32)
            done = m <= tol
            if chunked:
                done = done & (it_n % EM_CHUNK == 0) & (it_n >= min_iter)
            x.copy_(torch.where(act, x_p, x))
            converged.copy_(torch.where(act, done, converged))
            mrd.copy_(torch.where(act, m, mrd))
            it.copy_(it_n)
        more.copy_(active())

    chunks = (run_chunks(cache, key, chunk, more, dev, label)
              if max_iter > 0 or (not chunked and min_iter > 0) else 0)
    iters = int(it)
    return {"iterations": iters, "max_rel_diff": float(mrd),
            "chunks": chunks,
            "masked_iterations": chunks * EM_GRAPH_CHUNK - iters}


def run_em(labels: torch.Tensor, seg: torch.Tensor, counts: torch.Tensor,
           aux: torch.Tensor, class_sizes: torch.Tensor,
           alpha0: torch.Tensor, prior: torch.Tensor,
           eff_lens: torch.Tensor, num_txps: int, use_vbem: bool,
           tol: float, min_iter: int, max_iter: int,
           alpha_cutoff: float = DEFAULTS.alpha_check_cutoff,
           chunked: Optional[bool] = None, stats: Optional[dict] = None):
    """run_em_impl, compiled: on CUDA tensors each chunk of the loop
    replays a CUDA graph captured in this call (its first chunk runs
    eagerly, the second is captured); on CPU tensors the eager loop
    itself. A failed capture or replay raises, naming the signature."""
    cache = loop_cache(alpha0.device)
    return run_em_impl(labels, seg, counts, aux, class_sizes, alpha0,
                       prior, eff_lens, num_txps, use_vbem, tol, min_iter,
                       max_iter, alpha_cutoff, chunked, stats, cache)


def run_em_impl(labels: torch.Tensor, seg: torch.Tensor,
                counts: torch.Tensor, aux: torch.Tensor,
                class_sizes: torch.Tensor, alpha0: torch.Tensor,
                prior: torch.Tensor, eff_lens: torch.Tensor, num_txps: int,
                use_vbem: bool, tol: float, min_iter: int, max_iter: int,
                alpha_cutoff: float = DEFAULTS.alpha_check_cutoff,
                chunked: Optional[bool] = None,
                stats: Optional[dict] = None,
                cache: GraphCache | None = None):
    """The optimization loop, its chunks through `cache` (eagerly where
    it is None).

    labels/seg/aux: (E,) per-entry transcript, class and aux weight;
    counts/class_sizes: (Cl,) per class. chunked: the routed engine's
    rule (convergence tested after each chunk of EM_CHUNK iterations) or
    the per-iteration one; None picks by size (ROUTED_MIN_ENTRIES).
    `stats`, when given, receives the loop's chunks and masked
    iterations and the graph cache's counters ("graph"). Returns
    (alpha, n_iters, max_rel_diff, n_degenerate, available)."""
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

    if chunked is None:
        chunked = labels.shape[0] >= ROUTED_MIN_ENTRIES
    rule = "chunked" if chunked else "per-iteration"
    key = ("em", labels.shape[0], n_cl, num_txps, use_vbem, tol, min_iter,
           max_iter, alpha_cutoff, EM_GRAPH_CHUNK, rule)
    label = (f"em E={labels.shape[0]} classes={n_cl} T={num_txps} "
             f"{'vbem' if use_vbem else 'em'} tol={tol} iterations "
             f"{min_iter}-{max_iter} K={EM_GRAPH_CHUNK} {rule}")
    alpha = alpha0.clone()
    loop = masked_loop(step, alpha, tol, min_iter, max_iter, chunked,
                       alpha_cutoff, cache, key, label)
    if stats is not None:
        stats.update(chunks=loop["chunks"],
                     masked_iterations=loop["masked_iterations"],
                     graph=stats_totals(cache.stats.values() if cache
                                        else ()))
    return (alpha, loop["iterations"], loop["max_rel_diff"],
            int(degenerate.sum()), available)


def loop_clocks(results: list) -> dict:
    """em_masked_iters and em_graph_* of optimize's results (summed over
    the EMs of one quant), for its clocks line."""
    out = {"em_masked_iters": sum(r["masked_iterations"] for r in results)}
    for k in stats_totals(()):
        out[f"em_graph_{k}"] = sum(r["graph"][k] for r in results)
    return out


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
    converged, num_degenerate_classes, available, the loop's
    masked_iterations and its graph cache's counters (graph)."""
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
    loop = {}
    alpha, iters, mrd, n_degen, available = run_em(
        put(eq.labels, i64), put(seg, i64), put(eq.counts, f32),
        put(eq.weights, f32), put(eq.class_sizes, i64), put(a0, f32),
        put(pri, f32), put(eff_lens, f32), num_txps, config.use_vbem,
        config.rel_diff_tolerance, config.min_iterations,
        config.max_iterations, config.alpha_check_cutoff, stats=loop)
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
        "masked_iterations": loop["masked_iterations"],
        "graph": loop["graph"],
    }
