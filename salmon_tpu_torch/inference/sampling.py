"""Posterior sampling: Gibbs chains and bootstrap replicates.

Counterpart of salmon_tpu/inference/sampling.py. Reference:
src/inference/CollapsedGibbsSampler.cpp (Turro-style non-collapsed
sampler, sampleRoundNonCollapsedMultithreaded_ :93-180, sample
:318-520) and CollapsedEMOptimizer.cpp doBootstrap (:398-530) /
gatherBootstraps (:555-689).

Equivalence classes are padded to a dense (C, S) member matrix (S = max
class size). A multinomial redistribution of each class's count over
its members is drawn for all classes at once by a conditional-binomial
loop over the S member slots. Gibbs chains and bootstrap replicates are
a leading batch dimension of every tensor, in place of jax.vmap.

One formulation at every size: the JAX package switches to sort-routed
variants (gibbs_samples_routed, bootstrap_samples_routed, over
inference/fastem.py) at 65,536 eq entries because gathers are dear on
the TPU; this port keeps the dense functions, as inference/em.py keeps
one EM, and takes the routed variant's semantics from that size on.
Bootstraps equal the JAX package's at every size: below 65,536 entries
each replicate is resampled in class order and stops on its own (the
dense JAX variant); from there on, as bootstrap_samples_routed does,
deep classes are split first, the resample is drawn over the classes in
the routed engine's region order, and all replicates stop together,
tested after each chunk of EM_CHUNK iterations. Gibbs draws come from a
torch.Generator seeded with `seed`, not from jax.random: the two
packages agree in distribution, not in streams.

The JAX package compiles each sampler as one program: a chain is a
`lax.scan` over samples of a `fori_loop` over thinning rounds
(salmon_tpu/inference/sampling.py:246, :348), a replicate a
`while_loop` (:446, :520). Here, on CUDA tensors, the repeated unit is a
CUDA graph captured in the call (utils/graphcache.py): the thinning
rounds of all chains that make one sample, replayed once a sample, and
a chunk of the replicates' iterations, replayed until the host's one
read a chunk says all have stopped. On CPU tensors the same bodies run
eagerly (`*_impl` with no cache).
"""

from __future__ import annotations

import numpy as np
import torch

from salmon_tpu_torch.constants import DEFAULTS
from salmon_tpu_torch.inference.em import (DIGAMMA_MIN, MIN_EQ_WEIGHT,
                                           ROUTED_MIN_ENTRIES, masked_loop,
                                           prior_alphas, run_chunks)
from salmon_tpu_torch.inference.eqclasses import PackedEqClasses
from salmon_tpu_torch.utils.graphcache import (GraphCache, loop_cache,
                                               loop_step, stats_totals)

GIBBS_BETA = 0.1  # reference: beta in sampleRoundNonCollapsedMultithreaded_

# per-class count cap for the device multinomial: the conditional-
# binomial loop carries its running remainder in float32, which is exact
# for integers <= 2^24. Deeper classes are split into equal-distribution
# chunks (Multinomial(n1+n2, p) = Multinomial(n1, p) + Multinomial(n2, p)).
MULTINOMIAL_COUNT_CAP = 1 << 23
# iterations between the "all replicates converged" checks (the JAX
# package's): the loop ends at a multiple of them
BOOT_CHECK_EVERY = 10
# iterations of one captured chunk of the replicates' loop, which the
# host reads after: it divides BOOT_CHECK_EVERY, and is short so that
# the capture pays back in a short loop (em.EM_GRAPH_CHUNK)
BOOT_GRAPH_CHUNK = 5


# class widths of the JAX package's routed engine: the smallest 1.5x-graded
# step >= the class size (salmon_tpu/inference/fastem.py:51-68)
_WIDTH_STEPS = np.array(
    [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384,
     512, 768, 1024, 1536, 2048, 3072, 4096], np.int64)


def _bucket_widths(sizes: np.ndarray) -> np.ndarray:
    s = np.maximum(np.asarray(sizes).astype(np.int64), 1)
    i = np.searchsorted(_WIDTH_STEPS, s)
    big = i >= len(_WIDTH_STEPS)
    out = _WIDTH_STEPS[np.minimum(i, len(_WIDTH_STEPS) - 1)]
    # gigantic classes: the next power of two
    out[big] = 1 << np.ceil(np.log2(s[big])).astype(np.int64)
    return out


def region_order(class_sizes: np.ndarray) -> np.ndarray:
    """The routed engine's class order: a stable argsort of the padded
    class widths (fastem.py:114-116, `c_order`)."""
    return np.argsort(_bucket_widths(class_sizes), kind="stable")


def split_deep_classes(eq: PackedEqClasses,
                       cap: int = MULTINOMIAL_COUNT_CAP) -> PackedEqClasses:
    """Split classes with count > cap into chunks of <= cap fragments.

    The chunked multinomial reassignment has exactly the original
    distribution; only the float32 precision bound moves out of reach."""
    deep = np.flatnonzero(eq.counts > cap)
    if deep.size == 0:
        return eq
    label_chunks, weight_chunks = [], []
    counts, sizes = [], []
    for j in range(eq.num_classes):
        lo, hi = int(eq.offsets[j]), int(eq.offsets[j + 1])
        n = float(eq.counts[j])
        reps = max(1, int(np.ceil(n / cap)))
        for r in range(reps):
            label_chunks.append(eq.labels[lo:hi])
            weight_chunks.append(eq.weights[lo:hi])
            counts.append(min(float(cap), n - r * cap))
            sizes.append(hi - lo)
    labels = np.concatenate(label_chunks).astype(np.int32)
    weights = np.concatenate(weight_chunks)
    sizes = np.asarray(sizes, np.int32)
    offsets = np.zeros(sizes.shape[0] + 1, np.int64)
    offsets[1:] = np.cumsum(sizes)
    return PackedEqClasses(labels=labels, weights=weights,
                           offsets=offsets,
                           counts=np.asarray(counts, np.float64),
                           class_sizes=sizes)


def _nchains(num_samples: int) -> int:
    """Chain count keyed off the sample budget (reference sample
    :425-437)."""
    if num_samples >= 200:
        return 8
    if num_samples >= 100:
        return 4
    if num_samples >= 50:
        return 2
    return 1


def dense_classes(eq: PackedEqClasses, num_txps: int, device="cuda"):
    """Pad CSR classes to dense (C, S) tensors on `device`.

    Returns ({labels (C, S) int64, aux (C, S) float32 class-normalized
    aux weights, mask (C, S) bool, counts (C,) float32}, S).
    """
    C = eq.num_classes
    sizes = np.asarray(eq.class_sizes, np.int64)
    S = max(1, int(sizes.max())) if C else 1
    rows = np.repeat(np.arange(C), sizes)
    cols = np.arange(sizes.sum()) - np.repeat(np.asarray(eq.offsets[:-1]),
                                              sizes)
    labels = np.zeros((C, S), dtype=np.int64)
    aux = np.zeros((C, S), dtype=np.float32)
    mask = np.zeros((C, S), dtype=bool)
    labels[rows, cols] = eq.labels
    aux[rows, cols] = eq.weights
    mask[rows, cols] = True

    def put(a):
        return torch.from_numpy(a).to(device)

    return {"labels": put(labels), "aux": put(aux), "mask": put(mask),
            "counts": put(eq.counts.astype(np.float32))}, S


def multinomial_rows(gen: torch.Generator, n, probs, mask):
    """Draw Multinomial(n_j, probs_j) for every row j at once.

    Conditional-binomial method: slot i gets Binomial(remaining_j,
    p_i / tail_p_j). probs need not be normalized. n: (..., C) float
    counts; probs/mask: (..., C, S) (leading dimensions broadcast).
    Returns (..., C, S) float32. The running remainder is float32: a row
    with n > 2^24 loses integer precision (split_deep_classes keeps
    Gibbs rows below it).
    """
    p = torch.where(mask, probs, 0.0).to(torch.float32)
    S = p.shape[-1]
    tail = torch.flip(torch.cumsum(torch.flip(p, [-1]), dim=-1), [-1])
    remaining = n.to(torch.float32).expand(p.shape[:-1]).contiguous()
    mask = mask.expand(p.shape)
    out = torch.zeros_like(p)
    for i in range(S):
        pi, ti = p[..., i], tail[..., i]
        if i == S - 1:
            draw = remaining
        else:
            frac = torch.where(ti > MIN_EQ_WEIGHT, pi / ti.clamp(min=1e-30),
                               1.0).clamp(0.0, 1.0)
            draw = torch.binomial(remaining, frac.contiguous(),
                                  generator=gen)
            draw = torch.where(ti - pi <= MIN_EQ_WEIGHT, remaining, draw)
        draw = torch.where(mask[..., i], draw, 0.0)
        out[..., i] = draw
        remaining = remaining - draw
    return out


def _gibbs_round(gen, txp_count, dcls, prior, eff_lens, num_txps: int,
                 no_gamma_draw: bool):
    """One internal Gibbs round of every chain: mu draw + multinomial
    reassignment. txp_count: (K, T) int32 (draws are integral; int32
    keeps per-transcript totals exact past the float32 2^24 bound)."""
    ci = txp_count.to(torch.float32) + prior
    if no_gamma_draw:
        mu = ci / eff_lens.clamp(min=1.0)
    else:
        # Gamma(ci, scale=1/(beta + effLen))
        g = torch._standard_gamma(ci.clamp(min=1e-6), generator=gen)
        mu = g / (GIBBS_BETA + eff_lens)
    labels, mask = dcls["labels"], dcls["mask"]
    probs = 1000.0 * mu[:, labels] * dcls["aux"]
    # degenerate-denominator fallbacks (reference :103-130): 1/effLen,
    # then uniform
    denom = torch.where(mask, probs, 0.0).sum(dim=-1, keepdim=True)
    el_fallback = 1.0 / eff_lens[labels].clamp(min=1.0)
    probs = torch.where(denom > MIN_EQ_WEIGHT, probs, el_fallback)
    denom2 = torch.where(mask, probs, 0.0).sum(dim=-1, keepdim=True)
    probs = torch.where(denom2 > MIN_EQ_WEIGHT, probs, 1.0)

    assign = multinomial_rows(gen, dcls["counts"], probs, mask)
    K = txp_count.shape[0]
    flat = torch.where(mask, assign, 0.0).to(torch.int32).reshape(K, -1)
    return torch.zeros((K, num_txps), dtype=torch.int32,
                       device=flat.device).index_add_(
        1, labels.reshape(-1), flat)


def gibbs_samples(eq: PackedEqClasses, num_txps: int, eff_lens: np.ndarray,
                  init_counts: np.ndarray, num_samples: int,
                  thinning: int = DEFAULTS.thinning_factor,
                  prior: np.ndarray | float = 1e-3,
                  no_gamma_draw: bool = False,
                  seed: int = 271828, device="cuda",
                  stats: dict | None = None) -> np.ndarray:
    """gibbs_samples_impl, compiled: on a CUDA device each sample
    replays a CUDA graph of its thinning rounds, captured in this call
    (the first sample runs eagerly, the second is captured) with the
    call's generator registered; on the CPU the eager rounds."""
    cache = loop_cache(device)
    return gibbs_samples_impl(eq, num_txps, eff_lens, init_counts,
                              num_samples, thinning, prior, no_gamma_draw,
                              seed, device, stats, cache)


def gibbs_samples_impl(eq: PackedEqClasses, num_txps: int,
                       eff_lens: np.ndarray, init_counts: np.ndarray,
                       num_samples: int,
                       thinning: int = DEFAULTS.thinning_factor,
                       prior: np.ndarray | float = 1e-3,
                       no_gamma_draw: bool = False,
                       seed: int = 271828, device="cuda",
                       stats: dict | None = None,
                       cache: GraphCache | None = None) -> np.ndarray:
    """Generate `num_samples` posterior count draws on `device`, each
    sample's rounds through `cache` (eagerly where it is None).

    Chains restart from the initial EM estimate as the reference does
    (nchains keyed off numSamples, sample :425-437) and run side by side.
    The draws come from a torch.Generator seeded with `seed`: one seed
    gives the same draws at every call. `stats`, when given, receives
    the rounds and the graph cache's counters ("graph"). Returns
    (num_samples, num_txps) float64 integer counts (exact at any depth:
    deep classes are chunked and totals accumulate in int32).
    """
    eq = split_deep_classes(eq)
    dcls, S = dense_classes(eq, num_txps, device)
    eff = torch.as_tensor(np.maximum(eff_lens, 1.0), dtype=torch.float32,
                          device=device)
    pri = torch.as_tensor(np.broadcast_to(np.asarray(prior, np.float64),
                                          (num_txps,)).copy(),
                          dtype=torch.float32, device=device)
    nchains = _nchains(num_samples)
    per_chain = -(-num_samples // nchains)
    # the carry becomes integral after the first reassignment round;
    # rounding the (fractional) EM seed only perturbs the first mu draw
    tc = torch.as_tensor(np.rint(np.asarray(init_counts)),
                         dtype=torch.int32, device=device).expand(
        nchains, num_txps).contiguous()
    samples = torch.empty((nchains, per_chain, num_txps), dtype=torch.int32,
                          device=tc.device)
    row = torch.zeros(1, dtype=torch.int64, device=tc.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def sample():
        """The thinning rounds of every chain; their carry becomes the
        sample of the next row."""
        t = tc
        for _ in range(thinning):
            t = _gibbs_round(gen, t, dcls, pri, eff, num_txps,
                             no_gamma_draw)
        tc.copy_(t)
        samples.index_copy_(1, row, t[:, None])
        row.add_(1)

    key = ("gibbs", eq.num_classes, S, num_txps, nchains, thinning,
           no_gamma_draw)
    label = (f"gibbs classes={eq.num_classes} slots={S} T={num_txps} "
             f"chains={nchains} thinning={thinning}"
             f"{' noGammaDraw' if no_gamma_draw else ''}")
    for _ in range(per_chain):
        loop_step(cache, key, sample, tc.device, label, generator=gen)
    if stats is not None:
        stats.update(rounds=per_chain * thinning,
                     graph=stats_totals(cache.stats.values() if cache
                                        else ()))
    out = samples.reshape(-1, num_txps)[:num_samples]
    return out.cpu().numpy().astype(np.float64)


def bootstrap_samples(eq: PackedEqClasses, num_txps: int,
                      eff_lens: np.ndarray, num_boot: int,
                      use_vbem: bool, vb_prior: float,
                      per_transcript_prior: bool,
                      active_mask: np.ndarray | None = None,
                      reproject: bool = False,
                      tol: float = DEFAULTS.relative_diff_tolerance,
                      max_iter: int = DEFAULTS.max_em_iterations,
                      seed: int = 271828, device="cuda",
                      stats: dict | None = None) -> np.ndarray:
    """bootstrap_samples_impl, compiled: on a CUDA device each chunk of
    the replicates' iterations replays a CUDA graph captured in this
    call (the first chunk runs eagerly, the second is captured); on the
    CPU the eager loop."""
    cache = loop_cache(device)
    return bootstrap_samples_impl(
        eq, num_txps, eff_lens, num_boot, use_vbem, vb_prior,
        per_transcript_prior, active_mask, reproject, tol, max_iter, seed,
        device, stats, cache)


def bootstrap_samples_impl(eq: PackedEqClasses, num_txps: int,
                           eff_lens: np.ndarray, num_boot: int,
                           use_vbem: bool, vb_prior: float,
                           per_transcript_prior: bool,
                           active_mask: np.ndarray | None = None,
                           reproject: bool = False,
                           tol: float = DEFAULTS.relative_diff_tolerance,
                           max_iter: int = DEFAULTS.max_em_iterations,
                           seed: int = 271828, device="cuda",
                           stats: dict | None = None,
                           cache: GraphCache | None = None) -> np.ndarray:
    """Bootstrap replicates: multinomial resample of class counts on the
    host, then an independent EM/VBEM per replicate, all replicates side
    by side on `device`, each chunk of iterations through `cache`
    (eagerly where it is None).

    Below ROUTED_MIN_ENTRIES label entries each replicate stops on its
    own, as under the JAX package's vmap(while_loop): after at least 50
    iterations, at the first whose largest relative change is <= tol; a
    stopped replicate keeps its values while the others run on. From
    ROUTED_MIN_ENTRIES on, as bootstrap_samples_routed
    (salmon_tpu/inference/sampling.py:471-551): deep classes are split,
    the resample is drawn over the classes in region order, and every
    replicate runs chunks of EM_CHUNK iterations until, after at least
    50, the largest relative change of a chunk's last iteration over all
    replicates is <= tol. Either way the iterations run on the device in
    chunks (BOOT_GRAPH_CHUNK, or em.EM_GRAPH_CHUNK under em.masked_loop)
    that mask what runs past the stop, and the host reads once a chunk
    whether the loop runs on. `stats`, when given, receives the
    iteration count, the chunks, the masked iterations and the graph
    cache's counters ("graph"). Returns (num_boot, num_txps) float64
    counts.
    """
    routed = eq.labels.shape[0] >= ROUTED_MIN_ENTRIES
    if routed:
        eq = split_deep_classes(eq)
    dcls, _ = dense_classes(eq, num_txps, device)
    labels, mask = dcls["labels"], dcls["mask"]
    eff = torch.as_tensor(np.maximum(eff_lens, 1.0), dtype=torch.float32,
                          device=device)
    total = float(eq.counts.sum())
    C = eq.num_classes
    pri = torch.as_tensor(prior_alphas(num_txps, np.asarray(eff_lens),
                                       vb_prior, per_transcript_prior),
                          dtype=torch.float32, device=device)
    if active_mask is None:
        active = np.zeros(num_txps, dtype=bool)
        active[eq.labels] = True
    else:
        active = active_mask
    if routed:
        a0 = np.where(active, total / max(1, active.sum()), 0.0)
    else:
        a0 = np.where(active, float(1.0 / max(1, active.sum())) * total, 0.0)
    alpha0 = torch.as_tensor(a0, dtype=torch.float32, device=device)
    active_t = torch.as_tensor(active, device=device)

    # dense-form combined weights: aux / effLen, class-normalized
    el = eff[labels].clamp(min=1.0)
    cw = torch.where(mask, dcls["aux"] / el, 0.0)
    cw_sum = cw.sum(dim=1, keepdim=True)
    cw = torch.where(cw_sum > 0, cw / cw_sum.clamp(min=1e-30), 0.0)
    is_single = mask & (mask.sum(dim=1, keepdim=True) == 1)
    if routed:
        # the routed engine gives a singleton class its count only on a
        # slot of non-zero combined weight, count included (fastem.py:
        # 106-112, 338-341)
        is_single = is_single & (cw > 0) & (dcls["counts"] > 0)[:, None]

    def dense_update(alpha, counts):
        """alpha (K, T), counts (K, C) -> the next (K, T)."""
        base = alpha
        if use_vbem:
            ap = alpha + pri
            log_norm = torch.digamma(ap.sum(dim=1, keepdim=True))
            base = torch.where(
                ap > DIGAMMA_MIN,
                torch.exp(torch.digamma(ap.clamp(min=DIGAMMA_MIN))
                          - log_norm), 0.0)
            base = torch.where(active_t, base, 0.0)
        gamma = torch.where(mask, base[:, labels] * cw, 0.0)
        denom = gamma.sum(dim=2, keepdim=True)
        contrib = torch.where(denom > MIN_EQ_WEIGHT,
                              counts[:, :, None] * gamma
                              / denom.clamp(min=MIN_EQ_WEIGHT), 0.0)
        contrib = torch.where(is_single, counts[:, :, None], contrib)
        contrib = torch.where(mask, contrib, 0.0)
        return torch.zeros_like(alpha).index_add_(
            1, labels.reshape(-1), contrib.reshape(alpha.shape[0], -1))

    def rel_diff(alpha, alpha_p):
        return torch.where(alpha_p > cutoff, (alpha - alpha_p).abs()
                           / alpha_p.clamp(min=1e-30), 0.0)

    # replicates side by side: (K, T) alphas, (K, C) class counts
    loop_key = ("bootstrap", num_boot, C, labels.shape[1], num_txps,
                use_vbem, tol, max_iter, routed)
    loop_label = (f"bootstrap replicates={num_boot} classes={C} "
                  f"slots={labels.shape[1]} T={num_txps} "
                  f"{'vbem' if use_vbem else 'em'} tol={tol} "
                  f"max_iter={max_iter} "
                  f"{'chunked' if routed else 'per-replicate'}")
    min_iter = 50
    cutoff = DEFAULTS.alpha_check_cutoff

    # multinomial resample over classes on the HOST (reference csamp over
    # sampleWeights = class counts), the JAX package's very draw: exact
    # integer counts
    rng_h = np.random.default_rng(seed ^ 0x5A17)
    n_draw = max(1, int(round(total)))
    if routed:
        # over the classes in region order, the counts as the routed
        # pack holds them (float32), then back to class order
        order = region_order(eq.class_sizes)
        base_counts = np.asarray(eq.counts, np.float32).astype(
            np.float64)[order]
        pvec = base_counts / max(base_counts.sum(), 1e-300)
        draws = np.empty((num_boot, C), np.float32)
        draws[:, order] = rng_h.multinomial(n_draw, pvec, size=num_boot)
    else:
        base_counts = np.asarray(eq.counts, np.float64)
        pvec = base_counts / max(base_counts.sum(), 1e-300)
        draws = rng_h.multinomial(n_draw, pvec, size=num_boot).astype(
            np.float32)
    counts = torch.from_numpy(draws).to(device)

    alpha = alpha0.expand(num_boot, num_txps).contiguous()
    if routed:
        # every replicate stops together: the routed engine's chunked
        # rule over the largest change of all replicates
        loop = masked_loop(lambda a: dense_update(a, counts), alpha, tol,
                           min_iter, max_iter, True, cutoff, cache,
                           loop_key, loop_label)
    else:
        loop = _replicate_loop(dense_update, rel_diff, alpha, counts, tol,
                               min_iter, max(max_iter, min_iter), cache,
                               loop_key, loop_label)
    if stats is not None:
        stats.update(iterations=loop["iterations"], chunks=loop["chunks"],
                     masked_iterations=loop["masked_iterations"],
                     graph=stats_totals(cache.stats.values() if cache
                                        else ()))
    if reproject:
        alpha = dense_update(alpha, dcls["counts"].expand(num_boot, C))
    alpha = torch.where(alpha < DEFAULTS.min_alpha, 0.0, alpha)
    return alpha.cpu().numpy().astype(np.float64)


def _replicate_loop(update, rel_diff, alpha: torch.Tensor,
                    counts: torch.Tensor, tol: float, min_iter: int,
                    limit: int, cache: GraphCache | None, key,
                    label: str) -> dict:
    """Each replicate's own while_loop (the JAX package's vmap of it),
    in place on alpha (K, T): iteration `it` updates the replicates
    still running; from min_iter on a replicate stops after the first
    iteration whose largest relative change is <= tol, and keeps its
    values. The iterations run in chunks of BOOT_GRAPH_CHUNK through
    `cache`, each masked past `limit`; the host reads after a chunk
    whether the loop runs on: until `limit`, or a multiple of
    BOOT_CHECK_EVERY iterations at which no replicate runs."""
    dev = alpha.device
    running = torch.ones(alpha.shape[0], dtype=torch.bool, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    more = torch.ones((), dtype=torch.bool, device=dev)

    def chunk():
        for _ in range(BOOT_GRAPH_CHUNK):
            act = it < limit
            alpha_p = update(alpha, counts)
            rel = rel_diff(alpha, alpha_p)
            alpha.copy_(torch.where((running & act)[:, None], alpha_p,
                                    alpha))
            it_n = it + act.to(torch.int32)
            running.copy_(torch.where(act & (it_n >= min_iter),
                                      running & (rel.amax(dim=1) > tol),
                                      running))
            it.copy_(it_n)
        more.copy_((running.any() | (it % BOOT_CHECK_EVERY != 0))
                   & (it < limit))

    chunks = run_chunks(cache, key, chunk, more, dev, label) if limit > 0 \
        else 0
    iters = int(it)
    return {"iterations": iters, "chunks": chunks,
            "masked_iterations": chunks * BOOT_GRAPH_CHUNK - iters}
