"""EM / VBEM parity: the port's optimize (one gather plus index_add_
formulation at every size) against the JAX package's, on equivalence
classes made with numpy from a seed.

Below 65,536 entries the JAX package runs its gather/segment_sum engine
("xla"); at or above it, the sort-routed engine of fastem. All three run
float32 and sum in different orders, so alphas are compared with
rtol 1e-3 (plus atol 1e-3 read for transcripts near zero): the per-sum
rounding differences are ~1e-7 relative, and a few hundred contracting
iterations carry them to ~1e-5; the margin absorbs one iteration more or
less where the convergence test sits on its threshold. The float64
numpy engine is the shared yardstick at the small size.
"""

import dataclasses

import numpy as np
import pytest
import torch

from salmon_tpu.inference import em as jem
from salmon_tpu.inference.eqclasses import PackedEqClasses as JPacked
from salmon_tpu_torch.inference import em as tem
from salmon_tpu_torch.inference.eqclasses import PackedEqClasses as TPacked

torch.set_num_threads(2)

RTOL = ATOL = 1e-3


def random_eq(seed: int, n_txps: int, n_classes: int, max_size: int):
    rng = np.random.default_rng(seed)
    # skewed transcript popularity, as real libraries have; each class
    # takes the distinct transcripts among max_size draws
    pop = rng.pareto(1.2, n_txps) + 1e-3
    draws = np.sort(rng.choice(n_txps, (n_classes, max_size),
                               p=pop / pop.sum()), axis=1)
    first = np.ones(draws.shape, bool)
    first[:, 1:] = draws[:, 1:] != draws[:, :-1]
    keep = first & (np.cumsum(first, axis=1) <= rng.integers(
        1, max_size + 1, (n_classes, 1)))
    sizes = keep.sum(axis=1).astype(np.int32)
    labels = draws[keep].astype(np.int32)
    weights = rng.random(labels.shape[0]) + 0.05
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    seg = np.repeat(np.arange(n_classes), sizes)
    weights /= np.bincount(seg, weights=weights)[seg]
    counts = rng.integers(1, 50, n_classes).astype(np.float64)
    eff = rng.integers(50, 3000, n_txps).astype(np.float64)
    mass = np.bincount(labels, weights=counts[seg] / sizes[seg],
                       minlength=n_txps)
    fields = dict(labels=labels, weights=weights, offsets=offsets,
                  counts=counts, class_sizes=sizes)
    return JPacked(**fields), TPacked(**fields), eff, mass


def _compare(want: dict, got: dict, check_iters: bool):
    np.testing.assert_allclose(got["alphas"], want["alphas"], rtol=RTOL,
                               atol=ATOL)
    assert got["num_degenerate_classes"] == want["num_degenerate_classes"]
    if "available" in want:
        np.testing.assert_array_equal(got["available"], want["available"])
    if check_iters:
        assert abs(got["iterations"] - want["iterations"]) <= 1


@pytest.mark.parametrize("vbem", [False, True], ids=["em", "vbem"])
def test_optimize_matches_xla_engine(vbem):
    jeq, teq, eff, mass = random_eq(1, 400, 3000, 6)
    assert jeq.labels.shape[0] < jem.ROUTED_MIN_ENTRIES
    cfg = dict(use_vbem=vbem, min_iterations=50)
    want = jem.optimize(jeq, 400, eff, online_mass=mass,
                        config=jem.EMConfig(**cfg), engine="xla")
    got = tem.optimize(teq, 400, eff, online_mass=mass,
                       config=tem.EMConfig(**cfg), device="cpu")
    _compare(want, got, check_iters=True)
    ref = jem.em_numpy(jeq, 400, eff, config=jem.EMConfig(**cfg),
                       online_mass=mass)
    np.testing.assert_allclose(got["alphas"], ref["alphas"], rtol=RTOL,
                               atol=ATOL)
    assert got["alphas"].sum() == pytest.approx(jeq.counts.sum(),
                                                rel=1e-4)


def test_optimize_degenerate_classes():
    """Classes whose aux weights are all zero drop out of every update
    in both packages."""
    jeq, teq, eff, mass = random_eq(2, 200, 800, 4)
    for c in (5, 17, 40):
        jeq.weights[jeq.offsets[c]:jeq.offsets[c + 1]] = 0.0
    cfg = dict(use_vbem=False, min_iterations=20)
    want = jem.optimize(jeq, 200, eff, online_mass=mass,
                        total_mapped=5e7, config=jem.EMConfig(**cfg),
                        engine="xla")
    got = tem.optimize(teq, 200, eff, online_mass=mass, total_mapped=5e7,
                       config=tem.EMConfig(**cfg), device="cpu")
    assert want["num_degenerate_classes"] > 0
    _compare(want, got, check_iters=True)


@pytest.mark.parametrize("vbem", [False, True], ids=["em", "vbem"])
def test_optimize_matches_routed_engine(vbem):
    """At >= 65,536 entries the JAX package routes to fastem, which tests
    convergence every 100 iterations; both run a fixed 100 here."""
    jeq, teq, eff, mass = random_eq(3, 3000, 20000, 6)
    assert jeq.labels.shape[0] >= jem.ROUTED_MIN_ENTRIES
    cfg = dict(use_vbem=vbem, min_iterations=100, max_iterations=100)
    want = jem.optimize(jeq, 3000, eff, online_mass=mass,
                        config=jem.EMConfig(**cfg))
    got = tem.optimize(teq, 3000, eff, online_mass=mass,
                       config=tem.EMConfig(**cfg), device="cpu")
    assert want["iterations"] == got["iterations"] == 100
    _compare(want, got, check_iters=False)


@pytest.mark.parametrize("vbem", [False, True], ids=["em", "vbem"])
def test_stopping_rule_matches_routed_engine(vbem):
    """At >= 65,536 entries, with the default iteration limits and
    tolerance, the port tests convergence after each chunk of EM_CHUNK
    iterations as the routed engine does: both stop after the same
    number of iterations (a multiple of 100, or the maximum)."""
    jeq, teq, eff, mass = random_eq(3, 3000, 20000, 6)
    assert jeq.labels.shape[0] >= jem.ROUTED_MIN_ENTRIES
    assert tem.ROUTED_MIN_ENTRIES == jem.ROUTED_MIN_ENTRIES
    cfg = dict(use_vbem=vbem)
    want = jem.optimize(jeq, 3000, eff, online_mass=mass,
                        config=jem.EMConfig(**cfg))
    got = tem.optimize(teq, 3000, eff, online_mass=mass,
                       config=tem.EMConfig(**cfg), device="cpu")
    assert got["iterations"] == want["iterations"]
    assert (got["iterations"] % tem.EM_CHUNK == 0
            or got["iterations"] == tem.EMConfig().max_iterations)
    assert got["converged"] == want["converged"]
    _compare(want, got, check_iters=False)


@pytest.mark.parametrize("vbem", [False, True], ids=["em", "vbem"])
def test_stopping_rule_below_threshold(vbem):
    """Under 65,536 entries, with the default limits, the port still
    tests every iteration, as the JAX package's classic engine does."""
    jeq, teq, eff, mass = random_eq(5, 400, 3000, 6)
    assert jeq.labels.shape[0] < jem.ROUTED_MIN_ENTRIES
    cfg = dict(use_vbem=vbem)
    want = jem.optimize(jeq, 400, eff, online_mass=mass,
                        config=jem.EMConfig(**cfg))
    got = tem.optimize(teq, 400, eff, online_mass=mass,
                       config=tem.EMConfig(**cfg), device="cpu")
    _compare(want, got, check_iters=True)


def test_initial_and_prior_alphas_match():
    rng = np.random.default_rng(4)
    mass = rng.random(50) * 100
    eff = rng.random(50) * 1000 + 1
    for kw in (dict(), dict(init_uniform=True), dict(alt_init=True)):
        np.testing.assert_array_equal(
            tem.initial_alphas(50, mass, 1e5, **kw),
            jem.initial_alphas(50, mass, 1e5, **kw))
    for per_txp in (False, True):
        np.testing.assert_array_equal(
            tem.prior_alphas(50, eff, 1e-2, per_txp),
            jem.prior_alphas(50, eff, 1e-2, per_txp))
    assert dataclasses.asdict(tem.EMConfig()) == \
        dataclasses.asdict(jem.EMConfig())


@pytest.mark.parametrize("vbem,tol", [(False, 1e-3), (True, 1e-8)],
                         ids=["em", "vbem"])
def test_chunked_rule_below_threshold_matches_routed_engine(vbem, tol):
    """run_em(chunked=True) takes the routed engine's stopping rule under
    65,536 entries too, as the shard-serial quant asks of it: the same
    iteration count as fastem.optimize_routed, which the JAX config-5
    demo calls at every size, and alphas within 1e-4."""
    from salmon_tpu.inference import fastem

    jeq, teq, eff, _ = random_eq(5, 400, 3000, 6)
    assert jeq.labels.shape[0] < jem.ROUTED_MIN_ENTRIES
    a0 = jem.initial_alphas(400, None, jeq.num_fragments)
    pri = jem.prior_alphas(400, eff, 1e-2, True)
    want = fastem.optimize_routed(jeq, 400, eff, a0, pri, vbem, tol, 50,
                                  1000)
    seg = np.repeat(np.arange(teq.num_classes), teq.class_sizes)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    f32, i64 = torch.float32, torch.int64
    args = (put(teq.labels, i64), put(seg, i64), put(teq.counts, f32),
            put(teq.weights, f32), put(teq.class_sizes, i64),
            put(a0, f32), put(pri, f32), put(eff, f32), 400, vbem, tol,
            50, 1000, 1e-2)
    alpha, iters, _, n_degen, _ = tem.run_em(*args, chunked=True)
    assert iters == want["iterations"]
    assert iters % tem.EM_CHUNK == 0 or iters == 1000
    assert n_degen == want["num_degenerate_classes"]
    np.testing.assert_allclose(alpha.numpy(), want["alphas"], rtol=1e-4,
                               atol=1e-4)
    # by size, the same entries take the per-iteration rule
    assert tem.run_em(*args)[1] != iters
