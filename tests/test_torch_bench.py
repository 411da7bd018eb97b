"""The port's benchmark harness (salmon_tpu_torch/bench.py) against the
repository's JAX harness (bench.py, which is neither imported nor run
here) and the JAX package, on the CPU at small sizes.

- em_fixture builds the arrays of the JAX harness's EM fixture
  (bench.py:129-143), rebuilt here from the same numpy calls.
- On that fixture at T = NCLS = 20,000 (77,394 entries, past
  ROUTED_MIN_ENTRIES, so the chunked stopping rule), the port's run_em
  for 100 and for 200 VBEM iterations against the JAX package's routed
  engine (fastem.optimize_routed, as the JAX harness runs it). Both run
  in float32 with their own summation orders, and each is held to a
  float64 run of the same iterations (the port's run_em in float64)
  within rtol 1e-4 / atol 1e-3, the EM tolerance of
  tests/test_parallel.py; so the two are within twice that of each
  other, rtol 2e-4 / atol 2e-3. (At 200 iterations they differ by up to
  0.00186, rel 3.1e-4, on one of the 20,000 alphas: each is within
  rtol 1.6e-4 / 0.00094 of the float64 run, on opposite sides.)
- main(device="cpu") with BENCH_FAST=1, BENCH_BATCH=64, BENCH_PAIRS=128
  prints one JSON line with exactly the JAX harness's nine keys, and its
  mapped_fraction equals the JAX package's map_paired_batch on the same
  64-row tile of the sample pairs.
- Without a GPU, main() raises.
- The human-scale rate: null without a cache and BENCH_BUILD_HS=0; the
  cache build path (synthetic set, the port's CLI index in a
  subprocess) at 60 transcripts, then its reuse.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salmon_tpu.constants import DEFAULTS as JDEFAULTS
from salmon_tpu.index import builder as jb
from salmon_tpu.inference import em as jem
from salmon_tpu.inference import fastem
from salmon_tpu.inference.eqclasses import PackedEqClasses as JPacked
from salmon_tpu.io.fastq import _iter_fastq_seqs, pack_seqs
from salmon_tpu.mapping import pipeline as jpipe
from salmon_tpu.models.fld import FragmentLengthDistribution as JFld
from salmon_tpu.utils import libformat as jlf
from salmon_tpu_torch import bench
from salmon_tpu_torch.inference import em as tem

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
KEYS = {"metric", "value", "unit", "vs_baseline", "mapped_fraction",
        "sample_frags_per_s", "human_frags_per_s", "em_iters_per_s",
        "em_fixture_entries"}
EM_T = 20_000
RTOL, ATOL = 1e-4, 1e-3


def jax_harness_fixture(T, NCLS, seed=0):
    """bench.py:129-143, the JAX harness's fixture arrays."""
    rng = np.random.default_rng(seed)
    sizes = np.minimum(1 + rng.geometric(0.35, NCLS), 50).astype(np.int32)
    seg = np.repeat(np.arange(NCLS), sizes)
    E = int(sizes.sum())
    labels = rng.integers(0, T, E).astype(np.int32)
    weights = rng.random(E)
    wsum = np.bincount(seg, weights=weights, minlength=NCLS)
    weights = weights / wsum[seg]
    counts = rng.integers(1, 50, NCLS).astype(np.float64)
    offsets = np.zeros(NCLS + 1, np.int64)
    offsets[1:] = np.cumsum(sizes)
    return JPacked(labels=labels, weights=weights, offsets=offsets,
                   counts=counts, class_sizes=sizes)


@pytest.mark.parametrize("T,ncls", [(bench.EM_TXPS, bench.EM_CLASSES),
                                    (EM_T, EM_T), (300, 1000)])
def test_em_fixture_is_the_jax_harness_fixture(T, ncls):
    got = bench.em_fixture(T, ncls, 0)
    want = jax_harness_fixture(T, ncls)
    for f in ("labels", "weights", "offsets", "counts", "class_sizes"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    if T == bench.EM_TXPS:
        assert got.labels.shape[0] == 964_064


@pytest.mark.parametrize("n", [100, 200])
def test_fixture_em_matches_routed_engine(n):
    eq = bench.em_fixture(EM_T, EM_T, 0)
    assert eq.labels.shape[0] >= jem.ROUTED_MIN_ENTRIES
    jeq = jax_harness_fixture(EM_T, EM_T)
    eff = np.full(EM_T, bench.EM_EFF_LEN)
    a0 = jem.initial_alphas(EM_T, None, jeq.num_fragments)
    pri = jem.prior_alphas(EM_T, eff, 1e-2, True)
    want = fastem.optimize_routed(jeq, EM_T, eff, a0, pri, True, 1e-12, n,
                                  n)
    assert want["iterations"] == n

    args = bench.em_args(eq, EM_T, "cpu")
    alpha, iters, *_ = bench.run_fixture_em(args, EM_T, n)
    assert iters == n
    got = alpha.numpy().astype(np.float64)
    exact = tem.run_em(*(a.double() if a.is_floating_point() else a
                         for a in args), EM_T, True, 1e-12, n, n)[0].numpy()
    np.testing.assert_allclose(want["alphas"], exact, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, exact, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want["alphas"], rtol=2 * RTOL,
                               atol=2 * ATOL)
    np.testing.assert_allclose(got.sum(), want["alphas"].sum(), rtol=1e-5)


def _jax_tile_mapped_fraction(R):
    """num_mapped / num_processed of the JAX package's map_paired_batch
    on the sample pairs tiled to R rows, as bench.py maps them."""
    reads1 = list(_iter_fastq_seqs(os.path.join(DATA, "reads_1.fastq")))
    reads2 = list(_iter_fastq_seqs(os.path.join(DATA, "reads_2.fastq")))
    L = max(len(s) for s in reads1 + reads2)
    c1, l1 = pack_seqs(reads1, len(reads1), L)
    c2, l2 = pack_seqs(reads2, len(reads2), L)
    batch = {k: jnp.asarray(v[:R]) for k, v in (
        ("codes_l", c1), ("lengths_l", l1), ("codes_r", c2),
        ("lengths_r", l2))}
    idx = jb.build_index(os.path.join(DATA, "transcripts.fasta"), k=25)
    cfg = jpipe.MapperConfig.from_index(idx, validate_mappings=True)
    fmt = jlf.parse_library_format("IU")
    out = jpipe.map_paired_batch(
        batch, jpipe.device_index_arrays(idx), cfg,
        jnp.asarray(JFld(max_val=JDEFAULTS.max_frag_length).log_pmf(),
                    jnp.float32),
        jnp.asarray(jlf.paired_compat_table(fmt)),
        jnp.asarray(jlf.orphan_compat_table(fmt)))
    return float(out["num_mapped"]) / float(out["num_processed"])


def test_main_on_cpu_matches_jax_mapped_fraction(monkeypatch, capsys):
    for k, v in (("BENCH_FAST", "1"), ("BENCH_BATCH", "64"),
                 ("BENCH_PAIRS", "128")):
        monkeypatch.setenv(k, v)
    assert bench.main([], device="cpu") == 0
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert set(rec) == KEYS
    assert "# bench device: cpu" in out.err
    assert rec["metric"] == "reads/s/chip (sample)"
    assert rec["sample_frags_per_s"] > 0
    assert rec["value"] == rec["sample_frags_per_s"]
    assert rec["human_frags_per_s"] is None
    assert rec["em_iters_per_s"] is None and rec["em_fixture_entries"] is None
    want = _jax_tile_mapped_fraction(64)
    assert 0 < want <= 1
    assert rec["mapped_fraction"] == round(want, 4)


def test_main_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_human_scale_absent_cache_is_null(tmp_path, capsys):
    """BENCH_BUILD_HS=0 and no cache: (None, None), as the JAX
    harness reports it, with its stderr line."""
    assert bench._human_scale(str(tmp_path), False, 64, 128,
                              torch.device("cpu")) == (None, None)
    assert "BENCH_BUILD_HS=0" in capsys.readouterr().err


def test_human_scale_builds_then_reuses_the_cache(tmp_path, monkeypatch,
                                                  capsys):
    """The cache build (the synthetic set by scripts/
    make_synthetic_txome.py, the index by the port's CLI in a
    subprocess) at 60 transcripts / 300 pairs, then a rate; a second
    call maps from the cache without building."""
    monkeypatch.setattr(bench, "HUMAN_TXPS", 60)
    monkeypatch.setattr(bench, "HUMAN_PAIRS", 300)
    monkeypatch.setattr(bench, "HUMAN_MIN_BATCH", 64)
    cache, cpu = str(tmp_path / "cache"), torch.device("cpu")
    frags, mf = bench._human_scale(cache, True, 64, 128, cpu)
    err = capsys.readouterr().err
    assert "human-scale index built" in err and "peak RSS" in err
    assert frags > 0 and 0.9 < mf <= 1.0
    assert os.path.isdir(os.path.join(cache, "hs_idx"))
    assert not os.path.exists(os.path.join(cache, "txome_tmp.fasta"))
    frags2, mf2 = bench._human_scale(cache, False, 64, 128, cpu)
    assert "building human-scale cache" not in capsys.readouterr().err
    assert frags2 > 0 and mf2 == mf
