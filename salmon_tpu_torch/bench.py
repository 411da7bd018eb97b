"""Benchmark: selective-alignment mapping and EM throughput on the GPU.

Counterpart of the repository's bench.py (the JAX package's harness),
with the same measurements, keys and knobs:

    python -m salmon_tpu_torch.bench

prints ONE JSON line:
  {"metric": "reads/s/chip (...)", "value": N, "unit": "fragments/s",
   "vs_baseline": N, "mapped_fraction": N, "sample_frags_per_s": N,
   "human_frags_per_s": N|null, "em_iters_per_s": N,
   "em_fixture_entries": N}

- sample_frags_per_s: map_paired_batch (one banded-DP launch at band
  15 a call) on the bundled sample's index at k 25, its pairs tiled to
  R = BENCH_BATCH rows;
- em_iters_per_s: the marginal VBEM iteration rate of
  inference/em.run_em on a seed-0 numpy fixture of 250,000 transcripts,
  250,000 classes and 964,064 entries (em_fixture), at which run_em
  takes the routed engine's chunked stopping rule;
- human_frags_per_s: mapping on a 200,000-transcript synthetic index
  (scripts/make_synthetic_txome.py, indexed by this package's CLI),
  built once into BENCH_CACHE; null when the cache is absent and
  BENCH_BUILD_HS=0, or when its build or run fails.

The headline value is the human-scale rate when there is one, else the
sample rate. vs_baseline divides it by an assumed reference-salmon
throughput of 5e5 fragments/s on a 32-core CPU node (BASELINE.md).

Env knobs: BENCH_PAIRS (pairs a timed loop), BENCH_BATCH (rows a call),
BENCH_VALIDATE=0 (coverage only), BENCH_FAST=1 (sample rate only),
BENCH_CACHE (default ~/.cache/salmon_tpu_bench), BENCH_BUILD_HS=0 (no
cache build), BENCH_DEVICE_TIMEOUT (seconds for the device to answer),
and BENCH_SPARSE / BENCH_B / _W / _T / _T2 / _DPB / _STRIDE / _OCC
(MapperConfig overrides). Runs on the GPU; main(device="cpu") runs on
the CPU through the kernel's plain version (the tests do).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import resource
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from salmon_tpu_torch.constants import DEFAULTS
from salmon_tpu_torch.inference import em
from salmon_tpu_torch.inference.eqclasses import PackedEqClasses

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
BASELINE_FRAGS_PER_S = 5.0e5
# the EM fixture's sizes (the JAX harness's metric-of-record fixture)
EM_TXPS = EM_CLASSES = 250_000
EM_EFF_LEN = 300.0
HUMAN_TXPS = HUMAN_PAIRS = 200_000
HUMAN_MIN_BATCH = 16_384
# BENCH_* knob -> MapperConfig field
MAPPER_KNOBS = (("BENCH_B", "seed_hits_per_end"),
                ("BENCH_W", "weight_width"),
                ("BENCH_T", "max_cands"),
                ("BENCH_T2", "max_pair_cands"),
                ("BENCH_DPB", "dp_budget"),
                ("BENCH_STRIDE", "kmer_stride"),
                ("BENCH_OCC", "occ_cap"))


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _load_reads(r1_path, r2_path, R, device):
    """The pairs of two FASTQ files, packed and tiled to R rows, on
    `device`."""
    from salmon_tpu_torch.io.fastq import _iter_fastq_seqs, pack_seqs
    reads1 = list(_iter_fastq_seqs(r1_path))
    reads2 = list(_iter_fastq_seqs(r2_path))
    read_len = max(len(s) for s in reads1 + reads2)
    c1, l1 = pack_seqs(reads1, len(reads1), read_len)
    c2, l2 = pack_seqs(reads2, len(reads2), read_len)
    n = len(reads1)
    reps = -(-R // n)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {
        "codes_l": put(np.tile(c1, (reps, 1))[:R]),
        "lengths_l": put(np.tile(l1, reps)[:R]),
        "codes_r": put(np.tile(c2, (reps, 1))[:R]),
        "lengths_r": put(np.tile(l2, reps)[:R]),
    }


def mapper_inputs(idx, device, validate=True):
    """(config, device index, FLD log-pmf, paired and orphan compat
    tables for IU) as the harness maps with them, the BENCH_* overrides
    applied to the config."""
    from salmon_tpu_torch.mapping.pipeline import (MapperConfig,
                                                   device_index_tensors)
    from salmon_tpu_torch.models.fld import FragmentLengthDistribution
    from salmon_tpu_torch.utils import libformat

    cfg = MapperConfig.from_index(idx, validate_mappings=validate)
    overrides = {}
    if os.environ.get("BENCH_SPARSE"):
        overrides["sparse_seed"] = os.environ["BENCH_SPARSE"] == "1"
    for env, field in MAPPER_KNOBS:
        if os.environ.get(env):
            overrides[field] = int(os.environ[env])
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    dev = device_index_tensors(idx, device)
    fld = FragmentLengthDistribution(max_val=DEFAULTS.max_frag_length)
    fld_logpmf = torch.as_tensor(fld.log_pmf(), dtype=torch.float32,
                                 device=device)
    fmt = libformat.parse_library_format("IU")
    cp = torch.as_tensor(libformat.paired_compat_table(fmt), device=device)
    co = torch.as_tensor(libformat.orphan_compat_table(fmt), device=device)
    return cfg, dev, fld_logpmf, cp, co


def _map_throughput(idx, batch, n_batches, device, validate=True):
    """(fragments per second, mapped fraction) of map_paired_batch on
    `batch`: the median of three loops of n_batches calls."""
    from salmon_tpu_torch.mapping.align import BANDED_DP
    from salmon_tpu_torch.mapping.pipeline import map_paired_batch

    cfg, dev, fld_logpmf, cp, co = mapper_inputs(idx, device, validate)
    BANDED_DP.reset()
    out = map_paired_batch(batch, dev, cfg, fld_logpmf, cp, co)
    mapped_frac = float(out["num_mapped"]) / float(out["num_processed"])
    R = batch["lengths_l"].shape[0]
    # steady state: a few individually-finished warm calls (the first
    # calls pay the allocator's growth), then the median of three loops,
    # each finished by a device synchronize (launches return before the
    # device is done)
    for _ in range(3):
        map_paired_batch(batch, dev, cfg, fld_logpmf, cp, co)
        _sync(device)
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_batches):
            map_paired_batch(batch, dev, cfg, fld_logpmf, cp, co)
        _sync(device)
        rates.append(n_batches * R / (time.perf_counter() - t0))
    rates.sort()
    # on a GPU every call launches the banded-DP kernel; on the CPU its
    # plain version runs and nothing is counted
    _log(f"# banded_dp launches by band: {dict(BANDED_DP.by_shape)} "
         f"over {4 + 3 * n_batches} calls of R={R}")
    return rates[1], mapped_frac


def em_fixture(T: int = EM_TXPS, ncls: int = EM_CLASSES,
               seed: int = 0) -> PackedEqClasses:
    """The harness's synthetic eq classes: `ncls` classes of
    min(1 + geometric(0.35), 50) random transcripts of T, weights
    normalized within each class, counts in [1, 50)."""
    rng = np.random.default_rng(seed)
    sizes = np.minimum(1 + rng.geometric(0.35, ncls), 50).astype(np.int32)
    seg = np.repeat(np.arange(ncls), sizes)
    E = int(sizes.sum())
    labels = rng.integers(0, T, E).astype(np.int32)
    weights = rng.random(E)
    wsum = np.bincount(seg, weights=weights, minlength=ncls)
    weights = weights / wsum[seg]
    counts = rng.integers(1, 50, ncls).astype(np.float64)
    offsets = np.zeros(ncls + 1, np.int64)
    offsets[1:] = np.cumsum(sizes)
    return PackedEqClasses(labels=labels, weights=weights, offsets=offsets,
                           counts=counts, class_sizes=sizes)


def em_args(eq: PackedEqClasses, T: int, device) -> tuple:
    """run_em's leading arguments for the fixture on `device`, as
    em.optimize puts them there: uniform initial alphas, a
    per-transcript prior of 1e-2, effective lengths of EM_EFF_LEN."""
    eff = np.full(T, EM_EFF_LEN)
    a0 = em.initial_alphas(T, None, eq.num_fragments)
    pri = em.prior_alphas(T, eff, 1e-2, True)
    seg = np.repeat(np.arange(eq.num_classes), eq.class_sizes)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    f32, i64 = torch.float32, torch.int64
    return (put(eq.labels, i64), put(seg, i64), put(eq.counts, f32),
            put(eq.weights, f32), put(eq.class_sizes, i64), put(a0, f32),
            put(pri, f32), put(eff, f32))


def run_fixture_em(args: tuple, T: int, n: int):
    """n VBEM iterations of run_em (tolerance 1e-12, so exactly n);
    returns its (alpha, iterations, max_rel_diff, ...)."""
    return em.run_em(*args, T, True, 1e-12, n, n)


def _em_iters_per_s(device):
    """Marginal VBEM iteration rate at the 250k-txp / 964,064-entry
    fixture."""
    eq = em_fixture()
    E = int(eq.labels.shape[0])
    args = em_args(eq, EM_TXPS, device)

    def run(n):
        run_fixture_em(args, EM_TXPS, n)
        _sync(device)

    # steady-state marginal iteration rate: warmed runs at two trip
    # counts difference out the per-call overhead (the combined weights,
    # the degenerate-class pass, the chunks' readbacks)
    run(100)
    run(400)
    for _ in range(2):
        t0 = time.perf_counter()
        run(100)
        t100 = time.perf_counter() - t0
        t0 = time.perf_counter()
        run(400)
        t400 = time.perf_counter() - t0
        if t400 > t100:
            break
    if t400 > t100:
        rate = 300.0 / (t400 - t100)
        _log(f"# EM: 100 iters {t100:.3f}s, 400 iters {t400:.3f}s -> "
             f"{rate:.0f} iters/s marginal "
             f"({100.0 / t100:.0f} incl. overhead)")
    else:
        rate = 400.0 / t400          # incl.-overhead fallback
        _log(f"# EM: marginal measurement unstable "
             f"(t100 {t100:.3f}s >= t400 {t400:.3f}s); reporting "
             f"incl.-overhead {rate:.0f} iters/s")
    return rate, E


def _build_human_cache(cache, idx_dir):
    """First-run hook: the human-scale cache (200k-transcript synthetic
    transcriptome, truth-labelled reads, k=31 index), made in
    subprocesses: the set by scripts/make_synthetic_txome.py, the index
    by this package's CLI."""
    env = dict(os.environ, SALMON_NO_VERSION_CHECK="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    os.makedirs(cache, exist_ok=True)
    fa = os.path.join(cache, "txome_tmp.fasta")
    _log("# building human-scale cache (one-time)...")
    t0 = time.time()
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "make_synthetic_txome.py"),
         "--out-dir", cache, "--n-txps", str(HUMAN_TXPS),
         "--n-pairs", str(HUMAN_PAIRS)], env=env, check=True)
    os.replace(os.path.join(cache, "txome.fasta"), fa)
    t1 = time.time()
    _log(f"# human-scale set made in {t1 - t0:.1f}s")
    subprocess.run(
        [sys.executable, "-m", "salmon_tpu_torch", "index", "-t", fa,
         "-i", idx_dir, "-k", "31", "-p", "4"], env=env, check=True)
    os.remove(fa)
    # ru_maxrss: KiB, the largest of the finished subprocesses
    rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 2**20
    _log(f"# human-scale index built in {time.time() - t1:.1f}s (peak "
         f"RSS {rss:.1f} GiB); cache built in {time.time() - t0:.0f}s")


def _human_scale(cache, build, batch_rows, target_pairs, device,
                 validate=True):
    """Mapping throughput on the 200k-transcript synthetic index (built
    once into `cache` when `build`); (None, None) without it."""
    from salmon_tpu_torch.index.builder import load_index

    idx_dir = os.path.join(cache, "hs_idx")
    r1 = os.path.join(cache, "reads_1.fastq")
    r2 = os.path.join(cache, "reads_2.fastq")
    if not (os.path.isdir(idx_dir) and os.path.exists(r1)):
        if not build:
            _log("# human-scale cache absent and BENCH_BUILD_HS=0; "
                 f"skipping (expected at {cache})")
            return None, None
        try:
            _build_human_cache(cache, idx_dir)
        except Exception as e:
            _log(f"# human-scale cache build failed: {e}")
            return None, None
    t0 = time.perf_counter()
    idx = load_index(idx_dir)
    _log(f"# human index: {idx.num_targets} txps "
         f"(loaded in {time.perf_counter() - t0:.0f}s)")
    # bigger batches amortize the per-call dispatch
    hbatch = max(batch_rows, HUMAN_MIN_BATCH)
    batch = _load_reads(r1, r2, hbatch, device)
    t0 = time.perf_counter()
    frags, mf = _map_throughput(idx, batch,
                                max(1, target_pairs // hbatch), device,
                                validate)
    _log(f"# human-scale mapped fraction: {mf:.4f} (mapping runs "
         f"{time.perf_counter() - t0:.1f}s)")
    return frags, mf


def _discover(device, timeout):
    """The device's name, or the error line and exit 3 when it does not
    answer within `timeout` seconds."""
    ready = threading.Event()

    def _watchdog():
        if not ready.wait(timeout):
            print(json.dumps({
                "metric": "reads/s/chip", "value": 0.0,
                "unit": "fragments/s", "vs_baseline": 0.0,
                "error": "device discovery timed out (the CUDA device "
                         "did not answer)",
            }), flush=True)
            os._exit(3)

    threading.Thread(target=_watchdog, daemon=True).start()
    if device.type == "cuda":
        torch.zeros(1, device=device).add_(1).item()
        kind = torch.cuda.get_device_name(device)
    else:
        kind = "cpu"
    ready.set()
    return kind


def main(argv=None, device="cuda") -> int:
    """Run the harness on `device` (the GPU unless "cpu" is passed) and
    print its JSON line."""
    argparse.ArgumentParser(
        prog="python -m salmon_tpu_torch.bench",
        description=__doc__.split("\n\n")[0]).parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("salmon_tpu_torch.bench measures the GPU and no "
                           "CUDA device is visible (main(device='cpu') "
                           "runs it on the CPU)")
    target_pairs = int(os.environ.get("BENCH_PAIRS", 131072))
    batch_rows = int(os.environ.get("BENCH_BATCH", 4096))
    validate = os.environ.get("BENCH_VALIDATE", "1") != "0"
    fast = os.environ.get("BENCH_FAST", "0") == "1"
    cache = os.environ.get(
        "BENCH_CACHE", os.path.join(os.path.expanduser("~"), ".cache",
                                    "salmon_tpu_bench"))
    build_hs = os.environ.get("BENCH_BUILD_HS", "1") != "0"

    kind = _discover(device, float(os.environ.get("BENCH_DEVICE_TIMEOUT",
                                                  900)))
    _log(f"# bench device: {kind}")

    from salmon_tpu_torch.index.builder import build_index

    idx = build_index(os.path.join(DATA, "transcripts.fasta"), k=25)
    batch = _load_reads(os.path.join(DATA, "reads_1.fastq"),
                        os.path.join(DATA, "reads_2.fastq"), batch_rows,
                        device)
    frags_per_s, mapped_frac = _map_throughput(
        idx, batch, max(1, target_pairs // batch_rows), device, validate)
    _log(f"# sample mapped fraction: {mapped_frac:.4f}")

    human_fps = em_ips = em_entries = None
    if not fast:
        try:
            human_fps, _human_mf = _human_scale(
                cache, build_hs, batch_rows, target_pairs, device,
                validate)
        except Exception as e:  # never lose the headline number
            _log(f"# human-scale bench failed: {e}")
        try:
            em_ips, em_entries = _em_iters_per_s(device)
        except Exception as e:
            _log(f"# EM bench failed: {e}")

    headline = human_fps if human_fps else frags_per_s
    print(json.dumps({
        "metric": ("reads/s/chip (human-scale)" if human_fps
                   else "reads/s/chip (sample)"),
        "value": round(headline, 1),
        "unit": "fragments/s",
        "vs_baseline": round(headline / BASELINE_FRAGS_PER_S, 3),
        "mapped_fraction": round(mapped_frac, 4),
        "sample_frags_per_s": round(frags_per_s, 1),
        "human_frags_per_s": (round(human_fps, 1)
                              if human_fps else None),
        "em_iters_per_s": round(em_ips, 1) if em_ips else None,
        "em_fixture_entries": em_entries,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
