#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (salmon_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases, one line each; any failure raises and exits non-zero:
  1. device  — a CUDA device is visible; nvidia-smi name and power limit
  2. build   — nvcc builds every kernel source of the path, in parallel
  3. kernels — each kernel against its plain torch version on the card,
               at the main path's shapes, in every mode; times and bound
  4. golden  — `index` + `quant -l IU` of tests/data through the CLI,
               held to tests/data/golden like tests/test_golden.py
  5. scale   — `index` + `quant -l A` of a 5,000-transcript /
               200,000-pair synthetic set (scripts/make_synthetic_txome.py):
               fragments/s, mapping rate, DP launches per batch, and
               Spearman of NumReads against the truth in the read names
The kernels JSON line and the card's name and power limit come before
the last line, which is {"ok": true, "device": {...}}. Imports nothing
of JAX or salmon_tpu. --profile adds a phase 6: where the time of the
scale set's quant goes, by quantify's own clocks and a torch.profiler
breakdown of a few batches.
"""

from __future__ import annotations

import gzip
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "tests", "data")

# Spearman of quant.sf NumReads against the simulated truth counts that
# the JAX package reached on the same 5,000-transcript / 200,000-pair set
# (python -m salmon_tpu index -k 31, then quant -l A at defaults, JAX on
# the CPU; the set from scripts/make_synthetic_txome.py as in phase 5).
# The port must come within 0.01 of it.
JAX_SPEARMAN_5K = 0.9993151108089
SCALE_TXPS = 5000
SCALE_PAIRS = 200_000

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 add/max operations per band cell and read row of the DP
# (csrc/banded_dp.cu inner loop; softclip adds one max)
DP_OPS_PER_CELL = 20


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def device_phase():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible: the port runs on the "
                         "GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    phase("device", f"{smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")
    return smi


def build_phase():
    from salmon_tpu_torch import _cuda
    names = ["banded_dp"]
    t0 = time.perf_counter()
    built = _cuda.build(names)
    for name, (sec, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        phase("build", f"{name}: {sec:.1f} s; {' | '.join(regs)}")
    phase("build", f"all kernels ready in {time.perf_counter() - t0:.1f} s")


def _cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def dp_inputs(seed: int, ragged: bool, off64: bool, dev="cuda"):
    """One batch of DP problems shaped like the main path's: R = 4096
    fragments of 100 bp in a 128-column batch, both mates and both
    orientations as read rows (reverse complements flipped to the right
    edge), 2 x R x 2 problems placed near their true transcript
    positions over an 8.3 Mb random transcriptome."""
    import numpy as np
    import torch
    from salmon_tpu_torch.mapping.align import pack_seq4
    from salmon_tpu_torch.mapping.pipeline import _SEQ4_SHIFT, _revcomp_flip

    rng = np.random.default_rng(seed)
    R, L, P = 4096, 128, 16384
    lens = rng.integers(300, 3000, SCALE_TXPS)
    offs = np.concatenate([[0], np.cumsum(lens)])
    seq = rng.integers(0, 4, int(offs[-1])).astype(np.uint8)
    seq[rng.integers(0, seq.shape[0], seq.shape[0] // 2000)] = 4
    words, _ = pack_seq4(seq, lead_pad=_SEQ4_SHIFT)

    def mates():
        t = rng.integers(0, SCALE_TXPS, R)
        rl = (rng.integers(50, L + 1, R) if ragged
              else np.full(R, 100)).astype(np.int32)
        st = (rng.random(R) * (lens[t] - rl)).astype(np.int64)
        codes = np.full((R, L), 4, np.uint8)
        for i in range(R):
            codes[i, :rl[i]] = seq[offs[t[i]] + st[i]:
                                   offs[t[i]] + st[i] + rl[i]]
        err = rng.random((R, L)) < 0.01
        codes = np.where(err & (codes < 4), (codes + 1) % 4, codes)
        return t, st, rl, codes.astype(np.uint8)

    (tl_, sl, ll, cl), (tr, sr, lr, cr) = mates(), mates()
    cl_t, cr_t = torch.from_numpy(cl).to(dev), torch.from_numpy(cr).to(dev)
    reads = torch.cat([cl_t, _revcomp_flip(cl_t), cr_t, _revcomp_flip(cr_t)])
    var = rng.integers(0, 4, P)
    row = rng.integers(0, R, P)
    t = np.where(var < 2, tl_[row], tr[row])
    st = np.where(var < 2, sl[row], sr[row])
    rl = np.where(var < 2, ll[row], lr[row]).astype(np.int32)
    rs = np.where(var % 2 == 1, L - rl, 0).astype(np.int32)
    ref_base = (st - rs + rng.integers(-3, 4, P)).astype(np.int32)
    so = offs[t].astype(np.int64 if off64 else np.int32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return dict(reads=reads, read_ids=put((row + var * R).astype(np.int32)),
                read_lens=put(rl), ref_base=put(ref_base),
                txp_lens=put(lens[t].astype(np.int32)), seq_off=put(so),
                seq_words=put(words.view(np.int32)),
                seq_words_shift=_SEQ4_SHIFT, read_starts=put(rs))


def dp_bound_ms(inp: dict, softclip: bool) -> tuple[float, str]:
    """Least time for the DP's work on this card: fp32 operations over
    the active band cells, against the bytes each input must be read
    (reads, per-problem vectors, each problem's 2-bit window) and the
    scores written."""
    import torch
    L = inp["reads"].shape[1]
    P = inp["read_ids"].shape[0]
    rs, rl = inp["read_starts"].long(), inp["read_lens"].long()
    rows = (torch.clamp(rs + rl, max=L) - torch.clamp(rs, min=0)).clamp(
        min=0).sum().item()
    B = 31
    ops = rows * B * (DP_OPS_PER_CELL + int(softclip))
    window_words = (L + B - 1 + 15) // 16 + 1
    nbytes = (inp["reads"].numel()
              + P * (5 * 4 + inp["seq_off"].element_size())
              + P * window_words * 4 + P * 4)
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_phase() -> dict:
    import torch
    from salmon_tpu_torch.mapping import align

    modes = [("plain", dict(), False, False),
             ("softclip", dict(softclip=True), False, False),
             ("softclip_overhangs", dict(softclip_overhangs=True), False,
              False),
             ("ragged_starts_int64", dict(), True, True)]
    rec = {"name": "banded_dp", "route": "cuda",
           "source": "salmon_tpu_torch/csrc/banded_dp.cu",
           "replaces": "salmon_tpu/mapping/align.py:292",
           "max_abs_err": 0.0, "library_ms": None}
    # no single PyTorch call computes a banded DP: library_ms stays null
    for i, (name, kw, ragged, off64) in enumerate(modes):
        inp = dp_inputs(100 + i, ragged, off64)
        args = (inp["reads"], inp["read_ids"], inp["read_lens"],
                inp["ref_base"], inp["txp_lens"], None, inp["seq_off"], 15,
                2.0, -4.0, 6.0, 2.0)
        kw = dict(kw, seq_words=inp["seq_words"],
                  seq_words_shift=inp["seq_words_shift"],
                  read_starts=inp["read_starts"])
        got = align.banded_scores_indexed(*args, **kw)
        want = align._banded_scores_plain(*args, **kw)
        torch.cuda.synchronize()
        ok = want > -1e8
        err = (got[ok] - want[ok]).abs().max().item() if ok.any() else 0.0
        n_diff = int((got != want).sum())
        if err != 0.0 or n_diff:
            raise AssertionError(f"banded_dp {name}: max |kernel - plain| "
                                 f"{err} over scored problems, {n_diff} "
                                 "problems differ")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        ms = _cuda_ms(lambda: align.banded_scores_indexed(*args, **kw), 20)
        plain_ms = _cuda_ms(lambda: align._banded_scores_plain(*args, **kw),
                            3)
        bound, by = dp_bound_ms(inp, kw.get("softclip", False))
        phase("kernels", f"banded_dp {name}: exact on {int(ok.sum())}/"
              f"{ok.numel()} scored problems; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by})")
        if name == "plain":
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by=by)
    return rec


def _parse_sf(lines):
    rows = {}
    for ln in lines[1:]:
        f = ln.rstrip("\n").split("\t")
        if len(f) >= 5:
            rows[f[0]] = (float(f[2]), float(f[3]), float(f[4]))
    return rows


def golden_phase(tmp: str) -> None:
    import numpy as np
    from salmon_tpu_torch import cli
    from salmon_tpu_torch.mapping.align import BANDED_DP

    idx, out = os.path.join(tmp, "g_idx"), os.path.join(tmp, "g_quant")
    assert cli.main(["index", "-t", os.path.join(DATA, "transcripts.fasta"),
                     "-i", idx, "-k", "31"]) == 0
    BANDED_DP.launches = 0
    assert cli.main(["quant", "-i", idx, "-l", "IU",
                     "-1", os.path.join(DATA, "reads_1.fastq"),
                     "-2", os.path.join(DATA, "reads_2.fastq"),
                     "-o", out, "-q"]) == 0
    launches = BANDED_DP.launches
    with gzip.open(os.path.join(DATA, "golden", "quant.sf.gz"), "rt") as fh:
        want = _parse_sf(fh.readlines())
    with open(os.path.join(out, "quant.sf")) as fh:
        got = _parse_sf(fh.readlines())
    assert set(got) == set(want)
    w = np.array([want[k] for k in sorted(want)])
    g = np.array([got[k] for k in sorted(want)])
    np.testing.assert_allclose(g, w, rtol=5e-3, atol=0.5)
    wj = json.load(open(os.path.join(DATA, "golden",
                                     "lib_format_counts.json")))
    gj = json.load(open(os.path.join(out, "lib_format_counts.json")))
    for k in ("expected_format", "num_compatible_fragments",
              "num_assigned_fragments", "ISF", "ISR", "OSF", "OSR", "MSF",
              "MSR"):
        assert gj[k] == wj[k], (k, gj[k], wj[k])
    assert launches > 0, "the golden quant never launched banded_dp"
    phase("golden", f"quant.sf within rtol 5e-3 / atol 0.5 of the fixture "
          f"(max |diff| {np.abs(g - w).max():.4f}); lib_format_counts "
          f"exact; banded_dp launches {launches}")


def _spearman(a, b) -> float:
    from scipy.stats import spearmanr
    return float(spearmanr(a, b).statistic)


def scale_phase(tmp: str) -> tuple:
    import numpy as np
    import torch
    from salmon_tpu_torch import cli
    from salmon_tpu_torch.mapping.align import BANDED_DP

    syn = os.path.join(tmp, "syn")
    t0 = time.perf_counter()
    subprocess.run([sys.executable,
                    os.path.join(REPO, "scripts", "make_synthetic_txome.py"),
                    "--out-dir", syn, "--n-txps", str(SCALE_TXPS),
                    "--n-pairs", str(SCALE_PAIRS)], check=True,
                   capture_output=True, timeout=600)
    t_gen = time.perf_counter() - t0
    idx, out = os.path.join(syn, "idx"), os.path.join(syn, "quant")
    t0 = time.perf_counter()
    assert cli.main(["index", "-t", os.path.join(syn, "txome.fasta"),
                     "-i", idx, "-k", "31"]) == 0
    t_index = time.perf_counter() - t0
    r1, r2 = (os.path.join(syn, f"reads_{i}.fastq") for i in (1, 2))
    BANDED_DP.launches = 0
    t0 = time.perf_counter()
    assert cli.main(["quant", "-i", idx, "-l", "A", "-1", r1, "-2", r2,
                     "-o", out, "-q"]) == 0
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    launches = BANDED_DP.launches

    meta = json.load(open(os.path.join(out, "aux_info", "meta_info.json")))
    with open(os.path.join(out, "quant.sf")) as fh:
        rows = [ln.rstrip("\n").split("\t") for ln in fh.readlines()[1:]]
    names = [r[0] for r in rows]
    num_reads = np.array([float(r[4]) for r in rows])
    assert len(rows) == SCALE_TXPS and np.isfinite(num_reads).all()
    assert np.isfinite([float(r[2]) for r in rows]).all()
    truth = dict.fromkeys(names, 0)
    with open(r1) as fh:
        for i, ln in enumerate(fh):
            if i % 4 == 0:
                truth[ln[1:].split(":")[1]] += 1
    rho = _spearman(num_reads, [truth[n] for n in names])
    n_batches = math.ceil(SCALE_PAIRS / 4096)
    assert launches == n_batches, (launches, n_batches)
    assert meta["num_processed"] == SCALE_PAIRS
    assert rho >= JAX_SPEARMAN_5K - 0.01, (rho, JAX_SPEARMAN_5K)
    phase("scale", f"{SCALE_TXPS} txps / {SCALE_PAIRS} pairs: data "
          f"{t_gen:.1f} s, index {t_index:.1f} s, quant {t_quant!r} s = "
          f"{SCALE_PAIRS / t_quant!r} frags/s; mapped "
          f"{meta['percent_mapped']!r}%; banded_dp launches {launches} "
          f"for {n_batches} batches; NumReads Spearman vs truth "
          f"{rho!r} (JAX package on the CPU: {JAX_SPEARMAN_5K})")
    return launches, syn


def profile_phase(syn: str, n_batches: int = 6) -> None:
    """Where the time of the scale set's quant goes: the host's split
    between mapping and EM (quant.quantify's own clocks), and, over a
    few batches under torch.profiler, device time by kernel and by
    PyTorch op, launches per batch and the device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from salmon_tpu_torch import quant
    from salmon_tpu_torch.index.builder import load_index
    from salmon_tpu_torch.io.fastq import iter_paired_chunks
    from salmon_tpu_torch.mapping import pipeline
    from salmon_tpu_torch.models.fld import FragmentLengthDistribution

    dev_t = torch.device("cuda")
    r1, r2 = (os.path.join(syn, f"reads_{i}.fastq") for i in (1, 2))
    t0 = time.perf_counter()
    index = load_index(os.path.join(syn, "idx"))
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = quant.quantify(index, "A", [r1], [r2], progress=False,
                         device=dev_t)
    t_quant = time.perf_counter() - t0
    info = res.em_info
    phase("profile", f"quantify {t_quant!r} s after an index load of "
          f"{t_load!r} s: mapping loop {info['map_seconds']!r} s over "
          f"{res.num_batches} batches, EM {info['em_seconds']!r} s "
          f"({info['iterations']} iterations)")

    cfg = pipeline.MapperConfig.from_index(index)
    dev = pipeline.device_index_tensors(index, dev_t)
    fld = FragmentLengthDistribution()
    fld_in = {"logpmf": torch.as_tensor(fld.log_pmf(), dtype=torch.float32,
                                        device=dev_t),
              "logcmf": torch.as_tensor(fld.log_cmf(), dtype=torch.float32,
                                        device=dev_t), "mode": 1}
    cp = torch.ones(6, dtype=torch.bool, device=dev_t)
    co = torch.ones((2, 2), dtype=torch.bool, device=dev_t)
    chunks = iter_paired_chunks([r1], [r2], 4096, 256)
    batches = [{k: torch.from_numpy(v).to(dev_t) for k, v in (
        ("codes_l", c.left.codes), ("lengths_l", c.left.lengths),
        ("codes_r", c.right.codes), ("lengths_r", c.right.lengths))}
        for _, c in zip(range(n_batches + 1), chunks)]
    pipeline.map_paired_batch(batches[0], dev, cfg, fld_in, cp, co)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            out = pipeline.map_paired_batch(b, dev, cfg, fld_in, cp, co)
            out["eq_txp"].cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    kernels = sorted((e for e in avg if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    ops = sorted((e for e in avg if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    phase("profile", f"map_paired_batch, {n_batches} batches of R=4096: "
          f"wall {wall / n_batches * 1e3!r} ms/batch, device busy "
          f"{busy_s / n_batches * 1e3!r} ms/batch, idle share "
          f"{1 - busy_s / wall!r}, {launches / n_batches!r} kernel "
          f"launches/batch")
    for e in kernels[:8]:
        phase("profile", f"kernel {e.key[:60]}: "
              f"{e.self_device_time_total / 1e3 / n_batches!r} ms/batch, "
              f"{e.count / n_batches!r} launches/batch")
    for e in ops[:10]:
        phase("profile", f"op {e.key}: "
              f"{e.self_device_time_total / 1e3 / n_batches!r} ms/batch "
              f"on the device, {e.count / n_batches!r} calls/batch")


def main() -> int:
    smi = device_phase()
    sys.path.insert(0, REPO)
    import torch
    build_phase()
    rec = kernel_phase()
    with tempfile.TemporaryDirectory() as tmp:
        golden_phase(tmp)
        rec["launches"], syn = scale_phase(tmp)
        if "--profile" in sys.argv[1:]:
            profile_phase(syn)
    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"]
    print(json.dumps({"kernels": [{k: rec[k] for k in order}]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
