#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (salmon_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases, one line each; any failure raises and exits non-zero:
  1. device  — a CUDA device is visible; nvidia-smi name and power limit
  2. build   — nvcc builds every kernel source of the path, in parallel,
               and g++ the host library (salmon_tpu_torch/_native.py)
               beside them: its seconds and the g++ version
  3. kernels — each kernel against its plain torch version on the card,
               in every mode: banded_dp at the main DP's band (15) and
               shapes, at the rescue's band (80) and shapes, and at
               bands 40 and 7; the kernel's time (launches through its
               C entry), the plain version's time and the bound for each
     bench   — `python -m salmon_tpu_torch.bench` (the port's harness)
               in a process of its own with BENCH_BUILD_HS=0: its JSON
               line has bench.py's nine keys, the EM fixture's 964,064
               entries, positive sample and EM rates and a banded_dp
               launch on each mapping call; its mapped fraction is the
               port's CPU map_paired_batch's on the same tile; a
               profiled mapping call names banded_dp_kernel; the card's
               EM after 100 iterations on the fixture is held to the
               port's CPU run_em
     host    — each function of the host library against its plain
               version on this machine's host at phase 5's sizes (the
               scale set is made here): the BAM reader over the scale
               BAM, bam_pad_batch and aln_group_eq on its first batch,
               the FASTQ reader on the 200,000 pairs plain and gzipped,
               the flat and partitioned enumerations, table_place,
               oct_align_pads and gather_rows on the set's k-mers, and
               the bucket table's passes over its placed keys (the
               first fingerprint match, the row fill, the inlined
               records) inside build_hash_table at 4 M random keys, the
               tables equal; both times of each
  4. golden  — `index` + `quant -l IU` of tests/data through the CLI,
               held to tests/data/golden like tests/test_golden.py; then
               single-end `quant -l A -r reads_1.fastq` on the card, held
               to the truth in the read names and to the same command
               run by the port on the CPU; --recoverOrphans on 32
               pairs whose right mates only the rescue can place; and
               the sample pairs with --seqBias --gcBias --posBias, with
               --numBootstraps 16 and with --numGibbsSamples 16, each on
               the card against the port's CPU run (observed bias dumps
               equal, expected dumps and bootstraps within stated
               tolerances, Gibbs draws integral and conserving the eq
               classes' total); then alignment mode (`quant -a`) on the
               sample's truth BAM, plain and with --seqBias --gcBias, and
               eq-class mode (`quant -e`) on the golden run's --dumpEq
               output, each on the card against the port's CPU run; the
               sample pairs with the sparse seed flow
               (SALMON_TPU_SPARSE_SEED=1) and with the row-pool gather
               (SALMON_TPU_ROWPOOL=64), eq classes equal to the port's
               CPU run's and the dense card run's, and with a row pool
               that binds (SALMON_TPU_ROWPOOL=2), held to the port's CPU
               run; the side outputs (--writeMappings,
               --writeUnmappedNames, --writeOrphanLinks on pairs with
               swapped mates and all-N pairs, and --profileDir)
               byte-equal to the port's CPU run, the unmapped names
               those of the all-N pairs, the trace naming
               banded_dp_kernel;
               and `quantmerge` (-c TPM, -c NumReads, --genes) of those
               runs, held to their files and to the merge of the CPU
               runs; then in 2 processes sharing the card (gloo):
               --indexShards 2, on the index and on a table-less copy
               (eq classes equal to the sparse card run), and on the
               table-less index of the port's partitioned build (2
               bits; its keys, counts and records those of the flat
               index without its pad records; eq classes equal to the
               table-less copy's run), data-parallel
               plain and with --seqBias --gcBias (within rtol 1e-3 /
               atol 0.5 of the single-rank card run), and
               run_em_sharded against em.optimize
  5. scale   — `index` + `quant -l A` of a 5,000-transcript /
               200,000-pair synthetic set (scripts/make_synthetic_txome.py)
               in ten modes: paired, single-end (-r reads_1), paired
               with --recoverOrphans, with --seqBias --gcBias, with
               --numBootstraps 30, with --numGibbsSamples 32, alignment
               mode on a BAM of every pair and its paralog alignments
               (write_alignment_bam), eq-class mode on the Gibbs run's
               --dumpEq output, paired with the sparse seed flow and
               paired with --writeMappings --writeUnmappedNames (SAM
               records 2 per paired and 1 per orphan fragment, one
               unmapped name per unmapped fragment, the writer's
               seconds). For each: fragments (reads) per second,
               mapping rate, DP launches per batch and band, and Spearman
               of NumReads against the truth in the read names, gated at
               the JAX package's value minus 0.01; the bias mode's stage
               clocks and moved effective lengths, the draws' checks and
               the sampling clock, alignment mode's BAM and stage clocks;
               then in 2 processes sharing the card: `sharded2`
               (--indexShards 2, Spearman equal to `sparse`'s) and `dp2`
               (data-parallel), with the collectives' seconds; and
               `sharded2-decoy`: the set's transcripts plus 2 random
               decoy chromosomes of 4 MiB, indexed table-less by the
               port's partitioned build (6 bits) in a process of its
               own (stage seconds, peak RSS), quantified with
               --indexShards 2 (Spearman equal to the single-rank
               sparse run's on the same decoys, with a table)
     config5 — BASELINE config 5 shard by shard on the one card
               (salmon_tpu_torch.scripts.demo_config5_quant): that
               table-less decoy index at 2 and 4 shards over the
               200,000 pairs, R = 16,384: every pair a fragment,
               banded_dp once a batch, mapped fraction >= 0.99,
               NumReads Spearman at the sparse gate; the sample pairs
               at 2 shards on the golden partitioned index, eq classes
               equal to the port's CPU run of the module
     harness — the port's throughput harnesses on phase 5's set and
               index, each in processes of its own on the card:
               quant_window for 300 s with --progressUpdateMs 0 (exit 0,
               not timed out, all 200,000 pairs counted as
               meta_info.json counts them), then cut short (timed out,
               some but not all pairs counted; its window half that
               run's elapsed seconds, then bisected, at most 6 runs, as
               start-up varies by seconds); bench_multihost --procs 1,2
               --devices-per-proc 0 (2 processes share the card; 200,000
               fragments at each count, the report's keys and each
               rank's clocks; the efficiency recorded, not gated);
               bench_alignment_mode 10
               (both rates positive, quant.sf's NumReads summing to the
               100,000 fragments within 1 %)
     sims    — every truth simulation at its script's default size: the
               mixed simulation (seed 123, 30,000 pairs; mapping rate,
               TPM and counts Spearman >= 0.999, family median relative
               error <= 0.05) and the paralog simulation at the defaults
               (mapping >= 0.995, Spearman(all) >= 0.69, family 0 >=
               0.9, family total error <= 0.01, repeat error <= 0.15),
               the pins of tests/test_accuracy_gate.py; sim_seqbias,
               sim_gcbias and sim_posbias, each mean |log TPM err|
               within 5 % (or 0.003) of the JAX package's CPU value and
               each gain of its sign; sim_rescue_recall, each recall
               within 2 of 48 of the JAX package's, banded_dp at band 80
               once a run
With 2 or more GPUs the multi-process runs repeat over NCCL with a GPU
per process, and at 4 as 2 reads groups of 2 index shards; --multi runs
only them and the single-rank runs they are held to (not
`sharded2-decoy`). Each process of a multi-process run is this script
(--rank, rank_main) with the launch variables set, and reports its own
launch counts; the decoy index is built by this script too
(--build-index, build_index_main).
Every mode runs through the CLI with the launch counts set to 0 just
before it and read just after. The kernels JSON line (one record per
band the main paths run: 15, and 80 for the rescue), the host_native
JSON line (one record per host function: its seconds, the plain
version's and the problem size), the bench JSON line (the harness's
record), the config5 JSON line (each run's report, the device bytes of
each shard's planes, the seconds of load, B1, B2 and the EM), the
harness JSON line (each harness's record and seconds), the sims JSON
line (each metric beside its gate or the JAX package's value, the
banded_dp launches and seconds of each simulation) and the card's name
and power limit come before the last line,
which is {"ok": true, "device": {...}}. Imports nothing of JAX or
salmon_tpu. --profile adds
a phase 6: where the time of the paired scale quant goes, by
quantify's own clocks and a torch.profiler breakdown of a few batches,
dense and sparse seed flow in turns, the clocks and device busy time of
the bias passes and the draws, and the device busy time of alignment
mode's error model.
"""

from __future__ import annotations

import collections
import gzip
import json
import logging
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "tests", "data")
# the CLI's online version check stays off: the card's machine has no
# network
os.environ["SALMON_NO_VERSION_CHECK"] = "1"

# Spearman of quant.sf NumReads against the simulated truth counts that
# the JAX package reached on the same 5,000-transcript / 200,000-pair set
# (python -m salmon_tpu index -k 31, then quant -l A at defaults, JAX on
# the CPU; the set from scripts/make_synthetic_txome.py as in phase 5;
# tools/jax_reference_5k.py reruns it). The port must come within 0.01
# of each: paired, single-end (-r reads_1) and paired --recoverOrphans.
JAX_SPEARMAN_5K = 0.9993151108089
JAX_SPEARMAN_5K_SINGLE = 0.9922372116579615
JAX_SPEARMAN_5K_RESCUE = 0.9992805249685751
# paired with --seqBias --gcBias (tools/jax_reference_5k.py --modes bias)
JAX_SPEARMAN_5K_BIAS = 0.9993151132706852
# alignment mode (-a) on write_alignment_bam's BAM of the set, and
# eq-class mode (-e) on the classes of a paired --dumpEq run
# (tools/jax_reference_5k.py --modes alignment eqclass)
JAX_SPEARMAN_5K_ALIGNMENT = 0.9991168928230324
JAX_SPEARMAN_5K_EQCLASS = 0.9981131999535959
# paired with the sparse seed flow, SALMON_TPU_SPARSE_SEED=1
# (tools/jax_reference_5k.py --modes sparse): below the dense value, as
# its default budget of 32 hits a read end drops paralogs' occurrences
JAX_SPEARMAN_5K_SPARSE = 0.9974659839874211
SPARSE_ENV = {"SALMON_TPU_SPARSE_SEED": "1"}
ROWPOOL_ENV = {"SALMON_TPU_ROWPOOL": "64"}
ROWPOOL_BINDING_ENV = {"SALMON_TPU_ROWPOOL": "2"}   # a budget that binds
# num_orphans_rescued of that --recoverOrphans run, and how far the port
# may be from it (5 %): the rescue probes an orphan's first hit, and
# where orphan hits tie on score the two packages may rank another one
# first (ROADMAP queue 3)
JAX_RESCUED_5K = 197
RESCUED_SLACK = 10
SCALE_TXPS = 5000
SCALE_PAIRS = 200_000
BATCH = 4096            # reads per batch (the default --readBatchSize)
MAIN_BW, RESCUE_BW = 15, 80
SCALE_BOOTSTRAPS, SCALE_GIBBS = 30, 32   # draws in phase 5
# multi-process runs: each rank is a process of this script (rank_main)
# started with parallel.distributed's launch variables; a job whose
# ranks have not all ended after RANK_TIMEOUT seconds fails
RANK_TIMEOUT = 600
# data-parallel runs against the single-rank card run (their steps of
# one chunk per reads group feed the FLD and the online mass otherwise),
# and the sharded EM against em.optimize (tests/test_parallel.py's)
DP_RTOL, DP_ATOL = 1e-3, 0.5
EM_RTOL, EM_ATOL = 1e-4, 1e-3

# `sharded2-decoy`: the scale set's transcripts plus random decoy
# chromosomes (scripts/build_genome_scale_index.py::make_decoys' generator,
# seed 7, at 4 MiB a chromosome), indexed by the port's partitioned build
# at the genome scale's partition width, table-less
DECOY_CHROMS, DECOY_CHROM_MB, DECOY_SEED = 2, 4, 7
DECOY_PART_BITS = 6
# Spearman of a sharded run against the single-rank sparse run of the
# same set and index in the same call (scale_multi_phase holds
# `sharded2` to `sparse` so too)
SHARDED_RHO_EQ = 1e-6
# config5_phase: the shard counts of the shard-by-shard quant on the
# `sharded2-decoy` index, and its least mapped fraction
CONFIG5_SHARDS = (2, 4)
CONFIG5_MIN_MAPPED = 0.99
# harness_phase: quant_window's full window (seconds) on the scale set,
# with a progress line after every batch; bench_alignment_mode's REPS
# (100,000 fragments); a -a quant.sf's NumReads within this share of the
# fragments
QW_SECONDS = 300
QW_CUT_TRIES = 6        # windows bisected for the cut run (harness_phase)
ABENCH_REPS = 10
ABENCH_SUM_RTOL = 0.01
# sims_phase: the truth simulations at their scripts' default sizes. The
# JAX package's values on the CPU, as the unchanged scripts print them
# (JAX_PLATFORMS=cpu python scripts/sim_seqbias.py, and so sim_gcbias.py,
# sim_posbias.py, sim_rescue_recall.py): mean |log TPM err| uncorrected,
# then corrected (--posBias, then --posBiasCorrected), each held within
# SIM_ERR_RTOL (or SIM_ERR_ATOL, the larger) with each gain's sign; and
# rescued of 48 at each (sigma, probes), the oracle's too, within
# RECALL_SLACK (the orphan tie, ROADMAP queue 3)
JAX_SEQBIAS_ERR = (0.0719, 0.0294)
JAX_GCBIAS_ERR = (0.6762, 0.4786)
JAX_POSBIAS_ERR = (0.0563, 0.0878, 0.0517)
SIM_ERR_RTOL, SIM_ERR_ATOL = 0.05, 0.003
JAX_RESCUE_RECALL = {
    (25.0, 1): 46, (25.0, 3): 46, (25.0, 5): 46, (25.0, "oracle"): 45,
    (80.0, 1): 30, (80.0, 3): 46, (80.0, 5): 46, (80.0, "oracle"): 45,
    (160.0, 1): 16, (160.0, 3): 43, (160.0, 5): 44, (160.0, "oracle"): 45}
RECALL_SLACK = 2
# the accuracy gates' pins (tests/test_accuracy_gate.py, the JAX
# package's; tests/test_torch_accuracy_gate.py holds the port to them on
# the CPU): the mixed simulation (seed 123, 30,000 pairs) and the
# paralog simulation at the defaults
MIXED_PAIRS = 30_000
MIXED_MIN = {"mapping_rate": 0.999, "tpm_spearman": 0.999,
             "counts_spearman": 0.999}
MIXED_FAMILY_MEDIAN_RELERR = 0.05
PARALOG_MIN = {"mapping_rate": 0.995, "spearman_all": 0.69,
               "fam0_spearman": 0.9}
PARALOG_MAX = {"fam_total_relerr_max": 0.01, "rep_relerr_max": 0.15}
# host_native's table-pass records (first_match, table_fill_rows,
# table_inline): perf_tools/profile_table_build.py's input size
TABLE_PASS_KEYS = 4_000_000

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# add/max operations per band cell and read row that the DP's function
# needs: F 4, H 2, X 1, E 2, running max 1, and 2 for the
# gap-in-reference prefix done as a running max, E[d] = max(X[d],
# E[d-1] - ge); softclip adds one max. Counted against the fp32 peak
# (the kernel computes in int32 on DPX add-max, which fuses two of them;
# the count and the peak stay as they were, so that bounds compare
# across versions of the kernel)
DP_OPS_PER_CELL = 12


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
    """nvcc on every kernel source and, at the same time in a thread, g++
    on the host library's four sources."""
    import concurrent.futures
    from salmon_tpu_torch import _cuda, _native
    names = ["banded_dp"]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(_native.build)
        built = _cuda.build(names)
        host_built = host.result()
    for name, (sec, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        phase("build", f"{name}: {sec:.1f} s; {' | '.join(regs)}")
    cxx = subprocess.run([_native._cxx(), "--version"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    took = ("built before this run" if host_built is None
            else f"{host_built[0]!r} s")
    phase("build", f"host library ({', '.join(_native.SOURCES)}): {took} "
          f"with {cxx.splitlines()[0]}")
    phase("build", f"all kernels and the host library ready in "
          f"{time.perf_counter() - t0:.1f} s")


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


def dp_inputs(seed: int, ragged: bool, off64: bool, P: int = 16384,
              jitter: int = 3, dev="cuda"):
    """One batch of DP problems shaped like the main path's: R = 4096
    fragments of 100 bp in a 128-column batch, both mates and both
    orientations as read rows (reverse complements flipped to the right
    edge), P problems within `jitter` bases of their true transcript
    positions over an 8.3 Mb random transcriptome. The main DP has
    P = 2 x R x 2 = 16,384 and jitter 3; the rescue P = R / 4 = 1,024
    and jitter 60 (its probes land within the band of 80)."""
    import numpy as np
    import torch
    from salmon_tpu_torch.mapping.align import pack_seq4
    from salmon_tpu_torch.mapping.pipeline import _SEQ4_SHIFT, _revcomp_flip

    rng = np.random.default_rng(seed)
    R, L = BATCH, 128
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
    ref_base = (st - rs + rng.integers(-jitter, jitter + 1, P)).astype(
        np.int32)
    so = offs[t].astype(np.int64 if off64 else np.int32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return dict(reads=reads, read_ids=put((row + var * R).astype(np.int32)),
                read_lens=put(rl), ref_base=put(ref_base),
                txp_lens=put(lens[t].astype(np.int32)), seq_off=put(so),
                seq_words=put(words.view(np.int32)),
                seq_words_shift=_SEQ4_SHIFT, read_starts=put(rs))


def dp_bound_ms(inp: dict, bw: int, softclip: bool) -> tuple[float, str]:
    """Least time for the DP's work on this card: fp32 operations over
    the active band cells (B = 2 bw + 1 per read row, DP_OPS_PER_CELL
    each), against the bytes each input must be read (reads,
    per-problem vectors, each problem's 2-bit window) and the scores
    written."""
    import torch
    L = inp["reads"].shape[1]
    P = inp["read_ids"].shape[0]
    rs, rl = inp["read_starts"].long(), inp["read_lens"].long()
    rows = (torch.clamp(rs + rl, max=L) - torch.clamp(rs, min=0)).clamp(
        min=0).sum().item()
    B = 2 * bw + 1
    ops = rows * B * (DP_OPS_PER_CELL + int(softclip))
    window_words = (L + B - 1 + 15) // 16 + 1
    nbytes = (inp["reads"].numel()
              + P * (5 * 4 + inp["seq_off"].element_size())
              + P * window_words * 4 + P * 4)
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def dp_launch(lib, inp: dict, bw: int, out, softclip: bool = False,
              softclip_overhangs: bool = False) -> int:
    """One launch of a banded-DP build (lib, bound by
    align.bind_banded_dp) on dp_inputs' tensors, through the C interface
    the wrapper calls but without its Python checks, whose host time
    exceeds a launch of ~0.03 ms. Returns the C entry's code."""
    import torch
    return lib.banded_dp_scores(
        inp["reads"].data_ptr(), inp["reads"].shape[0],
        inp["reads"].shape[1], inp["read_ids"].data_ptr(),
        inp["read_lens"].data_ptr(), inp["ref_base"].data_ptr(),
        inp["txp_lens"].data_ptr(), inp["read_starts"].data_ptr(),
        inp["seq_off"].data_ptr(), int(inp["seq_off"].dtype == torch.int64),
        inp["seq_words"].data_ptr(), inp["seq_words"].shape[0],
        inp["seq_words_shift"], inp["read_ids"].shape[0], bw, 2, -4, 6, 2,
        0 if softclip_overhangs else -1000, int(softclip), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)


# (band, problems, placement jitter, cases); a case is (name, kernel
# options, ragged read lengths, int64 transcript offsets). The first
# case of a band gives its record's times.
DP_CASES = [
    (MAIN_BW, 16384, 3, [
        ("plain", dict(), False, False),
        ("softclip", dict(softclip=True), False, False),
        ("softclip_overhangs", dict(softclip_overhangs=True), False, False),
        ("softclip+overhangs",
         dict(softclip=True, softclip_overhangs=True), False, False),
        ("ragged_starts_int64", dict(), True, True)]),
    (RESCUE_BW, BATCH // 4, 60, [
        ("plain", dict(), False, False),
        ("softclip", dict(softclip=True), True, False),
        ("softclip_overhangs", dict(softclip_overhangs=True), False, True),
        ("softclip+overhangs",
         dict(softclip=True, softclip_overhangs=True), True, True)]),
    (40, 4096, 30, [
        ("plain", dict(), True, False),
        ("softclip", dict(softclip=True), False, True),
        ("softclip_overhangs", dict(softclip_overhangs=True), True, True),
        ("softclip+overhangs",
         dict(softclip=True, softclip_overhangs=True), False, False)]),
    (7, 16384, 3, [
        ("plain", dict(), False, True),
        ("softclip", dict(softclip=True), True, True),
        ("softclip_overhangs", dict(softclip_overhangs=True), False, False),
        ("softclip+overhangs",
         dict(softclip=True, softclip_overhangs=True), True, False)]),
]


def kernel_phase() -> dict:
    """banded_dp against its plain version at every band of DP_CASES.
    Returns {band: record} for the bands the main paths run."""
    import torch
    from salmon_tpu_torch import _cuda
    from salmon_tpu_torch.mapping import align

    lib = align.bind_banded_dp(_cuda.load("banded_dp"))
    records = {}
    seed = 100
    for bw, P, jitter, cases in DP_CASES:
        # no single PyTorch call computes a banded DP: library_ms is null
        rec = {"name": f"banded_dp_bw{bw}", "route": "cuda",
               "source": "salmon_tpu_torch/csrc/banded_dp.cu",
               "replaces": "salmon_tpu/mapping/align.py:292",
               "max_abs_err": 0.0, "library_ms": None}
        for name, kw, ragged, off64 in cases:
            seed += 1
            inp = dp_inputs(seed, ragged, off64, P=P, jitter=jitter)
            args = (inp["reads"], inp["read_ids"], inp["read_lens"],
                    inp["ref_base"], inp["txp_lens"], None, inp["seq_off"],
                    bw, 2.0, -4.0, 6.0, 2.0)
            kw = dict(kw, seq_words=inp["seq_words"],
                      seq_words_shift=inp["seq_words_shift"],
                      read_starts=inp["read_starts"])
            got = align.banded_scores_indexed(*args, **kw)
            want = align._banded_scores_plain(*args, **kw)
            torch.cuda.synchronize()
            ok = want > -1e8
            err = (got[ok] - want[ok]).abs().max().item() if ok.any() \
                else 0.0
            n_diff = int((got != want).sum())
            if err != 0.0 or n_diff:
                raise AssertionError(
                    f"banded_dp bw {bw} {name}: max |kernel - plain| {err} "
                    f"over scored problems, {n_diff} problems differ")
            # half the problems read a mate in the orientation it was not
            # drawn in, so about half align
            aligned = float((want > 0).float().mean())
            if aligned < 0.3:
                raise AssertionError(f"banded_dp bw {bw} {name}: only "
                                     f"{aligned} of the problems align")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            # the kernel alone: launches straight through its C entry
            out = torch.empty_like(got)
            mode = {k: kw[k] for k in ("softclip", "softclip_overhangs")
                    if k in kw}
            assert dp_launch(lib, inp, bw, out, **mode) == 0
            torch.cuda.synchronize()
            assert torch.equal(out, got)
            ms = _cuda_ms(lambda: dp_launch(lib, inp, bw, out, **mode), 20)
            call_ms = _cuda_ms(
                lambda: align.banded_scores_indexed(*args, **kw), 20)
            plain_ms = _cuda_ms(
                lambda: align._banded_scores_plain(*args, **kw), 3)
            bound, by = dp_bound_ms(inp, bw, kw.get("softclip", False))
            phase("kernels", f"banded_dp bw {bw} {name} (P = {P}): exact "
                  f"on {int(ok.sum())}/{ok.numel()} problems, "
                  f"{aligned:.3f} aligned; kernel {ms!r} ms ({call_ms!r} "
                  f"ms a wrapper call), plain "
                  f"{plain_ms!r} ms, bound {bound!r} ms ({by})")
            if "ms" not in rec:
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=by)
        if bw in (MAIN_BW, RESCUE_BW):
            records[bw] = rec
    return records


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "mapped_fraction",
              "sample_frags_per_s", "human_frags_per_s", "em_iters_per_s",
              "em_fixture_entries"}
BENCH_EM_ENTRIES = 964_064
BENCH_PAIRS = 131072     # the harness's default pairs a timed loop
BENCH_TIMEOUT = 600
# the card's EM against the port's CPU run after 100 iterations on the
# full fixture: both float32, with their own index_add_ order; each is
# within EM_RTOL / EM_ATOL of a float64 run at 20,000 transcripts
# (tests/test_torch_bench.py), so they are held to twice that
BENCH_EM_RTOL, BENCH_EM_ATOL = 2 * EM_RTOL, 2 * EM_ATOL


def bench_phase(tmp: str) -> tuple:
    """`python -m salmon_tpu_torch.bench` in a process of its own, with
    BENCH_BUILD_HS=0 and an empty cache (no human-scale rate): its JSON
    line has the JAX harness's nine keys, the fixture's 964,064 entries,
    positive sample and EM rates, a banded_dp launch on every mapping
    call, and the mapped fraction of the port's CPU map_paired_batch on
    one tile of the same batch. Then, in this process: one mapping call
    of that batch under the profiler names banded_dp_kernel, and the
    card's EM after 100 iterations on the full fixture agrees with the
    port's CPU run_em. Returns the harness's record."""
    import ast
    import numpy as np
    import torch
    from salmon_tpu_torch import bench
    from salmon_tpu_torch.index.builder import build_index
    from salmon_tpu_torch.mapping.pipeline import map_paired_batch

    env = dict(os.environ, BENCH_BUILD_HS="0", BENCH_FAST="0",
               BENCH_PAIRS=str(BENCH_PAIRS), BENCH_BATCH=str(BATCH),
               BENCH_CACHE=os.path.join(tmp, "bench_cache"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "salmon_tpu_torch.bench"],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    sec = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} lines: {lines}")
    rec = json.loads(lines[0])
    err = proc.stderr.splitlines()
    for ln in err:
        if ln.startswith("# "):
            phase("bench", ln[2:])
    if set(rec) != BENCH_KEYS:
        raise AssertionError(f"bench keys {sorted(rec)}")
    if rec["em_fixture_entries"] != BENCH_EM_ENTRIES:
        raise AssertionError(f"EM fixture of {rec['em_fixture_entries']} "
                             f"entries, not {BENCH_EM_ENTRIES}")
    for key in ("sample_frags_per_s", "em_iters_per_s"):
        if not (rec[key] or 0) > 0:
            raise AssertionError(f"bench {key} = {rec[key]}")
    if rec["human_frags_per_s"] is not None:
        raise AssertionError("a human-scale rate from an empty cache")
    launches = ast.literal_eval(next(
        ln for ln in err if ln.startswith("# banded_dp launches")
    ).split(": ", 1)[1].split(" over ")[0])
    calls = 4 + 3 * (BENCH_PAIRS // BATCH)
    if launches != {MAIN_BW: calls}:
        raise AssertionError(f"the sample rate's {calls} mapping calls "
                             f"launched banded_dp {launches}")

    # the mapped fraction of the harness's first tile, on the CPU
    idx = build_index(os.path.join(DATA, "transcripts.fasta"), k=25)
    r1, r2 = (os.path.join(DATA, f"reads_{i}.fastq") for i in (1, 2))
    cpu = torch.device("cpu")
    cfg, dev, fld, cp, co = bench.mapper_inputs(idx, cpu)
    out = map_paired_batch(bench._load_reads(r1, r2, BATCH, cpu), dev, cfg,
                           fld, cp, co)
    frac = round(float(out["num_mapped"]) / float(out["num_processed"]), 4)
    if rec["mapped_fraction"] != frac:
        raise AssertionError(f"bench mapped_fraction {rec['mapped_fraction']}"
                             f", the CPU map's {frac}")

    # one mapping call of the same batch on the card under the profiler
    gpu = torch.device("cuda")
    cfg, dev, fld, cp, co = bench.mapper_inputs(idx, gpu)
    batch = bench._load_reads(r1, r2, BATCH, gpu)
    map_paired_batch(batch, dev, cfg, fld, cp, co)
    _, kernels, _ = device_profile(
        lambda: map_paired_batch(batch, dev, cfg, fld, cp, co))
    if not any("banded_dp_kernel" in e.key for e in kernels):
        raise AssertionError("the profiler names no banded_dp_kernel in a "
                             "mapping call")

    # the card's EM against the CPU's, 100 iterations on the full fixture
    eq = bench.em_fixture()
    t_em = time.perf_counter()
    card = bench.run_fixture_em(bench.em_args(eq, bench.EM_TXPS, gpu),
                                bench.EM_TXPS, 100)[0].cpu().double().numpy()
    t_em = time.perf_counter() - t_em
    t_cpu = time.perf_counter()
    host = bench.run_fixture_em(bench.em_args(eq, bench.EM_TXPS, cpu),
                                bench.EM_TXPS, 100)[0].double().numpy()
    t_cpu = time.perf_counter() - t_cpu
    np.testing.assert_allclose(card, host, rtol=BENCH_EM_RTOL,
                               atol=BENCH_EM_ATOL)
    diff = np.abs(card - host)
    phase("bench", f"python -m salmon_tpu_torch.bench: {sec!r} s; nine "
          f"keys, {BENCH_EM_ENTRIES} EM entries; sample "
          f"{rec['sample_frags_per_s']!r} frags/s, mapped fraction "
          f"{rec['mapped_fraction']!r} (the CPU map's), banded_dp "
          f"launched {launches[MAIN_BW]} times over {calls} calls and named "
          f"by the profiler; EM {rec['em_iters_per_s']!r} iters/s; card EM "
          f"(100 iterations, {t_em!r} s with its set-up) within rtol "
          f"{BENCH_EM_RTOL} / atol {BENCH_EM_ATOL} of the CPU's ({t_cpu!r} "
          f"s): max |diff| {float(diff.max())!r}")
    return rec


def read_truth(reads_1: str) -> collections.Counter:
    """Reads per true transcript, from read names num:txp:pos:end."""
    truth = collections.Counter()
    with open(reads_1) as fh:
        for i, ln in enumerate(fh):
            if i % 4 == 0:
                truth[ln[1:].split(":")[1]] += 1
    return truth


# alignment-mode BAM of the scale set: a paralog record pair is written
# where each mate has at most this many mismatches (Bowtie2's default
# end-to-end minimum score, -0.6 - 0.6 x 100 = -60.6 at a mismatch
# penalty of 6, admits 10)
ALN_MAX_MISMATCHES = 10
# every this-many-th fragment's records carry =/X CIGARs instead of 100M
# (2 %), so that paralog records with >= 8 mismatches need more than the
# 16 ops the error model's grid holds and take its host path
ALN_EQX_EVERY = 50


def _fastq_codes(path: str):
    """(names, (n, L) uint8 base codes) of a FASTQ of equal-length
    reads."""
    import numpy as np
    with open(path) as fh:
        lines = fh.read().split("\n")
    names = [ln[1:] for ln in lines[0::4] if ln]
    seqs = lines[1::4][:len(names)]
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    codes = lut[np.frombuffer("".join(seqs).encode(), np.uint8)]
    return names, codes.reshape(len(names), -1)


def write_alignment_bam(syn: str, path: str) -> dict:
    """The scale set's pairs as a BAM from an aligner that reports every
    multimapper (Bowtie2 -k, STAR with multimappers), over
    scripts/make_synthetic_txome.py's transcriptome (seed 7):

    - one record pair per fragment at its true transcript and position,
      read from the read name (readnum:txp:start:fraglen);
    - a secondary record pair for every other member of that transcript's
      paralog family (same coordinates) that holds the whole fragment
      with at most ALN_MAX_MISMATCHES mismatches a mate. A family is a
      run of consecutive transcripts whose first 300 bases (every
      transcript has at least 300) differ on under 10 % of positions:
      the generator derives a family from one base sequence with ~2 %
      divergence, and unrelated transcripts differ on ~75 %;
    - CIGAR 100M, or =/X runs for every ALN_EQX_EVERY-th fragment;
      AS = 2 x matches - 4 x mismatches, NM = mismatches.

    Returns counts of what was written."""
    import importlib.util
    import numpy as np
    from salmon_tpu_torch.alignment.bamio import write_bam

    spec = importlib.util.spec_from_file_location(
        "make_synthetic_txome",
        os.path.join(REPO, "scripts", "make_synthetic_txome.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    names, seqs = gen.make_txome(SCALE_TXPS, seed=7)
    lens = [s.shape[0] for s in seqs]
    tid = {nm: i for i, nm in enumerate(names)}
    family = np.zeros(len(seqs), np.int64)
    for t in range(1, len(seqs)):
        differ = np.mean(seqs[t][:300] != seqs[t - 1][:300])
        family[t] = family[t - 1] + (differ >= 0.1)
    members = collections.defaultdict(list)
    for t, f in enumerate(family):
        members[f].append(t)

    rnames, c1 = _fastq_codes(os.path.join(syn, "reads_1.fastq"))
    _, c2 = _fastq_codes(os.path.join(syn, "reads_2.fastq"))
    # the right mate in reference orientation, as a BAM stores a
    # reverse-strand record
    c2 = np.where(c2 < 4, 3 - c2, 4)[:, ::-1]
    rl = c1.shape[1]
    stats = collections.Counter()

    def cigar(mismatch):
        if not mismatch.any():
            return f"{rl}="
        edges = np.flatnonzero(np.diff(mismatch.astype(np.int8))) + 1
        bounds = np.concatenate([[0], edges, [rl]])
        return "".join(f"{b - a}{'X' if mismatch[a] else '='}"
                       for a, b in zip(bounds[:-1], bounds[1:]))

    def records():
        for i, name in enumerate(rnames):
            _, txp, st, fl = name.split(":")
            t, st, fl = tid[txp], int(st), int(fl)
            p2 = st + fl - rl
            s1 = "".join("ACGTN"[x] for x in c1[i])
            s2 = "".join("ACGTN"[x] for x in c2[i])
            eqx = i % ALN_EQX_EVERY == 0
            for u in [t] + [u for u in members[family[t]] if u != t]:
                if lens[u] < st + fl:
                    continue
                mm1 = c1[i] != seqs[u][st:st + rl]
                mm2 = c2[i] != seqs[u][p2:p2 + rl]
                if u != t and max(mm1.sum(), mm2.sum()) > ALN_MAX_MISMATCHES:
                    continue
                sec = 0x100 if u != t else 0
                stats["secondary_pairs" if sec else "primary_pairs"] += 1
                for flag, pos, mpos, tlen, seq, mm in (
                        (0x1 | 0x40 | 0x20, st, p2, fl, s1, mm1),
                        (0x1 | 0x80 | 0x10, p2, st, -fl, s2, mm2)):
                    n_mm = int(mm.sum())
                    stats["records"] += 1
                    stats["eqx_records"] += eqx
                    yield dict(name=name, refid=u, pos=pos, flag=flag | sec,
                               cigar=cigar(mm) if eqx else f"{rl}M",
                               seq=seq, mate_refid=u, mate_pos=mpos,
                               tlen=tlen, tags={"AS": 2 * (rl - n_mm)
                                                - 4 * n_mm, "NM": n_mm})

    write_bam(path, names, lens, records())
    stats["fragments"] = len(rnames)
    stats["families"] = int(sum(len(m) > 1 for m in members.values()))
    return dict(stats)


# the BamBatch fields the host check compares (every one)
BAM_FIELDS = ("refid", "pos", "flag", "mapq", "mate_refid", "mate_pos",
              "tlen", "read_len", "seq_off", "cigar_off", "cigar_n",
              "as_tag", "nm_tag", "zw_tag", "name_hash", "seq_buf",
              "cigar_op", "cigar_oplen")


def _equal(got, want, what: str) -> None:
    """Arrays, or tuples and lists of them (nested), equal element for
    element (NaN equal to NaN); raises naming `what`."""
    import numpy as np
    if isinstance(got, (tuple, list)):
        if len(got) != len(want):
            raise AssertionError(f"{what}: {len(got)} parts, plain "
                                 f"{len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{what}[{i}]")
        return
    g, w = np.asarray(got), np.asarray(want)
    if g.shape != w.shape or not np.array_equal(
            g, w, equal_nan=g.dtype.kind == "f"):
        raise AssertionError(f"{what}: differs from its plain version")


def table_pass_records(n_keys: int = TABLE_PASS_KEYS) -> list:
    """The bucket table's native passes over the placed keys against
    their plain versions, inside build_hash_table over
    perf_tools/profile_table_build.py's input (n_keys random 62-bit keys
    from seed 0, 1-4 records each) with random records to inline: the
    first fingerprint match (table_first_match, plain
    _first_match_numpy), the row fill (table_fill_rows, plain
    _fill_rows_numpy) and the inlined records (table_inline, plain
    _inline_numpy). One build takes the native passes, one the plain
    ones: each pass's seconds in both, both builds' seconds, and the
    tables (rows, shadow appendix, counts) equal. Returns one
    host_native record per pass."""
    import numpy as np
    from salmon_tpu_torch.index import hashtable, native_kmers

    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(0, 1 << 62, n_keys, dtype=np.int64)
                     .astype(np.uint64))
    counts = rng.integers(1, 5, keys.size)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    txp = rng.integers(0, 1 << 18, int(offsets[-1])).astype(np.int32)
    pf = rng.integers(0, 1 << 24, int(offsets[-1])).astype(np.int32)
    passes = {"first_match": ("table_first_match", "_first_match_numpy"),
              "table_fill_rows": ("table_fill_rows", "_fill_rows_numpy"),
              "table_inline": ("table_inline", "_inline_numpy")}
    native = {name: getattr(native_kmers, fn)
              for name, (fn, _) in passes.items()}

    def build(plain: bool):
        sec = dict.fromkeys(passes, 0.0)

        def timed(name, route):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = route(*args, **kwargs)
                sec[name] += time.perf_counter() - t0
                return out
            return call

        for name, (fn, plain_fn) in passes.items():
            route = getattr(hashtable, plain_fn) if plain else native[name]
            setattr(native_kmers, fn, timed(name, route))
        try:
            t0 = time.perf_counter()
            tab = hashtable.build_hash_table(keys, occ_offsets=offsets,
                                             inline_records=(txp, pf))
            return tab, sec, time.perf_counter() - t0
        finally:
            for name, (fn, _) in passes.items():
                setattr(native_kmers, fn, native[name])

    tab, sec, build_sec = build(plain=False)
    want, plain_sec, plain_build_sec = build(plain=True)
    _equal((tab.rows, tab.appendix), (want.rows, want.appendix),
           "table passes: tables")
    assert (tab.n_shadowed, tab.n_evicted, tab.n_inlined) == \
        (want.n_shadowed, want.n_evicted, want.n_inlined)
    size = (f"{keys.size} random keys, {tab.n_shadowed} shadowed, "
            f"{tab.n_inlined} inlined")
    records = []
    for name in passes:
        phase("host", f"{name} ({size}): tables equal to the plain "
              f"passes'; native {sec[name]!r} s, plain {plain_sec[name]!r}"
              f" s ({plain_sec[name] / max(sec[name], 1e-9)!r}x)")
        records.append({"name": name, "seconds": sec[name],
                        "plain_seconds": plain_sec[name], "size": size,
                        "build_seconds": build_sec,
                        "plain_build_seconds": plain_build_sec})
    phase("host", f"build_hash_table ({size}): {build_sec!r} s with the "
          f"native passes, {plain_build_sec!r} s with the plain ones")
    return records


def host_native_phase(syn: str) -> tuple:
    """Each function of the port's native host library against its plain
    version on this machine's host, at phase 5's sizes: the BAM reader
    over the whole scale BAM (written here), bam_pad_batch and
    aln_group_eq on its first batch, the FASTQ reader on the 200,000
    pairs plain and gzipped, the flat and 6-bit partitioned enumerations
    of the set's transcripts, table_place and oct_align_pads on its keys,
    the table's passes over its placed keys at TABLE_PASS_KEYS random
    keys (table_pass_records), gather_rows of one of 2 shards' records.
    Returns (one record per function for the host_native line, the
    BAM's (stats, seconds))."""
    import gzip
    import shutil

    import numpy as np
    from salmon_tpu_torch.alignment import alnweights, bamio
    from salmon_tpu_torch.alignment import errormodel_device as emd
    from salmon_tpu_torch.alignment import quant as aq
    from salmon_tpu_torch.constants import DEFAULTS
    from salmon_tpu_torch.index import (builder, hashtable, kmer_enum,
                                        native_kmers)
    from salmon_tpu_torch.index.diskfmt import _oct_align_pads_py
    from salmon_tpu_torch.io import fastq
    from salmon_tpu_torch.io.fasta import load_transcripts
    from salmon_tpu_torch.models.fld import FragmentLengthDistribution

    records = []

    def check(name, size, native, plain, same=None):
        t0 = time.perf_counter()
        got = native()
        sec = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = plain()
        plain_sec = time.perf_counter() - t0
        (same or _equal)(got, want, name)
        records.append({"name": name, "seconds": sec,
                        "plain_seconds": plain_sec, "size": size})
        phase("host", f"{name} ({size}): equal to its plain version; "
              f"native {sec!r} s, plain {plain_sec!r} s "
              f"({plain_sec / max(sec, 1e-9)!r}x)")
        return got

    bam = os.path.join(syn, "aln.bam")
    t0 = time.perf_counter()
    stats = write_alignment_bam(syn, bam)
    t_bam = time.perf_counter() - t0

    def read(reader, *args):
        out = list(reader.batches(*args))
        reader.close()
        return out

    def same_batches(got, want, what):
        _equal([g.n for g in got], [w.n for w in want], what)
        for f in BAM_FIELDS:
            _equal([getattr(g, f) for g in got],
                   [getattr(w, f) for w in want], f"{what} {f}")

    batches = check("bam_next_batch", f"{stats['records']} records",
                    lambda: read(bamio.BamReader(bam)),
                    lambda: read(bamio._PyBam(bam), 1 << 16), same_batches)
    b = batches[0]
    sel = np.nonzero((b.flag & bamio.FLAG_UNMAPPED) == 0)[0]
    rl = -(-int(b.read_len.max()) // 64) * 64
    check("bam_pad_batch", f"{sel.size} records, grid {rl} wide",
          lambda: emd.pad_records(b, sel, rl),
          lambda: emd.pad_records_numpy(b, sel, rl))

    # the -a mode's weights before the error model is ready: AS and
    # the prior FLD (alignment/quant.py)
    (fid, keep, refid, flen, obs, score, *_) = aq._group_fragments(b, True)
    keep &= refid >= 0
    o = DEFAULTS
    log_pmf = FragmentLengthDistribution(
        max_val=o.max_frag_length, prior_mu=o.frag_len_prior_mean,
        prior_sigma=o.frag_len_prior_sd).log_pmf()
    logw = (score[keep].astype(np.float64)
            + log_pmf[np.clip(flen[keep], 0, o.max_frag_length)])
    args = (fid[keep], refid[keep], flen[keep], obs[keep], logw)

    def weigh_plain():
        eq_txp, eq_w, w, valid, starts, counts, wn, hist = \
            aq._weigh_fragments(*args, o, True)
        return (eq_txp, eq_w, wn, aq._best_alignments(w, valid, starts,
                                                      counts), hist)

    def same_weights(got, want, what):
        eq_txp, eq_w, wn, best, hist, _ = got
        _equal((eq_txp, best[best >= 0]), (want[0], want[3]), what)
        for name, g, w, rtol in (("eq_w", eq_w, want[1], 1e-5),
                                 ("wn", wn, want[2], 1e-12),
                                 ("fld_hist", hist, want[4], 1e-12)):
            if not np.allclose(g, w, rtol=rtol, atol=1e-12):
                raise AssertionError(f"{what} {name}: beyond rtol {rtol}")

    check("aln_group_eq", f"{args[0].size} alignments of "
          f"{np.unique(args[0]).size} fragments",
          lambda: alnweights.group_eq(*args, o.min_aln_prob, True,
                                      o.max_frag_length),
          weigh_plain, same_weights)

    reads = [os.path.join(syn, f"reads_{i}.fastq") for i in (1, 2)]
    for r in reads:
        with open(r, "rb") as src, gzip.open(r + ".gz", "wb", 1) as dst:
            shutil.copyfileobj(src, dst)

    def same_chunks(got, want, what):
        _equal([(c.left.codes, c.left.lengths, c.right.codes,
                 c.right.lengths, c.n_valid) for c in got],
               [(c.left.codes, c.left.lengths, c.right.codes,
                 c.right.lengths, c.n_valid) for c in want], what)

    for tag, (r1, r2) in (("plain", reads),
                          ("gzipped", [r + ".gz" for r in reads])):
        check(f"fastq_next_batch {tag}", f"{SCALE_PAIRS} pairs",
              lambda: list(fastq.iter_paired_chunks([r1], [r2], BATCH,
                                                    256)),
              lambda: list(fastq._iter_paired_chunks_py([r1], [r2], BATCH,
                                                        256)),
              same_chunks)

    txps, _ = load_transcripts(os.path.join(syn, "txome.fasta"))
    seq = np.concatenate([t.seq_codes for t in txps])
    off = np.concatenate([[0], np.cumsum([t.seq_codes.size
                                          for t in txps])]).astype(np.int64)
    km, tx, po, fw = check(
        "kmer_enumerate", f"{seq.size} bases, k 31",
        lambda: native_kmers.enumerate_sorted(seq, off, 31),
        lambda: builder._enumerate_sorted_records(seq, off, 31))
    check("kmer_enumerate_part", f"{seq.size} bases, k 31, "
          f"{DECOY_PART_BITS} bits",
          lambda: list(native_kmers.enumerate_sorted_partitioned(
              seq, off, 31, DECOY_PART_BITS)),
          lambda: list(kmer_enum.enumerate_sorted_partitioned(
              seq, off, 31, DECOY_PART_BITS)))

    keys, counts = np.unique(km, return_counts=True)
    n_buckets = hashtable.table_n_slots(keys.size) // 4

    def place_plain():
        hi, lo = hashtable.split_u64(keys)
        mask = np.uint32(n_buckets - 1)
        return hashtable._place_keys_numpy(
            (hashtable.mix32(hi, lo) & mask).astype(np.int64),
            (hashtable.mix32b(hi, lo) & mask).astype(np.int64), counts,
            n_buckets)

    check("table_place", f"{keys.size} keys, {n_buckets} buckets",
          lambda: native_kmers.table_place(keys, counts, n_buckets),
          place_plain)
    check("oct_align_pads", f"{keys.size} keys",
          lambda: native_kmers.oct_align_pads(counts, 8),
          lambda: _oct_align_pads_py(counts, 8))
    records += table_pass_records()
    # one of 2 shards' occurrence records, 8 bytes each
    occ = np.stack([tx, (po << 1) | fw], axis=1)
    gidx = np.nonzero(np.repeat(np.arange(keys.size) % 2 == 0, counts))[0]
    check("gather_rows", f"{gidx.size} of {occ.shape[0]} 8-byte records",
          lambda: native_kmers.gather_rows(occ, gidx), lambda: occ[gidx])
    return records, (stats, t_bam)


def _parse_sf(lines):
    rows = {}
    for ln in lines[1:]:
        f = ln.rstrip("\n").split("\t")
        if len(f) >= 5:
            rows[f[0]] = (float(f[2]), float(f[3]), float(f[4]))
    return rows


def spearman(quant_sf: str, truth) -> float:
    """Spearman of quant.sf NumReads against the truth counts, over
    every transcript of quant.sf."""
    import numpy as np
    from scipy.stats import spearmanr
    with open(quant_sf) as fh:
        rows = _parse_sf(fh.readlines())
    names = list(rows)
    num_reads = np.array([rows[n][2] for n in names])
    assert np.isfinite(num_reads).all()
    assert np.isfinite([rows[n][0] for n in names]).all()
    return float(spearmanr(num_reads, [truth.get(n, 0)
                                       for n in names]).statistic)


class StageClocks(logging.Handler):
    """Collects the stage clocks that the port logs with its records
    (extra={"clocks": {...}}: the bias collection and passes, the second
    EM, posterior sampling), and the text of its warnings."""

    def __init__(self):
        super().__init__()
        self.clocks = {}
        self.warnings = []

    def emit(self, record):
        self.clocks.update(getattr(record, "clocks", {}))
        if record.levelno >= logging.WARNING:
            self.warnings.append(record.getMessage())


def run_quant(argv: list, device=None, env=None) -> tuple[dict, float,
                                                          dict]:
    """One `quant` through the CLI, with the environment variables of
    `env` set for it, and the banded_dp launch counts set to 0 just
    before it. Returns (launches by band, seconds, the stage clocks the
    port logged)."""
    import torch
    from salmon_tpu_torch import cli
    from salmon_tpu_torch.mapping.align import BANDED_DP

    clocks = StageClocks()
    log = logging.getLogger("salmon_tpu_torch")
    log.addHandler(clocks)
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        BANDED_DP.reset()
        t0 = time.perf_counter()
        assert cli.main(["quant", *argv, "-q"], device=device) == 0
        if device is None:
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    finally:
        log.removeHandler(clocks)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return dict(BANDED_DP.by_shape), sec, clocks.clocks


def golden_phase(tmp: str) -> str:
    import numpy as np
    from salmon_tpu_torch import cli

    idx, out = os.path.join(tmp, "g_idx"), os.path.join(tmp, "g_quant")
    assert cli.main(["index", "-t", os.path.join(DATA, "transcripts.fasta"),
                     "-i", idx, "-k", "31"]) == 0
    launches, _, _ = run_quant(["-i", idx, "-l", "IU",
                                "-1", os.path.join(DATA, "reads_1.fastq"),
                                "-2", os.path.join(DATA, "reads_2.fastq"),
                                "--dumpEq", "-o", out])
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
    assert launches.get(MAIN_BW, 0) > 0 and set(launches) == {MAIN_BW}, \
        f"the golden quant launched banded_dp {launches}"
    phase("golden", f"quant.sf within rtol 5e-3 / atol 0.5 of the fixture "
          f"(max |diff| {np.abs(g - w).max():.4f}); lib_format_counts "
          f"exact; banded_dp launches {launches}")
    return idx


def golden_single_phase(idx: str, tmp: str) -> None:
    """Single-end quant of the sample's first reads on the card: held to
    the truth in the read names (tests/test_library_modes.py's gate) and
    to the port's own CPU run of the same command."""
    reads = os.path.join(DATA, "reads_1.fastq")
    outs = {d: os.path.join(tmp, f"g_single_{d}") for d in ("cuda", "cpu")}
    launches, sec, _ = run_quant(["-i", idx, "-l", "A", "-r", reads,
                                  "-o", outs["cuda"]])
    run_quant(["-i", idx, "-l", "A", "-r", reads, "-o", outs["cpu"]],
              device="cpu")
    diff = sf_close(outs["cuda"], outs["cpu"])
    rho = spearman(os.path.join(outs["cuda"], "quant.sf"),
                   read_truth(reads))
    meta = json.load(open(os.path.join(outs["cuda"], "aux_info",
                                       "meta_info.json")))
    assert rho >= 0.97, rho
    assert meta["library_types"] in (["U"], ["SF"], ["SR"]), meta
    assert launches.get(MAIN_BW, 0) > 0 and set(launches) == {MAIN_BW}, \
        f"the single-end quant launched banded_dp {launches}"
    phase("golden", f"single-end -r reads_1.fastq on the card: Spearman "
          f"vs truth {rho!r} (gate 0.97), library {meta['library_types']}, "
          f"mapped {meta['percent_mapped']!r}%, quant.sf within rtol 5e-3 "
          f"/ atol 0.5 of the port's CPU run (max |diff| "
          f"{diff:.4f}); {sec:.2f} s; banded_dp launches {launches}")


def golden_rescue_phase(idx: str, tmp: str) -> None:
    """--recoverOrphans on 32 pairs of the sample transcripts whose right
    mate has a mismatch every 12 bases: no k = 31 seed survives, but the
    mate aligns above minScoreFraction, so only the rescue pairs them
    (tests/test_quant_extras.py::test_orphan_rescue). On the card and in
    the port's CPU run: the same count rescued, at least 25."""
    import numpy as np
    from salmon_tpu_torch.index.builder import load_index

    index = load_index(idx)
    rng = np.random.default_rng(0)
    RL, FL = 76, 250
    paths = [os.path.join(tmp, f"rescue_{e}.fastq") for e in (1, 2)]
    with open(paths[0], "w") as f1, open(paths[1], "w") as f2:
        for i in range(32):
            codes = index.transcript_codes(int(rng.integers(
                0, index.num_valid_targets)))
            start = int(rng.integers(0, codes.shape[0] - FL))
            left = codes[start:start + RL]
            right = codes[start + FL - RL:start + FL][::-1]
            right = np.where(right < 4, 3 - right, 4)
            right[5::12] = (right[5::12] + 1) % 4
            for fh, c in ((f1, left), (f2, right)):
                fh.write(f"@p{i}\n{''.join('ACGTN'[x] for x in c)}\n+\n"
                         f"{'I' * RL}\n")
    meta, outs = {}, {}
    for device in (None, "cpu"):
        out = os.path.join(tmp, f"g_rescue_{device or 'cuda'}")
        launches, _, _ = run_quant(["-i", idx, "-l", "IU", "-1", paths[0],
                                    "-2", paths[1], "--recoverOrphans",
                                    "-o", out], device=device)
        if device is None:
            card_launches = launches
        meta[device] = json.load(open(os.path.join(out, "aux_info",
                                                   "meta_info.json")))
        outs[device] = out
    rescued = meta[None]["num_orphans_rescued"]
    assert rescued == meta["cpu"]["num_orphans_rescued"] >= 25, \
        (rescued, meta["cpu"]["num_orphans_rescued"])
    sf_close(outs[None], outs["cpu"])
    assert card_launches == {MAIN_BW: 1, RESCUE_BW: 1}, card_launches
    phase("golden", f"--recoverOrphans on 32 pairs with unseedable right "
          f"mates: {rescued} rescued on the card and on the CPU (gate "
          f"25); banded_dp launches {card_launches}")


def sf_close(got_dir: str, want_dir: str, rtol: float = 5e-3,
             atol: float = 0.5) -> float:
    """quant.sf of two runs within rtol / atol (by default the golden
    tolerance); returns the largest difference."""
    import numpy as np
    sf = []
    for d in (got_dir, want_dir):
        with open(os.path.join(d, "quant.sf")) as fh:
            sf.append(_parse_sf(fh.readlines()))
    got, want = sf
    assert set(got) == set(want)
    g = np.array([got[k] for k in sorted(want)])
    w = np.array([want[k] for k in sorted(want)])
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    return float(np.abs(g - w).max())


def eq_total(out: str) -> int:
    """Fragments in the equivalence classes of a --dumpEq run."""
    with gzip.open(os.path.join(out, "aux_info", "eq_classes.txt.gz"),
                   "rt") as fh:
        n_txps, n_classes = int(fh.readline()), int(fh.readline())
        for _ in range(n_txps):
            fh.readline()
        return sum(int(fh.readline().rsplit("\t", 1)[1])
                   for _ in range(n_classes))


def check_draws(out: str, n_draws: int, gibbs: bool) -> tuple:
    """Posterior draws of one run: n_draws rows over quant.sf's
    transcripts; Gibbs draws integral with every total equal to the eq
    classes' total, bootstrap totals within 0.1 % of the resampled total
    (the quant's assigned reads); the draws' mean ranks transcripts as
    NumReads does (Spearman >= 0.99). Returns (Spearman, largest
    relative deviation of a draw's total)."""
    import numpy as np
    from scipy.stats import spearmanr
    from salmon_tpu_torch.io.writers import read_bootstraps

    names, draws = read_bootstraps(out)
    with open(os.path.join(out, "quant.sf")) as fh:
        rows = _parse_sf(fh.readlines())
    assert names == list(rows), "names.tsv.gz differs from quant.sf"
    assert draws.shape == (n_draws, len(names)), draws.shape
    assert np.isfinite(draws).all() and (draws >= 0).all()
    num_reads = np.array([rows[n][2] for n in names])
    meta = json.load(open(os.path.join(out, "aux_info", "meta_info.json")))
    assert meta["samp_type"] == ("gibbs" if gibbs else "bootstrap"), meta
    assert meta["num_bootstraps"] == n_draws, meta
    if gibbs:
        assert (draws == np.round(draws)).all(), "a Gibbs draw is not integral"
        total = eq_total(out)
        assert (draws.sum(axis=1) == total).all(), (draws.sum(axis=1), total)
    else:
        total = num_reads.sum()
        assert np.abs(draws.sum(axis=1) / total - 1).max() <= 1e-3
    rho = float(spearmanr(draws.mean(axis=0), num_reads).statistic)
    assert rho >= 0.99, rho
    return rho, float(np.abs(draws.sum(axis=1) / total - 1).max())


# exp*_{seq,gc,pos} dumps, card against CPU: float32 sums of up to ~3e4
# terms per bin, added by atomics on the card and in sequence on the
# CPU: ~sqrt(n) 2^-24 ~ 1e-5 apart; ten times that
EXP_RTOL = 1e-4
# bootstrap draws, card against CPU: a replicate whose last relative
# change sits on the 1e-2 stopping threshold may stop one iteration
# apart on the two devices, which moves a transcript by up to ~1e-2
BOOT_RTOL, BOOT_ATOL = 2e-2, 1.0


def golden_bias_sampling_phase(idx: str, tmp: str) -> None:
    """The sample pairs with bias correction and with posterior draws,
    each on the card and in the port's CPU run: quant.sf within the
    golden tolerance of the CPU's; observed bias dumps equal, expected
    dumps within EXP_RTOL, the bias meta keys and aux_target_ids.json as
    asked; bootstraps within BOOT_RTOL / BOOT_ATOL of the CPU's; Gibbs
    draws checked by check_draws on both devices."""
    import numpy as np
    from salmon_tpu_torch.io.writers import read_bootstraps, read_matrix_gz

    reads = ["-1", os.path.join(DATA, "reads_1.fastq"),
             "-2", os.path.join(DATA, "reads_2.fastq")]
    aux_file = os.path.join(tmp, "aux_targets.txt")
    with open(aux_file, "w") as fh:
        fh.write("NM_014620\n")
    runs = [  # (name, flags, draws)
        ("bias", ["--seqBias", "--gcBias", "--posBias"], 0),
        ("bias-corrected", ["--seqBias", "--posBiasCorrected",
                            "--auxTargetFile", aux_file], 0),
        ("bootstrap", ["--numBootstraps", "16"], 16),
        ("bootstrap-reproject", ["--numBootstraps", "8",
                                 "--bootstrapReproject", "--seed", "7"], 8),
        ("gibbs", ["--numGibbsSamples", "16", "--thinningFactor", "4",
                   "--dumpEq"], 16),
        ("gibbs-noGammaDraw", ["--numGibbsSamples", "8", "--thinningFactor",
                               "2", "--noGammaDraw", "--dumpEq"], 8),
    ]
    for name, flags, n_draws in runs:
        outs = {}
        for device in (None, "cpu"):
            outs[device] = os.path.join(tmp, f"g_{name}_{device or 'cuda'}")
            launches, sec, clocks = run_quant(
                ["-i", idx, "-l", "IU", *reads, *flags, "-o",
                 outs[device]], device=device)
            if device is None:
                card = (launches, sec, clocks)
        launches, sec, clocks = card
        assert launches.get(MAIN_BW, 0) > 0 and set(launches) == {MAIN_BW}, \
            f"the golden {name} quant launched banded_dp {launches}"
        diff = sf_close(outs[None], outs["cpu"])
        aux = {d: os.path.join(o, "aux_info") for d, o in outs.items()}
        meta = json.load(open(os.path.join(aux[None], "meta_info.json")))
        if name.startswith("bias"):
            seq, gc = "--seqBias" in flags, "--gcBias" in flags
            corrected = "--posBiasCorrected" in flags
            pos = corrected or "--posBias" in flags
            assert (meta["seq_bias_correct"], meta["gc_bias_correct"],
                    meta["pos_bias_correct"]) == (seq, gc, pos), meta
            assert meta["pos_bias_mode"] == (
                "corrected" if corrected else "reference-parity"), meta
            dumps = ((["5_seq.gz", "3_seq.gz"] if seq else [])
                     + (["_gc.gz"] if gc else [])
                     + (["5_pos.gz", "3_pos.gz"] if pos else []))
            exp_err = 0.0
            for dump in dumps:
                g, w = (read_matrix_gz(os.path.join(aux[d], "obs" + dump))
                        for d in (None, "cpu"))
                assert g.sum() > 0 and np.array_equal(g, w), "obs" + dump
                g, w = (read_matrix_gz(os.path.join(aux[d], "exp" + dump))
                        for d in (None, "cpu"))
                np.testing.assert_allclose(g, w, rtol=EXP_RTOL,
                                           err_msg="exp" + dump)
                exp_err = max(exp_err, float(
                    (np.abs(g - w) / np.maximum(np.abs(w), 1e-30)).max()))
            extra = (f"{len(dumps)} observed dumps equal, expected dumps "
                     f"within rel {exp_err!r} (gate {EXP_RTOL})")
            if "--auxTargetFile" in flags:
                ids = [json.load(open(os.path.join(
                    aux[d], "aux_target_ids.json"))) for d in (None, "cpu")]
                assert ids[0] == ids[1] and ids[0]["aux_target_ids"], ids
                extra += f"; aux_target_ids.json {ids[0]} on both"
        elif name.startswith("bootstrap"):
            check_draws(outs[None], n_draws, gibbs=False)
            (nc, bc), (nw, bw) = (read_bootstraps(outs[d])
                                  for d in (None, "cpu"))
            assert nc == nw
            np.testing.assert_allclose(bc, bw, rtol=BOOT_RTOL,
                                       atol=BOOT_ATOL)
            extra = (f"bootstraps within max |diff| "
                     f"{np.abs(bc - bw).max():.4f} of the CPU's (gate "
                     f"rtol {BOOT_RTOL} / atol {BOOT_ATOL})")
        else:
            rho, _ = check_draws(outs[None], n_draws, gibbs=True)
            rho_cpu, _ = check_draws(outs["cpu"], n_draws, gibbs=True)
            extra = (f"Gibbs draws integral, totals = eq total "
                     f"{eq_total(outs[None])}, mean vs NumReads Spearman "
                     f"{rho!r} (CPU run {rho_cpu!r})")
        phase("golden", f"{name} ({' '.join(flags)}): quant.sf within rtol "
              f"5e-3 / atol 0.5 of the port's CPU run (max |diff| "
              f"{diff:.4f}); {extra}; clocks {clocks}; {sec:.2f} s; "
              f"banded_dp launches {launches}")


def sample_truth_bam(path: str) -> int:
    """The sample pairs at their true transcript and positions, from the
    read names (readnum:txp:start:fragment end), as a paired BAM written
    by the port's write_bam (tests/test_alignment_mode.py's truth BAM).
    Returns the number of records."""
    from salmon_tpu_torch.alignment.bamio import write_bam
    from salmon_tpu_torch.io.fasta import load_transcripts

    records, _ = load_transcripts(os.path.join(DATA, "transcripts.fasta"),
                                  noclip_polya=True)
    names = [r.name for r in records]
    tid = {nm: i for i, nm in enumerate(names)}
    with open(os.path.join(DATA, "reads_1.fastq")) as f1, \
            open(os.path.join(DATA, "reads_2.fastq")) as f2:
        l1, l2 = f1.read().split("\n"), f2.read().split("\n")
    recs = []
    for i in range(0, len(l1) - 3, 4):
        name = l1[i][1:].split()[0]
        _, txp, pos, fend = name.split(":")
        rid, pos, fend = tid[txp], int(pos), int(fend)
        s1, s2 = l1[i + 1].strip(), l2[i + 1].strip()
        tlen, p2 = fend - pos + 1, fend - len(s2) + 1
        recs.append(dict(name=name, refid=rid, pos=pos,
                         flag=0x1 | 0x40 | 0x20, cigar=f"{len(s1)}M",
                         seq=s1, mate_refid=rid, mate_pos=p2, tlen=tlen,
                         tags={"AS": 2 * len(s1), "NM": 0}))
        recs.append(dict(name=name, refid=rid, pos=p2,
                         flag=0x1 | 0x80 | 0x10, cigar=f"{len(s2)}M",
                         seq=s2, mate_refid=rid, mate_pos=pos, tlen=-tlen,
                         tags={"AS": 2 * len(s2), "NM": 0}))
    write_bam(path, names, [r.seq_codes.shape[0] for r in records], recs)
    return len(recs)


def golden_alignment_phase(tmp: str) -> None:
    """Alignment mode on the sample truth BAM, plain and with --seqBias
    --gcBias, and eq-class mode on the golden paired run's --dumpEq
    output, each on the card against the port's CPU run of the same
    command: quant.sf within rtol 5e-3 / atol 0.5, and for -a Spearman
    against the truth >= 0.999 (tests/test_alignment_mode.py's gate).
    Neither mode launches banded_dp."""
    bam = os.path.join(tmp, "g_truth.bam")
    n_rec = sample_truth_bam(bam)
    truth = read_truth(os.path.join(DATA, "reads_1.fastq"))
    fasta = os.path.join(DATA, "transcripts.fasta")
    runs = [("-a", ["-t", fasta, "-l", "A", "-a", bam]),
            ("-a --seqBias --gcBias", ["-t", fasta, "-l", "A", "-a", bam,
                                       "--seqBias", "--gcBias"]),
            ("-e", ["-e", os.path.join(tmp, "g_quant"), "-l", "A"])]
    for name, argv in runs:
        outs, metas = {}, {}
        for device in (None, "cpu"):
            outs[device] = os.path.join(
                tmp, f"g_{name.replace(' ', '')}_{device or 'cuda'}")
            launches, sec, clocks = run_quant([*argv, "-o", outs[device]],
                                              device=device)
            assert launches == {}, (name, launches)
            metas[device] = json.load(open(os.path.join(
                outs[device], "aux_info", "meta_info.json")))
            if device is None:
                card = (sec, clocks)
        diff = sf_close(outs[None], outs["cpu"])
        rho = spearman(os.path.join(outs[None], "quant.sf"), truth)
        meta = metas[None]
        if name.startswith("-a"):
            assert rho >= 0.999, (name, rho)
            assert meta["mapping_type"] == "alignment", meta
            assert meta["num_processed"] == n_rec // 2, meta
        else:
            assert meta["mapping_type"] == "eqclass", meta
        phase("golden", f"{name}: quant.sf within rtol 5e-3 / atol 0.5 of "
              f"the port's CPU run (max |diff| {diff:.4f}); Spearman vs "
              f"truth {rho!r}; num_em_iterations {meta['num_em_iterations']} "
              f"(CPU run {metas['cpu']['num_em_iterations']}); "
              f"{card[0]:.2f} s; clocks {card[1]}")


def sample_gene_map(tmp: str) -> str:
    """A gene map of the sample transcripts for `-g`: each consecutive
    pair of tests/data/transcripts.fasta's transcripts is one gene."""
    with open(os.path.join(DATA, "transcripts.fasta")) as fh:
        names = [ln[1:].split()[0] for ln in fh if ln.startswith(">")]
    path = os.path.join(tmp, "sample_genes.tsv")
    with open(path, "w") as fh:
        fh.writelines(f"{t}\tG{i // 2}\n" for i, t in enumerate(names))
    return path


N_ALL_N = 200   # fragments of swapped_mates whose two ends are all N


def swapped_mates(tmp: str) -> list:
    """The sample pairs with the right mates of every 8th fragment and
    its fifth neighbour swapped, and both ends of every 50th fragment,
    from the 4th, all N (tests/test_torch_side_outputs.py's reads): a
    quarter of the fragments have no concordant pair and map as
    orphans, and N_ALL_N map nowhere. Returns the -1/-2 arguments."""
    args = []
    for flag, mate in (("-1", "1"), ("-2", "2")):
        with open(os.path.join(DATA, f"reads_{mate}.fastq")) as fh:
            lines = fh.read().splitlines(keepends=True)
        recs = [lines[i:i + 4] for i in range(0, len(lines), 4)]
        if mate == "2":
            for i in range(0, len(recs) - 5, 8):
                recs[i][1], recs[i + 5][1] = recs[i + 5][1], recs[i][1]
        for r in recs[3::50]:
            r[1] = "N" * (len(r[1]) - 1) + "\n"
        path = os.path.join(tmp, f"swapped_reads_{mate}.fastq")
        with open(path, "w") as fh:
            fh.write("".join("".join(r) for r in recs))
        args += [flag, path]
    return args


def _bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def eq_class_lines(out: str) -> list:
    """The class lines of a --dumpEq run's eq_classes.txt.gz (labels and
    counts, no weights), with its header and transcript names."""
    with gzip.open(os.path.join(out, "aux_info", "eq_classes.txt.gz"),
                   "rt") as fh:
        n_txps, n_classes = int(fh.readline()), int(fh.readline())
        return [fh.readline() for _ in range(n_txps + n_classes)]


def golden_seed_modes_phase(idx: str, tmp: str, gene_map: str) -> dict:
    """The sample pairs (-l IU, -g gene_map, --dumpEq) with the sparse
    seed flow and with the row-pool gather, each on the card and in the
    port's CPU run: equivalence classes (labels and counts) equal to the
    CPU run's and to the dense card run's (g_quant), quant.sf within the
    golden tolerance of both. (The EM adds float32 on the card with
    atomics, so its last printed digits can differ from the CPU's, as in
    the dense runs above.) Then the row pool at a budget of 2 windows a
    read row, which binds: the card's run warns of the windows it left
    without their first row, as the CPU run does, and its eq classes
    and quant.sf are held to the CPU run's only. Returns {mode: {device:
    output directory}} of the first two."""
    reads = ["-1", os.path.join(DATA, "reads_1.fastq"),
             "-2", os.path.join(DATA, "reads_2.fastq")]
    dense = os.path.join(tmp, "g_quant")
    log = logging.getLogger("salmon_tpu_torch")
    runs = {}
    for name, env in (("sparse", SPARSE_ENV), ("rowpool-64", ROWPOOL_ENV),
                      ("rowpool-2", ROWPOOL_BINDING_ENV)):
        outs, saturated = {}, {}
        for device in (None, "cpu"):
            outs[device] = os.path.join(tmp, f"g_{name}_{device or 'cuda'}")
            watch = StageClocks()
            log.addHandler(watch)
            try:
                launches, sec, _ = run_quant(
                    ["-i", idx, "-l", "IU", *reads, "-g", gene_map,
                     "--dumpEq", "-o", outs[device]], device=device, env=env)
            finally:
                log.removeHandler(watch)
            saturated[device] = [w for w in watch.warnings
                                 if "tail-gather budget saturated" in w]
            if device is None:
                card = (launches, sec)
        launches, sec = card
        assert launches.get(MAIN_BW, 0) > 0 and set(launches) == {MAIN_BW}, \
            f"the golden {name} quant launched banded_dp {launches}"
        binding = name == "rowpool-2"
        assert saturated[None] == saturated["cpu"] and \
            bool(saturated[None]) == binding, (name, saturated)
        classes = eq_class_lines(outs[None])
        others = [outs["cpu"]] if binding else [outs["cpu"], dense]
        for other in others:
            assert classes == eq_class_lines(other), \
                f"{name}: eq classes differ from {other}"
        diffs = ", ".join(f"{sf_close(outs[None], o):.4f}" for o in others)
        phase("golden", f"{name} ({env}): {len(classes)} eq-class lines "
              f"equal to the port's CPU run"
              f"{'' if binding else ' and the dense card run'}; quant.sf "
              f"within rtol 5e-3 / atol 0.5 (max |diff| {diffs}); "
              f"{(saturated[None] or ['pool budget not reached'])[0]}; "
              f"{sec:.2f} s; banded_dp launches {launches}")
        if not binding:
            runs[name] = outs
    return runs


def golden_side_outputs_phase(idx: str, tmp: str, gene_map: str) -> dict:
    """One paired run (-l IU, -g gene_map) on swapped_mates with
    --writeMappings FILE --writeUnmappedNames --writeOrphanLinks on the
    card, also with --profileDir, and on the CPU: the SAM file,
    unmapped_names.txt and orphan_links.txt byte-equal, the unmapped
    names those of the N_ALL_N all-N fragments; the trace present,
    non-empty and naming banded_dp_kernel. Returns {device:
    output directory}."""
    reads = swapped_mates(tmp)
    outs, prof_dir = {}, os.path.join(tmp, "g_profile")
    side = ["--writeUnmappedNames", "--writeOrphanLinks"]
    for device in (None, "cpu"):
        outs[device] = os.path.join(tmp, f"g_side_{device or 'cuda'}")
        prof = ["--profileDir", prof_dir] if device is None else []
        launches, sec, clocks = run_quant(
            ["-i", idx, "-l", "IU", *reads, "-g", gene_map,
             "--writeMappings", outs[device] + ".sam", *side, *prof, "-o",
             outs[device]], device=device)
        if device is None:
            card = (launches, sec, clocks)
    launches, sec, clocks = card
    assert launches.get(MAIN_BW, 0) > 0 and set(launches) == {MAIN_BW}, \
        f"the golden side-output quant launched banded_dp {launches}"
    sizes = {}
    for name, rel in (("SAM", ".sam"),
                      ("unmapped_names.txt",
                       "/aux_info/unmapped_names.txt"),
                      ("orphan_links.txt", "/aux_info/orphan_links.txt")):
        got, want = (_bytes(outs[d] + rel) for d in (None, "cpu"))
        assert got == want, f"{name} on the card differs from the CPU run"
        sizes[name] = got.count(b"\n")
    assert sizes["orphan_links.txt"] > 1000 and sizes["SAM"] > 15000, sizes
    # the all-N fragments, and only they, are unmapped
    with open(reads[1]) as fh:
        heads = fh.read().splitlines()[::4]
    all_n = "".join(h[1:].split()[0] + " u\n" for h in heads[3::50])
    assert sizes["unmapped_names.txt"] == N_ALL_N, sizes
    assert _bytes(outs[None] + "/aux_info/unmapped_names.txt") \
        == all_n.encode(), "unmapped names are not the all-N fragments"
    traces = os.listdir(prof_dir)
    assert len(traces) == 1, traces
    trace = os.path.join(prof_dir, traces[0])
    body = _bytes(trace)
    assert body and b"banded_dp_kernel" in body, trace
    phase("golden", f"side outputs on pairs with swapped mates: SAM, "
          f"unmapped_names.txt, orphan_links.txt byte-equal to the port's "
          f"CPU run (lines {sizes}); --profileDir trace {traces[0]} of "
          f"{len(body)} bytes names banded_dp_kernel; clocks {clocks}; "
          f"{sec:.2f} s (under the profiler); banded_dp launches {launches}")
    return outs


def golden_quantmerge_phase(tmp: str, card: list, cpu: list) -> None:
    """quantmerge (-c TPM, -c NumReads, --genes) of the card runs'
    outputs: each cell the `:g` text of its run's quant.sf (or
    quant.genes.sf) value, and the matrix of the same merge of the
    port's CPU runs alike in names and within the golden tolerance."""
    import numpy as np
    from salmon_tpu_torch import cli
    from salmon_tpu_torch.io.writers import read_quant_sf

    names = ["--names", *(f"s{i}" for i in range(len(card)))]
    lines = {}
    for name, flags, col, fname in (
            ("TPM", ["-c", "TPM"], "TPM", "quant.sf"),
            ("NumReads", ["-c", "NumReads"], "NumReads", "quant.sf"),
            ("genes", ["--genes", "-c", "NumReads"], "NumReads",
             "quant.genes.sf")):
        tables = []
        for tag, dirs in (("cuda", card), ("cpu", cpu)):
            out = os.path.join(tmp, f"g_merge_{name}_{tag}.tsv")
            assert cli.main(["quantmerge", "--quants", *dirs, *names,
                             *flags, "-o", out]) == 0
            with open(out) as fh:
                rows = [ln.rstrip("\n").split("\t") for ln in fh]
            assert rows[0] == ["Name", *names[1:]], rows[0]
            for j, d in enumerate(dirs):
                q = read_quant_sf(os.path.join(d, fname))
                want = dict(zip(q["Name"], (f"{v:g}" for v in q[col])))
                assert {r[0]: r[1 + j] for r in rows[1:]} == want, (name, d)
            tables.append(rows)
        (got, want) = tables
        assert [r[0] for r in got] == [r[0] for r in want]
        np.testing.assert_allclose(
            np.array([r[1:] for r in got[1:]], float),
            np.array([r[1:] for r in want[1:]], float), rtol=5e-3, atol=0.5)
        lines[name] = len(got)
    phase("golden", f"quantmerge of {len(card)} card runs: every cell the "
          f"printed value of its run's file, the matrix within rtol 5e-3 / "
          f"atol 0.5 of the merge of their CPU runs (-c TPM, -c NumReads, "
          f"--genes; lines {lines})")


def changed_eff_share(plain: str, corrected: str) -> float:
    """Share of the transcripts with >= 10 reads in the plain run whose
    EffectiveLength the bias-corrected run moved by more than 0.01."""
    import numpy as np
    sf = []
    for d in (plain, corrected):
        with open(os.path.join(d, "quant.sf")) as fh:
            sf.append(_parse_sf(fh.readlines()))
    expressed = [n for n, row in sf[0].items() if row[2] >= 10]
    moved = [abs(sf[0][n][0] - sf[1][n][0]) > 0.01 for n in expressed]
    return float(np.mean(moved))


def make_scale_set(tmp: str) -> str:
    """scripts/make_synthetic_txome.py's SCALE_TXPS transcripts and
    SCALE_PAIRS pairs (seed 7) in tmp/syn; returns that directory."""
    syn = os.path.join(tmp, "syn")
    t0 = time.perf_counter()
    subprocess.run([sys.executable,
                    os.path.join(REPO, "scripts", "make_synthetic_txome.py"),
                    "--out-dir", syn, "--n-txps", str(SCALE_TXPS),
                    "--n-pairs", str(SCALE_PAIRS)], check=True,
                   capture_output=True, timeout=600)
    phase("scale", f"{SCALE_TXPS} txps / {SCALE_PAIRS} pairs: data "
          f"{time.perf_counter() - t0:.1f} s")
    return syn


def scale_phase(syn: str, only=None, bam=None) -> tuple:
    """The modes of the 5k / 200k set in syn (those named in `only`,
    default all); `bam`, (stats, seconds) of write_alignment_bam's BAM
    when it is written already. Returns ({mode: launches by band}, {mode:
    (Spearman, quant seconds)})."""
    from salmon_tpu_torch import cli

    idx = os.path.join(syn, "idx")
    t0 = time.perf_counter()
    assert cli.main(["index", "-t", os.path.join(syn, "txome.fasta"),
                     "-i", idx, "-k", "31"]) == 0
    phase("scale", f"index {time.perf_counter() - t0:.1f} s")
    r1, r2 = (os.path.join(syn, f"reads_{i}.fastq") for i in (1, 2))
    truth = read_truth(r1)
    n_batches = math.ceil(SCALE_PAIRS / BATCH)
    pairs = ["-i", idx, "-1", r1, "-2", r2]
    bam_path = os.path.join(syn, "aln.bam")
    sam = os.path.join(syn, "mappings.sam")
    # the draws and the side outputs leave quant.sf as the paired run
    # writes it, so those modes keep the paired gate; -a and -e launch no
    # banded_dp. (mode, argv, gate, launches, environment)
    modes = [
        ("paired", pairs, JAX_SPEARMAN_5K, {MAIN_BW: n_batches}, None),
        ("single-end", ["-i", idx, "-r", r1], JAX_SPEARMAN_5K_SINGLE,
         {MAIN_BW: n_batches}, None),
        ("recoverOrphans", [*pairs, "--recoverOrphans"],
         JAX_SPEARMAN_5K_RESCUE, {MAIN_BW: n_batches, RESCUE_BW: n_batches},
         None),
        ("bias", [*pairs, "--seqBias", "--gcBias"], JAX_SPEARMAN_5K_BIAS,
         {MAIN_BW: n_batches}, None),
        ("bootstrap", [*pairs, "--numBootstraps", str(SCALE_BOOTSTRAPS)],
         JAX_SPEARMAN_5K, {MAIN_BW: n_batches}, None),
        ("gibbs", [*pairs, "--numGibbsSamples", str(SCALE_GIBBS),
                   "--dumpEq"], JAX_SPEARMAN_5K, {MAIN_BW: n_batches}, None),
        ("alignment", ["-t", os.path.join(syn, "txome.fasta"), "-a",
                       bam_path],
         JAX_SPEARMAN_5K_ALIGNMENT, {}, None),
        ("eqclass", ["-e", os.path.join(syn, "quant_gibbs")],
         JAX_SPEARMAN_5K_EQCLASS, {}, None),
        ("sparse", pairs, JAX_SPEARMAN_5K_SPARSE, {MAIN_BW: n_batches},
         SPARSE_ENV),
        ("mappings", [*pairs, "--writeMappings", sam, "--writeUnmappedNames"],
         JAX_SPEARMAN_5K, {MAIN_BW: n_batches}, None),
    ]
    runs, seconds, rho_sec = {}, {}, {}
    for mode, argv, jax_rho, want_launches, env in modes:
        if only is not None and mode not in only:
            continue
        extra = ""
        if mode == "alignment":
            if bam is None:
                t0 = time.perf_counter()
                bam = write_alignment_bam(syn, bam_path), \
                    time.perf_counter() - t0
            stats, t_bam = bam
        out = os.path.join(syn, f"quant_{mode}")
        launches, sec, clocks = run_quant(["-l", "A", *argv, "-o", out],
                                          env=env)
        seconds[mode] = sec
        meta = json.load(open(os.path.join(out, "aux_info",
                                           "meta_info.json")))
        rho = spearman(os.path.join(out, "quant.sf"), truth)
        if mode == "eqclass":
            gibbs = json.load(open(os.path.join(
                syn, "quant_gibbs", "aux_info", "meta_info.json")))
            assert meta["num_processed"] == gibbs["num_mapped"], meta
        else:
            assert meta["num_processed"] == SCALE_PAIRS, meta["num_processed"]
        assert launches == want_launches, (mode, launches, want_launches)
        assert rho >= jax_rho - 0.01, (mode, rho, jax_rho)
        unit = "reads" if mode == "single-end" else "frags"
        if mode == "recoverOrphans":
            rescued = meta["num_orphans_rescued"]
            assert abs(rescued - JAX_RESCUED_5K) <= RESCUED_SLACK, \
                (rescued, JAX_RESCUED_5K)
            extra = (f"; num_orphans_rescued {rescued} (JAX package on the "
                     f"CPU: {JAX_RESCUED_5K})")
        elif mode == "bias":
            share = changed_eff_share(os.path.join(syn, "quant_paired"), out)
            assert share >= 0.5, share
            extra = (f"; EffectiveLength moved on {share!r} of the "
                     f"transcripts with >= 10 reads; seconds: collection "
                     f"{clocks['bias_collect_seconds']!r}, expected pass "
                     f"{clocks['bias_expected_seconds']!r}, efflen pass "
                     f"{clocks['bias_efflen_seconds']!r}, second EM "
                     f"{clocks['em2_seconds']!r}")
        elif mode in ("bootstrap", "gibbs"):
            n = SCALE_BOOTSTRAPS if mode == "bootstrap" else SCALE_GIBBS
            d_rho, dev = check_draws(out, n, gibbs=mode == "gibbs")
            extra = (f"; {n} draws, largest relative deviation of a draw's "
                     f"total {dev!r}, draws' mean vs NumReads Spearman "
                     f"{d_rho!r}; sampling {clocks['sampling_seconds']!r} s")
        elif mode == "alignment":
            assert clocks["host_path_records"] > 0, clocks
            extra = (f"; BAM of {stats['records']} records "
                     f"({stats['records'] / 2 / SCALE_PAIRS!r} alignments "
                     f"per fragment, {stats['secondary_pairs']} secondary "
                     f"pairs over {stats['families']} paralog families, "
                     f"{stats['eqx_records']} records with =/X CIGARs) "
                     f"built in {t_bam!r} s; bam_read_seconds "
                     f"{clocks['bam_read_seconds']!r}, errmodel_seconds "
                     f"{clocks['errmodel_seconds']!r}, host-path records "
                     f"{clocks['host_path_records']}, em_seconds "
                     f"{clocks['em_seconds']!r}; num_em_iterations "
                     f"{meta['num_em_iterations']}")
        elif mode == "eqclass":
            extra = (f"; num_em_iterations {meta['num_em_iterations']} over "
                     f"{meta['num_eq_classes']} classes")
        elif mode == "sparse":
            extra = (f"; dense paired in this call "
                     f"{SCALE_PAIRS / seconds['paired']!r} frags/s")
        elif mode == "mappings":
            paired_n, orphan_n, n_rec = sam_fragments(sam)
            assert paired_n + orphan_n == meta["num_mapped"], \
                (paired_n, orphan_n, meta["num_mapped"])
            assert n_rec == 2 * paired_n + orphan_n, (n_rec, paired_n)
            with open(os.path.join(out, "aux_info",
                                   "unmapped_names.txt")) as fh:
                n_unmapped = sum(1 for _ in fh)
            assert n_unmapped == meta["num_processed"] - meta["num_mapped"]
            extra = (f"; SAM {n_rec} records = 2 x {paired_n} paired + "
                     f"{orphan_n} orphan fragments, {n_unmapped} unmapped "
                     f"names; sam_write_seconds "
                     f"{clocks['sam_write_seconds']!r}, side_output_seconds "
                     f"{clocks['side_output_seconds']!r} of the quant's "
                     f"{sec!r} s; plain paired in this call "
                     f"{SCALE_PAIRS / seconds['paired']!r} frags/s")
        # -e re-runs the EM alone: no fragment passes through it
        rate = "" if mode == "eqclass" else f" = {SCALE_PAIRS / sec!r} {unit}/s"
        if "map_seconds" in clocks:
            n = clocks["mapped_batches"]
            extra += (f"; map_seconds {clocks['map_seconds'] / n!r} s a "
                      f"batch, of it read_seconds "
                      f"{clocks['read_seconds'] / n!r}")
        phase("scale", f"{mode}: quant {sec!r} s{rate}; mapped "
              f"{meta['percent_mapped']!r}%; banded_dp "
              f"launches {launches} for {n_batches} batches; NumReads "
              f"Spearman vs truth {rho!r} (JAX package on the CPU: "
              f"{jax_rho}){extra}")
        runs[mode] = launches
        rho_sec[mode] = (rho, sec)
    return runs, rho_sec


def sam_fragments(path: str) -> tuple:
    """(paired fragments, orphan fragments, records) of a --writeMappings
    SAM: a paired fragment has two records flagged 0x1, an orphan (or
    single-end read) one record without it; anything else fails."""
    recs = collections.Counter()
    paired = set()
    with open(path) as fh:
        for ln in fh:
            if ln.startswith("@"):
                continue
            name, flag = ln.split("\t", 2)[:2]
            recs[name] += 1
            if int(flag) & 0x1:
                paired.add(name)
    bad = [n for n, c in recs.items() if c != (2 if n in paired else 1)]
    assert not bad, bad[:5]
    return len(paired), len(recs) - len(paired), sum(recs.values())


def device_profile(fn) -> tuple:
    """fn() once under torch.profiler, between synchronizes. Returns
    (wall seconds, CUDA kernel events by device time, descending, all
    events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    kernels = sorted((e for e in avg if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    return wall, kernels, avg


def profile_phase(syn: str, n_batches: int = 6) -> None:
    """Where the time of the scale set's quant goes: the host's split
    between mapping and EM (quant.quantify's own clocks), and, over a
    few batches under torch.profiler (profile_mapping, the dense and
    the sparse seed flow), device time by kernel and by PyTorch op,
    launches per batch and the device's idle share. Then the same for
    the stages after the EM: quantify's bias clocks with --seqBias
    --gcBias, and the bias passes, the bootstraps and the Gibbs draws
    once each under the profiler."""
    import torch
    from salmon_tpu_torch import quant
    from salmon_tpu_torch.index.builder import load_index

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

    profile_mapping(index, r1, r2, dev_t, n_batches)
    profile_post_em(index, res, r1, r2, dev_t)
    profile_alignment(syn, dev_t)


def profile_mapping(index, r1: str, r2: str, dev_t, n_batches: int = 6,
                    turns: int = 2) -> None:
    """map_paired_batch over n_batches batches of R = 4,096 pairs under
    torch.profiler, the dense and the sparse seed flow in turns (dense,
    sparse, dense, ...): wall and device busy time a batch, the device's
    idle share, kernel launches, banded_dp's share and the top kernels
    and PyTorch ops by device time."""
    import dataclasses
    import torch
    from torch.autograd import DeviceType
    from salmon_tpu_torch.io.fastq import iter_paired_chunks
    from salmon_tpu_torch.mapping import pipeline
    from salmon_tpu_torch.models.fld import FragmentLengthDistribution

    cfgs = {"dense": pipeline.MapperConfig.from_index(index)}
    cfgs["sparse"] = dataclasses.replace(cfgs["dense"], sparse_seed=True)
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
    for cfg in cfgs.values():
        pipeline.map_paired_batch(batches[0], dev, cfg, fld_in, cp, co)

    for turn in range(turns):
        for flow, cfg in cfgs.items():
            def map_batches():
                for b in batches[1:]:
                    out = pipeline.map_paired_batch(b, dev, cfg, fld_in, cp,
                                                    co)
                    out["eq_txp"].cpu()

            wall, kernels, avg = device_profile(map_batches)
            ops = sorted((e for e in avg if e.device_type == DeviceType.CPU
                          and e.key.startswith("aten::")),
                         key=lambda e: -e.self_device_time_total)
            busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
            launches = sum(e.count for e in kernels)
            tag = f"map_paired_batch {flow} (turn {turn + 1})"
            phase("profile", f"{tag}, {n_batches} batches of R=4096: wall "
                  f"{wall / n_batches * 1e3!r} ms/batch, device busy "
                  f"{busy_s / n_batches * 1e3!r} ms/batch, idle share "
                  f"{1 - busy_s / wall!r}, {launches / n_batches!r} kernel "
                  f"launches/batch")
            dp = [e for e in kernels if "banded_dp_kernel" in e.key]
            dp_s = sum(e.self_device_time_total for e in dp) / 1e6
            phase("profile", f"{tag} banded_dp: "
                  f"{dp_s / n_batches * 1e3!r} ms/batch, "
                  f"{sum(e.count for e in dp) / n_batches!r} launches/batch, "
                  f"{dp_s / busy_s!r} of device busy time")
            if turn:
                continue
            for e in kernels[:8]:
                phase("profile", f"{tag} kernel {e.key[:60]}: "
                      f"{e.self_device_time_total / 1e3 / n_batches!r} "
                      f"ms/batch, {e.count / n_batches!r} launches/batch")
            for e in ops[:10]:
                phase("profile", f"{tag} op {e.key}: "
                      f"{e.self_device_time_total / 1e3 / n_batches!r} "
                      f"ms/batch on the device, "
                      f"{e.count / n_batches!r} calls/batch")


def profile_post_em(index, res, r1: str, r2: str, dev_t) -> None:
    """The stages after the EM on the scale set: quantify's clocks with
    --seqBias --gcBias, then the bias passes (fed the plain run's
    alphas), --numBootstraps and --numGibbsSamples once each under
    torch.profiler. `res` is the plain paired run's QuantResult."""
    import numpy as np
    from salmon_tpu_torch import quant
    from salmon_tpu_torch.constants import SalmonDefaults
    from salmon_tpu_torch.inference import sampling
    from salmon_tpu_torch.models.efflen import effective_lengths

    opts = SalmonDefaults()
    opts.seq_bias_correct = opts.gc_bias_correct = True
    res_b = quant.quantify(index, "A", [r1], [r2], opts=opts,
                           progress=False, device=dev_t)
    c = res_b.em_info
    phase("profile", f"quantify --seqBias --gcBias: mapping loop "
          f"{c['map_seconds']!r} s, of it the bias collection "
          f"{c['bias_collect_seconds']!r} s; expected pass "
          f"{c['bias_expected_seconds']!r} s, efflen pass "
          f"{c['bias_efflen_seconds']!r} s, second EM {c['em2_seconds']!r} "
          f"s; EM in all {c['em_seconds']!r} s")
    n = index.num_valid_targets
    pmf = res_b.fld.pmf()
    eff0 = effective_lengths(np.asarray(index.lengths[:n]), pmf)
    stages = {
        "bias passes (expected + efflen)":
            lambda: res_b.bias.corrected_effective_lengths(res.counts, eff0,
                                                           pmf),
        f"--numBootstraps {SCALE_BOOTSTRAPS}":
            lambda: sampling.bootstrap_samples(
                res.eq_classes, n, res.eff_lens, SCALE_BOOTSTRAPS,
                use_vbem=True, vb_prior=opts.vb_prior,
                per_transcript_prior=True, device=dev_t),
        f"--numGibbsSamples {SCALE_GIBBS}":
            lambda: sampling.gibbs_samples(
                res.eq_classes, n, res.eff_lens, res.counts, SCALE_GIBBS,
                thinning=opts.thinning_factor, prior=1.0, device=dev_t),
    }
    for name, fn in stages.items():
        wall, kernels, _ = device_profile(fn)
        busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
        top = "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3!r} "
                        f"ms x{e.count}" for e in kernels[:4])
        phase("profile", f"{name}: wall {wall!r} s, device busy {busy_s!r} "
              f"s, idle share {1 - busy_s / wall!r}, "
              f"{sum(e.count for e in kernels)} kernel launches; top: {top}")


def profile_alignment(syn: str, dev_t, n_batches: int = 4) -> None:
    """Alignment mode's error model on the scale BAM: the first
    n_batches reader batches once each through prepare, log_likelihood
    and update (the -a driver's calls) under torch.profiler, with the
    time of the reads beside it."""
    import numpy as np
    from salmon_tpu_torch.alignment import quant as aq
    from salmon_tpu_torch.alignment.bamio import BamReader
    from salmon_tpu_torch.alignment.errormodel_device import \
        DeviceAlignmentErrorModel

    names, tlens, records = aq._load_targets(os.path.join(syn,
                                                          "txome.fasta"))
    shim = aq._targets_index(names, tlens, records)
    rdr = BamReader(os.path.join(syn, "aln.bam"))
    ref_map = np.arange(len(names), dtype=np.int64)
    t0 = time.perf_counter()
    batches = [b for _, b in zip(range(n_batches), rdr.batches())]
    t_read = time.perf_counter() - t0
    rdr.close()
    groups = []
    for b in batches:
        g = aq._group_fragments(b, True)
        keep = np.nonzero(g[1])[0]
        groups.append((b, g[8][keep], g[9][keep]))
    model = DeviceAlignmentErrorModel(shim.seq_codes, shim.seq_offsets,
                                      tlens, device=dev_t)
    model.prepare(*groups[0], ref_map).update(np.ones(groups[0][1].size))

    def run():
        for b, i1, i2 in groups:
            prep = model.prepare(b, i1, i2, ref_map)
            prep.log_likelihood()
            prep.update(np.full(i1.size, 0.5))
        model.normalize()

    wall, kernels, avg = device_profile(run)
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    n_rec = sum(b.n for b in batches)
    top = "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3!r} ms "
                    f"x{e.count}" for e in kernels[:6])
    phase("profile", f"-a error model, {n_batches} batches of "
          f"{n_rec // n_batches} records: read {t_read!r} s "
          f"({t_read / n_rec * 1e6!r} us a record); prepare + likelihood + "
          f"update wall {wall!r} s, device busy {busy_s!r} s, idle share "
          f"{1 - busy_s / wall!r}, {sum(e.count for e in kernels)} kernel "
          f"launches; top: {top}")


def em_inputs(out: str) -> tuple:
    """The eq classes and effective lengths of a --dumpEq run, with the
    EM's default configuration and the starting and prior alphas that
    em.optimize derives from them."""
    from salmon_tpu_torch.alignment.eqmode import read_eq_classes
    from salmon_tpu_torch.inference import em as em_mod
    names, eff, eq = read_eq_classes(
        os.path.join(out, "aux_info", "eq_classes.txt.gz"))
    cfg = em_mod.EMConfig()
    a0 = em_mod.initial_alphas(len(names), None, eq.num_fragments)
    pri = em_mod.prior_alphas(len(names), eff, cfg.vb_prior,
                              cfg.per_transcript_prior)
    return eq, eff, a0, pri, cfg


def em_sharded(world, out: str) -> dict:
    """run_em_sharded over the world on the eq classes of `out`, as
    em.optimize would run them on one device."""
    import numpy as np
    import torch
    from salmon_tpu_torch.parallel.em import run_em_sharded
    eq, eff, a0, pri, cfg = em_inputs(out)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=world.device)

    f32, i64 = torch.float32, torch.int64
    seg = np.repeat(np.arange(eq.num_classes), eq.class_sizes)
    t0 = time.perf_counter()
    alpha, iters, _ = run_em_sharded(
        world, put(eq.labels, i64), put(seg, i64), put(eq.counts, f32),
        put(eq.weights, f32), put(eq.class_sizes, i64), put(a0, f32),
        put(pri, f32), put(eff, f32), len(a0), cfg.use_vbem,
        cfg.rel_diff_tolerance, cfg.min_iterations, cfg.max_iterations,
        cfg.alpha_check_cutoff)
    alphas = alpha.cpu().numpy().astype(np.float64)
    alphas[alphas < cfg.min_alpha] = 0.0
    return {"alphas": alphas.tolist(), "iterations": iters,
            "seconds": time.perf_counter() - t0}


def rank_main(kind: str, out_json: str, args: list) -> int:
    """One rank of a multi-process job (`chip_smoke.py --rank KIND OUT
    ARGS...`, started by run_jobs): it joins the group from the launch
    variables on its GPU (cuda:{rank % GPUs visible}); 'quant' runs
    `quant ARGS` through the CLI with the launch counts set to 0 just
    before it (run_quant), 'em' runs run_em_sharded on the --dumpEq
    output ARGS[0]. Its record (device, backend, launches, seconds,
    clocks) goes to OUT."""
    sys.path.insert(0, REPO)
    from salmon_tpu_torch.parallel import distributed
    world = distributed.init_from_env()
    rec = {"rank": world.rank, "device": str(world.device),
           "backend": world.backend}
    if kind == "quant":
        launches, sec, clocks = run_quant(args)
        rec.update(launches=launches, seconds=sec, clocks=clocks)
    else:
        rec.update(em_sharded(world, args[0]))
    with open(out_json, "w") as fh:
        json.dump(rec, fh)
    return 0


def _free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def run_jobs(jobs: list, tmp: str, share_gpu: bool) -> dict:
    """Multi-process jobs, all started at once; a job is (name, ranks,
    kind, args) as rank_main takes them. share_gpu: every rank sees the
    first GPU only, so the ranks share it and their device collectives
    run over gloo; else rank p takes GPU p and NCCL. Every process is
    waited for; a rank that fails or outlives RANK_TIMEOUT fails the
    phase, with the tail of its log. Returns {name: (wall seconds,
    [rank records])}; launches are keyed by band."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    procs, start, end = [], {}, {}
    for (name, n, kind, args), port in zip(jobs, _free_ports(len(jobs))):
        start[name] = time.perf_counter()
        for pid in range(n):
            env = dict(os.environ,
                       SALMON_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       SALMON_TPU_NUM_PROCS=str(n),
                       SALMON_TPU_PROC_ID=str(pid))
            if share_gpu:
                env["CUDA_VISIBLE_DEVICES"] = visible
            out = os.path.join(tmp, f"rank_{name}_{pid}.json")
            log = os.path.join(tmp, f"rank_{name}_{pid}.log")
            with open(log, "w") as fh:
                p = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank",
                     kind, out, *args], env=env, stdout=fh,
                    stderr=subprocess.STDOUT, cwd=REPO)
            procs.append((name, pid, p, out, log))
    deadline = time.monotonic() + RANK_TIMEOUT
    failed = None
    try:
        while failed is None and any(p.poll() is None for _, _, p, _, _
                                     in procs):
            time.sleep(0.2)
            for name, pid, p, _, log in procs:
                if p.poll() not in (None, 0):
                    failed = (name, pid, f"exit code {p.returncode}", log)
            for name in start:
                if name not in end and all(
                        p.poll() is not None for n_, _, p, _, _ in procs
                        if n_ == name):
                    end[name] = time.perf_counter()
            if failed is None and time.monotonic() > deadline:
                name, pid, _, _, log = next(x for x in procs
                                            if x[2].poll() is None)
                failed = (name, pid, f"still running after {RANK_TIMEOUT} "
                          f"s", log)
        for name, pid, p, _, log in procs:
            if failed is None and p.returncode != 0:
                failed = (name, pid, f"exit code {p.returncode}", log)
    finally:
        for _, _, p, _, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is not None:
        name, pid, why, log = failed
        with open(log) as fh:
            tail = fh.read()[-4000:]
        raise AssertionError(f"{name} rank {pid}: {why}\n{tail}")
    out = {}
    for name, pid, _, rec_path, _ in procs:
        with open(rec_path) as fh:
            rec = json.load(fh)
        if "launches" in rec:
            rec["launches"] = {int(k): v for k, v in rec["launches"].items()}
        out.setdefault(name, (end.get(name, time.perf_counter())
                              - start[name], []))[1].append(rec)
    return out


def check_ranks(name: str, recs: list, backend: str,
                launches: int | None = None) -> None:
    """Every rank ran on a GPU, its device collectives over `backend`,
    and, for a quant, launched banded_dp at the main band only (each
    `launches` times, when given)."""
    for r in recs:
        assert r["device"].startswith("cuda"), (name, r["device"])
        assert r["backend"] == backend, (name, r["backend"], backend)
        if "launches" in r:
            got = r["launches"]
            assert set(got) == {MAIN_BW} and got[MAIN_BW] > 0, (name, got)
            if launches is not None:
                assert got[MAIN_BW] == launches, (name, got, launches)


def collective_clocks(recs: list) -> str:
    """The ranks' collective seconds per mapped batch (the eq allgather
    once), quantify's map_seconds (its start to the stream's end) less
    the shard build a batch, of it read_seconds (reading, parsing and
    packing the FASTQ), and the shard build's seconds: each the slowest
    rank's."""
    keys = ("hit_allgather", "stats_allreduce", "eq_allgather")
    n = recs[0]["clocks"]["mapped_batches"]
    per = max((r["clocks"]["map_seconds"]
               - r["clocks"].get("shard_build_seconds", 0.0)) / n
              for r in recs)
    read = max(r["clocks"]["read_seconds"] for r in recs) / n
    parts = [f"map_seconds {per!r} s a batch", f"read_seconds {read!r}"]
    if "shard_build_seconds" in recs[0]["clocks"]:
        build = max(r["clocks"]["shard_build_seconds"] for r in recs)
        parts[0] += " less the shard build"
        parts.append(f"shard build {build!r} s")
    for k in keys:
        vals = [r["clocks"][f"{k}_seconds"] for r in recs
                if f"{k}_seconds" in r["clocks"]]
        if vals:
            per = "" if k == "eq_allgather" else " a batch"
            v = max(vals) if k == "eq_allgather" else max(vals) / n
            parts.append(f"{k} {v!r} s{per}")
    return ", ".join(parts)


def multi_layouts() -> list:
    """(backend, share the first GPU, ranks) of the multi-process runs:
    2 ranks on one GPU over gloo, and with more GPUs the same over NCCL
    with a GPU each, and at 4 a 2 x 2 layout (2 reads groups of 2 index
    shards)."""
    import torch
    n = torch.cuda.device_count()
    return ([("gloo", True, 2)] + ([("nccl", False, 2)] if n >= 2 else [])
            + ([("nccl", False, 4)] if n >= 4 else []))


def drop_pads(flat) -> tuple:
    """The flat index's CSR without its oct-alignment pad records (and
    without the shadow-merge appendix past it): (occ_txp, occ_pf) of each
    key's stored records, back to back."""
    import numpy as np
    off, cnt = np.asarray(flat.occ_offsets), np.asarray(flat.occ_counts)
    keep = (np.repeat(off[:-1] - (np.cumsum(cnt) - cnt), cnt)
            + np.arange(int(cnt.sum())))
    return np.asarray(flat.occ_txp)[keep], np.asarray(flat.occ_pf)[keep]


def golden_partitioned_index(idx: str, tmp: str) -> str:
    """The sample transcripts (k 31) through the port's partitioned build
    at 2 partition bits, table-less (TABLE_DIRECT_MAX_KEYS 0 in this
    process), held to the flat index at `idx`: the same keys, counts and
    occurrence records once the flat CSR's pad records are dropped.
    Returns the saved index's directory."""
    import numpy as np
    from salmon_tpu_torch.index import builder

    saved = builder.TABLE_DIRECT_MAX_KEYS
    builder.TABLE_DIRECT_MAX_KEYS = 0
    try:
        t0 = time.perf_counter()
        part = builder.build_index(os.path.join(DATA, "transcripts.fasta"),
                                   k=31, partition_bits=2)
        sec = time.perf_counter() - t0
    finally:
        builder.TABLE_DIRECT_MAX_KEYS = saved
    assert part.table is None and part.info["requires_shards"]
    flat = builder.load_index(idx)
    txp, pf = drop_pads(flat)
    np.testing.assert_array_equal(part.kmers, flat.kmers)
    np.testing.assert_array_equal(part.occ_counts, flat.occ_counts)
    np.testing.assert_array_equal(part.occ_txp, txp)
    np.testing.assert_array_equal(part.occ_pf, pf)
    out = os.path.join(tmp, "g_idx_partitioned")
    builder.save_index(part, out)
    phase("golden", f"partitioned build (2 bits, table-less) in {sec:.2f} "
          f"s: {part.kmers.shape[0]} keys and {txp.shape[0]} records equal "
          f"to the flat index's without its "
          f"{int(flat.occ_offsets[-1]) - txp.shape[0]} pad records")
    return out


def golden_multi_phase(idx: str, tmp: str, gene_map: str,
                       sparse: str) -> str:
    """The sample pairs in 2 processes: --indexShards 2 (eq classes equal
    to the single-rank sparse card run `sparse`, quant.sf within the
    golden tolerance of it), the same on a table-less copy of the index,
    the same on the table-less index of the port's partitioned build
    (golden_partitioned_index; eq classes equal to the table-less copy's
    run, quant.sf within the golden tolerance of it), data-parallel
    plain and with --seqBias --gcBias (within DP_RTOL / DP_ATOL of the
    single-rank card run, every fragment processed once), and
    run_em_sharded on the dense run's eq classes against em.optimize
    (iterations equal, alphas within EM_RTOL / EM_ATOL). At 4 GPUs,
    --indexShards 2 on 4 ranks (2 x 2), held like the data-parallel
    runs. Returns the partitioned build's table-less index."""
    import dataclasses
    import numpy as np
    from salmon_tpu_torch.index.builder import load_index, save_index
    from salmon_tpu_torch.inference import em as em_mod

    reads = ["-1", os.path.join(DATA, "reads_1.fastq"),
             "-2", os.path.join(DATA, "reads_2.fastq")]
    tl = os.path.join(tmp, "g_idx_tableless")
    save_index(dataclasses.replace(load_index(idx), table=None), tl)
    ptl = golden_partitioned_index(idx, tmp)
    dense = os.path.join(tmp, "g_quant")
    bias = os.path.join(tmp, "g_bias-gc_cuda")
    run_quant(["-i", idx, "-l", "IU", *reads, "--seqBias", "--gcBias",
               "-o", bias])
    eq, eff, _, _, cfg = em_inputs(dense)
    ref = em_mod.optimize(eq, len(eff), eff, config=cfg, device="cuda")
    sharded = ["-l", "IU", *reads, "-g", gene_map, "--dumpEq",
               "--indexShards", "2"]
    for backend, share, n in multi_layouts():
        def out(name):
            return os.path.join(tmp, f"g_{name}_{backend}{n}")
        if n == 2:
            jobs = [("sharded2", 2, "quant", ["-i", idx, *sharded, "-o",
                                              out("sharded2")]),
                    ("sharded2-tableless", 2, "quant",
                     ["-i", tl, *sharded, "-o", out("sharded2-tableless")]),
                    ("sharded2-partitioned", 2, "quant",
                     ["-i", ptl, *sharded, "-o",
                      out("sharded2-partitioned")]),
                    ("dp2", 2, "quant", ["-i", idx, "-l", "IU", *reads,
                                         "-o", out("dp2")]),
                    ("dp2-bias", 2, "quant",
                     ["-i", idx, "-l", "IU", *reads, "--seqBias",
                      "--gcBias", "-o", out("dp2-bias")]),
                    ("em2", 2, "em", [dense])]
        else:
            jobs = [("sharded-2x2", 4, "quant", ["-i", idx, *sharded, "-o",
                                                 out("sharded-2x2")])]
        res = run_jobs(jobs, tmp, share)
        for name, (wall, recs) in res.items():
            check_ranks(name, recs, backend)
            if name == "em2":
                for r in recs:
                    assert r["iterations"] == ref["iterations"], \
                        (r["iterations"], ref["iterations"])
                    np.testing.assert_allclose(r["alphas"], ref["alphas"],
                                               rtol=EM_RTOL, atol=EM_ATOL)
                d = max(float(np.abs(np.array(r["alphas"])
                                     - ref["alphas"]).max()) for r in recs)
                what = (f"run_em_sharded: {ref['iterations']} iterations "
                        f"as em.optimize, alphas within {d!r} (gate rtol "
                        f"{EM_RTOL} / atol {EM_ATOL})")
            else:
                meta = json.load(open(os.path.join(
                    out(name), "aux_info", "meta_info.json")))
                assert meta["num_processed"] == 10000, meta["num_processed"]
                if name == "sharded2-partitioned":
                    want = out("sharded2-tableless")
                    assert eq_class_lines(out(name)) == \
                        eq_class_lines(want), f"{name}: eq classes differ"
                    what = (f"eq classes equal to sharded2-tableless's, "
                            f"quant.sf within rtol 5e-3 / atol 0.5 of it "
                            f"(max |diff| {sf_close(out(name), want):.4f})")
                elif name.startswith("sharded2"):
                    assert eq_class_lines(out(name)) == \
                        eq_class_lines(sparse), f"{name}: eq classes differ"
                    what = (f"eq classes equal to the sparse card run, "
                            f"quant.sf within rtol 5e-3 / atol 0.5 (max "
                            f"|diff| {sf_close(out(name), sparse):.4f})")
                else:
                    want = (bias if name == "dp2-bias" else
                            sparse if name.startswith("sharded") else dense)
                    d = sf_close(out(name), want, DP_RTOL, DP_ATOL)
                    what = (f"quant.sf within rtol {DP_RTOL} / atol "
                            f"{DP_ATOL} of the single-rank card run (max "
                            f"|diff| {d:.4f}), 10000 fragments processed "
                            f"once")
                what += (f"; banded_dp launches by rank "
                         f"{[r['launches'] for r in recs]}; "
                         f"{collective_clocks(recs)}")
            phase("golden", f"{name}, {n} ranks over {backend}: {what}; "
                  f"wall {wall:.1f} s")
    return ptl


def scale_multi_phase(syn: str, rho_sec: dict) -> dict:
    """The scale set's pairs in 2 processes: `sharded2` (--indexShards 2:
    Spearman equal to the `sparse` mode's of this call to 1e-6, gated at
    the JAX package's sparse value minus 0.01, banded_dp at every batch
    on each rank) and `dp2` (data-parallel, the paired gate, banded_dp
    at each rank's half of the batches), one job at a time; and their
    NCCL and 2 x 2 layouts where the GPUs are there. Fragments per
    second over the slowest rank's quant (index load and shard build
    included, process start not), against the single-rank modes of this
    call, and the collectives' seconds. Returns {name: (Spearman, quant
    seconds of the slowest rank, rank records)}."""
    r1, r2 = (os.path.join(syn, f"reads_{i}.fastq") for i in (1, 2))
    truth = read_truth(r1)
    n_batches = math.ceil(SCALE_PAIRS / BATCH)
    pairs = ["-i", os.path.join(syn, "idx"), "-l", "A", "-1", r1, "-2", r2]
    rho_sparse, sec_sparse = rho_sec["sparse"]
    # the paired mode once more in a fresh process, started as a rank is
    # (CUDA context, kernel loads and caches cold), to hold the ranks to
    (_, recs), = run_jobs([("paired-1", 1, "quant",
                            [*pairs, "-o", os.path.join(syn,
                                                        "quant_paired-1")])],
                          os.path.dirname(syn), True).values()
    check_ranks("paired-1", recs, "nccl", launches=n_batches)
    sec_fresh = recs[0]["seconds"]
    phase("scale", f"paired in a process of its own: quant {sec_fresh!r} s "
          f"= {SCALE_PAIRS / sec_fresh!r} frags/s; {collective_clocks(recs)}")
    done = {}
    for backend, share, n in multi_layouts():
        modes = ([("sharded2", ["--indexShards", "2"]), ("dp2", [])]
                 if n == 2 else [("sharded-2x2", ["--indexShards", "2"])])
        for mode, flags in modes:
            name = f"{mode}-{backend}"
            out = os.path.join(syn, f"quant_{name}")
            (wall, recs), = run_jobs([(name, n, "quant",
                                       [*pairs, *flags, "-o", out])],
                                     os.path.dirname(syn), share).values()
            n_groups = n // 2 if flags else n
            check_ranks(name, recs, backend,
                        launches=math.ceil(n_batches / n_groups))
            meta = json.load(open(os.path.join(out, "aux_info",
                                               "meta_info.json")))
            assert meta["num_processed"] == SCALE_PAIRS, meta
            rho = spearman(os.path.join(out, "quant.sf"), truth)
            if flags:
                gate = JAX_SPEARMAN_5K_SPARSE
                if n_groups == 1:
                    assert abs(rho - rho_sparse) <= SHARDED_RHO_EQ, \
                        (rho, rho_sparse)
            else:
                gate = JAX_SPEARMAN_5K
            assert rho >= gate - 0.01, (name, rho, gate)
            sec = max(r["seconds"] for r in recs)
            done[name] = (rho, sec, recs)
            phase("scale", f"{mode} ({n} ranks over {backend}): quant "
                  f"{sec!r} s = {SCALE_PAIRS / sec!r} frags/s (wall with "
                  f"the processes' start {wall!r} s); mapped "
                  f"{meta['percent_mapped']!r}%; banded_dp launches by "
                  f"rank {[r['launches'] for r in recs]}; "
                  f"{collective_clocks(recs)}; NumReads Spearman vs truth "
                  f"{rho!r} (sparse in this call {rho_sparse!r}; JAX "
                  f"package on the CPU: {gate}); single-rank in this call: "
                  f"paired {SCALE_PAIRS / rho_sec['paired'][1]!r} (in a "
                  f"process of its own {SCALE_PAIRS / sec_fresh!r}), sparse "
                  f"{SCALE_PAIRS / sec_sparse!r} frags/s")
    return done


def write_decoys(path: str) -> list:
    """DECOY_CHROMS random chromosomes of DECOY_CHROM_MB MiB from seed
    DECOY_SEED, appended to the FASTA at `path` (the generator of
    scripts/build_genome_scale_index.py::make_decoys). Returns their
    names."""
    import numpy as np
    rng = np.random.default_rng(DECOY_SEED)
    bases = np.frombuffer(b"ACGT", np.uint8)
    names = [f"decoy_chr{c}" for c in range(DECOY_CHROMS)]
    with open(path, "ab") as fh:
        for name in names:
            fh.write(f">{name}\n".encode())
            seq = bases[rng.integers(0, 4, DECOY_CHROM_MB * 1024 * 1024)]
            fh.write(seq.tobytes())
            fh.write(b"\n")
    return names


def build_index_main(out_json: str, fasta: str, decoy_names: str,
                     idx_dir: str) -> int:
    """`chip_smoke.py --build-index OUT FASTA DECOY_NAMES IDX`, a process
    of its own: the port's partitioned build (DECOY_PART_BITS bits) of
    FASTA with the decoys DECOY_NAMES lists, first table-less
    (TABLE_DIRECT_MAX_KEYS 0 in this process), saved to IDX, then with
    its table, saved to IDX_table. Its record goes to OUT: the
    table-less build's stage clocks, build and save seconds, the
    process's peak RSS after that build and after its save, the
    index's sizes, and the second build's seconds and table clock."""
    import resource

    sys.path.insert(0, REPO)
    from salmon_tpu_torch.index import builder

    def peak_rss():
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

    def build(table: bool):
        saved = builder.TABLE_DIRECT_MAX_KEYS
        if not table:
            builder.TABLE_DIRECT_MAX_KEYS = 0
        clocks = StageClocks()
        log.addHandler(clocks)
        try:
            t0 = time.perf_counter()
            idx = builder.build_index(fasta, k=31,
                                      decoy_names_path=decoy_names,
                                      partition_bits=DECOY_PART_BITS)
            sec = time.perf_counter() - t0
        finally:
            log.removeHandler(clocks)
            builder.TABLE_DIRECT_MAX_KEYS = saved
        return idx, sec, clocks.clocks

    log = logging.getLogger("salmon_tpu_torch")
    log.setLevel(logging.INFO)
    idx, sec, clocks = build(table=False)
    rss_build = peak_rss()
    t0 = time.perf_counter()
    builder.save_index(idx, idx_dir)
    rec = dict(clocks, build_seconds=sec,
               save_seconds=time.perf_counter() - t0,
               peak_rss_build_bytes=rss_build, peak_rss_bytes=peak_rss(),
               num_bases=int(idx.seq_offsets[-1]),
               num_kmers=int(idx.kmers.shape[0]),
               num_occurrences=int(idx.occ_txp.shape[0]),
               num_decoys=idx.num_targets - idx.first_decoy_index,
               requires_shards=bool(idx.info.get("requires_shards")))
    del idx
    idx, sec, clocks = build(table=True)
    assert idx.table is not None
    builder.save_index(idx, idx_dir + "_table")
    rec.update(table_build_seconds=sec,
               table_seconds=clocks["index_table_seconds"])
    with open(out_json, "w") as fh:
        json.dump(rec, fh)
    return 0


def scale_decoy_phase(syn: str, sharded: tuple) -> str:
    """`sharded2-decoy`: the scale set's transcripts with DECOY_CHROMS
    random decoy chromosomes last, named in a decoys file as `index -d`
    takes them, indexed by the port's partitioned build in a process of
    its own (build_index_main: table-less, with the seconds of its
    count, enumeration and CSR stages and its peak RSS; then with a
    table, whose seconds it gives). The decoys come from seed 7 as the
    set does, so they repeat stretches of the transcripts' sequence, as
    a genome holds its transcripts' exons. The 200,000 pairs then run
    single-rank with the sparse seed flow on the table-bearing index,
    and with --indexShards 2 on 2 processes sharing the card (gloo) on
    the table-less one: banded_dp at every batch on each rank, every
    pair processed, Spearman at the JAX package's sparse gate and within
    SHARDED_RHO_EQ of the sparse run's (the sharded seeding is the
    sparse flow's). Its rate, decoy fragments, shard build and hit
    all-gather are printed next to `sharded2`'s (`sharded`: its
    Spearman, seconds and rank records). Returns the table-less decoy
    index (config5_phase quantifies it shard by shard)."""
    r1, r2 = (os.path.join(syn, f"reads_{i}.fastq") for i in (1, 2))
    n_batches = math.ceil(SCALE_PAIRS / BATCH)
    truth = read_truth(r1)
    fasta = os.path.join(syn, "txome_decoys.fasta")
    names_path = os.path.join(syn, "decoys.txt")
    with open(os.path.join(syn, "txome.fasta"), "rb") as src, \
            open(fasta, "wb") as dst:
        dst.write(src.read().rstrip(b"\n") + b"\n")
    with open(names_path, "w") as fh:
        fh.write("\n".join(write_decoys(fasta)) + "\n")
    idx = os.path.join(syn, "idx_decoy")
    rec_json = os.path.join(syn, "decoy_build.json")
    # ru_maxrss keeps the peak of the process that forked across exec:
    # a small launcher starts the build, so that its peak is its own
    # (/proc/self/status has no VmHWM on the card's machine)
    launcher = ("import subprocess, sys; "
                "sys.exit(subprocess.call(sys.argv[1:]))")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", launcher, sys.executable,
                           os.path.abspath(__file__), "--build-index",
                           rec_json, fasta, names_path, idx],
                          capture_output=True, text=True,
                          timeout=RANK_TIMEOUT, cwd=REPO)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(rec_json) as fh:
        b = json.load(fh)
    assert b["requires_shards"] and b["num_decoys"] == DECOY_CHROMS, b
    phase("scale", f"sharded2-decoy index: {b['num_bases']} bases "
          f"({DECOY_CHROMS} decoys of {DECOY_CHROM_MB} MiB), "
          f"{DECOY_PART_BITS} partition bits, table-less, in a process of "
          f"its own: count {b['index_count_seconds']!r} s, enumeration "
          f"{b['index_enumerate_seconds']!r} s, CSR "
          f"{b['index_csr_seconds']!r} s, build {b['build_seconds']!r} s, "
          f"save {b['save_seconds']!r} s; peak RSS "
          f"{b['peak_rss_build_bytes']} bytes after the build, "
          f"{b['peak_rss_bytes']} after the save; {b['num_kmers']} keys, "
          f"{b['num_occurrences']} records; with its table: build "
          f"{b['table_build_seconds']!r} s, of it the table "
          f"{b['table_seconds']!r} s; the process {wall!r} s")
    out_sp = os.path.join(syn, "quant_sparse-decoy")
    launches, sec_sp, _ = run_quant(["-i", idx + "_table", "-l", "A", "-1",
                                     r1, "-2", r2, "-o", out_sp],
                                    env=SPARSE_ENV)
    assert launches == {MAIN_BW: n_batches}, launches
    rho_sp = spearman(os.path.join(out_sp, "quant.sf"), truth)
    name = "sharded2-decoy"
    out = os.path.join(syn, f"quant_{name}")
    (wall, recs), = run_jobs([(name, 2, "quant",
                               ["-i", idx, "-l", "A", "-1", r1, "-2", r2,
                                "--indexShards", "2", "-o", out])],
                             os.path.dirname(syn), True).values()
    check_ranks(name, recs, "gloo", launches=n_batches)
    with open(os.path.join(out, "aux_info", "meta_info.json")) as fh:
        meta = json.load(fh)
    assert meta["num_processed"] == SCALE_PAIRS, meta["num_processed"]
    rho = spearman(os.path.join(out, "quant.sf"), truth)
    rho_sh, sec_sh, recs_sh = sharded
    assert rho >= JAX_SPEARMAN_5K_SPARSE - 0.01, (rho, JAX_SPEARMAN_5K_SPARSE)
    assert abs(rho - rho_sp) <= SHARDED_RHO_EQ, (rho, rho_sp)
    sec = max(r["seconds"] for r in recs)
    phase("scale", f"{name} (2 ranks over gloo): quant {sec!r} s = "
          f"{SCALE_PAIRS / sec!r} frags/s (wall with the processes' start "
          f"{wall!r} s); mapped {meta['percent_mapped']!r}%; "
          f"num_decoy_fragments {meta['num_decoy_fragments']}; banded_dp "
          f"launches by rank {[r['launches'] for r in recs]}; "
          f"{collective_clocks(recs)}; NumReads Spearman vs truth {rho!r} "
          f"(single-rank sparse on the decoy index in this call "
          f"{rho_sp!r} at {SCALE_PAIRS / sec_sp!r} frags/s; sharded2 "
          f"{rho_sh!r}, so the decoys move it by {rho - rho_sh!r}; gate "
          f"{JAX_SPEARMAN_5K_SPARSE} - 0.01); sharded2 in this call: "
          f"{SCALE_PAIRS / sec_sh!r} frags/s, {collective_clocks(recs_sh)}")
    return idx


def config5_phase(decoy_idx: str, syn: str, golden_idx: str) -> dict:
    """BASELINE config 5 shard by shard on the one card
    (salmon_tpu_torch.scripts.demo_config5_quant.quantify, the port's
    counterpart of scripts/demo_config5_quant.py): the table-less decoy
    index of `sharded2-decoy` at each of CONFIG5_SHARDS shards over all
    200,000 pairs, R = 16,384 a batch. Each run: every pair a fragment,
    banded_dp once a batch (in phase B2, counted from 0 just before the
    run), mapped fraction >= CONFIG5_MIN_MAPPED, the NumReads (alphas)
    Spearman against the truth over the transcripts at the JAX
    package's sparse gate minus 0.01 (the run scores with the uniform
    FLD, so it is not held to `sharded2-decoy`). Then the sample pairs
    at 2 shards on the golden partitioned build's table-less index,
    `golden_idx`, on the card against the port's CPU run of the module:
    eq classes (labels and counts) equal, alphas within rtol 5e-3 /
    atol 0.5. Returns the config5 line's record: each run's JSON, the
    device bytes of each shard's planes, the seconds of load, B1, B2
    and the EM, launches and Spearman."""
    import numpy as np
    from scipy.stats import spearmanr
    from salmon_tpu_torch.mapping.align import BANDED_DP
    from salmon_tpu_torch.scripts import demo_config5_quant as demo

    r1, r2 = (os.path.join(syn, f"reads_{i}.fastq") for i in (1, 2))
    truth = read_truth(r1)
    with open(os.path.join(decoy_idx, "ref_names.txt")) as fh:
        names = [ln.rstrip("\n") for ln in fh]
    with open(os.path.join(decoy_idx, "info.json")) as fh:
        n_txps = json.load(fh)["first_decoy_index"]
    want = np.array([truth.get(n, 0) for n in names[:n_txps]])
    n_batches = math.ceil(SCALE_PAIRS / demo.R)
    runs = []
    for n_shards in CONFIG5_SHARDS:
        BANDED_DP.reset()
        t0 = time.perf_counter()
        run = demo.quantify(decoy_idx, r1, r2, n_shards, SCALE_PAIRS,
                            "cuda")
        wall = time.perf_counter() - t0
        launches = dict(BANDED_DP.by_shape)
        rep = run.report
        assert rep["n_frags"] == SCALE_PAIRS, rep
        assert launches == {MAIN_BW: n_batches}, launches
        assert rep["mapped_frac"] >= CONFIG5_MIN_MAPPED, rep
        assert np.isfinite(run.alphas).all()
        assert run.alphas.shape == (len(names),)
        rho = float(spearmanr(run.alphas[:n_txps], want).statistic)
        assert rho >= JAX_SPEARMAN_5K_SPARSE - 0.01, (rho, n_shards)
        runs.append({"report": rep, "seconds": run.seconds,
                     "wall_seconds": wall, "shard_bytes": run.shard_bytes,
                     "banded_dp_launches": launches[MAIN_BW],
                     "spearman": rho})
        phase("config5", f"{n_shards} shards, shard by shard on the card: "
              f"{json.dumps(rep)}; load {run.seconds['load_s']!r} s, B1 "
              f"{run.seconds['b1_s']!r} s, B2 {run.seconds['b2_s']!r} s, "
              f"EM {run.seconds['em_s']!r} s ({wall!r} s in all); shard "
              f"planes {run.shard_bytes} bytes; banded_dp {launches} over "
              f"{n_batches} batches; NumReads Spearman vs truth {rho!r} "
              f"(gate {JAX_SPEARMAN_5K_SPARSE} - 0.01)")

    reads = [os.path.join(DATA, f"reads_{i}.fastq") for i in (1, 2)]
    card = demo.quantify(golden_idx, *reads, 2, 20_000, "cuda")
    cpu = demo.quantify(golden_idx, *reads, 2, 20_000, "cpu")
    for f in ("labels", "offsets", "counts"):
        _equal(getattr(card.eq, f), getattr(cpu.eq, f), f"config5 eq {f}")
    if not np.allclose(card.alphas, cpu.alphas, rtol=5e-3, atol=0.5):
        raise AssertionError("config5 golden alphas beyond rtol 5e-3 / "
                             "atol 0.5 of the CPU run")
    phase("config5", f"golden, 2 shards, sample pairs: "
          f"{card.report['n_frags']} fragments, {card.eq.num_classes} eq "
          f"classes (labels and counts) equal to the port's CPU run, "
          f"alphas within rtol 5e-3 / atol 0.5 (max |diff| "
          f"{np.abs(card.alphas - cpu.alphas).max()!r}), EM iterations "
          f"{card.report['em_iters']} and {cpu.report['em_iters']}")
    return {"runs": runs,
            "golden": {"n_frags": card.report["n_frags"],
                       "eq_classes": card.eq.num_classes,
                       "em_iters": card.report["em_iters"]}}


def _quant_window(argv: list, out_json: str) -> dict:
    """salmon_tpu_torch.scripts.quant_window with `argv`: its record."""
    from salmon_tpu_torch.scripts import quant_window
    assert quant_window.main(["--json-out", out_json, *argv]) == 0
    with open(out_json) as fh:
        return json.load(fh)


def harness_phase(syn: str) -> dict:
    """The port's throughput harnesses on phase 5's set and index (built
    by scale_phase), each with its default command on the card:
    quant_window for QW_SECONDS with --progressUpdateMs 0 (exit 0, not
    timed out, every pair counted, as meta_info.json counts them), then
    cut short (timed out, some but not all pairs counted), its window
    half the first run's elapsed seconds, then bisected between 0 and
    those seconds, at most QW_CUT_TRIES runs (half can end inside the
    process's start-up);
    bench_multihost at 1 and 2 processes, a GPU a rank (its --procs 1,2
    --devices-per-proc 0: 2 processes share the card; every pair a
    fragment at each count, the report's keys; efficiency_vs_1
    recorded, not gated); and
    bench_alignment_mode's BAM at ABENCH_REPS (both rates positive,
    quant.sf's NumReads summing to the fragments within
    ABENCH_SUM_RTOL). Returns the harness line's record."""
    from salmon_tpu_torch.scripts import bench_alignment_mode, bench_multihost

    idx = os.path.join(syn, "idx")
    r1, r2 = (os.path.join(syn, f"reads_{i}.fastq") for i in (1, 2))
    pairs = ["--index", idx, "-1", r1, "-2", r2]
    out = os.path.join(syn, "qw_full")
    t0 = time.perf_counter()
    full = _quant_window([*pairs, "--seconds", str(QW_SECONDS), "--out-dir",
                          out, "--", "--progressUpdateMs", "0"],
                         os.path.join(syn, "qw_full.json"))
    full_sec = time.perf_counter() - t0
    with open(os.path.join(out, "aux_info", "meta_info.json")) as fh:
        num_processed = json.load(fh)["num_processed"]
    assert full["exit_code"] == 0 and not full["timed_out"], full
    assert full["processed_fragments"] == SCALE_PAIRS == num_processed, \
        (full, num_processed)
    # the cut run: half the first run's elapsed seconds, as the harness's
    # own check takes it; but on the card most of a run is start-up,
    # which varies by seconds from one run to the next, and the loop
    # lasts ~3 s, so the window is bisected between 0 and the first
    # run's elapsed seconds until a run is cut inside its loop
    lo, hi = 0.0, full["elapsed_seconds"]
    window = hi / 2
    tries = []
    t0 = time.perf_counter()
    for i in range(QW_CUT_TRIES):
        cut = _quant_window([*pairs, "--seconds", f"{window:.3f}",
                             "--out-dir", os.path.join(syn, f"qw_cut{i}"),
                             "--", "--progressUpdateMs", "0"],
                            os.path.join(syn, f"qw_cut{i}.json"))
        n = cut["processed_fragments"]
        tries.append({"seconds": window, "processed_fragments": n,
                      "timed_out": cut["timed_out"]})
        if cut["timed_out"] and 0 < n < SCALE_PAIRS:
            break
        lo, hi = (window, hi) if n == 0 else (lo, window)
        window = (lo + hi) / 2
    cut_sec = time.perf_counter() - t0
    assert cut["timed_out"], tries
    assert 0 < cut["processed_fragments"] < SCALE_PAIRS, tries
    phase("harness", f"quant_window {QW_SECONDS} s: "
          f"{full['processed_fragments']} fragments in "
          f"{full['elapsed_seconds']!r} s = "
          f"{full['fragments_per_second']!r} frags/s, exit 0; cut: "
          f"timed out at {cut['processed_fragments']} fragments = "
          f"{cut['fragments_per_second']!r} frags/s; windows tried "
          f"{json.dumps(tries)}")

    t0 = time.perf_counter()
    results = bench_multihost.measure([1, 2], 0, idx, r1, r2,
                                      tempfile.mkdtemp(dir=syn, prefix="mh_"))
    mh_sec = time.perf_counter() - t0
    report = bench_multihost.report(results, 0)
    frags = {r["procs"]: r["frags"] for r in results}
    assert set(report) == {"metric", "devices_per_proc", "virtual_cpu_mesh",
                           "procs", "frags_per_s", "wall_s",
                           "efficiency_vs_1", "note", "rank_clocks"}, report
    assert report["procs"] == [1, 2] and not report["virtual_cpu_mesh"]
    assert frags == {1: SCALE_PAIRS, 2: SCALE_PAIRS}, frags
    for n, clocks in zip(report["procs"], report["rank_clocks"]):
        for k in ("index_load_seconds", "read_seconds", "map_seconds",
                  "em_seconds") + (("eq_allgather_seconds",) if n > 1
                                   else ()):
            assert len(clocks.get(k, ())) == n, (n, k, clocks)
    phase("harness", f"bench_multihost, 1 and 2 processes on the one "
          f"card: {json.dumps(report)} (efficiency recorded, not gated: "
          f"the processes share a card)")

    t0 = time.perf_counter()
    abench = bench_alignment_mode.bench(
        ABENCH_REPS, tempfile.mkdtemp(dir=syn, prefix="abench_"), "cuda")
    ab_sec = time.perf_counter() - t0
    line = {"metric": "alignment-mode frags/s", "value": abench["value"],
            "reader_rec_per_s": abench["reader_rec_per_s"]}
    assert abench["value"] > 0 and abench["reader_rec_per_s"] > 0, line
    with open(os.path.join(abench["out"], "quant.sf")) as fh:
        n_reads = sum(r[2] for r in _parse_sf(fh.readlines()).values())
    n = abench["n_frags"]
    assert abs(n_reads - n) <= ABENCH_SUM_RTOL * n, (n_reads, n)
    phase("harness", f"bench_alignment_mode {ABENCH_REPS}: {n} fragments, "
          f"{abench['n_records']} records: {json.dumps(line)}; quant.sf "
          f"NumReads sum {n_reads!r}")
    return {"quant_window": {"full": full, "full_seconds": full_sec,
                             "cut": cut, "cut_tries": tries,
                             "cut_seconds": cut_sec},
            "bench_multihost": {"report": report, "frags": frags,
                                "seconds": mh_sec},
            "bench_alignment_mode": {"line": line, "n_frags": n,
                                     "numreads_sum": n_reads,
                                     "seconds": ab_sec}}


def mixed_sim(d: str) -> dict:
    """tests/test_accuracy_gate.py's mixed simulation (seed 123,
    MIXED_PAIRS pairs of 100 bases): 280 unique transcripts and 10
    two-isoform families with a shared 5' block, written byte for byte
    as that fixture writes them (tests/test_torch_accuracy_gate.py holds
    it so) into d; the files' paths, the truth counts and the names."""
    import numpy as np
    from salmon_tpu_torch.utils.dna import decode_seq, revcomp_codes

    read_len, err = 100, 0.005
    rng = np.random.default_rng(123)
    seqs = []
    for _ in range(280):
        seqs.append(rng.integers(
            0, 4, int(rng.integers(500, 3000))).astype(np.uint8))
    for _ in range(10):
        shared = rng.integers(
            0, 4, int(rng.integers(400, 900))).astype(np.uint8)
        for _i in range(2):
            uniq = rng.integers(
                0, 4, int(rng.integers(500, 900))).astype(np.uint8)
            seqs.append(np.concatenate([shared, uniq]))
    names = [f"TX{i:04d}" for i in range(len(seqs))]
    fa = os.path.join(d, "t.fa")
    with open(fa, "w") as fh:
        for nm, s in zip(names, seqs):
            fh.write(f">{nm}\n{decode_seq(s)}\n")
    expr = rng.gamma(0.5, 1.0, len(seqs))
    expr[rng.random(len(seqs)) < 0.15] = 0.0
    lens = np.array([s.shape[0] for s in seqs], float)
    w = expr * np.maximum(lens - 250, 1)
    p = w / w.sum()
    truth = np.zeros(len(seqs))
    r1p, r2p = os.path.join(d, "r1.fq"), os.path.join(d, "r2.fq")
    with open(r1p, "w") as f1, open(r2p, "w") as f2:
        for i in range(MIXED_PAIRS):
            t = int(rng.choice(len(seqs), p=p))
            L = seqs[t].shape[0]
            fl = int(np.clip(rng.normal(250, 25), 2 * read_len, L))
            fl = min(fl, L)
            s0 = int(rng.integers(0, L - fl + 1))
            truth[t] += 1
            left = seqs[t][s0:s0 + read_len].copy()
            right = revcomp_codes(
                seqs[t][s0 + fl - read_len:s0 + fl]).copy()
            for r in (left, right):
                m = rng.random(read_len) < err
                r[m] = (r[m] + rng.integers(1, 4, m.sum())) % 4
            f1.write(f"@s{i}\n{decode_seq(left)}\n+\n{'I' * read_len}\n")
            f2.write(f"@s{i}\n{decode_seq(right)}\n+\n"
                     f"{'I' * read_len}\n")
    return {"fa": fa, "r1": r1p, "r2": r2p, "truth": truth, "names": names}


def mixed_metrics(sim: dict, res) -> dict:
    """The mixed gate's metrics of a quant result (the port's
    QuantResult) against the simulation's truth: mapping rate, TPM
    Spearman (truth TPM from the truth counts over the run's effective
    lengths), counts Spearman, and the median relative count error of
    the isoform families' members with >= 30 true fragments."""
    import numpy as np
    from scipy.stats import spearmanr

    names, truth = sim["names"], sim["truth"]
    est = dict(zip(res.names, res.counts))
    e = np.array([est.get(nm, 0.0) for nm in names])
    eff = dict(zip(res.names, res.eff_lens))
    el = np.array([max(eff.get(nm, 1.0), 1.0) for nm in names])
    t_tpm = truth / el
    t_tpm = t_tpm / t_tpm.sum() * 1e6
    tpm = dict(zip(res.names, res.tpm))
    e_tpm = np.array([tpm.get(nm, 0.0) for nm in names])
    fam = np.arange(280, 300)
    ft, fe = truth[fam], e[fam]
    good = ft >= 30
    return {"mapping_rate": res.num_mapped / res.num_processed,
            "tpm_spearman": float(spearmanr(t_tpm, e_tpm).statistic),
            "counts_spearman": float(spearmanr(truth, e).statistic),
            "family_median_relerr": float(np.median(
                np.abs(fe[good] - ft[good]) / ft[good]))}


def _err_close(got: float, want: float) -> bool:
    return abs(got - want) <= max(SIM_ERR_RTOL * abs(want), SIM_ERR_ATOL)


def sims_phase(tmp: str) -> dict:
    """Every truth simulation at its script's default size, on the card,
    with the banded_dp launches of each counted from 0 just before it:
    the mixed simulation and the paralog simulation (at the defaults)
    held to the accuracy gates' pins; sim_seqbias, sim_gcbias and
    sim_posbias, each error within SIM_ERR_RTOL (or SIM_ERR_ATOL) of the
    JAX package's CPU value and each gain of its sign; sim_rescue_recall,
    each recall within RECALL_SLACK of the JAX package's, band 80 once a
    run. Returns the sims line's record: each metric beside its gate or
    JAX value, launches and seconds."""
    import numpy as np
    from salmon_tpu_torch.index.builder import build_index
    from salmon_tpu_torch.mapping.align import BANDED_DP
    from salmon_tpu_torch.quant import quantify
    from salmon_tpu_torch.scripts import (sim_gcbias, sim_paralog_gate,
                                          sim_posbias, sim_rescue_recall,
                                          sim_seqbias)

    rec = {}

    def run(name, fn):
        d = os.path.join(tmp, f"sim_{name}")
        os.makedirs(d)
        BANDED_DP.reset()
        t0 = time.perf_counter()
        out = fn(d)
        rec[name] = {"seconds": time.perf_counter() - t0,
                     "banded_dp_launches": dict(BANDED_DP.by_shape)}
        return out

    def mixed(d):
        sim = mixed_sim(d)
        res = quantify(build_index(sim["fa"], k=31), "IU", [sim["r1"]],
                       [sim["r2"]], progress=False, device="cuda")
        return mixed_metrics(sim, res), res.num_batches

    m, n_batches = run("mixed", mixed)
    for k, lo in MIXED_MIN.items():
        assert m[k] >= lo, (k, m)
    assert m["family_median_relerr"] <= MIXED_FAMILY_MEDIAN_RELERR, m
    assert rec["mixed"]["banded_dp_launches"] == {MAIN_BW: n_batches}, rec
    rec["mixed"].update({"metrics": m, "min": MIXED_MIN, "max": {
        "family_median_relerr": MIXED_FAMILY_MEDIAN_RELERR}})
    phase("sims", f"mixed ({MIXED_PAIRS} pairs): {json.dumps(m)} (gates "
          f"{json.dumps(MIXED_MIN)}, family median rel err <= "
          f"{MIXED_FAMILY_MEDIAN_RELERR}); banded_dp "
          f"{rec['mixed']['banded_dp_launches']}")

    def paralog(d):
        sim = sim_paralog_gate.build_sim(d)
        m, res = sim_paralog_gate.run_setting(build_index(sim["fa"], k=31),
                                              sim, 8, 16, "cuda")
        return m, res.num_batches

    m, n_batches = run("paralog", paralog)
    got = {"mapping_rate": m["mapping_rate"],
           "spearman_all": m["spearman_all"],
           "fam0_spearman": m["fam_member_spearman"][0],
           "fam_total_relerr_max": m["fam_total_relerr_max"],
           "rep_relerr_max": m["rep_relerr_max"]}
    for k, lo in PARALOG_MIN.items():
        assert got[k] >= lo, (k, m)
    for k, hi in PARALOG_MAX.items():
        assert got[k] <= hi, (k, m)
    assert rec["paralog"]["banded_dp_launches"] == {MAIN_BW: n_batches}, rec
    rec["paralog"].update({"metrics": m, "min": PARALOG_MIN,
                           "max": PARALOG_MAX})
    phase("sims", f"paralog gate (occ_cap 8, weight_width 16, "
          f"{sim_paralog_gate.N_PAIRS} pairs): {json.dumps(got)}; member "
          f"Spearman by family {m['fam_member_spearman']} (gates "
          f"{json.dumps(PARALOG_MIN)} at least, {json.dumps(PARALOG_MAX)} "
          f"at most); banded_dp {rec['paralog']['banded_dp_launches']}")

    for name, mod, n_txps, n_frags, want in (
            ("seqbias", sim_seqbias, 48, 80000, JAX_SEQBIAS_ERR),
            ("gcbias", sim_gcbias, 48, 60000, JAX_GCBIAS_ERR),
            ("posbias", sim_posbias, 24, 20000, JAX_POSBIAS_ERR)):
        errs = run(name, lambda d: mod.errors(d, n_txps, n_frags, "cuda"))
        gains = [sim_seqbias.gain(errs[0], e) for e in errs[1:]]
        want_gains = [sim_seqbias.gain(want[0], e) for e in want[1:]]
        for got_e, want_e in zip(errs, want):
            assert np.isfinite(got_e) and _err_close(got_e, want_e), \
                (name, errs, want)
        for g, w in zip(gains, want_gains):
            assert np.sign(g) == np.sign(w), (name, gains, want_gains)
        rec[name].update({"errors": errs, "gains_percent": gains,
                          "jax_errors": list(want),
                          "jax_gains_percent": want_gains})
        phase("sims", f"sim_{name} ({n_txps} txps, {n_frags} fragments): "
              f"mean |log TPM err| {errs} (JAX package on the CPU "
              f"{list(want)}), gains {gains} % (JAX {want_gains} %); "
              f"banded_dp {rec[name]['banded_dp_launches']}")

    recalls = run("rescue_recall", lambda d: sim_rescue_recall.recalls(
        "cuda"))
    n_runs = len(sim_rescue_recall.SIGMAS) * (len(sim_rescue_recall.PROBES)
                                              + sim_rescue_recall.N)
    for key, (r, n) in recalls.items():
        assert n == sim_rescue_recall.N, (key, n)
        assert abs(r - JAX_RESCUE_RECALL[key]) <= RECALL_SLACK, \
            (key, r, JAX_RESCUE_RECALL[key])
    launches = rec["rescue_recall"]["banded_dp_launches"]
    assert launches == {MAIN_BW: n_runs, RESCUE_BW: n_runs}, launches
    rec["rescue_recall"]["recall"] = [
        {"sigma": s, "probes": q, "rescued": r, "of": n,
         "jax": JAX_RESCUE_RECALL[s, q]} for (s, q), (r, n) in
        recalls.items()]
    phase("sims", f"sim_rescue_recall: " + "; ".join(
        f"sigma {s:g} probes {q}: {r}/{n} (JAX {JAX_RESCUE_RECALL[s, q]})"
        for (s, q), (r, n) in recalls.items())
        + f"; banded_dp {launches} over {n_runs} map_paired_batch calls")
    return rec


def multi_main() -> None:
    """--multi: the multi-process phases alone, with the single-rank runs
    they are held to (the golden dense and sparse runs, the scale set's
    paired and sparse modes), for a machine with several GPUs."""
    with tempfile.TemporaryDirectory() as tmp:
        idx = golden_phase(tmp)
        gene_map = sample_gene_map(tmp)
        sparse = os.path.join(tmp, "g_sparse_cuda")
        run_quant(["-i", idx, "-l", "IU", "-1",
                   os.path.join(DATA, "reads_1.fastq"), "-2",
                   os.path.join(DATA, "reads_2.fastq"), "-g", gene_map,
                   "--dumpEq", "-o", sparse], env=SPARSE_ENV)
        golden_multi_phase(idx, tmp, gene_map, sparse)
        syn = make_scale_set(tmp)
        _, rho_sec = scale_phase(syn, only=("paired", "sparse"))
        scale_multi_phase(syn, rho_sec)


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        return rank_main(sys.argv[2], sys.argv[3], sys.argv[4:])
    if sys.argv[1:2] == ["--build-index"]:
        return build_index_main(*sys.argv[2:6])
    smi = device_phase()
    sys.path.insert(0, REPO)
    import torch
    build_phase()
    if "--multi" in sys.argv[1:]:
        multi_main()
        print(f"nvidia-smi: {smi}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    records = kernel_phase()
    with tempfile.TemporaryDirectory() as tmp:
        bench_rec = bench_phase(tmp)
        syn = make_scale_set(tmp)
        host, bam = host_native_phase(syn)
        idx = golden_phase(tmp)
        golden_single_phase(idx, tmp)
        golden_rescue_phase(idx, tmp)
        golden_bias_sampling_phase(idx, tmp)
        golden_alignment_phase(tmp)
        gene_map = sample_gene_map(tmp)
        seed_runs = golden_seed_modes_phase(idx, tmp, gene_map)
        side = golden_side_outputs_phase(idx, tmp, gene_map)
        golden_quantmerge_phase(
            tmp, *([seed_runs["sparse"][d], seed_runs["rowpool-64"][d],
                    side[d]] for d in (None, "cpu")))
        ptl = golden_multi_phase(idx, tmp, gene_map,
                                 seed_runs["sparse"][None])
        runs, rho_sec = scale_phase(syn, bam=bam)
        multi = scale_multi_phase(syn, rho_sec)
        decoy_idx = scale_decoy_phase(syn, multi["sharded2-gloo"])
        config5 = config5_phase(decoy_idx, syn, ptl)
        harness = harness_phase(syn)
        sims = sims_phase(tmp)
        records[MAIN_BW]["launches"] = runs["paired"][MAIN_BW]
        records[RESCUE_BW]["launches"] = runs["recoverOrphans"][RESCUE_BW]
        if "--profile" in sys.argv[1:]:
            profile_phase(syn)
    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"]
    print(json.dumps({"kernels": [{k: rec[k] for k in order}
                                  for rec in records.values()]}))
    print(json.dumps({"host_native": host}))
    print(json.dumps({"bench": bench_rec}))
    print(json.dumps({"config5": config5}))
    print(json.dumps({"harness": harness}))
    print(json.dumps({"sims": sims}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
