"""BASELINE config 5 on one GPU: a genome-decoy index quantified shard by
shard.

Counterpart of scripts/demo_config5_quant.py. The saved table-less v5
index is loaded as N k-mer shards by the streamed loader
(index.shard.iter_shard_arrays), and one card plays each position of the
sharded design in turn, so it quantifies an index past its memory:

  A  the streamed load: each shard's table and occurrence planes (the
     occurrences padded to oct rows), held on the host;
  B1 per shard: its planes on the card, every batch's budgeted hit list
     collected against them (collect_hits_sparse behind the owner mask,
     the per-rank program of parallel.sharded), the hits back to the
     host;
  B2 per batch: the shards' hits concatenated in shard order, the budget
     applied again (rebudget_hits), ranked, and the join / DP / filter /
     weight pipeline (map_paired_from_cands) run against the 2-bit
     genome plane: one banded-DP launch a batch;
  EM the eq classes' VBEM with the routed engine's chunked stopping rule.

Both passes score with the uniform pre-burn-in FLD and library IU (the
online FLD needs batches finished in order). Prints one JSON line with
the counterpart's twelve keys.

Usage: python -m salmon_tpu_torch.scripts.demo_config5_quant
       [n_shards] [max_frags]
Env: BENCH_CACHE (genome_idx and reads), CONFIG5_IDX, CONFIG5_R1,
CONFIG5_R2.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from salmon_tpu_torch.scripts import cache_dir, require_device

R = 16384
# the VBEM of the counterpart: per-transcript prior, tolerance, limits
EM_PRIOR, EM_TOL, EM_MIN_ITER, EM_MAX_ITER = 1e-2, 1e-8, 50, 1000


def log(m):
    print(m, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Config5Run:
    """A run's JSON report, its eq classes and alphas, the seconds of
    each phase and the device bytes of each shard's planes."""
    report: dict
    eq: object
    alphas: np.ndarray
    seconds: dict
    shard_bytes: list


def read_batches(r1, r2, R, max_frags):
    """Padded paired chunks of R rows until max_frags fragments."""
    from salmon_tpu_torch.io.fastq import iter_paired_chunks
    n = 0
    for chunk in iter_paired_chunks([r1], [r2], R, 256):
        yield chunk
        n += int((chunk.left.lengths > 0).sum())
        if n >= max_frags:
            return


def load_shards(idx_dir: str, n_shards: int):
    """Phase A: (shards, info.json dict). Each shard is its bucket rows
    and its occurrence records as (n_oct, 16) int32 oct rows."""
    from salmon_tpu_torch.index.shard import iter_shard_arrays
    t0 = time.time()
    shards = []
    meta = None
    for s, meta, sh in iter_shard_arrays(idx_dir, n_shards):
        n_oct = -(-sh["occ_txp"].shape[0] // 8)
        occ = np.zeros((n_oct * 8, 2), np.int32)
        occ[:sh["occ_txp"].shape[0], 0] = sh["occ_txp"]
        occ[:sh["occ_pf"].shape[0], 1] = sh["occ_pf"]
        shards.append({"tab_rows": sh["tab_rows"],
                       "occ_oct": occ.reshape(n_oct, 16),
                       "n_slots": sh["n_slots"],
                       "shard_bits": sh["shard_bits"]})
        log(f"#   shard {s}: {sh['n_keys'] / 1e6:.0f}M keys, "
            f"{sh['occ_txp'].shape[0] / 1e6:.0f}M occs, "
            f"table {sh['tab_rows'].nbytes / 2**30:.1f} GiB, "
            f"evicted {sh['n_evicted']} "
            f"({time.time() - t0:.0f}s)")
    return shards, meta


def _put(a, device, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _batch_tensors(chunk, device) -> dict:
    return {"codes_l": _put(chunk.left.codes, device),
            "lengths_l": _put(chunk.left.lengths, device),
            "codes_r": _put(chunk.right.codes, device),
            "lengths_r": _put(chunk.right.lengths, device)}


def run_vbem(eq, lengths: np.ndarray, device="cuda") -> tuple:
    """The counterpart's VBEM (fastem.optimize_routed) on `device`:
    effective lengths max(length - 200, 10), uniform initial alphas, a
    per-transcript prior of EM_PRIOR, tolerance EM_TOL within EM_MIN_ITER
    to EM_MAX_ITER iterations, tested after each chunk of EM_CHUNK at
    every size. Returns (alphas float64, iterations)."""
    from salmon_tpu_torch.inference import em as em_mod
    num_txps = int(lengths.shape[0])
    eff = np.maximum(lengths.astype(np.float64) - 200.0, 10.0)
    a0 = em_mod.initial_alphas(num_txps, None, eq.num_fragments)
    pri = em_mod.prior_alphas(num_txps, eff, EM_PRIOR, True)
    seg = np.repeat(np.arange(eq.num_classes), eq.class_sizes)
    f32, i64 = torch.float32, torch.int64
    alpha, iters, _, _, _ = em_mod.run_em(
        _put(eq.labels, device, i64), _put(seg, device, i64),
        _put(eq.counts, device, f32), _put(eq.weights, device, f32),
        _put(eq.class_sizes, device, i64), _put(a0, device, f32),
        _put(pri, device, f32), _put(eff, device, f32), num_txps, True,
        EM_TOL, EM_MIN_ITER, EM_MAX_ITER, alpha_cutoff=1e-2, chunked=True)
    return alpha.cpu().numpy().astype(np.float64), iters


def quantify(idx_dir: str, r1: str, r2: str, n_shards: int,
             max_frags: int, device="cuda") -> Config5Run:
    """Phases A, B1, B2 and the EM on `device`."""
    from salmon_tpu_torch.constants import SalmonDefaults
    from salmon_tpu_torch.index import diskfmt
    from salmon_tpu_torch.inference.eqclasses import \
        EquivalenceClassAccumulator
    from salmon_tpu_torch.mapping.align import pack_seq4
    from salmon_tpu_torch.mapping.pipeline import (MapperConfig, _SEQ4_SHIFT,
                                                   map_paired_from_cands)
    from salmon_tpu_torch.mapping.score import (candidate_read_start,
                                                diag_bucket_bits_for,
                                                window_bits_for)
    from salmon_tpu_torch.mapping.seed_sparse import (collect_hits_sparse,
                                                      rank_hits,
                                                      rebudget_hits)
    from salmon_tpu_torch.models.fld import FragmentLengthDistribution
    from salmon_tpu_torch.parallel.sharded import _local_seeds
    from salmon_tpu_torch.utils import libformat

    device = torch.device(device)
    opts = SalmonDefaults()

    # ---- phase A: streamed sharded load --------------------------------
    t0 = time.time()
    shards, meta = load_shards(idx_dir, n_shards)
    load_s = time.time() - t0
    shard_bits = shards[0]["shard_bits"]
    n_slots = shards[0]["n_slots"]
    shard_bytes = [sh["tab_rows"].nbytes + sh["occ_oct"].nbytes
                   for sh in shards]
    hbm_per_shard = (shards[0]["tab_rows"].nbytes
                     + max(sh["occ_oct"].nbytes for sh in shards))
    log(f"# load: {load_s / 60:.1f} min; per-shard device memory "
        f"{hbm_per_shard / 2**30:.2f} GiB")

    lengths = np.load(os.path.join(idx_dir, "lengths.npy"))
    seq_off = np.load(os.path.join(idx_dir, "seq_offsets.npy"))
    num_txps = int(lengths.shape[0])
    cfg = MapperConfig(
        k=int(meta["k"]), n_slots=n_slots, max_probes=8,
        first_decoy_index=int(meta["first_decoy_index"]),
        num_txps=num_txps, max_tpos=int(lengths.max()),
        occ_cap=min(opts.occ_cap, int(meta.get("max_occs_kept") or 8)),
        sparse_seed=True)

    # ---- phase B1: per-shard hit collection ---------------------------
    P = (opts.max_read_len - cfg.k) // cfg.kmer_stride + 1
    dbb = diag_bucket_bits_for(cfg.max_tpos, window_bits_for(P))

    def shard_hits(batch, dev_s, sid):
        seeded = [_local_seeds(batch[f"codes_{e}"], batch[f"lengths_{e}"],
                               dev_s, cfg, shard_bits, sid)
                  for e in ("l", "r")]
        return collect_hits_sparse(
            seeded, dev_s["occ_oct"], occ_cap=cfg.occ_cap,
            max_occs_per_hit=cfg.max_occs_per_hit,
            hits_per_end=cfg.seed_hits_per_end, stride=cfg.kmer_stride,
            diag_bucket_bits=dbb)

    batches = list(read_batches(r1, r2, R, max_frags))
    n_frags = sum(int((b.left.lengths > 0).sum()) for b in batches)
    log(f"# {len(batches)} batches, {n_frags} fragments")

    t0 = time.time()
    # hits on the host as u32 (rid, key, key2) and i32 (diag) planes
    hits_host = [[None] * n_shards for _ in batches]
    for s, sh in enumerate(shards):
        dev_s = {"tab_rows": _put(sh["tab_rows"], device),
                 "occ_oct": _put(sh["occ_oct"], device)}
        for bi, b in enumerate(batches):
            h = shard_hits(_batch_tensors(b, device), dev_s, s)
            hits_host[bi][s] = tuple(
                x.cpu().numpy().astype(np.uint32 if i < 3 else np.int32)
                for i, x in enumerate(h))
        del dev_s
        log(f"#   shard {s} hits pass done ({time.time() - t0:.0f}s)")
    t_pass1 = time.time() - t0

    # ---- phase B2: merge + rank + full pipeline -----------------------
    seq_codes = diskfmt.unpack_seq2(
        {"seq2": np.load(os.path.join(idx_dir, "seq2.npy"),
                         mmap_mode="r"),
         "seq2_n": np.load(os.path.join(idx_dir, "seq2_n.npy")),
         "seq2_len": np.load(os.path.join(idx_dir, "seq2_len.npy"))})
    words, _ = pack_seq4(seq_codes, lead_pad=_SEQ4_SHIFT)
    del seq_codes
    dev2 = {"txp_lens": _put(lengths.astype(np.int32), device),
            "seq_off": _put(seq_off.astype(np.int64), device),
            "seq4": _put(words.view(np.int32), device)}
    del words
    fmt = libformat.parse_library_format("IU")
    cp = _put(libformat.paired_compat_table(fmt), device)
    co = _put(libformat.orphan_compat_table(fmt), device)
    fld = FragmentLengthDistribution(opts.max_frag_length)
    fld_in = {"logpmf": _put(fld.log_pmf(), device, torch.float32),
              "logcmf": _put(fld.log_cmf(), device, torch.float32),
              "mode": 0}

    def map_batch(batch, hits):
        merged = tuple(
            _put(np.concatenate([h[i] for h in hits]).astype(
                np.int64 if i < 3 else np.int32), device)
            for i in range(4))
        merged = rebudget_hits(merged, P=P,
                               hits_per_end=cfg.seed_hits_per_end)
        cands_r = rank_hits(merged, R=R, E=2, P=P, max_cands=cfg.max_cands)
        cands = [(c, candidate_read_start(c, ln, cfg.k))
                 for c, ln in zip(cands_r, (batch["lengths_l"],
                                            batch["lengths_r"]))]
        return map_paired_from_cands(cands, batch, dev2, cfg, fld_in, cp,
                                     co)

    acc = EquivalenceClassAccumulator()
    t0 = time.time()
    n_mapped = 0
    for bi, b in enumerate(batches):
        out = map_batch(_batch_tensors(b, device), hits_host[bi])
        acc.add_batch(out["eq_txp"].cpu().numpy(),
                      out["eq_weight"].cpu().numpy(),
                      out["eq_bins"].cpu().numpy()
                      if cfg.range_bins > 0 else None)
        n_mapped += int(out["num_mapped"])
    t_pass2 = time.time() - t0
    map_s = t_pass1 + t_pass2
    rate = n_frags / map_s

    # ---- EM + report ---------------------------------------------------
    eq = acc.finish()
    t0 = time.time()
    alphas, em_iters = run_vbem(eq, lengths, device)
    em_s = time.time() - t0
    report = {
        "config": "5 (genome-decoy sharded)",
        "n_shards": n_shards,
        "index_keys_g": round(meta["num_kmers"] / 1e9, 3),
        "index_occs_g": round(meta["num_occurrences"] / 1e9, 3),
        "load_min": round(load_s / 60, 2),
        "per_shard_hbm_gib": round(hbm_per_shard / 2**30, 2),
        "n_frags": n_frags,
        "mapped_frac": round(n_mapped / max(n_frags, 1), 4),
        "map_s": round(map_s, 1),
        "frags_per_s": round(rate, 1),
        "em_s": round(em_s, 1),
        "em_iters": em_iters,
    }
    return Config5Run(report, eq, alphas,
                      {"load_s": load_s, "b1_s": t_pass1, "b2_s": t_pass2,
                       "em_s": em_s}, shard_bytes)


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    device = require_device(device, "demo_config5_quant")
    n_shards = int(argv[0]) if len(argv) > 0 else 8
    max_frags = int(argv[1]) if len(argv) > 1 else 400_000
    cache = cache_dir()
    idx_dir = os.environ.get("CONFIG5_IDX",
                             os.path.join(cache, "genome_idx"))
    r1 = os.environ.get("CONFIG5_R1", os.path.join(cache, "reads_1.fastq"))
    r2 = os.environ.get("CONFIG5_R2", os.path.join(cache, "reads_2.fastq"))
    for p in (idx_dir, r1, r2):
        if not os.path.exists(p):
            log(f"missing {p}; run salmon_tpu_torch.scripts."
                "build_genome_scale_index (KEEP_GENOME_IDX=1) and "
                "scripts/make_synthetic_txome.py first")
            return 1
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    log(f"# device: {kind}; shards={n_shards}")
    run = quantify(idx_dir, r1, r2, n_shards, max_frags, device)
    print(json.dumps(run.report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
