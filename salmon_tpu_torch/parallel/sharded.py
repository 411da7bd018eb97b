"""Sharded-index mapping: the k-mer dictionary and occurrence CSR split
over the ranks of each reads group, reads data-parallel over the groups.

Counterpart of salmon_tpu/parallel/sharded.py, whose ("reads", "kmer")
mesh becomes a rank layout (distributed.World.layout): rank r sits in
reads group r // S at kmer index r % S, S = --indexShards.

  * every rank of a reads group maps the same chunk of R reads;
  * each rank holds one index shard (index.shard; a genome-decoy index
    is too big to replicate per device), probes it for all R reads
    (queries whose owner is another shard are masked not-found) and
    expands its occurrences into the sparse seed flow's flat hit list;
  * the group's hit lists are all-gathered, concatenated in kmer-index
    order (hits carry global transcript coordinates), re-budgeted and
    ranked;
  * each rank then takes its kmer-index-th block of R / S rows and runs
    pairing, DP and filtering on it, so the post-seed stages use every
    rank; the batch statistics are summed over the world and the eq
    tensors stay with the rank.

Seeding equals the single-device sparse flow's at any hit budget: each
shard collects up to the per-end budget, a superset of the global kept
set, since each window's occurrences live in its one owner shard, and
rebudget_hits re-applies the budget over the union.
"""

from __future__ import annotations

import dataclasses

import torch

from salmon_tpu_torch.constants import DEFAULTS, SalmonDefaults
from salmon_tpu_torch.index.builder import TranscriptomeIndex
from salmon_tpu_torch.index.shard import shard_index_arrays
from salmon_tpu_torch.mapping.lookup import mix32b
from salmon_tpu_torch.mapping.pipeline import (MapperConfig, _end_seeds,
                                               device_index_tensors,
                                               map_paired_from_cands,
                                               map_single_from_cands)
from salmon_tpu_torch.mapping.score import (candidate_read_start,
                                            diag_bucket_bits_for,
                                            window_bits_for)
from salmon_tpu_torch.mapping.seed_sparse import (collect_hits_sparse,
                                                  rank_hits, rebudget_hits)
from salmon_tpu_torch.parallel.distributed import World
from salmon_tpu_torch.parallel.quant_step import merge_stats


def device_sharded_index(idx: TranscriptomeIndex, world: World,
                         n_shards: int):
    """This rank's shard of the index on its device, the rest of the
    index whole. Only the rank's own shard is built. Collective: it also
    sets up the reads group's group for the hit all-gather. Returns (dev
    dict, cfg overrides dict)."""
    _, s, _ = world.layout(n_shards)
    world.kmer_group(n_shards)
    sharded = shard_index_arrays(idx, n_shards, shards=[s])
    dev = device_index_tensors(idx, world.device,
                               planes=(sharded.tab_rows[0],
                                       sharded.occ_oct[0]))
    return dev, {"n_slots": sharded.n_slots,
                 "shard_bits": sharded.shard_bits}


def sharded_config(idx: TranscriptomeIndex, overrides: dict,
                   opts: SalmonDefaults = DEFAULTS,
                   **extra) -> MapperConfig:
    """The run's MapperConfig on a sharded index: the shards' common
    slot count and the sparse seed flow, which the sharding needs."""
    base = MapperConfig.from_index(idx, opts, allow_no_table=True, **extra)
    return dataclasses.replace(base, n_slots=overrides["n_slots"],
                               sparse_seed=True)


def _local_seeds(codes, lengths, dev: dict, cfg: MapperConfig,
                 shard_bits: int, kmer_index: int):
    """Per-end k-mer extraction and lookup in this rank's shard, found
    only where the rank owns the key. mix32b gives u32 values in int64
    (utils.u32), so >> is the logical shift of the JAX package."""
    km, (start, count, found, inl, itxp, ipf) = _end_seeds(
        codes, lengths, dev, cfg)
    if shard_bits:
        owner = mix32b(km["hi"], km["lo"]) >> (32 - shard_bits)
        found = found & (owner == kmer_index)
    return km, (start, count, found, inl, itxp, ipf)


def sub_block(a: torch.Tensor, s: int, n_blocks: int) -> torch.Tensor:
    """The s-th of n_blocks equal row blocks of `a`."""
    sub = a.shape[0] // n_blocks
    return a[s * sub:(s + 1) * sub]


def _sharded_cands(world: World, ends_cl, dev: dict, cfg: MapperConfig,
                   shard_bits: int):
    """Seed candidates against the local shard, hits all-gathered over
    the reads group, ranked, and this rank's row block taken.

    ends_cl: (codes, lengths) per read end, all R rows of the group's
    chunk. Returns [(cand, start)] per end over the rank's R / S rows."""
    n_shards = 1 << shard_bits
    _, s, _ = world.layout(n_shards)
    seeded = [_local_seeds(c, ln, dev, cfg, shard_bits, s)
              for c, ln in ends_cl]
    R, P = seeded[0][1][0].shape
    hits = collect_hits_sparse(
        seeded, dev["occ_oct"], occ_cap=cfg.occ_cap,
        max_occs_per_hit=cfg.max_occs_per_hit,
        hits_per_end=cfg.seed_hits_per_end, stride=cfg.kmer_stride,
        diag_bucket_bits=diag_bucket_bits_for(cfg.max_tpos,
                                              window_bits_for(P)))
    # one gather of the four (H,) planes; concatenated in kmer-index
    # order like the JAX package's all_gather(..., tiled=True)
    packed = torch.stack([h.to(torch.int64) for h in hits], dim=1)
    group = world.kmer_group(n_shards)
    with world.timed("hit_allgather"):
        packed = world.all_gather_cat(packed, group)
    hits = (packed[:, 0], packed[:, 1], packed[:, 2],
            packed[:, 3].to(torch.int32))
    hits = rebudget_hits(hits, P=P, hits_per_end=cfg.seed_hits_per_end)
    cands = rank_hits(hits, R=R, E=len(seeded), P=P,
                      max_cands=cfg.max_cands)
    out = []
    for cand, (_, lengths) in zip(cands, ends_cl):
        cand_sub = {k: sub_block(v, s, n_shards) for k, v in cand.items()}
        out.append((cand_sub, candidate_read_start(
            cand_sub, sub_block(lengths, s, n_shards), cfg.k)))
    return out


def _check_rows(R: int, n_shards: int) -> None:
    if R % n_shards:
        raise ValueError(f"batch rows {R} not divisible by {n_shards} "
                         f"devices")


def sharded_map_paired(world: World, batch: dict, dev: dict,
                       cfg: MapperConfig, shard_bits: int, fld,
                       compat_paired, compat_orphan) -> dict:
    """Map one paired chunk of the reads group with the index sharded
    over the group. Returns the outputs of the rank's row block (see
    sub_block), statistics summed over the world. Rows must divide by
    the shard count."""
    n_shards = 1 << shard_bits
    _check_rows(batch["lengths_l"].shape[0], n_shards)
    cands = _sharded_cands(world, [(batch["codes_l"], batch["lengths_l"]),
                                   (batch["codes_r"], batch["lengths_r"])],
                           dev, cfg, shard_bits)
    s = world.layout(n_shards)[1]
    bsub = {k: sub_block(v, s, n_shards) for k, v in batch.items()}
    return merge_stats(world, map_paired_from_cands(
        cands, bsub, dev, cfg, fld, compat_paired, compat_orphan))


def sharded_map_single(world: World, batch: dict, dev: dict,
                       cfg: MapperConfig, shard_bits: int, fld,
                       compat_single) -> dict:
    """sharded_map_paired for a single-end chunk."""
    n_shards = 1 << shard_bits
    _check_rows(batch["lengths"].shape[0], n_shards)
    cands = _sharded_cands(world, [(batch["codes"], batch["lengths"])],
                           dev, cfg, shard_bits)
    s = world.layout(n_shards)[1]
    bsub = {k: sub_block(v, s, n_shards) for k, v in batch.items()}
    return merge_stats(world, map_single_from_cands(
        cands, bsub, dev, cfg, fld, compat_single))
