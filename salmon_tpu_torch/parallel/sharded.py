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

sharded_map_paired / sharded_map_single are the counterparts of the JAX
package's jitted sharded step. On the card each is two captured CUDA
graphs per signature (utils.graphcache, in the index's cache of
mapping.pipeline.graph_cache): A, the seeds and the hit list before the
all-gather, and B, the ranking and the mapping of the rank's block after
it; the gather runs between them (over gloo it goes through the host,
which a graph cannot capture), and the statistics' all-reduce after B.
`*_impl` is the eager step, which CPU tensors run.
"""

from __future__ import annotations

import dataclasses

import torch

from salmon_tpu_torch.constants import DEFAULTS, SalmonDefaults
from salmon_tpu_torch.index.builder import TranscriptomeIndex
from salmon_tpu_torch.index.shard import shard_index_arrays
from salmon_tpu_torch.mapping.lookup import mix32b
from salmon_tpu_torch.mapping.pipeline import (MapperConfig, _end_seeds,
                                               _fld_parts,
                                               device_index_tensors,
                                               graph_cache,
                                               map_paired_from_cands,
                                               map_single_from_cands,
                                               row_pool_env, step_signature)
from salmon_tpu_torch.mapping.score import (candidate_read_start,
                                            diag_bucket_bits_for,
                                            window_bits_for)
from salmon_tpu_torch.mapping.seed_sparse import (collect_hits_sparse,
                                                  rank_hits, rebudget_hits)
from salmon_tpu_torch.parallel.distributed import World
from salmon_tpu_torch.parallel.quant_step import merge_stats
from salmon_tpu_torch.utils.graphcache import GraphCache, tensor_signature

# the read ends of a paired and of a single-end batch: (codes, lengths)
_ENDS = {"paired": (("codes_l", "lengths_l"), ("codes_r", "lengths_r")),
         "single": (("codes", "lengths"),)}


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


def n_windows(L: int, cfg: MapperConfig) -> int:
    """Seed windows a read end of width L queries (P of _end_seeds)."""
    return -(-(L - cfg.k + 1) // cfg.kmer_stride)


def _seed_hits(kind: str, batch: dict, dev: dict, cfg: MapperConfig,
               shard_bits: int, s: int) -> torch.Tensor:
    """The step before the all-gather: seeds against the local shard
    and their budgeted hit list, its four (H,) planes packed as one
    (H, 4) int64 tensor. batch: all R rows of the group's chunk."""
    seeded = [_local_seeds(batch[c], batch[ln], dev, cfg, shard_bits, s)
              for c, ln in _ENDS[kind]]
    P = seeded[0][1][0].shape[1]
    hits = collect_hits_sparse(
        seeded, dev["occ_oct"], occ_cap=cfg.occ_cap,
        max_occs_per_hit=cfg.max_occs_per_hit,
        hits_per_end=cfg.seed_hits_per_end, stride=cfg.kmer_stride,
        diag_bucket_bits=diag_bucket_bits_for(cfg.max_tpos,
                                              window_bits_for(P)))
    return torch.stack([h.to(torch.int64) for h in hits], dim=1)


def _gather_hits(world: World, packed: torch.Tensor,
                 n_shards: int) -> torch.Tensor:
    """The reads group's hit lists, concatenated in kmer-index order
    like the JAX package's all_gather(..., tiled=True)."""
    group = world.kmer_group(n_shards)
    with world.timed("hit_allgather"):
        return world.all_gather_cat(packed, group)


def _map_from_hits(kind: str, packed, bsub: dict, dev: dict,
                   cfg: MapperConfig, fld, compat, s: int, n_shards: int,
                   R: int, P: int) -> dict:
    """The step after the all-gather: the group's hits re-budgeted and
    ranked, this rank's row block of candidates taken (sub_block) and
    mapped. bsub: the rank's block of the batch."""
    hits = (packed[:, 0], packed[:, 1], packed[:, 2],
            packed[:, 3].to(torch.int32))
    hits = rebudget_hits(hits, P=P, hits_per_end=cfg.seed_hits_per_end)
    ends = _ENDS[kind]
    cands = rank_hits(hits, R=R, E=len(ends), P=P, max_cands=cfg.max_cands)
    out = []
    for cand, (_, ln) in zip(cands, ends):
        cand_sub = {k: sub_block(v, s, n_shards) for k, v in cand.items()}
        out.append((cand_sub, candidate_read_start(cand_sub, bsub[ln],
                                                   cfg.k)))
    if kind == "paired":
        return map_paired_from_cands(out, bsub, dev, cfg, fld, *compat)
    return map_single_from_cands(out, bsub, dev, cfg, fld, *compat)


def _check_rows(R: int, n_shards: int) -> None:
    if R % n_shards:
        raise ValueError(f"batch rows {R} not divisible by {n_shards} "
                         f"devices")


def _sharded_impl(kind: str, world: World, batch: dict, dev: dict,
                  cfg: MapperConfig, shard_bits: int, fld,
                  compat: tuple) -> dict:
    n_shards = 1 << shard_bits
    ends = _ENDS[kind]
    R, L = batch[ends[0][0]].shape
    _check_rows(R, n_shards)
    s = world.layout(n_shards)[1]
    packed = _gather_hits(
        world, _seed_hits(kind, batch, dev, cfg, shard_bits, s), n_shards)
    bsub = {k: sub_block(v, s, n_shards) for k, v in batch.items()}
    return merge_stats(world, _map_from_hits(
        kind, packed, bsub, dev, cfg, fld, compat, s, n_shards, R,
        n_windows(L, cfg)))


def _graphed(kind: str, world: World, batch: dict, dev: dict,
             cfg: MapperConfig, shard_bits: int, fld, compat: tuple,
             in_flight: int, cache: GraphCache) -> dict:
    """_sharded_impl through two graphs of `cache` per signature, A
    (_seed_hits) and B (_map_from_hits), with the all-gather between
    their replays and merge_stats after B. A signature holds what
    pipeline.step_signature holds (the index tensors' addresses among
    it), the shard count, the rank's kmer index and the row and window
    counts. B's outputs of the `in_flight` calls of its signature before
    this one stay readable."""
    n_shards = 1 << shard_bits
    ends = _ENDS[kind]
    R, L = batch[ends[0][0]].shape
    _check_rows(R, n_shards)
    s = world.layout(n_shards)[1]
    P = n_windows(L, cfg)
    names = sorted(batch)
    where = (kind, shard_bits, s, R, P)

    def seeds(ts):
        return {"packed": _seed_hits(kind, dict(zip(names, ts)), dev, cfg,
                                     shard_bits, s)}

    key_a = ("sharded seeds", where,
             tuple((k, tensor_signature(batch[k])) for k in names),
             tuple((k, v.data_ptr(), tensor_signature(v))
                   for k, v in sorted(dev.items())), cfg, row_pool_env())
    packed = cache.run(key_a, seeds, [batch[k] for k in names],
                       label=f"sharded seeds {kind} R={R} L={L} "
                             f"shards={n_shards} s={s}")["packed"]
    packed = _gather_hits(world, packed, n_shards)

    bsub = {k: sub_block(v, s, n_shards) for k, v in batch.items()}
    mode, fld_t = _fld_parts(fld)
    nb, nf = len(names), len(fld_t)

    def mapped(ts):
        f = ({"logpmf": ts[1 + nb], "logcmf": ts[2 + nb], "mode": mode}
             if mode is not None else ts[1 + nb])
        return _map_from_hits(kind, ts[0], dict(zip(names, ts[1:1 + nb])),
                              dev, cfg, f, ts[1 + nb + nf:], s, n_shards, R,
                              P)

    key_b = ("sharded map", where,
             step_signature(kind, bsub, dev, cfg, fld, compat),
             tensor_signature(packed))
    out = cache.run(key_b, mapped,
                    [packed] + [bsub[k] for k in names] + fld_t
                    + list(compat), ring=in_flight + 1,
                    label=f"sharded map {kind} R={R} L={L} "
                          f"shards={n_shards} s={s} fld_mode={mode}")
    return merge_stats(world, out)


def sharded_map_paired_impl(world: World, batch: dict, dev: dict,
                            cfg: MapperConfig, shard_bits: int, fld,
                            compat_paired, compat_orphan) -> dict:
    """Map one paired chunk of the reads group with the index sharded
    over the group, eagerly. Returns the outputs of the rank's row block
    (see sub_block), statistics summed over the world. Rows must divide
    by the shard count."""
    return _sharded_impl("paired", world, batch, dev, cfg, shard_bits, fld,
                         (compat_paired, compat_orphan))


def sharded_map_single_impl(world: World, batch: dict, dev: dict,
                            cfg: MapperConfig, shard_bits: int, fld,
                            compat_single) -> dict:
    """sharded_map_paired_impl for a single-end chunk."""
    return _sharded_impl("single", world, batch, dev, cfg, shard_bits, fld,
                         (compat_single,))


def sharded_map_paired(world: World, batch: dict, dev: dict,
                       cfg: MapperConfig, shard_bits: int, fld,
                       compat_paired, compat_orphan, *,
                       in_flight: int = 1) -> dict:
    """sharded_map_paired_impl, compiled: on CUDA tensors through the
    two graphs of its signature (_graphed; the first batch of a
    signature eager, the second captured, every later one replayed),
    on CPU tensors the eager step itself. On the card the outputs of the
    `in_flight` calls of the same signature before this one stay
    readable; older ones are overwritten."""
    if not batch["codes_l"].is_cuda:
        return sharded_map_paired_impl(world, batch, dev, cfg, shard_bits,
                                       fld, compat_paired, compat_orphan)
    return _graphed("paired", world, batch, dev, cfg, shard_bits, fld,
                    (compat_paired, compat_orphan), in_flight,
                    graph_cache(dev))


def sharded_map_single(world: World, batch: dict, dev: dict,
                       cfg: MapperConfig, shard_bits: int, fld,
                       compat_single, *, in_flight: int = 1) -> dict:
    """sharded_map_single_impl, compiled as sharded_map_paired is."""
    if not batch["codes"].is_cuda:
        return sharded_map_single_impl(world, batch, dev, cfg, shard_bits,
                                       fld, compat_single)
    return _graphed("single", world, batch, dev, cfg, shard_bits, fld,
                    (compat_single,), in_flight, graph_cache(dev))
