"""End-to-end quantification, mapping mode (paired-end or single-end
reads), on one device or one rank of a multi-process run.

Counterpart of salmon_tpu/quant.py (reference flow: salmonQuantify ->
processReads workers -> eq classes -> CollapsedEMOptimizer::optimize ->
GZipWriter outputs): stream fixed-shape chunks -> map each batch on the
device (and, with a bias flag on paired reads, collect its observed
bias histograms there) -> host eq-class / FLD / counter accumulation ->
effective lengths -> EM/VBEM on the device -> with a bias flag, the
bias-corrected effective lengths and a second EM -> writers, with
Gibbs or bootstrap draws on the device when asked. Side outputs of the
mapping loop: --writeMappings (SAM), --writeUnmappedNames,
--writeOrphanLinks and --profileDir (a torch.profiler trace). Under a
multi-process launch (parallel.distributed) each rank maps its own
chunks, data-parallel or with the index sharded over the ranks of a
reads group (--indexShards), the batch statistics are summed over the
ranks, and the eq tables and bias histograms are merged after the
stream, so that every rank runs the same EM.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from salmon_tpu_torch.constants import DEFAULTS, SalmonDefaults
from salmon_tpu_torch.index.builder import TranscriptomeIndex, load_index
from salmon_tpu_torch.inference import em as em_mod
from salmon_tpu_torch.inference import sampling
from salmon_tpu_torch.inference.clusters import normalize_alphas
from salmon_tpu_torch.inference.eqclasses import (INVALID_TXP,
                                                 EquivalenceClassAccumulator)
from salmon_tpu_torch.io import writers
from salmon_tpu_torch.io.fastq import (PairedChunk, ReadChunk, bucket_len,
                                       iter_paired_chunks, iter_single_chunks)
from salmon_tpu_torch.mapping.pipeline import (CUT_KEYS, ROW_COUNTERS,
                                               MapperConfig, WidePass,
                                               device_index_tensors,
                                               graph_stats,
                                               map_paired_batch,
                                               map_single_batch, mark_stats)
from salmon_tpu_torch.models.bias import (bias_device_tensors,
                                          collect_bias_observations)
from salmon_tpu_torch.models.bias_correct import BiasState
from salmon_tpu_torch.models.efflen import effective_lengths
from salmon_tpu_torch.models.fld import FragmentLengthDistribution
from salmon_tpu_torch.parallel import distributed
from salmon_tpu_torch.parallel.quant_step import merge_stats
from salmon_tpu_torch.parallel.sharded import (device_sharded_index,
                                               sharded_config,
                                               sharded_map_paired,
                                               sharded_map_single, sub_block)
from salmon_tpu_torch.utils import libformat, spans
from salmon_tpu_torch.utils.dna import decode_seq
from salmon_tpu_torch.utils.graphcache import stats_totals

logger = logging.getLogger("salmon_tpu_torch")


@dataclasses.dataclass
class QuantResult:
    names: list
    counts: np.ndarray
    eff_lens: np.ndarray
    tpm: np.ndarray
    num_processed: int
    num_mapped: int
    num_paired: int
    num_orphans: int
    em_info: dict
    fmt_counts: dict
    eq_classes: object = None
    fld: object = None
    lib_format: str = ""
    mapping_stats: dict = dataclasses.field(default_factory=dict)
    num_batches: int = 0
    num_orphans_rescued: int = 0
    paired: bool = True
    bias: Optional[BiasState] = None
    aux_target_ids: Optional[list] = None


class InsufficientAssignedFragments(RuntimeError):
    """Reference: SalmonExceptions / minAssignedFrags gate."""


class ForgettingMass:
    """SVI step-size schedule (reference ForgettingMassCalculator,
    ForgettingMassCalculator.hpp:23-64): logMass_t += ff*log(t-1) -
    log(t^ff - 1), applied per device batch."""

    def __init__(self, forgetting_factor: float = 0.65):
        self.ff = forgetting_factor
        self.log_mass = 0.0
        self.t = 0

    def next_log_mass(self) -> float:
        self.t += 1
        if self.t > 1:
            self.log_mass += (self.ff * np.log(self.t - 1)
                              - np.log(self.t ** self.ff - 1))
        return self.log_mass


DETECT_SAMPLES_NEEDED = 50_000  # LibraryTypeDetector numSamplesNeeded_


def _detect_library_format(fmt_hist: np.ndarray, paired: bool) -> str:
    """Auto-detect '-l A' from the observed orientation histogram
    (reference LibraryTypeDetector::mostLikelyType,
    LibraryTypeDetector.hpp:34-143): orientation by argmax, then
    strandedness with the 30%/70% forward-ratio bands. Single-end
    histograms count SF in entry 0 and SR in entry 1."""
    if not paired:
        fw, rc = int(fmt_hist[0]), int(fmt_hist[1])
        if fw + rc == 0:
            return "U"
        ratio = fw / (fw + rc)
        if ratio < 0.3:
            return "SR"
        if ratio < 0.7:
            return "U"
        return "SF"
    names = libformat.format_names_paired()
    counts = {names[i]: int(fmt_hist[i]) for i in range(6)}
    o_tot = {"I": counts["ISF"] + counts["ISR"],
             "O": counts["OSF"] + counts["OSR"],
             "M": counts["MSF"] + counts["MSR"]}
    if sum(o_tot.values()) == 0:
        return "IU"
    # argmax with the reference's tie order (inward >= outward >= same)
    o = "I"
    if o_tot["O"] > o_tot["I"]:
        o = "O"
    if o_tot["M"] > o_tot[o]:
        o = "M"
    sf = counts["ISF"] + counts["OSF"] + counts["MSF"]
    sr = counts["ISR"] + counts["OSR"] + counts["MSR"]
    st = sf + sr
    if st == 0:
        return o + "U"
    ratio = sf / st
    if ratio < 0.3:
        return o + "SR"
    if ratio < 0.7:
        return o + "U"
    return o + "SF"


def _seq_text(codes: np.ndarray, lengths: np.ndarray):
    """text(row, rc): the bases of row `row` of a (k, L) code block, its
    first lengths[row] codes, forward or reverse-complemented. The block
    is decoded twice at once (invalid bases read N, as decode_seq writes
    them); a call only slices."""
    L = codes.shape[1]
    fwd = decode_seq(codes.reshape(-1)).encode("ascii")
    comp = np.where(codes < 4, 3 - codes, codes)[:, ::-1]
    rev = decode_seq(comp.reshape(-1)).encode("ascii")
    lens = lengths.tolist()

    def text(row: int, rc: bool) -> str:
        if rc:   # the flipped row holds the read's bases at its right end
            return rev[(row + 1) * L - lens[row]:(row + 1) * L].decode()
        return fwd[row * L:row * L + lens[row]].decode()
    return text


def _write_sam_batch(fh, index, names, chunk, out) -> None:
    """SAM records for each mapped fragment's best alignment in a paired
    batch (--writeMappings; approximate CIGAR = full-length match, like
    the reference's SCORE_ONLY alignment mode). The bytes of the JAX
    package's _write_sam_batch (salmon_tpu/quant.py:155-200), with the
    bases decoded for the whole batch at once."""
    n = chunk.n_valid
    ok = _to_np(out["frag_ok"])[:n]
    txp = _to_np(out["best_txp"])[:n]
    keep = np.nonzero(ok & (txp < index.num_valid_targets))[0]
    if keep.size == 0:
        return
    txp = txp[keep].tolist()
    pos = _to_np(out["best_pos"])[keep].tolist()
    fw = _to_np(out["best_fw"])[keep].tolist()
    flen = _to_np(out["best_flen"])[keep].tolist()
    is_p = _to_np(out["best_is_paired"])[keep].tolist()
    l1 = chunk.left.lengths[keep].tolist()
    seq1 = _seq_text(chunk.left.codes[keep], chunk.left.lengths[keep])
    l2 = chunk.right.lengths[keep].tolist()
    seq2 = _seq_text(chunk.right.codes[keep], chunk.right.lengths[keep])
    lines = []
    for j, i in enumerate(keep.tolist()):
        nm = names[i]
        nm = nm.decode() if isinstance(nm, bytes) else nm
        rname = index.names[txp[j]]
        L1, p, f = l1[j], pos[j], fw[j]
        if is_p[j]:
            L2, tl = l2[j], flen[j]
            p1 = p if f else p + tl - L1
            p2 = p + tl - L2 if f else p
            f1 = 0x1 | 0x2 | 0x40 | (0x20 if f else 0x10)
            f2 = 0x1 | 0x2 | 0x80 | (0x10 if f else 0x20)
            lines.append(f"{nm}\t{f1}\t{rname}\t{p1 + 1}\t255\t{L1}M\t=\t"
                         f"{p2 + 1}\t{tl if f else -tl}\t"
                         f"{seq1(j, not f)}\t*\n"
                         f"{nm}\t{f2}\t{rname}\t{p2 + 1}\t255\t{L2}M\t=\t"
                         f"{p1 + 1}\t{-tl if f else tl}\t{seq2(j, f)}\t*\n")
        else:
            lines.append(f"{nm}\t{0 if f else 0x10}\t{rname}\t{p + 1}\t"
                         f"255\t{L1}M\t*\t0\t0\t{seq1(j, not f)}\t*\n")
    fh.write("".join(lines))


def _write_orphan_links(fh, chunk, out) -> None:
    """--writeOrphanLinks (reference SalmonQuantify.cpp:1409-1421): per
    fragment without a concordant pair, its left end's `txp,pos` fields,
    ':', its right end's."""
    rowsel = _to_np(out["orph_link_row"])
    lt, lp = _to_np(out["orphl_txp"]), _to_np(out["orphl_pos"])
    rt, rp = _to_np(out["orphr_txp"]), _to_np(out["orphr_pos"])
    for i in np.nonzero(rowsel[:chunk.n_valid])[0]:
        left = "\t".join(f"{t},{p}" for t, p in
                         zip(lt[i][lt[i] >= 0], lp[i][lt[i] >= 0]))
        right = "\t".join(f"{t},{p}" for t, p in
                          zip(rt[i][rt[i] >= 0], rp[i][rt[i] >= 0]))
        if left or right:
            fh.write(f"{left}:{right}\n")


def _open_sam(sam_path: str, index):
    """The --writeMappings stream (a file, or stdout for "-") with its
    header (reference ProgramOptionsGenerator.cpp:264-271)."""
    fh = sys.stdout if sam_path == "-" else open(sam_path, "w")
    fh.write("@HD\tVN:1.0\tSO:unknown\n")
    for i in range(index.num_valid_targets):
        fh.write(f"@SQ\tSN:{index.names[i]}\t"
                 f"LN:{int(index.complete_lengths[i])}\n")
    fh.write("@PG\tID:salmon_tpu\tPN:salmon_tpu\n")
    return fh


def _start_profiler(profile_dir: str, device: torch.device):
    """--profileDir: a torch.profiler session over the mapping loop (host
    activity, and the card's kernels on a CUDA device)."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, profile_dir: str, device: torch.device) -> None:
    """End the session and write its Chrome trace into profile_dir."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    path = os.path.join(profile_dir, time.strftime(
        "mapping_%Y%m%d_%H%M%S") + f"_{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace -> %s", path)


def _empty_chunk(paired: bool, rows: int, width: int, want_names: bool):
    """A chunk of padding rows only: what a rank maps where its reads
    group has no chunk left while other groups still have."""
    def part(names):
        return ReadChunk(np.full((rows, width), 4, np.uint8),
                         np.zeros(rows, np.int32), 0, names)
    names = [] if want_names else None
    return PairedChunk(part(names), part(None)) if paired else part(names)


def _group_chunks(chunks, group: int, n_groups: int, own_files: bool,
                  empty):
    """This reads group's chunks of a multi-process run. Streams of
    their own files (own_files) end together through a has-data vote,
    ended groups mapping empty chunks; a stream shared by all groups
    gives group g the g-th chunk of every n_groups (the stream packs
    only those, the others are None), the missing tail chunks empty.
    Either way every rank maps the same number of chunks, so their
    collectives pair up; the chunks of two groups may differ in
    width, as no collective spans rows of two groups."""
    if own_files:
        it = iter(chunks)
        while True:
            c = next(it, None)
            if not distributed.any_rank(c is not None):
                return
            yield c if c is not None else empty()
    n = 0
    for n, c in enumerate(chunks, 1):
        if (n - 1) % n_groups == group:
            yield c
    if 0 < n % n_groups <= group:
        yield empty()


def _read_spans(it):
    """The items of `it`, each next() (reading, parsing and packing a
    chunk) inside a quant.read span of the batch that the next chunk
    becomes: the number of chunks that are not None before it (a stream
    shared by reads groups yields None for the others' chunks)."""
    it = iter(it)
    b = 0
    end = object()
    while True:
        with spans.span("quant.read", b):
            item = next(it, end)
        if item is end:
            return
        if item is not None:
            b += 1
        yield item


def _sub_chunk(chunk, s: int, n_blocks: int):
    """The s-th of n_blocks equal row blocks of a chunk (the rows a
    rank maps past the seed stage of the sharded path)."""
    if n_blocks == 1:
        return chunk

    def sub(rc):
        rows = rc.codes.shape[0] // n_blocks
        lo = s * rows
        n = min(max(rc.n_valid - lo, 0), rows)
        return ReadChunk(rc.codes[lo:lo + rows], rc.lengths[lo:lo + rows],
                         n, None if rc.names is None
                         else rc.names[lo:lo + n])
    if isinstance(chunk, PairedChunk):
        return PairedChunk(sub(chunk.left), sub(chunk.right))
    return sub(chunk)


def _merge_ranks(world, acc, bias_state, ranged: bool) -> None:
    """After the stream: every rank's eq table and observed-bias
    histograms become the sum over the ranks, so the replicated EM
    agrees everywhere (mergeObservedBias, WorkerRuntimeContext.hpp:
    22-70, for the histograms: additive and fixed-size)."""
    if bias_state is not None:
        o = bias_state.obs
        (o.obs5, o.obs3, o.gc_obs, o.pos5, o.pos3, mf, mr) = \
            distributed.allreduce_histograms(
                [o.obs5, o.obs3, o.gc_obs, o.pos5, o.pos3,
                 np.float64(o.mass_fwd), np.float64(o.mass_rc)])
        o.mass_fwd, o.mass_rc = float(mf), float(mr)
    with world.timed("eq_allgather", host=True):
        # the ranks' labels at one width (a rank's wide pass may have
        # widened its table)
        acc.widen(distributed.max_over_ranks(acc.label_width))
        keys, counts, wsum = distributed.allgather_eq_state(
            *acc.collapsed())
    # a key is the labels, then as many range-factorization bins
    acc.replace_rows(keys, counts, wsum,
                     keys.shape[1] // 2 if ranged else keys.shape[1])


def _bias_on(opts: SalmonDefaults) -> bool:
    return bool(opts.seq_bias_correct or opts.gc_bias_correct
                or opts.pos_bias_correct)


def _mark_auxiliary_targets(index, opts):
    """--auxTargetFile (reference salmon::utils::markAuxiliaryTargets,
    SalmonUtils.cpp:1133-1194): transcripts named in the file are marked
    to skip bias correction. Returns (bool mask over valid targets, their
    ids for aux_target_ids.json), or (None, None) without a file."""
    path = opts.aux_target_file or ""
    if not path:
        return None, None
    if not os.path.exists(path):
        logger.warning("The auxiliary target file %s does not exist. "
                       "No targets will be treated as auxiliary.", path)
        return None, None
    with open(path) as fh:
        names = set(fh.read().split())
    logger.info("Parsed %d auxiliary targets from %s", len(names), path)
    n = index.num_valid_targets
    mask = np.array([nm in names for nm in index.names[:n]], dtype=bool)
    found = int(mask.sum())
    if found != len(names):
        logger.warning("While %d auxiliary target names were found in "
                       "%s, only %d matched index transcripts.",
                       len(names), path, found)
    return mask, np.nonzero(mask)[0].tolist()


def _to_np(t) -> np.ndarray:
    return t if isinstance(t, np.ndarray) else t.cpu().numpy()


def quantify(index: TranscriptomeIndex | str, lib_format: str,
             reads1: Sequence[str], reads2: Optional[Sequence[str]],
             opts: SalmonDefaults = DEFAULTS, progress: bool = True,
             unmapped_path: Optional[str] = None,
             sam_path: Optional[str] = None,
             orphan_links_path: Optional[str] = None,
             device="cuda",
             world: Optional[distributed.World] = None) -> QuantResult:
    """Mapping-based quantification on `device` (reference:
    salmonQuantify, src/quant/SalmonQuantify.cpp:2777): paired-end
    reads, or single-end reads when `reads2` is None. Side outputs, as
    in the JAX package: unmapped read names with the reference's 'u'
    reason code to `unmapped_path` (--writeUnmappedNames), each mapped
    fragment's best alignment as SAM to `sam_path` ("-" for stdout,
    --writeMappings; paired runs only, as in the JAX package, whose
    single-end runs fail there), paired runs' orphan links to `orphan_links_path`
    (--writeOrphanLinks, with opts.write_orphan_links), and with
    opts.profile_dir a torch.profiler trace of the mapping loop.

    `world` is this process's place in a multi-process run: its rank
    maps its own chunks, and the side outputs hold its own fragments.
    With opts.index_shards S > 1 the index is sharded over the S ranks
    of each reads group; the world's size must divide by S.

    The fragments that a fixed-shape cap of the batch step may have cut
    short are mapped again at wide caps in the same batch (the wide pass,
    mapping.pipeline.WidePass; not under --indexShards), and their
    completed labels reach the eq accumulator in the batch's one
    add_batch, in fragment order, widened to the batch's widest label.

    The mapping loop records spans (utils.spans) of each batch: quant.read,
    quant.submit and quant.consume, inside it quant.wait (the host blocked
    until the batch's outputs are on the host), step.wide (the wide
    pass's launch), quant.wide (its results spliced in, the wait on them
    included) and quant.eq (eq.dedupe, eq.merge), and on the card each
    batch step's and wide pass's interval (BatchEvents); the counters
    frags_marked, marked_occ, marked_cands, marked_dp, marked_width,
    frags_wide, frags_wide_passes and frags_cut_wide, and the peak
    label_width_max.
    Its clocks record sums them over this call."""
    t0 = time.perf_counter()
    span_base, count_base = spans.totals(), spans.counters()
    paired = reads2 is not None
    if sam_path is not None and not paired:
        raise NotImplementedError(
            "single-end --writeMappings: the JAX package's single-end "
            "batches emit no best hit, so its records have no reference "
            "(ROADMAP queue 3)")
    device = torch.device(device)
    if isinstance(index, str):
        index = load_index(index)
    n_shards = opts.index_shards
    group, kmer_index, n_groups = distributed.layout(
        world.rank if world else 0, world.size if world else 1, n_shards)
    multi = world is not None and world.size > 1
    if multi:
        world.reset_clocks()
    if device.type == "cuda":
        with spans.span("cuda.start"):
            # the runtime and the device's context, before the upload
            torch.cuda.init()
            torch.empty(1, device=device)
    shard_bits = 0
    if n_shards > 1:
        with world.timed("shard_build", host=True):
            dev, over = device_sharded_index(index, world, n_shards)
        cfg = sharded_config(index, over, opts)
        shard_bits = over["shard_bits"]
        logger.info("index sharded %d-way over the ranks of each reads "
                    "group; %d reads groups", n_shards, n_groups)
    else:
        cfg = MapperConfig.from_index(index, opts)
        dev = device_index_tensors(index, device)
        if multi:
            logger.info("mapping data-parallel over %d ranks", world.size)
    wide = (WidePass(index, cfg, paired, tab_rows=dev["tab_rows"])
            if n_shards == 1 else None)
    if wide is not None:
        logger.info("wide pass: occ_cap %d, candidates, pairs and labels "
                    "%d", wide.cfg.occ_cap, wide.cfg.weight_width)

    fld = FragmentLengthDistribution(
        max_val=opts.max_frag_length, prior_mu=opts.frag_len_prior_mean,
        prior_sigma=opts.frag_len_prior_sd)
    fmass = ForgettingMass(opts.forgetting_factor)
    acc = EquivalenceClassAccumulator()
    online_mass = np.zeros(index.num_targets, dtype=np.float64)
    totals = {"num_processed": 0, "num_mapped": 0, "num_paired": 0,
              "num_orphans": 0, "num_orphans_rescued": 0,
              "num_decoy_fragments": 0,
              "num_dovetail_fragments": 0, "num_frags_filtered_vm": 0,
              "num_alns_below_threshold": 0, "seed_tail_over": 0}
    fmt_hist_total = np.zeros(6, dtype=np.int64)
    # the wide pass's recount of the fragments it mapped again, added to
    # the totals and the online mass after the stream (summed over the
    # ranks there)
    wide_counts = np.zeros(len(ROW_COUNTERS), dtype=np.int64)
    wide_mass = np.zeros(index.num_targets, dtype=np.float64)
    wide_stats = {k: 0 for k in ("frags_marked", *CUT_KEYS, "frags_wide",
                                 "frags_cut_wide")}
    label_width_max = 0

    # bias models: observed statistics are collected per batch on the
    # device, paired input only (single-end runs keep no bias state, as
    # in the JAX package)
    aux_skip_bias, aux_target_ids = _mark_auxiliary_targets(index, opts)
    bias_state = bdev = None
    if paired and _bias_on(opts):
        bias_state = BiasState(index, opts, device)
        bias_state.skip_bias = aux_skip_bias
        bdev = bias_device_tensors(index, device)

    auto_detect = lib_format.strip().upper() == "A"
    resolved_format = None if auto_detect else lib_format.strip().upper()

    def compat_tensors(fmt: libformat.LibraryFormat):
        """(paired, orphan) tables, or the (single,) table."""
        tabs = ((libformat.paired_compat_table(fmt),
                 libformat.orphan_compat_table(fmt)) if paired
                else (libformat.single_compat_table(fmt),))
        return tuple(torch.as_tensor(t, device=device) for t in tabs)

    if auto_detect:
        # while detecting, every format is compatible (the reference
        # runs with a neutral incompatPrior until the detector can guess,
        # SalmonQuantify.cpp:691-700)
        compat = tuple(torch.ones(shape, dtype=torch.bool, device=device)
                       for shape in ([(6,), (2, 2)] if paired else [(2,)]))
        detect_hist = np.zeros(6, dtype=np.int64)
    else:
        compat = compat_tensors(libformat.parse_library_format(lib_format))

    want_names = unmapped_path is not None or sam_path is not None
    unmapped_fh = open(unmapped_path, "w") if unmapped_path else None
    orphan_fh = (open(orphan_links_path, "w")
                 if (orphan_links_path and paired) else None)
    sam_fh = _open_sam(sam_path, index) if sam_path is not None else None

    def put(a):
        return torch.from_numpy(a).to(device)

    def map_batch(batch, fld_in):
        # the outputs of `depth` batches wait for consume while the next
        # one maps
        if shard_bits:
            fn = sharded_map_paired if paired else sharded_map_single
            return fn(world, batch, dev, cfg, shard_bits, fld_in, *compat,
                      in_flight=depth)
        fn = map_paired_batch if paired else map_single_batch
        out = fn(batch, dev, cfg, fld_in, *compat, in_flight=depth)
        return merge_stats(world, out) if multi else out

    def submit(chunk, b):
        """Launch the mapping of one chunk, batch b (returns before the
        device finishes). Returns the rows of the chunk and of its device
        batch that the outputs hold (under shards the rank's block), and
        the outputs, and the FLD snapshot and compat tables it ran with."""
        # FLD snapshot for this minibatch (the LogCMFCache refresh
        # analog); mode selects the fragment-prob form by burn-in stage
        processed = totals["num_processed"]
        if processed < opts.num_pre_burnin_frags:
            mode = 0
        elif processed >= opts.num_burnin_frags:
            mode = 2
        else:
            mode = 1
        fld_in = {
            "logpmf": torch.as_tensor(fld.log_pmf(), dtype=torch.float32,
                                      device=device),
            "logcmf": torch.as_tensor(fld.log_cmf(), dtype=torch.float32,
                                      device=device),
            "mode": mode,
        }
        if not paired:
            batch = {"codes": put(chunk.codes),
                     "lengths": put(chunk.lengths)}
        else:
            batch = {"codes_l": put(chunk.left.codes),
                     "lengths_l": put(chunk.left.lengths),
                     "codes_r": put(chunk.right.codes),
                     "lengths_r": put(chunk.right.lengths)}
        if events is not None:
            events.begin(b)
        out = map_batch(batch, fld_in)
        if events is not None:
            events.end(b)
        if shard_bits:
            chunk = _sub_chunk(chunk, kmer_index, n_shards)
            batch = {k: sub_block(v, kmer_index, n_shards)
                     for k, v in batch.items()}
        return chunk, batch, out, (fld_in, compat)

    n_batches = 0
    last_progress = time.perf_counter()

    # the side outputs' keys of a batch's outputs, read on the host before
    # a later batch's step overwrites them
    side_keys = ((("frag_ok", "best_txp", "best_pos", "best_flen",
                   "best_fw", "best_is_paired") if paired else ("frag_ok",))
                 + (("orph_link_row", "orphl_txp", "orphl_pos", "orphr_txp",
                     "orphr_pos") if orphan_fh is not None else ()))
    # a batch whose wide pass runs on the card while the host goes on:
    # its eq rows reach the accumulator at the next consume (or after the
    # stream), before that batch's own
    deferred = []

    def run_wide(batch, out, b, step_in, n_wide):
        """The wide pass's launch over a batch's frag_wide fragments."""
        with spans.span("step.wide"):
            if wide_events is not None:
                wide_events.begin(b)
            ran = wide.run(batch, out, dev, step_in[0], step_in[1], n_wide)
            if wide_events is not None:
                wide_events.end(b)
        return ran

    def finish(chunk, eq, side, b, wide_part):
        """A batch's eq rows into the accumulator and its side outputs,
        once its wide pass (if any) is spliced in."""
        nonlocal label_width_max
        if wide_part is not None:
            ran, mass_factor, marked_counts = wide_part
            with spans.span("quant.wide", b):
                done = wide.complete(*eq, side["frag_ok"], ran)
            if wide_events is not None:
                wide_events.finish(b)
            eq = done["eq"]
            # the batch step's counts of these rows give way to the recount
            wide_counts[:] += done["counts"] - marked_counts
            wide_mass[:] += mass_factor * done["mass"]
            wide_stats["frags_cut_wide"] += done["cut"]
            spans.count("frags_cut_wide", done["cut"])
            side = dict(side, frag_ok=done["frag_ok"])
            for k, v in (done["best"] or {}).items():
                if k in side:
                    side[k] = side[k].copy()
                    side[k][done["rows"]] = v
        width = int((eq[0] != INVALID_TXP).sum(axis=1).max(initial=0))
        if width > label_width_max:
            label_width_max = width
            spans.peak("label_width_max", width)
        with spans.span("quant.eq", b):
            acc.add_batch(*eq)
        with spans.span("quant.side_outputs", b):
            write_side_outputs(chunk, side)

    def write_side_outputs(chunk, side):
        if orphan_fh is not None and "orph_link_row" in side:
            _write_orphan_links(orphan_fh, chunk, side)
        if want_names:
            names = (chunk.left.names if paired else chunk.names) or []
            if unmapped_fh is not None:
                ok = side["frag_ok"]
                for i, nm in enumerate(names[:chunk.n_valid]):
                    if not ok[i]:
                        unmapped_fh.write(f"{nm.decode()} u\n")
            if sam_fh is not None:
                with spans.span("quant.sam_write"):
                    _write_sam_batch(sam_fh, index, names, chunk, side)

    def consume(chunk, batch, out, b, step_in):
        nonlocal n_batches, last_progress
        with spans.span("quant.consume", b):
            with spans.span("quant.wait"):
                # the first copy waits for the batch's mapping to finish
                txp = _to_np(out["eq_txp"])
            if events is not None:
                events.finish(b)
            while deferred:
                finish(*deferred.pop())
            # what the host keeps of the outputs, read before the wide
            # pass is queued behind them
            eq = (txp, _to_np(out["eq_weight"]),
                  _to_np(out["eq_bins"]) if cfg.range_bins > 0 else None)
            want_side = want_names or orphan_fh is not None
            side = ({k: _to_np(out[k]) for k in side_keys} if want_side
                    else {})
            fld_hist = _to_np(out["fld_hist"]).astype(np.float64)
            txp_mass = _to_np(out["txp_mass"]).astype(np.float64)
            for k in totals:
                totals[k] += int(out[k])
            fmt_hist_total[:] += _to_np(out["fmt_hist"]).astype(np.int64)
            mass_factor = np.exp(fmass.next_log_mass())
            wide_part = None
            marks = (mark_stats(_to_np(out["mark_counts"]))
                     if wide is not None else {"frags_marked": 0})
            if marks["frags_marked"]:
                for k in ("frags_marked", *CUT_KEYS, "frags_wide"):
                    wide_stats[k] += marks[k]
                    spans.count(k, marks[k])
            if marks.get("frags_wide"):
                side.setdefault("frag_ok", _to_np(out["frag_ok"]))
                # launched now, the wide pass runs on the card while the
                # host does the rest and reads the next batch
                wide_part = (run_wide(batch, out, b, step_in,
                                      marks["frags_wide"]),
                             mass_factor,
                             np.array([marks[f"wide.{k}"]
                                       for k in ROW_COUNTERS], np.int64))
            if bias_state is not None:
                # the batch's mapping has finished (its eq tensors are on the
                # host), so this span holds the collection alone
                with spans.span("quant.bias_collect"):
                    bs = out["best_pos"]
                    bias_state.obs.add_batch(collect_bias_observations(
                        bdev, out["best_txp"], bs, bs + out["best_flen"] - 1,
                        out["best_fw"], batch["lengths_l"], batch["lengths_r"],
                        out["best_is_paired"]
                        & (out["best_txp"] < index.num_valid_targets),
                        torch.ones_like(bs, dtype=torch.float32)))
            fld.add_observations(fld_hist)
            online_mass[:] += mass_factor * txp_mass
            if wide_part is None:
                finish(chunk, eq, side, b, None)
            else:
                deferred.append((chunk, eq, side, b, wide_part))
            if totals["num_processed"] >= opts.num_burnin_frags:
                fld.freeze()
            n_batches += 1
            if (progress and not opts.disable_live_progress
                    and time.perf_counter() - last_progress
                    >= opts.progress_update_ms / 1000.0):
                last_progress = time.perf_counter()
                el = last_progress - t0
                logger.info(
                    "processed %d fragments (%.0f frags/s), mapped %.2f%%",
                    totals["num_processed"],
                    totals["num_processed"] / max(el, 1e-9),
                    100.0 * totals["num_mapped"]
                    / max(totals["num_processed"], 1))

    # depth-deep host/device pipeline: consume batch N-depth while N
    # runs (depth 1 = the reference's one-batch-stale online state;
    # SALMON_TPU_PIPE_DEPTH overrides opts.pipeline_depth)
    depth = max(1, int(os.environ.get("SALMON_TPU_PIPE_DEPTH",
                                      opts.pipeline_depth)))
    pending = collections.deque()
    # several input files: each reads group streams its own (the files
    # g::n_groups); one shared stream: each group packs and takes its
    # chunks of it
    own_files = multi and len(reads1) > 1
    pick = None
    if own_files:
        reads1 = list(reads1[group::n_groups])
        reads2 = list(reads2[group::n_groups]) if paired else None
        logger.info("reads group %d streams %d input files", group,
                    len(reads1))
    elif multi:
        def pick(i):
            return i % n_groups == group
    if paired:
        chunks = iter_paired_chunks(reads1, reads2, opts.reads_per_batch,
                                    opts.max_read_len, want_names, pick)
    else:
        chunks = iter_single_chunks(reads1, opts.reads_per_batch,
                                    opts.max_read_len, want_names, pick)
    chunks = _read_spans(chunks)
    if multi:
        # padding rows only: the narrowest width that holds a k-mer
        width = bucket_len(cfg.k, opts.max_read_len)
        chunks = _group_chunks(
            chunks, group, n_groups, own_files,
            lambda: _empty_chunk(paired, opts.reads_per_batch, width,
                                 want_names))
    profile_dir = getattr(opts, "profile_dir", None)
    prof = _start_profiler(profile_dir, device) if profile_dir else None
    # the card's interval of each batch step, on the host's clock
    events = (spans.BatchEvents(device, depth) if device.type == "cuda"
              else None)
    wide_events = (spans.BatchEvents(device, depth, "step.wide")
                   if wide is not None and device.type == "cuda" else None)
    # map_seconds less the set-up before the loop (the index's upload)
    t_loop = time.perf_counter()
    with spans.span("quant.loop"):
        for b, chunk in enumerate(chunks):
            with spans.span("quant.submit", b):
                chunk, batch, out, step_in = submit(chunk, b)
            if resolved_format is None:
                # detection batches run synchronously (reference
                # LibraryTypeDetector: 50k samples, neutral compat until
                # then)
                with spans.span("quant.detect", b):
                    detect_hist += _to_np(out["fmt_hist"]).astype(np.int64)
                if detect_hist.sum() >= DETECT_SAMPLES_NEEDED:
                    resolved_format = _detect_library_format(detect_hist,
                                                             paired)
                    logger.info("auto-detected library format: %s",
                                resolved_format)
                    compat = compat_tensors(
                        libformat.parse_library_format(resolved_format))
            pending.append((chunk, batch, out, b, step_in))
            if len(pending) > depth:
                consume(*pending.popleft())
        while pending:
            consume(*pending.popleft())
        while deferred:
            finish(*deferred.pop())
    if prof is not None:
        _stop_profiler(prof, profile_dir, device)
    for fh in (unmapped_fh, orphan_fh):
        if fh is not None:
            fh.close()
    if sam_fh is not None:
        if sam_path == "-":
            sam_fh.flush()
        else:
            sam_fh.close()
    # the spans' sums over this call's set-up and loop
    tot, cnt = spans.totals(span_base), spans.counters(count_base)

    def spent(name):
        return tot[name].seconds if name in tot else 0.0
    if want_names or orphan_fh is not None:
        side_clocks = {"side_output_seconds": spent("quant.side_outputs"),
                       "sam_write_seconds": spent("quant.sam_write")}
        logger.info("side output clocks (s): %s", side_clocks,
                    extra={"clocks": side_clocks})
    for st in graph_stats(dev):
        logger.info("batch step %s: %d eager, %d captured, %d replayed "
                    "(capture %.3f s, pool %d bytes)", st.label, st.eager,
                    st.captures, st.replays, st.capture_seconds,
                    st.pool_bytes)
    if auto_detect and resolved_format is None:
        resolved_format = _detect_library_format(detect_hist, paired)
        logger.info("auto-detected library format (short input): %s",
                    resolved_format)
    if wide is not None:
        corr = [wide_counts.astype(np.float64), wide_mass]
        if multi:
            corr = distributed.allreduce_histograms(corr)
        for k, v in zip(ROW_COUNTERS, corr[0]):
            totals[k] += int(round(v))
        online_mass += corr[1]
    map_seconds = time.perf_counter() - t0
    map_loop_seconds = time.perf_counter() - t_loop
    if wide_stats["frags_cut_wide"]:
        logger.warning(
            "%d fragments filled a cap of the wide pass (labels of at "
            "most %d transcripts); their labels may lack transcripts",
            wide_stats["frags_cut_wide"], wide.cfg.weight_width)
    if totals["seed_tail_over"]:
        logger.warning(
            "seed tail-gather budget saturated for %d k-mer windows "
            "(their occurrences past the first oct row were dropped)",
            totals["seed_tail_over"])
    if totals["num_mapped"] < opts.min_assigned_frags:
        raise InsufficientAssignedFragments(
            f"salmon_tpu_torch was only able to assign "
            f"{totals['num_mapped']} fragments (min required: "
            f"{opts.min_assigned_frags})")
    if multi:
        _merge_ranks(world, acc, bias_state, cfg.range_bins > 0)
        wclocks = {f"{k}_seconds": v
                   for k, v in world.read_clocks().items()}
        logger.info("multi-process clocks (s): %s", wclocks,
                    extra={"clocks": wclocks})

    eq = acc.finish()
    if opts.no_rich_eq_classes and eq.labels.shape[0]:
        # --noRichEqClasses: flat aux weights 1/|label|
        sz = np.repeat(eq.class_sizes.astype(np.float64), eq.class_sizes)
        eq = dataclasses.replace(eq, weights=1.0 / np.maximum(sz, 1.0))
    n_valid = index.num_valid_targets
    # single-end keeps the prior FLD (no paired observations), which the
    # reference likewise uses for its length correction
    fld_pmf = fld.pmf()
    eff = effective_lengths(
        np.asarray(index.lengths[:n_valid]), fld_pmf,
        no_length_correction=opts.no_length_correction,
        no_effective_length_correction=opts.no_effective_length_correction)
    emc = em_mod.EMConfig(
        use_vbem=opts.use_vb_opt and not opts.use_em,
        vb_prior=opts.vb_prior,
        per_transcript_prior=opts.per_transcript_prior,
        rel_diff_tolerance=opts.relative_diff_tolerance,
        max_iterations=opts.max_em_iterations,
        # reference: minIter 100 when bias-correcting, else 50
        # (CollapsedEMOptimizer.cpp:741-742)
        min_iterations=(opts.min_required_iterations if _bias_on(opts)
                        else opts.min_em_iterations))
    # normalizeAlphas (reference SalmonUtils.cpp:462-529)
    if eq.num_classes and online_mass[:n_valid].sum() > 0:
        online_mass = normalize_alphas(eq, n_valid, online_mass[:n_valid])
    else:
        om_sum = online_mass[:n_valid].sum()
        if om_sum > 0:
            online_mass = online_mass * (totals["num_mapped"] / om_sum)

    def optimize(eff_lens):
        return em_mod.optimize(
            eq, n_valid, eff_lens, online_mass=online_mass[:n_valid],
            total_mapped=float(totals["num_mapped"]), config=emc,
            init_uniform=opts.init_uniform,
            num_required_frags=opts.num_required_frags,
            alt_init=opts.alternative_init_mode or opts.meta_mode,
            device=device)

    t_em = time.perf_counter()
    clocks = {}
    em_runs = []     # each EM's result, for its loop's clocks
    if opts.skip_quant:
        res = {"alphas": np.zeros(n_valid), "iterations": 0,
               "max_rel_diff": 0.0, "converged": False, "skipped": True}
    else:
        res = optimize(eff)
        em_runs.append(res)
    if bias_state is not None and not opts.skip_quant:
        # bias-aware effective-length recompute + re-optimize (reference:
        # the mid-loop needsBiasLengthRecompute step,
        # CollapsedEMOptimizer.cpp:900-928)
        logger.info("recomputing effective lengths with bias models")
        eff2 = bias_state.corrected_effective_lengths(res["alphas"], eff,
                                                      fld_pmf)
        clocks = {"bias_collect_seconds": spent("quant.bias_collect"),
                  **{f"bias_{k}_seconds": v
                     for k, v in bias_state.seconds.items()},
                  **bias_state.graph_clocks(bdev)}
        if not np.allclose(eff2, eff):
            eff = eff2
            t_em2 = time.perf_counter()
            res = optimize(eff)
            em_runs.append(res)
            clocks["em2_seconds"] = time.perf_counter() - t_em2
        logger.info("bias correction clocks (s): %s", clocks,
                    extra={"clocks": clocks})
    res["map_seconds"] = map_seconds
    res["em_seconds"] = time.perf_counter() - t_em
    res.update(clocks)
    loop_clocks = {
        "read_seconds": spent("quant.read"),
        "submit_seconds": spent("quant.submit"),
        "device_wait_seconds": spent("quant.wait"),
        "eq_accumulate_seconds": spent("quant.eq"),
        "eq_dedupe_seconds": spent("eq.dedupe"),
        "eq_merge_seconds": spent("eq.merge"),
        "eq_merges": cnt.get("eq_merges", 0),
        "eq_rows_merged": cnt.get("eq_rows_merged", 0),
        "eq_rows_new": cnt.get("eq_rows_new", 0),
        "consume_seconds": spent("quant.consume") - spent("quant.eq"),
        "index_prep_seconds": spent("index.prep"),
        "index_h2d_seconds": spent("index.h2d"),
        "index_h2d_bytes": cnt.get("index_h2d_bytes", 0),
        "index_occ_max_seconds": spent("index.occ_max"),
        "frags_processed": totals["num_processed"],
        **wide_stats,
        "frags_wide_passes": cnt.get("frags_wide_passes", 0),
        "label_width_max": label_width_max,
        "wide_occ_cap": wide.cfg.occ_cap if wide is not None else 0,
        "wide_width": wide.cfg.weight_width if wide is not None else 0,
        "wide_seconds": spent("step.wide") + spent("quant.wide")}
    if events is not None:
        loop_clocks["step_device_seconds"] = events.total_ns * 1e-9
    if wide_events is not None:
        loop_clocks["wide_device_seconds"] = wide_events.total_ns * 1e-9
    run_clocks = {"map_seconds": map_seconds,
                  "map_loop_seconds": map_loop_seconds,
                  "mapped_batches": n_batches,
                  **loop_clocks,
                  **{f"graph_{k}": v
                     for k, v in stats_totals(graph_stats(dev)).items()},
                  "em_seconds": res["em_seconds"],
                  **em_mod.loop_clocks(em_runs)}
    logger.info("quantify clocks (s): %s", run_clocks,
                extra={"clocks": run_clocks})

    counts = res["alphas"]
    names = (libformat.format_names_paired() if paired
             else libformat.format_names_single())
    return QuantResult(
        names=index.names[:n_valid], counts=counts, eff_lens=eff,
        tpm=writers.compute_tpm(counts, eff),
        num_processed=totals["num_processed"],
        num_mapped=totals["num_mapped"],
        num_paired=totals["num_paired"],
        num_orphans=totals["num_orphans"],
        em_info=res,
        fmt_counts={nm: int(fmt_hist_total[i])
                    for i, nm in enumerate(names)},
        eq_classes=eq, fld=fld, lib_format=resolved_format,
        mapping_stats={k: totals[k] for k in (
            "num_decoy_fragments", "num_dovetail_fragments",
            "num_frags_filtered_vm", "num_alns_below_threshold")},
        num_batches=n_batches,
        num_orphans_rescued=totals["num_orphans_rescued"], paired=paired,
        bias=bias_state, aux_target_ids=aux_target_ids)


def _posterior_samples(result: QuantResult, opts: SalmonDefaults,
                       seed: int, device, stats: Optional[dict] = None):
    """Gibbs or bootstrap draws on `device` (reference:
    stageFinalizeMappingOutputs :63-98); `stats` receives the sampler's
    (its graph cache's counters among them). Returns (samples,
    samp_type) or (None, 'none')."""
    n = len(result.names)
    use_vb = opts.use_vb_opt and not opts.use_em
    if opts.num_gibbs_samples > 0:
        # Gibbs prior floors (reference CollapsedGibbsSampler::sample
        # :356-368)
        if use_vb:
            prior = max(opts.vb_prior, 1.0) if opts.per_transcript_prior \
                else max(opts.vb_prior, 1e-3)
        else:
            prior = 1e-3
        if not opts.per_transcript_prior:
            prior = prior * np.maximum(result.eff_lens, 1.0)
        samples = sampling.gibbs_samples(
            result.eq_classes, n, result.eff_lens, result.counts,
            opts.num_gibbs_samples, thinning=opts.thinning_factor,
            prior=prior, no_gamma_draw=opts.no_gamma_draw, seed=seed,
            device=device, stats=stats)
        return samples, "gibbs"
    if opts.num_bootstraps > 0:
        samples = sampling.bootstrap_samples(
            result.eq_classes, n, result.eff_lens, opts.num_bootstraps,
            use_vbem=use_vb, vb_prior=opts.vb_prior,
            per_transcript_prior=opts.per_transcript_prior,
            reproject=opts.bootstrap_reproject, seed=seed, device=device,
            stats=stats)
        return samples, "bootstrap"
    return None, "none"


def write_outputs(result: QuantResult, index: TranscriptomeIndex,
                  out_dir: str, opts: SalmonDefaults = DEFAULTS,
                  cmd_args: Optional[dict] = None,
                  dump_eq: bool = False,
                  dump_eq_weights: bool = True, seed: int = 271828,
                  device="cuda", mapping_type: str = "mapping") -> None:
    """Write the output directory (reference stageFinalizeMappingOutputs,
    MappingPipelineStages.cpp:37-203); Gibbs or bootstrap draws, when
    asked, run on `device`. mapping_type goes to meta_info.json
    ("mapping", or "alignment" from the -a driver)."""
    n_valid = index.num_valid_targets
    if not opts.skip_quant:
        writers.write_quant_sf(out_dir, result.names,
                               index.complete_lengths[:n_valid],
                               result.eff_lens, result.counts,
                               sig_digits=opts.sig_digits)
    writers.write_cmd_info(out_dir, cmd_args or {})
    if result.aux_target_ids is not None:
        d = os.path.join(out_dir, opts.aux_dir)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "aux_target_ids.json"), "w") as fh:
            json.dump({"aux_target_ids": result.aux_target_ids}, fh)
    # numCompat: observed formats compatible with the expected one
    # (reference ReadLibrary::numCompat via salmon::utils::compatibleHit)
    fmt = libformat.parse_library_format(result.lib_format)
    if result.paired:
        compat = libformat.paired_compat_table(fmt)
        names = libformat.format_names_paired()
    else:
        compat = libformat.single_compat_table(fmt)
        names = libformat.format_names_single()
    num_compat = sum(int(result.fmt_counts.get(nm, 0))
                     for i, nm in enumerate(names) if compat[i])
    writers.write_lib_format_counts(
        out_dir, result.lib_format, result.fmt_counts, num_compat,
        result.num_processed, result.num_mapped)
    aux = opts.aux_dir
    samples, samp_type = None, "none"
    if (result.eq_classes is not None and result.eq_classes.num_classes
            and not opts.skip_quant):
        t0 = time.perf_counter()
        samp = {}
        samples, samp_type = _posterior_samples(result, opts, seed, device,
                                                samp)
        if samples is not None:
            clocks = {"sampling_seconds": time.perf_counter() - t0,
                      **{f"sampling_{k}": v for k, v in samp.items()
                         if k != "graph"},
                      **{f"sampling_graph_{k}": v
                         for k, v in samp["graph"].items()}}
            logger.info("posterior sampling (%s, %d draws): %.3f s",
                        samp_type, samples.shape[0],
                        clocks["sampling_seconds"], extra={"clocks": clocks})
            writers.write_bootstraps(out_dir, aux, result.names, samples)
    pm = (100.0 * result.num_mapped / result.num_processed
          if result.num_processed else 0.0)
    writers.write_meta_info(out_dir, aux, {
        "opt_type": "vb" if (opts.use_vb_opt and not opts.use_em) else "em",
        "samp_type": samp_type,
        "num_bootstraps": (opts.num_gibbs_samples if samp_type == "gibbs"
                           else opts.num_bootstraps),
        "num_libraries": 1,
        "library_types": [result.lib_format],
        "frag_dist_length": opts.max_frag_length + 1,
        "seq_bias_correct": opts.seq_bias_correct,
        "gc_bias_correct": opts.gc_bias_correct,
        "pos_bias_correct": opts.pos_bias_correct,
        # which positional estimator ran: "reference-parity" reproduces
        # the reference algorithm; "corrected" (--posBiasCorrected) is
        # the fw-marginal estimator with knots at the bin centres
        "pos_bias_mode": (
            "corrected" if opts.pos_bias_corrected
            else "reference-parity") if opts.pos_bias_correct else "off",
        "num_bias_bins": 4096,
        "mapping_type": mapping_type,
        "keep_duplicates": index.info.get("keep_duplicates", True),
        "num_valid_targets": n_valid,
        "num_decoy_targets": index.num_targets - n_valid,
        "num_eq_classes": result.eq_classes.num_classes
        if result.eq_classes is not None else 0,
        "serialized_eq_classes": dump_eq,
        "eq_class_properties": ["range_factorized"]
        if opts.range_factorization_bins > 0 else [],
        "length_classes": [],
        "index_seq_hash": index.info.get("SeqHash256", ""),
        "index_name_hash": index.info.get("NameHash256", ""),
        "index_seq_hash512": index.info.get("SeqHash512", ""),
        "index_name_hash512": index.info.get("NameHash512", ""),
        "index_decoy_seq_hash": index.info.get("DecoySeqHash", ""),
        "index_decoy_name_hash": index.info.get("DecoyNameHash", ""),
        "num_targets": index.num_targets,
        "num_processed": result.num_processed,
        "num_mapped": result.num_mapped,
        "num_orphans_rescued": result.num_orphans_rescued,
        "num_decoy_fragments":
        result.mapping_stats.get("num_decoy_fragments", 0),
        "num_dovetail_fragments":
        result.mapping_stats.get("num_dovetail_fragments", 0),
        "num_fragments_filtered_vm":
        result.mapping_stats.get("num_frags_filtered_vm", 0),
        "num_alignments_below_threshold_for_mapped_fragments_vm":
        result.mapping_stats.get("num_alns_below_threshold", 0),
        "percent_mapped": pm,
        "call": "quant",
        "num_em_iterations": result.em_info.get("iterations", 0),
        "em_converged": result.em_info.get("converged", False),
        "frag_length_mean": (result.fld.summary()["mean"]
                             if result.fld else 0.0),
        "frag_length_sd": (result.fld.summary()["sd"]
                           if result.fld else 0.0),
    })
    if result.fld is not None:
        writers.write_fld(out_dir, aux, result.fld.pmf())
    writers.write_vestigial_bias_vectors(out_dir, aux)
    if result.bias is not None:
        writers.write_bias_models(out_dir, aux, result.bias, opts)
    if result.eq_classes is not None:
        writers.write_ambig_info(out_dir, aux, n_valid, result.eq_classes)
        if dump_eq:
            writers.write_eq_classes(out_dir, aux, result.names,
                                     result.eq_classes,
                                     dump_weights=dump_eq_weights,
                                     eff_lens=result.eff_lens)
