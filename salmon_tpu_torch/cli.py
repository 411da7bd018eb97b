"""Command-line interface of the port: `python -m salmon_tpu_torch`.

Counterpart of salmon_tpu/cli.py (reference src/cli/Salmon.cpp:161-327
and src/cli/ProgramOptionsGenerator.cpp). The flag surface is the JAX
package's, so a command line switches by replacing the module name.
The port runs `index` (partitioned by canonical top bits from 1.5 Gb of
input, and table-less past 800 M keys, as the JAX package's), `quant`
in its three modes (mapping mode on
paired-end -1/-2 or single-end -r reads, with the dense or the sparse
seed flow and the side outputs --writeMappings, --writeUnmappedNames,
--writeOrphanLinks and --profileDir; alignment mode -a/-t and eq-class
mode -e; bias correction, Gibbs or bootstrap draws and --geneMap) on a
CUDA device, `quantmerge` on the host, and the `alevin` stub and `swim`.
`quant` also runs in several processes, one per device, under the JAX
package's launch variables (parallel.distributed, parallel.launch):
data-parallel, or with the index sharded over the processes
(--indexShards, which table-less genome-scale indexes need); rank 0
writes the outputs. Single-end --writeMappings raises
NotImplementedError naming its ROADMAP item.
`index`, `quant` and `quantmerge` check online for a newer salmon
version, as the JAX package does, unless --no-version-check is given or
SALMON_NO_VERSION_CHECK is 1, TRUE or T.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from salmon_tpu_torch import __version__
from salmon_tpu_torch.constants import SalmonDefaults

logger = logging.getLogger("salmon_tpu_torch")


def _setup_logging(out_dir: str | None = None) -> None:
    """Console + logs/salmon_quant.log (reference processQuantOptions,
    QuantOptionsUtils.cpp:304-354)."""
    handlers = [logging.StreamHandler(sys.stderr)]
    if out_dir:
        log_dir = os.path.join(out_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        handlers.append(logging.FileHandler(
            os.path.join(log_dir, "salmon_quant.log")))
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s",
        handlers=handlers, force=True)


def _add_index_parser(sub):
    p = sub.add_parser("index", help="create a salmon index")
    p.add_argument("--no-version-check", action="store_true")
    p.add_argument("-t", "--transcripts", required=True)
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-k", "--kmerLen", type=int, default=31)
    p.add_argument("-d", "--decoys", default=None,
                   help="file listing decoy sequence names")
    p.add_argument("--gencode", action="store_true")
    p.add_argument("--features", action="store_true",
                   help="(accepted; feature-barcode input unsupported)")
    p.add_argument("--keepDuplicates", action="store_true")
    p.add_argument("-p", "--threads", type=int, default=2)
    p.add_argument("--maxOccsKept", type=int, default=0,
                   help="store at most this many occurrence records per "
                        "k-mer (0 = all). Query-identical for any "
                        "occ_cap <= this value: the repetitive-seed "
                        "filter still sees true counts via the table "
                        "row. Cuts genome-decoy index size sharply "
                        "(repeat k-mers dominate the CSR)")
    p.add_argument("--filterSize", type=int, default=-1,
                   help="(accepted; no Bloom pre-filter in this index)")
    p.add_argument("--tmpdir", default=None)
    p.add_argument("--no-clip", dest="noClip", action="store_true",
                   help="do not clip poly-A tails")
    p.add_argument("-m", "--minimizerLen", type=int, default=19,
                   help="(accepted; this index is not minimizer-based)")
    return p


def _add_quant_shared(p):
    """Flags shared between mapping and alignment quant modes."""
    p.add_argument("-l", "--libType", default="A")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-p", "--threads", type=int, default=8)
    p.add_argument("--seqBias", action="store_true")
    p.add_argument("--gcBias", action="store_true")
    p.add_argument("--posBias", action="store_true")
    p.add_argument("--posBiasCorrected", action="store_true",
                   help="positional bias with the corrected estimator "
                        "(fw-marginal only + spline knots matching the "
                        "accumulation bins); --posBias alone reproduces "
                        "the reference algorithm exactly, whose gain is "
                        "negative under generative positional bias "
                        "(see scripts/posbias_reference_trace.py)")
    p.add_argument("--incompatPrior", type=float, default=0.0)
    p.add_argument("-g", "--geneMap", default=None)
    p.add_argument("--meta", action="store_true")
    p.add_argument("--dumpEq", action="store_true")
    p.add_argument("-d", "--dumpEqWeights", action="store_true")
    p.add_argument("--minAssignedFrags", type=int, default=10)
    p.add_argument("--useEM", action="store_true")
    p.add_argument("--useVBOpt", action="store_true", default=True)
    p.add_argument("--noLengthCorrection", action="store_true")
    p.add_argument("--noEffectiveLengthCorrection", action="store_true")
    p.add_argument("--noFragLengthDist", action="store_true")
    p.add_argument("--noSingleFragProb", action="store_true")
    p.add_argument("--rangeFactorizationBins", type=int, default=4)
    p.add_argument("--numBootstraps", type=int, default=0)
    p.add_argument("--numGibbsSamples", type=int, default=0)
    p.add_argument("--thinningFactor", type=int, default=16)
    p.add_argument("--noGammaDraw", action="store_true")
    p.add_argument("--bootstrapReproject", action="store_true")
    p.add_argument("--vbPrior", type=float, default=1e-2)
    p.add_argument("--perTranscriptPrior", action="store_true",
                   default=True)
    p.add_argument("--perNucleotidePrior", action="store_true")
    p.add_argument("--sigDigits", type=int, default=3)
    p.add_argument("--initUniform", action="store_true")
    p.add_argument("--fldMax", type=int, default=1000)
    p.add_argument("--fldMean", type=float, default=250.0)
    p.add_argument("--fldSD", type=float, default=25.0)
    p.add_argument("--forgettingFactor", type=float, default=0.65)
    p.add_argument("--numBurninFrags", type=int, default=5_000_000)
    p.add_argument("--numPreAuxModelSamples", type=int, default=5000)
    p.add_argument("--dontExtrapolateCounts", "--noExtrapolateCounts",
                   action="store_true")
    p.add_argument("--numGCBins", type=int, default=25)
    p.add_argument("--conditionalGCBins", type=int, default=3)
    p.add_argument("--noBiasLengthThreshold", action="store_true")
    p.add_argument("--alternativeInitMode", action="store_true")
    p.add_argument("--noRichEqClasses", action="store_true")
    p.add_argument("--rankEqClasses", action="store_true",
                   help="[unsupported] experimental rank-ordered eq "
                        "labels; hard error if set")
    p.add_argument("--noFragLenFactor", action="store_true",
                   help="accepted for compatibility; vestigial in the "
                        "reference too (the field is never read)")
    p.add_argument("-n", "--numRequiredObs", type=float, default=5e7)
    p.add_argument("--maxRecoverReadOcc", type=int, default=2500)
    p.add_argument("--auxDir", default="aux_info")
    p.add_argument("--readBatchSize", type=int, default=0,
                   help="reads per device batch (0 = default)")
    p.add_argument("--adaptiveReadBatch", action="store_true",
                   help="accepted for compatibility; batches are "
                        "fixed-shape device programs here, so there is "
                        "nothing to adapt")
    p.add_argument("--maxHashResizeThreads", type=int, default=0,
                   help="accepted for compatibility; no host hash "
                        "resizing exists in this engine")
    p.add_argument("--disableLiveProgress", action="store_true")
    p.add_argument("--progressUpdateMs", type=int, default=5000)
    p.add_argument("--emitJoinDedupStats", action="store_true",
                   help="accepted for compatibility; the sort-merge "
                        "pair join emits unique (txp,pos) pairs by "
                        "construction, so there are no dedup events "
                        "to report")
    p.add_argument("--seed", type=int, default=271828,
                   help="RNG seed for Gibbs/bootstrap draws")
    p.add_argument("--no-version-check", action="store_true")
    p.add_argument("--profileDir", default=None,
                   help="write a torch.profiler trace of the mapping loop "
                        "(host activity, and the CUDA kernels on the "
                        "card) to this directory as a Chrome trace JSON "
                        "(open with chrome://tracing or Perfetto)")
    p.add_argument("-q", "--quiet", action="store_true")


def _add_quant_parser(sub):
    p = sub.add_parser(
        "quant", help="quantify a sample",
        description="Mapping-based mode: -i index + -1/-2 or -r reads. "
        "Alignment-based mode: -a alignments + -t targets. "
        "Eq-class mode: -e eq_classes directory.")
    # mapping-mode input
    p.add_argument("-i", "--index", default=None)
    p.add_argument("-1", "--mates1", nargs="+", default=None)
    p.add_argument("-2", "--mates2", nargs="+", default=None)
    p.add_argument("-r", "--unmatedReads", nargs="+", default=None)
    # alignment-mode input
    p.add_argument("-a", "--alignments", nargs="+", default=None)
    p.add_argument("-t", "--targets", default=None)
    p.add_argument("-e", "--eqclasses", default=None)
    p.add_argument("--ont", action="store_true")
    p.add_argument("--sampleOut", action="store_true")
    p.add_argument("--sampleUnaligned", action="store_true")
    p.add_argument("--noErrorModel", action="store_true")
    p.add_argument("--numErrorBins", type=int, default=6)
    p.add_argument("--mappingCacheMemoryLimit", type=int, default=2000000)
    # mapping-specific
    p.add_argument("--validateMappings", action="store_true", default=True)
    p.add_argument("--minScoreFraction", type=float, default=0.65)
    p.add_argument("--consensusSlack", type=float, default=0.35)
    p.add_argument("--preMergeChainSubThresh", type=float, default=0.75)
    p.add_argument("--postMergeChainSubThresh", type=float, default=0.9)
    p.add_argument("--orphanChainSubThresh", type=float, default=0.95)
    p.add_argument("--scoreExp", type=float, default=1.0)
    p.add_argument("--ma", "--matchScore", dest="matchScore", type=int,
                   default=2)
    p.add_argument("--mp", "--mismatchPenalty", dest="mismatchPenalty",
                   type=int, default=-4)
    p.add_argument("--go", "--gapOpenPenalty", dest="gapOpenPenalty",
                   type=int, default=6)
    p.add_argument("--ge", "--gapExtendPenalty", dest="gapExtendPenalty",
                   type=int, default=2)
    p.add_argument("--bandwidth", type=int, default=15)
    p.add_argument("--mismatchSeedSkip", type=int, default=3)
    p.add_argument("--indexShards", type=int, default=1,
                   help="split the k-mer dictionary/occurrences over this"
                        " many devices (a power of two dividing the"
                        " number of processes of the launch)")
    p.add_argument("--disableChainingHeuristic", action="store_true")
    p.add_argument("--disableAlignmentCache", action="store_true")
    p.add_argument("--decoyThreshold", type=float, default=1.0)
    p.add_argument("--minAlnProb", type=float, default=1e-5)
    p.add_argument("--maxReadOcc", type=int, default=200)
    p.add_argument("--maxOccsPerHit", type=int, default=1000)
    p.add_argument("--hardFilter", action="store_true")
    p.add_argument("--softclip", action="store_true")
    p.add_argument("--softclipOverhangs", action="store_true")
    p.add_argument("--fullLengthAlignment", action="store_true")
    p.add_argument("--allowDovetail", action="store_true")
    p.add_argument("--discardOrphans", "--discardOrphansQuasi",
                   action="store_true")
    p.add_argument("--recoverOrphans", action="store_true")
    p.add_argument("--mimicBT2", action="store_true")
    p.add_argument("--mimicStrictBT2", action="store_true")
    p.add_argument("--hitFilterPolicy", default="AFTER",
                   choices=["AFTER", "BEFORE", "BOTH", "NONE"])
    p.add_argument("--writeMappings", nargs="?", const="-", default=None)
    p.add_argument("--writeQualities", action="store_true")
    p.add_argument("--writeUnmappedNames", action="store_true")
    p.add_argument("--writeOrphanLinks", action="store_true")
    p.add_argument("--skipQuant", action="store_true")
    p.add_argument("--reduceGCMemory", action="store_true")
    p.add_argument("--biasSpeedSamp", type=int, default=5)
    p.add_argument("--numBiasSamples", type=int, default=2_000_000)
    p.add_argument("--numAuxModelSamples", type=int, default=5_000_000)
    p.add_argument("--auxTargetFile", default=None)
    p.add_argument("--minAlnProbSE", type=float, default=None,
                   help=argparse.SUPPRESS)
    _add_quant_shared(p)
    return p


def _add_quantmerge_parser(sub):
    p = sub.add_parser("quantmerge",
                       help="merge multiple quantifications into a matrix")
    p.add_argument("--no-version-check", action="store_true")
    p.add_argument("--quants", nargs="+", required=True)
    p.add_argument("--names", nargs="+", default=None)
    p.add_argument("-c", "--column", default="TPM",
                   choices=["len", "elen", "tpm", "numreads",
                            "TPM", "NumReads"])
    p.add_argument("--genes", action="store_true")
    p.add_argument("--missing", default="NA")
    p.add_argument("-o", "--output", required=True)
    return p


def _opts_from_args(args):
    o = SalmonDefaults()
    o.seq_bias_correct = args.seqBias
    o.gc_bias_correct = args.gcBias
    o.pos_bias_correct = args.posBias or args.posBiasCorrected
    o.pos_bias_corrected = args.posBiasCorrected
    o.incompat_prior = args.incompatPrior
    o.use_em = args.useEM
    o.use_vb_opt = not args.useEM
    o.vb_prior = args.vbPrior
    o.per_transcript_prior = (args.perTranscriptPrior
                              and not args.perNucleotidePrior)
    o.per_nucleotide_prior = args.perNucleotidePrior
    o.range_factorization_bins = args.rangeFactorizationBins
    o.num_bootstraps = args.numBootstraps
    o.num_gibbs_samples = args.numGibbsSamples
    o.thinning_factor = args.thinningFactor
    o.no_gamma_draw = args.noGammaDraw
    o.bootstrap_reproject = args.bootstrapReproject
    o.sig_digits = args.sigDigits
    o.init_uniform = args.initUniform
    o.max_frag_length = args.fldMax
    o.frag_len_prior_mean = args.fldMean
    o.frag_len_prior_sd = args.fldSD
    o.forgetting_factor = args.forgettingFactor
    o.num_burnin_frags = args.numBurninFrags
    o.min_assigned_frags = args.minAssignedFrags
    o.no_length_correction = args.noLengthCorrection
    o.no_effective_length_correction = args.noEffectiveLengthCorrection
    o.no_frag_length_dist = args.noFragLengthDist
    o.no_single_frag_prob = args.noSingleFragProb
    if getattr(args, "rankEqClasses", False):
        raise SystemExit(
            "--rankEqClasses (experimental rank-ordered equivalence "
            "class labels) is not supported")
    o.dont_extrapolate_counts = args.dontExtrapolateCounts
    o.num_gc_bins = args.numGCBins
    o.conditional_gc_bins = args.conditionalGCBins
    o.no_bias_length_threshold = args.noBiasLengthThreshold
    o.alternative_init_mode = args.alternativeInitMode
    o.meta_mode = args.meta
    o.no_rich_eq_classes = args.noRichEqClasses
    o.num_required_frags = args.numRequiredObs
    o.max_recover_read_occ = args.maxRecoverReadOcc
    o.aux_dir = args.auxDir
    if args.readBatchSize > 0:
        o.reads_per_batch = args.readBatchSize
    o.disable_live_progress = args.disableLiveProgress
    o.progress_update_ms = args.progressUpdateMs
    if getattr(args, "minScoreFraction", None) is not None:
        o.min_score_fraction = args.minScoreFraction
        o.consensus_slack = args.consensusSlack
        o.score_exp = args.scoreExp
        o.match_score = args.matchScore
        o.mismatch_penalty = args.mismatchPenalty
        o.gap_open_penalty = args.gapOpenPenalty
        o.gap_extend_penalty = args.gapExtendPenalty
        o.dp_bandwidth = args.bandwidth
        o.decoy_threshold = args.decoyThreshold
        o.min_aln_prob = args.minAlnProb
        o.max_read_occs = args.maxReadOcc
        o.max_occs_per_hit = args.maxOccsPerHit
        o.hard_filter = args.hardFilter
        o.softclip = args.softclip
        o.softclip_overhangs = args.softclipOverhangs
        o.full_length_alignment = args.fullLengthAlignment
        o.allow_dovetail = args.allowDovetail
        o.discard_orphans = args.discardOrphans
        o.recover_orphans = args.recoverOrphans
        o.mismatch_seed_skip = args.mismatchSeedSkip
        # the seed-skip stride IS the mismatchSeedSkip analog: it sets the
        # base-position step between queried k-mer windows
        o.kmer_stride = max(1, args.mismatchSeedSkip)
        o.index_shards = args.indexShards
        o.profile_dir = getattr(args, "profileDir", None)
        o.hit_filter_policy = args.hitFilterPolicy
        o.mimic_bt2 = args.mimicBT2
        o.mimic_strict_bt2 = args.mimicStrictBT2
        o.write_orphan_links = args.writeOrphanLinks
        o.skip_quant = args.skipQuant
        o.aux_target_file = args.auxTargetFile or ""
        o.alignment_cache = not args.disableAlignmentCache
        _process_quant_options(o)
    return o


def _process_quant_options(o) -> None:
    """Option-interaction rules (reference processQuantOptions,
    QuantOptionsUtils.cpp:105-296)."""
    if getattr(o, "meta_mode", False):
        # --meta implications (QuantOptionsUtils.cpp:449-454)
        o.init_uniform = True
        o.no_rich_eq_classes = True
        o.use_em = True
    if o.gc_bias_correct and not o.seq_bias_correct:
        # gcBias without seqBias collapses the conditional GC axis
        # (QuantOptionsUtils.cpp:505-507)
        o.conditional_gc_bins = 1
    if o.mimic_bt2 and o.mimic_strict_bt2:
        raise SystemExit(
            "You passed both the --mimicBT2 and --mimicStrictBT2 "
            "parameters. These are mutually exclusive.")
    if o.mimic_bt2 or o.mimic_strict_bt2 or o.hard_filter:
        # these flags imply mapping validation (:105-109)
        o.validate_mappings = True
    if o.mimic_bt2 or o.mimic_strict_bt2:
        # Bowtie2-like presets (:256-293)
        o.max_read_occs = 1000
        o.consensus_slack = 0.5
        o.discard_orphans = True
        o.softclip_overhangs = False
        if o.mimic_bt2:
            o.match_score = 2
            o.mismatch_penalty = -4
            o.gap_open_penalty = 5
            o.gap_extend_penalty = 3
        else:
            o.min_score_fraction = 0.8
            o.match_score = 1
            o.mismatch_penalty = 0
            o.gap_open_penalty = 25
            o.gap_extend_penalty = 25
    if o.hit_filter_policy != "AFTER":
        # this engine scores whole candidate sets in fixed-shape tensors;
        # there is no pre-chaining hit filter stage to reorder
        raise SystemExit(
            f"--hitFilterPolicy {o.hit_filter_policy} is not supported by "
            "salmon_tpu_torch (only AFTER, the reference default)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="salmon-tpu-torch",
        description="salmon_tpu_torch v%s — transcript quantification on "
        "a CUDA device (selective alignment + collapsed VBEM)"
        % __version__)
    ap.add_argument("-v", "--version", action="version",
                    version=f"salmon_tpu_torch {__version__}")
    sub = ap.add_subparsers(dest="command")
    _add_index_parser(sub)
    _add_quant_parser(sub)
    _add_quantmerge_parser(sub)
    sub.add_parser("alevin", help="(removed upstream; stub)")
    sub.add_parser("swim", help="perform super-secret operation")
    return ap


def cmd_index(args) -> int:
    from salmon_tpu_torch.index.builder import build_index, save_index

    _setup_logging()
    logger.info("building index from %s (k=%d)", args.transcripts,
                args.kmerLen)
    idx = build_index(
        args.transcripts, k=args.kmerLen,
        decoy_names_path=args.decoys, gencode=args.gencode,
        keep_duplicates=args.keepDuplicates, noclip_polya=args.noClip,
        max_occs_kept=args.maxOccsKept)
    save_index(idx, args.index)
    logger.info("index written to %s (%d targets, %d decoys, %d k-mers)",
                args.index, idx.num_valid_targets,
                idx.num_targets - idx.num_valid_targets,
                idx.kmers.shape[0])
    return 0


def cmd_quant(args, device=None) -> int:
    from salmon_tpu_torch.parallel.distributed import (init_from_env,
                                                       process_info)
    world = init_from_env(device)
    if world is not None:
        device = world.device
    elif device is None:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(
                "salmon_tpu_torch quant needs a CUDA device and none is "
                "visible (the JAX package, python -m salmon_tpu, runs on "
                "other hardware)")
        device = "cuda"
    _setup_logging(args.output)
    cmd_args = {k: v for k, v in vars(args).items()
                if v is not None and k != "command"}

    if args.eqclasses:
        from salmon_tpu_torch.alignment.eqmode import quantify_eqclasses
        return quantify_eqclasses(args, _opts_from_args(args), cmd_args,
                                  device)
    if args.alignments:
        from salmon_tpu_torch.alignment.quant import quantify_alignments
        return quantify_alignments(args, _opts_from_args(args), cmd_args,
                                   device)

    if not args.index:
        logger.error("mapping-based mode requires -i/--index")
        return 1
    if not (args.mates1 and args.mates2) and not args.unmatedReads:
        logger.error("provide -1/-2 (paired) or -r (single-end) reads")
        return 1
    # up-front input checks (ReadLibrary::checkValid role,
    # ReadLibrary.hpp:130-170): fail before loading the index
    import stat as _stat
    for path in ((args.mates1 or []) + (args.mates2 or [])
                 + (args.unmatedReads or [])):
        try:
            st = os.stat(path)
        except OSError as e:
            logger.error("cannot read input %s: %s", path, e.strerror)
            return 1
        if not (_stat.S_ISREG(st.st_mode) or _stat.S_ISFIFO(st.st_mode)):
            logger.error("input %s is neither a regular file nor a "
                         "FIFO", path)
            return 1
    if args.mates1 and args.mates2 and \
            len(args.mates1) != len(args.mates2):
        logger.error("-1 and -2 must list the same number of files "
                     "(%d vs %d)", len(args.mates1), len(args.mates2))
        return 1

    from salmon_tpu_torch.index.builder import load_index
    from salmon_tpu_torch.io import writers
    from salmon_tpu_torch.quant import (InsufficientAssignedFragments,
                                        quantify, write_outputs)

    opts = _opts_from_args(args)
    index = load_index(args.index)
    unmapped_path = orphan_links_path = None
    aux = os.path.join(args.output, args.auxDir)
    # each process of a launch writes its own fragments' side outputs
    rank, n_procs = process_info()
    suffix = f".{rank}" if n_procs > 1 else ""
    if args.writeUnmappedNames:
        os.makedirs(aux, exist_ok=True)
        unmapped_path = os.path.join(aux, f"unmapped_names.txt{suffix}")
    if args.writeOrphanLinks:
        os.makedirs(aux, exist_ok=True)
        orphan_links_path = os.path.join(aux, f"orphan_links.txt{suffix}")
    try:
        result = quantify(index, args.libType,
                          args.mates1 or args.unmatedReads, args.mates2,
                          opts=opts, progress=not args.quiet,
                          unmapped_path=unmapped_path,
                          sam_path=args.writeMappings,
                          orphan_links_path=orphan_links_path,
                          device=device, world=world)
    except InsufficientAssignedFragments as e:
        logger.error(str(e))
        n = index.num_valid_targets
        writers.write_empty_outputs(args.output, args.auxDir,
                                    index.names[:n],
                                    index.complete_lengths[:n])
        return 1
    if rank != 0:
        # every rank holds the same result; rank 0 writes it
        logger.info("process %d done (rank 0 writes the outputs)", rank)
        return 0
    write_outputs(result, index, args.output, opts=opts,
                  cmd_args=cmd_args,
                  dump_eq=args.dumpEq or args.dumpEqWeights,
                  dump_eq_weights=args.dumpEqWeights, seed=args.seed,
                  device=device)
    if args.geneMap and not opts.skip_quant:
        from salmon_tpu_torch.utils.genemap import aggregate_quant_sf
        aggregate_quant_sf(os.path.join(args.output, "quant.sf"),
                           args.geneMap)
    logger.info("quantification written to %s", args.output)
    return 0


def cmd_quantmerge(args) -> int:
    """Merge one column of several quantifications into a matrix, on the
    host (reference src/commands/SalmonQuantMerge.cpp:219; the JAX
    package's cmd_quantmerge, salmon_tpu/cli.py:507-559). With --genes,
    a sample without quant.genes.sf is rolled up from its quant.sf
    through the gene map its cmd_info.json names."""
    from salmon_tpu_torch.io.writers import read_quant_sf

    _setup_logging()
    col_map = {"len": "Length", "elen": "EffectiveLength", "tpm": "TPM",
               "TPM": "TPM", "numreads": "NumReads",
               "NumReads": "NumReads"}
    col = col_map[args.column]
    names = args.names or [os.path.basename(os.path.normpath(q))
                           for q in args.quants]
    if len(names) != len(args.quants):
        logger.error("--names length must match --quants")
        return 1
    fname = "quant.genes.sf" if args.genes else "quant.sf"
    tables = []
    for q in args.quants:
        path = os.path.join(q, fname)
        if not os.path.exists(path) and args.genes:
            ci = os.path.join(q, "cmd_info.json")
            gm = None
            if os.path.exists(ci):
                with open(ci) as fh:
                    gm = json.load(fh).get("geneMap")
            if gm and os.path.exists(gm):
                from salmon_tpu_torch.utils.genemap import aggregate_quant_sf
                logger.info("deriving %s from quant.sf via %s", path, gm)
                aggregate_quant_sf(os.path.join(q, "quant.sf"), gm)
        if not os.path.exists(path):
            logger.error("missing %s", path)
            return 1
        tables.append(read_quant_sf(path))
    all_targets = list(dict.fromkeys(nm for t in tables for nm in t["Name"]))
    per_sample = [dict(zip(t["Name"], t[col])) for t in tables]
    with open(args.output, "w") as fh:
        fh.write("Name\t" + "\t".join(names) + "\n")
        for tgt in all_targets:
            row = [tgt]
            for s in per_sample:
                v = s.get(tgt)
                row.append(args.missing if v is None else f"{v:g}")
            fh.write("\t".join(row) + "\n")
    logger.info("merged %d samples x %d targets -> %s", len(tables),
                len(all_targets), args.output)
    return 0


def cmd_alevin() -> int:
    """Reference: src/commands/AlevinRemoved.cpp:7-18."""
    sys.stderr.write(
        "The single-cell processing functionality (alevin) was removed "
        "upstream in this refactor line and is not part of salmon_tpu.\n"
        "Please use alevin-fry (https://github.com/COMBINE-lab/alevin-fry) "
        "for single-cell quantification.\n")
    return 1


def cmd_swim() -> int:
    sys.stdout.write(r"""
    _____       .__
   /  ___
   \___ \_____  |  |  _____   ____   ____      TPU
  /____  \__  \ |  |  /     \ /  _ \ /    \    ~~~~~>
 /       \/ __ \|  |_|  Y Y  (  <_> )   |  \   ><(((°>
/______  (____  /____/__|_|  /\____/|___|  /
       \/     \/           \/            \/
""")
    return 0


def _version_message(timeout_s: float = 2.0) -> str:
    """Best-effort version check (reference getVersionMessage,
    src/cli/VersionChecker.cpp:5-31): GET
    combine-lab.github.io/salmon/version_info/<version> with a 2 s
    timeout; any failure (offline machines included) gives the
    reference's exception line, never an error."""
    try:
        from urllib.request import urlopen
        url = ("https://combine-lab.github.io/salmon/version_info/"
               + __version__)
        with urlopen(url, timeout=timeout_s) as res:
            if res.status == 200:
                return "Version Info: " + res.read().decode(
                    "utf-8", "replace")
            return f"Version Server Response: {res.reason}\n"
    except Exception as e:  # timeout, DNS failure, no route, ...
        return f"Version Info Exception: {e}\n"


def _skip_version_check(args) -> bool:
    """The --no-version-check flag, SALMON_NO_VERSION_CHECK (1, TRUE or
    T, any case) and the alevin command skip the check (reference
    Salmon.cpp:218-231)."""
    env = os.environ.get("SALMON_NO_VERSION_CHECK", "").upper()
    return (getattr(args, "no_version_check", False)
            or env in ("1", "TRUE", "T")
            or args.command == "alevin")


def main(argv=None, device=None) -> int:
    """Run one command. `device` (a torch device, e.g. "cpu") places the
    quant work; by default it is the CUDA device, and quant raises when
    there is none."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.command in ("index", "quant", "quantmerge") \
            and not _skip_version_check(args):
        sys.stderr.write(_version_message())
    if args.command == "index":
        return cmd_index(args)
    if args.command == "quant":
        return cmd_quant(args, device)
    if args.command == "quantmerge":
        return cmd_quantmerge(args)
    if args.command == "alevin":
        return cmd_alevin()
    if args.command == "swim":
        return cmd_swim()
    ap.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
