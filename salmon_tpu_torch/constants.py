"""Central defaults and configuration for salmon_tpu_torch.

Mirrors the semantics of the reference defaults
(include/salmon/internal/config/SalmonDefaults.hpp:24-116) plus the
shape/batching knobs of the JAX package, which the port shares so both
packages map the same batches the same way (the reference is thread-pool
based; both packages are fixed-shape batch based).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SalmonDefaults:
    """Quantification defaults (reference: SalmonDefaults.hpp)."""

    # --- general -----------------------------------------------------
    seq_bias_correct: bool = False
    gc_bias_correct: bool = False
    pos_bias_correct: bool = False
    # corrected positional-bias estimator (--posBiasCorrected): fixes
    # the two reference defects root-caused in
    # scripts/posbias_reference_trace.py (fw x rc double count; uniform
    # bins projected through non-uniform Cufflinks spline knots). OFF by
    # default: plain --posBias stays reference-parity, defects included.
    pos_bias_corrected: bool = False
    num_threads: int = 8
    incompat_prior: float = 0.0
    discard_orphans: bool = False

    # --- mapping / selective alignment -------------------------------
    validate_mappings: bool = True
    consensus_slack: float = 0.35
    min_score_fraction: float = 0.65
    pre_merge_chain_sub_thresh: float = 0.75
    post_merge_chain_sub_thresh: float = 0.9
    orphan_chain_sub_thresh: float = 0.95
    score_exp: float = 1.0
    match_score: int = 2
    mismatch_penalty: int = -4
    gap_open_penalty: int = 6
    gap_extend_penalty: int = 2
    dp_bandwidth: int = 15
    mismatch_seed_skip: int = 3
    hard_filter: bool = False
    softclip: bool = False
    softclip_overhangs: bool = False
    full_length_alignment: bool = False
    allow_dovetail: bool = False
    recover_orphans: bool = False
    max_recover_read_occ: int = 2500     # --maxRecoverReadOcc (orphan-rescue occ gate)
    # full-coverage candidates skip DP with the perfect score (the
    # reference's alignment-cache role; --disableAlignmentCache)
    alignment_cache: bool = True
    rescue_bandwidth: int = 80           # rescue DP band (~3 sigma of FLD)
    rescue_probes: int = 3               # FLD-quantile positions probed per orphan (1 = mean only)
    max_read_occs: int = 200
    max_occs_per_hit: int = 1000
    decoy_threshold: float = 1.0
    min_aln_prob: float = 1e-5
    hit_filter_policy: str = "AFTER"
    mimic_bt2: bool = False
    mimic_strict_bt2: bool = False
    write_orphan_links: bool = False
    skip_quant: bool = False
    aux_target_file: str = ""

    # --- fragment length distribution ---------------------------------
    max_frag_length: int = 1000          # fldMax
    frag_len_prior_mean: float = 250.0   # fldMean
    frag_len_prior_sd: float = 25.0      # fldSD
    no_frag_length_dist: bool = False
    no_single_frag_prob: bool = False
    no_length_correction: bool = False
    no_effective_length_correction: bool = False

    # --- online inference ---------------------------------------------
    forgetting_factor: float = 0.65      # ffactor
    num_burnin_frags: int = 5_000_000
    num_pre_burnin_frags: int = 5_000
    num_bias_samples: int = 2_000_000
    min_assigned_frags: int = 10
    init_uniform: bool = False

    # --- offline inference ----------------------------------------------
    use_em: bool = False                 # default is VBEM (useVBOpt=true)
    use_vb_opt: bool = True
    vb_prior: float = 1e-2
    per_transcript_prior: bool = True
    per_nucleotide_prior: bool = False
    range_factorization_bins: int = 4
    sig_digits: int = 3
    num_gibbs_samples: int = 0
    num_bootstraps: int = 0
    thinning_factor: int = 16
    no_gamma_draw: bool = False
    bootstrap_reproject: bool = False
    dont_extrapolate_counts: bool = False
    # EM convergence (reference: MappingPipelineStages.cpp:49,
    # CollapsedEMOptimizer.cpp:741-742)
    relative_diff_tolerance: float = 0.01
    max_em_iterations: int = 10_000
    min_em_iterations: int = 50
    min_required_iterations: int = 100   # when bias correcting
    alpha_check_cutoff: float = 1e-2
    min_alpha: float = 1e-8
    min_em_weight_cutoff: float = 1e-8   # minEQClassWeight guard

    # --- bias models -----------------------------------------------------
    num_frag_gc_bins: int = 25
    num_conditional_gc_bins: int = 3
    bias_speed_samp: int = 5
    num_gc_bins: int = 25                # --numGCBins (numFragGCBins)
    conditional_gc_bins: int = 3         # --conditionalGCBins (1 when gcBias without seqBias)
    no_bias_length_threshold: bool = False  # --noBiasLengthThreshold
    alternative_init_mode: bool = False  # --alternativeInitMode
    meta_mode: bool = False              # --meta (implies initUniform/noRich/EM)
    no_rich_eq_classes: bool = False     # --noRichEqClasses: flat aux weights
    num_required_frags: float = 5e7      # --numRequiredObs (EM init blend)
    aux_dir: str = "aux_info"            # --auxDir
    pipeline_depth: int = 1              # batches in flight before the host consumes one
    disable_live_progress: bool = False  # --disableLiveProgress
    progress_update_ms: int = 5000       # --progressUpdateMs (log-line throttle; the reference's TTY ticker defaults to 500)

    # --- index -----------------------------------------------------------
    kmer_len: int = 31                   # k (odd, <= 31)

    # --- batching knobs (no reference analog: fixed shapes) -------------
    reads_per_batch: int = 4096          # R: fragments per device batch
    max_read_len: int = 256              # L: padded read length
    occ_cap: int = 8                     # C: occurrences gathered per k-mer
    max_cands: int = 64                  # T: candidate (txp,orient) per end
    max_pair_cands: int = 64             # T2: joined hits kept per fragment
    hash_max_probes: int = 8             # slots probed per query (4-slot
                                         # buckets -> two row gathers)
    hash_load_factor: float = 0.5
    kmer_stride: int = 6                 # seed-skip between query windows
                                         # (reference altSkip=3;
                                         # --mismatchSeedSkip 3 restores
                                         # the reference-parity stride)
    # batch-global sparse seed flow (mapping.seed_sparse); SALMON_TPU_SPARSE_SEED overrides it
    sparse_seed: bool = False
    seed_hits_per_end: int = 32          # B: hit budget per read end in the sparse seed flow
    index_shards: int = 1                # --indexShards: index shards over the ranks of a reads group
    dp_budget: int = 4                   # avg DP-validated candidates per fragment
    weight_width: int = 16               # W: score-sorted hits kept per fragment for weighting/eq emission


DEFAULTS = SalmonDefaults()
