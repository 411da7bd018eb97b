"""Orchestration of bias-aware effective-length correction.

Counterpart of salmon_tpu/models/bias_correct.py: the host-side driver
over the device passes in bias.py / bias_expected.py, the role of
updateEffectiveLengths (src/util/SalmonUtils.cpp:1208-1980) called from
CollapsedEMOptimizer::optimize (:900-928). The JAX package's two jitted
bucket programs are bias_expected's bucket passes, whose per-length body
replays a CUDA graph on the card (a GraphCache a bucket's pass); each
bucket's code matrix, lengths and length classes go to the device once,
in BiasState.__init__.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from salmon_tpu_torch.models import bias as B
from salmon_tpu_torch.models import bias_expected as BE
from salmon_tpu_torch.utils.graphcache import stats_totals

logger = logging.getLogger("salmon_tpu_torch")

POS_RATIO_MAX = 10.0  # spline-noise guard on sparse length classes


def _pos_factor_grid(obs_masses, exp_masses, uniform_knots=False):
    """(5, POS_GRID) obs/exp positional factor ratio tables, clamped to
    [1/POS_RATIO_MAX, POS_RATIO_MAX] (divergence from the reference,
    which leaves the spline ratio unclamped: sparse length classes
    otherwise produce multi-x noise factors)."""
    grid = np.ones((B.POS_LENGTH_CLASSES, BE.POS_GRID))
    for li in range(B.POS_LENGTH_CLASSES):
        # +1 pseudocount per bin (the reference's SimplePosBias starts
        # each bin at LOG_1, i.e. mass 1.0: SimplePosBias.cpp ctor)
        o = B.pos_project_weights(obs_masses[li] + 1.0, BE.POS_GRID,
                                  uniform_knots)
        e = B.pos_project_weights(exp_masses[li] + 1.0, BE.POS_GRID,
                                  uniform_knots)
        if obs_masses[li].sum() > 0 and exp_masses[li].sum() > 0:
            grid[li] = np.clip(o / np.maximum(e, 1e-5),
                               1.0 / POS_RATIO_MAX, POS_RATIO_MAX)
    return grid


def _gc_ratio(obs, exp, max_ratio=B.GC_RATIO_MAX):
    """GCFragModel::ratio with per-conditional-bin normalization."""
    o = np.asarray(obs, dtype=np.float64)
    e = np.asarray(exp, dtype=np.float64)
    o_n = o / np.maximum(o.sum(axis=1, keepdims=True), 1e-300)
    e_n = e / np.maximum(e.sum(axis=1, keepdims=True), 1e-300)
    r = np.where(e_n > 0, o_n / np.maximum(e_n, 1e-300), 1.0)
    r = np.where((o_n <= 0) & (e_n <= 0), 1.0, r)
    return np.clip(r, 1.0 / max_ratio, max_ratio)


def _gc_percent_to_bin(n_bins: int) -> np.ndarray:
    """GCDesc::fragBin(n): percent (0..100) -> bin under an n-bin model
    (GCFragModel.hpp:19-22)."""
    p = np.arange(101)
    return np.minimum(n_bins - 1, (p / (100.0 / n_bins)).astype(np.int64))


def fold_gc_counts(mat101, n_bins: int, cond_bins: int) -> np.ndarray:
    """Fold percent-resolution (3, 101) GC masses into the configured
    (cond_bins, n_bins) model: the device collects at percent
    resolution, so --numGCBins/--conditionalGCBins are a lossless host
    re-bin (reference default 3 x 25, SalmonDefaults.hpp:105-106; gcBias
    without seqBias collapses the conditional axis,
    QuantOptionsUtils.cpp:505-507)."""
    m = np.asarray(mat101, np.float64)
    if cond_bins == 1:
        m = m.sum(axis=0, keepdims=True)
    b = _gc_percent_to_bin(n_bins)
    out = np.zeros((m.shape[0], n_bins))
    np.add.at(out, (np.arange(m.shape[0])[:, None],
                    np.broadcast_to(b, (m.shape[0], 101))), m)
    return out


def expand_gc_ratio(ratio_n: np.ndarray, n_bins: int,
                    cond_bins: int) -> np.ndarray:
    """Expand a (cond_bins, n_bins) ratio table back to the device's
    fixed (3, 101) percent-resolution lookup (each percent reads its
    bin's ratio; a collapsed conditional axis broadcasts)."""
    r = np.asarray(ratio_n, np.float64)[:, _gc_percent_to_bin(n_bins)]
    if cond_bins == 1:
        r = np.broadcast_to(r, (B.GC_COND_BINS, 101)).copy()
    return r


class BiasState:
    """All learned bias state + the recompute entry point, on `device`.

    After corrected_effective_lengths has run its first pass, the
    expected statistics (exp5_counts, exp3_counts, gc_exp, pos5_exp,
    pos3_exp) and the GC models it compared (gc_obs_model,
    gc_exp_model) are set, for the dumps; `seconds` holds the pass
    clocks ("expected", "efflen"), each ending in a device sync, and
    `graphs` each pass's graph cache counters (stats_totals; zeros on
    the CPU, where the passes run eagerly)."""

    def __init__(self, index, opts, device="cuda"):
        self.opts = opts
        self.index = index
        self.device = torch.device(device)
        self.obs = B.BiasObservations()
        self.skip_bias = None     # --auxTargetFile mask over valid targets
        n = index.num_valid_targets
        lengths = np.asarray(index.lengths[:n])
        self.length_class = np.clip(np.searchsorted(
            B.length_class_bounds(lengths), lengths, side="right"), 0,
            B.POS_LENGTH_CLASSES - 1).astype(np.int32)
        self.buckets = []
        for idxs, mat in BE.bucket_transcripts(index.transcript_codes,
                                               lengths):
            self.buckets.append({
                "idx": torch.from_numpy(idxs).to(self.device),
                "codes": torch.from_numpy(mat).to(self.device),
                "lens": torch.from_numpy(
                    lengths[idxs].astype(np.int32)).to(self.device),
                "len_class": torch.from_numpy(
                    self.length_class[idxs]).to(self.device)})
        self.enabled = (opts.seq_bias_correct or opts.gc_bias_correct
                        or opts.pos_bias_correct)
        self.exp5_counts = self.exp3_counts = None
        self.gc_exp = self.pos5_exp = self.pos3_exp = None
        self.gc_obs_model = self.gc_exp_model = None
        self.seconds = {}
        self.graphs = {}

    def graph_clocks(self, bdev: dict) -> dict:
        """The graph counters of the collection on `bdev` and of the last
        passes, as a quant's clocks name them (bias_collect_graph_*,
        bias_expected_graph_*, bias_efflen_graph_*)."""
        parts = {"collect": stats_totals(B.collect_graph_stats(bdev)),
                 **self.graphs}
        return {f"bias_{p}_graph_{k}": v for p, g in parts.items()
                for k, v in g.items()}

    def _put(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def corrected_effective_lengths(self, alphas: np.ndarray,
                                    eff_in: np.ndarray,
                                    fld_pmf: np.ndarray) -> np.ndarray:
        """The updateEffectiveLengths analog. alphas/eff_in over valid
        (non-decoy) targets; returns float64 effective lengths."""
        o = self.opts
        seq_b, gc_b, pos_b = (o.seq_bias_correct, o.gc_bias_correct,
                              o.pos_bias_correct)
        if gc_b and self.obs.gc_frac_fwd() < 0:
            logger.warning("no fragments to estimate fwd/rc rate; "
                           "skipping bias correction")
            return eff_in

        cdf = self._put(np.cumsum(fld_pmf))
        fld_low, fld_high = BE.fld_quantile_bounds(fld_pmf)
        gc_samp = int(o.bias_speed_samp)

        weights = np.where(alphas >= BE.MIN_ALPHA_BG,
                           alphas / np.maximum(eff_in, 1.0), 0.0)
        skip = self.skip_bias
        if skip is not None:
            # --auxTargetFile targets are excluded from the background
            # and never bias-corrected (reference skipBiasCorrection,
            # SalmonUtils.cpp:1507)
            weights[skip[:weights.shape[0]]] = 0.0
        n_bg = int((weights > 0).sum())
        cutoff = min(150, max(1, int(0.1 * n_bg)))
        if n_bg < cutoff or n_bg == 0:
            logger.warning("only %d background transcripts; skipping bias "
                           "correction", n_bg)
            return eff_in

        # --- pass 1: expected statistics over buckets
        t0 = time.perf_counter()
        w_dev = self._put(weights)
        sums = {}
        graphs = []
        for b in self.buckets:
            out = BE.expected_pass_bucket(
                b["codes"], b["lens"], w_dev[b["idx"]], b["len_class"], cdf,
                fld_low, fld_high, gc_samp, seq_b, gc_b, pos_b, stats=graphs)
            for k, v in out.items():
                sums[k] = sums[k] + v.double() if k in sums else v.double()
        host = {k: v.cpu().numpy() for k, v in sums.items()}
        self.seconds["expected"] = time.perf_counter() - t0
        self.graphs["expected"] = stats_totals(graphs)

        def get(k, shape):
            return host[k] if k in host else np.zeros(shape)

        sb, gcs = (B.SB_ROWS, B.SB_CTX), (B.GC_COND_BINS, B.GC_BINS)
        ps = (B.POS_LENGTH_CLASSES, B.POS_BINS)
        exp5, exp3 = get("exp5", sb), get("exp3", sb)
        gc_exp = get("gc_exp", gcs)
        pos5_exp, pos3_exp = get("pos5", ps), get("pos3", ps)
        self.exp5_counts, self.exp3_counts = exp5, exp3
        self.gc_exp, self.pos5_exp, self.pos3_exp = gc_exp, pos5_exp, \
            pos3_exp

        # --- normalize models (host, float64)
        zeros = np.zeros(sb)
        obs5_logp = B.sb_normalize(self.obs.obs5) if seq_b else zeros
        obs3_logp = B.sb_normalize(self.obs.obs3) if seq_b else zeros
        exp5_logp = B.sb_normalize(exp5) if seq_b else zeros
        exp3_logp = B.sb_normalize(exp3) if seq_b else zeros
        if gc_b:
            n_gc, n_cond = int(o.num_gc_bins), int(o.conditional_gc_bins)
            self.gc_obs_model = fold_gc_counts(self.obs.gc_obs, n_gc,
                                               n_cond)
            self.gc_exp_model = fold_gc_counts(gc_exp, n_gc, n_cond)
            gc_ratio = expand_gc_ratio(
                _gc_ratio(self.gc_obs_model, self.gc_exp_model),
                n_gc, n_cond)
        else:
            gc_ratio = np.ones(gcs)
        ones_grid = np.ones((B.POS_LENGTH_CLASSES, BE.POS_GRID))
        grid_fw = grid_rc = ones_grid
        if pos_b:
            corrected = bool(o.pos_bias_corrected)
            grid_fw = _pos_factor_grid(self.obs.pos5, pos5_exp,
                                       uniform_knots=corrected)
            # --posBiasCorrected: the 5'/3' start distributions are
            # marginals of ONE positional distribution linked by the
            # fragment length; multiplying both factors double-counts
            # it, so the corrected integral uses the fw marginal only
            if not corrected:
                grid_rc = _pos_factor_grid(self.obs.pos3, pos3_exp)

        # --- pass 2: per-transcript corrected effective lengths
        t0 = time.perf_counter()
        process = (alphas >= BE.MIN_ALPHA_BG) & (
            np.asarray(self.index.lengths[:alphas.shape[0]]) - eff_in > 0)
        if skip is not None:
            process &= ~skip[:process.shape[0]]
        tabs = [self._put(t) for t in (obs5_logp, exp5_logp, obs3_logp,
                                       exp3_logp, gc_ratio, grid_fw,
                                       grid_rc)]
        eff_dev, proc_dev = self._put(eff_in), self._put(process, torch.bool)
        # every valid target lies in one bucket, so every row is written
        eff_out = torch.empty_like(eff_dev)
        graphs = []
        for b in self.buckets:
            eff_out[b["idx"]] = BE.efflen_pass_bucket(
                b["codes"], b["lens"], eff_dev[b["idx"]], proc_dev[b["idx"]],
                b["len_class"], cdf, fld_low, fld_high, gc_samp, *tabs,
                seq_b, gc_b, pos_b, bool(o.no_bias_length_threshold),
                stats=graphs)
        out = eff_out.cpu().numpy().astype(np.float64)
        self.seconds["efflen"] = time.perf_counter() - t0
        self.graphs["efflen"] = stats_totals(graphs)
        return out
