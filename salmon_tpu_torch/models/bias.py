"""Sequence / fragment-GC / positional bias models: the structures, the
host-side normalisation and spline projection, and the per-batch
collection of observed statistics on the device.

Counterpart of salmon_tpu/models/bias.py. Reference:
  SBModel        include/salmon/internal/model/SBModel.hpp:15-97,
                 src/model/SBModel.cpp (order {0,1,2,2,2,2,2,2,2},
                 context -3..+5 around the fragment end)
  GCFragModel    include/salmon/internal/model/GCFragModel.hpp:45-160
                 (3 conditional context bins x 101 GC bins, ratio clamp)
  SimplePosBias  include/salmon/internal/model/SimplePosBias.hpp:10-47,
                 src/model/SimplePosBias.cpp (20 Cufflinks bins, spline
                 projection, 5 transcript-length quantile classes)
  observed sampling       src/quant/SalmonQuantify.cpp:895-982,1668-1757

Observed statistics are fixed-size histograms accumulated on the device
per mapped batch (index_add_ into zeroed tensors) and summed on the host
in float64 (the per-thread BiasParams merge, WorkerRuntimeContext.hpp).
Every gather that the JAX package writes with mode="clip" clamps its
index here, so out-of-range best-hit fields read the edge as they do
there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from salmon_tpu_torch.utils.graphcache import GraphCache, tensor_signature

# --- SBModel structure (variable-order Markov model) ---------------------
SB_ORDER = (0, 1, 2, 2, 2, 2, 2, 2, 2)   # per-position context order
SB_CONTEXT_LEFT = 3                       # bases before the fragment end
SB_CONTEXT_RIGHT = 5                      # bases after
SB_CTX = len(SB_ORDER)                    # 9
SB_ROWS = 4 ** (max(SB_ORDER) + 1)        # 64
SB_PRIOR = 1e-10

GC_COND_BINS = 3
GC_BINS = 101
GC_RATIO_MAX = 1000.0
GC_CTX_OUTSIDE = 3
GC_CTX_INSIDE = 2

POS_BINS = 20
POS_LENGTH_CLASSES = 5
# Cufflinks position bin edges (SimplePosBias.hpp:42-45)
POS_BIN_EDGES = np.array([.02, .04, .06, .08, .10, .15, .2, .3, .4, .5,
                          .6, .7, .8, .85, .9, .92, .94, .96, .98, 1.0])


def take_clip(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with idx clamped into range (jnp.take(mode="clip"))."""
    return table[idx.clamp(0, table.shape[0] - 1)]


# base j of a context sits at bits SB_SHIFT[j] of the packed 18-bit
# context; position i keeps its order[i] + 1 bases (i - order[i] .. i)
SB_SHIFT = tuple(2 * (SB_CTX - 1 - j) for j in range(SB_CTX))
SB_MASK = tuple((1 << 2 * (o + 1)) - 1 for o in SB_ORDER)


def sb_context_indices(ctx_codes: torch.Tensor) -> torch.Tensor:
    """(..., 9) base codes -> (..., 9) int32 VLMM state indices.

    Position i conditions on min(i, order[i]) preceding bases: the index
    is the 2-bit packing of bases (i-order[i] .. i) (SBModel::_getIndex),
    cut here from the packing of all 9 bases.
    """
    c = ctx_codes.to(torch.int32) & 3
    # SB_SHIFT and SB_MASK made on the device (no host copy, which a
    # captured graph cannot hold): order[i] = min(i, 2)
    j = torch.arange(SB_CTX, dtype=torch.int32, device=c.device)
    shift = 2 * (SB_CTX - 1 - j)
    mask = (1 << 2 * (torch.clamp(j, max=max(SB_ORDER)) + 1)) - 1
    packed = (c << shift).sum(dim=-1, dtype=torch.int32)
    return (packed[..., None] >> shift) & mask


def sb_normalize(counts: np.ndarray) -> np.ndarray:
    """counts (64, 9) -> conditional log-probs (SBModel::normalize):
    P(base | prefix) within each aligned group of 4 rows per position."""
    c = np.asarray(counts, dtype=np.float64) + SB_PRIOR
    out = np.zeros_like(c)
    for i, o in enumerate(SB_ORDER):
        n = 4 ** (o + 1)
        col = c[:n, i].reshape(n // 4, 4)
        probs = col / col.sum(axis=1, keepdims=True)
        out[:n, i] = np.log(probs).reshape(-1)
        out[n:, i] = np.log(SB_PRIOR)
    return out


def sb_marginalize(counts: np.ndarray) -> np.ndarray:
    """(4, 9) per-position marginal base probabilities (for dumps)."""
    c = np.asarray(counts, dtype=np.float64) + SB_PRIOR
    out = np.zeros((4, SB_CTX))
    for i, o in enumerate(SB_ORDER):
        n = 4 ** (o + 1)
        col = c[:n, i].reshape(n // 4, 4)
        out[:, i] = col.sum(axis=0) / col.sum()
    return out


def length_class_bounds(lengths: np.ndarray,
                        n: int = POS_LENGTH_CLASSES) -> np.ndarray:
    """Quantile upper bounds (reference setTranscriptLengthClasses,
    ReadExperiment.inl:352-388)."""
    ls = np.sort(np.asarray(lengths))
    if ls.size == 0:
        return np.full(n, np.iinfo(np.int32).max)
    if ls.size > n:
        step = ls.size // n
        idx = np.minimum(np.arange(1, n + 1) * step, ls.size - 1)
        return ls[idx].astype(np.int64)
    out = np.full(n, ls[-1], dtype=np.int64)
    out[:ls.size] = ls
    return out


def length_class_of(lengths: torch.Tensor,
                    bounds: torch.Tensor) -> torch.Tensor:
    """upper_bound semantics: first class whose bound > length."""
    return torch.searchsorted(bounds, lengths, right=True).clamp(
        0, POS_LENGTH_CLASSES - 1)


def pos_bin_of(pos: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """floor(pos / (length / 20)) in float32 (SimplePosBias::addMass)."""
    step = torch.clamp(length.to(torch.float32), min=1.0) / POS_BINS
    return (pos.to(torch.float32) / step).to(torch.int32).clamp(
        0, POS_BINS - 1)


def pos_project_weights(masses: np.ndarray, length: int,
                        uniform_knots: bool = False) -> np.ndarray:
    """Spline-project 20 bin masses to per-position factors
    (SimplePosBias::finalize + projectWeights).

    uniform_knots=False reproduces the reference: masses accumulated
    into UNIFORM bins (pos_bin_of) are projected through spline knots at
    the NON-uniform Cufflinks positions - 0.01. uniform_knots=True
    (--posBiasCorrected) places the knots at the uniform bin centres the
    masses came from."""
    from scipy.interpolate import CubicSpline

    m = np.asarray(masses, dtype=np.float64)
    s = m.sum()
    if s <= 0:
        return np.ones(length)
    start_knot = m[0] / s
    stop_knot = m[-1] / s
    spline_sum = s + start_knot + stop_knot
    ys = np.concatenate([[start_knot], m / spline_sum, [stop_knot]])
    if uniform_knots:
        centers = (np.arange(POS_BINS) + 0.5) / POS_BINS
        xs = np.concatenate([[0.0], centers, [1.0]])
    else:
        xs = np.concatenate([[0.0], POS_BIN_EDGES - 0.01, [1.0]])
    cs = CubicSpline(xs, ys)
    frac = np.arange(length, dtype=np.float64) / max(length, 1)
    return np.maximum(0.001, cs(frac))


# =========================================================================
# Observed statistics (device, per mapped batch)
# =========================================================================

_OBS_KEYS = ("bias_obs5", "bias_obs3", "bias_gc", "bias_pos5", "bias_pos3",
             "bias_mass_fwd", "bias_mass_rc")


@dataclasses.dataclass
class BiasObservations:
    """Host accumulator for the per-batch observed histograms
    (BiasParams analog, include/salmon/internal/quant/BiasParams.hpp)."""
    obs5: np.ndarray = None   # (64, 9) seq-bias counts, 5' (fw) ends
    obs3: np.ndarray = None   # (64, 9) 3' (rc) ends
    gc_obs: np.ndarray = None  # (3, 101) fragment-GC mass
    pos5: np.ndarray = None   # (5, 20) positional mass fw
    pos3: np.ndarray = None   # (5, 20) rc
    mass_fwd: float = 0.0
    mass_rc: float = 0.0

    def __post_init__(self):
        if self.obs5 is None:
            self.obs5 = np.zeros((SB_ROWS, SB_CTX))
            self.obs3 = np.zeros((SB_ROWS, SB_CTX))
            self.gc_obs = np.zeros((GC_COND_BINS, GC_BINS))
            self.pos5 = np.zeros((POS_LENGTH_CLASSES, POS_BINS))
            self.pos3 = np.zeros((POS_LENGTH_CLASSES, POS_BINS))

    def add_batch(self, out: dict) -> None:
        """Add one batch of collect_bias_observations' tensors (one copy
        to the host for all of them)."""
        flat = torch.cat([out[k].reshape(-1) for k in _OBS_KEYS]).to(
            torch.float64).cpu().numpy()
        parts, o = [], 0
        for arr in (self.obs5, self.obs3, self.gc_obs, self.pos5,
                    self.pos3):
            parts.append(flat[o:o + arr.size].reshape(arr.shape))
            o += arr.size
        self.obs5 += parts[0]
        self.obs3 += parts[1]
        self.gc_obs += parts[2]
        self.pos5 += parts[3]
        self.pos3 += parts[4]
        self.mass_fwd += float(flat[o])
        self.mass_rc += float(flat[o + 1])

    def gc_frac_fwd(self) -> float:
        tot = self.mass_fwd + self.mass_rc
        return self.mass_fwd / tot if tot > 0 else -1.0


def bias_device_tensors(idx, device) -> dict:
    """Extra device planes for observed-bias collection: concatenated
    transcript codes, per-txp offsets/lengths, GC prefix sums, length-class
    ids."""
    seq = np.asarray(idx.seq_codes).astype(np.int8)
    gc = np.concatenate([[0], np.cumsum((seq == 1) | (seq == 2))])
    lengths = np.asarray(idx.lengths)
    bounds = length_class_bounds(lengths[:idx.num_valid_targets])
    lc = np.searchsorted(bounds, lengths, side="right")

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {
        "seq_codes": put(seq),
        "seq_off": put(np.asarray(idx.seq_offsets).astype(np.int64)),
        "gc_cum": put(gc.astype(np.int32)),
        "txp_len": put(lengths.astype(np.int32)),
        "len_class": put(
            np.clip(lc, 0, POS_LENGTH_CLASSES - 1).astype(np.int32)),
    }


def _gather_context(bdev: dict, txp, pos, rc):
    """Gather the 9-base context around position `pos` on transcript `txp`.

    fw: bases pos-3 .. pos+5 on the coding strand; rc: the reverse
    complement of bases pos-5 .. pos+3 (reference leftMer/rightMer logic,
    SalmonQuantify.cpp:1735-1749). Returns (N, 9) int32 codes + (N,)
    validity.
    """
    off = take_clip(bdev["seq_off"], txp)
    tlen = take_clip(bdev["txp_len"], txp)
    j = torch.arange(SB_CTX, dtype=torch.int32, device=pos.device)
    fw_pos = pos[:, None] - SB_CONTEXT_LEFT + j[None, :]
    rc_pos = pos[:, None] + SB_CONTEXT_LEFT - j[None, :]
    p = torch.where(rc[:, None], rc_pos, fw_pos)
    valid = ((p >= 0) & (p < tlen[:, None])).all(dim=1)
    codes = take_clip(bdev["seq_codes"], off[:, None] + p).to(torch.int32)
    codes = torch.where(rc[:, None], 3 - codes, codes) & 3
    return codes, valid


def _gc_desc(bdev: dict, txp, start, stop):
    """Fragment GC% + context GC% (Transcript::gcDesc,
    Transcript.hpp:294-345). Returns (frag_bin, cond_bin, valid)."""
    off = take_clip(bdev["seq_off"], txp)
    tlen = take_clip(bdev["txp_len"], txp)
    last = tlen - 1

    def cum(p):
        return take_clip(bdev["gc_cum"],
                         off + torch.minimum(p.clamp(min=0), tlen))

    # gc count over [s, e] inclusive = cum(e+1) - cum(s)
    frag_gc = cum(stop + 1) - cum(start)
    flen = torch.clamp(stop - start + 1, min=1)
    frag_frac = torch.round(100.0 * frag_gc.to(torch.float32)
                            / flen.to(torch.float32)).to(torch.int32)

    fs = start - (GC_CTX_OUTSIDE + 1)
    fe = start + (GC_CTX_INSIDE - 1)
    ts = stop - GC_CTX_INSIDE
    te = stop + GC_CTX_OUTSIDE
    fs_c = fs.clamp(min=0)
    fe_c = torch.minimum(fe, last)
    ts_c = ts.clamp(min=0)
    te_c = torch.minimum(te, last)
    fp_gc = cum(fe_c + 1) - cum(fs_c)
    tp_gc = cum(te_c + 1) - cum(ts_c)
    fp_size = torch.where(fs < 0, fe_c + 1, fe_c - fs_c)
    tp_size = torch.where(ts < 0, te_c + 1, te_c - ts_c)
    ctx_size = (fp_size + tp_size).to(torch.float32)
    ctx_frac = torch.where(
        ctx_size > 0,
        torch.round(100.0 * (fp_gc + tp_gc).to(torch.float32)
                    / ctx_size.clamp(min=1.0)),
        0.0).to(torch.int32)
    w = 100.0 / GC_COND_BINS
    cond_bin = torch.clamp(
        (ctx_frac.to(torch.float32) / w).to(torch.int32),
        max=GC_COND_BINS - 1)
    valid = (start >= 0) & (stop < tlen) & (stop > start)
    return frag_frac.clamp(0, 100), cond_bin, valid


def _seg_sum(values: torch.Tensor, index: torch.Tensor, n: int):
    return torch.zeros(n, dtype=torch.float32,
                       device=values.device).index_add_(
        0, index.reshape(-1).to(torch.int64),
        values.reshape(-1).to(torch.float32))


# one cache per bias_device_tensors on the card, dropped with its tensors
_GRAPHS = WeakIdKeyDictionary()
# least rows of a padded batch on the card (see collect_bias_observations)
COLLECT_MIN_ROWS = 256


def collect_graph_stats(bdev: dict) -> list:
    """The collection's SignatureStats of `bdev`, one per signature (none
    where no batch of `bdev` was collected on the card)."""
    cache = _GRAPHS.get(bdev["seq_codes"])
    return list(cache.stats.values()) if cache is not None else []


def collect_bias_observations(bdev: dict, txp, frag_start, frag_end, fw1,
                              len1, len2, frag_valid, weight) -> dict:
    """collect_bias_observations_impl, compiled: the counterpart of the
    JAX package's jax.jit of it (salmon_tpu/quant.py:299,
    salmon_tpu/alignment/quant.py:363). On CUDA tensors, one CUDA graph
    per batch signature (utils/graphcache.py; the first batch of a
    signature eager, the second captured, the rest replayed). The
    outputs are the graph's one output set, which the next batch of the
    signature overwrites: a caller copies them out first, as
    BiasObservations.add_batch does at once. A batch is padded to the
    next power of two rows (at least COLLECT_MIN_ROWS) with invalid
    rows, which add nothing, so that batches of other lengths (`-a`)
    share a signature. On CPU tensors, the eager body itself."""
    args = [txp, frag_start, frag_end, fw1, len1, len2, frag_valid, weight]
    if not txp.is_cuda:
        return collect_bias_observations_impl(bdev, *args)
    args = padded_rows(args)
    rows = args[0].shape[0]
    cache = _GRAPHS.get(bdev["seq_codes"])
    if cache is None:
        cache = _GRAPHS[bdev["seq_codes"]] = GraphCache()
    key = ("bias_collect", tuple(tensor_signature(a) for a in args),
           tuple((k, v.data_ptr(), tensor_signature(v))
                 for k, v in sorted(bdev.items())))
    return cache.run(key, lambda ts: collect_bias_observations_impl(
        bdev, *ts), args, ring=1, label=f"bias collection R={rows}")


def padded_rows(args: list) -> list:
    """The (R,) inputs padded with zeros (rows that are not frag_valid,
    so that they add nothing) to the next power of two rows, at least
    COLLECT_MIN_ROWS."""
    n = args[0].shape[0]
    rows = max(COLLECT_MIN_ROWS, 1 << max(0, n - 1).bit_length())
    if rows == n:
        return args
    return [torch.cat([a, a.new_zeros(rows - n)]) for a in args]


def collect_bias_observations_impl(bdev: dict, txp, frag_start, frag_end,
                                   fw1, len1, len2, frag_valid,
                                   weight) -> dict:
    """Device collection of one batch's observed-bias statistics.

    Args are (R,) best-alignment fields: transcript id, fragment start /
    end (inclusive, transcript coords), orientation of read 1, the two
    read lengths, validity mask, and posterior weight. Assumes
    opposite-strand (inward/outward) pairs: the fw mate's 5' end is the
    fragment start, the rc mate's 5' end is the fragment end (reference
    startPos logic, SalmonQuantify.cpp:1691-1699). Returns (64, 9),
    (3, 101), (5, 20) float32 histograms and two float32 masses.
    """
    w = torch.where(frag_valid, weight, 0.0).to(torch.float32)

    ctx5, v5 = _gather_context(bdev, txp, frag_start,
                               torch.zeros_like(fw1, dtype=torch.bool))
    ctx3, v3 = _gather_context(bdev, txp, frag_end,
                               torch.ones_like(fw1, dtype=torch.bool))
    w5 = torch.where(frag_valid & v5 & v3, 1.0, 0.0)
    col = torch.arange(SB_CTX, dtype=torch.int32, device=w.device)

    def sb_hist(ctx):
        flat = sb_context_indices(ctx) * SB_CTX + col[None, :]
        return _seg_sum(w5[:, None].expand(flat.shape), flat,
                        SB_ROWS * SB_CTX).reshape(SB_ROWS, SB_CTX)

    # fragment GC (posterior-weighted)
    frag_bin, cond_bin, gc_valid = _gc_desc(bdev, txp, frag_start,
                                            frag_end)
    wgc = torch.where(frag_valid & gc_valid, w, 0.0)
    gc_obs = _seg_sum(wgc, cond_bin * GC_BINS + frag_bin,
                      GC_COND_BINS * GC_BINS).reshape(GC_COND_BINS, GC_BINS)

    # positional bias: each mate's leftmost position
    tlen = take_clip(bdev["txp_len"], txp)
    lc = take_clip(bdev["len_class"], txp)
    len_rc = torch.where(fw1, len2, len1)
    pos_fw = torch.minimum(frag_start.clamp(min=0), tlen - 1)
    pos_rc = torch.minimum((frag_end - len_rc + 1).clamp(min=0), tlen - 1)
    n_pos = POS_LENGTH_CLASSES * POS_BINS
    pos5 = _seg_sum(w, lc * POS_BINS + pos_bin_of(pos_fw, tlen), n_pos)
    pos3 = _seg_sum(w, lc * POS_BINS + pos_bin_of(pos_rc, tlen), n_pos)

    return {"bias_obs5": sb_hist(ctx5), "bias_obs3": sb_hist(ctx3),
            "bias_gc": gc_obs,
            "bias_pos5": pos5.reshape(POS_LENGTH_CLASSES, POS_BINS),
            "bias_pos3": pos3.reshape(POS_LENGTH_CLASSES, POS_BINS),
            "bias_mass_fwd": torch.where(frag_valid & fw1, w, 0.0).sum(),
            "bias_mass_rc": torch.where(frag_valid & ~fw1, w, 0.0).sum()}
