"""Expected-bias pass and bias-aware effective lengths.

Counterpart of salmon_tpu/models/bias_expected.py. Reference:
updateEffectiveLengths (src/util/SalmonUtils.cpp:1208-1980): pass 1
accumulates the abundance-weighted *expected* seq/GC/pos statistics over
the whole transcriptome; pass 2 recomputes each transcript's effective
length as sum_fl flWeight * sum_pos (seqFW[s] * seqRC[e] * gcRatio(desc)
* posFW[s] * posRC[e]).

Transcripts are bucketed by padded length into (B, Lmax) code matrices
(host); both passes are torch programs on the bucket's device. The JAX
package jits each bucket's pass (salmon_tpu/models/bias_correct.py:91,
:100) around a fori_loop over the sampled fragment lengths; here the
repeated unit is the per-length body, which takes the length and its
weights as device tensors (the rolls by the length become gathers at
s + fl - 1, masked as the rolls' wrapped cells were), so that on CUDA
tensors one captured CUDA graph of the body serves every sampled length
of a row chunk (utils/graphcache.py: the first length eager, the second
captured, the rest replayed, one launch each; the graph dropped after
the chunk's last length); on CPU tensors the body
runs eagerly (`*_impl` with no cache). Each bucket is processed in row
chunks of at most
MAX_CELLS padded cells, so a pass fits any index the mapping path can
load; the seq-bias state indices are built one context position at a
time, never as a (B, L, 9) tensor. Context-GC for expected fragments
uses the gcDesc window formulas (Transcript.hpp:294-345), as the
observed side does (the JAX package's documented divergence from
populateContextCounts).
"""

from __future__ import annotations

import numpy as np
import torch

from salmon_tpu_torch.models.bias import (GC_BINS, GC_COND_BINS,
                                          GC_CTX_INSIDE, GC_CTX_OUTSIDE,
                                          POS_BINS, POS_LENGTH_CLASSES,
                                          SB_CONTEXT_LEFT, SB_CTX, SB_MASK,
                                          SB_ROWS, SB_SHIFT, pos_bin_of,
                                          take_clip)
from salmon_tpu_torch.utils.graphcache import (GraphCache, loop_cache,
                                               loop_step)

MIN_ALPHA_BG = 1e-8   # minAlpha cutoff for background transcripts
MIN_CDF_MASS = 1e-10
POS_GRID = 1024       # spline factor grid resolution (device lookup)
# padded (row x position) cells per chunk of a bucket: bounds a pass's
# peak device memory (~100 bytes a cell in the seq-bias part). On the
# card the per-length body's working set is held twice, in the
# allocator's cache (a chunk's first length runs eagerly) and in the
# loops' graph pool (utils/graphcache.loop_graphs), which keeps the
# largest chunk's for the process
MAX_CELLS = 1 << 23
# copies of the bins that the expected pass's histograms spread their
# values over on a GPU (value k adds to copy k % HIST_COPIES), summed
# at the end: a few hundred bins take millions of values, and
# index_add_'s atomics on one address serialise. The CPU adds in order
# into one copy, the JAX package's association.
HIST_COPIES = 1024


def fld_quantile_bounds(pmf: np.ndarray, lo_q=0.005):
    """fldLow/fldHigh quantile cutoffs (SalmonUtils.cpp:1262-1290)."""
    cdf = np.cumsum(pmf)
    lo = int(np.searchsorted(cdf, lo_q))
    hi = int(np.searchsorted(cdf, 1.0 - lo_q))
    return max(1, lo), max(lo + 1, min(hi, pmf.shape[0] - 1))


def bucket_transcripts(codes_list, lengths, pad_to=(256, 512, 1024, 2048,
                                                    4096, 8192, 16384,
                                                    32768, 65536)):
    """Group transcript indices by padded length; returns list of
    (txp_idx array, (B, Lmax) code matrix)."""
    lengths = np.asarray(lengths)
    buckets = {}
    for i, L in enumerate(lengths):
        for p in pad_to:
            if L <= p:
                buckets.setdefault(p, []).append(i)
                break
        else:
            buckets.setdefault(pad_to[-1], []).append(i)
    out = []
    for p, idxs in sorted(buckets.items()):
        mat = np.full((len(idxs), p), 4, dtype=np.uint8)
        for r, i in enumerate(idxs):
            c = codes_list(i)[:p]
            mat[r, :c.shape[0]] = c
        out.append((np.array(idxs, dtype=np.int64), mat))
    return out


def _row_chunks(n_rows: int, length: int, max_cells: int):
    step = max(1, max_cells // max(length, 1))
    return [(r, min(r + step, n_rows)) for r in range(0, n_rows, step)]


def _row_tables(codes):
    """Per-row helpers: gc prefix sums (B, L+1) and position iota."""
    B, L = codes.shape
    is_gc = ((codes == 1) | (codes == 2)).to(torch.int32)
    gcum = torch.cat([torch.zeros((B, 1), dtype=torch.int32,
                                  device=codes.device),
                      torch.cumsum(is_gc, dim=1, dtype=torch.int32)], dim=1)
    pos = torch.arange(L, dtype=torch.int32,
                       device=codes.device)[None, :].expand(B, L)
    return gcum, pos


def _conditional_cdf(cdf, x, cdf_max_arg, cdf_max_val):
    """cdf(min(x, maxArg)) / maxVal per row (SalmonUtils.cpp:1524-1528)."""
    xi = torch.minimum(x, cdf_max_arg)
    v = take_clip(cdf, xi)
    return torch.where(x > cdf_max_arg, 1.0,
                       v / cdf_max_val.clamp(min=MIN_CDF_MASS))


def _cdf_bounds(cdf, lens):
    cdf_max_arg = torch.clamp(lens, max=cdf.shape[0] - 1)
    return cdf_max_arg, take_clip(cdf, cdf_max_arg)


def _context_states(c, rc: bool):
    """Per context position i, the (B, L-8) int32 VLMM state index of the
    window starting at each position (sb_context_indices of the window's
    9 bases, fw or reverse-complemented rc; bias_expected._seq_ctx_fw /
    _seq_ctx_rc of the JAX package, one position at a time)."""
    P = c.shape[1] - SB_CTX + 1
    packed = torch.zeros((c.shape[0], P), dtype=torch.int32, device=c.device)
    for j in range(SB_CTX):
        if rc:
            code = 3 - c[:, SB_CTX - 1 - j:SB_CTX - 1 - j + P].clamp(0, 3)
        else:
            code = c[:, j:j + P].clamp(0, 3)
        packed += code << SB_SHIFT[j]
    for i in range(SB_CTX):
        yield i, (packed >> SB_SHIFT[i]) & SB_MASK[i]


def _gc_windows(gcum, lens, pos):
    """The context windows of gcDesc (Transcript.hpp:294-345) in row
    form: per position, the GC count and size of the 5' window of a
    fragment that starts there and of the 3' window of one that ends
    there. Neither depends on the fragment length."""
    lcol = lens[:, None]
    last = lcol - 1

    def cum_at(p):
        return torch.gather(gcum, 1, torch.minimum(p.clamp(min=0), lcol)
                            .to(torch.int64))

    fs = pos - (GC_CTX_OUTSIDE + 1)
    fe = pos + (GC_CTX_INSIDE - 1)
    ts = pos - GC_CTX_INSIDE
    te = pos + GC_CTX_OUTSIDE
    fs_c = fs.clamp(min=0)
    fe_c = torch.minimum(fe, last)
    ts_c = ts.clamp(min=0)
    te_c = torch.minimum(te, last)
    return (cum_at(fe_c + 1) - cum_at(fs_c),
            torch.where(fs < 0, fe_c + 1, fe_c - fs_c),
            cum_at(te_c + 1) - cum_at(ts_c),
            torch.where(ts < 0, te_c + 1, te_c - ts_c))


def _gc_bins(gcum, windows, pos, fl):
    """(frag_bin, cond_bin) of the fragment [s, s + fl - 1] at every
    position s; fl is a 0-d int32 device tensor. The fragment's GC count
    reads the prefix sums at s + fl, its 3' window the windows at its end
    s + fl - 1, each gathered with the index clamped into the row: cells
    where the fragment runs past the transcript read an edge value, and
    every caller masks them."""
    fp_gc, fp_size, tp_gc, tp_size = windows
    L = fp_gc.shape[1]
    end = (pos + fl - 1).to(torch.int64)
    gc = torch.gather(gcum, 1, torch.clamp(end + 1, max=L)) - gcum[:, :L]
    frag_bin = torch.round(100.0 * gc.to(torch.float32)
                           / fl.to(torch.float32)).to(torch.int32).clamp(
        0, 100)
    end = torch.clamp(end, max=L - 1)
    tp_gc = torch.gather(tp_gc, 1, end)
    ctx = (fp_size + torch.gather(tp_size, 1, end)).to(torch.float32)
    frac = torch.where(ctx > 0, torch.round(
        100.0 * (fp_gc + tp_gc).to(torch.float32) / ctx.clamp(min=1.0)),
        0.0)
    w = 100.0 / GC_COND_BINS
    cond_bin = torch.clamp((frac / w).to(torch.int32), max=GC_COND_BINS - 1)
    return frag_bin, cond_bin


def _per_length(cache: GraphCache | None, key, label: str, fls: list,
                fl_ws: torch.Tensor, body) -> None:
    """body(fl, fl_w) for every sampled length, in order, through
    `cache` (loop_step): fl the length as a 0-d int32 device tensor,
    fl_w its (B,) weights, each read inside the step at a device index
    that the step advances. The graph of `key` is dropped after the last
    length: a row chunk's graph is not replayed again."""
    device = fl_ws.device
    fl_t = torch.tensor(fls, dtype=torch.int32, device=device)
    i = torch.zeros(1, dtype=torch.int64, device=device)

    def step():
        body(fl_t.index_select(0, i)[0], fl_ws.index_select(0, i)[0])
        i.add_(1)

    for _ in fls:
        loop_step(cache, key, step, device, label)
    if cache is not None:
        cache.drop(key)


def _fl_grid(fld_low: int, fld_high: int, gc_samp: int):
    """The sampled fragment lengths."""
    return [fld_low + i * gc_samp
            for i in range(max(1, (fld_high - fld_low) // gc_samp + 1))]


def expected_pass_bucket(codes, lens, weights, len_class, cdf,
                         fld_low: int, fld_high: int, gc_samp: int,
                         seq_bias: bool, gc_bias: bool, pos_bias: bool,
                         max_cells: int = MAX_CELLS,
                         hist_copies: int | None = None,
                         stats: list | None = None) -> dict:
    """expected_pass_bucket_impl, compiled: on CUDA tensors through a
    GraphCache of this call, whose graphs of the per-length body each
    serve one row chunk; on CPU tensors the eager body. `stats`, a
    list, receives the cache's SignatureStats."""
    cache = loop_cache(codes.device)
    out = expected_pass_bucket_impl(
        codes, lens, weights, len_class, cdf, fld_low, fld_high, gc_samp,
        seq_bias, gc_bias, pos_bias, max_cells, hist_copies, cache)
    if stats is not None and cache is not None:
        stats.extend(cache.stats.values())
    return out


def expected_pass_bucket_impl(codes, lens, weights, len_class, cdf,
                              fld_low: int, fld_high: int, gc_samp: int,
                              seq_bias: bool, gc_bias: bool, pos_bias: bool,
                              max_cells: int = MAX_CELLS,
                              hist_copies: int | None = None,
                              cache: GraphCache | None = None) -> dict:
    """Pass 1 for one bucket: abundance-weighted expected statistics.

    codes: (B, Lmax) uint8; lens: (B,) int32; weights: (B,) f32
    (alpha/effLen, zero for excluded rows); len_class: (B,) int32; cdf:
    float32 FLD cdf; all on one device. hist_copies: copies of each
    histogram's bins (default 1 on the CPU, HIST_COPIES elsewhere).
    cache: runs the per-length body (eagerly where None); a cache made
    for this call alone, since its signatures leave out the tensors that
    the body reads, which die with the call. Returns
    float32 tensors exp5/exp3 (64, 9), gc_exp (3, 101), pos5/pos3
    (5, 20) for the biases asked for.
    """
    B, L = codes.shape
    if hist_copies is None:
        hist_copies = 1 if codes.device.type == "cpu" else HIST_COPIES
    out = {}
    for r0, r1 in _row_chunks(B, L, max_cells):
        key = ("bias_expected", L, r0, r1, seq_bias, gc_bias, pos_bias,
               fld_low, fld_high, gc_samp, hist_copies)
        label = (f"bias expected pass L={L} rows {r0}-{r1} "
                 f"lengths {fld_low}-{fld_high}/{gc_samp}")
        part = _expected_rows(codes[r0:r1], lens[r0:r1], weights[r0:r1],
                              len_class[r0:r1], cdf, fld_low, fld_high,
                              gc_samp, seq_bias, gc_bias, pos_bias,
                              hist_copies, cache, key, label)
        for k, v in part.items():
            out[k] = out[k] + v if k in out else v
    return out


def _expected_rows(codes, lens, weights, len_class, cdf, fld_low, fld_high,
                   gc_samp, seq_bias, gc_bias, pos_bias, copies, cache,
                   loop_key, label) -> dict:
    B, L = codes.shape
    device = codes.device
    c = codes.to(torch.int32)
    gcum, pos = _row_tables(c)
    cdf_max_arg, cdf_max_val = _cdf_bounds(cdf, lens)
    row_ok = (weights > 0) & (cdf_max_val > MIN_CDF_MASS)
    wrow = torch.where(row_ok, weights, 0.0)

    def zeros(n):
        return torch.zeros(copies * n, dtype=torch.float32, device=device)

    def spread(n_values, n_bins):
        """Offset of the copy of the bins each value adds to."""
        if copies == 1:
            return 0
        return (torch.arange(n_values, dtype=torch.int32, device=device)
                % copies) * n_bins

    def fold(acc, *shape):
        return acc.view(copies, *shape).sum(dim=0)

    out = {}
    P = L - SB_CTX + 1
    if seq_bias and P > 0:
        # weight per window w: condCDF(len - (w + contextLeft)), the max
        # fragment length a read starting in this window could have
        # (SalmonUtils.cpp:1585-1597)
        wpos = pos[:, :P]
        max_fl = lens[:, None] - (wpos + SB_CONTEXT_LEFT)
        dens = _conditional_cdf(cdf, max_fl, cdf_max_arg[:, None],
                                cdf_max_val[:, None])
        wvalid = (wpos + SB_CTX <= lens[:, None]) & (max_fl >= 0)
        wv = torch.where(wvalid, wrow[:, None] * dens, 0.0).reshape(-1)
        off = spread(wv.numel(), SB_ROWS * SB_CTX)
        for key, rc in (("exp5", False), ("exp3", True)):
            acc = zeros(SB_ROWS * SB_CTX)
            for i, idx in _context_states(c, rc):
                acc.index_add_(0, (idx * SB_CTX + i).reshape(-1) + off, wv)
            out[key] = fold(acc, SB_ROWS, SB_CTX)

    if pos_bias:
        dens_fw = _conditional_cdf(cdf, lens[:, None] - pos + 1,
                                   cdf_max_arg[:, None],
                                   cdf_max_val[:, None])
        dens_rc = _conditional_cdf(cdf, pos, cdf_max_arg[:, None],
                                   cdf_max_val[:, None])
        pvalid = pos < lens[:, None]
        flat = (len_class[:, None] * POS_BINS
                + pos_bin_of(pos, lens[:, None])).reshape(-1)
        n = POS_LENGTH_CLASSES * POS_BINS
        flat = flat + spread(flat.numel(), n)
        for key, dens in (("pos5", dens_fw), ("pos3", dens_rc)):
            w = torch.where(pvalid, wrow[:, None] * dens, 0.0).reshape(-1)
            out[key] = fold(zeros(n).index_add_(0, flat, w),
                            POS_LENGTH_CLASSES, POS_BINS)

    if gc_bias:
        n = GC_COND_BINS * GC_BINS
        off = spread(B * L, n)
        acc = torch.zeros(n, dtype=torch.float32, device=device)
        windows = _gc_windows(gcum, lens, pos)
        fls = _fl_grid(fld_low, fld_high, gc_samp)
        fl_ws = _fl_weights(cdf, fls, gc_samp, cdf_max_arg, cdf_max_val)

        def body(fl, fl_w):
            svalid = (pos + fl - 1 < lens[:, None]) & row_ok[:, None]
            frag_bin, cond_bin = _gc_bins(gcum, windows, pos, fl)
            wv = torch.where(svalid, wrow[:, None] * fl_w[:, None], 0.0)
            # one histogram per fragment length, added to the running sum
            # (the JAX package's association)
            acc.add_(fold(zeros(n).index_add_(
                0, (cond_bin * GC_BINS + frag_bin).reshape(-1) + off,
                wv.reshape(-1)), n))

        _per_length(cache, loop_key, label, fls, fl_ws, body)
        out["gc_exp"] = acc.reshape(GC_COND_BINS, GC_BINS)
    return out


def _fl_weights(cdf, fls, gc_samp: int, cdf_max_arg, cdf_max_val):
    """(len(fls), B) conditional FLD mass of (fl - gc_samp, fl] per
    sampled length and row."""
    full = torch.tensor(fls, dtype=cdf_max_arg.dtype,
                        device=cdf_max_arg.device)[:, None].expand(
        len(fls), cdf_max_arg.shape[0])
    return (_conditional_cdf(cdf, full, cdf_max_arg, cdf_max_val)
            - _conditional_cdf(cdf, full - gc_samp, cdf_max_arg,
                               cdf_max_val))


def efflen_pass_bucket(codes, lens, eff_in, process_row, len_class, cdf,
                       fld_low: int, fld_high: int, gc_samp: int,
                       obs5_logp, exp5_logp, obs3_logp, exp3_logp,
                       gc_ratio, pos_grid_fw, pos_grid_rc,
                       seq_bias: bool, gc_bias: bool, pos_bias: bool,
                       no_threshold: bool = False,
                       max_cells: int = MAX_CELLS,
                       stats: list | None = None) -> torch.Tensor:
    """efflen_pass_bucket_impl, compiled as expected_pass_bucket is."""
    cache = loop_cache(codes.device)
    out = efflen_pass_bucket_impl(
        codes, lens, eff_in, process_row, len_class, cdf, fld_low,
        fld_high, gc_samp, obs5_logp, exp5_logp, obs3_logp, exp3_logp,
        gc_ratio, pos_grid_fw, pos_grid_rc, seq_bias, gc_bias, pos_bias,
        no_threshold, max_cells, cache)
    if stats is not None and cache is not None:
        stats.extend(cache.stats.values())
    return out


def efflen_pass_bucket_impl(codes, lens, eff_in, process_row, len_class,
                            cdf, fld_low: int, fld_high: int, gc_samp: int,
                            obs5_logp, exp5_logp, obs3_logp, exp3_logp,
                            gc_ratio, pos_grid_fw, pos_grid_rc,
                            seq_bias: bool, gc_bias: bool, pos_bias: bool,
                            no_threshold: bool = False,
                            max_cells: int = MAX_CELLS,
                            cache: GraphCache | None = None) -> torch.Tensor:
    """Pass 2 for one bucket: bias-corrected effective lengths.

    obs/exp *_logp: (64, 9) float32 conditional log-prob tables (zeros
    when seq_bias is off); gc_ratio: (3, 101); pos_grid_*: (5, POS_GRID)
    obs/exp factor ratio on a fractional-position grid; eff_in (B,)
    float32; process_row (B,) bool; cache: runs the per-length body
    (eagerly where None), made for this call alone, as in
    expected_pass_bucket_impl. Returns (B,) float32 effective lengths
    (unprocessed rows -> eff_in).
    """
    B, L = codes.shape
    tables = (obs5_logp.reshape(-1), exp5_logp.reshape(-1),
              obs3_logp.reshape(-1), exp3_logp.reshape(-1),
              gc_ratio.reshape(-1), pos_grid_fw.reshape(-1),
              pos_grid_rc.reshape(-1))
    parts = []
    for r0, r1 in _row_chunks(B, L, max_cells):
        key = ("bias_efflen", L, r0, r1, seq_bias, gc_bias, pos_bias,
               fld_low, fld_high, gc_samp)
        label = (f"bias efflen pass L={L} rows {r0}-{r1} "
                 f"lengths {fld_low}-{fld_high}/{gc_samp}")
        parts.append(_efflen_rows(
            codes[r0:r1], lens[r0:r1], eff_in[r0:r1], process_row[r0:r1],
            len_class[r0:r1], cdf, fld_low, fld_high, gc_samp, tables,
            seq_bias, gc_bias, pos_bias, no_threshold, cache, key, label))
    return torch.cat(parts) if parts else eff_in.clone()


def _efflen_rows(codes, lens, eff_in, process_row, len_class, cdf,
                 fld_low, fld_high, gc_samp, tables, seq_bias, gc_bias,
                 pos_bias, no_threshold, cache, loop_key,
                 label) -> torch.Tensor:
    obs5, exp5, obs3, exp3, gc_ratio, grid_fw, grid_rc = tables
    B, L = codes.shape
    device = codes.device
    c = codes.to(torch.int32)
    gcum, pos = _row_tables(c)
    cdf_max_arg, cdf_max_val = _cdf_bounds(cdf, lens)
    row_ok = process_row & (cdf_max_val > MIN_CDF_MASS)

    # --- per-position seq factors
    sfw = torch.ones((B, L), dtype=torch.float32, device=device)
    src = torch.ones((B, L), dtype=torch.float32, device=device)
    if seq_bias:
        P = L - SB_CTX + 1
        win_valid = pos[:, :P] + SB_CTX <= lens[:, None]

        def factor(obs, exp, rc):
            lp_obs = lp_exp = None
            for i, idx in _context_states(c, rc):
                k = idx * SB_CTX + i
                lp_obs = obs[k] if lp_obs is None else lp_obs + obs[k]
                lp_exp = exp[k] if lp_exp is None else lp_exp + exp[k]
            return torch.where(win_valid, torch.exp(lp_obs - lp_exp), 1.0)

        # window w -> fw factor applies at read start s = w + 3; rc factor
        # applies at fragment end e = w + 5 (reference: seqFactors filled
        # at readStart then RC reversed, SalmonUtils.cpp:1845-1875)
        sfw[:, SB_CONTEXT_LEFT:SB_CONTEXT_LEFT + P] = factor(obs5, exp5,
                                                             False)
        e0 = SB_CTX - SB_CONTEXT_LEFT - 1
        src[:, e0:e0 + P] = factor(obs3, exp3, True)

    if pos_bias:
        frac_idx = (pos.to(torch.float32)
                    / lens[:, None].to(torch.float32).clamp(min=1.0)
                    * POS_GRID).to(torch.int32).clamp(0, POS_GRID - 1)
        k = len_class[:, None] * POS_GRID + frac_idx
        sfw = sfw * take_clip(grid_fw, k)
        src = src * take_clip(grid_rc, k)

    eff = torch.zeros(B, dtype=torch.float32, device=device)
    windows = _gc_windows(gcum, lens, pos) if gc_bias else None
    fls = _fl_grid(fld_low, fld_high, gc_samp)
    fl_ws = _fl_weights(cdf, fls, gc_samp, cdf_max_arg, cdf_max_val)

    def body(fl, fl_w):
        # e = s + fl - 1: the rc factor at the fragment's end, gathered
        # with the index clamped into the row (cells past the
        # transcript fall outside svalid)
        end = torch.clamp(pos + fl - 1, max=L - 1).to(torch.int64)
        frag = sfw * torch.gather(src, 1, end)
        if gc_bias:
            frag_bin, cond_bin = _gc_bins(gcum, windows, pos, fl)
            frag = frag * take_clip(gc_ratio, cond_bin * GC_BINS + frag_bin)
        svalid = pos + fl - 1 < lens[:, None]
        fl_mass = torch.where(svalid, frag, 0.0).sum(dim=1)
        eff.add_(fl_w * fl_mass)

    _per_length(cache, loop_key, label, fls, fl_ws, body)
    unprocessed = torch.clamp(lens.to(torch.float32) - eff_in, min=0.0)
    if no_threshold:
        # --noBiasLengthThreshold (reference :1959-1964): take the raw
        # corrected length whenever it is meaningful
        out = torch.where((unprocessed > 0.0) & (eff > 1.0), eff, eff_in)
    else:
        # barrier (reference :1955-1975):
        # effLensOut = max(eff, min(elenNoBias, unprocessedLen))
        offset = unprocessed.clamp(min=1.0)
        out = torch.maximum(eff, torch.minimum(eff_in, offset))
    return torch.where(row_ok, out, eff_in)
