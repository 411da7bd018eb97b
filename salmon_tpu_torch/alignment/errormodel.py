"""Alignment error model: per-position-bin transition matrices.

Reference: AlignmentModel (include/salmon/internal/alignment/
AlignmentModel.hpp, src/alignment/AlignmentModel.cpp): alignment columns
are encoded as states refBase*9 + readBase over the 9-symbol alphabet
{A,C,G,T,-,S,H,P,N} (AlignmentCommon.hpp:38-46 + setBasesFromCIGAROp_);
the model is P(curState | prevState) per read-position bin (4 bins),
left/right mates separate; the likelihood of an alignment is
sum(log P(cur|prev)) minus the same-length background of (0,0)->(0,0)
transitions. Learned during burn-in with posterior-weighted updates.

Host copy of salmon_tpu/alignment/errormodel.py: the CIGAR walk is
vectorized with numpy repeat/cumsum over a whole record batch at once (no
per-record Python loop); counts and likelihood evaluation are flat
bincount / gather-sum over the aligned columns. AlignmentErrorModel is
the plain version of errormodel_device.DeviceAlignmentErrorModel and
takes the records that do not fit its grid; ONTErrorModel serves --ont.
"""

from __future__ import annotations

import numpy as np

N_STATES = 9
N_FULL = 82          # 81 pair states + START
START_STATE = 81
N_BINS = 4
ALN_DASH = 4
ALN_SOFT = 5
ALN_HARD = 6
ALN_PAD = 7
ALN_SKIP = 8

# BAM cigar ops: MIDNSHP=X
_CONSUMES_READ = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=np.int64)
_CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.int64)


def expand_batch(b, sel_idx, ref_map, seq_codes, seq_off, txp_lens):
    """Expand selected BAM records into per-aligned-column state arrays.

    Args:
      b: BamBatch; sel_idx: record indices to expand; ref_map: BAM ref ->
      txp id; seq_codes/seq_off/txp_lens: concatenated target sequences.

    Returns dict with (n_cols,) arrays: aln (record ordinal in sel_idx),
    prev, cur (state ids), bin (read-position bin), all int32.
    """
    if sel_idx.size == 0:
        return {k: np.zeros(0, np.int32)
                for k in ("aln", "prev", "cur", "bin")}
    n = sel_idx.size
    # flatten each record's cigar ops into columns (vectorized ragged
    # ranges — a per-record arange loop costs more than the expansion)
    c_off = b.cigar_off[sel_idx].astype(np.int64)
    c_n = b.cigar_n[sel_idx].astype(np.int64)
    total_ops = int(c_n.sum())
    op_rec = np.repeat(np.arange(n), c_n)
    op_idx = (np.repeat(c_off, c_n) + np.arange(total_ops)
              - np.repeat(np.cumsum(c_n) - c_n, c_n)) if total_ops \
        else np.zeros(0, np.int64)
    ops = b.cigar_op[op_idx].astype(np.int64)
    oplens = b.cigar_oplen[op_idx].astype(np.int64)

    col_rec = np.repeat(op_rec, oplens)
    col_op = np.repeat(ops, oplens)
    n_cols = col_rec.size
    if n_cols == 0:
        return {k: np.zeros(0, np.int32)
                for k in ("aln", "prev", "cur", "bin")}

    # per-column read/ref cursors: cumsum of consumes within each record
    cons_read = _CONSUMES_READ[np.clip(col_op, 0, 8)]
    cons_ref = _CONSUMES_REF[np.clip(col_op, 0, 8)]
    # record boundaries in column space
    cols_per_rec = np.zeros(n, dtype=np.int64)
    np.add.at(cols_per_rec, col_rec, 1)
    starts = np.concatenate([[0], np.cumsum(cols_per_rec)[:-1]])

    def seg_cumsum_excl(x):
        """Exclusive cumsum of x, restarted at each record boundary."""
        offs = np.concatenate([[0], np.cumsum(x)])[:-1]
        rec_base = offs[starts][col_rec]
        return offs - rec_base

    read_cursor = seg_cumsum_excl(cons_read)
    ref_cursor = seg_cumsum_excl(cons_ref)

    read_len = b.read_len[sel_idx].astype(np.int64)
    pos = b.pos[sel_idx].astype(np.int64)
    txp = ref_map[np.clip(b.refid[sel_idx], 0, ref_map.size - 1)]
    toff = seq_off[np.clip(txp, 0, seq_off.size - 2)].astype(np.int64)
    tlen = txp_lens[np.clip(txp, 0, txp_lens.size - 1)].astype(np.int64)

    rl = read_len[col_rec]
    seq_offsets = b.seq_off[sel_idx]
    read_base = b.seq_buf[
        seq_offsets[col_rec] + np.minimum(read_cursor, rl - 1)
    ].astype(np.int64)
    ref_pos = pos[col_rec] + ref_cursor
    ref_ok = (ref_pos >= 0) & (ref_pos < tlen[col_rec])
    ref_base = np.where(
        ref_ok,
        seq_codes[np.clip(toff[col_rec] + ref_pos, 0,
                          seq_codes.size - 1)].astype(np.int64), 4)

    # state symbols per CIGAR op (setBasesFromCIGAROp_): one table
    # lookup per side instead of four full-array where passes.
    # rb override per op: I->dash, S->soft, H->hard, P->pad; else base
    col_op_c = np.clip(col_op, 0, 8)
    rb_override = np.array([-1, ALN_DASH, -1, -1, ALN_SOFT, ALN_HARD,
                            ALN_PAD, -1, -1], np.int64)[col_op_c]
    qb_override = np.array([-1, -1, ALN_DASH, ALN_SKIP, -1, ALN_HARD,
                            ALN_PAD, -1, -1], np.int64)[col_op_c]
    rb = np.where(rb_override >= 0, rb_override, ref_base)
    qb = np.where(qb_override >= 0, qb_override, read_base)
    qb = np.clip(qb, 0, N_STATES - 1)
    rb = np.clip(rb, 0, N_STATES - 1)

    cur = (rb * N_STATES + qb).astype(np.int32)
    prev = np.empty_like(cur)
    prev[1:] = cur[:-1]
    prev[starts] = START_STATE
    is_start = np.zeros(n_cols, dtype=bool)
    is_start[starts] = True
    prev = np.where(is_start, START_STATE, prev)

    pbin = np.minimum((read_cursor * N_BINS) // np.maximum(rl, 1),
                      N_BINS - 1).astype(np.int32)
    return {"aln": col_rec.astype(np.int32), "prev": prev,
            "cur": cur.astype(np.int32), "bin": pbin}


def clip_counts(b, sel_idx):
    """Per-record clip base counts from the CIGAR pools (vectorized).

    Returns (fclips, bclips, sclips, hclips): clip bases at the front /
    back (soft+hard, like the reference's ErrorCount.fclips_/bclips_,
    AlignmentCommon.hpp:62-63 + computeErrorCount), total soft-clip
    bases and total hard-clip bases, each (len(sel_idx),) int64.
    """
    sel = np.asarray(sel_idx, np.int64)
    off = b.cigar_off[sel]
    n = b.cigar_n[sel].astype(np.int64)
    op = np.asarray(b.cigar_op)
    oplen = np.asarray(b.cigar_oplen).astype(np.int64)

    def end_clips(o0, o1, has2):
        # clip bases among the first (or last) two ops: H then S (or S
        # then H at the back); a lone S or H also counts
        c0_op, c0_len = op[o0], oplen[o0]
        c1_op, c1_len = op[o1], oplen[o1]
        first = np.where((c0_op == 4) | (c0_op == 5), c0_len, 0)
        second = np.where(
            has2 & ((c0_op == 4) | (c0_op == 5))
            & ((c1_op == 4) | (c1_op == 5)), c1_len, 0)
        return first + second

    has2 = n >= 2
    o0 = off
    o1 = np.where(has2, off + 1, off)
    fcl = np.where(n > 0, end_clips(o0, o1, has2), 0)
    e0 = off + np.maximum(n - 1, 0)
    e1 = np.where(has2, off + n - 2, e0)
    bcl = np.where(n > 0, end_clips(e0, e1, has2), 0)
    # lone-op record would double count front+back; a single clip op
    # cannot be both (an alignment needs >=1 aligned base), keep as-is
    # total S and H bases per record via segment sums over the pool
    if op.size:
        is_s = np.where(op == 4, oplen, 0)
        is_h = np.where(op == 5, oplen, 0)
        cs_s = np.concatenate([[0], np.cumsum(is_s)])
        cs_h = np.concatenate([[0], np.cumsum(is_h)])
        scl = cs_s[off + n] - cs_s[off]
        hcl = cs_h[off + n] - cs_h[off]
    else:
        scl = np.zeros(sel.shape[0], np.int64)
        hcl = np.zeros(sel.shape[0], np.int64)
    return fcl, bcl, scl, hcl


class ONTErrorModel:
    """Oxford-Nanopore error model (reference ONTAlignmentModel,
    src/alignment/ONTAlignmentModel.cpp).

    Per-100bp-length-bin running averages (mass, sum) of: the error
    rate (errors / aligned length, binned by aligned length) and the
    front / back clip bases (binned by read length). The likelihood of
    an alignment (logLikelihood, :26-127) is

      * a two-tailed Binomial(alignLen, binMeanErrorRate) probability of
        observing an error count at least as far from the bin median as
        this alignment's ("likelihood ... to get a read further away
        from mode"), plus
      * front/back Geometric(1/(meanClip+1)) tail ratios, penalizing
        only clips beyond the bin mean (:92-124).

    Error counts come from the NM tag (= mismatches + inserted +
    deleted bases, the reference's ErrorCount.ims()); clip bases come
    from the CIGAR (clip_counts above).
    """

    BIN_LEN = 100          # reference binLen (ONTAlignmentModel.hpp:22)
    MAX_READ_LEN = 50000   # reference maxReadLen (ONTAlignmentModel.hpp:21)
    N_LEN_BINS = MAX_READ_LEN // BIN_LEN + 1
    LL_MIN = 1e-10         # reference llMin (ONTAlignmentModel.cpp:30)
    LOG_0 = -1e30

    def __init__(self, alpha: float = 0.0):
        # (mass, sum) running pairs per length bin
        self.err = np.zeros((self.N_LEN_BINS, 2))
        self.fclip = np.zeros((self.N_LEN_BINS, 2))
        self.bclip = np.zeros((self.N_LEN_BINS, 2))

    def normalize(self):
        """No-op: the running (mass, sum) averages are consumed directly
        (kept for interface parity with AlignmentErrorModel)."""

    def update(self, read_len, nm, fclips, bclips, sclips, hclips,
               weights):
        """read_len: l_seq (read bases, excludes hard clips); nm: NM tag;
        clips from clip_counts. Reference update():137-194."""
        read_len = np.asarray(read_len, np.int64)
        align_len = np.maximum(read_len - sclips, 1)
        err_rate = np.maximum(nm, 0) / align_len
        full_len = np.maximum(read_len + hclips, 1)
        fr = fclips / full_len
        br = bclips / full_len
        ok = (err_rate <= 1.0) & (fr <= 1.0) & (br <= 1.0)
        w = np.where(ok, weights, 0.0)

        eb = np.minimum(align_len // self.BIN_LEN, self.N_LEN_BINS - 1)
        np.add.at(self.err, (eb, 0), w)
        np.add.at(self.err, (eb, 1), w * err_rate)
        cb = np.minimum(read_len // self.BIN_LEN, self.N_LEN_BINS - 1)
        # reference accumulates (binIndex+1)*binLen * clipRate — the
        # clip count rescaled to the bin's upper length
        np.add.at(self.fclip, (cb, 0), w)
        np.add.at(self.fclip, (cb, 1),
                  (cb + 1) * self.BIN_LEN * w * fr)
        np.add.at(self.bclip, (cb, 0), w)
        np.add.at(self.bclip, (cb, 1),
                  (cb + 1) * self.BIN_LEN * w * br)

    @staticmethod
    def _binom_cdf(k, n, p):
        """P(X <= k) for X ~ Binomial(n, p), vectorized; k<0 -> 0,
        k>=n -> 1."""
        from scipy.special import betainc
        k = np.asarray(k, np.float64)
        n = np.asarray(n, np.float64)
        p = np.clip(np.asarray(p, np.float64), 1e-12, 1 - 1e-12)
        kc = np.clip(k, 0, np.maximum(n - 1, 0))
        cdf = betainc(np.maximum(n - kc, 1e-12), kc + 1.0, 1.0 - p)
        return np.where(k < 0, 0.0, np.where(k >= n, 1.0, cdf))

    def _clip_ll(self, tab, read_len, clips):
        cb = np.minimum(np.asarray(read_len, np.int64) // self.BIN_LEN,
                        self.N_LEN_BINS - 1)
        mass = tab[cb, 0]
        mean = np.where(mass > 0, tab[cb, 1] / np.maximum(mass, 1e-300),
                        0.0)
        trained = (mass > 0) & (tab[cb, 1] > 0)
        # Geometric(p = 1/(mean+1)) tail ratio: only clips beyond the
        # rounded bin mean are penalized (reference :92-124); the
        # closed form of (1-cdf(clips))/(1-cdf(rmean)) is (1-p)^(clips
        # - rmean)
        rmean = np.round(mean)
        q = 1.0 - 1.0 / (mean + 1.0)
        excess = np.maximum(np.asarray(clips, np.float64) - rmean, 0.0)
        lik = np.power(np.maximum(q, 1e-300), excess)
        ll = np.where(lik < self.LL_MIN, self.LOG_0, np.log(
            np.maximum(lik, 1e-300)))
        return np.where(trained, ll, 0.0)

    def log_likelihood(self, read_len, nm, fclips, bclips, sclips,
                       hclips):
        read_len = np.asarray(read_len, np.int64)
        align_len = read_len - sclips
        empty = align_len <= 0
        align_len = np.maximum(align_len, 1)
        eb = np.minimum(align_len // self.BIN_LEN, self.N_LEN_BINS - 1)
        mass = self.err[eb, 0]
        err_p = np.where(mass > 0,
                         self.err[eb, 1] / np.maximum(mass, 1e-300), 0.0)
        trained = mass > np.finfo(np.float64).tiny

        # binomial median: smallest m with CDF(m) >= 0.5
        m0 = np.floor(align_len * err_p)
        med = np.where(self._binom_cdf(m0, align_len, err_p) >= 0.5,
                       m0, m0 + 1)
        k = np.maximum(np.asarray(nm, np.int64), 0)
        off = np.abs(med - k)
        lo = np.maximum(med - off, 0)
        hi = np.minimum(med + off, align_len)
        lik = (self._binom_cdf(lo, align_len, err_p)
               + 1.0 - self._binom_cdf(hi, align_len, err_p))
        err_ll = np.where(lik < self.LL_MIN, self.LOG_0,
                          np.log(np.maximum(lik, 1e-300)))
        err_ll = np.where(trained & (err_p > 0), err_ll, 0.0)

        total = (err_ll
                 + self._clip_ll(self.fclip, read_len, fclips)
                 + self._clip_ll(self.bclip, read_len, bclips))
        return np.where(empty, self.LOG_0, total)


class AlignmentErrorModel:
    """Transition-count model with Laplace prior (reference alpha=1e-3
    default in AtomicMatrix)."""

    def __init__(self, alpha: float = 1e-3):
        self.counts = np.full((2, N_BINS, N_FULL, N_FULL), alpha)
        self._logp = None

    def update(self, cols: dict, weights: np.ndarray, mate: int) -> None:
        """cols from expand_batch; weights: (n_records,) posterior mass;
        mate: 0=left, 1=right."""
        if cols["aln"].size == 0:
            return
        w = weights[cols["aln"]]
        flat = (cols["bin"].astype(np.int64) * N_FULL * N_FULL
                + cols["prev"].astype(np.int64) * N_FULL + cols["cur"])
        add = np.bincount(flat, weights=w,
                          minlength=N_BINS * N_FULL * N_FULL)
        self.counts[mate] += add.reshape(N_BINS, N_FULL, N_FULL)
        self._logp = None

    def normalize(self) -> None:
        tot = self.counts.sum(axis=3, keepdims=True)
        self._logp = np.log(self.counts / np.maximum(tot, 1e-300))

    def log_likelihood(self, cols: dict, n_records: int,
                       mate: int) -> np.ndarray:
        """Per-record fg - bg log-likelihood (reference logLikelihood:
        bg uses the (0,0) self-transition per column)."""
        if self._logp is None:
            self.normalize()
        out = np.zeros(n_records)
        if cols["aln"].size == 0:
            return out
        lp = self._logp[mate]
        fg = lp[cols["bin"], cols["prev"], cols["cur"]]
        bg = lp[cols["bin"], 0, 0]
        np.add.at(out, cols["aln"], fg - bg)
        return out
