"""Alignment error model on the device (the `-a` mode's model).

Counterpart of salmon_tpu/alignment/errormodel_device.py (reference
AlignmentModel::update / logLikelihood,
include/salmon/internal/alignment/AlignmentModel.hpp:10-84,
src/alignment/AlignmentModel.cpp): per-read-position-bin 82x82
transition matrices, likelihood = sum(log P(cur|prev)) minus the
(0,0)->(0,0) background, learned with posterior-weighted updates in
processMiniBatch (src/alignment/SalmonQuantifyAlignments.cpp:126).

Every record is one row of an (N, C) grid and the CIGAR expansion is a
handful of whole-grid torch operations on `device`:

  * per-column op index = searchsorted of the column in the record's
    cumulative op lengths (P = 16 padded ops),
  * read/ref cursors = masked prefix sums along the row,
  * read/ref bases = one gather per side,
  * transition states = small-table lookups; prev = a row shift
    (column 0 is the START state),
  * update: one flat index_add_ of the valid columns into the
    (2 x 4 x 82 x 82) count vector,
  * likelihood: one flat gather from the normalized log-probabilities,
    summed along the row (fg - bg per reference logLikelihood).

Records that do not fit the grid (more than 16 CIGAR ops, or more than C
aligned columns) go through the numpy walk of errormodel.py, as in the
JAX package; their count and likelihood contributions merge exactly (the
split is by record, and the grid width only grows). Counts stay on the
device between batches; normalize() is a device log-normalize.

The five steps (expand_fused, ll_keys, update_keys, count_update,
log_likelihood_rows) are the counterparts of the JAX model's five
jax.jit programs: each `*_impl` is the eager body, and its entry runs it
through one captured CUDA graph per signature of the model's GraphCache
(utils.graphcache) on the card, or runs it itself on CPU tensors. A
signature repeats because the grid's rows are padded to a power-of-four
bucket from 4,096 and its width only grows, as in the JAX package's
_pack; the op tables are device tensors made once a device, and an
invalid column scatters into one sentinel slot, so that no step uploads
from the host or takes a shape from the data.
"""

from __future__ import annotations

import numpy as np
import torch

from salmon_tpu_torch import _native
from salmon_tpu_torch.utils.graphcache import (GraphCache, run_compiled,
                                               tensor_signature)

from salmon_tpu_torch.alignment.errormodel import (ALN_DASH, ALN_HARD,
                                                   ALN_PAD, ALN_SKIP,
                                                   ALN_SOFT, N_BINS, N_FULL,
                                                   N_STATES, START_STATE,
                                                   AlignmentErrorModel,
                                                   expand_batch)

MAXOPS = 16           # padded CIGAR ops per record (P)
COL_SLACK = 48        # extra columns beyond the longest read (indels)
N_FLAT = N_BINS * N_FULL * N_FULL
SENTINEL = N_FLAT     # invalid-column key (one extra scatter bucket)
ROW_BUCKET = 4096     # the least padded row count; buckets grow by 4x

# per-op consume flags and state overrides (MIDNSHP=X; -1 = use base)
_CONS_READ = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], np.int64)
_CONS_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], np.int64)
_RB_OVR = np.array([-1, ALN_DASH, -1, -1, ALN_SOFT, ALN_HARD,
                    ALN_PAD, -1, -1], np.int64)
_QB_OVR = np.array([-1, -1, ALN_DASH, ALN_SKIP, -1, ALN_HARD,
                    ALN_PAD, -1, -1], np.int64)

# the op tables on each device, made once (op_tables)
_TABLES: dict = {}


def op_tables(device) -> tuple:
    """(consumes read, consumes reference, reference-state override,
    read-state override) per CIGAR op, int64 tensors on `device`: made
    at the first call for a device, so that a step reads them in place
    (a graph cannot capture an upload from pageable host memory)."""
    device = torch.device(device)
    tabs = _TABLES.get(device)
    if tabs is None:
        tabs = _TABLES[device] = tuple(
            torch.as_tensor(a, device=device)
            for a in (_CONS_READ, _CONS_REF, _RB_OVR, _QB_OVR))
    return tabs


def row_bucket(n: int) -> int:
    """Padded rows for n records: 4,096, then each power of four above
    it (the JAX package's _pack buckets)."""
    npad = ROW_BUCKET
    while npad < n:
        npad <<= 2
    return npad


def expand_keys(ops, oplens, rseq, rlen, toff, pos, tlen, seq_codes):
    """(N, C) int64 flat transition keys (SENTINEL where invalid) and the
    (N, C) validity mask, C = rseq.shape[1] + COL_SLACK.

    ops/oplens: (N, P) CIGAR ops and lengths (all 0 for a row that does
    not fit); rseq: (N, RL) read codes; rlen, toff, pos, tlen: (N,) read
    length, transcript offset into seq_codes, alignment start and
    transcript length."""
    dev = ops.device
    N, P = ops.shape
    C = rseq.shape[1] + COL_SLACK
    cum = torch.cumsum(oplens.long(), dim=1)                  # (N, P)
    colj = torch.arange(C, dtype=torch.int64, device=dev)
    # op index of each column: how many ops end at or before it
    opidx = torch.searchsorted(cum, colj.expand(N, C).contiguous(),
                               right=True)                     # (N, C)
    valid = colj[None, :] < cum[:, -1:]
    opv = torch.where(opidx < P, torch.gather(
        ops.long(), 1, opidx.clamp(max=P - 1)), 0).clamp(0, 8)
    cons_read, cons_ref, rb_ovr, qb_ovr = op_tables(dev)

    cr = cons_read[opv] * valid
    cf = cons_ref[opv] * valid
    readcur = torch.cumsum(cr, dim=1) - cr                    # exclusive
    refcur = torch.cumsum(cf, dim=1) - cf

    rl = rlen.long().clamp(min=1)[:, None]
    read_base = torch.gather(rseq.long(), 1,
                             torch.minimum(readcur, rl - 1))
    rpos = pos.long()[:, None] + refcur
    ref_ok = (rpos >= 0) & (rpos < tlen.long()[:, None])
    gidx = (toff.long()[:, None] + rpos).clamp(0, seq_codes.shape[0] - 1)
    ref_base = torch.where(ref_ok, seq_codes[gidx].long(), 4)

    rb_o, qb_o = rb_ovr[opv], qb_ovr[opv]
    rb = torch.where(rb_o >= 0, rb_o, ref_base).clamp(0, N_STATES - 1)
    qb = torch.where(qb_o >= 0, qb_o, read_base).clamp(0, N_STATES - 1)
    cur = rb * N_STATES + qb
    prev = torch.cat([torch.full((N, 1), START_STATE, dtype=torch.int64,
                                 device=dev), cur[:, :-1]], dim=1)
    prev = torch.where(valid, prev, START_STATE)

    pbin = torch.clamp((readcur * N_BINS) // rl, max=N_BINS - 1)
    key = pbin * (N_FULL * N_FULL) + prev * N_FULL + cur
    return torch.where(valid, key, SENTINEL), valid


def _scatter_valid(key, valid, w, n):
    """(n,) float32 sums of each row's weight over its valid columns'
    keys: every column adds into an (n + 1,) vector, an invalid one
    (key == n) its weight 0.0 into the sentinel slot, which is dropped
    (no mask indexing: no shape taken from the data)."""
    wcol = torch.where(valid, w.to(torch.float32)[:, None], 0.0)
    return torch.zeros(n + 1, dtype=torch.float32,
                       device=key.device).index_add_(
        0, key.reshape(-1), wcol.reshape(-1))[:n]


def count_update_impl(ops, oplens, rseq, rlen, toff, pos, tlen, w,
                      seq_codes):
    """(N_FLAT,) count increments of one mate's records, weighted by
    w (N,)."""
    key, valid = expand_keys(ops, oplens, rseq, rlen, toff, pos, tlen,
                             seq_codes)
    return _scatter_valid(key, valid, w, N_FLAT)


def log_likelihood_rows_impl(ops, oplens, rseq, rlen, toff, pos, tlen,
                             lp_flat, lp_bg, seq_codes):
    """(N,) fg - bg log-likelihood of one mate's records under the
    normalized (N_FLAT,) log-probabilities and (N_BINS,) background."""
    key, valid = expand_keys(ops, oplens, rseq, rlen, toff, pos, tlen,
                             seq_codes)
    zero = lp_flat.new_zeros(1)
    fg = torch.cat([lp_flat, zero])[key]
    # sentinel -> bin N_BINS, the padded 0
    bg = torch.cat([lp_bg, zero])[torch.clamp(key // (N_FULL * N_FULL),
                                              max=N_BINS)]
    return torch.where(valid, fg - bg, 0.0).sum(dim=1)


# --- fused batch path: expand once per batch (both mates in one grid),
# then reuse the keys for likelihood and update. Keys carry the mate:
# key_full = mate * N_FLAT + key; 2 * N_FLAT marks an invalid column.

def expand_fused_impl(ops, oplens, rseq, rlen, toff, pos, tlen, mate,
                      seq_codes):
    key, valid = expand_keys(ops, oplens, rseq, rlen, toff, pos, tlen,
                             seq_codes)
    return torch.where(valid, mate.long()[:, None] * N_FLAT + key,
                       2 * N_FLAT)


def ll_keys_impl(key_full, lp2_flat, lp2_bg):
    """(N,) fg - bg log-likelihood from fused keys, lp2_flat the
    (2 * N_FLAT,) log-probabilities of both mates, lp2_bg their
    (2 * N_BINS,) backgrounds."""
    valid = key_full < 2 * N_FLAT
    zero = lp2_flat.new_zeros(1)
    fg = torch.cat([lp2_flat, zero])[key_full]
    # key_full // (82 * 82) == mate * N_BINS + bin exactly
    bg = torch.cat([lp2_bg, zero])[torch.clamp(
        key_full // (N_FULL * N_FULL), max=2 * N_BINS)]
    return torch.where(valid, fg - bg, 0.0).sum(dim=1)


def update_keys_impl(key_full, w):
    """(2, N_BINS, 82, 82) count increments from fused keys, each row
    weighted by w (N,)."""
    return _scatter_valid(key_full, key_full < 2 * N_FLAT, w,
                          2 * N_FLAT).reshape(2, N_BINS, N_FULL, N_FULL)


# --- the compiled steps: the counterparts of the JAX model's jax.jit
# programs. A step's signature: its name, its inputs' shapes and dtypes,
# the addresses of the tensors it reads in place (seq_codes and the op
# tables) and the mate of a one-mate step.

def compiled_step(cache: GraphCache | None, name: str, impl,
                  inputs: list, reads: tuple = (), mate=None):
    """impl(*inputs) as a compiled step (graphcache.run_compiled): on the
    card through the graph of its signature in the model's cache, on
    CPU tensors without a cache impl itself. The result stays readable
    until the next call of the same signature but one."""
    key = (name, tuple(tensor_signature(t) for t in inputs),
           tuple((t.data_ptr(), tensor_signature(t)) for t in reads), mate)
    label = (f"error model {name} shapes="
             f"{[tuple(t.shape) for t in inputs]} mate={mate}")
    return run_compiled(cache, key, lambda ts: {"out": impl(*ts)},
                        list(inputs), label)["out"]


def _grid_reads(seq_codes) -> tuple:
    return (seq_codes, *op_tables(seq_codes.device))


def expand_fused(ops, oplens, rseq, rlen, toff, pos, tlen, mate,
                 seq_codes, *, cache: GraphCache | None = None):
    """expand_fused_impl, compiled (compiled_step)."""
    return compiled_step(
        cache, "expand_fused",
        lambda *ts: expand_fused_impl(*ts, seq_codes),
        [ops, oplens, rseq, rlen, toff, pos, tlen, mate],
        _grid_reads(seq_codes))


def ll_keys(key_full, lp2_flat, lp2_bg, *,
            cache: GraphCache | None = None):
    """ll_keys_impl, compiled (the log-probabilities are inputs, copied
    into the graph's own at each replay)."""
    return compiled_step(cache, "ll_keys", ll_keys_impl,
                         [key_full, lp2_flat, lp2_bg])


def update_keys(key_full, w, *, cache: GraphCache | None = None):
    """update_keys_impl, compiled."""
    return compiled_step(cache, "update_keys", update_keys_impl,
                         [key_full, w])


def count_update(ops, oplens, rseq, rlen, toff, pos, tlen, w, seq_codes,
                 *, cache: GraphCache | None = None, mate=None):
    """count_update_impl, compiled; `mate` goes into the signature."""
    return compiled_step(
        cache, "count_update",
        lambda *ts: count_update_impl(*ts, seq_codes),
        [ops, oplens, rseq, rlen, toff, pos, tlen, w],
        _grid_reads(seq_codes), mate)


def log_likelihood_rows(ops, oplens, rseq, rlen, toff, pos, tlen,
                        lp_flat, lp_bg, seq_codes, *,
                        cache: GraphCache | None = None, mate=None):
    """log_likelihood_rows_impl, compiled; `mate` goes into the
    signature."""
    return compiled_step(
        cache, "log_likelihood_rows",
        lambda *ts: log_likelihood_rows_impl(*ts, seq_codes),
        [ops, oplens, rseq, rlen, toff, pos, tlen, lp_flat, lp_bg],
        _grid_reads(seq_codes), mate)


class PreparedBatch:
    """Device keys for one batch's kept records, expanded once and
    shared by log_likelihood() and update() (the reference touches each
    alignment's CIGAR once per minibatch too)."""

    def __init__(self, model, b, i1, i2, ref_map):
        self.model = model
        self.b = b
        self.ref_map = ref_map
        self.paired = i2 is not None
        i1 = np.asarray(i1, np.int64)
        self.k = i1.size
        if self.paired:
            self.sel = np.concatenate([i1, np.asarray(i2, np.int64)])
            self.mate = np.repeat(np.array([0, 1], np.int32), self.k)
        else:
            self.sel = i1
            self.mate = np.zeros(self.k, np.int32)
        p, self.fits, self.n = model._pack_padded(b, self.sel, ref_map)
        m = np.zeros(p["rlen"].shape[0], np.int32)
        m[:self.n] = self.mate
        self.keys = expand_fused(
            p["ops"], p["oplens"], p["rseq"], p["rlen"], p["toff"],
            p["pos"], p["tlen"], model._put(m), model.seq_codes,
            cache=model.graphs)
        self._rest_cols = None  # lazy numpy expansion of overflow rows

    def _rest(self):
        if self._rest_cols is None:
            rest = ~self.fits
            self._rest_cols = {}
            for mt in (0, 1) if self.paired else (0,):
                rsel = rest & (self.mate == mt)
                if rsel.any():
                    self._rest_cols[mt] = (rsel, expand_batch(
                        self.b, self.sel[rsel], self.ref_map,
                        self.model._seq_host, self.model._seq_off,
                        self.model._txp_lens))
        return self._rest_cols

    def log_likelihood(self):
        """(k,) summed over mates, aligned with i1/i2."""
        model = self.model
        if model._logp is None:
            model.normalize()
        ll = np.zeros(self.sel.size)
        if self.fits.any():
            lv = ll_keys(self.keys, model._logp.reshape(-1),
                         model._lp_bg.reshape(-1),
                         cache=model.graphs)[:self.n].cpu().numpy()
            ll[self.fits] = lv[self.fits]
        for mt, (rsel, cols) in self._rest().items():
            ll[rsel] = model._np_eval.log_likelihood(
                cols, int(rsel.sum()), mt)
        return ll[:self.k] + (ll[self.k:] if self.paired else 0.0)

    def update(self, w):
        """Posterior-weighted count update; w aligned with i1/i2."""
        model = self.model
        w = np.asarray(w, np.float32)
        wfull = np.concatenate([w, w]) if self.paired else w
        if self.fits.any():
            wg = np.zeros(self.keys.shape[0], np.float32)
            wg[:self.n] = np.where(self.fits, wfull, 0.0)
            model.counts += update_keys(self.keys, model._put(wg),
                                        cache=model.graphs)
        for mt, (rsel, cols) in self._rest().items():
            model._np_model.update(cols, wfull[rsel], mt)
            model._np_dirty = True
        model._logp = None

    @property
    def host_records(self) -> int:
        """Records of this batch that take the numpy walk."""
        return int((~self.fits).sum())


def pad_records(b, sel, RL: int, npad: int | None = None) -> tuple:
    """The records `sel` of BamBatch b on a fixed (npad, MAXOPS) CIGAR
    grid and an (npad, RL) read-code grid, npad = len(sel) unless given
    (rows past len(sel) all zeros): (ops i32, oplens i32, rseq u8, fits
    bool of the len(sel) records). A row that does not fit (no op or
    more than MAXOPS, a read longer than RL, more than RL + COL_SLACK
    aligned columns) is all zeros. The native repack (csrc/bamreader.cpp
    bam_pad_batch); pad_records_numpy is its plain version."""
    n = sel.size
    npad = n if npad is None else npad
    ops = np.zeros((npad, MAXOPS), np.int32)
    oplens = np.zeros((npad, MAXOPS), np.int32)
    rseq = np.zeros((npad, RL), np.uint8)
    ok = np.empty(n, np.uint8)
    _native.lib().bam_pad_batch(
        n, np.ascontiguousarray(sel, np.int64),
        np.ascontiguousarray(b.read_len, np.int32),
        np.ascontiguousarray(b.seq_off, np.int64),
        np.ascontiguousarray(b.seq_buf, np.uint8),
        np.ascontiguousarray(b.cigar_off, np.int64),
        np.ascontiguousarray(b.cigar_n, np.int32),
        np.ascontiguousarray(b.cigar_op, np.uint8),
        np.ascontiguousarray(b.cigar_oplen, np.uint32),
        RL, MAXOPS, RL + COL_SLACK, ops, oplens, rseq, ok)
    fits = ok.astype(bool)
    # the native pass keeps the ops of a row whose columns overflow
    over = np.nonzero(~fits)[0]
    ops[over] = 0
    oplens[over] = 0
    return ops, oplens, rseq, fits


def pad_records_numpy(b, sel, RL: int) -> tuple:
    """Plain version of pad_records, in numpy."""
    rl_all = b.read_len[sel].astype(np.int32)
    cn = b.cigar_n[sel].astype(np.int64)
    co = b.cigar_off[sel].astype(np.int64)
    opcols = np.arange(MAXOPS, dtype=np.int64)
    gather = np.minimum(co[:, None] + opcols,
                        max(b.cigar_op.size - 1, 0))
    opmask = (opcols[None, :] < cn[:, None]) & (cn[:, None] <= MAXOPS)
    ops = np.where(opmask, b.cigar_op[gather], 0).astype(np.int32)
    oplens = np.where(opmask, b.cigar_oplen[gather], 0).astype(np.int32)
    fits = ((cn > 0) & (cn <= MAXOPS) & (rl_all <= RL)
            & (oplens.sum(axis=1) <= RL + COL_SLACK))
    ops[~fits] = 0
    oplens[~fits] = 0
    so = b.seq_off[sel].astype(np.int64)
    rcols = np.arange(RL, dtype=np.int64)
    sgather = np.minimum(so[:, None] + rcols,
                         max(b.seq_buf.size - 1, 0))
    rmask = (rcols[None, :] < rl_all[:, None]) & fits[:, None]
    rseq = np.where(rmask, b.seq_buf[sgather], 0).astype(np.uint8)
    return ops, oplens, rseq, fits


class DeviceAlignmentErrorModel:
    """Functional twin of errormodel.AlignmentErrorModel whose counts,
    expansion and likelihood live on `device`."""

    def __init__(self, seq_codes, seq_off, txp_lens,
                 alpha: float = 1e-3, read_len_cap: int = 512,
                 device="cuda"):
        self.device = torch.device(device)
        self.alpha = alpha
        self._seq_host = np.asarray(seq_codes, np.uint8)
        self.seq_codes = self._put(self._seq_host)
        self._seq_off = np.asarray(seq_off, np.int64)
        self._txp_lens = np.asarray(txp_lens, np.int64)
        self.counts = torch.full((2, N_BINS, N_FULL, N_FULL), alpha,
                                 dtype=torch.float32, device=self.device)
        self._logp = None
        self._lp_bg = None
        self._np_eval_cache = None
        self.read_len_cap = read_len_cap
        self._rl_grid = 0      # current padded read length (grows)
        # the compiled steps' graphs on the card (none on the CPU, where
        # the steps run their eager bodies)
        self.graphs = GraphCache() if self.device.type == "cuda" else None
        # numpy model for records that do not fit the grid
        self._np_model = AlignmentErrorModel(alpha=0.0)
        self._np_dirty = False

    def _put(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- packing ------------------------------------------------------
    def _pack_padded(self, b, sel, ref_map):
        """Device grid tensors for all `sel` records on row_bucket(n)
        rows, the host fits mask of the n records, and n: the JAX
        package's _pack. Rows that do not fit the grid (cigar ops > 16,
        read longer than the grid, or expanded columns past the slack)
        and the padding rows are zeroed: they hold no valid column on
        the device, and the records among them go through the numpy walk
        instead. The ragged to padded repack runs on the native library
        (pad_records)."""
        n = sel.size
        rl_all = b.read_len[sel].astype(np.int32)
        rl_max = min(int(rl_all.max()) if n else 1, self.read_len_cap)
        # grow-only grid width, padded to 64: which records fit depends
        # only on the records seen so far, as in the JAX package
        self._rl_grid = max(self._rl_grid, -(-rl_max // 64) * 64)
        RL = self._rl_grid
        npad = row_bucket(n)
        ops, oplens, rseq, fits = pad_records(b, sel, RL, npad)
        txp = ref_map[np.clip(b.refid[sel], 0, ref_map.size - 1)]
        toff = self._seq_off[np.clip(txp, 0, self._seq_off.size - 2)]
        tlen = self._txp_lens[np.clip(txp, 0, self._txp_lens.size - 1)]

        def pad(a, dtype):
            out = np.zeros(npad, dtype)
            out[:n] = a
            return out

        return {
            "ops": self._put(ops), "oplens": self._put(oplens),
            "rseq": self._put(rseq),
            "rlen": self._put(pad(np.minimum(rl_all, RL), np.int32)),
            "toff": self._put(pad(toff, np.int64)),
            "pos": self._put(pad(b.pos[sel], np.int32)),
            "tlen": self._put(pad(tlen, np.int32)),
        }, fits, n

    def _pack(self, b, sel, ref_map):
        """The first n rows of _pack_padded's grid, and the fits mask."""
        p, fits, n = self._pack_padded(b, sel, ref_map)
        return {k: v[:n] for k, v in p.items()}, fits

    # -- model interface ----------------------------------------------
    def prepare(self, b, i1, i2, ref_map) -> PreparedBatch:
        """Expand one batch's kept records (both mates fused) once;
        the returned handle serves log_likelihood() and update()."""
        return PreparedBatch(self, b, i1, i2, ref_map)

    def update(self, b, sel_idx, ref_map, weights, mate: int) -> None:
        """Posterior-weighted transition-count update for the records
        sel_idx of batch b (weights aligned with sel_idx)."""
        sel = np.asarray(sel_idx, np.int64)
        w = np.asarray(weights, np.float32)
        p, fits, n = self._pack_padded(b, sel, ref_map)
        if fits.any():
            wg = np.zeros(p["rlen"].shape[0], np.float32)
            wg[:n] = np.where(fits, w, 0.0)
            add = count_update(p["ops"], p["oplens"], p["rseq"], p["rlen"],
                               p["toff"], p["pos"], p["tlen"],
                               self._put(wg), self.seq_codes,
                               cache=self.graphs, mate=mate)
            self.counts[mate] += add.reshape(N_BINS, N_FULL, N_FULL)
        rest = ~fits
        if rest.any():
            cols = expand_batch(b, sel[rest], ref_map, self._seq_host,
                                self._seq_off, self._txp_lens)
            self._np_model.update(cols, w[rest], mate)
            self._np_dirty = True
        self._logp = None

    def normalize(self) -> None:
        if self._np_dirty:
            self.counts += self._put(
                self._np_model.counts.astype(np.float32))
            self._np_model.counts[:] = 0.0
            self._np_dirty = False
        tot = self.counts.sum(dim=3, keepdim=True)
        self._logp = torch.log(self.counts / torch.clamp(tot, min=1e-30))
        # background per (mate, bin): the (0,0)->(0,0) transition
        self._lp_bg = self._logp[:, :, 0, 0]
        self._np_eval_cache = None

    @property
    def _np_eval(self):
        """Numpy mirror for the grid-overflow records (built only when a
        batch holds such records)."""
        if self._np_eval_cache is None:
            m = AlignmentErrorModel(alpha=0.0)
            m.counts = self.counts.cpu().numpy().astype(np.float64)
            m.normalize()
            self._np_eval_cache = m
        return self._np_eval_cache

    def log_likelihood(self, b, sel_idx, ref_map, mate: int):
        """Per-record fg-bg log-likelihood, aligned with sel_idx."""
        if self._logp is None:
            self.normalize()
        sel = np.asarray(sel_idx, np.int64)
        out = np.zeros(sel.size)
        p, fits, n = self._pack_padded(b, sel, ref_map)
        if fits.any():
            lv = log_likelihood_rows(
                p["ops"], p["oplens"], p["rseq"], p["rlen"], p["toff"],
                p["pos"], p["tlen"], self._logp[mate].reshape(-1),
                self._lp_bg[mate], self.seq_codes, cache=self.graphs,
                mate=mate)[:n].cpu().numpy()
            out[fits] = lv[fits]
        rest = ~fits
        if rest.any():
            cols = expand_batch(b, sel[rest], ref_map, self._seq_host,
                                self._seq_off, self._txp_lens)
            out[rest] = self._np_eval.log_likelihood(
                cols, int(rest.sum()), mate)
        return out


def load_counts(model: DeviceAlignmentErrorModel, counts) -> None:
    """Set the model's transition counts from a (2, N_BINS, 82, 82)
    numpy array, for instance another implementation's, so that two
    models can be held to one state."""
    model.counts = model._put(np.asarray(counts, np.float32).reshape(
        2, N_BINS, N_FULL, N_FULL).copy())
    model._np_model.counts[:] = 0.0
    model._np_dirty = False
    model._logp = None
    model._np_eval_cache = None


def read_counts(model: DeviceAlignmentErrorModel) -> np.ndarray:
    """The model's transition counts as a float64 numpy array, the
    overflow records' share not yet merged by normalize() included."""
    counts = model.counts.cpu().numpy().astype(np.float64)
    if model._np_dirty:
        counts = counts + model._np_model.counts
    return counts
