"""Plain reference of selective alignment's answer for a fragment: the
set of transcripts it is compatible with.

Semantics (salmon's selective alignment at its defaults, as the
configuration states them):
  - candidates: every placement of a mate, in either orientation, that
    an exact k-mer match puts on a transcript (every k-mer of the read,
    not a sample of them);
  - a concordant pair is the two mates on opposite strands of one
    transcript, the forward mate not starting after the reverse one,
    the fragment no longer than fld_max; a fragment with no concordant
    pair falls back to its mates' single placements (orphans);
  - each placement is scored by banded affine-gap alignment, the read
    end to end and the reference free at both ends of a band of
    half-width `band` around the placement (match +2, mismatch -4, a
    gap of length l costs go + ge * l, reference bases outside the
    transcript -1000);
  - a transcript is in the label when its best pair score is at least
    min_score_fraction of the perfect score and its probability
    exp(-score_exp * (best - score)) is at least min_aln_prob, among
    placements whose orientation the library (detected from the sample:
    the 30/70 bands) allows.
No code of the program is imported; plain torch on any device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEG = -1e9
OOB = -1000


def _kmers(mat: torch.Tensor, k: int):
    """(n, L) codes -> (n, L-k+1) int64 k-mer codes and validity."""
    n, L = mat.shape
    w = L - k + 1
    code = torch.zeros((n, w), dtype=torch.int64, device=mat.device)
    ok = torch.ones((n, w), dtype=torch.bool, device=mat.device)
    m = mat.to(torch.int64)
    for j in range(k):
        c = m[:, j:j + w]
        code = code * 4 + c.clamp(max=3)
        ok &= c < 4
    return code, ok


def _revcomp(mat: torch.Tensor) -> torch.Tensor:
    f = torch.flip(mat, dims=[1])
    return torch.where(f < 4, 3 - f, f)


def find_placements(variants: torch.Tensor, codes: torch.Tensor,
                    offsets: torch.Tensor, lens: torch.Tensor, k: int,
                    chunk: int = 1 << 25):
    """Exact k-mer placements of each read row.

    variants: (V, L) read rows; codes: the concatenated transcriptome
    (uint8, device); offsets: (n+1,) int64; lens: (n,) each transcript's
    length (bases past it, such as a clipped poly-A tail, are not the
    transcript's). Returns numpy arrays
    (row, txp, diag): row r placed with its first base at `diag` on
    transcript `txp`, one entry per distinct placement."""
    dev = codes.device
    qc, qok = _kmers(variants, k)
    V, W = qc.shape
    rows = torch.arange(V, device=dev)[:, None].expand(V, W)[qok]
    offs = torch.arange(W, device=dev)[None, :].expand(V, W)[qok]
    qv = qc[qok]
    uq, inv = torch.unique(qv, return_inverse=True)
    order = torch.argsort(inv, stable=True)
    occ_row, occ_off = rows[order], offs[order]
    counts = torch.bincount(inv, minlength=uq.shape[0])
    first = torch.cumsum(counts, 0) - counts
    total = int(offsets[-1])
    hit_pos, hit_q = [], []
    for a in range(0, max(total - k + 1, 0), chunk):
        b = min(a + chunk, total - k + 1)
        seg = codes[a:b + k - 1].to(torch.int64)
        n = b - a
        code = torch.zeros(n, dtype=torch.int64, device=dev)
        for j in range(k):
            code.mul_(4).add_(seg[j:j + n].clamp(max=3))
        i = torch.searchsorted(uq, code).clamp(max=uq.shape[0] - 1)
        hit = uq[i] == code
        pos = torch.nonzero(hit)[:, 0] + a
        hit_pos.append(pos)
        hit_q.append(i[hit])
    pos = torch.cat(hit_pos) if hit_pos else torch.zeros(0, dtype=torch.int64,
                                                         device=dev)
    q = torch.cat(hit_q) if hit_q else torch.zeros(0, dtype=torch.int64,
                                                   device=dev)
    t = torch.searchsorted(offsets[1:], pos, right=True)
    tpos = pos - offsets[t]
    inside = tpos <= lens[t] - k          # the k-mer lies in one transcript
    pos, q, t, tpos = pos[inside], q[inside], t[inside], tpos[inside]
    rep = counts[q]
    idx = torch.repeat_interleave(first[q], rep) + (
        torch.arange(int(rep.sum()), device=dev)
        - torch.repeat_interleave(torch.cumsum(rep, 0) - rep, rep))
    t_e = torch.repeat_interleave(t, rep)
    tpos_e = torch.repeat_interleave(tpos, rep)
    row_e = occ_row[idx]
    diag = tpos_e - occ_off[idx]
    trip = torch.stack([row_e, t_e, diag], 1)
    trip = torch.unique(trip, dim=0) if trip.shape[0] else trip
    trip = trip.cpu().numpy()
    return trip[:, 0], trip[:, 1], trip[:, 2]


def banded_scores(reads: torch.Tensor, txp: torch.Tensor, pos: torch.Tensor,
                  codes: torch.Tensor, offsets: torch.Tensor,
                  lengths: torch.Tensor, band: int, ma: int, mp: int,
                  go: int, ge: int) -> torch.Tensor:
    """Glocal affine-gap scores of each read row of `reads` (P, L) placed
    with its first base at `pos` on `txp`, in a band of half-width
    `band`: cell (i, d), d in [0, 2 band], aligns read base i with
    reference base pos + i + d - band. Returns (P,) float32 scores
    (integer sums, exact)."""
    dtype = torch.float32
    dev = reads.device
    P, L = reads.shape
    B = 2 * band + 1
    Wn = L + B - 1
    lens = lengths[txp]
    j = pos[:, None] - band + torch.arange(Wn, device=dev)[None, :]
    inside = (j >= 0) & (j < lens[:, None])
    ref = codes[(offsets[txp][:, None] + j.clamp(min=0)).clamp(
        max=codes.shape[0] - 1)].to(torch.int64)
    ref = torch.where(inside, ref, 5)
    rd = reads.to(torch.int64)
    neg = torch.full((P, 1), NEG, dtype=dtype, device=dev)
    dvec = torch.arange(B, device=dev, dtype=dtype)[None, :]
    H = torch.zeros((P, B), dtype=dtype, device=dev)
    Ins = torch.full((P, B), NEG, dtype=dtype, device=dev)
    for i in range(L):
        r = ref[:, i:i + B]
        a = rd[:, i:i + 1]
        sub = torch.where((a == r) & (a < 4), ma, mp).to(dtype)
        sub = torch.where(r == 5, float(OOB), sub)
        diag = H + sub
        # read base i against no reference base: from (i-1, d+1)
        Ins = torch.maximum(torch.cat([Ins[:, 1:], neg], 1) - ge,
                            torch.cat([H[:, 1:], neg], 1) - go - ge)
        Hc = torch.maximum(diag, Ins)
        # reference bases skipped: best Hc[d'] - go - ge * (d - d'), d' < d
        G = Hc + ge * dvec
        run = torch.cummax(G, dim=1).values
        Dl = torch.cat([neg, run[:, :-1]], 1) - go - ge * dvec
        H = torch.maximum(Hc, Dl)
    return H.amax(dim=1)


def reference_labels(r1: np.ndarray, r2: np.ndarray, txome, params: dict,
                     device="cpu"):
    """(labels, scores, summary): the label (sorted transcript ids, a
    tuple) of each fragment of (r1, r2) ((F, L) uint8 mates), its
    transcripts' alignment scores in label order, and a summary dict."""
    dev = torch.device(device)
    k = params["k"]
    codes = torch.as_tensor(txome.codes, device=dev)
    offsets = torch.as_tensor(txome.offsets, device=dev)
    lens = torch.as_tensor(txome.lengths, device=dev)
    m1 = torch.as_tensor(r1, device=dev)
    m2 = torch.as_tensor(r2, device=dev)
    F, L = m1.shape
    # variant rows: 0 mate-1 fw, 1 mate-1 rc, 2 mate-2 fw, 3 mate-2 rc
    variants = torch.cat([m1, _revcomp(m1), m2, _revcomp(m2)], 0)
    row, t, diag = find_placements(variants, codes, offsets, lens, k)
    var, frag = row // F, row % F
    ma, mp = params["match"], params["mismatch"]
    go, ge = params["gap_open"], params["gap_extend"]
    band = params["band"]
    # score every placement once
    if row.shape[0]:
        sc = banded_scores(
            variants[torch.as_tensor(row, device=dev)],
            torch.as_tensor(t, device=dev), torch.as_tensor(diag, device=dev),
            codes, offsets, lens, band, ma, mp, go, ge).cpu().numpy()
    else:
        sc = np.zeros(0)
    sc = sc.astype(np.float64)
    fld_max = params["fld_max"]
    # concordant pairs: (mate-1 fw, mate-2 rc) is "forward-first" (ISF
    # for a stranded library), (mate-2 fw, mate-1 rc) the other
    pairs = []       # (frag, txp, score, orient 0/1)
    by_key = {}
    for i in range(row.shape[0]):
        by_key.setdefault((int(frag[i]), int(t[i]), int(var[i])), []).append(i)
    for (f, tx, v), idx_fw in by_key.items():
        if v not in (0, 2):
            continue
        mate_rc = 3 if v == 0 else 1
        idx_rc = by_key.get((f, tx, mate_rc))
        if not idx_rc:
            continue
        best = None
        for a in idx_fw:
            for b in idx_rc:
                s_fw, s_rc = int(diag[a]), int(diag[b])
                if s_fw > s_rc:
                    continue            # dovetail
                if s_rc + L - s_fw > fld_max:
                    continue
                s = sc[a] + sc[b]
                best = s if best is None else max(best, s)
        if best is not None:
            pairs.append((f, tx, best, 0 if v == 0 else 1))
    min_frac = params["min_score_fraction"]
    slack = -math.log(params["min_aln_prob"]) / params["score_exp"]
    paired_perfect = ma * 2 * L
    # library orientation from the sample's best pairs (30/70 bands)
    best_of = {}
    for f, tx, s, o in pairs:
        if s >= min_frac * paired_perfect and (
                f not in best_of or s > best_of[f][0]):
            best_of[f] = (s, o)
    n0 = sum(1 for s, o in best_of.values() if o == 0)
    n1 = len(best_of) - n0
    ratio = n0 / max(n0 + n1, 1)
    allowed = {0} if ratio >= 0.7 else ({1} if ratio <= 0.3 else {0, 1})
    per_frag = {}
    for f, tx, s, o in pairs:
        if o in allowed and s >= min_frac * paired_perfect:
            d = per_frag.setdefault(f, {})
            d[tx] = max(d.get(tx, NEG), s)
    # orphans: fragments with no concordant pair at all
    paired_frags = {f for f, _, _, _ in pairs}
    for i in range(row.shape[0]):
        f = int(frag[i])
        if f in paired_frags:
            continue
        if sc[i] >= min_frac * ma * L:
            d = per_frag.setdefault(f, {})
            d[int(t[i])] = max(d.get(int(t[i]), NEG), sc[i])
    labels, scores = [], []
    for f in range(F):
        d = per_frag.get(f)
        if not d:
            labels.append(())
            scores.append(())
            continue
        best = max(d.values())
        lab = tuple(sorted(tx for tx, s in d.items() if best - s <= slack))
        labels.append(lab)
        scores.append(tuple(d[tx] for tx in lab))
    summary = {"placements": int(row.shape[0]), "pairs": len(pairs),
               "orientation_ratio": ratio,
               "orientations_allowed": sorted(allowed)}
    return labels, scores, summary
