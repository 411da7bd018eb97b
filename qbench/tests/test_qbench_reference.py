"""The plain reference against the program's own plain versions on the
CPU: the banded DP, the effective lengths and the VBEM."""

from __future__ import annotations

import numpy as np
import torch

from qbench.reference import em as ref_em
from qbench.reference import mapping as ref_map


def _problems(seed, P=300, L=100, T=600):
    rng = np.random.default_rng(seed)
    txps = [rng.integers(0, 4, T).astype(np.uint8) for _ in range(5)]
    codes = np.concatenate(txps)
    offsets = np.arange(6, dtype=np.int64) * T
    reads = np.zeros((P, L), np.uint8)
    txp = rng.integers(0, 5, P)
    pos = rng.integers(-20, T - L + 20, P)
    for i in range(P):
        src = np.resize(txps[txp[i]], T + 2 * L)
        r = src[max(pos[i], 0):max(pos[i], 0) + L + 3].copy()
        if rng.random() < 0.3:           # an indel
            at = int(rng.integers(5, L - 5))
            r = (np.delete(r, at) if rng.random() < 0.5
                 else np.insert(r, at, rng.integers(0, 4)))
        r = r[:L]
        hit = rng.random(L) < 0.03
        r[hit] = (r[hit] + 1) % 4
        reads[i] = r
    shift = rng.integers(-3, 4, P)
    return reads, txp, pos + shift, codes, offsets


def test_dp_matches_port_plain_dp():
    from salmon_tpu_torch.mapping.align import banded_scores

    reads, txp, pos, codes, offsets = _problems(0)
    lens = np.diff(offsets)
    mine = ref_map.banded_scores(
        torch.as_tensor(reads), torch.as_tensor(txp), torch.as_tensor(pos),
        torch.as_tensor(codes), torch.as_tensor(offsets),
        torch.as_tensor(lens), 15, 2, -4, 6, 2)
    port = banded_scores(
        torch.as_tensor(reads), torch.full((len(txp),), 100, dtype=torch.int32),
        torch.as_tensor(pos, dtype=torch.int32),
        torch.as_tensor(lens[txp], dtype=torch.int32), torch.as_tensor(codes),
        torch.as_tensor(offsets[txp]), 15, 2.0, -4.0, 6.0, 2.0)
    assert torch.equal(mine, port)


def test_efflen_matches_port():
    from salmon_tpu_torch.models.efflen import effective_lengths

    rng = np.random.default_rng(1)
    pmf = np.exp(-0.5 * ((np.arange(1001) - 250) / 25.0) ** 2)
    pmf /= pmf.sum()
    lens = rng.integers(50, 5000, 2000)
    assert np.array_equal(ref_em.effective_lengths(lens, pmf),
                          effective_lengths(lens, pmf))


def test_vbem_matches_port():
    from salmon_tpu_torch.inference import em
    from salmon_tpu_torch.inference.eqclasses import PackedEqClasses

    rng = np.random.default_rng(2)
    n, ncl = 400, 900
    sizes = rng.integers(1, 5, ncl).astype(np.int32)
    labels = np.concatenate([np.sort(rng.choice(n, s, replace=False))
                             for s in sizes]).astype(np.int32)
    w = rng.random(labels.shape[0])
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    for a, b in zip(offsets[:-1], offsets[1:]):
        w[a:b] /= w[a:b].sum()
    counts = rng.integers(1, 50, ncl).astype(np.float64)
    eq = PackedEqClasses(labels, w, offsets, counts, sizes)
    eff = rng.uniform(100, 3000, n)
    online = rng.random(n) * counts.sum() / n
    res = em.optimize(eq, n, eff, online_mass=online,
                      total_mapped=counts.sum(), device="cpu")
    params = {"vb_prior": 0.01, "per_transcript_prior": True,
              "min_alpha": 1e-8, "num_required_frags": 5e7}
    ref = ref_em.vbem(labels, offsets, counts, w, eff, online, counts.sum(),
                      res["iterations"], params)
    assert np.abs(res["alphas"] - ref).sum() / ref.sum() < 1e-5
    bf = ref_em.vbem(labels, offsets, counts, w, eff, online, counts.sum(),
                     res["iterations"], params, dtype=torch.bfloat16)
    assert np.abs(bf - ref).sum() / ref.sum() > 1e-4


def _label_batches(seed, n_batches=6, R=512, T=8, n_txps=60):
    """Batches as the batch step emits them: (R, T) sorted labels padded
    with INVALID, float32 weights, int32 bins; some rows unmapped."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        txp = np.full((R, T), 0x7FFFFFFF, np.int32)
        w = np.zeros((R, T), np.float32)
        bins = np.zeros((R, T), np.int32)
        sizes = rng.integers(0, 4, R)
        for r, s in enumerate(sizes):
            txp[r, :s] = np.sort(rng.choice(n_txps, s, replace=False))
            w[r, :s] = rng.random(s)
            bins[r, :s] = rng.integers(0, 4, s)
        out.append((txp, w, bins))
    return out


def test_eq_classes_match_port_accumulator():
    from qbench.lib.observe import flat_labels
    from qbench.reference import eqclasses as ref_eq
    from salmon_tpu_torch.inference.eqclasses import \
        EquivalenceClassAccumulator

    batches = _label_batches(3)
    acc = EquivalenceClassAccumulator(merge_buffer_rows=300)
    for b in batches:
        acc.add_batch(*b)
    eq = acc.finish()
    port = (eq.labels, eq.offsets, eq.counts, eq.weights)
    flat = [flat_labels(*b) for b in batches]
    ref = ref_eq.aggregate(flat)
    assert ref[1].sum() == eq.counts.sum()
    assert ref_eq.class_gap(port, ref) < 1e-12
    # the control: the classes summed in float32
    low = ref_eq.to_packed(ref_eq.aggregate(flat, dtype=torch.float32))
    assert ref_eq.class_gap(low, ref) > 1e-9
    # a batch lost, and one fragment's count moved to another class
    acc2 = EquivalenceClassAccumulator()
    for b in batches[1:]:
        acc2.add_batch(*b)
    eq2 = acc2.finish()
    assert ref_eq.class_gap((eq2.labels, eq2.offsets, eq2.counts,
                             eq2.weights), ref) == 1.0 or \
        ref_eq.class_gap((eq2.labels, eq2.offsets, eq2.counts,
                          eq2.weights), ref) > 1e-3
    moved = eq.counts.copy()
    moved[0] += 1
    moved[1] -= 1
    assert ref_eq.class_gap((eq.labels, eq.offsets, moved, eq.weights),
                            ref) > 1e-6


def test_gene_transcriptome_shares_exons():
    from qbench.lib.txome import make_gene_txome

    spec = dict(n_txps=400, seed=7, txps_per_gene=4.0,
                exons_per_gene=[7, 8.8], first_exon=[240, 300],
                internal_exon=[122, 145], last_exon=[400, 770],
                inclusion=0.8, min_len=200, exon_min=20)
    names, seqs = make_gene_txome(**spec)
    again = make_gene_txome(**spec)[1]
    assert len(seqs) == 400 and len(set(names)) == 400
    assert all(np.array_equal(a, b) for a, b in zip(seqs, again))
    assert min(s.shape[0] for s in seqs) >= 200
    # isoforms of a gene share 31-mers: far fewer distinct k-mers than
    # positions
    k = 31
    kmers = set()
    total = 0
    for s in seqs:
        b = s.tobytes()
        total += len(b) - k + 1
        kmers.update(b[i:i + k] for i in range(0, len(b) - k + 1))
    assert len(kmers) < 0.6 * total
