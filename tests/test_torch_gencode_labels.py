"""Complete labels on isoforms that share exons: the batch step marks the
fragments that a fixed-shape cap may have cut, the wide pass maps them
again at caps sized from the index, and the eq accumulator takes the
batch's widened labels.

Held to the benchmark's plain reference (qbench/reference/mapping.py,
plain torch) on a seeded gene transcriptome (qbench/lib/txome.py) and
seeded pairs (qbench/lib/traffic.py): the labels at the defaults, with
every cap at 2 (the wide pass on most fragments, in repeated
sub-batches), and on a batch whose spilling k-mer windows outnumber the
tail-row budget; and the accumulator on batches of widths 16, 40 and 16
against the sort-based dedupe of test_torch_eqclasses."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from qbench.lib import traffic
from qbench.lib import txome as qtx
from qbench.reference.mapping import reference_labels
from salmon_tpu_torch.constants import DEFAULTS
from salmon_tpu_torch.index import builder as tb
from salmon_tpu_torch.inference.eqclasses import (INVALID_TXP,
                                                  EquivalenceClassAccumulator)
from salmon_tpu_torch.mapping import pipeline as tpipe
from salmon_tpu_torch.utils import libformat as tlf
from test_torch_eqclasses import _dedupe_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QB = os.path.join(REPO, "qbench")
R, L = 256, 128


def _json(*parts):
    with open(os.path.join(QB, *parts)) as fh:
        return json.load(fh)


CFG = _json("configs", "gencode-vbem.json")
# labels alone (the check's weights are not compared here): the stand-in
# stream's limit
LIMIT = _json("workloads",
              "paralog-vbem.stream.json")["limits"]["map_answer_mismatch"]
PARAMS = dict(CFG["reference"], k=CFG["k"])


def _index(tmp, names, seqs):
    fasta = os.path.join(tmp, "txome.fa")
    qtx.write_fasta(fasta, names, seqs)
    offsets = np.concatenate([[0], np.cumsum([s.shape[0] for s in seqs])])
    tx = qtx.Txome(np.concatenate(seqs), offsets.astype(np.int64),
                   PARAMS["polya_clip"])
    return tb.build_index(fasta, k=CFG["k"]), tx


@pytest.fixture(scope="module")
def genes(tmp_path_factory):
    spec = dict(CFG["transcriptome"], n_txps=600)
    spec.pop("model")
    names, seqs = qtx.make_gene_txome(**spec)
    idx, tx = _index(str(tmp_path_factory.mktemp("genes")), names, seqs)
    mix = dict(_json("traffic", "stream.json"), pool_pairs=2 * R)
    pool = traffic.make_pool(tx, mix, 2_718_281_903, R)
    return idx, tx, pool.r1, pool.r2


def _batch(r1, r2):
    def pad(r):
        c = np.full((R, L), 4, np.uint8)
        c[:, :r.shape[1]] = r
        return torch.from_numpy(c)
    n = np.full(R, r1.shape[1], np.int32)
    return {"codes_l": pad(r1), "lengths_l": torch.from_numpy(n),
            "codes_r": pad(r2), "lengths_r": torch.from_numpy(n.copy())}


def _map(idx, r1, r2, options: dict, rows=None):
    """(main outputs, completed (R, W) eq_txp, the wide pass's results)
    of one batch through the batch step and the wide pass, as quantify
    runs them, for an ISF library (the stream's mates)."""
    opts = dataclasses.replace(DEFAULTS, **options)
    cfg = tpipe.MapperConfig.from_index(idx, opts)
    dev = tpipe.device_index_tensors(idx, "cpu")
    fmt = tlf.parse_library_format("ISF")
    compat = (torch.from_numpy(tlf.paired_compat_table(fmt)),
              torch.from_numpy(tlf.orphan_compat_table(fmt)))
    fld = torch.full((cfg.fld_max + 1,), float(-np.log(cfg.fld_max + 1)))
    batch = _batch(r1, r2)
    out = tpipe.map_paired_batch(batch, dev, cfg, fld, *compat)
    out.update(tpipe.mark_stats(out["mark_counts"]))
    txp = out["eq_txp"].numpy()
    n = out["frags_wide"]
    if not n:
        return out, txp, None
    wide = tpipe.WidePass(idx, cfg, paired=True, rows=rows)
    ran = wide.run(batch, out, dev, fld, compat, n)
    done = wide.complete(txp, out["eq_weight"].numpy(),
                         out["eq_bins"].numpy(), out["frag_ok"].numpy(),
                         ran)
    done["passes"] = len(ran[0])
    return out, done["eq"][0], done


def _labels(eq_txp, idx, tx):
    to_ref = {tx.name(i): i for i in range(tx.n)}
    ref_of = np.array([to_ref[n] for n in idx.names])
    return [tuple(sorted(ref_of[row[row != INVALID_TXP]].tolist()))
            for row in eq_txp]


def _differ(got, want):
    lack = sum(bool(set(w) - set(g)) for g, w in zip(got, want))
    return sum(g != w for g, w in zip(got, want)), lack


CAPS2 = {"occ_cap": 2, "max_cands": 2, "max_pair_cands": 2,
         "weight_width": 2, "dp_budget": 2}


@pytest.mark.parametrize("options,rows", [({}, None), (CAPS2, 48)],
                         ids=["defaults", "every_cap_2"])
def test_labels_against_reference(genes, options, rows):
    idx, tx, r1, r2 = genes
    want, _, _ = reference_labels(r1[:R], r2[:R], tx, PARAMS)
    out, txp, done = _map(idx, r1[:R], r2[:R], options, rows)
    marked, wide = out["frags_marked"], out["frags_wide"]
    per_cap = [out[k] for k in tpipe.CUT_KEYS]
    assert max(per_cap) <= marked <= sum(per_cap)
    assert out["marked_occ"] <= wide <= marked
    capped = _labels(out["eq_txp"].numpy(), idx, tx)
    got = _labels(txp, idx, tx)
    n_diff, lack = _differ(got, want)
    # the caps cut these labels; the wide pass completes them
    assert _differ(capped, want)[1] > (0.25 * R if options else 0)
    assert lack == 0
    assert n_diff / R <= LIMIT
    assert done is not None and done["cut"] == 0
    assert done["width"] == max(len(g) for g in got)
    if options:
        assert wide > 0.5 * R
        assert done["passes"] == -(-wide // rows) > 1
    else:
        assert out["marked_dp"] > 0


def test_tail_budget_spill_loses_no_transcript(tmp_path):
    """256 fragments on one 300-base exon shared by 20 isoforms: every
    window of every read spills past its first row of occurrences, ~6,000
    windows against a tail budget of 1,024; with the occurrence, pair,
    DP and label caps wide enough, only the tail budget marks them, and
    the wide pass gives each fragment all 20 isoforms."""
    rng = np.random.default_rng(20)
    shared = rng.integers(0, 4, 300).astype(np.uint8)
    seqs = [np.concatenate([shared, rng.integers(0, 4, 150).astype(np.uint8)])
            for _ in range(20)]
    seqs += [rng.integers(0, 4, 500).astype(np.uint8) for _ in range(40)]
    names = [f"SYNT{i:06d}" for i in range(len(seqs))]
    idx, tx = _index(str(tmp_path), names, seqs)
    st = rng.integers(0, 300 - 220 + 1, R)
    cols = np.arange(100)
    r1 = shared[st[:, None] + cols]
    r2 = np.ascontiguousarray(3 - shared[(st + 220 - 100)[:, None]
                                         + cols][:, ::-1])
    out, txp, done = _map(idx, r1, r2, {
        "occ_cap": 32, "max_cands": 64, "max_pair_cands": 64,
        "weight_width": 32, "dp_budget": 128})
    assert out["marked_occ"] == out["frags_marked"] == out["frags_wide"] > 0
    assert all(out[k] == 0 for k in ("marked_cands", "marked_dp",
                                     "marked_width"))
    assert int(out["seed_tail_over"]) > 1024
    want, _, _ = reference_labels(r1, r2, tx, PARAMS)
    assert all(w == tuple(range(20)) for w in want)
    assert _differ(_labels(out["eq_txp"].numpy(), idx, tx), want)[1] > 0
    assert _labels(txp, idx, tx) == want
    assert done["width"] == 20


def _rows_of(rng, n, width, n_txps=400):
    """n labels of 1..width transcripts (sorted, INVALID-padded to
    width) with weights and bins; a few repeat."""
    txp = np.full((n, width), INVALID_TXP, np.int32)
    w = np.zeros((n, width), np.float32)
    bins = np.full((n, width), -1, np.int32)
    for i in range(n):
        k = int(rng.integers(1, width + 1)) if i % 3 else 2
        t = np.sort(rng.choice(n_txps if i % 3 else 6, k, replace=False))
        txp[i, :k] = t
        w[i, :k] = rng.random(k).astype(np.float32)
        bins[i, :k] = rng.integers(0, 4, k)
    return txp, w, bins


def test_add_batch_of_any_width_matches_sort_dedupe():
    """Batches of widths 16, 40 and 16 through one accumulator: the
    classes, their order, counts and weight sums are those of the
    sort-based dedupe of every row padded to width 40."""
    rng = np.random.default_rng(40)
    batches = [_rows_of(rng, 300, w) for w in (16, 40, 16)]
    batches[2][0][:5] = batches[0][0][:5]      # classes met again
    batches[2][2][:5] = batches[0][2][:5]
    acc = EquivalenceClassAccumulator(merge_buffer_rows=256)
    for txp, w, bins in batches:
        acc.add_batch(txp, w, bins)
    assert acc.label_width == 40
    got = acc.finish()

    def pad(a, fill):
        out = np.full((a.shape[0], 40), fill, a.dtype)
        out[:, :a.shape[1]] = a
        return out
    txp = np.concatenate([pad(b[0], INVALID_TXP) for b in batches])
    w = np.concatenate([pad(b[1], 0) for b in batches]).astype(np.float64)
    bins = np.concatenate([pad(b[2], -1) for b in batches])
    keys, counts, wsum = _dedupe_rows(np.concatenate([txp, bins], axis=1),
                                      np.ones(txp.shape[0]), w)
    m = keys[:, :40] != INVALID_TXP
    np.testing.assert_array_equal(got.counts, counts)
    np.testing.assert_array_equal(got.class_sizes, m.sum(axis=1))
    np.testing.assert_array_equal(got.labels, keys[:, :40][m])
    np.testing.assert_array_equal(got.offsets[1:], np.cumsum(m.sum(axis=1)))
    np.testing.assert_array_equal(got.weights, (wsum / counts[:, None])[m])
