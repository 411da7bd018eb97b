"""The eq accumulator's native hash table of classes against a numpy
sort-based dedupe: every row of every batch deduped at once, the classes
ascending by the rows' bytes (a void view), the weights summed in float64
in arrival order."""

import numpy as np
import pytest

from salmon_tpu_torch.inference.eqclasses import (INVALID_TXP,
                                                  EquivalenceClassAccumulator,
                                                  _Table)
from salmon_tpu_torch.utils import spans

T2 = 6


def _void_view(mat):
    m = np.ascontiguousarray(mat)
    return m.view([("", "V%d" % (m.shape[1] * m.itemsize))]).ravel()


def _dedupe_rows(key_mat, counts, wsum):
    """The sort-based dedupe: (uniq_keys, counts, wsum), ascending by the
    rows' bytes; duplicates summed in their order (stable sort)."""
    kv = _void_view(key_mat)
    order = np.argsort(kv, kind="stable")
    kv_s = kv[order]
    is_new = np.empty(kv_s.shape[0], dtype=bool)
    is_new[0] = True
    is_new[1:] = kv_s[1:] != kv_s[:-1]
    group = np.cumsum(is_new) - 1
    n = int(group[-1]) + 1
    uniq = key_mat[order[is_new]]
    c_out = np.bincount(group, weights=counts[order], minlength=n)
    w_out = np.empty((n, wsum.shape[1]), dtype=np.float64)
    ws = wsum[order]
    for j in range(wsum.shape[1]):
        w_out[:, j] = np.bincount(group, weights=ws[:, j], minlength=n)
    return uniq, c_out, w_out


def _batches(seed, n_batches=12, rows=256, n_classes=400, bins=True):
    """Batches drawn with repeats from a pool of classes of 1-4
    transcripts; a tenth of the rows unmapped."""
    rng = np.random.default_rng(seed)
    pool_txp = np.full((n_classes, T2), INVALID_TXP, np.int32)
    pool_bins = np.full((n_classes, T2), -1, np.int32)
    for c in range(n_classes):
        s = int(rng.integers(1, 5))
        pool_txp[c, :s] = np.sort(rng.choice(1000, s, replace=False))
        pool_bins[c, :s] = rng.integers(0, 4, s)
    out = []
    for _ in range(n_batches):
        pick = rng.integers(0, n_classes, rows)
        txp, b = pool_txp[pick].copy(), pool_bins[pick].copy()
        txp[rng.random(rows) < 0.1] = INVALID_TXP
        w = rng.random((rows, T2)).astype(np.float32)
        w[txp == INVALID_TXP] = 0.0
        out.append((txp, w, b if bins else None))
    return out


def _reference(batches):
    keys, ws = [], []
    for txp, w, b in batches:
        ok = txp[:, 0] != INVALID_TXP
        keys.append(txp[ok] if b is None
                    else np.concatenate([txp[ok], b[ok]], axis=1))
        ws.append(w[ok].astype(np.float64))
    keys = np.concatenate(keys)
    return _dedupe_rows(keys, np.ones(keys.shape[0]), np.concatenate(ws))


def _assert_rows_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-12, atol=0)


@pytest.mark.parametrize("merge_rows", [1, 300, 1 << 14])
@pytest.mark.parametrize("bins", [True, False], ids=["bins", "no_bins"])
def test_matches_sort_dedupe(bins, merge_rows):
    batches = _batches(3, bins=bins)
    c0 = spans.counters()
    acc = EquivalenceClassAccumulator(merge_buffer_rows=merge_rows)
    for b in batches:
        acc.add_batch(*b)
    want = _reference(batches)
    got = acc.collapsed()
    # the classes, their order and counts exactly; sums to rounding
    _assert_rows_equal(got, want)
    c = spans.counters(c0)
    assert c["eq_rows_new"] == want[0].shape[0] == acc.num_classes
    assert c["eq_rows_merged"] >= c["eq_rows_new"]
    eq = acc.finish()
    t = want[0][:, :T2]
    m = t != INVALID_TXP
    np.testing.assert_array_equal(eq.labels, t[m])
    np.testing.assert_array_equal(eq.class_sizes, m.sum(axis=1))
    np.testing.assert_array_equal(eq.offsets[1:], np.cumsum(m.sum(axis=1)))
    np.testing.assert_array_equal(eq.counts, want[1])
    np.testing.assert_allclose(eq.weights, (want[2] / want[1][:, None])[m],
                               rtol=1e-12, atol=0)
    assert eq.num_fragments == sum(
        int((b[0][:, 0] != INVALID_TXP).sum()) for b in batches)


@pytest.mark.parametrize("bins", [True, False], ids=["bins", "no_bins"])
def test_growth_from_tiny_start(bins):
    """A table with room for 4 classes grows through many doublings; every
    merge may grow it once, to what the merge's rows need."""
    batches = _batches(7, n_batches=8, rows=2000, n_classes=6000, bins=bins)
    ref = _reference(batches)
    table = _Table(ref[0].shape[1], T2, n_rows=4)
    new = 0
    for b in batches:
        one = _reference([b])
        new += table.merge(*one)
        assert table.size == new
    assert new == ref[0].shape[0]
    _assert_rows_equal(table.export(), ref)


def test_probe_collisions():
    """Rows equal but for their last column, into a table that starts with
    room for 4 classes: long probe runs, a key compared in full."""
    rng = np.random.default_rng(11)
    n = 5000
    keys = np.tile(np.arange(2 * T2, dtype=np.int32), (n, 1))
    keys[:, -1] = rng.integers(0, 700, n)
    w = rng.random((n, T2))
    table = _Table(2 * T2, T2, n_rows=4)
    for part in np.array_split(np.arange(n), 7):
        table.merge(keys[part], np.ones(part.size), w[part])
    _assert_rows_equal(table.export(), _dedupe_rows(keys, np.ones(n), w))
    assert table.size == np.unique(keys[:, -1]).size


@pytest.mark.parametrize("bins", [True, False], ids=["bins", "no_bins"])
def test_replace_rows(bins):
    """Two accumulators' tables, concatenated, become one table: the
    multi-rank merge after the stream."""
    batches = _batches(5, bins=bins)
    parts = []
    for half in (batches[::2], batches[1::2]):
        acc = EquivalenceClassAccumulator(merge_buffer_rows=500)
        for b in half:
            acc.add_batch(*b)
        parts.append(acc.collapsed())
    acc = EquivalenceClassAccumulator()
    acc.add_batch(*batches[0])
    acc.replace_rows(*(np.concatenate(x) for x in zip(*parts)), T2)
    want = _reference(batches[::2] + batches[1::2])
    _assert_rows_equal(acc.collapsed(), want)
    assert acc.num_classes == want[0].shape[0]
    assert acc.finish().counts.sum() == want[1].sum()


def test_empty():
    acc = EquivalenceClassAccumulator()
    txp = np.full((8, T2), INVALID_TXP, np.int32)
    acc.add_batch(txp, np.zeros((8, T2), np.float32))
    assert acc.num_classes == 0
    eq = acc.finish()
    assert eq.num_classes == 0 and eq.offsets.tolist() == [0]
    acc.replace_rows(np.zeros((0, 0), np.int32), np.zeros(0),
                     np.zeros((0, 0)), T2)
    assert acc.finish().num_classes == 0


def test_rejects_rows_of_another_width():
    """Rows that do not fit the table's widths never reach the native
    code."""
    table = _Table(2 * T2, T2)
    with pytest.raises(ValueError):
        table.merge(np.zeros((3, T2), np.int32), np.ones(3),
                    np.zeros((3, T2)))
    with pytest.raises(ValueError):
        table.merge(np.zeros((3, 2 * T2), np.int32), np.ones(2),
                    np.zeros((3, T2)))
    acc = EquivalenceClassAccumulator(merge_buffer_rows=1)
    txp, w, bins = _batches(1, n_batches=1)[0]
    acc.add_batch(txp, w, bins)
    with pytest.raises(ValueError):
        acc.add_batch(txp, w, None)
    assert table.size == 0
