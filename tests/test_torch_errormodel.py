"""The alignment error model of `-a`: the port's torch model
(alignment/errormodel_device.py) against the JAX package's jitted model
and against the numpy model (alignment/errormodel.py, its plain
version), on the mixed-CIGAR BAMs of test_torch_bamio.py (indels, clips,
=/X runs past the 16-op grid, which take the numpy walk in both
packages).

Tolerances: the transition keys, the grid's fits mask, the numpy walk
and the ONT model are integer or the same float64 code, so exact.
Counts are float32 sums of the same weights in another order: rtol 1e-5
against the JAX model (and against the float64 numpy model). A record's
likelihood is a float32 sum of up to ~140 log-probabilities of
magnitude <= ~12: within atol 1e-4 (rtol 1e-5) of the JAX model's from
the same counts, atol 1e-3 of the float64 numpy model's.
"""

import numpy as np
import pytest
import torch

from salmon_tpu.alignment import errormodel as jerr
from salmon_tpu.alignment import errormodel_device as jdev
from salmon_tpu_torch.alignment import bamio as tbam
from salmon_tpu_torch.alignment import errormodel as terr
from salmon_tpu_torch.alignment import errormodel_device as tdev
from test_torch_bamio import mixed_records, targets

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(reference arrays, batches of three mixed BAMs)."""
    names, lens, seqs = targets()
    seq = np.concatenate(seqs)
    seq_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    d = tmp_path_factory.mktemp("em_bams")
    batches = []
    for seed in (7, 8, 9):
        path = str(d / f"m{seed}.bam")
        tbam.write_bam(path, names, lens, mixed_records(seed=seed, n=240))
        rdr = tbam.BamReader(path)
        batches.append(next(rdr.batches()))
        rdr.close()
    ref = (seq, seq_off, np.asarray(lens, np.int64),
           np.arange(len(names), dtype=np.int64))
    return ref, batches


def _mapped(b):
    return np.nonzero(b.refid[:b.n] >= 0)[0]


def _jax_counts(model):
    c = np.asarray(model.counts, np.float64)
    return c + model._np_model.counts if model._np_dirty else c


def test_expand_keys_matches_jax(setup):
    """The same grid rows (overflow rows included) and, from them, the
    same keys and validity as the JAX _expand_keys, exactly."""
    (seq, seq_off, tlens, ref_map), batches = setup
    jm = jdev.DeviceAlignmentErrorModel(seq, seq_off, tlens)
    tm = tdev.DeviceAlignmentErrorModel(seq, seq_off, tlens, device="cpu")
    n_over = 0
    for b in batches:
        sel = _mapped(b)
        jp, jfits, n = jm._pack(b, sel, ref_map)
        tp, tfits = tm._pack(b, sel, ref_map)
        np.testing.assert_array_equal(tfits, jfits)
        n_over += int((~tfits).sum())
        jkey, jvalid = jdev._expand_keys(
            jp["ops"], jp["oplens"], jp["rseq"], jp["rlen"], jp["toff"],
            jp["pos"], jp["tlen"], jm.seq_codes)
        tkey, tvalid = tdev.expand_keys(
            tp["ops"], tp["oplens"], tp["rseq"], tp["rlen"], tp["toff"],
            tp["pos"], tp["tlen"], tm.seq_codes)
        np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey)[:n])
        np.testing.assert_array_equal(tvalid.numpy(),
                                      np.asarray(jvalid)[:n])
        assert tvalid.sum() > 0
        mate = np.arange(n) % 2
        np.testing.assert_array_equal(
            tdev.expand_fused(tp["ops"], tp["oplens"], tp["rseq"],
                              tp["rlen"], tp["toff"], tp["pos"],
                              tp["tlen"], torch.from_numpy(mate),
                              tm.seq_codes).numpy(),
            np.asarray(jdev._expand_fused(
                jp["ops"], jp["oplens"], jp["rseq"], jp["rlen"],
                jp["toff"], jp["pos"], jp["tlen"],
                np.pad(mate, (0, jp["rlen"].shape[0] - n)).astype(np.int32),
                jm.seq_codes))[:n])
    assert n_over > 0, "no record took the host path"


def test_counts_and_likelihoods_match_jax(setup):
    """A sequence of fused (both mates) and unfused updates in both
    packages: the same counts, and the same likelihoods along the way
    from the same state."""
    (seq, seq_off, tlens, ref_map), batches = setup
    jm = jdev.DeviceAlignmentErrorModel(seq, seq_off, tlens)
    tm = tdev.DeviceAlignmentErrorModel(seq, seq_off, tlens, device="cpu")
    rng = np.random.default_rng(0)
    for step, b in enumerate(batches):
        sel = _mapped(b)
        k = sel.size // 2
        i1, i2 = sel[:k], sel[k:2 * k]
        jprep = jm.prepare(b, i1, i2, ref_map)
        tprep = tm.prepare(b, i1, i2, ref_map)
        if step:
            np.testing.assert_allclose(tprep.log_likelihood(),
                                       jprep.log_likelihood(),
                                       rtol=1e-5, atol=1e-4)
        w = rng.random(k)
        jprep.update(w)
        tprep.update(w)
        w2 = rng.random(sel.size)
        jm.update(b, sel, ref_map, w2, step % 2)
        tm.update(b, sel, ref_map, w2, step % 2)
        np.testing.assert_allclose(tdev.read_counts(tm), _jax_counts(jm),
                                   rtol=1e-5)
        for mate in (0, 1):
            np.testing.assert_allclose(
                tm.log_likelihood(b, sel, ref_map, mate),
                jm.log_likelihood(b, sel, ref_map, mate),
                rtol=1e-5, atol=1e-4)


def test_likelihoods_from_carried_counts(setup):
    """The JAX model's trained counts carried into the port's model give
    the JAX model's likelihoods, and read back unchanged."""
    (seq, seq_off, tlens, ref_map), batches = setup
    jm = jdev.DeviceAlignmentErrorModel(seq, seq_off, tlens)
    rng = np.random.default_rng(1)
    for b in batches:
        sel = _mapped(b)
        jm.update(b, sel, ref_map, rng.random(sel.size), 0)
        jm.update(b, sel, ref_map, rng.random(sel.size), 1)
    jm.normalize()
    counts = np.asarray(jm.counts)
    tm = tdev.DeviceAlignmentErrorModel(seq, seq_off, tlens, device="cpu")
    tdev.load_counts(tm, counts)
    np.testing.assert_array_equal(tdev.read_counts(tm), counts)
    for b in batches:
        sel = _mapped(b)
        k = sel.size // 2
        for mate in (0, 1):
            np.testing.assert_allclose(
                tm.log_likelihood(b, sel, ref_map, mate),
                jm.log_likelihood(b, sel, ref_map, mate),
                rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(
            tm.prepare(b, sel[:k], sel[k:2 * k], ref_map).log_likelihood(),
            jm.prepare(b, sel[:k], sel[k:2 * k], ref_map).log_likelihood(),
            rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mate", [0, 1])
def test_device_model_matches_numpy_model(setup, mate):
    """The torch model against its plain version, the float64 numpy
    walk over every record."""
    (seq, seq_off, tlens, ref_map), batches = setup
    host = terr.AlignmentErrorModel()
    tm = tdev.DeviceAlignmentErrorModel(seq, seq_off, tlens, device="cpu")
    rng = np.random.default_rng(2)
    for b in batches:
        sel = _mapped(b)
        w = rng.random(sel.size)
        host.update(terr.expand_batch(b, sel, ref_map, seq, seq_off, tlens),
                    w, mate)
        tm.update(b, sel, ref_map, w, mate)
    np.testing.assert_allclose(tdev.read_counts(tm), host.counts,
                               rtol=1e-5)
    host.normalize()
    for b in batches:
        sel = _mapped(b)
        cols = terr.expand_batch(b, sel, ref_map, seq, seq_off, tlens)
        np.testing.assert_allclose(
            tm.log_likelihood(b, sel, ref_map, mate),
            host.log_likelihood(cols, sel.size, mate), rtol=1e-4,
            atol=1e-3)


def test_numpy_walk_and_clips_match_jax(setup):
    """expand_batch and clip_counts: the same arrays as the JAX
    package's."""
    (seq, seq_off, tlens, ref_map), batches = setup
    for b in batches:
        sel = _mapped(b)
        got = terr.expand_batch(b, sel, ref_map, seq, seq_off, tlens)
        want = jerr.expand_batch(b, sel, ref_map, seq, seq_off, tlens)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], k)
        for g, w in zip(terr.clip_counts(b, sel), jerr.clip_counts(b, sel)):
            np.testing.assert_array_equal(g, w)


def test_ont_model_matches_jax():
    """--ont's model: updates and likelihoods equal to the JAX
    package's."""
    rng = np.random.default_rng(0)
    models = (terr.ONTErrorModel(), jerr.ONTErrorModel())
    for _ in range(3):
        n = 2000
        read_len = rng.integers(200, 3000, n)
        nm = rng.binomial(read_len, 0.08)
        fcl, bcl = rng.poisson(5.0, n), rng.poisson(20.0, n)
        scl = rng.integers(0, 5, n)
        hcl = fcl + bcl
        w = rng.random(n)
        for m in models:
            m.update(read_len, nm, fcl, bcl, scl, hcl, w)
        for f in ("err", "fclip", "bclip"):
            np.testing.assert_array_equal(getattr(models[0], f),
                                          getattr(models[1], f))
        args = (read_len, nm + rng.integers(-20, 20, n), fcl * 2, bcl,
                scl, hcl)
        np.testing.assert_array_equal(models[0].log_likelihood(*args),
                                      models[1].log_likelihood(*args))
