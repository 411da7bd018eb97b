"""BASELINE config 5 and the human-scale scripts: the port's
salmon_tpu_torch.scripts against the JAX package's scripts/, at toy size
on the CPU, and the bucket table's first fingerprint match against its
plain version.

- demo_config5_quant: tests/test_config5_demo.py's table-less
  partitioned index and the sample reads, at 1, 2 and 4 shards. The
  fragments, keys, iterations and mapped fraction are equal; the eq
  classes are equal but for fragments whose join holds a tie
  (ROADMAP queue 3: two candidates of one end on one transcript and
  strand tie on the join key, pair.py:87, and the packages pair
  different members), which the test finds and counts; alphas within
  rtol 5e-3 / atol 0.5 of fastem.optimize_routed on the same eq classes.
- build_genome_scale_index: the decoy generator byte for byte, and the
  index planes of a small transcriptome plus decoys.
- check_hs_accuracy, eval_hs_accuracy: their printed lines on a small
  synthetic set.
"""

import contextlib
import io
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from salmon_tpu_torch.index import hashtable, native_kmers
from salmon_tpu_torch.scripts import (build_genome_scale_index as t_build,
                                      check_hs_accuracy as t_check,
                                      demo_config5_quant as t_demo,
                                      eval_hs_accuracy as t_eval)

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DATA = os.path.join(HERE, "data")
READS = (os.path.join(DATA, "reads_1.fastq"),
         os.path.join(DATA, "reads_2.fastq"))
RTOL, ATOL = 5e-3, 0.5
INVALID = 2**31 - 1


def _script(name):
    return os.path.join(REPO, "scripts", f"{name}.py")


def _run_jax_script(name, argv, monkeypatch):
    """Run scripts/<name>.py's main through runpy; its stdout lines."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    ns = runpy.run_path(_script(name), run_name="not_main")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ns["main"]()
    return buf.getvalue().strip().splitlines()


def _run_port(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv, device="cpu")
    assert rc == 0
    return buf.getvalue().strip().splitlines()


def _table_less(monkeypatch):
    from salmon_tpu.index import builder as jb
    from salmon_tpu_torch.index import builder as tb
    for mod in (jb, tb):
        monkeypatch.setattr(mod, "TABLE_DIRECT_MAX_KEYS", 1)
    return jb, tb


# ---------------------------------------------------------------------------
# demo_config5_quant
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tl_index(tmp_path_factory):
    """test_config5_demo.py's index: the sample transcripts at k 25,
    partitioned at 2 bits, table-less; built by both packages, whose
    directories are equal file for file."""
    mp = pytest.MonkeyPatch()
    try:
        jb, tb = _table_less(mp)
        base = tmp_path_factory.mktemp("config5")
        fa = os.path.join(DATA, "transcripts.fasta")
        dirs = []
        for b, name in ((jb, "jax"), (tb, "port")):
            idx = b.build_index(fa, k=25, partition_bits=2)
            assert idx.table is None
            d = str(base / name)
            b.save_index(idx, d)
            dirs.append(d)
    finally:
        mp.undo()
    _assert_same_index_dirs(*dirs)
    return dirs[0]


def _assert_same_index_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for nm in names:
        if nm.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(a, nm)),
                                          np.load(os.path.join(b, nm)),
                                          err_msg=nm)
    with open(os.path.join(a, "info.json")) as fa, \
            open(os.path.join(b, "info.json")) as fb:
        assert json.load(fa) == json.load(fb)


def _classes(eq) -> dict:
    return {tuple(eq.labels[eq.offsets[c]:eq.offsets[c + 1]].tolist()):
            float(eq.counts[c]) for c in range(eq.counts.shape[0])}


def _label_sets(eq_txp: np.ndarray) -> list:
    return [tuple(r[r != INVALID].tolist()) for r in eq_txp]


def _join_tie(cands, row: int, txps) -> bool:
    """Whether one end of fragment `row` holds two valid candidates on one
    of `txps` and one strand: a tie on the join key."""
    for cand in cands:
        v = cand["valid"][row].numpy()
        t = cand["txp"][row].numpy()[v]
        fw = cand["is_fw"][row].numpy()[v]
        for x in txps:
            for s in (False, True):
                if ((t == x) & (fw == s)).sum() >= 2:
                    return True
    return False


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_demo_config5_matches_jax(tl_index, n_shards, monkeypatch):
    from salmon_tpu.inference import fastem
    from salmon_tpu.inference.eqclasses import EquivalenceClassAccumulator
    from salmon_tpu_torch.inference.eqclasses import PackedEqClasses
    from salmon_tpu_torch.mapping import pipeline as tpipe

    for k, v in (("CONFIG5_IDX", tl_index), ("CONFIG5_R1", READS[0]),
                 ("CONFIG5_R2", READS[1])):
        monkeypatch.setenv(k, v)
    want = {"rows": []}
    add, finish = (EquivalenceClassAccumulator.add_batch,
                   EquivalenceClassAccumulator.finish)
    routed = fastem.optimize_routed

    def add_batch(self, eq_txp, eq_weight, eq_bins=None):
        want["rows"] += _label_sets(eq_txp)
        return add(self, eq_txp, eq_weight, eq_bins)

    def finish_(self):
        want["eq"] = finish(self)
        return want["eq"]

    def routed_(*a, **kw):
        want["em"] = routed(*a, **kw)
        return want["em"]

    monkeypatch.setattr(EquivalenceClassAccumulator, "add_batch", add_batch)
    monkeypatch.setattr(EquivalenceClassAccumulator, "finish", finish_)
    monkeypatch.setattr(fastem, "optimize_routed", routed_)
    jrep = json.loads(_run_jax_script(
        "demo_config5_quant", [str(n_shards), "20000"], monkeypatch)[-1])

    # the port: its JSON line from main, its run, eq rows and candidates
    got = {"rows": [], "cands": []}
    join, map_from, quantify = (tpipe.join_pairs, tpipe.map_paired_from_cands,
                                t_demo.quantify)

    def join_pairs(cand_l, cand_r, *a, **kw):
        got["cands"].append((cand_l, cand_r))
        return join(cand_l, cand_r, *a, **kw)

    def map_paired_from_cands(*a, **kw):
        out = map_from(*a, **kw)
        got["rows"] += _label_sets(out["eq_txp"].numpy())
        return out

    def quantify_(*a, **kw):
        got["run"] = quantify(*a, **kw)
        return got["run"]

    monkeypatch.setattr(tpipe, "join_pairs", join_pairs)
    monkeypatch.setattr(tpipe, "map_paired_from_cands",
                        map_paired_from_cands)
    monkeypatch.setattr(t_demo, "quantify", quantify_)
    trep = json.loads(_run_port(t_demo, [str(n_shards), "20000"])[-1])
    run = got["run"]
    assert run.report == trep

    assert list(trep) == list(jrep)
    for key in ("n_shards", "n_frags", "index_keys_g", "index_occs_g",
                "em_iters", "mapped_frac"):
        assert trep[key] == jrep[key], key
    assert trep["n_frags"] == 10000

    # eq classes: equal but for fragments whose join holds a tie
    jrows, trows = want["rows"], got["rows"]
    assert len(jrows) == len(trows)
    diff = [r for r, (a, b) in enumerate(zip(jrows, trows)) if a != b]
    R = t_demo.R
    ties = [r for r in diff if _join_tie(got["cands"][r // R], r % R,
                                         set(jrows[r]) ^ set(trows[r]))]
    assert ties == diff
    assert len(diff) <= 2          # 1 of 10,000 at every shard count
    jcls, tcls = _classes(want["eq"]), _classes(run.eq)
    moved = sum(abs(jcls.get(k, 0.0) - tcls.get(k, 0.0))
                for k in set(jcls) | set(tcls))
    assert moved == 2 * len(diff)

    # the VBEM: the port's on the JAX package's eq classes within
    # tolerance of the routed engine's, at the same iteration count;
    # the run's own alphas too, away from the tied fragments' transcripts
    jeq = want["eq"]
    lengths = np.load(os.path.join(tl_index, "lengths.npy"))
    alphas, iters = t_demo.run_vbem(
        PackedEqClasses(labels=jeq.labels, weights=jeq.weights,
                        offsets=jeq.offsets, counts=jeq.counts,
                        class_sizes=jeq.class_sizes), lengths, "cpu")
    assert iters == want["em"]["iterations"] == trep["em_iters"]
    np.testing.assert_allclose(alphas, want["em"]["alphas"], rtol=RTOL,
                               atol=ATOL)
    touched = sorted({t for r in diff for t in jrows[r] + trows[r]})
    keep = np.ones(lengths.shape[0], bool)
    keep[touched] = False
    np.testing.assert_allclose(run.alphas[keep], want["em"]["alphas"][keep],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mod", [t_demo, t_build, t_check, t_eval],
                         ids=["demo", "build", "check", "eval"])
def test_scripts_need_cuda(mod, monkeypatch, tmp_path):
    """No CPU fallback: without a CUDA device each script raises before
    it reads or writes anything, unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BENCH_CACHE", str(tmp_path / "cache"))
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
    assert not os.path.exists(tmp_path / "cache")


# ---------------------------------------------------------------------------
# build_genome_scale_index
# ---------------------------------------------------------------------------

def test_make_decoys_byte_equal(tmp_path):
    ns = runpy.run_path(_script("build_genome_scale_index"),
                        run_name="not_main")
    a, b = str(tmp_path / "jax.fa"), str(tmp_path / "port.fa")
    ns["make_decoys"](a, 64 / 1024)         # one 64 MiB chromosome
    t_build.make_decoys(b, 64 / 1024)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        ja, jb = fa.read(), fb.read()
    assert len(ja) == 64 * 2**20 + len(">decoy_chr0\n\n")
    assert ja == jb


def test_build_script_matches_jax(tmp_path, monkeypatch):
    """Both build scripts on the sample transcripts plus two small random decoy
    chromosomes, built the genome-scale way (partitioned, table-less):
    equal index directories."""
    from salmon_tpu.index import builder as jb
    from salmon_tpu_torch.index import builder as tb
    _table_less(monkeypatch)
    for mod in (jb, tb):
        monkeypatch.setattr(mod, "PARTITIONED_BUILD_BASES", 1)
    dirs = []
    for name in ("jax", "port"):
        cache = tmp_path / name
        cache.mkdir()
        with open(os.path.join(DATA, "transcripts.fasta")) as src:
            (cache / "txome.fasta").write_text(src.read())
        with open(cache / "decoys_0.001gb.fasta", "w") as fh:
            r = np.random.default_rng(3)
            for c in range(2):
                seq = np.frombuffer(b"ACGT", np.uint8)[
                    r.integers(0, 4, 5000)].tobytes().decode()
                fh.write(f">decoy_chr{c}\n{seq}\n")
        monkeypatch.setenv("BENCH_CACHE", str(cache))
        monkeypatch.setenv("KEEP_GENOME_IDX", "1")
        if name == "jax":
            out = _run_jax_script("build_genome_scale_index", ["0.001"],
                                  monkeypatch)
        else:
            out = _run_port(t_build, ["0.001"])
        rep = eval(out[-1])                     # the printed dict
        assert rep["tableless"] and rep["decoys"] == 2
        dirs.append(str(cache / "genome_idx"))
    _assert_same_index_dirs(*dirs)


# ---------------------------------------------------------------------------
# check_hs_accuracy, eval_hs_accuracy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hs_cache(tmp_path_factory):
    """A small harness cache: scripts/make_synthetic_txome.py at 300
    transcripts and 3,000 pairs, indexed at k 31 into hs_idx."""
    from salmon_tpu_torch.index.builder import build_index, save_index
    cache = str(tmp_path_factory.mktemp("hs_cache"))
    subprocess.run([sys.executable, _script("make_synthetic_txome"),
                    "--out-dir", cache, "--n-txps", "300",
                    "--n-pairs", "3000"], check=True,
                   stdout=subprocess.DEVNULL)
    save_index(build_index(os.path.join(cache, "txome.fasta"), k=31),
               os.path.join(cache, "hs_idx"))
    return cache


def test_check_hs_accuracy_matches_jax(hs_cache, monkeypatch):
    monkeypatch.setenv("BENCH_CACHE", hs_cache)
    monkeypatch.setenv("BENCH_BATCH", "1024")
    want = _run_jax_script("check_hs_accuracy", ["2"], monkeypatch)[-1]
    got = _run_port(t_check, ["2"])[-1]
    rep = eval(got)
    assert rep["fragments"] == 2048 and rep["mapped_frac"] > 0.95
    assert got == want


def test_eval_hs_accuracy_matches_jax(hs_cache, tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_CACHE", hs_cache)
    want = _run_jax_script("eval_hs_accuracy", [str(tmp_path / "jax")],
                           monkeypatch)
    got = _run_port(t_eval, [str(tmp_path / "port")])
    assert got[-2:] == want[-2:]
    rho = float(got[-1].split()[0].split("=")[1])
    assert rho > 0.9


# ---------------------------------------------------------------------------
# the bucket table's first fingerprint match
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_keys,fp_bits", [(1000, 2), (200_000, 4),
                                            (1_000_000, 16)])
def test_first_match_native_equals_plain(n_keys, fp_bits):
    """native_kmers.table_first_match against hashtable._first_match_numpy
    on a placed table whose stored fingerprints are narrowed to
    `fp_bits` bits, so that matches, shadows and misses all occur."""
    rng = np.random.default_rng(n_keys)
    keys = np.unique(rng.integers(0, 1 << 62, n_keys, dtype=np.int64)
                     .astype(np.uint64))
    n = keys.shape[0]
    n_buckets = hashtable.table_n_slots(n) // hashtable.SLOTS_PER_BUCKET
    slot_key, _ = native_kmers.table_place(keys, np.ones(n, np.int64),
                                           n_buckets)
    fp = rng.integers(0, 1 << fp_bits, n).astype(np.uint32)
    rows = np.zeros((n_buckets, 8), np.int32)
    pb, ps = np.nonzero(slot_key >= 0)
    rows[pb, 2 * ps] = ((fp[slot_key[pb, ps]] << np.uint32(16))
                        | np.uint32(1)).view(np.int32)
    # queries: every placed key in each of its buckets, and random
    # buckets with random fingerprints
    hi, lo = hashtable.split_u64(keys)
    mask = np.uint32(n_buckets - 1)
    pk = slot_key[pb, ps]
    b1 = (hashtable.mix32(hi, lo) & mask).astype(np.int64)[pk]
    b2 = (hashtable.mix32b(hi, lo) & mask).astype(np.int64)[pk]
    b3 = rng.integers(0, n_buckets, pk.shape[0])
    got = native_kmers.table_first_match(rows, slot_key, fp[pk], b1, b2, b3)
    want = hashtable._first_match_numpy(rows, slot_key, fp[pk], b1, b2, b3)
    for (gs, ge), (ws, we) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(ge, we)
    # matches and misses occur, and some first matches are foreign keys
    (s1, e1), (s2, e2) = got[:2]
    assert ((s1 < 8) | (s2 < 8)).all()         # a key finds its own fp
    assert (got[2][0] == 8).any() and (got[2][0] < 8).any()
    own = np.arange(pk.shape[0])
    first = np.where(s1 < 8, e1, e2)
    assert (first != own).any() or fp_bits == 16


@pytest.mark.parametrize("chunk", [None, 4096], ids=["one_chunk",
                                                     "chunks"])
def test_build_hash_table_native_equals_plain(chunk, monkeypatch):
    """The whole table (rows, shadow appendix, inlined records) from the
    native passes over the placed keys (row fill, first match, inline)
    equals the table from their plain versions, in one bucket chunk or
    several, and the JAX package's."""
    from salmon_tpu.index import hashtable as jht

    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(0, 1 << 62, 300_000, dtype=np.int64)
                     .astype(np.uint64))
    counts = rng.integers(1, 4, keys.shape[0])
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    txp = rng.integers(0, 5000, int(off[-1])).astype(np.int32)
    pf = rng.integers(0, 1 << 20, int(off[-1])).astype(np.int32)
    kw = dict(occ_offsets=off, inline_records=(txp, pf))
    ref = jht.build_hash_table(keys, **kw)
    if chunk:
        monkeypatch.setattr(hashtable, "_CHUNK_BUCKETS", chunk)
    got = hashtable.build_hash_table(keys, **kw)
    for name, plain in (("table_first_match", hashtable._first_match_numpy),
                        ("table_fill_rows", hashtable._fill_rows_numpy),
                        ("table_inline", hashtable._inline_numpy)):
        monkeypatch.setattr(native_kmers, name, plain)
    want = hashtable.build_hash_table(keys, **kw)
    assert got.n_shadowed == want.n_shadowed == ref.n_shadowed > 0
    assert got.rows.shape[0] > 4 * 4096
    for tab in (want, ref):
        np.testing.assert_array_equal(got.rows, tab.rows)
        np.testing.assert_array_equal(got.appendix, tab.appendix)
        assert (got.n_inlined, got.n_evicted) == (tab.n_inlined,
                                                  tab.n_evicted)
