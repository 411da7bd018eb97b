"""The sparse seed flow and the pooled occurrence gathers of the PyTorch
port against the JAX package.

- collect_hits_sparse, rebudget_hits and rank_hits on lookups made with
  numpy from a seed: one and two read ends, stride 1 and 3, a hit budget
  that covers every hit and one that binds, occurrence lists holding the
  separator records of shadow-merged blocks (matching and foreign
  fingerprints) and inlined single records. Every output is exact: the
  flow is integer arithmetic, and each of its order-sensitive
  reductions is keyed fully (the JAX package's first sort carries the
  diagonal unkeyed, but equal keys are hits of one window and diagonal
  bucket, whose distinct-window count and minimum ignore their order).
- map_paired_batch / map_single_batch with sparse_seed on the sample
  reads: counters, eq tensors and histograms exact, weights at rtol
  1e-5. The best hit is the first joined hit after mapping.pair's
  ranking by pair score, an unstable sort in the JAX package (ROADMAP
  queue 3), so the best_* keys are compared on fragments without a tie
  on the top score, as tests/test_torch_pipeline.py does.
- expand_occurrences with row_pool = P (covers every window), row_pool
  = 2 (binds) and inline_pool: valid lanes, their records and the
  overflow count exact.
- Both CLIs on the sample reads with SALMON_TPU_SPARSE_SEED=1 and with
  SALMON_TPU_ROWPOOL=64: quant.sf within the golden tolerance and the
  mapping counters equal.

u32 values are int64 tensors in the port (salmon_tpu_torch.utils.u32)
and uint32 arrays in JAX; they are compared as int64.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_pipeline as ttp
import torch

from salmon_tpu import cli as jcli
from salmon_tpu.index import builder as jb
from salmon_tpu.mapping import pipeline as jpipe
from salmon_tpu.mapping import score as jsc
from salmon_tpu.mapping import seed_sparse as jss
from salmon_tpu.utils import libformat as jlf
from salmon_tpu_torch import cli
from salmon_tpu_torch.index import builder as tb
from salmon_tpu_torch.io.fastq import iter_paired_chunks, iter_single_chunks
from salmon_tpu_torch.mapping import lookup as tlk
from salmon_tpu_torch.mapping import pipeline as tpipe
from salmon_tpu_torch.mapping import score as tsc
from salmon_tpu_torch.mapping import seed_sparse as tss

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
READS = ["-1", os.path.join(DATA, "reads_1.fastq"),
         "-2", os.path.join(DATA, "reads_2.fastq")]

# the JAX functions, compiled once per shape (op by op they run slowly)
J_COLLECT = jax.jit(jss.collect_hits_sparse, static_argnames=(
    "occ_cap", "max_occs_per_hit", "hits_per_end", "stride",
    "diag_bucket_bits"))
J_REBUDGET = jax.jit(jss.rebudget_hits,
                     static_argnames=("P", "hits_per_end"))
J_RANK = jax.jit(jss.rank_hits, static_argnames=("R", "E", "P",
                                                 "max_cands"))


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_eq(got, want, msg=""):
    g, w = np_(got), np_(want)
    assert g.shape == w.shape, (msg, g.shape, w.shape)
    np.testing.assert_array_equal(
        g.astype(np.int64) if g.dtype != bool else g,
        w.astype(np.int64) if w.dtype != bool else w, err_msg=msg)


def make_end(rng, R: int, P: int, C: int, occ: np.ndarray):
    """One read end's k-mers and lookup, both packages' forms: windows
    with 1..C+4 occurrences (some past max_occs_per_hit = C + 2), a
    tenth not found, a fifth inlined, a tenth invalid k-mers; in a
    tenth of the found windows one record of the range is a separator
    of a shadow-merged block, half of them carrying the window's own
    fingerprint30. Writes the separators into `occ`."""
    n_occ = occ.shape[0] * 8
    hi = rng.integers(0, 2**32, (R, P), dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, (R, P), dtype=np.uint64).astype(np.uint32)
    fp = tlk.fingerprint30(torch.from_numpy(hi.astype(np.int64)),
                           torch.from_numpy(lo.astype(np.int64))).numpy()
    found = rng.random((R, P)) < 0.9
    inl = found & (rng.random((R, P)) < 0.2)
    count = rng.integers(1, C + 5, (R, P)).astype(np.int32)
    start = rng.integers(0, n_occ - 64, (R, P)).astype(np.int32)
    count = np.where(inl, 1, np.where(found, count, 0)).astype(np.int32)
    start = np.where(inl, -2, np.where(found, start, -1)).astype(np.int32)
    itxp = rng.integers(0, 40, (R, P)).astype(np.int32)
    ipf = rng.integers(0, 2 * 3000, (R, P)).astype(np.int32)
    flat = occ.reshape(-1, 2)
    sep = found & ~inl & (count >= 2) & (rng.random((R, P)) < 0.1)
    for r, p in zip(*np.nonzero(sep)):
        at = start[r, p] + rng.integers(1, count[r, p])
        own = rng.random() < 0.5
        flat[at] = (-1, int(fp[r, p] if own else rng.integers(0, 2**30))
                    << 1)
    fw = rng.random((R, P)) < 0.5
    valid = rng.random((R, P)) < 0.9
    jk = {"hi": jnp.asarray(hi), "lo": jnp.asarray(lo),
          "is_fw": jnp.asarray(fw), "valid": jnp.asarray(valid)}
    tk = {"hi": torch.from_numpy(hi.astype(np.int64)),
          "lo": torch.from_numpy(lo.astype(np.int64)),
          "is_fw": torch.from_numpy(fw), "valid": torch.from_numpy(valid)}
    lk = (start, count, found, inl, itxp, ipf)
    return ((jk, tuple(jnp.asarray(a) for a in lk)),
            (tk, tuple(torch.from_numpy(a) for a in lk)))


def make_ends(seed: int, E: int, R: int = 48, P: int = 20, C: int = 8):
    rng = np.random.default_rng(seed)
    occ = np.zeros((6000, 16), np.int32)
    occ[:, 0::2] = rng.integers(0, 40, (6000, 8))
    occ[:, 1::2] = rng.integers(0, 2 * 3000, (6000, 8))
    ends = [make_end(rng, R, P, C, occ) for _ in range(E)]
    return ([e[0] for e in ends], [e[1] for e in ends], jnp.asarray(occ),
            torch.from_numpy(occ))


CASES = [(1, 1, 160), (2, 1, 160), (2, 3, 160), (1, 3, 8), (2, 1, 8),
         (2, 3, 5)]


@pytest.mark.parametrize("E,stride,budget", CASES,
                         ids=[f"E{e}-stride{s}-B{b}" for e, s, b in CASES])
def test_collect_and_rank_hits_exact(E, stride, budget):
    """budget 160 = P x C covers every hit; 8 and 5 bind."""
    jends, tends, jocc, tocc = make_ends(10 + E * 7 + stride, E)
    R, P = tends[0][1][0].shape
    kw = dict(occ_cap=8, max_occs_per_hit=10, hits_per_end=budget,
              stride=stride, diag_bucket_bits=5)
    want = J_COLLECT(jends, jocc, **kw)
    got = tss.collect_hits_sparse(tends, tocc, **kw)
    for name, g, w in zip(("rid", "key", "key2", "diag"), got, want):
        assert_eq(g, w, name)
    rid = np_(want[0]).astype(np.int64)
    n_hits = int((rid != 0xFFFFFFFF).sum())
    assert n_hits > (E * R * budget // 2 if budget < 20 else 1000)
    # the separators took effect: some slots of a merged range dropped
    assert n_hits < int(np_(want[0]).shape[0])
    wc = J_RANK(want, R=R, E=E, P=P, max_cands=16)
    gc = tss.rank_hits(got, R=R, E=E, P=P, max_cands=16)
    assert len(gc) == len(wc) == E
    for e in range(E):
        assert int(np_(wc[e]["valid"]).sum()) > R
        for name in ("txp", "is_fw", "score", "min_diag", "valid"):
            assert_eq(gc[e][name], wc[e][name], f"end {e} {name}")
    full = tss.seed_candidates_sparse(tends, tocc, max_cands=16, **kw)
    for e in range(E):
        for name in full[e]:
            assert torch.equal(full[e][name], gc[e][name]), name


@pytest.mark.parametrize("budget", [160, 6])
def test_rebudget_hits_exact(budget):
    """Two disjoint halves of each end's windows collected apart (the
    sharded index's per-shard lists), concatenated and re-budgeted."""
    jends, tends, jocc, tocc = make_ends(31, 2)
    R, P = tends[0][1][0].shape
    kw = dict(occ_cap=8, max_occs_per_hit=10, hits_per_end=budget)
    halves = np.random.default_rng(4).random((R, P)) < 0.5

    def shard(ends, part, asarray):
        out = []
        for km, lk in ends:
            found = np_(lk[2]) & (halves == part)
            out.append((km, (lk[0], lk[1], asarray(found)) + tuple(lk[3:])))
        return out

    want = [J_COLLECT(shard(jends, s, jnp.asarray), jocc, **kw)
            for s in (0, 1)]
    got = [tss.collect_hits_sparse(shard(tends, s, torch.from_numpy), tocc,
                                   **kw) for s in (0, 1)]
    want = J_REBUDGET(tuple(jnp.concatenate([a, b]) for a, b in
                                   zip(*want)), P=P, hits_per_end=budget)
    got = tss.rebudget_hits(tuple(torch.cat([a, b]) for a, b in zip(*got)),
                            P=P, hits_per_end=budget)
    for name, g, w in zip(("rid", "key", "key2", "diag"), got, want):
        assert_eq(g, w, name)
    wc = J_RANK(want, R=R, E=2, P=P, max_cands=16)
    gc = tss.rank_hits(got, R=R, E=2, P=P, max_cands=16)
    for e in range(2):
        for name in ("txp", "is_fw", "score", "min_diag", "valid"):
            assert_eq(gc[e][name], wc[e][name], f"end {e} {name}")


@pytest.fixture(scope="module")
def setup():
    fasta = os.path.join(DATA, "transcripts.fasta")
    jidx, tidx = jb.build_index(fasta, k=31), tb.build_index(fasta, k=31)
    return (jpipe.device_index_arrays(jidx),
            jpipe.MapperConfig.from_index(jidx, sparse_seed=True),
            tpipe.device_index_tensors(tidx, device="cpu"),
            tpipe.MapperConfig.from_index(tidx, sparse_seed=True))


def _compare_outputs(got: dict, want: dict, untied: np.ndarray):
    # the port's marks for its wide pass ride beside the JAX package's keys
    assert set(got) == set(want) | set(tpipe.MARK_KEYS)
    for key in sorted(want):
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape, key
        if key in ttp.BEST_KEYS:
            np.testing.assert_array_equal(g[untied].astype(w.dtype),
                                          w[untied], err_msg=key)
        elif key == "fld_hist" and "best_flen" in want:
            np.testing.assert_array_equal(g, ttp.own_fld_hist(got))
            np.testing.assert_array_equal(w, ttp.own_fld_hist(want))
        elif key in ttp.FLOAT_KEYS:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w,
                                          err_msg=key)


@pytest.mark.parametrize("lib,batch_i", [("IU", 0), ("A", 1)])
def test_map_paired_batch_sparse_matches_jax(setup, lib, batch_i):
    jdev, jcfg, tdev, tcfg = setup
    assert tcfg.sparse_seed and jcfg.sparse_seed
    chunks = iter_paired_chunks([READS[1]], [READS[3]], 1024, 256)
    chunk = [next(chunks) for _ in range(batch_i + 1)][-1]
    logpmf, logcmf = ttp._fld(2)
    if lib == "A":
        cp, co = np.ones(6, bool), np.ones((2, 2), bool)
    else:
        fmt = jlf.parse_library_format(lib)
        cp, co = jlf.paired_compat_table(fmt), jlf.orphan_compat_table(fmt)
    arrays = {"codes_l": chunk.left.codes, "lengths_l": chunk.left.lengths,
              "codes_r": chunk.right.codes,
              "lengths_r": chunk.right.lengths}
    want = jpipe.map_paired_batch(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jdev, jcfg,
        {"logpmf": jnp.asarray(logpmf), "logcmf": jnp.asarray(logcmf),
         "mode": jnp.int32(2)}, jnp.asarray(cp), jnp.asarray(co))
    tbatch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    got = tpipe.map_paired_batch(
        tbatch, tdev, tcfg, {"logpmf": torch.from_numpy(logpmf),
                             "logcmf": torch.from_numpy(logcmf), "mode": 2},
        torch.from_numpy(cp), torch.from_numpy(co))
    assert int(want["num_mapped"]) > 0.9 * int(want["num_processed"])
    untied = ~ttp.tied_top_rows(tbatch, tdev, tcfg)
    assert untied.mean() > 0.5
    _compare_outputs(got, want, untied)


def test_map_single_batch_sparse_matches_jax(setup):
    jdev, jcfg, tdev, tcfg = setup
    chunk = next(iter_single_chunks([READS[1]], 1024, 256))
    logpmf, _ = ttp._fld(1)
    cs = np.ones(2, bool)
    want = jpipe.map_single_batch(
        {"codes": jnp.asarray(chunk.codes),
         "lengths": jnp.asarray(chunk.lengths)}, jdev, jcfg,
        jnp.asarray(logpmf), jnp.asarray(cs))
    got = tpipe.map_single_batch(
        {"codes": torch.from_numpy(chunk.codes),
         "lengths": torch.from_numpy(chunk.lengths)}, tdev, tcfg,
        torch.from_numpy(logpmf), torch.from_numpy(cs))
    assert int(want["num_mapped"]) > 0.9 * int(want["num_processed"])
    _compare_outputs(got, want, np.ones(1024, bool))


def test_sparse_switch_reads_the_environment(monkeypatch):
    """SALMON_TPU_SPARSE_SEED overrides opts.sparse_seed both ways, as
    in the JAX package; unset, the option decides."""
    from salmon_tpu_torch.constants import SalmonDefaults
    idx = tb.build_index(os.path.join(DATA, "transcripts.fasta"), k=31)
    on = SalmonDefaults()
    on.sparse_seed = True
    for env, opts, want in (("1", None, True), ("0", on, False),
                            (None, on, True), (None, None, False)):
        if env is None:
            monkeypatch.delenv("SALMON_TPU_SPARSE_SEED", raising=False)
        else:
            monkeypatch.setenv("SALMON_TPU_SPARSE_SEED", env)
        kw = {} if opts is None else {"opts": opts}
        assert tpipe.MapperConfig.from_index(idx, **kw).sparse_seed is want


def _expand_inputs(seed: int):
    """tests/test_seed_sparse.py::test_row_pool_expand_parity's inputs."""
    rng = np.random.default_rng(seed)
    R, P, n_oct = 64, 12, 4096
    occ = rng.integers(0, 2**20, (n_oct, 16), dtype=np.int64).astype(
        np.int32)
    start = (rng.integers(0, n_oct - 2, (R, P), dtype=np.int64) * 8
             + rng.integers(0, 8, (R, P))).astype(np.int32)
    count = np.minimum(1 + rng.geometric(0.6, (R, P)), 8).astype(np.int32)
    found = rng.random((R, P)) < 0.9
    inl = (rng.random((R, P)) < 0.7) & found
    itxp = rng.integers(0, 1000, (R, P), dtype=np.int64).astype(np.int32)
    ipf = rng.integers(0, 2**18, (R, P), dtype=np.int64).astype(np.int32)
    hi = rng.integers(0, 2**32, (R, P), dtype=np.int64)
    lo = rng.integers(0, 2**32, (R, P), dtype=np.int64)
    fw = rng.random((R, P)) < 0.5
    valid = np.ones((R, P), bool)
    jk = {"hi": jnp.asarray(hi.astype(np.uint32)),
          "lo": jnp.asarray(lo.astype(np.uint32)),
          "valid": jnp.asarray(valid), "is_fw": jnp.asarray(fw)}
    tk = {"hi": torch.from_numpy(hi), "lo": torch.from_numpy(lo),
          "valid": torch.from_numpy(valid), "is_fw": torch.from_numpy(fw)}
    lk = (start, count, found, inl, itxp, ipf)
    return (jk, tuple(jnp.asarray(a) for a in lk), jnp.asarray(occ), tk,
            tuple(torch.from_numpy(a) for a in lk), torch.from_numpy(occ), P)


POOLS = [("row_pool=P", dict(row_pool=12)), ("row_pool=2", dict(row_pool=2)),
         ("inline_pool", dict(inline_pool=True)),
         ("inline_pool+row_pool", dict(inline_pool=True, row_pool=2))]


@pytest.mark.parametrize("name,pool", POOLS, ids=[p[0] for p in POOLS])
def test_expand_occurrences_pools_exact(name, pool):
    jk, jl, jocc, tk, tl, tocc, P = _expand_inputs(5)
    for tail_frac in (64, 8):
        want = jax.jit(jsc.expand_occurrences,
                       static_argnums=(3, 4, 5, 6, 7, 8))(
            jk, jl, jocc, 8, 1000, 6, tail_frac,
            pool.get("inline_pool", False), pool.get("row_pool", 0))
        got = tsc.expand_occurrences(tk, tl, tocc, 8, 1000, stride=6,
                                     tail_frac=tail_frac, **pool)
        valid = np_(want[3])
        assert_eq(got[3], valid, "valid")
        for nm, g, w in zip(("key", "rpos", "diag"), got[:3], want[:3]):
            np.testing.assert_array_equal(
                np.where(valid, np_(g).astype(np.int64), 0),
                np.where(valid, np_(w).astype(np.int64), 0), err_msg=nm)
        assert_eq(got[4], want[4], "n_tail_over")
        if name == "row_pool=2":
            assert int(np_(want[4])) > 0          # the budget binds
        if name == "row_pool=P":                  # the unpooled gather's
            base = tsc.expand_occurrences(tk, tl, tocc, 8, 1000, stride=6,
                                          tail_frac=tail_frac)
            for a, b in zip(base, got):
                assert torch.equal(a, b)


@pytest.fixture(scope="module")
def jax_index(tmp_path_factory):
    idx = str(tmp_path_factory.mktemp("jax_idx") / "idx")
    jb.save_index(jb.build_index(os.path.join(DATA, "transcripts.fasta"),
                                 k=31), idx)
    return idx


@pytest.mark.parametrize("env", [{"SALMON_TPU_SPARSE_SEED": "1"},
                                 {"SALMON_TPU_ROWPOOL": "64"}],
                         ids=["sparse", "rowpool-64"])
def test_cli_seed_modes_match_jax_cli(jax_index, tmp_path, monkeypatch,
                                      env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    outs = {}
    for name, main, kw in (("port", cli.main, {"device": "cpu"}),
                           ("jax", jcli.main, {})):
        outs[name] = str(tmp_path / name)
        assert main(["quant", "-i", jax_index, "-l", "IU", *READS, "-q",
                     "--no-version-check", "-o", outs[name]], **kw) == 0
    from test_torch_quant import assert_quant_sf_close
    metas, sfs = [], []
    for out in outs.values():
        with open(os.path.join(out, "quant.sf")) as fh:
            sfs.append(fh.readlines())
        with open(os.path.join(out, "aux_info", "meta_info.json")) as fh:
            metas.append(json.load(fh))
    assert_quant_sf_close(*sfs)
    for key in ("num_processed", "num_mapped", "num_decoy_fragments",
                "num_fragments_filtered_vm", "percent_mapped"):
        assert metas[0][key] == metas[1][key], key
