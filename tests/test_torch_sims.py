"""The truth simulations: the port's salmon_tpu_torch.scripts.sim_* against
the JAX package's scripts/sim_*.py, run through runpy as they are, at a
reduced size on the CPU.

- Data: each generator writes files byte-equal to the JAX script's from
  the same seed (sequence bias at SEQBIAS_TXPS=8 SEQBIAS_FRAGS=4000 and
  the like; the paralog simulation at N_PAIRS = 3,000).
- Results: the mean |log TPM err| of each quant within 5 % relative or
  0.003 absolute of the JAX script's (TPM_RTOL, TPM_ATOL); the paralog
  metrics at the defaults within 0.01 on the Spearmans and exact on the
  mapping rate against the JAX package with its sorts made stable, and
  against it as it is exact on the mapping rate but for fragments whose
  seed candidates hold a tie (ROADMAP queue 3), which the test finds and
  counts; the rescue recall at sigma 80 with 1 and 3 probes within
  2 of 48.
"""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from salmon_tpu.constants import SalmonDefaults
from salmon_tpu_torch.scripts import (sim_gcbias, sim_paralog_gate,
                                      sim_posbias, sim_rescue_recall,
                                      sim_seqbias)

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TPM_RTOL, TPM_ATOL = 0.05, 0.003
RHO_ATOL = 0.01
RECALL_SLACK = 2          # of 48 candidates: queue 3's orphan tie
SMALL_TXPS, SMALL_FRAGS = 8, 4000
PARALOG_PAIRS = 3000


def _jax_script(name):
    return runpy.run_path(os.path.join(REPO, "scripts", f"{name}.py"),
                          run_name="not_main")


def _same_files(a, b, names):
    for nm in names:
        with open(os.path.join(a, nm), "rb") as fa, \
                open(os.path.join(b, nm), "rb") as fb:
            ja, pb = fa.read(), fb.read()
        assert len(ja) > 0
        assert ja == pb, nm


def _close(got, want):
    return abs(got - want) <= max(TPM_RTOL * abs(want), TPM_ATOL)


# ---------------------------------------------------------------------------
# sequence, GC and positional bias
# ---------------------------------------------------------------------------

BIAS_SIMS = {
    # name: (port module, flag sets of its quants)
    "sim_seqbias": (sim_seqbias, ([], ["--seqBias"])),
    "sim_gcbias": (sim_gcbias, ([], ["--gcBias"])),
    "sim_posbias": (sim_posbias, sim_posbias.FLAG_SETS),
}


def _jax_quant(ns_seq, ns, name, sim_dir, i, flags):
    """The JAX script's own run_quant for quant i with `flags`:
    sim_gcbias uses sim_seqbias's, sim_posbias its own (a plain run, then
    --posBias, then --posBiasCorrected)."""
    out = os.path.join(sim_dir, f"q{i}")
    if name == "sim_posbias":
        return ns["run_quant"](sim_dir, out, bool(flags),
                               corrected=flags == ["--posBiasCorrected"])
    return ns_seq["run_quant"](sim_dir, out, flags)


@pytest.fixture(scope="module", params=sorted(BIAS_SIMS))
def bias_sim(request, tmp_path_factory):
    """One bias simulation at SMALL_TXPS / SMALL_FRAGS, made and quantified
    by the JAX script and by the port (on the CPU): (name, the two
    directories, the JAX errors, the port's errors)."""
    name = request.param
    mod, flag_sets = BIAS_SIMS[name]
    base = tmp_path_factory.mktemp(name)
    ns_seq = _jax_script("sim_seqbias")
    ns = ns_seq if name == "sim_seqbias" else _jax_script(name)
    jdir, pdir = str(base / "jax"), str(base / "port")
    made = ns["make_sim"](jdir, SMALL_TXPS, SMALL_FRAGS)
    names, tpm_true = made[0], made[1]
    jax_err = [ns_seq["tpm_error"](names, tpm_true,
                                   _jax_quant(ns_seq, ns, name, jdir, i, f))
               for i, f in enumerate(flag_sets)]
    made = mod.make_sim(pdir, SMALL_TXPS, SMALL_FRAGS)
    assert made[0] == names
    np.testing.assert_array_equal(made[1], tpm_true)
    port_err = sim_seqbias.quant_errors(pdir, names, tpm_true, flag_sets,
                                        "cpu")
    return name, jdir, pdir, jax_err, port_err


def test_bias_sim_data_byte_equal(bias_sim):
    _, jdir, pdir, _, _ = bias_sim
    _same_files(jdir, pdir, ("transcripts.fasta", "reads_1.fastq",
                             "reads_2.fastq"))


def test_bias_sim_errors_match_jax(bias_sim):
    """Each quant's mean |log TPM err| (plain, then corrected) within 5 %
    or 0.003 of the JAX script's on the same files."""
    name, _, _, jax_err, port_err = bias_sim
    assert len(port_err) == len(jax_err)
    for got, want in zip(port_err, jax_err):
        assert np.isfinite(got)
        assert _close(got, want), (name, port_err, jax_err)


@pytest.mark.parametrize("name", sorted(BIAS_SIMS))
def test_bias_sim_main_prints_the_jax_line(name, monkeypatch, capsys,
                                           tmp_path):
    """main's printed line has the JAX script's words and flags, read from
    the same environment variables (here a size the JAX run need not
    repeat: the errors are held to it above)."""
    prefix = name.split("_")[1][:-4].upper() + "BIAS"
    monkeypatch.setenv(f"{prefix}_TXPS", "4")
    monkeypatch.setenv(f"{prefix}_FRAGS", "1000")
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    mod = BIAS_SIMS[name][0]
    assert mod.main([], device="cpu") == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("mean |log TPM err|: uncorrected ")
    for flags in BIAS_SIMS[name][1][1:]:
        assert f"  {flags[0]} " in line, line
    assert line.count("(gain ") == len(BIAS_SIMS[name][1]) - 1


# ---------------------------------------------------------------------------
# paralog gate
# ---------------------------------------------------------------------------

def _batch(r1, r2):
    """The simulation's pairs as one batch of numpy arrays."""
    from salmon_tpu_torch.io.fastq import iter_paired_chunks
    ch = next(iter(iter_paired_chunks([r1], [r2], 4096, 100)))
    return {"codes_l": ch.left.codes, "lengths_l": ch.left.lengths,
            "codes_r": ch.right.codes, "lengths_r": ch.right.lengths}


def _batch_mapping(jidx, idx, batch):
    """Both packages' map_paired_batch on one batch, with the default FLD
    (mode 1): whether each row maps in each, and per row whether the
    seed candidates of an end hold a tie (the same scores and validity
    slot by slot, other members: the top-T ranking's unstable sort,
    ROADMAP queue 3) or differ otherwise."""
    import jax.numpy as jnp

    from salmon_tpu.mapping import pipeline as jp
    from salmon_tpu.utils import libformat as jlf
    from salmon_tpu_torch.mapping import pipeline as tp
    from salmon_tpu_torch.models.fld import FragmentLengthDistribution
    from salmon_tpu_torch.utils import libformat

    jcfg, cfg = jp.MapperConfig.from_index(jidx), \
        tp.MapperConfig.from_index(idx)
    jdev, dev = jp.device_index_arrays(jidx), \
        tp.device_index_tensors(idx, "cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch.items()}
    ends = ("codes_l", "lengths_l"), ("codes_r", "lengths_r")
    jc = jp._seed_candidates([jb[c] for c, _ in ends],
                             [jb[n] for _, n in ends], jdev, jcfg)
    tc = tp._seed_candidates([tb[c] for c, _ in ends],
                             [tb[n] for _, n in ends], dev, cfg)
    rows = batch["lengths_l"].shape[0]
    tied, other = np.zeros(rows, bool), np.zeros(rows, bool)
    for (jca, _), (tca, _) in zip(jc, tc):
        valid = tca["valid"].numpy()
        same = (np.all(np.asarray(jca["score"]) == tca["score"].numpy(), 1)
                & np.all(np.asarray(jca["valid"]) == valid, 1))
        members = np.zeros(rows, bool)
        for k in ("txp", "min_diag", "is_fw"):
            members |= np.any((np.asarray(jca[k]) != tca[k].numpy())
                              & valid, 1)
        tied |= members & same
        other |= ~same
    logpmf = FragmentLengthDistribution().log_pmf().astype(np.float32)
    jfmt, fmt = jlf.parse_library_format("IU"), \
        libformat.parse_library_format("IU")
    jo = jp.map_paired_batch(jb, jdev, jcfg, jnp.asarray(logpmf),
                             jnp.asarray(jlf.paired_compat_table(jfmt)),
                             jnp.asarray(jlf.orphan_compat_table(jfmt)))
    to = tp.map_paired_batch(
        tb, dev, cfg, torch.from_numpy(logpmf),
        torch.as_tensor(libformat.paired_compat_table(fmt)),
        torch.as_tensor(libformat.orphan_compat_table(fmt)))
    invalid = 2**31 - 1
    return {"jax_mapped": np.any(np.asarray(jo["eq_txp"]) != invalid, 1),
            "mapped": np.any(to["eq_txp"].numpy() != invalid, 1),
            "tied": tied, "other": other,
            "jax_txp": np.asarray(jo["eq_txp"]),
            "txp": to["eq_txp"].numpy(),
            "marked": to["frag_marked"].numpy(),
            "port": (tb, dev, cfg, torch.from_numpy(logpmf),
                     torch.as_tensor(libformat.paired_compat_table(fmt)),
                     torch.as_tensor(libformat.orphan_compat_table(fmt)),
                     to)}


@pytest.fixture(scope="module")
def paralog(tmp_path_factory):
    """The paralog simulation at PARALOG_PAIRS pairs from both generators,
    quantified at the defaults by the port on the CPU and by the JAX
    package twice: as it is, and with jax.lax.sort made stable (the
    port's order among equal keys); and mapped as one batch by both."""
    import jax

    sys.path.insert(0, REPO)
    from scripts import sim_paralog_gate as jsim

    from salmon_tpu.index.builder import build_index as jbuild
    from salmon_tpu.quant import quantify as jquantify
    from salmon_tpu_torch.index.builder import build_index

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jsim, "N_PAIRS", PARALOG_PAIRS)
        mp.setattr(sim_paralog_gate, "N_PAIRS", PARALOG_PAIRS)
        jdir = tmp_path_factory.mktemp("paralog_jax")
        pdir = tmp_path_factory.mktemp("paralog_port")
        jax_sim = jsim.build_sim(str(jdir))
        sim = sim_paralog_gate.build_sim(str(pdir))
    finally:
        mp.undo()
    jidx, idx = jbuild(jax_sim["fa"], k=31), build_index(sim["fa"], k=31)

    def jax_quant():
        return jquantify(jidx, "IU", [jax_sim["r1"]], [jax_sim["r2"]],
                         opts=SalmonDefaults(), progress=False)

    jres = jax_quant()
    sort = jax.lax.sort

    def stable_sort(*args, **kw):
        return sort(*args, **{**kw, "is_stable": True})

    batch = _batch(sim["r1"], sim["r2"])
    mp = pytest.MonkeyPatch()
    try:
        jax.clear_caches()      # no program traced with the unstable sort
        mp.setattr(jax.lax, "sort", stable_sort)
        jres_stable = jax_quant()
        batch_stable = _batch_mapping(jidx, idx, batch)
    finally:
        mp.undo()
        jax.clear_caches()
    from salmon_tpu_torch.inference import em as em_mod
    optimize, ems = em_mod.optimize, []

    def tapped_optimize(eq, num_txps, eff_lens, **kw):
        out = optimize(eq, num_txps, eff_lens, **kw)
        ems.append({"eq": eq, "eff_lens": np.array(eff_lens, np.float64),
                    "kw": kw, "iterations": int(out["iterations"])})
        return out

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(em_mod, "optimize", tapped_optimize)
        m, res = sim_paralog_gate.run_setting(idx, sim, 8, 16, "cpu")
    finally:
        mp.undo()
    return {"jdir": str(jdir), "pdir": str(pdir), "jax_sim": jax_sim,
            "sim": sim, "port": m, "res": res, "jres": jres,
            "jax_stable": jsim.metrics(jax_sim, jres_stable),
            "jres_stable": jres_stable,
            "batch": _batch_mapping(jidx, idx, batch),
            "batch_stable": batch_stable, "idx": idx, "ems": ems}


def test_paralog_sim_byte_equal(paralog):
    _same_files(paralog["jdir"], paralog["pdir"], ("t.fa", "r1.fq",
                                                   "r2.fq"))
    js, ps = paralog["jax_sim"], paralog["sim"]
    assert js["names"] == ps["names"]
    np.testing.assert_array_equal(js["truth"], ps["truth"])
    np.testing.assert_array_equal(js["fam_of"], ps["fam_of"])
    assert ps["truth"].sum() == PARALOG_PAIRS


def test_paralog_mapping_differs_only_on_ties(paralog):
    """Against the JAX package as it is: the seed candidates of both hold
    the same scores slot by slot on every row; a fragment that no cap
    cut (not marked) and that maps in one package and not in the other
    holds a tie among its candidates (the JAX package's unstable sorts,
    ROADMAP queue 3; 3 of 3,000 here, each a tandem-repeat fragment),
    and the quant's mapped counts differ by no more than the number of
    fragments that map in one package only."""
    b = paralog["batch"]
    assert not b["other"].any()
    flips = b["mapped"] != b["jax_mapped"]
    # a fragment that a cap cut (marked) maps where the port completes its
    # label; every other flip is a tie's
    same = flips & ~b["marked"]
    assert (same <= b["tied"]).all(), np.nonzero(same & ~b["tied"])
    assert same.sum() <= 5, np.nonzero(same)
    assert abs(paralog["res"].num_mapped - paralog["jres"].num_mapped) \
        <= flips.sum()
    assert paralog["res"].num_processed == paralog["jres"].num_processed \
        == PARALOG_PAIRS


def _fasta_txome(path: str):
    """(names, Txome) of a FASTA of the simulation."""
    from qbench.lib.txome import Txome
    names, seqs = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith(">"):
                names.append(line[1:].strip())
                seqs.append([])
            else:
                seqs[-1].append(line.strip())
    codes = [np.frombuffer("".join(q).encode(), np.uint8) for q in seqs]
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    lens = [c.shape[0] for c in codes]
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return names, Txome(lut[np.concatenate(codes)], offsets)


def test_paralog_metrics_match_jax(paralog):
    """At the defaults (occ_cap 8, weight_width 16), against the JAX
    package with its sorts stable (this simulation is made of ties: 54 %
    of its fragments hold one among their seed candidates, and the
    weight_width cut falls inside families of up to 50 equal members):
    the mapped fragments equal; the batch step's labels equal the JAX
    package's on every fragment the port did not mark for its wide pass;
    the marked fragments' completed labels (256 of them) equal the plain
    reference's (qbench/reference) but on at most 3 %, members that the
    consensus slack drops and the reference keeps; the quant's counts
    equal the plain reference's float64 VBEM on the port's classes within
    rtol 5e-3 / atol 0.5; and, since the wide pass completes the labels
    that weight_width cut inside the families, the port's Spearmans,
    family and repeat errors hold near its own readings against the
    truth and are no worse than the JAX package's by more than 0.01
    (ROADMAP queue 3 gives both sides' numbers)."""
    from qbench.reference.mapping import reference_labels
    from salmon_tpu_torch.mapping.pipeline import WidePass
    from salmon_tpu_torch.mapping.pipeline import mark_stats as tpipe_marks

    j, p = paralog["jax_stable"], paralog["port"]
    assert paralog["res"].num_mapped == paralog["jres_stable"].num_mapped
    assert p["mapping_rate"] == j["mapping_rate"]
    b = paralog["batch_stable"]
    unmarked = ~b["marked"]
    assert unmarked.sum() > 0.3 * PARALOG_PAIRS
    np.testing.assert_array_equal(b["txp"][unmarked],
                                  b["jax_txp"][unmarked])

    tb, dev, cfg, fld, cp, co, out = b["port"]
    wide = WidePass(paralog["idx"], cfg, paired=True)
    done = wide.complete(
        b["txp"], out["eq_weight"].numpy(), out["eq_bins"].numpy(),
        out["frag_ok"].numpy(),
        wide.run(tb, out, dev, fld, (cp, co),
                 tpipe_marks(out["mark_counts"])["frags_wide"]))
    names, tx = _fasta_txome(paralog["sim"]["fa"])
    ref_of = np.array([names.index(n) for n in paralog["idx"].names])
    rows = np.nonzero(b["marked"])[0][:256]
    n = tb["lengths_l"].numpy()[rows]
    assert (n == n[0]).all()
    want, _, _ = reference_labels(tb["codes_l"].numpy()[rows, :n[0]],
                                  tb["codes_r"].numpy()[rows, :n[0]], tx,
                                  {"k": 31, "match": 2, "mismatch": -4,
                                   "gap_open": 6, "gap_extend": 2,
                                   "band": 15, "fld_max": 1000,
                                   "min_score_fraction": 0.65,
                                   "min_aln_prob": 1e-5, "score_exp": 1.0})
    got = [tuple(sorted(ref_of[r[r != 2**31 - 1]].tolist()))
           for r in done["eq"][0][rows]]
    # the reference keeps what salmon's consensus slack drops: a member
    # whose chain covers less than 65 % of the best's (5 of these 256)
    assert sum(g != w for g, w in zip(got, want)) <= 0.03 * rows.size

    # the quant's counts against the plain reference's float64 VBEM on the
    # port's completed classes, with the port's effective lengths and
    # online estimate, for the same iterations
    from qbench.reference import em as ref_em
    with open(os.path.join(REPO, "qbench", "configs",
                           "paralog-vbem.json")) as fh:
        params = json.load(fh)["reference"]
    (run,) = paralog["ems"]
    eq, kw = run["eq"], run["kw"]
    ref = ref_em.vbem(eq.labels, eq.offsets, eq.counts, eq.weights,
                      run["eff_lens"], kw["online_mass"], kw["total_mapped"],
                      max(run["iterations"], params["min_iterations"]),
                      params)
    np.testing.assert_allclose(paralog["res"].counts, ref, rtol=5e-3,
                               atol=0.5)

    # against the truth, near the port's own readings (spearman_all
    # 0.9946, family members 0.9725-0.9983, errors 2e-08 and 0), and no
    # worse than the JAX package's
    assert p["spearman_all"] >= 0.98, (p, j)
    assert p["spearman_all"] >= j["spearman_all"] - RHO_ATOL, (p, j)
    assert len(p["fam_member_spearman"]) == len(j["fam_member_spearman"])
    for got_rho, want_rho in zip(p["fam_member_spearman"],
                                 j["fam_member_spearman"]):
        assert got_rho >= 0.96, (p, j)
        assert got_rho >= want_rho - RHO_ATOL, (p, j)
    for k in ("fam_total_relerr_max", "rep_relerr_max"):
        assert p[k] <= 1e-6, (k, p, j)
        assert p[k] <= j[k] + RHO_ATOL, (k, p, j)


def test_paralog_main_prints_the_jax_lines(paralog, monkeypatch, capsys):
    """main with occ_cap=/weight_width= pairs prints the JAX script's
    lines: the simulation's header, then one setting's metrics."""
    monkeypatch.setattr(sim_paralog_gate, "N_PAIRS", 500)
    assert sim_paralog_gate.main(["occ_cap=4", "weight_width=8"],
                                 device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == ("# sim: 302 txps (148 paralog members in 6 "
                        "families), 500 pairs")
    assert lines[1].startswith("occ_cap=  4 W=  8: rate=")
    for key in ("rho_all=", "fam_rho_min=", "fam_tot_err=", "rep_err="):
        assert key in lines[1]
    assert lines[2].startswith("   fam_rhos=[")


# ---------------------------------------------------------------------------
# rescue recall
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("probes", [1, 3])
def test_rescue_recall_matches_jax(probes):
    """At sigma 80 (the band-80 DP's recall), the port's rescued count
    within 2 of 48 of the JAX script's run()."""
    from salmon_tpu_torch.mapping.pipeline import device_index_tensors
    ns = _jax_script("sim_rescue_recall")
    want, n = ns["run"](80.0, probes)
    idx = sim_rescue_recall.sample_index()
    got, n_port = sim_rescue_recall.run(idx, device_index_tensors(idx, "cpu"),
                                        80.0, probes, "cpu")
    assert n == n_port == 48
    assert abs(got - want) <= RECALL_SLACK, (got, want)
    assert got > 0


def test_rescue_pairs_destroy_every_seed():
    """Every right mate of the simulation has no k=31 window of its
    transcript, and every left mate is the transcript's own sequence."""
    from salmon_tpu_torch.utils.dna import encode_seq, revcomp_codes
    idx = sim_rescue_recall.sample_index()
    s1, s2, fls = sim_rescue_recall.make_pairs(idx, 80.0, 48, 0)
    assert len(s1) == len(s2) == len(fls) == 48
    refs = [idx.transcript_codes(t).tobytes()
            for t in range(idx.num_valid_targets)]
    for a, b in zip(s1, s2):
        left = encode_seq(a).tobytes()
        assert any(left in r for r in refs)
        right = revcomp_codes(encode_seq(b))
        for w in range(0, len(right) - 31 + 1):
            assert not any(right[w:w + 31].tobytes() in r for r in refs)
