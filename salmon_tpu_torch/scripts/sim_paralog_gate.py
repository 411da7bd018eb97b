"""Repeat-heavy, paralog-rich accuracy simulation: the occ_cap /
weight_width sweep.

Counterpart of scripts/sim_paralog_gate.py: the same simulation, byte
for byte from the same seed, quantified by the port's quant.quantify.
Paralog families of 10-50 near-identical members (k-mer occurrence
multiplicities far past occ_cap) plus transcripts with internal tandem
repeats stress the speed knobs that the easy mixed simulation does not.
Reports, per (occ_cap, weight_width) setting: mapping rate, overall
counts Spearman, the least within-family member Spearman, the largest
family-total relative error and the largest repeat error. Its defaults
are tests/test_torch_accuracy_gate.py::test_paralog_gate.

Usage: python -m salmon_tpu_torch.scripts.sim_paralog_gate
       [occ_cap=N [weight_width=W]]
(no argument: the five settings (8, 16), (4, 16), (8, 8), (16, 32),
(6, 16)).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile

import numpy as np

from salmon_tpu_torch.scripts import require_device
from salmon_tpu_torch.utils.dna import decode_seq, revcomp_codes

READ_LEN = 100
N_PAIRS = 20_000
ERR = 0.005
SUB_RATE = 0.012          # per-base divergence between family members
FAM_SIZES = (10, 12, 16, 24, 36, 50)
SWEEP = [(8, 16), (4, 16), (8, 8), (16, 32), (6, 16)]


def build_sim(tmpdir: str, rng=None):
    """Write t.fa, r1.fq and r2.fq into tmpdir; the files' paths, the
    truth counts, the names and each transcript's family (-1: none)."""
    rng = rng or np.random.default_rng(20240817)
    seqs, names, fam_of = [], [], []
    # paralog families: one ancestor, members = independent substitutions
    for fi, fs in enumerate(FAM_SIZES):
        L = int(rng.integers(1500, 2200))
        base = rng.integers(0, 4, L).astype(np.uint8)
        for mi in range(fs):
            s = base.copy()
            m = rng.random(L) < SUB_RATE
            s[m] = (s[m] + rng.integers(1, 4, m.sum())) % 4
            seqs.append(s)
            names.append(f"FAM{fi}_M{mi:02d}")
            fam_of.append(fi)
    # internal tandem repeats: unit repeated 8x between unique flanks
    for ri in range(4):
        unit = rng.integers(0, 4, 150).astype(np.uint8)
        fl5 = rng.integers(0, 4, 300).astype(np.uint8)
        fl3 = rng.integers(0, 4, 300).astype(np.uint8)
        seqs.append(np.concatenate([fl5] + [unit] * 8 + [fl3]))
        names.append(f"REP{ri}")
        fam_of.append(-1)
    # unique background
    for ui in range(150):
        seqs.append(rng.integers(
            0, 4, int(rng.integers(500, 2500))).astype(np.uint8))
        names.append(f"UNIQ{ui:03d}")
        fam_of.append(-1)

    fa = os.path.join(tmpdir, "t.fa")
    with open(fa, "w") as fh:
        for nm, s in zip(names, seqs):
            fh.write(f">{nm}\n{decode_seq(s)}\n")

    expr = rng.gamma(1.0, 1.0, len(seqs)) + 0.05
    lens = np.array([s.shape[0] for s in seqs], float)
    w = expr * np.maximum(lens - 250, 1)
    p = w / w.sum()
    truth = np.zeros(len(seqs))
    r1p = os.path.join(tmpdir, "r1.fq")
    r2p = os.path.join(tmpdir, "r2.fq")
    with open(r1p, "w") as f1, open(r2p, "w") as f2:
        for i in range(N_PAIRS):
            t = int(rng.choice(len(seqs), p=p))
            L = seqs[t].shape[0]
            fl = int(np.clip(rng.normal(250, 25), 2 * READ_LEN, L))
            fl = min(fl, L)
            s0 = int(rng.integers(0, L - fl + 1))
            truth[t] += 1
            left = seqs[t][s0:s0 + READ_LEN].copy()
            right = revcomp_codes(
                seqs[t][s0 + fl - READ_LEN:s0 + fl]).copy()
            for r in (left, right):
                m = rng.random(READ_LEN) < ERR
                r[m] = (r[m] + rng.integers(1, 4, m.sum())) % 4
            f1.write(f"@s{i}\n{decode_seq(left)}\n+\n{'I' * READ_LEN}\n")
            f2.write(f"@s{i}\n{decode_seq(right)}\n+\n"
                     f"{'I' * READ_LEN}\n")
    return {"fa": fa, "r1": r1p, "r2": r2p, "truth": truth,
            "names": names, "fam_of": np.array(fam_of)}


def metrics(sim, res):
    """The gate's metrics of a quant result against the simulation."""
    from scipy.stats import spearmanr
    est = dict(zip(res.names, res.counts))
    e = np.array([est.get(nm, 0.0) for nm in sim["names"]])
    truth, fam_of = sim["truth"], sim["fam_of"]
    out = {
        "mapping_rate": res.num_mapped / res.num_processed,
        "spearman_all": float(spearmanr(truth, e).statistic),
    }
    fam_rhos, fam_errs = [], []
    for fi in range(fam_of.max() + 1):
        m = fam_of == fi
        fam_rhos.append(float(spearmanr(truth[m], e[m]).statistic))
        te, ee = truth[m].sum(), e[m].sum()
        fam_errs.append(abs(ee - te) / max(te, 1.0))
    out["fam_member_spearman"] = fam_rhos
    out["fam_member_spearman_min"] = min(fam_rhos)
    out["fam_total_relerr_max"] = max(fam_errs)
    rep = np.array([nm.startswith("REP") for nm in sim["names"]])
    big = rep & (truth >= 20)
    out["rep_relerr_max"] = float(np.max(
        np.abs(e[big] - truth[big]) / truth[big])) if big.any() else 0.0
    return out


def run_setting(idx, sim, occ_cap: int, weight_width: int, device):
    """quantify at one (occ_cap, weight_width); (metrics, result)."""
    from salmon_tpu_torch.constants import SalmonDefaults
    from salmon_tpu_torch.quant import quantify
    o = dataclasses.replace(SalmonDefaults(), occ_cap=occ_cap,
                            weight_width=weight_width)
    res = quantify(idx, "IU", [sim["r1"]], [sim["r2"]], opts=o,
                   progress=False, device=device)
    return metrics(sim, res), res


def main(argv=None, device="cuda") -> int:
    from salmon_tpu_torch.index.builder import build_index

    argv = sys.argv[1:] if argv is None else list(argv)
    device = require_device(device, "sim_paralog_gate")
    kv = dict(a.split("=") for a in argv)
    if "occ_cap" in kv:
        settings = [(int(kv["occ_cap"]), int(kv.get("weight_width", 16)))]
    else:
        settings = SWEEP

    with tempfile.TemporaryDirectory() as d:
        sim = build_sim(d)
        n_fam = sum(FAM_SIZES)
        print(f"# sim: {len(sim['names'])} txps ({n_fam} paralog members "
              f"in {len(FAM_SIZES)} families), {N_PAIRS} pairs")
        idx = build_index(sim["fa"], k=31)
        for oc, ww in settings:
            m, _ = run_setting(idx, sim, oc, ww, device)
            print(f"occ_cap={oc:3d} W={ww:3d}: "
                  f"rate={m['mapping_rate']:.4f} "
                  f"rho_all={m['spearman_all']:.4f} "
                  f"fam_rho_min={m['fam_member_spearman_min']:.4f} "
                  f"fam_tot_err={m['fam_total_relerr_max']:.4f} "
                  f"rep_err={m['rep_relerr_max']:.4f}")
            rhos = ['%.3f' % r for r in m['fam_member_spearman']]
            print(f"   fam_rhos={rhos}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
