"""The port's accuracy gates on simulated truth, the counterparts of
tests/test_accuracy_gate.py's: perf work on the port cannot land if these
drift.

1. The mixed simulation (the JAX gate's own `mixed_sim` fixture: seed
   123, 30,000 pairs of unique transcripts and two-isoform families):
   mapping rate >= 0.999, TPM and counts Spearman >= 0.999 against the
   truth, isoform-family median relative error <= 0.05.
2. The paralog gate on the port's sim_paralog_gate (families of 10-50
   near-identical members and tandem repeats): mapping >= 0.995,
   Spearman(all) >= 0.69, family 0's member Spearman >= 0.9, family
   total error <= 0.01, repeat error <= 0.15.

Both run the port on the CPU at full size and are marked slow, as their
JAX counterparts are; chip_smoke.py's sims phase runs both on the card.
Tier-1 holds chip_smoke.mixed_sim, the card's copy of the fixture, byte
for byte to it.
"""

import numpy as np
import pytest
import torch
from test_accuracy_gate import N_PAIRS, mixed_sim  # noqa: F401 (fixture)

import chip_smoke
from salmon_tpu_torch.index.builder import build_index
from salmon_tpu_torch.quant import quantify
from salmon_tpu_torch.scripts import sim_paralog_gate

torch.set_num_threads(2)


def test_mixed_sim_copy_matches_the_gate_fixture(mixed_sim, tmp_path):
    """chip_smoke.mixed_sim writes the fixture's files byte for byte,
    with its truth and names."""
    sim = chip_smoke.mixed_sim(str(tmp_path))
    assert chip_smoke.MIXED_PAIRS == N_PAIRS
    for k in ("fa", "r1", "r2"):
        with open(sim[k], "rb") as fa, open(mixed_sim[k], "rb") as fb:
            assert fa.read() == fb.read(), k
    np.testing.assert_array_equal(sim["truth"], mixed_sim["truth"])
    assert sim["names"] == mixed_sim["names"]
    assert sim["truth"].sum() == N_PAIRS


@pytest.mark.slow
def test_tpm_spearman_and_mapping_rate_gate(mixed_sim):
    idx = build_index(mixed_sim["fa"], k=31)
    r = quantify(idx, "IU", [mixed_sim["r1"]], [mixed_sim["r2"]],
                 progress=False, device="cpu")
    m = chip_smoke.mixed_metrics(mixed_sim, r)
    assert m["mapping_rate"] >= 0.999, m
    # BASELINE's own acceptance bar (TPM Spearman >= 0.999 vs truth)
    assert m["tpm_spearman"] >= 0.999, m
    assert m["counts_spearman"] >= 0.999, m
    # isoform families: the EM must recover the within-family split
    assert m["family_median_relerr"] <= 0.05, m


@pytest.mark.slow
def test_paralog_gate(tmp_path):
    sim = sim_paralog_gate.build_sim(str(tmp_path))
    m, _ = sim_paralog_gate.run_setting(build_index(sim["fa"], k=31), sim,
                                        8, 16, "cpu")
    assert m["mapping_rate"] >= 0.995, m
    assert m["spearman_all"] >= 0.69, m
    assert m["fam_member_spearman"][0] >= 0.9, m
    assert m["fam_total_relerr_max"] <= 0.01, m
    assert m["rep_relerr_max"] <= 0.15, m
