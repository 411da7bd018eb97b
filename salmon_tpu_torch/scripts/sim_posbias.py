"""Positional-bias correction on simulated truth: simulate a 5'-biased
library over a synthetic transcriptome and compare TPM error with and
without --posBias and --posBiasCorrected.

Counterpart of scripts/sim_posbias.py: the same generator, byte-equal
files from the same seed, quantified by the port's CLI. Generative
model: fragment start positions p on transcript i are drawn with weight
b(p / L_i) = exp(-RATE * rel); reads per transcript c_i ~ eta_i * s_i,
where s_i = sum_p b(p / L_i) over valid starts, so the molar truth is
eta_i. With POSBIAS_FACTORIZED=1 the weight is g(start/L) * h(end/L),
the model the reference's fw*rc factor product nominally assumes.

A negative gain is expected at strong RATE: the reference's
SimplePosBias algorithm does not recover this truth (its fw*rc product
double-counts the start/end preference with a length-dependent offset,
and the 5 length classes of 20 linear bins projected through
Cufflinks-knot splines are too coarse for smooth exponential biases).
The port reproduces the reference formula as the JAX package does, so
this measures the algorithm, not the implementation
(scripts/posbias_reference_trace.py traces it).

Usage: [POSBIAS_RATE=1.5] [POSBIAS_FACTORIZED=0] [POSBIAS_RATE_END=0.75]
       [POSBIAS_TXPS=24] [POSBIAS_FRAGS=20000]
  python -m salmon_tpu_torch.scripts.sim_posbias
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from salmon_tpu_torch.scripts import require_device
from salmon_tpu_torch.scripts.sim_seqbias import (FLEN_MU, FLEN_SD,
                                                  READ_LEN, gain,
                                                  quant_errors, write_pair)

FLAG_SETS = ([], ["--posBias"], ["--posBiasCorrected"])


def _start_weights(L, max_start):
    """Unnormalized start-position weights for one transcript."""
    rate = float(os.environ.get("POSBIAS_RATE", 1.5))
    rel = np.arange(max_start) / L
    g = np.exp(-rate * rel)
    if os.environ.get("POSBIAS_FACTORIZED", "0") == "1":
        rate_end = float(os.environ.get("POSBIAS_RATE_END", 0.75))
        rel_e = (np.arange(max_start) + FLEN_MU) / L
        g = g * np.exp(rate_end * np.minimum(rel_e, 1.0))
    return g


def make_sim(out_dir, n_txps=24, n_frags=20000, seed=11):
    """Write transcripts.fasta and reads_{1,2}.fastq; (names, tpm_true,
    fragments a transcript)."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    lens = np.linspace(600, 6000, n_txps).astype(int)
    rng.shuffle(lens)
    names = [f"SIM{i:03d}" for i in range(n_txps)]
    seqs = ["".join(rng.choice(bases, L)) for L in lens]

    # molar abundances and positional-bias usable mass
    eta = rng.lognormal(0.0, 1.0, n_txps)
    s = np.zeros(n_txps)
    for i, L in enumerate(lens):
        s[i] = _start_weights(L, max(L - FLEN_MU, 1)).sum()
    w = eta * s
    c = rng.multinomial(n_frags, w / w.sum())
    tpm_true = eta / eta.sum() * 1e6

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "transcripts.fasta"), "w") as fh:
        for nm, sq in zip(names, seqs):
            fh.write(f">{nm}\n{sq}\n")

    with open(os.path.join(out_dir, "reads_1.fastq"), "w") as f1, \
            open(os.path.join(out_dir, "reads_2.fastq"), "w") as f2:
        rn = 0
        for i in range(n_txps):
            L = lens[i]
            if not c[i]:
                continue
            flens = np.clip(rng.normal(FLEN_MU, FLEN_SD, c[i]).astype(int),
                            2 * READ_LEN, None)
            max_start = np.maximum(L - flens, 1)
            pw_full = _start_weights(L, int(max_start.max()))
            for j in range(c[i]):
                ms = int(max_start[j])
                pw = pw_full[:ms]
                pos = int(rng.choice(ms, p=pw / pw.sum()))
                fl = int(min(flens[j], L - pos))
                write_pair(f1, f2, f"{rn}:{names[i]}:{pos}:{fl}", seqs[i],
                           pos, fl)
                rn += 1
    return names, tpm_true, c


def errors(sim_dir: str, n_txps: int, n_frags: int, device) -> list:
    """Simulate into sim_dir and quantify plain, with --posBias and with
    --posBiasCorrected; the three mean |log TPM err|."""
    names, tpm_true, c = make_sim(sim_dir, n_txps, n_frags)
    print(f"# sim at {sim_dir}: {int(c.sum())} fragments", file=sys.stderr)
    return quant_errors(sim_dir, names, tpm_true, FLAG_SETS, device)


def main(argv=None, device="cuda") -> int:
    device = require_device(device, "sim_posbias")
    e0, e1, e2 = errors(
        tempfile.mkdtemp(prefix="salmon_tpu_torch_posbias_"),
        int(os.environ.get("POSBIAS_TXPS", 24)),
        int(os.environ.get("POSBIAS_FRAGS", 20000)), device)
    print(f"mean |log TPM err|: uncorrected {e0:.4f}  --posBias {e1:.4f} "
          f"(gain {gain(e0, e1):.1f}%)  "
          f"--posBiasCorrected {e2:.4f} "
          f"(gain {gain(e0, e2):.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
