"""Fragment-GC bias on simulated truth: simulate PCR-like GC-dependent
fragment recovery (the bias --gcBias models, Love et al. 2016) and
compare TPM error with and without correction.

Counterpart of scripts/sim_gcbias.py: the same generator, byte-equal
files from the same seed, quantified by the port's CLI (the harness of
sim_seqbias). Generative model: candidate fragments (uniform start,
N(200, 15) length) are accepted with probability
w(gc) = exp(-((gc - 0.5) / SIGMA)^2); transcripts have different base
compositions, so the bias is confounded with the transcript (the case
GC correction exists for).

Usage: [GCBIAS_SIGMA=0.12] [GCBIAS_TXPS=48] [GCBIAS_FRAGS=60000]
  python -m salmon_tpu_torch.scripts.sim_gcbias
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from salmon_tpu_torch.scripts import require_device
from salmon_tpu_torch.scripts.sim_seqbias import (B2C, FLEN_MU, FLEN_SD,
                                                  READ_LEN, gain,
                                                  quant_errors, write_fasta,
                                                  write_pair)


def make_sim(out_dir, n_txps, n_frags, seed=11):
    """Write transcripts.fasta and reads_{1,2}.fastq; (names, tpm_true)."""
    sigma = float(os.environ.get("GCBIAS_SIGMA", 0.12))
    rng = np.random.default_rng(seed)
    lens = np.linspace(800, 6000, n_txps).astype(int)
    rng.shuffle(lens)
    names = [f"SIM{i:03d}" for i in range(n_txps)]
    # per-transcript GC composition from 30% to 70%
    gc_frac = np.linspace(0.30, 0.70, n_txps)
    rng.shuffle(gc_frac)
    codes = []
    for L, g in zip(lens, gc_frac):
        p = np.array([(1 - g) / 2, g / 2, g / 2, (1 - g) / 2])
        codes.append(rng.choice(4, size=L, p=p).astype(np.int8))

    def gc_accept(c, s, fl):
        frag = c[s:s + fl]
        gc = ((frag == 1) | (frag == 2)).mean()
        return np.exp(-(((gc - 0.5) / sigma) ** 2))

    # usable mass per transcript: MC estimate of mean acceptance
    eta = rng.lognormal(0.0, 1.0, n_txps)
    acc = np.zeros(n_txps)
    for i, c in enumerate(codes):
        n = max(lens[i] - FLEN_MU, 1)
        ss = rng.integers(0, n, 200)
        acc[i] = np.mean([gc_accept(c, s, FLEN_MU) for s in ss])
    mass = eta * acc * np.maximum(lens - FLEN_MU, 1)
    cnt = rng.multinomial(n_frags, mass / mass.sum())
    tpm_true = eta / eta.sum() * 1e6

    write_fasta(out_dir, names, codes)
    with open(os.path.join(out_dir, "reads_1.fastq"), "w") as f1, \
            open(os.path.join(out_dir, "reads_2.fastq"), "w") as f2:
        rn = 0
        for i in range(n_txps):
            c = codes[i]
            L = lens[i]
            seq = "".join(B2C[c])
            made = 0
            while made < cnt[i]:
                s = int(rng.integers(0, max(L - FLEN_MU, 1)))
                fl = int(np.clip(rng.normal(FLEN_MU, FLEN_SD),
                                 2 * READ_LEN, L - s))
                if rng.random() > gc_accept(c, s, fl):
                    continue
                write_pair(f1, f2, f"{rn}:{names[i]}:{s}:{fl}", seq, s, fl)
                rn += 1
                made += 1
    return names, tpm_true


def errors(sim_dir: str, n_txps: int, n_frags: int, device) -> list:
    """Simulate into sim_dir and quantify without and with --gcBias;
    [uncorrected, corrected] mean |log TPM err|."""
    names, tpm_true = make_sim(sim_dir, n_txps, n_frags)
    print(f"# sim at {sim_dir}", file=sys.stderr, flush=True)
    return quant_errors(sim_dir, names, tpm_true, ([], ["--gcBias"]), device)


def main(argv=None, device="cuda") -> int:
    device = require_device(device, "sim_gcbias")
    e0, e1 = errors(tempfile.mkdtemp(prefix="salmon_tpu_torch_gcbias_"),
                    int(os.environ.get("GCBIAS_TXPS", 48)),
                    int(os.environ.get("GCBIAS_FRAGS", 60000)), device)
    print(f"mean |log TPM err|: uncorrected {e0:.4f}  --gcBias {e1:.4f} "
          f"(gain {gain(e0, e1):.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
