"""Sequence-bias correction on simulated truth: simulate
random-hexamer-primed fragmentation (the bias --seqBias models, Roberts
et al. 2011) and compare TPM error with and without correction.

Counterpart of scripts/sim_seqbias.py: the same generator, whose files
are byte-equal to that script's from the same seed, quantified by the
port's CLI. Generative model: each fragment start s on transcript i is
drawn with weight exp(sum_j S[base(s+j), j]) over the 6-mer at the
start, where S is a random position-weight matrix of strength
SEQBIAS_SCALE. Reads per transcript ~ eta_i * total usable weight, so
the molar truth is eta.

Usage: [SEQBIAS_SCALE=1.0] [SEQBIAS_TXPS=48] [SEQBIAS_FRAGS=80000]
  python -m salmon_tpu_torch.scripts.sim_seqbias
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from salmon_tpu_torch.scripts import require_device

FLEN_MU, FLEN_SD = 200, 15
READ_LEN = 75
K = 6
B2C = np.array(list("ACGT"))
COMP = str.maketrans("ACGT", "TGCA")


def write_fasta(out_dir: str, names, codes) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "transcripts.fasta"), "w") as fh:
        for nm, c in zip(names, codes):
            fh.write(f">{nm}\n{''.join(B2C[c])}\n")


def write_pair(f1, f2, nm: str, seq: str, s: int, fl: int) -> None:
    """One fragment [s, s + fl) of `seq` as a pair of READ_LEN mates, the
    right one reverse-complemented."""
    left = seq[s:s + READ_LEN]
    right = seq[s + fl - READ_LEN:s + fl].translate(COMP)[::-1]
    f1.write(f"@{nm}\n{left}\n+\n{'I' * len(left)}\n")
    f2.write(f"@{nm}\n{right}\n+\n{'I' * len(right)}\n")


def make_sim(out_dir, n_txps, n_frags, seed=11):
    """Write transcripts.fasta and reads_{1,2}.fastq; (names, tpm_true)."""
    scale = float(os.environ.get("SEQBIAS_SCALE", 1.0))
    rng = np.random.default_rng(seed)
    lens = np.linspace(600, 6000, n_txps).astype(int)
    rng.shuffle(lens)
    names = [f"SIM{i:03d}" for i in range(n_txps)]
    codes = [rng.integers(0, 4, L).astype(np.int8) for L in lens]
    # position-weight matrix over the start hexamer (fixed across txps)
    S = rng.normal(0.0, scale, (4, K))

    def start_weights(c):
        n = max(c.shape[0] - FLEN_MU, 1)
        w = np.zeros(n)
        for j in range(K):
            w += S[c[j:j + n], j]
        return np.exp(w)

    eta = rng.lognormal(0.0, 1.0, n_txps)
    sw = [start_weights(c) for c in codes]
    mass = eta * np.array([w.sum() for w in sw])
    cnt = rng.multinomial(n_frags, mass / mass.sum())
    tpm_true = eta / eta.sum() * 1e6

    write_fasta(out_dir, names, codes)
    with open(os.path.join(out_dir, "reads_1.fastq"), "w") as f1, \
            open(os.path.join(out_dir, "reads_2.fastq"), "w") as f2:
        rn = 0
        for i in range(n_txps):
            if not cnt[i]:
                continue
            seq = "".join(B2C[codes[i]])
            w = sw[i]
            starts = rng.choice(w.shape[0], size=cnt[i], p=w / w.sum())
            flens = np.clip(rng.normal(FLEN_MU, FLEN_SD, cnt[i])
                            .astype(int), 2 * READ_LEN, None)
            for s, fl in zip(starts, flens):
                fl = int(min(fl, lens[i] - s))
                write_pair(f1, f2, f"{rn}:{names[i]}:{s}:{fl}", seq, s, fl)
                rn += 1
    return names, tpm_true


def run_quant(sim_dir, out, flags, device="cuda"):
    """`index` (once) and `quant -l IU` of the simulation through the
    port's CLI on `device`; {name: TPM}."""
    from salmon_tpu_torch.cli import main
    from salmon_tpu_torch.io.writers import read_quant_sf
    idx_dir = os.path.join(sim_dir, "idx")
    if not os.path.isdir(idx_dir):
        assert main(["index", "-t",
                     os.path.join(sim_dir, "transcripts.fasta"),
                     "-i", idx_dir, "-k", "31", "--no-version-check"]) == 0
    assert main(["quant", "-i", idx_dir, "-l", "IU",
                 "-1", os.path.join(sim_dir, "reads_1.fastq"),
                 "-2", os.path.join(sim_dir, "reads_2.fastq"),
                 "-o", out, *flags, "-q", "--no-version-check"],
                device=device) == 0
    q = read_quant_sf(os.path.join(out, "quant.sf"))
    return dict(zip(q["Name"], q["TPM"]))


def tpm_error(names, tpm_true, est):
    """Mean |log(estimated / true TPM)| over the transcripts both hold."""
    t = np.asarray(tpm_true, float)
    e = np.array([est.get(nm, 0.0) for nm in names])
    m = (t > 0) & (e > 0)
    return float(np.mean(np.abs(np.log(e[m] / t[m]))))


def gain(e0: float, e1: float) -> float:
    """Error reduction in percent."""
    return 100 * (1 - e1 / max(e0, 1e-12))


def quant_errors(sim_dir: str, names, tpm_true, flag_sets, device) -> list:
    """Mean |log TPM err| of a quant of the simulation in sim_dir with
    each set of flags in turn (outputs q0, q1, ...)."""
    return [tpm_error(names, tpm_true,
                      run_quant(sim_dir, os.path.join(sim_dir, f"q{i}"),
                                flags, device))
            for i, flags in enumerate(flag_sets)]


def errors(sim_dir: str, n_txps: int, n_frags: int, device) -> list:
    """Simulate into sim_dir and quantify without and with --seqBias;
    [uncorrected, corrected] mean |log TPM err|."""
    names, tpm_true = make_sim(sim_dir, n_txps, n_frags)
    print(f"# sim at {sim_dir}", file=sys.stderr, flush=True)
    return quant_errors(sim_dir, names, tpm_true, ([], ["--seqBias"]),
                        device)


def main(argv=None, device="cuda") -> int:
    device = require_device(device, "sim_seqbias")
    e0, e1 = errors(tempfile.mkdtemp(prefix="salmon_tpu_torch_seqbias_"),
                    int(os.environ.get("SEQBIAS_TXPS", 48)),
                    int(os.environ.get("SEQBIAS_FRAGS", 80000)), device)
    print(f"mean |log TPM err|: uncorrected {e0:.4f}  --seqBias {e1:.4f} "
          f"(gain {gain(e0, e1):.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
