"""Orphan-rescue recall: FLD-quantile probes against mean-only.

Counterpart of scripts/sim_rescue_recall.py on the port's
map_paired_batch (the rescue is the banded DP at band 80). The reference
rescues orphans with a full-window edlib search
(src/quant/SalmonQuantify.cpp:1356-1364); the port, as the JAX package,
probes the banded DP at a few FLD-quantile-predicted mate positions
(mapping/pipeline.py::_rescue_orphans). This harness measures the recall
gap:

  - pairs whose right mate is seed-destroyed but alignable, with true
    fragment lengths drawn from the FLD,
  - rescue with rescue_probes = 1 (mean only), 3 (the default) and 5,
    and an oracle upper bound (a point-mass FLD at each read's true
    fragment length, one read a run),
  - recall = rescued / orphan candidates for narrow and wide FLDs.

Usage: python -m salmon_tpu_torch.scripts.sim_rescue_recall
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from salmon_tpu_torch.scripts import REPO, require_device

SIGMAS = (25.0, 80.0, 160.0)
PROBES = (1, 3, 5)
N = 48            # pairs a run; the oracle maps them one a run
R, RL = 1024, 76  # K = R/4 = 256 DP slots: 48x5 probes all fit
MEAN_FL = 280.0
M = 1001          # the FLD's support, [0, 1000]


def sample_index():
    """The sample transcripts (tests/data) indexed at k 31."""
    from salmon_tpu_torch.index.builder import build_index
    return build_index(os.path.join(REPO, "tests", "data",
                                    "transcripts.fasta"), k=31)


def make_pairs(idx, sigma: float, n: int, seed: int):
    """n pairs whose right mates have every k=31 seed window destroyed;
    (left sequences, right sequences, true fragment lengths)."""
    from salmon_tpu_torch.utils.dna import decode_seq, revcomp_codes
    rng = np.random.default_rng(seed)
    s1, s2, true_fl = [], [], []
    while len(true_fl) < n:
        tid = int(rng.integers(0, idx.num_valid_targets))
        codes = idx.transcript_codes(tid)
        L = codes.shape[0]
        fl = int(np.clip(rng.normal(MEAN_FL, sigma), 2 * RL, M - 1))
        if L <= fl + 2:
            continue
        start = int(rng.integers(0, L - fl))
        left = codes[start:start + RL].copy()
        right = revcomp_codes(codes[start + fl - RL:start + fl]).copy()
        for p in range(5, RL, 12):  # destroy every k=31 seed window
            right[p] = (right[p] + 1) % 4
        s1.append(decode_seq(left).encode())
        s2.append(decode_seq(right).encode())
        true_fl.append(fl)
    return s1, s2, true_fl


def fld_logpmf(sigma: float) -> np.ndarray:
    """The learned FLD's analog: a truncated normal log-pmf over [0, M)."""
    xs = np.arange(M, dtype=np.float64)
    pmf = np.exp(-0.5 * ((xs - MEAN_FL) / sigma) ** 2)
    pmf[: 2 * RL] = 0.0  # fragment at least covers both mates
    pmf /= pmf.sum()
    return np.log(np.maximum(pmf, 1e-300)).astype(np.float32)


def run(idx, dev, sigma, probes, device, n=N, seed=0, oracle=False):
    """(rescued, candidates) at one FLD width and probe count; `dev` is
    device_index_tensors(idx, device)."""
    from salmon_tpu_torch.io.fastq import pack_seqs
    from salmon_tpu_torch.mapping.pipeline import (MapperConfig,
                                                   map_paired_batch)
    from salmon_tpu_torch.utils import libformat

    s1, s2, true_fl = make_pairs(idx, sigma, n, seed)
    c1, l1 = pack_seqs(s1, R, RL)
    c2, l2 = pack_seqs(s2, R, RL)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    batch = {"codes_l": put(c1), "lengths_l": put(l1),
             "codes_r": put(c2), "lengths_r": put(l2)}
    fmt = libformat.parse_library_format("IU")
    cp = put(libformat.paired_compat_table(fmt))
    co = put(libformat.orphan_compat_table(fmt))
    cfg = MapperConfig.from_index(idx, recover_orphans=True)
    if oracle:
        # a point-mass FLD at each read's true fragment length is not
        # expressible batch-wide: one read a run, tiled to 8 rows. The
        # JAX script's config keeps its default probes here (its
        # MapperConfig has no replace method), and so does this one.
        # Recall is then the DP/band ceiling (position exactly right).
        rescued = 0
        for i in range(n):
            pm = np.full(M, 1e-30, np.float32)
            pm[true_fl[i]] = 1.0
            lp = put(np.log(pm / pm.sum()).astype(np.float32))
            b1 = {k: torch.cat([v[i:i + 1]] * 8, 0)
                  for k, v in batch.items()}
            out = map_paired_batch(b1, dev, cfg, lp, cp, co)
            rescued += int(int(out["num_orphans_rescued"]) > 0)
        return rescued, n
    cfg = dataclasses.replace(cfg, rescue_probes=probes)
    out = map_paired_batch(batch, dev, cfg, put(fld_logpmf(sigma)), cp, co)
    return int(out["num_orphans_rescued"]), n


def recalls(device, sigmas=SIGMAS, probes=PROBES) -> dict:
    """{(sigma, probes or "oracle"): (rescued, n)} over the grid."""
    from salmon_tpu_torch.mapping.pipeline import device_index_tensors
    idx = sample_index()
    dev = device_index_tensors(idx, device)
    out = {}
    for sigma in sigmas:
        for q in probes:
            out[sigma, q] = run(idx, dev, sigma, q, device)
        out[sigma, "oracle"] = run(idx, dev, sigma, 1, device, oracle=True)
    return out


def main(argv=None, device="cuda") -> int:
    device = require_device(device, "sim_rescue_recall")
    res = recalls(device)
    print(f"{'FLD sigma':>10} {'probes':>7} {'recall':>8}")
    for (sigma, q), (r, n) in res.items():
        label = f"{q:>7d}" if q != "oracle" else f"{'oracle':>7}"
        print(f"{sigma:>10.0f} {label} {r}/{n} = {r / n:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
