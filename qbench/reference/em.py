"""Plain references of the sample's finish: effective lengths and the
VBEM over rich equivalence classes (salmon's CollapsedEMOptimizer at
its defaults), in any torch dtype on any device. No code of the program
is imported.

effective_lengths: efflen(t) = len(t) - E[fragment length | fragment
length <= len(t)] under the fragment-length pmf (lengths past the pmf
read its last entry), or len(t) where that is below 1.

vbem: the initial estimate blends the online estimate with a uniform
one, frac = min(0.999, mapped / num_required_frags); class entries are
weighted count * aux / max(efflen, 1), normalised within the class;
classes whose weight under the initial estimate is ~0 drop out; each
iteration sets alpha_t = sum over classes of count * w_t exp(digamma(
alpha_t + prior_t)) / sum_t' (...), the digamma of the total cancelling
within a class, with prior_t = vb_prior (per transcript, salmon's default) or
vb_prior * efflen_t (per nucleotide), singleton classes
giving their whole count; estimates below min_alpha end as 0.
"""

from __future__ import annotations

import numpy as np
import torch


def effective_lengths(lengths: np.ndarray, pmf: np.ndarray,
                      dtype=torch.float64) -> np.ndarray:
    p = torch.as_tensor(np.asarray(pmf, np.float64), dtype=dtype)
    x = torch.arange(p.shape[0], dtype=dtype)
    mass = torch.cumsum(p, 0)
    mean = torch.where(mass > 0, torch.cumsum(p * x, 0)
                       / torch.where(mass > 0, mass, torch.ones_like(mass)),
                       torch.zeros_like(mass))
    L = torch.as_tensor(np.asarray(lengths, np.int64))
    lf = L.to(dtype)
    eff = lf - mean[L.clamp(max=p.shape[0] - 1)]
    eff = torch.where(eff < 1, lf, eff)
    return eff.to(torch.float64).numpy()


def vbem(labels, offsets, counts, aux, eff_lens, online_mass, total_mapped,
         iterations: int, params: dict, device="cpu", dtype=torch.float64):
    """Estimated counts after `iterations` VBEM iterations."""
    dev = torch.device(device)
    n = eff_lens.shape[0]

    def put(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=dev).to(dt)

    sizes = np.diff(np.asarray(offsets))
    seg = put(np.repeat(np.arange(sizes.shape[0]), sizes), torch.int64)
    lab = put(labels, torch.int64)
    cnt = put(counts)
    el = put(eff_lens)
    ncl = sizes.shape[0]

    def seg_sum(v, idx, m):
        return torch.zeros(m, dtype=v.dtype, device=dev).index_add_(0, idx, v)

    frac = min(0.999, float(total_mapped) / params["num_required_frags"])
    a = put(online_mass) * frac + (float(total_mapped) / n) * (1 - frac)
    prior = (torch.full_like(el, params["vb_prior"])
             if params["per_transcript_prior"] else params["vb_prior"] * el)
    w = cnt[seg] * put(aux) / torch.clamp(el[lab], min=1.0)
    den = seg_sum(w, seg, ncl)[seg]
    w = torch.where(den > 0, w / den, torch.zeros_like(w))
    dead = (seg_sum(a[lab] * w, seg, ncl) <= 1e-30) & (put(sizes) > 0)
    cnt = torch.where(dead, torch.zeros_like(cnt), cnt)
    ce = cnt[seg]
    single = put(sizes, torch.int64)[seg] == 1
    for _ in range(iterations):
        ap = a + prior
        g = torch.where(ap > 1e-10,
                        torch.exp(torch.digamma(torch.clamp(ap, min=1e-10))
                                  - torch.digamma(ap.sum())),
                        torch.zeros_like(ap))
        gam = g[lab] * w
        d = seg_sum(gam, seg, ncl)[seg]
        c = torch.where(d > 1e-30, ce * gam / torch.clamp(d, min=1e-30),
                        torch.zeros_like(gam))
        c = torch.where(single, ce, c)
        a = seg_sum(c, lab, n)
    out = a.to(torch.float64).cpu().numpy()
    out[out < params["min_alpha"]] = 0.0
    return out
