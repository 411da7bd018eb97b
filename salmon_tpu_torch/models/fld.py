"""Fragment length distribution (reference:
src/model/FragmentLengthDistribution.cpp — log-space histogram with a
Gaussian prior (mean 250, sd 25; SalmonDefaults.hpp:59-60) and binomial
kernel smoothing of each observation).

Device design: the device emits one posterior-weighted fragment-length
histogram per batch (mapping.pipeline fld_hist); this host model folds those
in linear space (float64 — the array is tiny: fld_max+1 bins) and hands the
device back a log-pmf plane for the next batch. That makes the online FLD
batch-synchronous instead of atomically-racing (SURVEY.md §7 design stance).
"""

from __future__ import annotations

import numpy as np

from salmon_tpu_torch.constants import DEFAULTS


def _binomial_kernel(n: int = 4, p: float = 0.5) -> np.ndarray:
    from math import comb
    return np.array([comb(n, i) * p**i * (1 - p)**(n - i)
                     for i in range(n + 1)])


def gaussian_bin_mass(max_val: int, mu: float, sigma: float) -> np.ndarray:
    """Per-integer-bin mass of N(mu, sigma) over [0, max_val] (reference
    ctor: cdf(i+0.5) - cdf(i-0.5))."""
    from math import erf, sqrt
    edges = np.arange(-0.5, max_val + 1.0)
    cdf = 0.5 * (1.0 + np.vectorize(erf)((edges - mu) / (sigma * sqrt(2.0))))
    return np.maximum(np.diff(cdf), 1e-300)


class FragmentLengthDistribution:
    """Linear-space FLD with Gaussian prior and kernel-smoothed updates."""

    def __init__(self, max_val: int = DEFAULTS.max_frag_length,
                 prior_mu: float = DEFAULTS.frag_len_prior_mean,
                 prior_sigma: float = DEFAULTS.frag_len_prior_sd,
                 alpha: float = 1.0, kernel_n: int = 4,
                 kernel_p: float = 0.5):
        self.max_val = max_val
        if prior_mu > 0:
            self.hist = alpha * gaussian_bin_mass(max_val, prior_mu,
                                                  prior_sigma)
        else:
            self.hist = np.full(max_val + 1, alpha / max_val)
            self.hist[0] = 1e-300
        self.kernel = _binomial_kernel(kernel_n, kernel_p)
        self._frozen_logpmf: np.ndarray | None = None
        self.total_observed = 0.0

    def add_observations(self, obs_hist: np.ndarray) -> None:
        """Fold in a batch histogram of posterior-weighted fragment lengths
        (kernel smoothing matches reference addVal's +/-2 binomial spread).
        Out-of-range smoothed mass is clipped to the array bounds."""
        if self._frozen_logpmf is not None:
            return  # frozen after burn-in (reference cacheCMF semantics)
        sm = np.convolve(obs_hist.astype(np.float64), self.kernel)
        half = len(self.kernel) // 2
        sm = sm[half:half + self.max_val + 1]
        self.hist[:len(sm)] += sm
        self.total_observed += float(obs_hist.sum())

    def pmf(self) -> np.ndarray:
        h = self.hist / self.hist.sum()
        return h

    def log_pmf(self) -> np.ndarray:
        if self._frozen_logpmf is not None:
            return self._frozen_logpmf
        return np.log(self.pmf())

    def freeze(self) -> None:
        self._frozen_logpmf = np.log(self.pmf())

    def mean(self) -> float:
        p = self.pmf()
        return float((np.arange(len(p)) * p).sum())

    def cmf(self) -> np.ndarray:
        return np.cumsum(self.pmf())

    def log_cmf(self) -> np.ndarray:
        """Log cumulative mass, the evaluateLogCMF analog
        (reference DistributionUtils.cpp:95-116 + LogCMFCache). The CMF
        snapshot backs single-end/orphan ambiguous fragment-length
        probabilities and txp-length conditioning of the paired pmf."""
        return np.log(np.maximum(self.cmf(), 1e-300))

    def summary(self) -> dict:
        """FLD summary for meta_info.json (reference writeMeta)."""
        p = self.pmf()
        mean = self.mean()
        var = float(((np.arange(len(p)) - mean) ** 2 * p).sum())
        return {"mean": mean, "sd": float(np.sqrt(var))}
