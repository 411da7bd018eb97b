"""Effective transcript lengths.

Reference semantics (src/util/DistributionUtils.cpp:9-56
correctionFactorsFromMass + computeSmoothedEffectiveLengths, driven from
ReadExperiment.inl:62-94 updateTranscriptLengthsAtomic):

  correction[L] = E[fragLen | fragLen <= L]   (conditional mean)
  effLen(t)     = refLen(t) - correction[min(refLen, maxLen-1)]
  if effLen < 1: effLen = refLen

With --noLengthCorrection every transcript gets effLen = 100
(CollapsedEMOptimizer.cpp:787-789).
"""

from __future__ import annotations

import numpy as np


def correction_factors_from_mass(pmf: np.ndarray) -> np.ndarray:
    """correction[i] = sum_{j<=i} j*pmf[j] / sum_{j<=i} pmf[j]."""
    idx = np.arange(pmf.shape[0], dtype=np.float64)
    vals = np.cumsum(pmf * idx)
    mult = np.cumsum(pmf)
    out = np.zeros_like(pmf, dtype=np.float64)
    nz = mult > 0
    out[nz] = vals[nz] / mult[nz]
    return out


def effective_lengths(ref_lens: np.ndarray, fld_pmf: np.ndarray,
                      no_length_correction: bool = False,
                      no_effective_length_correction: bool = False
                      ) -> np.ndarray:
    """Conditional-mean effective lengths (float64)."""
    lens = ref_lens.astype(np.float64)
    if no_length_correction:
        return np.full_like(lens, 100.0)
    if no_effective_length_correction:
        return lens
    corr = correction_factors_from_mass(fld_pmf)
    max_len = corr.shape[0]
    cf = corr[np.minimum(ref_lens, max_len - 1)]
    eff = lens - cf
    eff = np.where(eff < 1.0, lens, eff)
    return eff
