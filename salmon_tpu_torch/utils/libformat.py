"""Library format handling (reference: src/model/LibraryFormat.cpp,
src/util/SalmonUtils.cpp:138-298 isCompatible/compatibleHit,
src/util/SalmonUtils.cpp:531-657 hitType).

Formats: U/SF/SR (single-end), IU/ISF/ISR/OU/OSF/OSR/MU/MSF/MSR (paired),
plus 'A' for auto-detection.

For the device pipeline, observed paired-end orientations are encoded as a
small integer (OBS_* codes) so compatibility with the expected library type
is a 1-D table gather instead of branching.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum

import numpy as np


class ReadType(IntEnum):
    SINGLE_END = 0
    PAIRED_END = 1


class Orientation(IntEnum):
    NONE = 0
    SAME = 1      # M
    AWAY = 2      # O
    TOWARD = 3    # I


class Strandedness(IntEnum):
    U = 0
    S = 1
    A = 2
    SA = 3
    AS = 4


@dataclasses.dataclass(frozen=True)
class LibraryFormat:
    type: ReadType
    orientation: Orientation
    strandedness: Strandedness

    def check(self) -> bool:
        """Validity rules (reference: LibraryFormat::check)."""
        if self.type == ReadType.SINGLE_END:
            if self.orientation != Orientation.NONE:
                return False
            return self.strandedness in (Strandedness.U, Strandedness.S,
                                         Strandedness.A)
        if self.orientation == Orientation.NONE:
            return False
        if self.orientation == Orientation.SAME:
            return self.strandedness in (Strandedness.U, Strandedness.S,
                                         Strandedness.A)
        return self.strandedness in (Strandedness.U, Strandedness.SA,
                                     Strandedness.AS)

    def name(self) -> str:
        for nm, fmt in _FORMATS.items():
            if fmt == self:
                return nm
        return "?"


_T, _O, _S = ReadType, Orientation, Strandedness
_FORMATS: dict[str, LibraryFormat] = {
    "U":   LibraryFormat(_T.SINGLE_END, _O.NONE, _S.U),
    "SF":  LibraryFormat(_T.SINGLE_END, _O.NONE, _S.S),
    "SR":  LibraryFormat(_T.SINGLE_END, _O.NONE, _S.A),
    "IU":  LibraryFormat(_T.PAIRED_END, _O.TOWARD, _S.U),
    "ISF": LibraryFormat(_T.PAIRED_END, _O.TOWARD, _S.SA),
    "ISR": LibraryFormat(_T.PAIRED_END, _O.TOWARD, _S.AS),
    "OU":  LibraryFormat(_T.PAIRED_END, _O.AWAY, _S.U),
    "OSF": LibraryFormat(_T.PAIRED_END, _O.AWAY, _S.SA),
    "OSR": LibraryFormat(_T.PAIRED_END, _O.AWAY, _S.AS),
    "MU":  LibraryFormat(_T.PAIRED_END, _O.SAME, _S.U),
    "MSF": LibraryFormat(_T.PAIRED_END, _O.SAME, _S.S),
    "MSR": LibraryFormat(_T.PAIRED_END, _O.SAME, _S.A),
}


def parse_library_format(s: str) -> LibraryFormat:
    """Parse a '-l' library type string ('A' handled by the caller)."""
    s = s.strip().upper()
    if s not in _FORMATS:
        raise ValueError(f"unknown library format '{s}' "
                         f"(expected one of {sorted(_FORMATS)} or 'A')")
    return _FORMATS[s]


# ---------------------------------------------------------------------------
# Observed-orientation codes for device-side compatibility gathers.
# Paired observed formats (reference hitType, SalmonUtils.cpp:531-576):
#   fwd1 != fwd2, fwd1, s1 <= s2       -> ISF  (TOWARD, SA)
#   fwd1 != fwd2, fwd1, s1 >  s2       -> OSF  (AWAY,  SA)
#   fwd1 != fwd2, fwd2, s2 <= s1       -> ISR  (TOWARD, AS)
#   fwd1 != fwd2, fwd2, s2 >  s1       -> OSR  (AWAY,  AS)
#   fwd1 == fwd2, fwd1                 -> MSF  (SAME,  S)
#   fwd1 == fwd2, !fwd1                -> MSR  (SAME,  A)
OBS_ISF, OBS_OSF, OBS_ISR, OBS_OSR, OBS_MSF, OBS_MSR = range(6)
_OBS_PAIRED = ["ISF", "OSF", "ISR", "OSR", "MSF", "MSR"]
# Single-end observed codes:
OBS_SF, OBS_SR = 0, 1
_OBS_SINGLE = ["SF", "SR"]


def paired_compat_table(expected: LibraryFormat) -> np.ndarray:
    """bool[6]: is observed paired code compatible with `expected`?

    Reference: compatibleHit(expected, observed) SalmonUtils.cpp:271-298 —
    orientations must match; strandedness must match or expected U.
    """
    out = np.zeros(6, dtype=bool)
    for code, nm in enumerate(_OBS_PAIRED):
        obs = _FORMATS[nm]
        if expected.type != ReadType.PAIRED_END:
            out[code] = False
            continue
        if expected.orientation != obs.orientation:
            out[code] = False
        else:
            out[code] = (expected.strandedness == Strandedness.U
                         or expected.strandedness == obs.strandedness)
    return out


def single_compat_table(expected: LibraryFormat) -> np.ndarray:
    """bool[2] over (SF, SR) observed single-end hits.

    Reference: compatibleHit(expected, start, isForward, SINGLE_END)
    SalmonUtils.cpp:191-205.
    """
    es = expected.strandedness
    fw_ok = es in (Strandedness.U, Strandedness.S)
    rc_ok = es in (Strandedness.U, Strandedness.A)
    return np.array([fw_ok, rc_ok], dtype=bool)


def orphan_compat_table(expected: LibraryFormat) -> np.ndarray:
    """bool[2,2] over (mate in {left,right}) x (observed {fwd, rc}).

    Reference: compatibleHit PAIRED_END_LEFT/RIGHT branches
    (SalmonUtils.cpp:206-257).
    """
    es, eo = expected.strandedness, expected.orientation
    out = np.zeros((2, 2), dtype=bool)
    if eo == Orientation.SAME:
        # left and right mates behave identically for SAME orientation
        out[0, 0] = es in (Strandedness.U, Strandedness.S)   # observed fwd
        out[0, 1] = es in (Strandedness.U, Strandedness.A)   # observed rc
        out[1] = out[0]
        return out
    # left mate: fwd -> U or SA ; rc -> U or AS
    out[0, 0] = es in (Strandedness.U, Strandedness.SA)
    out[0, 1] = es in (Strandedness.U, Strandedness.AS)
    # right mate: fwd -> U or AS ; rc -> U or SA
    out[1, 0] = es in (Strandedness.U, Strandedness.AS)
    out[1, 1] = es in (Strandedness.U, Strandedness.SA)
    return out


def format_names_paired() -> list[str]:
    return list(_OBS_PAIRED)


def format_names_single() -> list[str]:
    return list(_OBS_SINGLE)
