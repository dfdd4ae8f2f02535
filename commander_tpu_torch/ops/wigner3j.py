"""Wigner 3j symbols by the Racah formula, its terms summed on a log scale
(host numpy).

Counterpart of commander_tpu.ops.wigner3j (the reference's SLATEC
drc3jj.f), for mode-coupling calculations of beams and pixel windows:
accurate to about 1e-10 for l up to a few hundred. No driver path calls it,
as in the JAX package.
"""
from __future__ import annotations

import numpy as np
from scipy.special import gammaln


def _lnf(n):
    return gammaln(np.asarray(n, np.float64) + 1.0)


def wigner_3j(l1, l2, l3, m1, m2, m3) -> float:
    """The symbol (l1 l2 l3; m1 m2 m3); 0 where the selection rules fail."""
    if m1 + m2 + m3 != 0 or not abs(l1 - l2) <= l3 <= l1 + l2:
        return 0.0
    if abs(m1) > l1 or abs(m2) > l2 or abs(m3) > l3:
        return 0.0
    ln_delta = 0.5 * (_lnf(l1 + l2 - l3) + _lnf(l1 - l2 + l3)
                      + _lnf(-l1 + l2 + l3) - _lnf(l1 + l2 + l3 + 1))
    ln_pref = 0.5 * (_lnf(l1 + m1) + _lnf(l1 - m1) + _lnf(l2 + m2)
                     + _lnf(l2 - m2) + _lnf(l3 + m3) + _lnf(l3 - m3))
    t_min = max(0, l2 - l3 - m1, l1 - l3 + m2)
    t_max = min(l1 + l2 - l3, l1 - m1, l2 + m2)
    if t_max < t_min:
        return 0.0
    ts = np.arange(t_min, t_max + 1)
    ln_terms = -(_lnf(ts) + _lnf(l1 + l2 - l3 - ts) + _lnf(l1 - m1 - ts)
                 + _lnf(l2 + m2 - ts) + _lnf(l3 - l2 + m1 + ts)
                 + _lnf(l3 - l1 - m2 + ts))
    ln_max = ln_terms.max()
    s = np.sum((-1.0) ** ts * np.exp(ln_terms - ln_max))
    return float((-1.0) ** (l1 - l2 - m3)
                 * np.exp(ln_delta + ln_pref + ln_max) * s)


def wigner_3j_series(l2: int, l3: int, m2: int, m3: int):
    """Every allowed l1 for fixed (l2, l3, m2, m3), m1 = -(m2 + m3) (the
    DRC3JJ contract): (l1_min, the symbols for l1 = l1_min .. l2 + l3)."""
    m1 = -(m2 + m3)
    l1min = max(abs(l2 - l3), abs(m1))
    return l1min, np.array([wigner_3j(l1, l2, l3, m1, m2, m3)
                            for l1 in range(l1min, l2 + l3 + 1)])
