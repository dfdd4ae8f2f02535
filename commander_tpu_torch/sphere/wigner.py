"""Wigner-d tables by the scaled upward recurrence in l (host numpy).

Counterpart of commander_tpu.sphere.wigner, a copy: _theta_halves,
wigner_d_table_fast (the JAX package's wigner_d_table and
wigner_d_table_fast give the same numbers) and spin_lambda_north.
They give

    d^l_{m,mp}(theta) for l = 0..lmax, m = 0..m_max, one mp,

the seed d^{l0}_{m,mp} ~ cos^a(theta/2) sin^b(theta/2) and the three-term
recurrence run on (mantissa, exponent-block) pairs, renormalized whenever
the mantissa leaves [2^-450, 2^450], so that the seeds of m ~ thousands
near the poles do not underflow float64; values still below ~1e-300 after
unscaling are flushed to 0. Its users here: the exact HEALPix pixel window
(instrument/beam.pixel_window_exact), the Legendre tables of the table SHT
path (spin_lambda_north, sphere/sht.get_plan(tables=True)) and the
sidelobe convolver's d^l_{m,+-m'} tables (tod/conviqt.conviqt_tables); the
kernels' recurrence lives in sphere/sht_otf.py.
"""
from __future__ import annotations

import functools

import numpy as np

_SCALE_EXP = 450  # renormalize when |mantissa| crosses 2^+-_SCALE_EXP
_BIG = float(2.0**_SCALE_EXP)
_BIGI = float(2.0**-_SCALE_EXP)


@functools.lru_cache(maxsize=None)
def _theta_halves(nside: int):
    from .healpix import ring_geometry

    g = ring_geometry(nside)
    nh = 2 * nside  # north rings incl. equator
    th = g.theta[:nh]
    return np.cos(th / 2.0), np.sin(th / 2.0)


def wigner_d_table_fast(lmax: int, m_max: int, mp: int, cth2: np.ndarray,
                        sth2: np.ndarray) -> np.ndarray:
    """The per-m recurrence (the JAX package's wigner_d_table), vectorized
    over m (identical output).

    One numpy loop over l updating all (theta, m) columns at once — the
    recurrence, seeds, and exponent-tracked rescaling all vectorize. This
    is what makes nside >= 512 plan builds tractable (the per-m Python
    loop costs minutes at lmax 1024+).
    """
    from scipy.special import gammaln

    ntheta = cth2.shape[0]
    nm = m_max + 1
    x = (cth2**2 - sth2**2)[:, None]                      # (T, 1)
    out = np.zeros((ntheta, lmax + 1, nm), dtype=np.float64)

    m = np.arange(nm, dtype=np.float64)[None, :]          # (1, nm)
    amp = abs(mp)
    l0 = np.maximum(m, amp).astype(np.int64)              # (1, nm)

    # --- seeds (log space), all m at once --------------------------------
    with np.errstate(divide="ignore"):
        lc, ls = np.log(cth2)[:, None], np.log(sth2)[:, None]
    logv = np.empty((ntheta, nm))
    sign = np.empty((ntheta, nm))
    hi = (m >= amp)                                       # seed at l0 = m
    logc_hi = 0.5 * (gammaln(2 * m + 1) - gammaln(m + mp + 1)
                     - gammaln(m - mp + 1))
    logv_hi = logc_hi + (m + mp) * lc + (m - mp) * ls
    sign_hi = np.broadcast_to((-1.0) ** (m - mp), (ntheta, nm))
    logc_lo = 0.5 * (gammaln(2 * amp + 1) - gammaln(amp + m + 1)
                     - gammaln(amp - m + 1))
    if mp > 0:
        logv_lo = logc_lo + (mp + m) * lc + (mp - m) * ls
        sign_lo = np.ones((ntheta, nm))
    else:
        logv_lo = logc_lo + (amp - m) * lc + (amp + m) * ls
        sign_lo = np.broadcast_to((-1.0) ** (amp + m), (ntheta, nm))
    logv = np.where(hi, logv_hi, logv_lo)
    sign = np.where(hi, sign_hi, sign_lo)

    lbig = np.log(_BIG)
    seed_exp = np.floor(logv / lbig).astype(np.int64)
    seed_mant = sign * np.exp(logv - seed_exp * lbig)
    bad = ~np.isfinite(logv)
    seed_mant[bad] = 0.0
    seed_exp[bad] = 0

    def emit(l, mant, exp, cols):
        v = np.where(exp == 0, mant,
                     np.where(exp < 0, mant * np.where(exp >= -1, _BIGI, 0.0),
                              mant * _BIG))
        out[:, l, :][:, cols] = v[:, cols]

    cur_mant = np.zeros((ntheta, nm))
    cur_exp = np.zeros((ntheta, nm), np.int64)
    prev_mant = np.zeros((ntheta, nm))
    prev_exp = np.zeros((ntheta, nm), np.int64)

    mf = m  # (1, nm) float
    for l in range(int(l0.min()), lmax + 1):
        starting = (l0 == l)[0]                            # (nm,) bool
        if starting.any():
            cur_mant[:, starting] = seed_mant[:, starting]
            cur_exp[:, starting] = seed_exp[:, starting]
            prev_mant[:, starting] = 0.0
            prev_exp[:, starting] = 0
        active = (l0 <= l)[0]
        emit(l, cur_mant, cur_exp, active)
        if l == lmax:
            break
        # recurrence l -> l+1 for columns with l0 <= l
        lf = float(l)
        wl1 = np.sqrt(np.maximum(((lf + 1) ** 2 - mf**2)
                                 * ((lf + 1) ** 2 - mp**2), 0.0)) / (lf + 1)
        if l == 0:
            alpha = x * np.ones((1, nm))
            beta = np.zeros((1, nm))
        else:
            wl = np.sqrt(np.maximum((lf**2 - mf**2) * (lf**2 - mp**2),
                                    0.0)) / lf
            with np.errstate(divide="ignore", invalid="ignore"):
                alpha = (2 * lf + 1) * (x - (mf * mp) / (lf * (lf + 1))) / wl1
                beta = wl / wl1
            alpha[:, ~np.isfinite(alpha[0])] = 0.0
            beta = np.where(np.isfinite(beta), beta, 0.0)
        de = prev_exp - cur_exp
        scale_prev = np.where(de == 0, 1.0, np.where(de <= -1, _BIGI, _BIG))
        scale_prev = np.where(de <= -2, 0.0, scale_prev)
        new_mant = alpha * cur_mant - beta * prev_mant * scale_prev
        new_exp = cur_exp.copy()
        big = np.abs(new_mant) > _BIG
        if big.any():
            new_mant = np.where(big, new_mant * _BIGI, new_mant)
            cur_scaled = np.where(big, cur_mant * _BIGI, cur_mant)
            new_exp = new_exp + big
        else:
            cur_scaled = cur_mant
        # the divided cur must carry the incremented exponent (new_exp), or
        # the beta*prev term is double-scaled to ~0 on the step after a
        # rescale — a ~5% persistent error when the rescale lands near the
        # turning point where prev ~ cur (caught vs scipy at nside 512).
        # copy(): the starting-column reset mutates prev_exp in place and
        # must not clobber cur_exp through aliasing
        prev_mant, prev_exp = cur_scaled, new_exp.copy()
        cur_mant, cur_exp = new_mant, new_exp
        # freeze inactive columns so their (zero) state is untouched
        inactive = (l0 > l)[0]
        if inactive.any():
            cur_mant[:, inactive] = 0.0
            prev_mant[:, inactive] = 0.0
            cur_exp[:, inactive] = 0
            prev_exp[:, inactive] = 0
    return out


@functools.lru_cache(maxsize=2)
def spin_lambda_north(nside: int, lmax: int, spin: int,
                      mmax: int | None = None):
    """sLambda_lm on the northern rings (incl. equator) of an nside grid.

    Returns (lam_pos, lam_neg):
      lam_pos[r, l, m] = sqrt((2l+1)/4pi) d^l_{m,-s}(theta_r)
      lam_neg[r, l, m] = sqrt((2l+1)/4pi) d^l_{m, s}(theta_r)
    With our d-convention this matches scipy/healpy for s=0:
      Y_lm(theta, phi) = lam_pos[.., l, m] e^{i m phi}  (CS phase included).
    For spin 0 the two are identical and lam_neg is lam_pos (same object).
    Shapes (2*nside, lmax+1, mmax+1) float64. The southern rings follow from
      d^l_{m,mp}(pi - theta) = (-1)^(l+m) d^l_{m,-mp}(theta):
    sht.py folds (-1)^(l+m) into the alms and takes the other table. Two
    calls are cached, the spin 0 and spin 2 of one resolution (a table at
    nside 256 / lmax 512 is 1.1 GB).
    """
    if mmax is None:
        mmax = lmax
    cth2, sth2 = _theta_halves(nside)
    norm = np.sqrt((2.0 * np.arange(lmax + 1) + 1.0) / (4.0 * np.pi))
    pref = norm[None, :, None]
    d_pos = wigner_d_table_fast(lmax, mmax, -spin, cth2, sth2)
    lam_pos = pref * d_pos
    if spin == 0:
        return lam_pos, lam_pos
    d_neg = wigner_d_table_fast(lmax, mmax, spin, cth2, sth2)
    lam_neg = pref * d_neg
    return lam_pos, lam_neg
