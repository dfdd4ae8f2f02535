"""Derivative-free minimization (Powell's method), host numpy.

Copied from commander_tpu.ops.powell (the reference's powell_mod.f90), for
the OPERATION = optimize fits of the point sources
(sampling/joint.optimize_ptsrc): the objective is a numpy function of a few
parameters, and the outer loop is tiny.
"""
from __future__ import annotations

import numpy as np


def _line_min(f, x, d, tol=1e-8, maxiter=60):
    """Line search of f(x + t d): coarse bidirectional grid to bracket a
    minimum around t=0, then golden-section refinement."""
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    ts = np.concatenate([[0.0], np.geomspace(1e-3, 4.0, 10),
                         -np.geomspace(1e-3, 4.0, 10)])
    fs = np.array([f(x + t * d) for t in ts])
    i = int(np.argmin(fs))
    t_best = ts[i]
    step = max(abs(t_best), 1e-3)
    a, b = t_best - step, t_best + step
    c = b - phi * (b - a)
    dd = a + phi * (b - a)
    fc, fd = f(x + c * d), f(x + dd * d)
    for _ in range(maxiter):
        if abs(b - a) < tol * (1.0 + abs(a) + abs(b)):
            break
        if fc < fd:
            b, dd, fd = dd, c, fc
            c = b - phi * (b - a)
            fc = f(x + c * d)
        else:
            a, c, fc = c, dd, fd
            dd = a + phi * (b - a)
            fd = f(x + dd * d)
    cand = [(fs[i], ts[i]), (fc, c), (fd, dd)]
    ft, t = min(cand)
    return x + t * d, ft


def powell(f, x0, tol=1e-8, maxiter=50):
    """Minimize f: R^n -> R. Returns (x_min, f_min, n_iter)."""
    x = np.asarray(x0, np.float64).copy()
    n = x.size
    dirs = [np.eye(n)[i] * max(abs(x[i]) * 0.1, 0.1) for i in range(n)]
    fx = f(x)
    for it in range(maxiter):
        x_start, f_start = x.copy(), fx
        biggest, bi = 0.0, 0
        for i, d in enumerate(dirs):
            x_new, f_new = _line_min(f, x, d)
            if fx - f_new > biggest:
                biggest, bi = fx - f_new, i
            x, fx = x_new, f_new
        if 2.0 * (f_start - fx) <= tol * (abs(f_start) + abs(fx) + 1e-300):
            break
        # replace the direction of largest decrease with the net direction
        d_net = x - x_start
        if np.linalg.norm(d_net) > 0:
            dirs[bi] = d_net
    return x, fx, it + 1
