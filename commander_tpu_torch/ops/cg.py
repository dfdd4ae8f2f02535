"""Preconditioned conjugate gradient as a Python loop.

Counterpart of commander_tpu.ops.cg (pcg, CGResult), with the same maxiter /
tol / min_iter semantics, including the initial A(x0). The loop reads the
residual norm back to the host for its convergence test EVERY iteration: at
the tutorial's scale one iteration is a full synthesis plus adjoint over
all bands, so a one-scalar device-to-host sync per iteration costs little
and never runs an iteration past convergence.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    rel_res: float          # final |r|/|b|
    converged: bool


def _plain_dot(a, b):
    return torch.sum((a * b.conj()).real) if a.is_complex() \
        else torch.sum(a * b)


def pcg(A: Callable, b: torch.Tensor, x0=None, M_inv: Callable | None = None,
        dot: Callable = _plain_dot, tol: float = 1e-8, maxiter: int = 100,
        min_iter: int = 0) -> CGResult:
    """Solve A x = b with preconditioned CG; `dot` is the inner product
    under which A and M_inv are self-adjoint positive."""
    if M_inv is None:
        M_inv = lambda r: r
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - A(x)
    z = M_inv(r)
    p = z
    bnorm = float(torch.sqrt(dot(b, b)))
    bnorm = bnorm if bnorm > 0 else 1.0
    rz = dot(r, z)
    rnorm = float(torch.sqrt(dot(r, r)))
    i = 0
    while i < maxiter and (rnorm / bnorm > tol or i < min_iter):
        Ap = A(p)
        pAp = dot(p, Ap)
        # breakdown: the residual is exhausted in this precision (rz or
        # p.Ap has underflowed to 0) and the next step would divide by 0
        if not min(torch.stack([pAp, rz]).tolist()) > 0.0:
            break
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rnorm = float(torch.sqrt(dot(r, r)))
        i += 1
    rel = rnorm / bnorm
    return CGResult(x=x, iters=i, rel_res=rel, converged=rel <= tol)
