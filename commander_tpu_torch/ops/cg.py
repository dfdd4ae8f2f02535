"""Preconditioned conjugate gradient as a Python loop.

Counterpart of commander_tpu.ops.cg (pcg, CGResult), with the same maxiter /
tol / min_iter semantics, including the initial A(x0). The loop reads the
residual norm back to the host for its convergence test EVERY iteration: at
the tutorial's scale one iteration is a full synthesis plus adjoint over
all bands, so a one-scalar device-to-host sync per iteration costs little
and never runs an iteration past convergence.

The solution is a tensor, or a vector object with the few ops the loop uses
(v + w, v - w, scalar * v, v.clone(), v.zeros_like()): the joint system's
sampling/joint.JointState (alms, template and source amplitudes) has them,
so the CG runs on it through its own dot with the same stopping rule and the
same two host reads per iteration.

check_every = N > 1 reads the residual and tests convergence only every
N-th iteration (and at maxiter), where hook(iteration, x) is called: the
JAX package's host-chunked CG (amplitude.sample_amplitudes_chunked) with
its dumps, as one loop with the same iterates.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class CGResult(NamedTuple):
    x: object               # a tensor, or a joint.JointState
    iters: int
    rel_res: float          # final |r|/|b|
    converged: bool


def _plain_dot(a, b):
    return torch.sum((a * b.conj()).real) if a.is_complex() \
        else torch.sum(a * b)


def pcg(A: Callable, b: torch.Tensor, x0=None, M_inv: Callable | None = None,
        dot: Callable = _plain_dot, tol: float = 1e-8, maxiter: int = 100,
        min_iter: int = 0, check_every: int = 1,
        hook: Callable | None = None) -> CGResult:
    """Solve A x = b with preconditioned CG; `dot` is the inner product
    under which A and M_inv are self-adjoint positive. b, x0: tensors or
    vector objects (see the module docstring); check_every, hook: see the
    module docstring."""
    if M_inv is None:
        M_inv = lambda r: r
    if x0 is not None:
        x = x0.clone()
    else:
        x = b.zeros_like() if hasattr(b, "zeros_like") \
            else torch.zeros_like(b)
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
        i += 1
        if i % check_every and i < maxiter:
            continue
        rnorm = float(torch.sqrt(dot(r, r)))
        if hook is not None and i % check_every == 0:
            hook(i, x)
    rel = rnorm / bnorm
    return CGResult(x=x, iters=i, rel_res=rel, converged=rel <= tol)
