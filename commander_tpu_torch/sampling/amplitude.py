"""Conditional Gaussian amplitude sampling via preconditioned CG (torch).

Counterpart of commander_tpu.sampling.amplitude for constant-mixing
systems, temperature only (S = 1) or polarized (S = 3: T by spin 0, (Q, U)
by spin 2). With A_b = B_b sum_c F_bc and prior S, solve
  (1 + S^1/2 A^T N^-1 A S^1/2) u = S^1/2 A^T N^-1 d
        + S^1/2 A^T N^-1/2 eta1 + eta2,   a = S^1/2 u,
which draws a ~ P(a | d, Cl) (the Wiener mean without eta1/eta2). The
per-band SHTs run as one batched transform over (band x Stokes). N is
diagonal per pixel, or carries 2x2 QU blocks (cov_qu); S is diagonal in
Stokes, or its symmetric root couples them per ell (cl_mat). Pixel-dependent
mixing, band chunking and the pseudo-inverse and low-ell preconditioners of
the reference are not ported.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from ..model.cl import apply_sqrtS, sqrt_psd
from ..ops.cg import CGResult, pcg
from ..sphere import sht
from ..sphere.alm import alm_dot, random_alm_white, real_m0, triangle_mask


@dataclasses.dataclass
class AmplitudeSystem:
    """All tensors defining one CG amplitude solve.

    Shapes: nband=B, ncomp=C, nmaps=S (1 or 3), npix=P, nl=lmax+1, nm=nl."""
    F: torch.Tensor          # (B, C, S) mixing matrix in band units
    bl: torch.Tensor         # (B, S, nl) beam per band
    inv_rms2: torch.Tensor   # (B, S, P) = mask / rms^2  (N^-1 diagonal)
    inv_rms: torch.Tensor    # (B, S, P) = mask / rms    (N^-1/2 diagonal)
    cl: torch.Tensor         # (C, S, nl) prior spectra
    data: torch.Tensor       # (B, S, P) band maps
    tri: torch.Tensor        # (nl, nm) triangle mask
    # QU pixel covariance: when set, the Q, U rows of N^-1 and N^-1/2 use
    # these 2x2 blocks in place of the diagonal (T stays diagonal)
    inv_qu: torch.Tensor | None = None        # (B, P, 2, 2)
    sqrt_inv_qu: torch.Tensor | None = None   # (B, P, 2, 2)
    # Stokes-coupled prior: the symmetric root of the per-(comp, ell) Stokes
    # covariance (TE coupling). When set it REPLACES the diagonal sqrt(cl)
    # multiply; cl then holds the matching diagonal (the preconditioner
    # reads it)
    sqrtS_mat: torch.Tensor | None = None     # (C, nl, S, S)
    # per-component ell window, multiplied into the prior spectrum each time
    # Cl is re-evaluated (zero prior power confines a = S^1/2 u exactly)
    ell_mask: torch.Tensor | None = None      # (C, S, nl)

    def to(self, device) -> "AmplitudeSystem":
        kw = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        return AmplitudeSystem(**{k: None if v is None else v.to(device)
                                  for k, v in kw.items()})


def apply_invN(sys: AmplitudeSystem, m: torch.Tensor) -> torch.Tensor:
    """N^-1 m, with the QU covariance blocks where the system has them."""
    return _apply_noise(sys.inv_rms2, sys.inv_qu, m)


def apply_sqrt_invN(sys: AmplitudeSystem, m: torch.Tensor) -> torch.Tensor:
    """N^-1/2 m, with the QU covariance blocks where the system has them."""
    return _apply_noise(sys.inv_rms, sys.sqrt_inv_qu, m)


def _apply_noise(diag, blocks, m):
    out = m * diag
    if blocks is None:
        return out
    msk = (diag[:, 1:] > 0).to(m.dtype)
    qu = torch.einsum("bpij,bjp->bip", blocks, m[:, 1:] * msk)
    return torch.cat([out[:, :1], qu * msk], dim=1)


def build_system(F, bl, rms, cl, data, mask=None, cov_qu=None, cl_mat=None,
                 ell_mask=None) -> AmplitudeSystem:
    """Tensors (or arrays) in; the system keeps data's dtype and device.

    mask: optional (B, S, P), pixels at or below 0.5 are dropped. cov_qu:
    optional (B, P, 2, 2) QU covariance per pixel. cl_mat: optional (C, nl,
    S, S) Stokes-coupled prior covariance; cl is then overridden by its
    diagonal and the operator uses the symmetric matrix root. ell_mask:
    optional (C, S, nl) window on the prior."""
    data = torch.as_tensor(data)
    dt, dev = data.dtype, data.device
    t = lambda a: torch.as_tensor(np.asarray(a) if not isinstance(
        a, torch.Tensor) else a, device=dev).to(dt)
    F = t(F)
    if F.ndim == 2:
        F = F[..., None].repeat(1, 1, data.shape[1])
    rms = t(rms)
    good = torch.isfinite(rms) & (rms > 0)
    if mask is not None:
        good = good & (t(mask) > 0.5)
    safe = torch.where(good, rms, torch.ones_like(rms))
    inv_rms = torch.where(good, 1.0 / safe, torch.zeros_like(rms))
    bl = t(bl)
    nl = bl.shape[-1]
    tri = torch.as_tensor(triangle_mask(nl, nl), dtype=dt, device=dev)
    inv_qu = sqrt_inv_qu = None
    if cov_qu is not None:
        inv_qu = torch.linalg.inv(t(cov_qu))
        sqrt_inv_qu = torch.linalg.cholesky(inv_qu).transpose(-1, -2) \
            .contiguous()
    sqrtS_mat = None
    if cl_mat is not None:
        cl_mat = t(cl_mat)
        sqrtS_mat = sqrt_psd(cl_mat)
        cl = torch.diagonal(cl_mat, dim1=-2, dim2=-1).permute(0, 2, 1)
    cl = t(cl)
    if ell_mask is not None:
        ell_mask = t(ell_mask)
        cl = cl * ell_mask
    return AmplitudeSystem(F=F, bl=bl, inv_rms2=inv_rms ** 2,
                           inv_rms=inv_rms, cl=cl, data=data, tri=tri,
                           inv_qu=inv_qu, sqrt_inv_qu=sqrt_inv_qu,
                           sqrtS_mat=sqrtS_mat, ell_mask=ell_mask)


def _sqrtS(sys: AmplitudeSystem, u: torch.Tensor) -> torch.Tensor:
    # real_m0 keeps the solve in the one-dof-per-(l, m=0) subspace of real
    # fields, on every operator and rhs evaluation
    if sys.sqrtS_mat is not None:
        # Stokes-coupled symmetric root; self-adjoint, so the same product
        # serves both S^1/2 applications in the CG operator
        out = torch.einsum("clxy,cylm->cxlm", sys.sqrtS_mat.to(u.dtype), u)
        return real_m0(out * sys.tri)
    return real_m0(apply_sqrtS(sys.cl, u) * sys.tri)


def _project_bands(sys: AmplitudeSystem, plan, a: torch.Tensor):
    """a (C,S,nl,nm) -> band alms (B,S,nl,nm): alm_b = bl_b sum_c F_bc a_c."""
    alm_b = torch.einsum("bcs,cslm->bslm", sys.F.to(a.dtype), a)
    return alm_b * sys.bl[..., None]


def _project_bands_T(sys: AmplitudeSystem, plan, alm_b: torch.Tensor):
    """Transpose of _project_bands: (B,S,nl,nm) -> (C,S,nl,nm)."""
    alm_b = alm_b * sys.bl[..., None]
    return torch.einsum("bcs,bslm->cslm", sys.F.to(alm_b.dtype), alm_b)


def _synth(plan, alm_b: torch.Tensor) -> torch.Tensor:
    """Batched band synthesis: spin 0 for S = 1, T + spin 2 for S = 3."""
    if alm_b.shape[-3] == 3:
        return sht.alm2map_teb(plan, alm_b)
    return sht.alm2map(plan, alm_b)


def _synth_T(plan, maps: torch.Tensor) -> torch.Tensor:
    if maps.shape[-2] == 3:
        return sht.alm2map_teb_adjoint(plan, maps)
    return sht.alm2map_adjoint(plan, maps)


def apply_A(sys: AmplitudeSystem, plan, u: torch.Tensor) -> torch.Tensor:
    """(1 + S^1/2 A^T N^-1 A S^1/2) u: one batched Y and Yt over all bands."""
    a = _sqrtS(sys, u)
    m = _synth(plan, _project_bands(sys, plan, a))      # batch (B, S)
    r_b = _synth_T(plan, apply_invN(sys, m))
    return u + _sqrtS(sys, _project_bands_T(sys, plan, r_b))


def compute_rhs(sys: AmplitudeSystem, plan,
                generator: torch.Generator | None = None,
                eta1: torch.Tensor | None = None,
                eta2: torch.Tensor | None = None) -> torch.Tensor:
    """S^1/2 A^T N^-1 d, plus the fluctuation terms S^1/2 A^T N^-1/2 eta1 +
    eta2 when a generator is given or the draws are passed in.

    eta1 (B, S, P) ~ N(0, 1); eta2 (C, S, nl, nm) a white alm draw
    (random_alm_white), masked to the triangle here."""
    fluct = generator is not None or eta1 is not None
    w = apply_invN(sys, sys.data)
    if fluct:
        if eta1 is None:
            eta1 = torch.randn(sys.data.shape, generator=generator,
                               dtype=sys.data.dtype, device=sys.data.device)
        w = w + apply_sqrt_invN(sys, eta1.to(w))
    rhs = _sqrtS(sys, _project_bands_T(sys, plan, _synth_T(plan, w)))
    if fluct:
        if eta2 is None:
            eta2 = random_alm_white(generator, tuple(rhs.shape),
                                    sys.data.dtype, sys.data.device)
        rhs = rhs + eta2.to(rhs) * sys.tri
    return rhs


def build_preconditioner(sys: AmplitudeSystem, plan):
    """Block-diagonal preconditioner: per (Stokes, ell) ncomp x ncomp blocks
    M = I + S^1/2 F^T B^T <N^-1> B F S^1/2 with N^-1 approximated by its
    harmonic diagonal kappa_b = sum_p invN_bp / (4 pi), inverted as one
    batch after Jacobi equilibration (the S^1/2 G S^1/2 entries span ~1e10
    at production lmax; a plain f32 inverse loses the small directions).
    Returns apply(r)."""
    kappa = torch.sum(sys.inv_rms2, dim=-1) / (4.0 * np.pi)   # (B,S)
    sqcl = torch.sqrt(torch.clamp(sys.cl, min=0.0))          # (C,S,nl)
    fb = torch.einsum("bcs,bsl->bcsl", sys.F, sys.bl)
    G = torch.einsum("bcsl,bdsl,bs->slcd", fb, fb, kappa)
    S_half = sqcl.permute(1, 2, 0)                           # (S,nl,C)
    C = sys.F.shape[1]
    M = torch.eye(C, dtype=G.dtype, device=G.device) \
        + S_half[..., :, None] * G * S_half[..., None, :]
    d = torch.sqrt(torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1),
                               min=1e-30))
    E = 1.0 / d
    Mn = M * E[..., :, None] * E[..., None, :]
    M_inv = torch.linalg.inv(Mn) * E[..., :, None] * E[..., None, :]

    def apply(r):
        return torch.einsum("slcd,dslm->cslm", M_inv.to(r.dtype), r)

    return apply


def sample_amplitudes(sys: AmplitudeSystem, plan,
                      generator: torch.Generator | None = None,
                      eta1=None, eta2=None, tol=1e-8, maxiter=300
                      ) -> tuple[torch.Tensor, CGResult]:
    """Draw a ~ P(a | d, Cl) (the Wiener mean without generator or draws),
    by CG with the diagonal preconditioner. Returns (a, CGResult)."""
    rhs = compute_rhs(sys, plan, generator, eta1, eta2)
    M_inv = build_preconditioner(sys, plan)
    res = pcg(partial(apply_A, sys, plan), rhs, M_inv=M_inv,
              dot=alm_dot, tol=tol, maxiter=maxiter)
    return _sqrtS(sys, res.x), res
