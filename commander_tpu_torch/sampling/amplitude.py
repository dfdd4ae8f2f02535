"""Conditional Gaussian amplitude sampling via preconditioned CG (torch).

Counterpart of commander_tpu.sampling.amplitude for constant-mixing
systems, temperature only (S = 1) or polarized (S = 3: T by spin 0, (Q, U)
by spin 2). With A_b = B_b sum_c F_bc and prior S, solve
  (1 + S^1/2 A^T N^-1 A S^1/2) u = S^1/2 A^T N^-1 d
        + S^1/2 A^T N^-1/2 eta1 + eta2,   a = S^1/2 u,
which draws a ~ P(a | d, Cl) (the Wiener mean without eta1/eta2). The
per-band SHTs run as one batched transform over (band x Stokes). N is
diagonal per pixel, or carries 2x2 QU blocks (cov_qu); S is diagonal in
Stokes, or its symmetric root couples them per ell (cl_mat). The operator
and its parts take any leading batch axes in front of (C, S, nl, nm), which
one transform per call carries (the low-ell block's column chunks).

Preconditioners (the reference's CG_PRECOND_TYPE and CG_LMAX_PRECOND):
  diagonal   per-(Stokes, ell) ncomp x ncomp blocks with N^-1 by its
             harmonic mean (build_preconditioner);
  pseudoinv  N applied exactly in pixel space between the pseudo-inverses
             of the per-(Stokes, ell) design matrices
             (build_preconditioner_pseudoinv);
  low-ell    a dense inverse over every component's ell <= L modes, built
             from the operator of a degraded system, with the diagonal one
             above L (build_preconditioner_lowl, lowl_lmax >= 0).
Pixel-dependent mixing (F_pix, map-valued spectral indices) takes the
reference's pixel-space path through the operator and the rhs
(_forward_pixmix); every preconditioner reads the pixel mean F, as in the
JAX package. sample_amplitudes_chunked is the CG that
OUTPUT_EVERY_NTH_CG_ITERATION runs: the JAX package's chunked iteration as
one loop, its convergence tested where the chunks end. Band chunking is not
ported.
"""
from __future__ import annotations

import dataclasses
import functools
from functools import partial

import numpy as np
import torch

from ..model.cl import apply_sqrtS, sqrt_psd
from ..ops.cg import CGResult, pcg
from ..sphere import healpix, sht
from ..sphere.alm import alm_dot, random_alm_white, real_m0, triangle_mask
from ..utils.device import randn


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
    # pixel-dependent mixing (map-valued spectral indices): when set, the
    # operator takes the reference's Y -> F(p) -> YtW -> B path
    # (evalDiffuseBand, comm_diffuse_comp_mod.f90:2027-2109) in place of the
    # alm-space multiply by F, and F holds the pixel mean of F_pix, which
    # the preconditioners read (the reference's F_mean)
    F_pix: torch.Tensor | None = None         # (B, C, S, P)

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
    qu = torch.einsum("bpij,...bjp->...bip", blocks, m[..., 1:, :] * msk)
    return torch.cat([out[..., :1, :], qu * msk], dim=-2)


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
        out = torch.einsum("clxy,...cylm->...cxlm", sys.sqrtS_mat.to(u.dtype),
                           u)
        return real_m0(out * sys.tri)
    return real_m0(apply_sqrtS(sys.cl, u) * sys.tri)


def _project_bands(sys: AmplitudeSystem, plan, a: torch.Tensor):
    """a (..., C,S,nl,nm) -> band alms (..., B,S,nl,nm): alm_b = bl_b sum_c
    F_bc a_c."""
    alm_b = torch.einsum("bcs,...cslm->...bslm", sys.F.to(a.dtype), a)
    return alm_b * sys.bl[..., None]


def _project_bands_T(sys: AmplitudeSystem, plan, alm_b: torch.Tensor):
    """Transpose of _project_bands: (..., B,S,nl,nm) -> (..., C,S,nl,nm)."""
    alm_b = alm_b * sys.bl[..., None]
    return torch.einsum("bcs,...bslm->...cslm", sys.F.to(alm_b.dtype), alm_b)


def _synth(plan, alm_b: torch.Tensor) -> torch.Tensor:
    """Batched band synthesis: spin 0 for S = 1, T + spin 2 for S = 3."""
    if alm_b.shape[-3] == 3:
        return sht.alm2map_teb(plan, alm_b)
    return sht.alm2map(plan, alm_b)


def _synth_T(plan, maps: torch.Tensor) -> torch.Tensor:
    if maps.shape[-2] == 3:
        return sht.alm2map_teb_adjoint(plan, maps)
    return sht.alm2map_adjoint(plan, maps)


def _pix_weights(plan) -> torch.Tensor:
    """Per-pixel quadrature weight w(p) (the ring weight of the pixel's
    ring), (npix,)."""
    return plan.ring_weight[plan.pix_idx // plan.pmax]


def _forward_pixmix(sys: AmplitudeSystem, plan, a: torch.Tensor):
    """Band maps with pixel mixing: B_b YtW [sum_c F_bc(p) (Y a_c)(p)],
    (..., C, S, nl, nm) -> (..., B, S, P). YtW is the adjoint pair Yt(w .)
    of the synthesis, so that _forward_pixmix_T is its exact transpose.
    Three transforms: the components (batch C), the mixed bands' adjoint
    and their synthesis (batch B each)."""
    u = _synth(plan, a)                                 # (..., C, S, P)
    F = sys.F_pix.to(u.dtype)
    # one component at a time: no (B, C, S, P) temporary, nor a permuted
    # copy of F_pix (2.3 GB in float32 at nside 1024 with T/Q/U)
    s_b = F[:, 0] * u[..., 0:1, :, :]
    for c in range(1, F.shape[1]):
        s_b = s_b + F[:, c] * u[..., c:c + 1, :, :]     # (..., B, S, P)
    w = _pix_weights(plan).to(u.dtype)
    alm_b = _synth_T(plan, s_b * w) * sys.bl[..., None]
    return _synth(plan, alm_b)


def _forward_pixmix_T(sys: AmplitudeSystem, plan, g_b: torch.Tensor):
    """The exact adjoint of _forward_pixmix: (..., B, S, P) -> (..., C,
    S, nl, nm)."""
    alm_b = _synth_T(plan, g_b) * sys.bl[..., None]
    t_b = _synth(plan, alm_b) * _pix_weights(plan).to(g_b.dtype)
    F = sys.F_pix.to(t_b.dtype)
    v_c = F[0] * t_b[..., 0:1, :, :]
    for b in range(1, F.shape[0]):
        v_c = v_c + F[b] * t_b[..., b:b + 1, :, :]      # (..., C, S, P)
    return _synth_T(plan, v_c)


def apply_A(sys: AmplitudeSystem, plan, u: torch.Tensor) -> torch.Tensor:
    """(1 + S^1/2 A^T N^-1 A S^1/2) u: one batched Y and Yt over all bands
    (and over any leading axes of u (..., C, S, nl, nm)); with F_pix the
    pixel-mixing pair _forward_pixmix / _forward_pixmix_T."""
    a = _sqrtS(sys, u)
    if sys.F_pix is not None:
        m = apply_invN(sys, _forward_pixmix(sys, plan, a))
        return u + _sqrtS(sys, _forward_pixmix_T(sys, plan, m))
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
            eta1 = randn(sys.data.shape, generator, sys.data.dtype,
                         sys.data.device)
        w = w + apply_sqrt_invN(sys, eta1.to(w))
    if sys.F_pix is not None:
        rhs = _sqrtS(sys, _forward_pixmix_T(sys, plan, w))
    else:
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
    The blocks are built and inverted in float64 and cast to the system's
    dtype: with more components than bands (the tutorial's five on three)
    G has rank B < C, M is I plus a huge rank-B part, and its float32
    inverse was 5e-3 of the max off in the directions the data leave to
    the priors (entry_joint at nside 32). Returns apply(r)."""
    f64 = lambda x: x.to(torch.float64)
    kappa = torch.sum(sys.inv_rms2, dim=-1, dtype=torch.float64) \
        / (4.0 * np.pi)                                      # (B,S)
    sqcl = torch.sqrt(torch.clamp(f64(sys.cl), min=0.0))     # (C,S,nl)
    fb = torch.einsum("bcs,bsl->bcsl", f64(sys.F), f64(sys.bl))
    G = torch.einsum("bcsl,bdsl,bs->slcd", fb, fb, kappa)
    S_half = sqcl.permute(1, 2, 0)                           # (S,nl,C)
    C = sys.F.shape[1]
    M = torch.eye(C, dtype=G.dtype, device=G.device) \
        + S_half[..., :, None] * G * S_half[..., None, :]
    d = torch.sqrt(torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1),
                               min=1e-30))
    E = 1.0 / d
    Mn = M * E[..., :, None] * E[..., None, :]
    # M >= I is never singular: inv_ex leaves out the error check, which
    # would read the status back to the host
    M_inv = (torch.linalg.inv_ex(Mn).inverse * E[..., :, None]
             * E[..., None, :]).to(sys.bl.dtype)

    def apply(r):
        return torch.einsum("slcd,dslm->cslm", M_inv.to(r.dtype), r)

    return apply


def build_preconditioner_pseudoinv(sys: AmplitudeSystem, plan):
    """Pseudo-inverse preconditioner (the reference's CG_PRECOND_TYPE =
    pseudoinv, comm_diffuse_comp_mod.f90:1255-1293, 1560-1660, 2238-2380).

    Per (Stokes, ell) the tall design matrix
        U = [ alpha_b b_l F_bc sqrt(Cl_c) ]   (data rows, one per band)
            [ I_C                         ]   (prior rows)
    with alpha_b = sqrt(sum tau^2 / sum tau), tau the band's N^-1 diagonal,
    so that the CG operator is about U^T blockdiag(T_b, I) U with T_b the
    alm-normalized band noise. M^-1 = U^+ blockdiag(T_b^-1, I) (U^+)^T with
    T_b^-1 applied exactly in pixel space (Yt W N W Y times alpha^2; N = 0
    where N^-1 is 0, the unsolved pixels), which is what lets it follow
    strongly inhomogeneous noise. Each application costs one synthesis and
    one adjoint over all bands, as much as the operator. Returns
    apply(r)."""
    B, C = sys.F.shape[0], sys.F.shape[1]
    S, nl = sys.bl.shape[1], sys.bl.shape[2]
    dt = sys.bl.dtype
    tau = sys.inv_rms2                                   # (B,S,P)
    s1 = torch.sum(tau, dim=-1, dtype=torch.float64)
    s2 = torch.sum(tau * tau, dim=-1, dtype=torch.float64)
    alpha = torch.sqrt(torch.where(
        s1 > 0, s2 / torch.where(s1 > 0, s1, 1.0), 0.0)).to(dt)
    sqcl = torch.sqrt(torch.clamp(sys.cl, min=0.0))      # (C,S,nl)
    U_data = torch.einsum("bs,bsl,bcs,csl->slbc", alpha, sys.bl, sys.F,
                          sqcl)
    eye = torch.eye(C, dtype=dt, device=U_data.device).expand(S, nl, C, C)
    U = torch.cat([U_data, eye], dim=2)                  # (S,nl,B+C,C)
    # One batched pseudo-inverse. Its default cutoff (rtol = eps * max(B+C,
    # C)) is not jnp.linalg.pinv's, but U^T U = (data rows)^T (data rows) +
    # I has every eigenvalue >= 1, so every singular value of U is >= 1 and
    # neither cutoff drops one. It is taken in float64 whatever the
    # system's dtype (S nl matrices of (B+C) x C): a float32 SVD loses the
    # directions of the small singular values, and on entry_tod a float32
    # step then ends 3e-3 of the amplitudes' max and 0.27 index grid steps
    # from the float64 step after 30 CG iterations, against 1e-4 and 4e-4
    # with this one (PERF.md). (On a CUDA tensor torch's SVD reads its
    # status back to the host: one sync per build, none per application.)
    pinvU = torch.linalg.pinv(U.to(torch.float64)).to(dt)  # (S,nl,C,B+C)
    cdt = torch.complex128 if dt == torch.float64 else torch.complex64
    P_data = pinvU[..., :B].to(cdt)                      # (S,nl,C,B)
    P_prior = pinvU[..., B:]
    Q_prior = (P_prior @ P_prior.transpose(-1, -2)).to(cdt)   # (S,nl,C,C)
    inv = sys.inv_rms2
    pos = inv > 0
    N_pix = torch.where(pos, 1.0 / torch.where(pos, inv, 1.0), 0.0)
    # W Y, then N, then Yt W: one map of w^2 N
    wNw = N_pix * _pix_weights(plan).to(dt) ** 2
    alpha2 = (alpha ** 2)[..., None, None]

    def apply(r):
        r = real_m0(r * sys.tri)
        # data rows: (U^+)^T r, then T_b^-1, then U^+
        alm_b = torch.einsum("slcb,cslm->bslm", P_data, r)
        alm_b = _synth_T(plan, _synth(plan, alm_b) * wNw) * alpha2
        z = torch.einsum("slcb,bslm->cslm", P_data, alm_b)
        # prior rows: P_prior P_prior^T r
        z = z + torch.einsum("slcd,dslm->cslm", Q_prior, r)
        return real_m0(z * sys.tri)

    return apply


# ---------------------------------------------------------------------------
# Low-ell dense preconditioner (updateLowlPrecond,
# comm_diffuse_comp_mod.f90:5098-5259)
# ---------------------------------------------------------------------------

def _lowl_basis_size(C: int, S: int, L: int) -> int:
    return C * S * (L + 1) ** 2


def _lowl_indices(L: int):
    """(l of the m = 0 entries, l and m of the m > 0 entries) of the l <= L
    triangle, host int arrays."""
    mm, ll = np.meshgrid(np.arange(1, L + 1), np.arange(L + 1))
    keep = mm <= ll
    return np.arange(L + 1), ll[keep], mm[keep]


@functools.lru_cache(maxsize=None)
def _lowl_index_tensors(L: int, device: str):
    """_lowl_indices on `device`, made once (a copy per call would wait on
    the host)."""
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in _lowl_indices(L))


def pack_lowl(a: torch.Tensor, L: int) -> torch.Tensor:
    """Restrict alm (..., nl, nm) to the l <= L triangle, packed into a
    real vector (..., (L+1)^2) under which the eps metric is the plain dot:
    [m = 0: Re; m > 0: sqrt2 Re, sqrt2 Im]."""
    l0, ll, mm = _lowl_index_tensors(L, str(a.device))
    sq2 = np.sqrt(2.0)
    tail = a[..., ll, mm]
    return torch.cat([a[..., l0, 0].real, sq2 * tail.real,
                      sq2 * tail.imag], dim=-1)


def unpack_lowl(v: torch.Tensor, L: int, nl: int, nm: int,
                dtype) -> torch.Tensor:
    """Inverse of pack_lowl: (..., (L+1)^2) -> alm (..., nl, nm) of `dtype`,
    zero outside the l <= L triangle."""
    l0, ll, mm = _lowl_index_tensors(L, str(v.device))
    n0, nr = L + 1, ll.shape[0]
    out = torch.zeros(v.shape[:-1] + (nl, nm), dtype=dtype, device=v.device)
    out[..., l0, 0] = v[..., :n0].to(dtype)
    sq2 = np.sqrt(2.0)
    out[..., ll, mm] = torch.complex(v[..., n0:n0 + nr] / sq2,
                                     v[..., n0 + nr:] / sq2).to(dtype)
    return out


@functools.lru_cache(maxsize=8)
def _udgrade_tensor(nside_in: int, nside_out: int, device: str):
    """healpix.udgrade_indices on `device`, made once per pair."""
    return torch.as_tensor(healpix.udgrade_indices(nside_in, nside_out),
                           device=device)


@functools.lru_cache(maxsize=8)
def _lowres_plan(nside: int, lmax: int, spin2: bool, dtype, device: str):
    return sht.get_plan(nside, lmax, spin2=spin2, dtype=dtype, device=device)


def lowres_system(sys: AmplitudeSystem, nside_lo: int, lmax_lo: int):
    """Degrade a system to (nside_lo, lmax_lo) for the low-ell block, as the
    reference evaluates its low-ell operator on nside_chisq_lowres with
    invN_lowres (comm_diffuse_comp_mod.f90:5117-5160): N^-1 co-added over
    each low-res pixel's children, F_pix averaged over them, beams, spectra,
    the Stokes-coupled root and the ell window cut at lmax_lo, no data, no
    QU blocks. (The JAX version keeps ell_mask at the full lmax, which the
    port cuts like the spectra.)
    Returns (sys_lo, plan_lo), plan_lo in the system's dtype and on its
    device."""
    inv = sys.inv_rms2
    dev, dt = inv.device, inv.dtype
    nside = int(round(np.sqrt(inv.shape[-1] / 12)))
    idx = _udgrade_tensor(nside, nside_lo, str(dev))
    inv_rms2_lo = torch.sum(inv[..., idx], dim=-1)
    nl_lo = lmax_lo + 1
    cut = lambda t: None if t is None else t[..., :nl_lo]
    sys_lo = dataclasses.replace(
        sys, inv_rms2=inv_rms2_lo, inv_rms=torch.sqrt(inv_rms2_lo),
        bl=sys.bl[..., :nl_lo], cl=sys.cl[..., :nl_lo],
        data=torch.zeros_like(inv_rms2_lo),
        tri=torch.tril(torch.ones((nl_lo, nl_lo), dtype=dt, device=dev)),
        inv_qu=None, sqrt_inv_qu=None,
        sqrtS_mat=None if sys.sqrtS_mat is None
        else sys.sqrtS_mat[:, :nl_lo], ell_mask=cut(sys.ell_mask),
        F_pix=None if sys.F_pix is None
        else torch.mean(sys.F_pix[..., idx], dim=-1))
    plan_lo = _lowres_plan(nside_lo, lmax_lo, sys.bl.shape[1] == 3, dt,
                           str(dev))
    return sys_lo, plan_lo


def lowl_grid(L: int, nl: int, nside_lo: int | None = None):
    """(nside_lo, lmax_lo) of the degraded system for a low-ell block of
    l <= L on a system of nl ells: by default the smallest power of two at
    or above L, halved (at least 2), and lmax_lo = min(2 L, 3 nside_lo - 1,
    nl - 1), as the JAX package has it."""
    if nside_lo is None:
        nside_lo = max(2, int(2 ** np.ceil(np.log2(max(L, 2)))) // 2)
    return nside_lo, min(2 * L, 3 * nside_lo - 1, nl - 1)


# columns of the low-ell block per batched operator application
LOWL_CHUNK = 256


def lowl_block(sys: AmplitudeSystem, L: int, nside_lo: int | None = None,
               chunk: int = LOWL_CHUNK) -> torch.Tensor:
    """The dense low-ell block: the degraded system's CG operator on every
    unit vector of the l <= L real basis (pack_lowl), symmetrized, (n, n)
    with n = C S (L+1)^2 in the system's dtype. The columns go `chunk` at a
    time through one batched operator application (one transform per
    chunk)."""
    C, S = sys.F.shape[1], sys.bl.shape[1]
    nside_lo, lmax_lo = lowl_grid(L, sys.tri.shape[0], nside_lo)
    sys_lo, plan_lo = lowres_system(sys, nside_lo, lmax_lo)
    n = _lowl_basis_size(C, S, L)
    dt, dev = sys.bl.dtype, sys.bl.device
    cdt = torch.complex128 if dt == torch.float64 else torch.complex64
    rows = []
    for j0 in range(0, n, chunk):
        k = min(chunk, n - j0)
        V = torch.zeros((k, n), dtype=dt, device=dev)
        V[:, j0:j0 + k] = torch.eye(k, dtype=dt, device=dev)
        u = unpack_lowl(V.reshape(k, C, S, -1), L, lmax_lo + 1, lmax_lo + 1,
                        cdt)
        rows.append(pack_lowl(apply_A(sys_lo, plan_lo, u), L).reshape(k, n))
    M = torch.cat(rows).T               # column j: the operator on e_j
    return 0.5 * (M + M.T)


def _lowl_apply(sys: AmplitudeSystem, L: int, M_dense_inv: torch.Tensor,
                diag_apply):
    """The hybrid application: M_dense_inv on the l <= L modes, diag_apply
    above (applyLowlPrecond)."""
    C, S = sys.F.shape[1], sys.bl.shape[1]
    nl, nm = sys.tri.shape
    keep = torch.zeros((nl, 1), dtype=sys.bl.dtype, device=sys.bl.device)
    keep[: L + 1] = 1.0

    def apply(r):
        z = diag_apply(r)
        v = pack_lowl(r, L).reshape(-1)
        zl = (M_dense_inv.to(v.dtype) @ v).reshape(C, S, -1)
        zl = unpack_lowl(zl, L, nl, nm, r.dtype)
        return z * (1.0 - keep) + zl * keep

    return apply


def build_preconditioner_lowl(sys: AmplitudeSystem, plan, lmax_lowl: int,
                              nside_lo: int | None = None):
    """Hybrid preconditioner: the dense inverse of lowl_block over every
    component's modes with l <= lmax_lowl, the diagonal preconditioner
    above (the reference's CG_LMAX_PRECOND, updateLowlPrecond /
    applyLowlPrecond). The block is inverted in the system's dtype, without
    equilibration, as the JAX package does (on tutorial_tod's float32
    system the inverse is within 6e-6 of a float64 one, PERF.md), and the
    inverse is symmetrized, which the JAX package leaves out: an LU inverse
    is symmetric only to its rounding, and in float32 that asymmetry is
    above what the CG's float32 arithmetic tolerates of a preconditioner
    (chip_smoke.solve_checks). Returns apply(r)."""
    M = lowl_block(sys, lmax_lowl, nside_lo)
    # M >= I is never singular: inv_ex leaves out the host-side check
    M_inv = torch.linalg.inv_ex(M).inverse
    M_inv = 0.5 * (M_inv + M_inv.T)
    return _lowl_apply(sys, lmax_lowl, M_inv, build_preconditioner(sys, plan))


PRECONDS = {"diagonal": build_preconditioner,
            "pseudoinv": build_preconditioner_pseudoinv}


def build_precond(sys: AmplitudeSystem, plan, precond: str = "diagonal",
                  lowl_lmax: int = -1):
    """The preconditioner sample_amplitudes uses: the low-ell hybrid when
    lowl_lmax >= 0 (it wraps the diagonal one whatever precond says, as the
    JAX package does), else PRECONDS[precond]."""
    if precond not in PRECONDS:
        raise ValueError(f"unknown preconditioner {precond!r}; the port has "
                         f"{sorted(PRECONDS)}")
    if lowl_lmax >= 0:
        return build_preconditioner_lowl(sys, plan, lowl_lmax)
    return PRECONDS[precond](sys, plan)


def sample_amplitudes(sys: AmplitudeSystem, plan,
                      generator: torch.Generator | None = None,
                      eta1=None, eta2=None, tol=1e-8, maxiter=300,
                      precond: str = "diagonal", lowl_lmax: int = -1
                      ) -> tuple[torch.Tensor, CGResult]:
    """Draw a ~ P(a | d, Cl) (the Wiener mean without generator or draws)
    by preconditioned CG. precond: the reference's CG_PRECOND_TYPE,
    "diagonal" or "pseudoinv"; lowl_lmax >= 0 switches on the dense low-ell
    block (CG_LMAX_PRECOND) instead. Returns (a, CGResult)."""
    rhs = compute_rhs(sys, plan, generator, eta1, eta2)
    M_inv = build_precond(sys, plan, precond, lowl_lmax)
    res = pcg(partial(apply_A, sys, plan), rhs, M_inv=M_inv,
              dot=alm_dot, tol=tol, maxiter=maxiter)
    return _sqrtS(sys, res.x), res


def sample_amplitudes_chunked(sys: AmplitudeSystem, plan,
                              generator: torch.Generator | None = None,
                              eta1=None, eta2=None, tol=1e-8, maxiter=300,
                              precond: str = "diagonal", dump_every: int = 10,
                              dump_fn=None) -> tuple[torch.Tensor, CGResult]:
    """The draw of sample_amplitudes by the JAX package's chunked CG as
    run() calls it for OUTPUT_EVERY_NTH_CG_ITERATION (amplitude.py:573-647,
    run.py:1580-1604: chunks of dump_every iterations), as one pcg with its
    iterates: the relative residual is tested only at every dump_every-th
    iteration, where dump_fn(iteration, S^1/2 x) is called
    (comm_cr_mod.f90:275-321), and at maxiter. The JAX chunks exist for a
    TPU miscompile and device memory, which the card does not have (ROADMAP
    queue 1 item 3). Returns (a, CGResult)."""
    rhs = compute_rhs(sys, plan, generator, eta1, eta2)
    hook = None if dump_fn is None else (
        lambda i, x: dump_fn(i, _sqrtS(sys, x)))
    res = pcg(partial(apply_A, sys, plan), rhs,
              M_inv=PRECONDS[precond](sys, plan), dot=alm_dot, tol=tol,
              maxiter=maxiter, check_every=dump_every, hook=hook)
    return _sqrtS(sys, res.x), res
