"""Joint amplitude system: diffuse alms, template amplitudes and point-source
amplitudes in one CG solve (torch).

Counterpart of commander_tpu.sampling.joint (the reference's full solution
vector [diffuse alms | template amps | ptsrc amps], cr_amp2x / cr_x2amp,
with the md, template and ptsrc component classes), all of it;
febecop_stamp_ptsrc reads its beam file through io/hdf5.py.

The port's forms, and why:
  TemplateSet  only the non-zero (band, Stokes) planes of the JAX package's
               dense (T, B, S, P) maps: planes (K, P), with the template
               (rows) and the flat band * S + Stokes slot (slots) of each
               plane. An md row lives on one band's T plane and relquad on
               each band's T plane, so the tutorial's 13 rows keep 15 of the
               dense form's 117 planes (0.76 GB in float32 at nside 1024
               against 5.9 GB). The forward product is one GEMM of the
               planes, the adjoint one dot per plane: the JAX einsums' sums
               without the zero planes.
  PtsrcSet     the JAX fields, plus the flat (band, Stokes, pixel) indices
               of the stamps sorted once when the set is built (a stable
               sort, so each pixel's run keeps the stamps' order). The
               forward scatter sums each run with torch.segment_reduce and
               writes each pixel once: no float atomics (index_add_ on the
               card adds overlapping stamps in a varying order), and two
               seeded calls give the same bits.
  JointState   (a, t, p) with the vector ops ops/cg.pcg uses (v + w, v - w,
               scalar * v, clone, zeros_like), so the CG iterates it as it
               iterates a tensor, with the same two host reads per
               iteration.
With pixel mixing (sys.F_pix) the diffuse rows take amplitude.py's
pixel-mixing pair (_forward_pixmix and its transpose); the preconditioner
keeps the pixel mean F, as in the JAX package.

Draws: compute_rhs_joint takes them from a torch.Generator in the
reference's order (joint.py:294-312: eta1 over the data, eta2 over the
alms, one normal per template, one per source), or ready-made (eta1, eta2,
eta_t, eta_p), which the parity tests regenerate from the JAX key.

Numerics: the template normal matrix G (a pinned row has 1e12 on its
diagonal) and the source diagonal are built and inverted in float64 and
cast back to the system's dtype. The noise of the joint operator is the
diagonal inv_rms2, as in the JAX package, which ignores QU covariance
blocks there; the port refuses a system that has them rather than drop
them. The joint system takes the diagonal diffuse preconditioner only, as
the JAX package does (gibbs_step refuses another).
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial

import numpy as np
import torch

from ..ops.cg import CGResult, pcg
from ..ops.powell import powell
from ..sphere import healpix
from ..sphere.alm import alm_dot, random_alm_white
from ..utils.device import randn, resolve_device
from . import amplitude as amp
from .specind import _cdf_invert, _uniform


@dataclasses.dataclass(frozen=True)
class TemplateSet:
    """Fixed pixel-space templates with one amplitude each, as their non-zero
    planes: plane k is the map planes[k] of the template onehot[k] marks, on
    the flat (band, Stokes) slot slots[k] = b * nmaps + s, zero elsewhere.

    sel (B*S, K) is the 0/1 matrix of the slots and onehot (K, T) that of
    the templates (made by make_template_set). prior_istd 0 is a flat
    prior."""
    planes: torch.Tensor      # (K, P)
    slots: torch.Tensor       # (K,) int64
    sel: torch.Tensor         # (B*S, K)
    onehot: torch.Tensor      # (K, T)
    nband: int
    nmaps: int
    prior_mean: torch.Tensor  # (T,)
    prior_istd: torch.Tensor  # (T,)

    @property
    def ntemp(self) -> int:
        return self.onehot.shape[1]

    def dense(self) -> torch.Tensor:
        """The JAX package's (T, B, S, P) form (for tests and convert)."""
        T, K, P = self.ntemp, self.planes.shape[0], self.planes.shape[1]
        out = torch.zeros((T, self.nband * self.nmaps, P),
                          dtype=self.planes.dtype, device=self.planes.device)
        rows = torch.argmax(self.onehot, dim=1)
        for k in range(K):
            out[int(rows[k]), int(self.slots[k])] += self.planes[k]
        return out.reshape(T, self.nband, self.nmaps, P)


def make_template_set(planes, rows, slots, ntemp: int, nband: int,
                      nmaps: int, prior_mean=None, prior_istd=None,
                      dtype=torch.float64, device=None) -> TemplateSet:
    """A TemplateSet from its planes (K, P) and each plane's template row and
    flat band * nmaps + Stokes slot (host ints or arrays); the priors default
    to flat (mean 0, istd 0). (row, slot) pairs must be distinct."""
    device = resolve_device(device)
    rows = np.asarray(rows, np.int64).reshape(-1)
    slots = np.asarray(slots, np.int64).reshape(-1)
    if len(set(zip(rows.tolist(), slots.tolist()))) != rows.size:
        raise ValueError("a template has two planes on one (band, Stokes)")
    K = rows.size
    sel = np.zeros((nband * nmaps, K))
    sel[slots, np.arange(K)] = 1.0
    onehot = np.zeros((K, ntemp))
    onehot[np.arange(K), rows] = 1.0
    t = lambda a: torch.as_tensor(np.asarray(a)).to(device, dtype)
    zero = np.zeros(ntemp)
    return TemplateSet(
        planes=torch.as_tensor(planes).to(device, dtype),
        slots=torch.as_tensor(slots, device=device), sel=t(sel),
        onehot=t(onehot), nband=nband, nmaps=nmaps,
        prior_mean=t(zero if prior_mean is None else prior_mean),
        prior_istd=t(zero if prior_istd is None else prior_istd))


def templates_from_dense(maps, prior_mean=None, prior_istd=None,
                         dtype=None, device=None) -> TemplateSet:
    """The TemplateSet of the JAX package's dense (T, B, S, P) maps (array or
    tensor): every (template, band, Stokes) plane with a non-zero pixel."""
    maps = np.asarray(maps.cpu() if isinstance(maps, torch.Tensor)
                      else maps)
    T, B, S, P = maps.shape
    nz = np.argwhere(np.any(maps != 0, axis=-1))        # (K, 3): t, b, s
    dtype = dtype or (torch.float64 if maps.dtype == np.float64
                      else torch.float32)
    return make_template_set(
        maps[nz[:, 0], nz[:, 1], nz[:, 2]], nz[:, 0], nz[:, 1] * S + nz[:, 2],
        T, B, S, prior_mean, prior_istd, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class PtsrcSet:
    """Point-source catalog with per-band postage stamps.

    pix (nsrc, npatch) RING pixel indices, stamp (B, S, nsrc, npatch) the
    response of a unit amplitude. flat (B*S*nsrc*npatch,) is the flat (band,
    Stokes, pixel) index of each stamp value in stamp's order; order, its
    stable argsort; uniq, the distinct sorted indices; offsets (U + 1,),
    each run's start in the sorted order (made by make_ptsrc_set)."""
    pix: torch.Tensor
    stamp: torch.Tensor
    prior_mean: torch.Tensor
    prior_istd: torch.Tensor
    npix: int
    flat: torch.Tensor
    order: torch.Tensor
    uniq: torch.Tensor
    offsets: torch.Tensor


def make_ptsrc_set(pix, stamp, npix: int, prior_mean=None, prior_istd=None,
                   dtype=None, device=None) -> PtsrcSet:
    """A PtsrcSet from pix (nsrc, npatch) and stamp (B, S, nsrc, npatch)
    (arrays or tensors) on maps of npix pixels, its scatter's runs sorted
    once here (one host read); priors default to flat."""
    device = resolve_device(device)
    stamp = torch.as_tensor(np.asarray(stamp) if not isinstance(
        stamp, torch.Tensor) else stamp)
    stamp = stamp.to(device, dtype or stamp.dtype)
    pix = torch.as_tensor(np.asarray(pix) if not isinstance(
        pix, torch.Tensor) else pix).to(device, torch.int64)
    B, S = stamp.shape[0], stamp.shape[1]
    flat = ((torch.arange(B * S, device=device) * npix)[:, None]
            + pix.reshape(-1)[None, :]).reshape(-1)
    order = torch.argsort(flat, stable=True)
    uniq, counts = torch.unique_consecutive(flat[order], return_counts=True)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    nsrc = pix.shape[0]
    t = lambda v: torch.zeros(nsrc, dtype=stamp.dtype, device=device) \
        if v is None else torch.as_tensor(v).to(device, stamp.dtype)
    return PtsrcSet(pix=pix, stamp=stamp, prior_mean=t(prior_mean),
                    prior_istd=t(prior_istd), npix=int(npix), flat=flat,
                    order=order, uniq=uniq, offsets=offsets)


@dataclasses.dataclass
class JointState:
    """The joint solution vector: diffuse (C, S, nl, nm) complex alms, and
    template (T,) and source (nsrc,) amplitudes where the system has them,
    with the vector ops pcg uses."""
    a: torch.Tensor
    t: torch.Tensor | None = None
    p: torch.Tensor | None = None

    def _zip(self, other, f) -> "JointState":
        g = lambda x, y: None if x is None else f(x, y)
        return JointState(f(self.a, other.a), g(self.t, other.t),
                          g(self.p, other.p))

    def _each(self, f) -> "JointState":
        g = lambda x: None if x is None else f(x)
        return JointState(f(self.a), g(self.t), g(self.p))

    def __add__(self, other):
        return self._zip(other, torch.add)

    def __sub__(self, other):
        return self._zip(other, torch.sub)

    def __mul__(self, c):
        return self._each(lambda x: x * c)

    __rmul__ = __mul__

    def clone(self) -> "JointState":
        return self._each(torch.clone)

    def zeros_like(self) -> "JointState":
        return self._each(torch.zeros_like)


def make_md_templates(nside: int, nband: int, nmaps: int = 1,
                      dtype=torch.float64, device=None) -> TemplateSet:
    """Monopole + dipole templates [1, x, y, z] per band on its T plane (rows
    4 b .. 4 b + 3), flat priors (the reference's md component, one per
    band)."""
    vec = healpix.pix2vec_ring(nside)
    base = np.concatenate([np.ones((1, vec.shape[0])), vec.T], axis=0)
    planes = np.concatenate([base] * nband, axis=0)         # (4 B, P)
    rows = np.arange(4 * nband)
    return make_template_set(planes, rows, (rows // 4) * nmaps, 4 * nband,
                             nband, nmaps, dtype=dtype, device=device)


def gaussian_stamp_ptsrc(nside: int, src_pix, F_src, bl_fwhm_arcmin,
                         nmaps: int = 1, npatch: int = 64,
                         dtype=torch.float64, device=None) -> PtsrcSet:
    """Gaussian beam stamps on the npatch nearest pixels of each source
    (host numpy, as the JAX package builds them, so that argpartition picks
    the same pixels), normalized to unit integral and scaled by F_src (B,
    nsrc), the band response of a unit amplitude; T plane only."""
    vec = healpix.pix2vec_ring(nside)
    F_src = np.asarray(F_src)
    nsrc, nband = len(src_pix), F_src.shape[0]
    pix = np.zeros((nsrc, npatch), np.int64)
    stamp = np.zeros((nband, nmaps, nsrc, npatch))
    omega = 4 * np.pi / (12 * nside * nside)
    for i, sp in enumerate(src_pix):
        d = vec @ vec[sp]
        idx = np.argpartition(-d, npatch)[:npatch]
        pix[i] = idx
        theta = np.arccos(np.clip(d[idx], -1, 1))
        for b in range(nband):
            sig = np.deg2rad(bl_fwhm_arcmin[b] / 60) / np.sqrt(8 * np.log(2))
            prof = np.exp(-0.5 * (theta / sig) ** 2)
            prof /= max(prof.sum() * omega, 1e-300)
            stamp[b, 0, i] = F_src[b, i] * prof
    return make_ptsrc_set(pix, stamp, 12 * nside * nside, dtype=dtype,
                          device=device)


def febecop_stamp_ptsrc(path: str, nside: int, src_theta, src_phi, F_src,
                        nside_febecop: int, band_labels=None,
                        npatch: int = 64, nmaps: int = 1,
                        dtype=torch.float64, device=None) -> PtsrcSet:
    """Per-source FEBeCoP effective-beam stamps from the reference's HDF
    layout (read_febecop_beam, comm_ptsrc_comp_mod.f90:796-880), as a
    PtsrcSet on maps at `nside`: group [<band label>/]<centre pixel>, the
    centre ang2pix_ring(nside_febecop, source) (:815), with datasets
    `indices` (RING pixels at nside_febecop) and `values` (the response).
    Read with io/hdf5.py (contiguous datasets: what h5py writes by
    default). At another nside the stamp moves by NEST relations: the
    children's mean into their parent, or the value copied to each child.
    Per source one pixel patch shared by the bands, the npatch pixels of
    largest summed |response|; each band's stamp normalized to unit
    integral and scaled by F_src (B, nsrc); T plane only; flat priors.
    Host numpy, as the JAX package builds it."""
    from ..io.hdf5 import File, Group

    src_theta = np.asarray(src_theta, np.float64)
    F_src = np.asarray(F_src)
    nsrc, nband = len(src_theta), F_src.shape[0]
    pix_out = np.zeros((nsrc, npatch), np.int32)
    stamp = np.zeros((nband, nmaps, nsrc, npatch))
    omega = 4 * np.pi / (12 * nside * nside)
    centers = healpix.ang2pix_ring(nside_febecop, src_theta,
                                   np.asarray(src_phi, np.float64))
    f = File(path, "r")
    try:
        for i in range(nsrc):
            per_band = []
            for b in range(nband):
                grp = f.root if band_labels is None \
                    else f.get(str(band_labels[b]))
                g = grp.members.get(str(int(centers[i]))) \
                    if isinstance(grp, Group) else None
                if g is None:
                    raise KeyError(f"{path}: no stamp for pixel "
                                   f"{int(centers[i])}")
                ind = f.read_dataset(g.members["indices"])
                val = f.read_dataset(g.members["values"]).astype(np.float64)
                if nside_febecop != nside:
                    ind, val = _febecop_udgrade(ind, val, nside_febecop,
                                                nside)
                per_band.append((ind, val))
            allpix = np.unique(np.concatenate([pb[0] for pb in per_band]))
            score = np.zeros(len(allpix))
            col = {p: j for j, p in enumerate(allpix)}
            for ind, val in per_band:
                for p, v in zip(ind, val):
                    score[col[p]] += abs(v)
            k = min(npatch, len(allpix))
            top = allpix[np.argpartition(-score, k - 1)[:k]] \
                if k < len(allpix) else allpix
            pix_out[i, :len(top)] = top.astype(np.int32)
            lut = {p: j for j, p in enumerate(top)}
            for b, (ind, val) in enumerate(per_band):
                v = np.zeros(npatch)
                for p, x in zip(ind, val):
                    j = lut.get(p)
                    if j is not None:
                        v[j] = x
                v /= max(v.sum() * omega, 1e-300)
                stamp[b, 0, i] = F_src[b, i] * v
    finally:
        f.close()
    return make_ptsrc_set(pix_out, stamp, 12 * nside * nside,
                          prior_mean=np.zeros(nsrc),
                          prior_istd=np.zeros(nsrc), dtype=dtype,
                          device=device)


def _febecop_udgrade(ind, val, nside_in: int, nside_out: int):
    """A stamp's (RING pixels, values) from nside_in to nside_out by NEST
    relations: degraded, each parent the mean of its children's values
    over all its children; upgraded, each child its parent's value."""
    r2n = healpix.ring2nest_table(nside_in)
    n2r = healpix.nest2ring_table(nside_out)
    if nside_out < nside_in:
        q = (nside_in // nside_out) ** 2
        uniq, inv = np.unique(r2n[ind] // q, return_inverse=True)
        acc = np.zeros(len(uniq))
        np.add.at(acc, inv, val)
        return n2r[uniq], acc / q
    q = (nside_out // nside_in) ** 2
    base = r2n[ind][:, None] * q + np.arange(q)
    return n2r[base.reshape(-1)], np.repeat(val, q)


# ---------------------------------------------------------------------------
# Pixel-space projections
# ---------------------------------------------------------------------------

def _templates_fwd(ts: TemplateSet, t: torch.Tensor) -> torch.Tensor:
    """amps (T,) -> maps (B, S, P): one GEMM of the planes by the (B*S, K)
    matrix of each plane's amplitude on its slot."""
    W = ts.sel.to(t.dtype) * (ts.onehot.to(t.dtype) @ t)[None, :]
    out = W @ ts.planes.to(t.dtype)
    return out.reshape(ts.nband, ts.nmaps, -1)


def _templates_adj(ts: TemplateSet, m: torch.Tensor) -> torch.Tensor:
    """maps (B, S, P) -> amps (T,): each plane's dot with its slot's map,
    summed into its template."""
    rows = m.reshape(ts.nband * ts.nmaps, -1).index_select(0, ts.slots)
    g = torch.sum(rows * ts.planes.to(m.dtype), dim=-1)          # (K,)
    return ts.onehot.to(m.dtype).T @ g


def _ptsrc_fwd(ps: PtsrcSet, p: torch.Tensor, npix: int) -> torch.Tensor:
    """amps (nsrc,) -> maps (B, S, P): the stamps scaled by p, each pixel's
    run summed in the stamps' order and written once."""
    if npix != ps.npix:
        raise ValueError(f"the sources' runs were sorted for {ps.npix} "
                         f"pixels, not {npix}")
    B, S = ps.stamp.shape[0], ps.stamp.shape[1]
    vals = (ps.stamp * p[None, None, :, None]).reshape(-1)
    sums = torch.segment_reduce(vals[ps.order], "sum", offsets=ps.offsets,
                                axis=0, unsafe=True)
    out = torch.zeros(B * S * npix, dtype=vals.dtype, device=vals.device)
    out.index_copy_(0, ps.uniq, sums)
    return out.reshape(B, S, npix)


def _ptsrc_adj(ps: PtsrcSet, m: torch.Tensor) -> torch.Tensor:
    """maps (B, S, P) -> amps (nsrc,) (flat gather)."""
    gath = m.reshape(-1)[ps.flat].reshape(ps.stamp.shape)
    return torch.einsum("bsnk,bsnk->n", gath, ps.stamp.to(m.dtype))


def extra_sky(ts, ps, t, p, npix: int):
    """The template and source maps (B, S, P) of amplitudes t and p, or None
    where there are neither (the md / ptsrc / template signal beside the
    diffuse sky)."""
    out = None
    if ts is not None and t is not None:
        out = _templates_fwd(ts, t)
    if ps is not None and p is not None:
        ps_sky = _ptsrc_fwd(ps, p, npix)
        out = ps_sky if out is None else out + ps_sky
    return out


# ---------------------------------------------------------------------------
# Joint operator / RHS / preconditioner / solve
# ---------------------------------------------------------------------------

def joint_dot(x: JointState, y: JointState) -> torch.Tensor:
    d = alm_dot(x.a, y.a)
    if x.t is not None:
        d = d + torch.sum(x.t * y.t)
    if x.p is not None:
        d = d + torch.sum(x.p * y.p)
    return d


def _diagonal_noise(sys: amp.AmplitudeSystem):
    if sys.inv_qu is not None:
        raise NotImplementedError(
            "the joint system's noise is diagonal: the JAX package ignores "
            "QU covariance blocks there, and the port refuses them")


def _band_maps(sys, plan, x: JointState, ts, ps) -> torch.Tensor:
    a = amp._sqrtS(sys, x.a)
    if sys.F_pix is not None:
        # pixel mixing rides through the joint system as in the
        # reference's cr_matmulA, every component class in one matvec
        m = amp._forward_pixmix(sys, plan, a)
    else:
        m = amp._synth(plan, amp._project_bands(sys, plan, a))
    if ts is not None:
        m = m + _templates_fwd(ts, x.t)
    if ps is not None:
        m = m + _ptsrc_fwd(ps, x.p, m.shape[-1])
    return m


def _band_maps_adj(sys, plan, m, ts, ps) -> JointState:
    if sys.F_pix is not None:
        a = amp._sqrtS(sys, amp._forward_pixmix_T(sys, plan, m))
    else:
        a = amp._sqrtS(sys, amp._project_bands_T(sys, plan,
                                                 amp._synth_T(plan, m)))
    t = _templates_adj(ts, m) if ts is not None else None
    p = _ptsrc_adj(ps, m) if ps is not None else None
    return JointState(a=a, t=t, p=p)


def apply_A_joint(sys, plan, ts, ps, x: JointState) -> JointState:
    """The joint operator: 1 + S^1/2 A^T N^-1 A S^1/2 on the alms, the
    templates' and sources' projections beside them, their prior precisions
    and a 1e-12 ridge on t and p (definite where a prior is flat)."""
    _diagonal_noise(sys)
    m = _band_maps(sys, plan, x, ts, ps) * sys.inv_rms2
    r = _band_maps_adj(sys, plan, m, ts, ps)
    a = x.a + r.a
    t = None if ts is None else x.t * ts.prior_istd ** 2 + r.t
    p = None if ps is None else x.p * ps.prior_istd ** 2 + r.p
    if ts is not None:
        t = t + 1e-12 * x.t
    if ps is not None:
        p = p + 1e-12 * x.p
    return JointState(a=a, t=t, p=p)


def compute_rhs_joint(sys, plan, ts, ps,
                      generator: torch.Generator | None = None, eta1=None,
                      eta2=None, eta_t=None, eta_p=None) -> JointState:
    """The joint right-hand side: A^T N^-1 d and the priors' mean terms,
    plus the fluctuation terms when a generator is given or the draws are
    passed in: eta1 (B, S, P) and eta2 (C, S, nl, nm) as compute_rhs has
    them, eta_t (T,) and eta_p (nsrc,) N(0, 1) times the prior istd."""
    _diagonal_noise(sys)
    fluct = generator is not None or eta1 is not None
    dt, dev = sys.data.dtype, sys.data.device
    w = sys.data * sys.inv_rms2
    if fluct:
        if eta1 is None:
            eta1 = randn(sys.data.shape, generator, dt, dev)
        w = w + eta1.to(w) * sys.inv_rms
    r = _band_maps_adj(sys, plan, w, ts, ps)
    a, t, p = r.a, r.t, r.p
    if ts is not None:
        t = t + ts.prior_istd ** 2 * ts.prior_mean
    if ps is not None:
        p = p + ps.prior_istd ** 2 * ps.prior_mean
    if fluct:
        if eta2 is None:
            eta2 = random_alm_white(generator, tuple(a.shape), dt, dev)
        a = a + eta2.to(a) * sys.tri
        if ts is not None:
            if eta_t is None:
                eta_t = randn(t.shape, generator, dt, dev)
            t = t + ts.prior_istd * eta_t.to(t)
        if ps is not None:
            if eta_p is None:
                eta_p = randn(p.shape, generator, dt, dev)
            p = p + ps.prior_istd * eta_p.to(p)
    return JointState(a=a, t=t, p=p)


# pixels per float64 chunk of the template normal matrix's sums
_G_CHUNK = 1 << 21


def _gram(x: torch.Tensor, y: torch.Tensor, sub: int = 4096) -> torch.Tensor:
    """x (K, n) @ y (L, n)^T as a batch of products over sub-chunks of the
    long axis, summed: one GEMM with n in its reduction would leave it to a
    few thread blocks."""
    n = x.shape[-1]
    c = math.gcd(n, sub)
    xs = x.reshape(x.shape[0], n // c, c).transpose(0, 1)     # (n/c, K, c)
    ys = y.reshape(y.shape[0], n // c, c).permute(1, 2, 0)    # (n/c, c, L)
    return torch.sum(torch.bmm(xs, ys), dim=0)


def template_normal_matrix(ts: TemplateSet, inv_rms2: torch.Tensor
                           ) -> torch.Tensor:
    """G = T^T N^-1 T (T, T) in float64: the planes' products on a shared
    slot, summed a float64 chunk of pixels at a time."""
    inv = inv_rms2.reshape(ts.nband * ts.nmaps, -1)
    K, P = ts.planes.shape
    Gp = torch.zeros((K, K), dtype=torch.float64, device=inv.device)
    for p0 in range(0, P, _G_CHUNK):
        pl = ts.planes[:, p0:p0 + _G_CHUNK].to(torch.float64)
        w = pl * inv[ts.slots, p0:p0 + _G_CHUNK].to(torch.float64)
        Gp += _gram(w, pl)
    same = (ts.slots[:, None] == ts.slots[None, :]).to(torch.float64)
    R = ts.onehot.to(torch.float64)
    return R.T @ (Gp * same) @ R


def build_joint_preconditioner(sys, plan, ts, ps):
    """The diagonal diffuse block (amplitude.build_preconditioner) beside
    the inverse template normal matrix (G + prior precision + 1e-12) and
    the inverse diagonal of the source normal matrix (the reference's
    invM_diff / invM_temp / invM_src); the small blocks in float64, cast to
    the system's dtype. Returns apply(r)."""
    M_diff = amp.build_preconditioner(sys, plan)
    dt = sys.data.dtype
    Mt_inv = Mp_inv = None
    if ts is not None:
        G = template_normal_matrix(ts, sys.inv_rms2)
        G = G + torch.diag(ts.prior_istd.to(torch.float64) ** 2 + 1e-12)
        Mt_inv = torch.linalg.inv_ex(G).inverse.to(dt)
    if ps is not None:
        B, S = ps.stamp.shape[0], ps.stamp.shape[1]
        iv = sys.inv_rms2.reshape(-1)[ps.flat].reshape(ps.stamp.shape)
        diag = torch.einsum("bsnk,bsnk->n", ps.stamp.to(torch.float64) ** 2,
                            iv.to(torch.float64))
        Mp_inv = (1.0 / (diag + ps.prior_istd.to(torch.float64) ** 2
                         + 1e-12)).to(dt)

    def apply(r: JointState) -> JointState:
        return JointState(
            a=M_diff(r.a),
            t=None if Mt_inv is None else Mt_inv @ r.t,
            p=None if Mp_inv is None else Mp_inv * r.p)

    return apply


def sample_joint(sys, plan, ts=None, ps=None,
                 generator: torch.Generator | None = None, eta1=None,
                 eta2=None, eta_t=None, eta_p=None, tol=1e-8, maxiter=500
                 ) -> tuple[JointState, CGResult]:
    """Draw (a, t, p) ~ P(. | d, Cl, theta) jointly (the Wiener mean without
    generator or draws). Returns (JointState with a unwhitened, CGResult)."""
    rhs = compute_rhs_joint(sys, plan, ts, ps, generator, eta1, eta2, eta_t,
                            eta_p)
    M_inv = build_joint_preconditioner(sys, plan, ts, ps)
    res = pcg(partial(apply_A_joint, sys, plan, ts, ps), rhs, M_inv=M_inv,
              dot=joint_dot, tol=tol, maxiter=maxiter)
    x = res.x
    return JointState(a=amp._sqrtS(sys, x.a), t=x.t, p=x.p), res


def sample_template_amp_masked(res_map, T_map, inv_rms2, mask,
                               prior_mean=0.0, prior_std=None,
                               sample: bool = True,
                               generator: torch.Generator | None = None,
                               z=None) -> torch.Tensor:
    """Masked single-template amplitude draw outside the CG (the reference's
    sample_partialsky_tempamps): mu = <T N^-1 r>_mask / <T N^-1 T>_mask,
    sigma^2 = 1 / <T N^-1 T>_mask, combined with the Gaussian prior
    (prior_mean, prior_std); mu + sigma z with z ~ N(0, 1) (from the
    generator, or given) when sample, else mu. Maps (..., P), one band."""
    w = inv_rms2 * mask
    num = torch.sum(w * res_map * T_map)
    den = torch.sum(w * T_map * T_map)
    mu = num / den
    var = 1.0 / den
    if prior_std is not None:
        vp = prior_std * prior_std
        mu = (mu * vp + prior_mean * var) / (vp + var)
        var = var * vp / (var + vp)
    if sample and (generator is not None or z is not None):
        if z is None:
            z = randn((), generator, res_map.dtype, res_map.device)
        return mu + torch.sqrt(var) * z
    return mu


# ---------------------------------------------------------------------------
# Per-source spectral indices (the reference's samplePtsrcSpecInd)
# ---------------------------------------------------------------------------

def ptsrc_sed(nuratio, alphas) -> torch.Tensor:
    """Radio SED factor per (band, source): (nu_b / nu0)^(-2 + alpha_i)."""
    alphas = torch.as_tensor(alphas)
    nuratio = torch.as_tensor(nuratio, dtype=alphas.dtype,
                              device=alphas.device)
    return torch.pow(nuratio[:, None], (-2.0 + alphas)[None, :])


def restamp_ptsrc(ps_unit: PtsrcSet, nuratio, alphas) -> PtsrcSet:
    """The unit-profile stamps with the current per-source SED baked in (the
    sorted runs carry over: the pixels do not change)."""
    F = ptsrc_sed(nuratio, alphas).to(ps_unit.stamp)
    return dataclasses.replace(ps_unit,
                               stamp=ps_unit.stamp * F[:, None, :, None])


def sample_ptsrc_alpha(ps_unit: PtsrcSet, nuratio, res, amps, alphas,
                       inv_rms2, grid, prior_mean=None, prior_istd=None,
                       generator: torch.Generator | None = None, u=None
                       ) -> torch.Tensor:
    """Grid-inversion draw of each source's spectral index, batched over
    sources and grid. ps_unit: unit-profile stamps (no SED); res (B, S, P):
    the residual of the full model at the current alphas; amps (nsrc,).
    u: optional (nsrc,) uniforms in place of the generator's. Returns the
    (nsrc,) new alphas, float64."""
    pix = ps_unit.pix
    nur = torch.as_tensor(nuratio, dtype=res.dtype, device=res.device)
    r_patch = res[:, :, pix]                           # (B,S,nsrc,npatch)
    iv_patch = inv_rms2[:, :, pix]
    F_cur = ptsrc_sed(nur, alphas)                     # (B,nsrc)
    own = ps_unit.stamp * (F_cur[:, None, :, None]
                           * amps[None, None, :, None])
    r_full = r_patch + own
    F_g = torch.pow(nur[:, None, None], (-2.0 + grid)[None, None, :])
    model = (ps_unit.stamp[..., None] * amps[None, None, :, None, None]
             * F_g[:, None, :, None, :])               # (B,S,nsrc,np,G)
    dlt = r_full[..., None] - model
    lnl = -0.5 * torch.sum(iv_patch[..., None] * dlt * dlt, dim=(0, 1, 3))
    if prior_mean is not None and prior_istd is not None:
        lnl = lnl - 0.5 * ((grid[None, :] - prior_mean[:, None])
                           * prior_istd[:, None]) ** 2
    u = _uniform((pix.shape[0],), res, generator, u)
    return _cdf_invert(u, lnl, grid)


def optimize_ptsrc(ps_unit: PtsrcSet, nuratio, res, amps, alphas, inv_rms2,
                   alpha_bounds=(-4.0, 1.0)):
    """OPERATION = optimize: a Powell fit of (amplitude, alpha) per source
    (the reference's powell(x, lnL_ptsrc_multi)), a host loop over sources
    in float64 numpy. Returns (amps, alphas) as float64 host tensors."""
    host = lambda x: torch.as_tensor(x).detach().to(
        "cpu", torch.float64).numpy()
    pix = host(ps_unit.pix).astype(np.int64)
    r_patch = host(res)[:, :, pix]
    iv_patch = host(inv_rms2)[:, :, pix]
    unit = host(ps_unit.stamp)
    nur = host(nuratio)
    amps, alphas = host(amps).copy(), host(alphas).copy()
    F_cur = nur[:, None] ** (-2.0 + alphas)[None, :]
    for i in range(pix.shape[0]):
        r_i = r_patch[:, :, i] + unit[:, :, i] \
            * (F_cur[:, i, None] * amps[i])[:, None]

        def negl(x, i=i, r_i=r_i):
            a, al = x
            al = np.clip(al, *alpha_bounds)
            F = nur ** (-2.0 + al)
            d = r_i - unit[:, :, i] * (F[:, None, None] * a)
            return float(np.sum(iv_patch[:, :, i] * d * d))

        x, _, _ = powell(negl, np.array([amps[i], alphas[i]]))
        amps[i] = x[0]
        alphas[i] = float(np.clip(x[1], *alpha_bounds))
    return torch.as_tensor(amps), torch.as_tensor(alphas)
