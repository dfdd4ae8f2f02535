"""CG sampling groups: a Gibbs sweep of per-group conditional amplitude
solves (torch).

Counterpart of commander_tpu.sampling.groups (the reference's
define_cg_samp_groups, comm_param_mod.f90:2381-2429, and its group loop,
commander.f90:211-221):
  build_groups               the user groups (CG_SAMPLING_GROUPxx, 'md'
                             expanded to the band-named md rows, a group
                             mask from FITS) first, then one automatic group
                             per component, maxiter 150 for cmb and the
                             non-diffuse classes, COMP_CG_SAMP_GROUP_MAXITER
                             (or CG_MAXITER) otherwise;
  sample_amplitudes_grouped  per group, the non-members' signal at their
                             current values subtracted from the data and the
                             group mask applied to N^-1 (_group_system),
                             then the members' conditional: a dense direct
                             solve for template rows alone, a CG over the
                             sources alone, the joint CG with rows, or the
                             diffuse CG.
Draws: group gi draws under the JAX key fold_in(k_amp, gi); here from the
generator in group order, or ready-made as draws[gi] ({eta1, eta2, eta_t,
eta_p} as the group's solve takes them).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.cg import pcg
from ..utils.device import randn
from . import amplitude as amp
from . import joint


@dataclasses.dataclass(frozen=True)
class SampGroup:
    """One CG sampling group: its diffuse components, template rows and
    whether the sources are in it; its maxiter and (S, P) mask or None."""
    name: str
    comp_idx: tuple = ()
    temp_idx: tuple = ()
    ptsrc: bool = False
    maxiter: int = 150
    mask: Optional[object] = None


def _diffuse_signal(sys, plan, a, comp_idx):
    """The band maps of the diffuse components comp_idx (zeros for none)."""
    if len(comp_idx) == 0:
        return torch.zeros_like(sys.data)
    idx = torch.as_tensor(comp_idx, dtype=torch.int64, device=a.device)
    if sys.F_pix is not None:
        sub = dataclasses.replace(sys, F=sys.F[:, idx],
                                  F_pix=sys.F_pix[:, idx])
        return amp._forward_pixmix(sub, plan, a[idx])
    sub = dataclasses.replace(sys, F=sys.F[:, idx])
    return amp._synth(plan, amp._project_bands(sub, plan, a[idx]))


def subset_templates(ts: joint.TemplateSet, rows) -> joint.TemplateSet:
    """The template set of rows `rows` alone, renumbered 0.. in that order,
    with their priors."""
    rows = [int(r) for r in rows]
    of = torch.argmax(ts.onehot, dim=1).tolist()
    keep = [k for k, r in enumerate(of) if r in rows]
    kk = torch.as_tensor(keep, dtype=torch.int64, device=ts.planes.device)
    ri = torch.as_tensor(rows, dtype=torch.int64, device=ts.planes.device)
    return joint.make_template_set(
        ts.planes[kk], [rows.index(of[k]) for k in keep],
        ts.slots[kk].cpu().numpy(), len(rows), ts.nband, ts.nmaps,
        prior_mean=ts.prior_mean[ri].cpu().numpy(),
        prior_istd=ts.prior_istd[ri].cpu().numpy(), dtype=ts.planes.dtype,
        device=ts.planes.device)


def _group_system(sys, plan, a, t, p, ts, ps, g: SampGroup):
    """The group's system: the non-members' signal subtracted from the
    data, the group mask on N^-1 (and its root on N^-1/2), the members'
    mixing columns, spectra and prior roots."""
    C = a.shape[0]
    sky = _diffuse_signal(sys, plan, a, tuple(
        i for i in range(C) if i not in g.comp_idx))
    if ts is not None:
        keep = torch.tensor([0.0 if i in g.temp_idx else 1.0
                             for i in range(ts.ntemp)], dtype=t.dtype,
                            device=t.device)
        sky = sky + joint._templates_fwd(ts, t * keep)
    if ps is not None and not g.ptsrc:
        sky = sky + joint._ptsrc_fwd(ps, p, sys.data.shape[-1])
    inv_rms2, inv_rms = sys.inv_rms2, sys.inv_rms
    if g.mask is not None:
        m = torch.as_tensor(np.asarray(g.mask)).to(sys.data.device,
                                                    sys.data.dtype)
        inv_rms2 = inv_rms2 * m
        inv_rms = inv_rms * torch.sqrt(m)
    idx = torch.as_tensor(g.comp_idx, dtype=torch.int64,
                          device=sys.data.device)
    pick = lambda x, dim=0: None if x is None else x.index_select(dim, idx)
    return dataclasses.replace(
        sys, data=sys.data - sky, inv_rms2=inv_rms2, inv_rms=inv_rms,
        F=pick(sys.F, 1), F_pix=pick(sys.F_pix, 1), cl=pick(sys.cl),
        sqrtS_mat=pick(sys.sqrtS_mat), ell_mask=pick(sys.ell_mask))


def _solve_templates_direct(sys_g, ts_g: joint.TemplateSet, generator,
                            draws, fluct: bool):
    """The exact Gaussian conditional of a group of template rows alone:
    (T^t N^-1 T + P) t = T^t N^-1 d + P mu (+ T^t N^-1/2 eta1 + P^1/2
    eta_t), the (T, T) system solved directly in float64 (the reference
    runs a 3-iteration CG on the tutorial's md group)."""
    dt, dev = sys_g.data.dtype, sys_g.data.device
    G = joint.template_normal_matrix(ts_g, sys_g.inv_rms2)
    istd = ts_g.prior_istd.to(torch.float64)
    G = G + torch.diag(istd ** 2 + 1e-12)
    w = sys_g.data * sys_g.inv_rms2
    if fluct:
        eta1 = draws.get("eta1")
        if eta1 is None:
            eta1 = randn(sys_g.data.shape, generator, dt, dev)
        w = w + sys_g.inv_rms * eta1.to(w)
    rhs = joint._templates_adj(ts_g, w).to(torch.float64) \
        + istd ** 2 * ts_g.prior_mean.to(torch.float64)
    if fluct:
        eta_t = draws.get("eta_t")
        if eta_t is None:
            eta_t = randn(istd.shape, generator, dt, dev)
        rhs = rhs + istd * eta_t.to(rhs)
    return torch.linalg.solve(G, rhs).to(dt)


def _solve_ptsrc_only(sys_g, ps, generator, draws, fluct: bool, maxiter,
                      tol):
    """A CG over the source amplitudes alone (the stamps' scatter and
    gather, the prior precision and a 1e-12 ridge), preconditioned by the
    inverse diagonal."""
    dt, dev = sys_g.data.dtype, sys_g.data.device
    npix = sys_g.data.shape[-1]
    istd2 = ps.prior_istd ** 2

    def A(p):
        m = joint._ptsrc_fwd(ps, p, npix) * sys_g.inv_rms2
        return joint._ptsrc_adj(ps, m) + (istd2 + 1e-12) * p

    w = sys_g.data * sys_g.inv_rms2
    if fluct:
        eta1 = draws.get("eta1")
        if eta1 is None:
            eta1 = randn(sys_g.data.shape, generator, dt, dev)
        w = w + sys_g.inv_rms * eta1.to(w)
    rhs = joint._ptsrc_adj(ps, w) + istd2 * ps.prior_mean
    if fluct:
        eta_p = draws.get("eta_p")
        if eta_p is None:
            eta_p = randn(ps.prior_istd.shape, generator, dt, dev)
        rhs = rhs + ps.prior_istd * eta_p.to(rhs)
    iv = sys_g.inv_rms2.reshape(-1)[ps.flat].reshape(ps.stamp.shape)
    Mp = 1.0 / (torch.einsum("bsnk,bsnk->n", ps.stamp ** 2, iv)
                + istd2 + 1e-12)
    res = pcg(A, rhs, M_inv=lambda r: Mp * r,
              dot=lambda x, y: torch.sum(x * y), tol=tol, maxiter=maxiter)
    return res.x, res


def sample_amplitudes_grouped(groups: Sequence[SampGroup], sys, plan, a, t,
                              p, ts, ps, generator=None, draws=None,
                              tol=1e-8, optimize=False,
                              precond="diagonal", lowl_lmax=-1):
    """One sweep over the groups, in order: each draws its members'
    conditional given the current values of every non-member. draws:
    optional list of per-group draws dicts. Returns (a, t, p, the last
    CGResult or None)."""
    fluct = not optimize
    res_last = None
    a = a.clone()
    t = None if t is None else t.clone()
    for gi, g in enumerate(groups):
        d = {} if draws is None else draws[gi]
        kw = {} if optimize else dict(
            generator=generator, eta1=d.get("eta1"), eta2=d.get("eta2"))
        sys_g = _group_system(sys, plan, a, t, p, ts, ps, g)
        if len(g.comp_idx) == 0 and not g.ptsrc:
            if ts is None or len(g.temp_idx) == 0:
                continue
            t_new = _solve_templates_direct(
                sys_g, subset_templates(ts, g.temp_idx), generator, d,
                fluct)
            t[list(g.temp_idx)] = t_new
            continue
        if len(g.comp_idx) == 0:
            p, res_last = _solve_ptsrc_only(sys_g, ps, generator, d, fluct,
                                            g.maxiter, tol)
            continue
        ts_g = subset_templates(ts, g.temp_idx) \
            if ts is not None and len(g.temp_idx) > 0 else None
        ps_g = ps if g.ptsrc else None
        if ts_g is not None or ps_g is not None:
            if fluct:
                kw.update(eta_t=d.get("eta_t"), eta_p=d.get("eta_p"))
            x, res_last = joint.sample_joint(sys_g, plan, ts_g, ps_g,
                                             tol=tol, maxiter=g.maxiter,
                                             **kw)
            a_g = x.a
            if x.t is not None:
                t[list(g.temp_idx)] = x.t
            if x.p is not None:
                p = x.p
        else:
            a_g, res_last = amp.sample_amplitudes(
                sys_g, plan, tol=tol, maxiter=g.maxiter, precond=precond,
                lowl_lmax=lowl_lmax, **kw)
        a[list(g.comp_idx)] = a_g
    return a, t, p, res_last


def build_groups(cfg, diffuse_names, template_names, has_ptsrc: bool,
                 ptsrc_labels=(), nmaps: int = 1, npix: int = 0,
                 data_dir=None) -> tuple:
    """The configuration's groups as SampGroups (define_cg_samp_groups):
    the user groups, then one automatic group per component."""
    from ..io import fits as fitsio
    from ..sphere.healpix import udgrade_indices

    name_to_comp = {n: i for i, n in enumerate(diffuse_names)}

    def temp_rows_for(label):
        return tuple(i for i, tn in enumerate(template_names or ())
                     if tn == label or tn.startswith(f"md_{label}_")
                     or tn.startswith(f"{label}_"))

    def load_mask(spec):
        if not spec or str(spec).lower() in ("fullsky", "none"):
            return None
        path = str(spec)
        if not os.path.isabs(path):
            path = os.path.join(data_dir or ".", path)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"CG sampling group mask file not found: {path}")
        mm = np.asarray(fitsio.read_map(path))
        nsm = int(np.sqrt(mm.shape[-1] / 12))
        nso = int(np.sqrt(npix / 12))
        if nsm != nso and npix:
            if nsm > nso:
                idx = np.asarray(udgrade_indices(nsm, nso))
                mm = mm[..., idx[:, 0]] if idx.ndim == 2 else mm[..., idx]
            else:
                idx = np.asarray(udgrade_indices(nso, nsm))
                mm = mm[..., idx].mean(axis=-1)
        mm = (mm > 0.5).astype(np.float32)
        if mm.ndim == 1:
            mm = np.broadcast_to(mm, (nmaps, mm.shape[-1])).copy()
        return mm[:nmaps]

    groups = []
    for ug in cfg.cg_user_groups or []:
        comp_idx, temp_idx, has_src = [], [], False
        tokens = list(ug.get("comps", []))
        if "md" in tokens:
            tokens += [b.label for b in cfg.bands]
        for tok in tokens:
            if tok in name_to_comp:
                comp_idx.append(name_to_comp[tok])
            if tok in (ptsrc_labels or ()):
                has_src = has_ptsrc
            temp_idx += list(temp_rows_for(tok))
        groups.append(SampGroup(
            name=",".join(ug.get("comps", [])),
            comp_idx=tuple(sorted(set(comp_idx))),
            temp_idx=tuple(sorted(set(temp_idx))), ptsrc=has_src,
            maxiter=int(ug.get("maxiter") or 0) or cfg.cg_maxiter,
            mask=load_mask(ug.get("mask"))))
    for c in cfg.comps:
        if c.cclass == "diffuse" and c.ctype not in ("md", "cmb_relquad",
                                                     "template"):
            if c.label not in name_to_comp:
                continue
            mi = 150 if c.ctype == "cmb" else (c.cg_samp_group_maxiter
                                               or cfg.cg_maxiter)
            groups.append(SampGroup(name=c.label,
                                    comp_idx=(name_to_comp[c.label],),
                                    maxiter=mi))
        elif c.ctype == "md":
            rows = tuple(i for i, tn in enumerate(template_names or ())
                         if tn.startswith("md_"))
            if rows:
                groups.append(SampGroup(name="md", temp_idx=rows,
                                        maxiter=150))
        elif c.cclass == "template" or c.ctype == "cmb_relquad":
            rows = temp_rows_for(c.label)
            if rows:
                groups.append(SampGroup(name=c.label, temp_idx=rows,
                                        maxiter=150))
        elif c.cclass == "ptsrc" and has_ptsrc:
            groups.append(SampGroup(name=c.label, ptsrc=True, maxiter=150))
    return tuple(groups)
