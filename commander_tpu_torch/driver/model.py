"""The model of a parameter file: run.build_model's lowering (torch).

Counterpart of commander_tpu.run.build_model (run.py:129-588; the
reference's initialize_data_mod and initialize_signal_mod,
comm_data_mod.f90:74, comm_signal_mod.f90:46-130) and the helpers it shares
with the multi-resolution builder (run.py:27-91). From a lowered RunConfig
(io/params.py) it makes, on one device and in one dtype:

  * the SHT plan at the shared (nside, lmax);
  * the diffuse components and the bands' bandpasses and mixing matrix;
  * b_l: the BAND_BEAM_B_L_FILE table or a Gaussian of BAND_BEAM_FWHM (60'
    where unset), times the HEALPix pixel window of the nside;
  * the C_l prior of every component by COMP_CL_TYPE (binned ones with
    COMP_CL_BIN_FILE or the default geometric bins, the functional kinds as
    fixed spectra), times the COMP_LMAX_AMP / LMIN_AMP window;
  * the data: synthetic (the truth alms sqrt(cl0) x a white draw, projected,
    beamed and synthesized on the device, plus rms-10 noise from numpy's
    default_rng(seed)), or FITS maps, noise (rms or QUcov) and masks under
    data_dir, ud-graded to the nside;
  * the joint system's template rows (md: [1, x, y, z] per band, prior 0 +-
    100; cmb_relquad: one pinned row over the active bands; generic
    templates from their definition files) and point-source rows (a catalog,
    or 20 synthetic sources injected into the data).

Randomness: the noise, the synthetic sources and their amplitudes come from
numpy's default_rng(seed) in run.build_model's order, so both packages draw
the same numbers; the truth alms from numpy's default_rng([seed, 1]) unless
a_true is given (the tests pass the JAX package's draw).
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from ..instrument.bandpass import delta_bandpass, tophat_bandpass
from ..instrument.beam import gaussian_bl, pixel_window
from ..io import fits as fitsio
from ..model import seds
from ..model.cl import (ClModelConfig, fixed_cl_from_config,
                        read_cl_bin_file)
from ..model.mixing import DiffuseComponent, mixing_matrix
from ..model.relquad import relquad_template
from ..sampling import amplitude as amp
from ..sampling import joint
from ..sphere import healpix, sht
from ..sphere.alm import triangle_mask
from ..utils.device import resolve_device

GHZ = 1e9

# run.py:27-42
_SED_OF = {"cmb": "cmb", "power_law": "power_law", "MBB": "MBB",
           "freefree": "freefree", "spindust": "spindust",
           "spindust2": "spindust2", "physdust": "physdust",
           "line": "line", "curved_power_law": "curved_power_law"}
# parameter-file units -> SED units
_INDEX_SCALE = {"nu_p": GHZ}
# component types that are not diffuse amplitude fields
_NOT_DIFFUSE = ("md", "cmb_relquad", "template")


class Model(NamedTuple):
    """What build_model lowers a configuration to (run.build_model's
    12-tuple, by name)."""
    plan: sht.SHTPlan
    sys: amp.AmplitudeSystem
    diffuse: list              # DiffuseComponent per diffuse component
    bps: list                  # Bandpass per band
    cl_cfg: ClModelConfig      # the shared binned config
    cl0: np.ndarray            # (C, S, nl) prior spectra, float64
    meta: dict                 # nside, lmax, nmaps, comps, bands, ...
    truth: torch.Tensor | None  # (C, S, nl, nm) synthetic truth alms
    pcfgs: list                # the diffuse components' configs
    ts: joint.TemplateSet | None
    ps: joint.PtsrcSet | None
    cl_cfgs: tuple             # per component


def comp_to_diffuse(c) -> DiffuseComponent:
    """The DiffuseComponent of a component config (run._comp_to_diffuse):
    theta0 from the indices' defaults, nu_p scaled from GHz."""
    theta0 = tuple((v.get("default") or 0.0) * _INDEX_SCALE.get(k, 1.0)
                   for k, v in c.indices.items())
    return DiffuseComponent(
        name=c.label, sed=_SED_OF.get(c.ctype, "power_law"),
        nu_ref=c.nu_ref_t_ghz * GHZ, polarized=c.polarized, theta0=theta0,
        unit="uK_cmb" if c.ctype == "cmb" else "uK_RJ")


def diffuse_configs(cfg) -> list:
    """The component configs that are diffuse amplitude fields."""
    return [c for c in cfg.comps if c.cclass == "diffuse"
            and c.ctype not in _NOT_DIFFUSE]


def band_bandpasses(cfg, data_dir=None) -> list:
    """Per-band Bandpass (run._band_bandpasses): a delta at the nominal
    frequency for BAND_BANDPASS_TYPE delta or none or without a file; the
    band's detector (its label) in a tabulated HDF file (.h5 / .hdf5) that
    exists, with the profile type's response and trimming conventions
    (instrument/files.load_bandpass_hdf, comm_bp_mod.f90:99-116); else a
    20% top-hat carrying the band's profile type."""
    from ..instrument.files import load_bandpass_hdf

    bps = []
    for b in cfg.bands:
        bpath = os.path.join(data_dir or ".", str(b.bandpassfile or ""))
        if b.bandpass_type in ("delta", "none") or b.bandpassfile is None:
            bps.append(delta_bandpass(b.nominal_freq_ghz * GHZ,
                                      unit=b.unit))
        elif os.path.exists(bpath) and bpath.endswith((".h5", ".hdf5")):
            bps.append(load_bandpass_hdf(bpath, det=b.label, unit=b.unit,
                                         profile_type=str(b.bandpass_type)))
        else:
            bp = tophat_bandpass(b.nominal_freq_ghz * GHZ, 0.2, unit=b.unit)
            bps.append(dataclasses.replace(
                bp, profile_type=str(b.bandpass_type)))
    return bps


def comp_ell_mask(comps, diffuse_names, nl: int, S: int) -> np.ndarray:
    """Per-component ell window (C, S, nl) float64 from COMP_LMAX_AMP /
    COMP_LMIN_AMP (run._comp_ell_mask): zero prior power outside it confines
    the component there exactly."""
    name_to = {c.label: c for c in comps}
    mask = np.ones((len(diffuse_names), S, nl))
    ell = np.arange(nl)
    for i, n in enumerate(diffuse_names):
        c = name_to.get(n)
        if c is None:
            continue
        if c.lmax_amp is not None and 0 <= c.lmax_amp < nl - 1:
            mask[i, :, ell > c.lmax_amp] = 0.0
        if c.lmin_amp and c.lmin_amp > 0:
            mask[i, :, ell < c.lmin_amp] = 0.0
    return mask


def white_alm(rng, shape) -> np.ndarray:
    """A white alm draw (random_alm_white's law) from numpy's rng."""
    a = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) \
        * np.sqrt(0.5)
    a[..., 0] = rng.standard_normal(shape[:-1])
    return a


def default_bins(lmax: int, nbin: int = 10) -> tuple:
    """run.py's default C_l bins: 0, 2, then geometric from 4 to lmax."""
    return tuple(int(x) for x in np.unique(np.concatenate(
        [[0, 2], np.geomspace(4, max(lmax, 5), nbin).astype(int)])))


def _ud(m: np.ndarray, nside: int, rms: bool = False) -> np.ndarray:
    """(k, npix_in) maps at another nside: the mean of the children
    (quadrature for rms maps) or the parent's value (run.py's udgrade)."""
    mns = int(np.sqrt(m.shape[1] / 12))
    if mns == nside:
        return m
    idx = healpix.udgrade_indices(mns, nside)
    if idx.ndim == 2:
        return np.sqrt((m[:, idx] ** 2).mean(-1)) if rms \
            else m[:, idx].mean(-1)
    return m[:, idx]


def _cl_row(c, stokes: int, ell: np.ndarray) -> np.ndarray:
    """The default power-law prior row of a component (run.py:227-236)."""
    amp_ = c.cl_amp_def[min(stokes, 2)] or 1.0
    beta = c.cl_beta_def[min(stokes, 2)] or 0.0
    dl = np.asarray(amp_) * (np.maximum(ell, 1) / max(c.cl_lpivot, 1)) ** beta
    cl = 2 * np.pi * dl / np.maximum(ell * (ell + 1), 1)
    cl[0] = cl[1]
    if stokes > 0:
        cl[:2] = 0.0
    return cl


def cl_models(pcfgs, lmax: int, S: int, data_dir=None):
    """(cl_cfgs, cl0 (C, S, nl), shared cl_cfg): the C_l model of every
    diffuse component by COMP_CL_TYPE (run.py:220-279)."""
    bins = default_bins(lmax)
    ell = np.arange(lmax + 1, dtype=np.float64)
    cl_cfgs, rows = [], []
    for c in pcfgs:
        kind = str(c.cl_type or "binned").lower()
        if kind in ("binned", "single_l"):
            starts, sample = bins, ()
            if c.cl_bin_file:
                bpath = os.path.join(data_dir or ".", str(c.cl_bin_file))
                if os.path.exists(bpath):
                    st, sm = read_cl_bin_file(bpath, lmax)
                    starts, sample = st, tuple(map(tuple, sm))
            cl_cfgs.append(ClModelConfig(kind="binned", lmax=lmax, nmaps=S,
                                         bin_starts=starts,
                                         sample_bins=sample))
            rows.append(np.stack([_cl_row(c, s, ell) for s in range(S)]))
        elif kind in ("power_law", "power_law_gauss", "exp", "gauss"):
            cl_cfgs.append(ClModelConfig(kind=kind, lmax=lmax, nmaps=S,
                                         ell_pivot=max(c.cl_lpivot, 1)))
            amps = [c.cl_amp_def[min(s, 2)] or 1.0 for s in range(S)]
            betas = [c.cl_beta_def[min(s, 2)] or 0.0 for s in range(S)]
            rows.append(np.asarray(fixed_cl_from_config(
                kind, amps, betas, c.cl_lpivot, lmax, S), np.float64))
        else:
            cl_cfgs.append(ClModelConfig(kind="none", lmax=lmax, nmaps=S))
            rows.append(np.stack([_cl_row(c, s, ell) for s in range(S)]))
    shared = ClModelConfig(kind="binned", lmax=lmax, nmaps=S, bin_starts=next(
        (cc.bin_starts for cc in cl_cfgs if cc.kind == "binned"), bins))
    return tuple(cl_cfgs), np.stack(rows), shared


def _beams(cfg, nside: int, lmax: int, S: int, synthetic: bool, data_dir):
    """(B, S, nl) b_l x pixel window (run.py:185-210)."""
    from ..instrument.files import load_beam_bl_fits

    pw = pixel_window(nside, lmax)
    bl = np.empty((len(cfg.bands), S, lmax + 1))
    for b_i, b in enumerate(cfg.bands):
        blf = getattr(b, "beamfile", None)
        if blf and str(blf).lower() not in ("none", ""):
            path = os.path.join(data_dir or ".", str(blf))
            if os.path.exists(path):
                cols = load_beam_bl_fits(path, lmax)
                for s in range(S):
                    bl[b_i, s] = cols[:, min(s, cols.shape[1] - 1)] * pw
                continue
            if not synthetic:
                raise FileNotFoundError(
                    f"BAND_BEAM_B_L_FILE {blf!r} for band {b.label} not "
                    f"found (resolved {path!r})")
        fwhm = b.beam_fwhm_arcmin or 60.0
        bl[b_i] = (gaussian_bl(max(fwhm, 1e-3), lmax) * pw)[None, :]
    return bl


def _read_bands(cfg, nside: int, S: int, rms: np.ndarray, data_dir):
    """Band maps (B, S, P) from BAND_MAPFILE, rms from BAND_NOISEFILE into
    `rms`, and the QUcov noise blocks (or None) (run.py:308-382)."""
    npix = 12 * nside * nside
    maps, cov_qu = [], None
    for b_i, b in enumerate(cfg.bands):
        path = os.path.join(data_dir or ".", b.mapfile or "")
        if b.mapfile and os.path.exists(path):
            maps.append(_ud(fitsio.read_map(path)[:S], nside))
        elif b.mapfile:
            raise FileNotFoundError(
                f"BAND_MAPFILE {b.mapfile!r} for band {b.label} not found "
                f"(resolved {path!r})")
        else:
            maps.append(np.zeros((S, npix)))
        npath = os.path.join(data_dir or ".", b.noisefile or "")
        if b.noisefile and os.path.exists(npath):
            r_all = fitsio.read_map(npath)
            if str(b.noise_format).lower() == "qucov" and S == 3 \
                    and r_all.shape[0] >= 4:
                # BAND_NOISE_FORMAT = QUcov: rows (rms_T, NQQ, NQU, NUU)
                if cov_qu is None:
                    cov_qu = np.zeros((len(cfg.bands), npix, 2, 2))
                    cov_qu[..., 0, 0] = 1.0
                    cov_qu[..., 1, 1] = 1.0
                r_all = _ud(r_all, nside)
                rms[b_i, 0] = r_all[0]
                rms[b_i, 1] = np.sqrt(np.maximum(r_all[1], 1e-30))
                rms[b_i, 2] = np.sqrt(np.maximum(r_all[3], 1e-30))
                cov_qu[b_i, :, 0, 0] = r_all[1]
                cov_qu[b_i, :, 0, 1] = r_all[2]
                cov_qu[b_i, :, 1, 0] = r_all[2]
                cov_qu[b_i, :, 1, 1] = r_all[3]
            else:
                r = r_all[:S] if r_all.shape[0] >= S else r_all[:1]
                rms[b_i] = _ud(r, nside, rms=True)
        elif b.noisefile:
            raise FileNotFoundError(
                f"BAND_NOISEFILE {b.noisefile!r} for band {b.label} not "
                f"found (resolved {npath!r})")
        else:
            raise ValueError(
                f"band {b.label} has no BAND_NOISEFILE; real-data runs "
                f"require a noise rms map per band (the reference reads one "
                f"unconditionally, comm_data_mod.f90:74)")
    return np.stack(maps), cov_qu


def _masks(cfg, nside: int, S: int, data_dir) -> np.ndarray:
    """(B, S, P) band masks (BAND_MASKFILE; 'fullsky' or a missing file:
    ones)."""
    mask = np.ones((len(cfg.bands), S, 12 * nside * nside))
    for b_i, b in enumerate(cfg.bands):
        if b.maskfile and str(b.maskfile).lower() not in ("fullsky", "none"):
            path = os.path.join(data_dir or ".", str(b.maskfile))
            if os.path.exists(path):
                mm = (_ud(fitsio.read_map(path), nside) > 0.5).astype(float)
                mask[b_i] = mm[:S] if mm.shape[0] >= S else mm[0]
    return mask


def _read_rows(path: str):
    """Non-comment lines of a definition or catalog file, as token lists."""
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                yield line.split()


def _templates(cfg, nside: int, S: int, synthetic: bool, data_dir,
               dtype, device, meta: dict):
    """The joint system's template rows (run.py:394-495) as a TemplateSet,
    or None."""
    B = len(cfg.bands)
    planes, rows, slots, mu, rms, names = [], [], [], [], [], []

    def add_row(row_planes, m, r, name):
        t = len(mu)
        for plane, slot in row_planes:
            planes.append(plane)
            rows.append(t)
            slots.append(slot)
        mu.append(m)
        rms.append(r)
        names.append(name)

    if any(c.ctype == "md" for c in cfg.comps):
        vec = healpix.pix2vec_ring(nside)
        base = np.concatenate([np.ones((1, vec.shape[0])), vec.T], axis=0)
        for b_i, b in enumerate(cfg.bands):
            for k, nm in enumerate(("mono", "dx", "dy", "dz")):
                add_row([(base[k], b_i * S)], 0.0, 100.0,
                        f"md_{b.label}_{nm}")
    labels = {b.label: i for i, b in enumerate(cfg.bands)}
    for c in cfg.comps:
        if c.ctype == "cmb_relquad":
            active = [True] * B
            if c.template_file:
                path = os.path.join(data_dir or ".", str(c.template_file))
                if os.path.exists(path):
                    act = {t[0]: t[1].lower() in (".true.", "true", "1")
                           for t in _read_rows(path)}
                    active = [act.get(b.label, True) for b in cfg.bands]
                elif not synthetic:
                    raise FileNotFoundError(
                        f"COMP_TEMPLATE_DEFINITION_FILE "
                        f"{c.template_file!r} not found")
            add_row([(relquad_template(nside, b.nominal_freq_ghz * GHZ),
                      b_i * S) for b_i, b in enumerate(cfg.bands)
                     if active[b_i]],
                    c.amp_prior_mean or c.amp_default, c.amp_prior_rms,
                    c.label)
        elif c.cclass == "template" and c.template_file:
            path = os.path.join(data_dir or ".", str(c.template_file))
            if not os.path.exists(path):
                if synthetic:
                    continue
                raise FileNotFoundError(
                    f"COMP_TEMPLATE_DEFINITION_FILE {c.template_file!r} "
                    f"not found")
            for toks in _read_rows(path):
                lbl, mapf = toks[0], toks[1]
                m = float(toks[3]) if len(toks) > 3 else 0.0
                r = float(toks[4]) if len(toks) > 4 else 0.0
                if lbl not in labels:
                    continue
                tpath = os.path.join(data_dir or ".", mapf)
                if not os.path.exists(tpath):
                    if synthetic:
                        continue
                    raise FileNotFoundError(f"template map {mapf!r} not "
                                            f"found")
                tm = _ud(fitsio.read_map(tpath)[:S], nside)
                b_i = labels[lbl]
                add_row([(tm[s], b_i * S + s) for s in range(tm.shape[0])
                         if np.any(tm[s] != 0)], m, r, f"{c.label}_{lbl}")
    if not mu:
        return None
    rms_arr = np.asarray(rms, np.float64)
    # rms 0: pinned at the mean (inverse std 1e6); rms > 0: Gaussian prior
    istd = np.where(rms_arr > 0, 1.0 / np.maximum(rms_arr, 1e-30), 1e6)
    meta["template_names"] = names
    return joint.make_template_set(
        np.stack(planes), rows, slots, len(mu), B, S,
        prior_mean=np.asarray(mu, np.float64), prior_istd=istd, dtype=dtype,
        device=device)


def _ptsrc(cfg, c, nside: int, S: int, synthetic: bool, data_dir, rng,
           dtype, device, meta: dict):
    """(PtsrcSet, true amplitudes or None) of one ptsrc component
    (run.py:496-577), or (None, None)."""
    npix = 12 * nside * nside
    path = os.path.join(data_dir or ".", str(c.catalog or ""))
    npatch = min(32, npix // 4)
    if c.catalog and os.path.exists(path):
        rows = []
        for toks in _read_rows(path):
            vals = []
            for t in toks[:8]:
                try:
                    vals.append(float(t))
                except ValueError:
                    break
            rows.append(vals + [0.0] * (8 - len(vals)))
        cat = np.asarray(rows)
        glon, glat = np.deg2rad(cat[:, 0]), np.deg2rad(cat[:, 1])
        src_pix = np.asarray(healpix.ang2pix_ring(nside, np.pi / 2.0 - glat,
                                                  glon), np.int64)
        alpha = cat[:, 4]
        nu0 = c.nu_ref_t_ghz or 30.0
        nur = np.asarray([b.nominal_freq_ghz / nu0 for b in cfg.bands])
        F_src = nur[:, None] ** (-2.0 + alpha[None, :])
        fwhms = np.asarray([max(b.beam_fwhm_arcmin, 1.0) for b in cfg.bands])
        istd = np.where(cat[:, 3] > 0, 1.0 / np.maximum(cat[:, 3], 1e-30),
                        0.0)
        stamp = lambda F: joint.gaussian_stamp_ptsrc(
            nside, src_pix, F, fwhms, nmaps=S, npatch=npatch, dtype=dtype,
            device=device)
        ps = dataclasses.replace(
            stamp(F_src), prior_mean=torch.as_tensor(cat[:, 2]).to(
                device, dtype), prior_istd=torch.as_tensor(istd).to(
                    device, dtype))
        unit = stamp(np.ones_like(F_src))
        meta.update(nsrc=int(cat.shape[0]), ptsrc_alpha=alpha,
                    ptsrc_unit=dataclasses.replace(
                        unit, prior_mean=ps.prior_mean,
                        prior_istd=ps.prior_istd),
                    ptsrc_nuratio=nur,
                    ptsrc_alpha_rms=(cat[:, 6] if cat.shape[1] > 6
                                     else np.zeros(cat.shape[0])))
        return ps, None
    if synthetic:
        nsrc = 20
        src_pix = rng.choice(npix, size=nsrc, replace=False)
        F_src = np.stack([(b.nominal_freq_ghz / 30.0) ** -2.5 * np.ones(nsrc)
                          for b in cfg.bands])
        fwhms = np.asarray([max(b.beam_fwhm_arcmin, 60.0)
                            for b in cfg.bands])
        ps = joint.gaussian_stamp_ptsrc(nside, src_pix, F_src, fwhms,
                                        nmaps=S, npatch=npatch, dtype=dtype,
                                        device=device)
        p_true = np.abs(rng.standard_normal(nsrc)) * 50.0 + 50.0
        meta.update(nsrc=nsrc, ptsrc_true=p_true)
        return ps, p_true
    if c.catalog:
        raise FileNotFoundError(f"COMP_CATALOG {c.catalog!r} not found "
                                f"(resolved {path!r})")
    return None, None


def build_model(cfg, nside=None, lmax=None, synthetic: bool = False,
                seed: int = 0, data_dir=None, dtype=torch.float64,
                pol: bool = False, device=None, a_true=None) -> Model:
    """Lower a RunConfig into the runtime objects on `device` (None: the
    CUDA card) in `dtype` (run.build_model). nside / lmax default to the
    smallest band nside and min(2 nside, smallest band lmax); pol: T/Q/U
    where every band is polarized. synthetic: data simulated from the prior
    (a_true: optional (C, S, nl, nl) truth alms in place of the draw), else
    FITS inputs under data_dir."""
    device = resolve_device(device)
    for c in cfg.comps:
        if c.cclass == "diffuse" and c.ctype in ("spindust", "spindust2") \
                and getattr(c, "sed_template", None):
            path = os.path.join(data_dir or ".", str(c.sed_template))
            if os.path.exists(path):
                seds.load_spindust_template(path)
    pcfgs = diffuse_configs(cfg)
    diffuse = [comp_to_diffuse(c) for c in pcfgs]
    if not diffuse:
        raise ValueError("no diffuse components in configuration")
    nside = nside or min(b.nside for b in cfg.bands)
    lmax = lmax or min(2 * nside, min(b.lmax for b in cfg.bands))
    nl, npix, B, C = lmax + 1, 12 * nside * nside, len(cfg.bands), len(diffuse)
    pol = pol and all(b.polarized for b in cfg.bands)
    S = 3 if pol else 1
    plan = sht.get_plan(nside, lmax, spin2=pol, dtype=dtype, device=device)
    bps = band_bandpasses(cfg, data_dir)
    F = mixing_matrix(diffuse, bps, device="cpu").numpy()
    bl = _beams(cfg, nside, lmax, S, synthetic, data_dir)
    cl_cfgs, cl0, cl_cfg = cl_models(pcfgs, lmax, S, data_dir)
    ell_mask = comp_ell_mask(cfg.comps, [d.name for d in diffuse], nl, S)
    has_window = not np.all(ell_mask == 1.0)
    if has_window:
        cl0 = cl0 * ell_mask
    t = lambda a: torch.as_tensor(np.asarray(a)).to(device, dtype)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    rng = np.random.default_rng(seed)
    rms = np.full((B, S, npix), 10.0)
    cov_qu, truth, sky_true = None, None, None
    meta = {"nside": nside, "lmax": lmax, "nmaps": S,
            "comps": [d.name for d in diffuse],
            "bands": [b.label for b in cfg.bands]}
    if synthetic:
        if a_true is None:
            a_true = white_alm(np.random.default_rng([seed, 1]),
                               (C, S, nl, nl)) * np.sqrt(cl0)[..., None]
        truth = torch.as_tensor(np.asarray(a_true)
                                * triangle_mask(nl, nl)).to(device, cdt)
        sys0 = amp.build_system(t(F), t(bl), t(rms), t(cl0),
                                torch.zeros((B, S, npix), dtype=dtype,
                                            device=device))
        sky_true = amp._synth(plan, amp._project_bands(sys0, plan, truth))
        data = sky_true + t(rms * rng.standard_normal(tuple(sky_true.shape)))
    else:
        data, cov_qu = _read_bands(cfg, nside, S, rms, data_dir)
        data = t(data)
    mask = _masks(cfg, nside, S, data_dir)
    sys = amp.build_system(t(F), t(bl), t(rms), t(cl0), data, mask=t(mask),
                           cov_qu=None if cov_qu is None else t(cov_qu),
                           ell_mask=t(ell_mask) if has_window else None)
    ts = _templates(cfg, nside, S, synthetic, data_dir, dtype, device, meta)
    ps = None
    for c in cfg.comps:
        if c.cclass != "ptsrc":
            continue
        ps, p_true = _ptsrc(cfg, c, nside, S, synthetic, data_dir, rng,
                            dtype, device, meta)
        if p_true is not None:
            # the synthetic sources' signal, in the data and the truth
            extra = joint._ptsrc_fwd(ps, t(p_true), npix)
            sys = dataclasses.replace(sys, data=sys.data + extra)
            sky_true = sky_true + extra
    if synthetic:
        meta["sky_true"] = sky_true
    return Model(plan=plan, sys=sys, diffuse=diffuse, bps=bps, cl_cfg=cl_cfg,
                 cl0=cl0, meta=meta, truth=truth, pcfgs=pcfgs, ts=ts, ps=ps,
                 cl_cfgs=cl_cfgs)
