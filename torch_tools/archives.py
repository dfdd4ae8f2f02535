"""Write TOD archives, filelists and RIMO files holding the TOD that the
synthetic command simulates, so that the same command runs from archives.

    python3 torch_tools/archives.py param_tutorial_full.txt --synthetic \
        --pol --cpu --nside 16 --lmax 32 --SYNTH_TOD_NSCAN=4 \
        --SYNTH_TOD_NTOD=2048 --out build/archives --sidelobes 12:2 \
        --zodi --det-bandpasses

builds the command's model (driver/model.build_model), simulates every
band's TOD as run() does for a band without a filelist (the same seed,
scans, detectors and samples, tod_gibbs.simulate_bands), and writes per
band with a TOD type, with the port's writers:

  * <out>/<label>_NN.h5 (tod/loader.write_archive, nfiles files of
    consecutive scans) and <out>/filelist_<label>.txt; the samples the
    simulator flags carry flag bit 1, every scan a satpos (ecliptic
    longitude advancing over the scans), the scalars the simulator's
    start state (tod/process.init_tod_state);
  * with --sidelobes LMAX:MMAX, --det-bandpasses or --zodi: the TOD holds
    the sidelobe signal of the band's true sky (beams from a seed,
    sl_beams) and the zodi signal (tod/zodi.py at the satpos), and
    <out>/rimo_<label>.h5 (instrument/files.write_rimo_tod) the beams and,
    with --det-bandpasses, each detector's bandpass: a narrow top-hat at
    the band's frequency shifted by DET_SHIFTS (+-1-2%, zero mean); each
    detector's TOD then holds the sky of its bandpass shifted by
    DET_OFFSETS_HZ (zero mean), the offsets the per-detector bandpass move
    has to find;
  * with --dipole K: the orbital dipole of K times the satellite's
    velocity, in the TOD and in the archives' vsun (a fixture choice: the
    reference's sky-free first pass over archive TOD anchors the gains on
    the orbital dipole alone, and on the tutorial's sky at the simulated
    dipole they diverge; ROADMAP queue 3 item 25).

It prints the overrides that run the command from them (BAND_TOD_FILELIST,
BAND_TOD_FLAG 1, BAND_TOD_RIMO, TOD_INCLUDE_ZODI) as a JSON line. On the
card the simulation runs on the host, the injection on the card
(injection_maps makes the transforms, injected applies them).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# the sidelobe beams' seed and the detectors' bandpass shifts (fractions of
# the band's frequency; +-1-2%, zero mean)
SL_SEED = 9
DET_SHIFTS = {1: (0.0,), 2: (-0.015, 0.015), 3: (-0.02, 0.0, 0.02),
              4: (-0.02, -0.01, 0.01, 0.02)}
# the detectors' profiles: top-hats of this width (fraction of the band's
# frequency) on this many nodes
DET_WIDTH, DET_NODES = 0.01, 9
# the detectors' responses in the TOD: their RIMO profiles shifted by these
# offsets (Hz, zero mean), which the per-detector bandpass move (proposals
# of 0.1 GHz, tod/bandpass_mh.sample_bp_det) has to find from zero
DET_OFFSETS_HZ = {1: (0.0,), 2: (-0.15e9, 0.15e9), 3: (-0.2e9, 0.0, 0.2e9),
                  4: (-0.2e9, -0.1e9, 0.1e9, 0.2e9)}


def sl_beams(ndet: int, lmax: int, mmax: int, seed: int,
             amp: float = 0.02) -> np.ndarray:
    """Smooth per-detector sidelobe beams b_{l m'} (ndet, lmax+1, mmax+1)
    complex128 from a seed, normalized to amp at their largest (decaying as
    e^{-5 l/lmax})."""
    rng = np.random.default_rng(seed)
    nl = lmax + 1
    out = np.zeros((ndet, nl, mmax + 1), np.complex128)
    for d in range(ndet):
        for m in range(mmax + 1):
            v = rng.normal(size=nl) + (1j * rng.normal(size=nl) if m else 0.0)
            v[:m] = 0.0
            out[d, :, m] = v * np.exp(-5.0 * np.arange(nl) / lmax)
        out[d] *= amp / np.abs(out[d]).max()
    return out


def det_names(label: str, ndet: int) -> list:
    return [f"{label}-{d}" for d in range(ndet)]


def det_profile(nu0_hz: float, shift: float) -> tuple:
    """(bandpassx in GHz, bandpass): a top-hat of DET_WIDTH at
    nu0 (1 + shift)."""
    nu = nu0_hz * (1.0 + shift) * np.linspace(1 - DET_WIDTH / 2,
                                              1 + DET_WIDTH / 2, DET_NODES)
    return nu / 1e9, np.ones(DET_NODES)


def satpos_of(nscan: int) -> np.ndarray:
    """(Ns, 2) ecliptic (lon, lat) in degrees per scan."""
    return np.stack([np.linspace(0.0, 359.0, nscan),
                     1.5 * np.sin(np.linspace(0.0, 2 * np.pi, nscan))],
                    axis=-1)


def simulate(cfg, model, tod_bands) -> list:
    """The bands' TOD as the synthetic command makes it (loop._tod_bands),
    float64 on the host."""
    from commander_tpu_torch.sampling import tod_gibbs
    from commander_tpu_torch.sampling.tod_gibbs import is_differential

    meta, sys_ = model.meta, model.sys
    return tod_gibbs.simulate_bands(
        meta["nside"], meta["sky_true"], sys_.inv_rms,
        [b.nominal_freq_ghz * 1e9 for b in cfg.bands],
        nscan=cfg.synth_tod_nscan, ndet=cfg.synth_tod_ndet,
        ntod=cfg.synth_tod_ntod, sigma0_scale=cfg.synth_tod_sigma0_scale,
        fknee=cfg.synth_tod_fknee, seed=cfg.base_seed,
        dtype=torch.float64, device="cpu", tod=tod_bands,
        kinds=["diff" if is_differential(b) else "lfi" for b in cfg.bands])


def write_rimo(out: str, label: str, nu_hz: float, names: list, blm=None,
               det_bp: bool = False):
    """<out>/rimo_<label>.h5 (instrument/files.write_rimo_tod) with the
    sidelobe beams blm (Nd, nl, nm) and, with det_bp, each detector's
    bandpass (det_profile at DET_SHIFTS); None where neither is asked
    for."""
    from commander_tpu_torch.instrument.files import write_rimo_tod

    if blm is None and not det_bp:
        return None
    path = os.path.join(out, f"rimo_{label}.h5")
    dets = {}
    for d, n in enumerate(names):
        e = {"centFreq": nu_hz / 1e9}
        if blm is not None:
            e["sl"] = blm[d]
        if det_bp:
            e["bandpassx"], e["bandpass"] = det_profile(
                nu_hz, DET_SHIFTS[len(names)][d])
        dets[n] = e
    write_rimo_tod(path, dets)
    return path


def det_bandpasses(rimo: str, names: list, unit: str) -> tuple:
    """The detectors' bandpasses as the run reads them from the RIMO
    (driver/loop.archive_aux: LFI profiles)."""
    from commander_tpu_torch.instrument.files import load_bandpass_hdf

    return tuple(load_bandpass_hdf(rimo, n, unit=unit, profile_type="LFI")
                 for n in names)


def injection_maps(model, b: int, band, blm=None, det_bps=None,
                   shift_model: str = "additive_shift",
                   device="cpu") -> dict:
    """The maps that injected() projects into band b's TOD, the transforms
    on `device`: with the sidelobe beams blm (Nd, lmax+1, mmax+1) the
    sidelobe f-maps of the band's true sky and the samples' pixels on
    their plan;
    with det_bps the detectors' sky corrections (Nd, S, P) that make each
    detector see its bandpass at its offset DET_OFFSETS_HZ: (F_det - F_b)
    on the true amplitudes at the band's beam, the correction
    driver/loop.det_sky adds. Returns {fm, sl_pix, corr, seconds}."""
    from commander_tpu_torch.sampling import amplitude as amp
    from commander_tpu_torch.sampling import tod_gibbs
    from commander_tpu_torch.sphere import sht
    from commander_tpu_torch.tod import bandpass_mh, conviqt

    t0 = time.perf_counter()
    blk, cfg = band.block, band.cfg
    f64 = torch.float64
    out = {"fm": None, "sl_pix": None, "corr": None}
    truth = model.truth.to(device)
    if blm is not None:
        lmax, mmax = blm.shape[1] - 1, blm.shape[2] - 1
        ns_sl = 16
        while 2 * ns_sl < lmax:
            ns_sl *= 2
        ns_sl = min(ns_sl, cfg.nside)
        band_t = band._replace(
            sl_blm=torch.as_tensor(blm).to(device),
            sl_plan=sht.get_plan(ns_sl, lmax, dtype=f64, device=device),
            sl_tables=conviqt.conviqt_tables(ns_sl, lmax, mmax, f64, device))
        out["fm"] = tod_gibbs.band_sl_fmaps(
            [band_t], _band_system(model, b, device),
            truth[:, :, :lmax + 1, :lmax + 1])[0]
        out["sl_pix"] = torch.as_tensor(conviqt.degrade_table(
            cfg.nside, ns_sl)).to(device)[blk.pix.to(device).long()].to(
                torch.int32)
    if det_bps is not None:
        offs = torch.as_tensor(DET_OFFSETS_HZ[blk.ndet], dtype=f64,
                               device=device)
        F_det = bandpass_mh.det_mixing(
            model.diffuse, det_bps, [tuple(c.theta0) for c in model.diffuse],
            offs, shift_model)
        F_b = model.sys.F[b].to(device)
        bl = model.sys.bl[b].to(device)
        dF = (F_det[:, :, None] - F_b[None]).to(truth.dtype)
        alm = torch.einsum("dcs,cslm->dslm", dF, truth) \
            * bl[None, :, :, None]
        out["corr"] = amp._synth(model.plan, alm).to(f64)
    out["seconds"] = time.perf_counter() - t0
    return out


def injected(band, satpos, maps: dict, zodi=False, dipole: float = 1.0,
             device="cpu") -> dict:
    """Band's TOD with the terms of injection_maps (the sidelobe signal and
    the detectors' sky corrections), the zodi signal at satpos and, with
    dipole != 1, the orbital dipole of dipole times the satellite's
    velocity in place of the simulated one, on `device` (no transform):
    {tod (host float64), vsun (host, the velocity the TOD's dipole is
    of), and the seconds of each term}."""
    from commander_tpu_torch.sphere import healpix
    from commander_tpu_torch.tod import conviqt
    from commander_tpu_torch.tod import zodi as zodi_mod
    from commander_tpu_torch.tod.model import orbital_dipole, project_sky

    blk, cfg = band.block, band.cfg
    f64 = torch.float64
    tod = blk.tod.to(device, f64)
    pix = blk.pix.to(device)
    psi = blk.psi.to(device, f64)
    vsun = blk.vsun.to(device, f64)
    out = {"sidelobe_s": 0.0, "zodi_s": 0.0, "det_sky_s": 0.0,
           "dipole_s": 0.0}
    if maps.get("fm") is not None:
        t0 = time.perf_counter()
        tod = tod + conviqt.conviqt_interp_dets(maps["fm"], maps["sl_pix"],
                                                psi)
        out["sidelobe_s"] = time.perf_counter() - t0
    if maps.get("corr") is not None:
        t0 = time.perf_counter()
        tod = tod + project_sky(maps["corr"], pix, psi, cfg.pol)
        out["det_sky_s"] = time.perf_counter() - t0
    if zodi:
        t0 = time.perf_counter()
        tod = tod + zodi_mod.zodi_tod_template(
            cfg.nside, pix, satpos, cfg.nu) * zodi_mod.mjysr_to_uk_cmb(cfg.nu)
        out["zodi_s"] = time.perf_counter() - t0
    if dipole != 1.0:
        t0 = time.perf_counter()
        pv = torch.as_tensor(healpix.pix2vec_ring(cfg.nside)).to(device, f64)
        tod = tod + orbital_dipole(dipole * vsun, pv, cfg.nu, pix) \
            - orbital_dipole(vsun, pv, cfg.nu, pix)
        vsun = dipole * vsun
        out["dipole_s"] = time.perf_counter() - t0
    out["tod"] = tod.cpu().numpy()
    out["vsun"] = vsun.cpu().numpy()
    return out


def _band_system(model, b: int, device):
    """What band_sl_fmaps reads of the system (F and bl), band b first."""
    from types import SimpleNamespace
    return SimpleNamespace(F=model.sys.F[b:b + 1].to(device),
                           bl=model.sys.bl[b:b + 1].to(device))


def write_band(out: str, label: str, band, tod: np.ndarray, satpos,
               vsun=None, nfiles: int = 1) -> dict:
    """Band's archives (nfiles files of consecutive scans, vsun the
    satellite's velocity per scan, the block's where None) and filelist
    under out. Returns {filelist, files, bytes, seconds}."""
    from commander_tpu_torch.tod.loader import write_archive
    from commander_tpu_torch.tod.process import init_tod_state

    t0 = time.perf_counter()
    blk = band.block
    Ns, Nd, Nt = blk.tod.shape
    names = det_names(label, Nd)
    pix = blk.pix.cpu().numpy()
    psi = blk.psi.cpu().numpy()
    flag = (blk.mask.cpu().numpy() == 0).astype(np.int64)
    vsun = blk.vsun.cpu().numpy() if vsun is None else np.asarray(vsun)
    st = init_tod_state(blk)
    scal = torch.stack([st.gain, st.sigma0, st.fknee, st.alpha],
                       -1).cpu().double().numpy()
    files, nbytes, lines = [], 0, []
    bounds = np.linspace(0, Ns, nfiles + 1).astype(int)
    for k in range(nfiles):
        s0, s1 = bounds[k], bounds[k + 1]
        name = f"{label}_{k:02d}.h5"
        path = os.path.join(out, name)
        write_archive(path, band.cfg.nside, blk.fsamp, names, [
            dict(pix=pix[s], psi=psi[s], flag=flag[s], tod=tod[s],
                 vsun=vsun[s], satpos=satpos[s], scalars=scal[s])
            for s in range(s0, s1)])
        nbytes += os.path.getsize(path)
        files.append(path)
        # write_archive numbers a file's scans 1..n
        for j, s in enumerate(range(s0, s1)):
            lines.append(f"{j + 1} {name} {Nt:.1f} {0.5 + 0.01 * s:.5f} "
                         f"{2 * np.pi * s / Ns:.5f}")
    flist = os.path.join(out, f"filelist_{label}.txt")
    with open(flist, "w") as f:
        f.write(f"{len(lines)}\n" + "\n".join(lines) + "\n")
    return dict(filelist=flist, bytes=nbytes, files=files,
                seconds=time.perf_counter() - t0)


def overrides(cfg, written: dict, zodi: bool) -> list:
    """The command-line overrides that run the command from the written
    files."""
    out = [f"--TOD_INCLUDE_ZODI={'.true.' if zodi else '.false.'}"]
    for b, w in written.items():
        i = f"{b + 1:03d}"
        out += [f"--BAND_TOD_FILELIST{i}={w['filelist']}",
                f"--BAND_TOD_FLAG{i}=1"]
        if w["rimo"]:
            out.append(f"--BAND_TOD_RIMO{i}={w['rimo']}")
    return out


def band_inputs(cfg, model, out: str, b: int, band, sl=None, det_bp=False,
                device="cpu") -> dict:
    """Band b's RIMO (write_rimo, with the beams of sl) and its
    injection_maps: {rimo, maps}."""
    label = cfg.bands[b].label
    names = det_names(label, band.block.ndet)
    blm = None if sl is None else sl_beams(band.block.ndet, *sl, SL_SEED)
    rimo = write_rimo(out, label, band.cfg.nu, names, blm, det_bp)
    det_bps = det_bandpasses(rimo, names, cfg.bands[b].unit) if det_bp \
        else None
    maps = injection_maps(model, b, band, blm, det_bps,
                          cfg.bands[b].bandpass_model, device)
    return dict(rimo=rimo, maps=maps)


def finish_band(cfg, out: str, b: int, band, inputs: dict, zodi=False,
                dipole: float = 1.0, nfiles: int = 1,
                device="cpu") -> dict:
    """Band b's TOD with its terms injected (injected) and written
    (write_band) beside its RIMO: {filelist, rimo, files, bytes, seconds
    (of the writing), the terms' seconds, tod (host float64)}."""
    satpos = satpos_of(band.block.nscan)
    inj = injected(band, satpos, inputs["maps"], zodi, dipole, device)
    w = write_band(out, cfg.bands[b].label, band, inj["tod"], satpos,
                   inj["vsun"], nfiles)
    w["rimo"] = inputs["rimo"]
    if w["rimo"]:
        w["bytes"] += os.path.getsize(w["rimo"])
    w.update({k: inj[k] for k in ("sidelobe_s", "zodi_s", "det_sky_s",
                                  "dipole_s", "tod")},
             maps_s=inputs["maps"]["seconds"])
    return w


def write_archives(cfg, model, out: str, sl=None, zodi=False,
                   det_bp=False, nfiles: int = 1, device="cpu",
                   bands=None, dipole: float = 1.0) -> dict:
    """Every LFI band with a TOD type: simulated (or `bands`, simulate's
    output), the terms injected, written under out. Returns {overrides,
    per band {filelist, rimo, bytes, files, seconds and the terms'
    seconds}, simulate_s}."""
    from commander_tpu_torch.sampling.tod_gibbs import (has_tod_type,
                                                        is_differential)

    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    if bands is None:
        bands = simulate(cfg, model, [has_tod_type(b) for b in cfg.bands])
    sim_s = time.perf_counter() - t0
    written = {}
    for b, band in enumerate(bands):
        if band is None or is_differential(cfg.bands[b]):
            continue
        inputs = band_inputs(cfg, model, out, b, band, sl, det_bp, device)
        written[b] = finish_band(cfg, out, b, band, inputs, zodi, dipole,
                                 nfiles, device)
        del written[b]["tod"]
    return dict(overrides=overrides(cfg, written, zodi), bands=written,
                simulate_s=sim_s)


def main(argv=None) -> int:
    from commander_tpu_torch.driver.model import build_model
    from commander_tpu_torch.io.params import Params, lower_params

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("param")
    ap.add_argument("--out", required=True)
    ap.add_argument("--nside", type=int)
    ap.add_argument("--lmax", type=int)
    ap.add_argument("--pol", action="store_true")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--sidelobes", help="LMAX:MMAX of the sidelobe beams")
    ap.add_argument("--zodi", action="store_true")
    ap.add_argument("--det-bandpasses", action="store_true")
    ap.add_argument("--nfiles", type=int, default=1)
    ap.add_argument("--dipole", type=float, default=1.0,
                    help="the orbital dipole in units of the simulated one")
    args, rest = ap.parse_known_args(argv)
    if not args.synthetic:
        ap.error("the archives hold the synthetic command's TOD: "
                 "--synthetic")
    cfg = lower_params(Params.load(args.param, [a for a in rest
                                                if a.startswith("--")
                                                and "=" in a]))
    dev = "cpu" if args.cpu else "cuda"
    dtype = torch.float32 if args.f32 else torch.float64
    model = build_model(cfg, nside=args.nside, lmax=args.lmax,
                        synthetic=True, dtype=dtype, pol=args.pol,
                        device=dev)
    sl = tuple(int(x) for x in args.sidelobes.split(":")) \
        if args.sidelobes else None
    res = write_archives(cfg, model, args.out, sl, args.zodi,
                         args.det_bandpasses, args.nfiles, dev,
                         dipole=args.dipole)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
