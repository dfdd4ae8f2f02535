"""The port's TOD archive reader and writer (commander_tpu_torch/tod/loader.py
on io/hdf5.py) and instrument files (instrument/files.py) against the JAX
package's (tod/loader.py, instrument/files.py through h5py), on the same
files in both directions: every array of the block and state, and the
meta, equal.

Reference behaviour confirmed here (ROADMAP queue 3 items 20-23):
  (a) a differential archive read as an LFI one (what run() does with a
      WMAP band that has a filelist) raises KeyError in both packages;
  (b) read_archive_diff skips scan ids the archive lacks, read_archive
      raises KeyError on them;
  (c) load_band_tod masks every flagged sample by default (bad_flag_bits
      ~0), read_archive none (0);
  (d) a scan written without satpos carries [0, 0]: the zodi template is
      then the one of an observer at ecliptic longitude 0 and latitude 0,
      whatever the scan's time.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu.instrument import files as jfiles
from commander_tpu.tod import loader as JL
from commander_tpu.tod import zodi as JZ
from commander_tpu_torch.instrument import files as tfiles
from commander_tpu_torch.tod import loader as TL
from commander_tpu_torch.tod import zodi as TZ

NSIDE, NPIX = 8, 768
DETS = ["27M", "27S", "28M"]
WRITERS = {"jax": (JL.write_archive, JL.write_archive_diff),
           "port": (TL.write_archive, TL.write_archive_diff)}


def _scans(n, nt=300, seed=0, satpos=True, diff=False, nd=len(DETS)):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n):
        walk = lambda: np.cumsum(rng.integers(-2, 3, (nd, nt)), 1) % NPIX
        sc = dict(psi=rng.uniform(0, 2 * np.pi, (nd, nt)),
                  flag=(rng.uniform(size=(nd, nt)) < 0.1)
                  * rng.integers(1, 4, (nd, nt)),
                  tod=rng.standard_normal((nd, nt)) * 100.0,
                  vsun=rng.standard_normal(3) * 1e4,
                  scalars=rng.uniform(0.5, 2.0, (nd, 4)))
        if diff:
            sc.update(pixA=walk(), pixB=walk(), psiA=sc.pop("psi"),
                      psiB=rng.uniform(0, 2 * np.pi, (nd, nt)),
                      x_im=rng.uniform(-0.05, 0.05, nd))
        else:
            sc["pix"] = walk()
        if satpos and not diff:
            sc["satpos"] = [15.0 * s, 0.5 - 0.1 * s]
        out.append(sc)
    return out


def _same(bj, sj, mj, bt, st, mt, fields):
    for k in fields:
        a, b = np.asarray(getattr(bj, k)), getattr(bt, k).numpy()
        assert a.shape == b.shape and np.array_equal(a, b), k
    for k in ("gain", "sigma0", "fknee", "alpha", "n_corr"):
        assert np.array_equal(np.asarray(getattr(sj, k)),
                              getattr(st, k).numpy()), k
    assert bt.fsamp == bj.fsamp
    assert set(mt) == set(mj)
    for k, v in mj.items():
        assert np.array_equal(np.asarray(mt[k]), np.asarray(v)), k


@pytest.mark.parametrize("layout", ["lfi", "diff"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_archives_read_alike_both_ways(tmp_path, writer, layout):
    """Archives from either package's writer: both readers give the same
    block, state and meta, with a detector subset, scan ids and flag
    bits."""
    path = str(tmp_path / "a.h5")
    diff = layout == "diff"
    WRITERS[writer][diff](path, NSIDE, 32.5, DETS, _scans(3, diff=diff))
    kw = dict(bad_flag_bits=2, scan_ids=[1, 3], dets=["27S", "28M"])
    if diff:
        out_j = JL.read_archive_diff(path, **kw)
        out_t = TL.read_archive_diff(path, device="cpu", **kw)
        fields = ("tod", "pixA", "psiA", "pixB", "psiB", "mask", "vsun")
    else:
        out_j = JL.read_archive(path, **kw)
        out_t = TL.read_archive(path, device="cpu", **kw)
        fields = ("tod", "pix", "psi", "mask", "vsun", "satpos")
    _same(*out_j, *out_t, fields)
    blk = out_t[0]
    assert blk.tod.shape == (2, 2, 300) and 0 < float(blk.mask.mean()) < 1
    assert (blk.pixA if diff else blk.pix).dtype == torch.int32


def test_filelist_distribution_and_band_over_two_files(tmp_path):
    """read_filelist, distribute_scans and load_band_tod (two archive files
    of unequal scan lengths, a scan range, a detector subset, flag bits,
    two shards) as the JAX package gives them."""
    a0, a1 = _scans(3, nt=200, seed=1), _scans(2, nt=260, seed=2)
    TL.write_archive(str(tmp_path / "f0.h5"), NSIDE, 20.0, DETS, a0)
    JL.write_archive(str(tmp_path / "f1.h5"), NSIDE, 20.0, DETS, a1)
    rng = np.random.default_rng(3)
    lines = [f"{pid} {f} {rng.uniform(0.5, 2):.3f} "
             f"{rng.uniform(0.2, 2.9):.4f} {rng.uniform(0, 6.28):.4f}"
             for f, n in (("f0.h5", 3), ("f1.h5", 2))
             for pid in range(1, n + 1)]
    flist = str(tmp_path / "filelist.txt")
    with open(flist, "w") as f:
        f.write(f"{len(lines)}\n" + "\n".join(lines) + "\n")
    fj, ft = JL.read_filelist(flist, 2, 4), TL.read_filelist(flist, 2, 4)
    assert ft["filename"] == fj["filename"]
    for k in ("scanid", "weight", "spin"):
        assert np.array_equal(ft[k], fj[k]), k
    full = TL.read_filelist(flist)
    for nproc in (1, 2, 3):
        assert np.array_equal(
            TL.distribute_scans(full["weight"], full["spin"], nproc),
            JL.distribute_scans(full["weight"], full["spin"], nproc))
    for shard in (0, 1):
        kw = dict(bad_flag_bits=1, dets=["28M", "27M"], shard=shard,
                  nshard=2)
        out_j = JL.load_band_tod(flist, **kw)
        out_t = TL.load_band_tod(flist, device="cpu", **kw)
        _same(*out_j, *out_t, ("tod", "pix", "psi", "mask", "vsun",
                               "satpos"))
    bj, _, mj = JL.load_band_tod(flist, first_scan=2, last_scan=3)
    bt, _, mt = TL.load_band_tod(flist, first_scan=2, last_scan=3,
                                 device="cpu")
    assert mt["nscan"] == mj["nscan"] == 3 and bt.ntod == 260
    assert np.array_equal(bt.pix.numpy(), np.asarray(bj.pix))


def test_rimo_and_bandpass_files_read_alike_both_ways(tmp_path):
    """A RIMO with sidelobe and main-beam alms, scalars and per-detector
    bandpasses, written by either package: load_rimo_tod and
    load_bandpass_hdf (GHz nodes, a zero node dropped) alike
    in both; a detector the file lacks is KeyError in both."""
    rng = np.random.default_rng(4)

    def alm(nl, nm):
        a = rng.standard_normal((nl, nm)) + 1j * rng.standard_normal((nl, nm))
        a *= np.tril(np.ones((nl, nm)))
        a[:, 0] = a[:, 0].real
        return a
    dets = {d: dict(sl=alm(13, 3), beam=alm(9, 9), fwhm=32.0 + i,
                    centFreq=28.4, elip=1.1, bandpassx=np.linspace(
                        25.0, 32.0, 21), bandpass=np.r_[0.0, rng.uniform(
                            0.001, 1.0, 20)])
            for i, d in enumerate(DETS)}
    dets["28M"].pop("beam")
    for writer, wmod in (("jax", jfiles), ("port", tfiles)):
        path = str(tmp_path / f"rimo_{writer}.h5")
        wmod.write_rimo_tod(path, dets)
        rj = jfiles.load_rimo_tod(path, DETS)
        rt = tfiles.load_rimo_tod(path, DETS)
        for d in DETS:
            assert set(rt[d]) == set(rj[d])
            for k, v in rj[d].items():
                if v is None:
                    assert rt[d][k] is None, (d, k)
                else:
                    assert np.array_equal(rt[d][k], v), (d, k)
        assert rt["28M"]["beam"] is None
        assert np.allclose(rt["27M"]["sl"], dets["27M"]["sl"], atol=1e-15)
        for d in DETS:
            for ptype in ("LFI", "delta"):
                bj = jfiles.load_bandpass_hdf(path, d, profile_type=ptype)
                bt = tfiles.load_bandpass_hdf(path, d, profile_type=ptype)
                assert np.array_equal(bt.nu, bj.nu)
                assert np.array_equal(bt.tau, bj.tau)
                assert bt.unit == bj.unit and bt.profile_type == ptype
        with pytest.raises(KeyError):
            jfiles.load_rimo_tod(path, ["30M"])
        with pytest.raises(KeyError):
            tfiles.load_rimo_tod(path, ["30M"])
        with pytest.raises(KeyError):
            tfiles.load_bandpass_hdf(path, "30M")


def test_differential_archive_read_as_lfi_raises(tmp_path):
    """(a): read_archive on a differential archive reads <det>/pix, which it
    lacks: KeyError in both packages (the port refuses a WMAP band with a
    filelist before the build instead: test_torch_driver.py)."""
    path = str(tmp_path / "w.h5")
    TL.write_archive_diff(path, NSIDE, 10.0, DETS, _scans(2, diff=True))
    with pytest.raises(KeyError):
        JL.read_archive(path)
    with pytest.raises(KeyError):
        TL.read_archive(path, device="cpu")


def test_missing_scan_ids(tmp_path):
    """(b): scan ids the archive lacks: read_archive raises KeyError,
    read_archive_diff skips them, in both packages."""
    p, q = str(tmp_path / "l.h5"), str(tmp_path / "d.h5")
    TL.write_archive(p, NSIDE, 10.0, DETS, _scans(2))
    TL.write_archive_diff(q, NSIDE, 10.0, DETS, _scans(2, diff=True))
    for mod, kw in ((JL, {}), (TL, dict(device="cpu"))):
        with pytest.raises(KeyError, match="missing requested scan ids"):
            mod.read_archive(p, scan_ids=[2, 5], **kw)
        blk, _, _ = mod.read_archive_diff(q, scan_ids=[2, 5], **kw)
        assert blk.tod.shape[0] == 1


def test_flag_bit_defaults(tmp_path):
    """(c): load_band_tod masks every flagged sample by default
    (bad_flag_bits ~0), read_archive masks none (0), in both packages."""
    sc = _scans(2)
    path = str(tmp_path / "a.h5")
    TL.write_archive(path, NSIDE, 10.0, DETS, sc)
    flist = str(tmp_path / "fl.txt")
    with open(flist, "w") as f:
        f.write("2\n1 a.h5 1.0 0.5 0.1\n2 a.h5 1.0 0.6 0.2\n")
    flagged = np.stack([s["flag"] for s in sc]) != 0
    for mod, kw in ((JL, {}), (TL, dict(device="cpu"))):
        blk, _, _ = mod.read_archive(path, **kw)
        assert float(np.asarray(blk.mask).min()) == 1.0
        blk, _, _ = mod.load_band_tod(flist, **kw)
        assert np.array_equal(np.asarray(blk.mask) == 0, flagged)


def test_scan_without_satpos_gives_the_zodi_of_longitude_zero(tmp_path):
    """(d): a scan written without satpos reads back [0, 0] in both
    packages, and its zodi template is the one of an observer at ecliptic
    (0, 0): equal in both packages, and unlike a real position's."""
    path = str(tmp_path / "a.h5")
    TL.write_archive(path, NSIDE, 10.0, DETS, _scans(2, satpos=False))
    bj, _, _ = JL.read_archive(path)
    bt, _, _ = TL.read_archive(path, device="cpu")
    assert np.array_equal(np.asarray(bj.satpos), np.zeros((2, 2)))
    assert torch.equal(bt.satpos, torch.zeros(2, 2, dtype=torch.float64))
    zt = TZ.zodi_tod_template(NSIDE, bt.pix, bt.satpos, 30e9)
    zj = np.asarray(JZ.zodi_tod_template(NSIDE, jnp.asarray(bj.pix),
                                         jnp.asarray(bj.satpos), 30e9))
    assert np.abs(zt.numpy() - zj).max() <= 1e-12 * np.abs(zj).max()
    assert np.isfinite(zj).all() and np.abs(zj).max() > 0
    moved = TZ.zodi_tod_template(NSIDE, bt.pix, np.array(
        [[90.0, 0.0], [90.0, 0.0]]), 30e9)
    assert not torch.allclose(moved, zt)


def test_hdf5_opaque_and_string_datasets_read_by_h5py(tmp_path):
    """The port's HDF5 writer's opaque blobs, fixed-length strings and
    scalars read by h5py; a missing path is KeyError."""
    import h5py

    from commander_tpu_torch.io import hdf5

    path = str(tmp_path / "o.h5")
    with hdf5.File(path, "w") as f:
        f.put("g/blob", np.void(b"\x08\x00\xffab"))
        f.put("g/name", np.bytes_("27M, 27S"))
        f.put("x", np.float64(2.5))
    with h5py.File(path, "r") as f:
        assert f["g/blob"][()].tobytes() == b"\x08\x00\xffab"
        assert f["g/name"][()] == b"27M, 27S"
        assert f["x"][()] == 2.5 and f["x"].shape == ()
    with hdf5.File(path, "r") as f:
        assert f.read("g/blob").tobytes() == b"\x08\x00\xffab"
        assert "g/name" in f and "g/nope" not in f
        with pytest.raises(KeyError):
            f["g/nope"]
        with pytest.raises(KeyError):
            f.read("nope/x")
    assert os.path.getsize(path) > 0


def test_first_pass_on_the_input_maps(tmp_path, monkeypatch):
    """ROADMAP queue 3 item 25: the archive bands' first pass
    (init_band_maps_from_tod) runs on the band's input map, and on the
    tutorial's sky at nside 16 (band 030 from archives, 32 scans x 2
    detectors x 4096 samples) it keeps the gains within 5% of the
    simulated 1 and the chain finite after one iteration. run()'s form
    (loop._REFERENCE_FORM: the pass on a zero sky) anchors the gains on
    the orbital dipole alone: they come out more than 100% off, or not
    finite (1e15 here); with the archives' orbital dipole 30 times the
    simulated one (torch_tools/archives.py --dipole, the fixture of the
    parity test with run(), tests/test_torch_archive_run.py) within 20% (a
    5% bias of the mean, the sky's projection on the dipole) and the chain
    finite."""
    import sys

    from commander_tpu_torch.driver import loop
    from commander_tpu_torch.driver.model import build_model
    from commander_tpu_torch.io.params import Params, lower_params
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "torch_tools"))
    import archives

    over = ["--SYNTH_TOD_NSCAN=32", "--SYNTH_TOD_NTOD=4096",
            "--SYNTH_TOD_NDET=2", "--BAND_TOD_TYPE002=none",
            "--BAND_TOD_TYPE003=none"] + [
        f"--INCLUDE_COMP0{c}=.false." for c in range(4, 9)]
    param = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "param_tutorial_full.txt")
    cfg = lower_params(Params.load(param, over))
    model = build_model(cfg, nside=16, lmax=32, synthetic=True,
                        dtype=torch.float64, pol=True, device="cpu")
    gains = {}
    for dipole, reference in ((1.0, False), (1.0, True), (30.0, True)):
        monkeypatch.setattr(loop, "_REFERENCE_FORM", reference)
        arch = archives.write_archives(cfg, model,
                                       str(tmp_path / f"a{dipole}"),
                                       dipole=dipole)
        cfg_d = lower_params(Params.load(param, over + arch["overrides"]))
        res = loop.run(cfg_d, nside=16, lmax=32, synthetic=True, niter=1,
                       outdir=str(tmp_path / f"o{dipole}{reference}"),
                       dtype=torch.float64, verbose=False, pol=True,
                       tod=True, device="cpu")
        g = res.bands[0].state.gain
        gains[dipole, reference] = float(torch.nan_to_num(
            (g - 1.0).abs(), nan=np.inf).max())
        if (dipole, reference) != (1.0, True):
            assert bool(torch.isfinite(torch.view_as_real(
                res.state.a)).all())
    assert gains[1.0, False] <= 0.05 and gains[30.0, True] <= 0.2
    assert gains[1.0, True] > 1.0


def test_archives_hold_each_detectors_bandpass_sky(tmp_path):
    """torch_tools/archives.py's fixture matches its RIMO: each detector's
    TOD holds the sky of its RIMO bandpass at its offset
    (archives.DET_OFFSETS_HZ). The archives read back
    (loop.setup_archive_tod) less the run's own model of the truth -- the
    detectors' skies (loop.det_sky at bp_delta_det = the offsets, unit
    gain), the orbital dipole of the archives' vsun, the sidelobe and zodi
    terms (process.static_signal) -- leave the simulated noise: the
    residual is the simulator's own n_corr + white noise to the float32
    rounding of the archived TOD, and at zero offsets it is not."""
    import dataclasses
    import sys

    from commander_tpu_torch.driver import loop
    from commander_tpu_torch.driver.model import build_model
    from commander_tpu_torch.io.params import Params, lower_params
    from commander_tpu_torch.sampling import tod_gibbs
    from commander_tpu_torch.sampling.gibbs import GibbsState
    from commander_tpu_torch.tod.model import project_sky
    from commander_tpu_torch.tod.process import static_signal
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "torch_tools"))
    import archives

    over = ["--SYNTH_TOD_NSCAN=4", "--SYNTH_TOD_NTOD=2048",
            "--BAND_TOD_TYPE002=none", "--BAND_TOD_TYPE003=none",
            "--TOD_INCLUDE_ZODI=.true."]
    param = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "param_tutorial_full.txt")
    cfg = lower_params(Params.load(param, over))
    model = build_model(cfg, nside=8, lmax=16, synthetic=True,
                        dtype=torch.float64, pol=True, device="cpu")
    sim = archives.simulate(cfg, model, [True, False, False])[0]
    arch = archives.write_archives(cfg, model, str(tmp_path), sl=(12, 2),
                                   zodi=True, det_bp=True, dipole=30.0,
                                   bands=[sim, None, None])
    cfg = lower_params(Params.load(param, over + arch["overrides"]))
    band = loop.setup_archive_tod(cfg, model, "cpu", torch.float64)[0]
    # the read block at the simulator's own angles (the archives hold psi
    # in 4096 bins)
    blk = dataclasses.replace(band.block, psi=sim.block.psi)
    offs = np.asarray(archives.DET_OFFSETS_HZ[blk.ndet])
    assert band.det_bps is not None and band.zodi is not None
    st = GibbsState(a=model.truth, cl_bins=None, t=None, p=None)
    s_stat = static_signal(
        band.cfg, blk, tod_gibbs.pixel_vectors(8, torch.float64, "cpu"),
        tod_gibbs.band_sl_fmaps([band], model.sys, model.truth)[0],
        band.zodi, None, band.sl_pix)
    # the simulator's noise: its TOD less its sky and orbital dipole
    truth_n = sim.block.tod - project_sky(model.meta["sky_true"][0],
                                          sim.block.pix, sim.block.psi,
                                          True) - static_signal(
        sim.cfg, sim.block, tod_gibbs.pixel_vectors(8, torch.float64,
                                                    "cpu"))
    res = {}
    for name, dd in (("offsets", offs), ("zero", 0.0 * offs)):
        sky = loop.det_sky(cfg, model, model.sys, st,
                           [tuple(c.theta0) for c in model.diffuse],
                           band._replace(bp_delta_det=dd), 0,
                           model.meta["sky_true"][0], np.zeros(3))
        assert tuple(sky.shape) == (blk.ndet, 3, 768)
        resid = blk.tod - project_sky(sky, blk.pix, blk.psi, True) - s_stat
        res[name] = float((resid - truth_n).abs().max()
                          / blk.tod.abs().max())
    # the archives hold the TOD in float32: the residual to its rounding
    assert res["offsets"] <= 1e-6 < res["zero"]
