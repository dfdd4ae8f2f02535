"""run_multires' TOD branch and its FITS maps: the port's run.run_multires
against commander_tpu.run.run_multires, float64 on the CPU, on
test_torch_multires.py's reduced problem (cmb, synch and ff; 30 and 44 GHz
at nside 4 / lmax 8, 70 GHz at nside 8 / lmax 16; T/Q/U; every band
sampling its gain), 2 iterations, with run_multires' draws replayed and its
index lnL patched in (multires_gibbs._REFERENCE_FORM). Two cases:

  tod    --tod with band 044 differential (BAND_TOD_TYPE WMAP) beside the
         LFI band 030 in the nside-4 group, 070 at map level (no TOD
         type): run_multires' stand-in blocks (LFI 8 scans
         x 2 detectors x 4096 samples, the differential one 4 x 2 x 2048,
         seed 7 + band, sigma0 0.05 x the mean rms, T only), 3 burn-in
         passes on the zero sky, a pass per band ahead of each iteration,
         its (map, rms) into the band's T row (Q and U keep the map-level
         data: ROADMAP queue 3 item 18). The key chain: the chain key split
         once per band and burn-in pass, then per iteration once per band
         for its pass (process_tod's or process_tod_diff's draws through
         their own splits), then test_torch_multires._draws;
  fits   synthetic=False: each band's map, rms and mask written by the
         port's io/fits.py, at nside 8 for a band at 4 (degraded by the
         mean of the children), at 4 for the band at 8 (upgraded), and
         one band with no noise file and a fullsky mask (rms 10 and no
         mask, as build_multi_model keeps them).

The CG runs CG_MAXITER = 30 iterations at tol 1e-12 on both sides: the
TOD rows weigh their hit pixels ~1e5 times the map-level ones, and the
diagonal preconditioner does not converge such a system in 300; both
solvers then take the same 30 iterations. Held: both samples' alms to
1e-8 of their max, the index vector 1e-8 of its scale, the gains 1e-8
(the TOD case: TOD_BOUNDS), the CG iterations equal (the FITS case also
its rms rows and mask read as build_multi_model reads them, 1e-12).

TOD_BOUNDS: the differential stand-in's mapmaker runs to maxiter at x_im
0.01 (tests/test_torch_differential.py), so rounding moves its map, and
run_multires against itself with its TOD data moved by 1e-12 parts by
2.0e-8 (sample 1) and 4.4e-8 (sample 2) of the alms, 2.7e-8 of the index
vector's scale and 8.9e-9 in the gains (measured at this size: `PYTHONPATH=.
python3 tests/test_torch_multires_tod.py`, measure_spread); the bounds are 10x
that. The LFI stand-ins simulate their
orbital dipole at 30 GHz, as run_multires' do (the port gives each band its
own frequency: queue 3 item 4b).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from commander_tpu.run import build_multi_model, run_multires
from commander_tpu.tod.process import TodConfig as JTodConfig
from commander_tpu_torch import convert, entry
from commander_tpu_torch import run as trun
from commander_tpu_torch.io.chain import ChainFile
from commander_tpu_torch.io.fits import write_map
from commander_tpu_torch.sampling import multires_gibbs as mg
from commander_tpu_torch.tod import sim as tsim
from test_torch_differential import jax_diff_pass_draws
from test_torch_multires import _cfg, _chain_mr, _draws, _rel
from test_torch_tod import jax_pass_draws

torch.set_num_threads(1)

CG_MAXITER = 30
# 10x run_multires' own spread: alms, index vector, gains (module
# docstring)
TOD_BOUNDS = (4.4e-7, 2.7e-7, 8.9e-8)


def _tod_draws(key, cfg, band_slot, groups):
    """One split of key per TOD band, each into its pass's draws: (key,
    {band: draws})."""
    row = {}
    for i, band in enumerate(cfg.bands):
        if band.tod_type in (None, "none"):
            continue
        key, k = jax.random.split(key)
        ns = groups[band_slot[i][0]][0]
        kind = "diff" if str(band.tod_type).upper() == "WMAP" else "lfi"
        shape = tuple(mg.STANDIN[kind][n] for n in ("nscan", "ndet", "ntod"))
        mask = np.ones(shape)
        mask[..., :8] = 0.0
        if kind == "diff":
            row[i] = jax_diff_pass_draws(k, shape, mask)
            continue
        blk = type("B", (), dict(tod=type("T", (), dict(shape=shape)),
                                 mask=mask))
        row[i] = {n: tuple(torch.as_tensor(x) for x in v)
                  if isinstance(v, tuple) else torch.as_tensor(v)
                  for n, v in jax_pass_draws(k, JTodConfig(nside=ns, nu=1.0),
                                             blk, 12 * ns * ns).items()}
    return key, row


def _replay(case, tod):
    """draws(it) of run.run_multires along run_multires' key chain: 0 the
    burn-in's passes, then each iteration's (module docstring)."""
    key = case.key
    made = {}
    if tod:
        passes = []
        for _ in range(mg.TOD_BURNIN_PASSES):
            key, row = _tod_draws(key, case.cfg, case.meta["band_slot"],
                                  case.meta["groups"])
            passes.append(row)
        made[0] = {"tod": passes}

    def draws(it):
        nonlocal key
        while it not in made:
            row = None
            if tod:
                key, row = _tod_draws(key, case.cfg, case.meta["band_slot"],
                                      case.meta["groups"])
            d, key = _draws(case, key)
            made[max(made, default=0) + 1] = dict(d, tod=row)
        return made[it]
    return draws


def _fits_files(root):
    """Each band's files (module docstring); returns the overrides of the
    bands' file keys."""
    rng = np.random.default_rng(3)
    files = {}
    for label, ns in (("030", 8), ("044", 4), ("070", 4)):
        m = rng.standard_normal((3, 12 * ns * ns)) * 30.0 + 50.0
        write_map(str(root / f"map_{label}.fits"), m)
        files[label] = dict(mapfile=f"map_{label}.fits")
    write_map(str(root / "rms_030.fits"),
              rng.uniform(5.0, 15.0, (3, 12 * 4 * 4)))
    files["030"]["noisefile"] = "rms_030.fits"
    mask = (rng.uniform(size=(3, 12 * 8 * 8)) > 0.2).astype(float)
    write_map(str(root / "mask_030.fits"), mask)
    files["030"]["maskfile"] = "mask_030.fits"
    write_map(str(root / "rms_070.fits"),
              rng.uniform(5.0, 15.0, (3, 12 * 4 * 4)))
    files["070"].update(noisefile="rms_070.fits", maskfile="fullsky")
    files["044"].update(noisefile="none", maskfile="fullsky")
    return files


@pytest.mark.parametrize("case_name", ["tod", "fits"])
def test_run_multires_matches_run_multires(tmp_path, case_name, monkeypatch):
    """Both samples of the chain against run_multires' own (module
    docstring)."""
    cfg = _cfg(("cmb", "synch", "ff"), (4, 4, 8))
    cfg.cg_maxiter = CG_MAXITER
    tod = case_name == "tod"
    synthetic = tod
    if tod:
        cfg.enable_tod = True
        cfg.bands[1] = dataclasses.replace(cfg.bands[1], tod_type="WMAP")
        cfg.bands[2] = dataclasses.replace(cfg.bands[2], tod_type=None)
    else:
        for b in cfg.bands:
            for attr, fn in _fits_files(tmp_path)[b.label].items():
                setattr(b, attr, fn)
    kw = dict(synthetic=synthetic, pol=True, data_dir=str(tmp_path))
    ms, plans, diffuse, cl_cfg, meta, a_true = build_multi_model(cfg, **kw)
    case = type("Case", (), dict(
        ms=ms, plans=plans, cl_cfg=cl_cfg, meta=meta, cfg=cfg,
        key=jax.random.fold_in(jax.random.PRNGKey(cfg.base_seed), 1)))()
    tcfg = convert.run_config(dataclasses.asdict(cfg))
    case.pb = entry.build_multi_problem(
        tcfg, dtype=torch.float64, device="cpu", a_true=a_true, **kw)
    if not tod:
        assert case.pb.a_true is None
        for g, sys_g in enumerate(ms.groups):
            for k in ("inv_rms", "data"):
                assert _rel(getattr(case.pb.ms.groups[g], k).numpy(),
                            getattr(sys_g, k)) <= 1e-12, (g, k)
    _, jpath, _ = run_multires(cfg, niter=2, outdir=str(tmp_path / "jax"),
                               verbose=False, tod=tod, **kw)
    real_sim = tsim.simulate_tod
    monkeypatch.setattr(mg, "_REFERENCE_FORM", True)
    monkeypatch.setattr(mg, "simulate_tod",
                        lambda *a, **k: real_sim(*a, **dict(k, nu=30e9)))
    st, path, _ = trun.run_multires(
        tcfg, niter=2, outdir=str(tmp_path / "port"), verbose=False,
        device="cpu", draws=_replay(case, tod), a_true=a_true, tod=tod, **kw)
    if tod:
        assert sorted(st.bands) == [0, 1]
        assert st.bands[1].kind == "diff" and st.bands[0].kind == "lfi"
        assert not st.bands[0].cfg.pol
    got, ref = _chain_mr(path, ChainFile), _chain_mr(jpath, ChainFile)
    assert len(got) == len(ref) == 2
    b_alm, b_th, b_gain = TOD_BOUNDS if tod else (1e-8, 1e-8, 1e-8)
    for g, r in zip(got, ref):
        for name in r["comps"]:
            assert _rel(g["comps"][name]["alm"], r["comps"][name]["alm"]) \
                <= b_alm, name
        th_g, th_r = (np.asarray(s["aux"]["specind"]) for s in (g, r))
        assert np.abs(th_g - th_r).max() <= b_th * np.abs(th_r).max()
        assert np.abs(g["gain"] - r["gain"]).max() <= b_gain
        assert int(g["aux"]["cg_iters"]) == int(r["aux"]["cg_iters"])


def measure_spread(root):
    """run_multires' own spread for the tod case (module docstring): its
    chain against the same with its stand-ins' TOD moved by 1e-12; then
    the JAX run_multires of MULTIRES_TOD_ARGV's bands at nside 8 / 16 (the
    smoke's rehearsal size), its differential stand-in's x_im and gain per
    pass and the CG's relres per iteration (ROADMAP queue 3 item 16)."""
    import jax.numpy as jnp

    from commander_tpu.io.params import Params, lower_params
    from commander_tpu.tod import differential as JD
    from commander_tpu.tod import sim as JS

    cfg = _cfg(("cmb", "synch", "ff"), (4, 4, 8))
    cfg.cg_maxiter, cfg.enable_tod = CG_MAXITER, True
    cfg.bands[1] = dataclasses.replace(cfg.bands[1], tod_type="WMAP")
    cfg.bands[2] = dataclasses.replace(cfg.bands[2], tod_type=None)
    real = (JD.simulate_tod_diff, JS.simulate_tod)

    def moved(fn):
        def f(*a, **k):
            b, t = fn(*a, **k)
            return dataclasses.replace(b, tod=b.tod * (1.0 + 1e-12)), t
        return f

    kw = dict(niter=2, synthetic=True, verbose=False, tod=True, pol=True)
    _, p1, _ = run_multires(cfg, outdir=str(root / "a"), **kw)
    JD.simulate_tod_diff, JS.simulate_tod = (moved(f) for f in real)
    try:
        _, p2, _ = run_multires(cfg, outdir=str(root / "b"), **kw)
    finally:
        JD.simulate_tod_diff, JS.simulate_tod = real
    for i, (g, r) in enumerate(zip(_chain_mr(p2, ChainFile),
                                   _chain_mr(p1, ChainFile)), start=1):
        th_g, th_r = (np.asarray(s["aux"]["specind"]) for s in (g, r))
        th = np.abs(th_g - th_r).max() / np.abs(th_r).max()
        print(f"sample {i}: alms " + ", ".join(
            f"{n} {_rel(g['comps'][n]['alm'], c['alm']):.3g}"
            for n, c in r["comps"].items())
            + f"; index vector {th:.3g}; gains "
            f"{np.abs(g['gain'] - r['gain']).max():.3g}")
    real_pass = JD.process_tod_diff

    def spy(*a, **k):
        st, p = real_pass(*a, **k)
        jax.debug.print("differential pass: x_im mean {x}, gain mean {g}",
                        x=jnp.mean(p["x_im"]), g=jnp.mean(st.gain))
        return st, p

    p = Params.load("param_tutorial_full.txt")
    for k, v in (("BAND_NSIDE001", "8"), ("BAND_LMAX001", "16"),
                 ("BAND_NSIDE002", "8"), ("BAND_LMAX002", "16"),
                 ("BAND_TOD_TYPE002", "WMAP")):
        p.table[k] = v
    JD.process_tod_diff = spy
    try:
        run_multires(lower_params(p), outdir=str(root / "cli"), max_nside=16,
                     **dict(kw, verbose=True))
    finally:
        JD.process_tod_diff = real_pass


if __name__ == "__main__":
    # PYTHONPATH=. python3 tests/test_torch_multires_tod.py: the spread behind
    # TOD_BOUNDS and the JAX run_multires with a differential stand-in at
    # nside 8 / 16 (float64 on the CPU, a few minutes)
    import pathlib
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    measure_spread(pathlib.Path(tempfile.mkdtemp()))
