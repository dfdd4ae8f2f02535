"""The port's program (commander_tpu_torch.run: build_model, run()'s loop,
the reject rule, resume, INIT_CHAIN, main) against the JAX package's, float64
on the CPU.

The JAX side runs commander_tpu.run.run as its command line does
(param_tutorial_full.txt --synthetic --pol at nside 16 / lmax 32), once per
configuration in module-scoped fixtures, and its chain files are read back
with the port's ChainFile. The port's loop runs the same configuration with
run()'s draws replayed attempt by attempt, and the index phase's
amplitude maps in run()'s spin-0 form (full_gibbs._amp_synth; ROADMAP
queue 3 has the divergence): fold_in(PRNGKey(BASE_SEED),
chain), skey = fold_in(key, 552), one split of skey per attempt into the
step's key fk (gibbs_step's (next, k_amp, k_cl) split, compute_rhs_joint's
draws under k_amp, the index uniforms under fold_in(next, 17)), then one
split per gain-sampling band; the truth alms are the JAX build_model's.

Tolerances: build_model's b_l, F, cl0, masks, templates and source stamps
1e-12, its data 1e-10 (the port synthesizes on the fly, the JAX package by
its Legendre tables); the chain samples 1e-8 (alms relative to their max,
indices and amplitudes absolute in units of max(1, |value|)); the reject
rule: the same accepted and rejected attempts, in the same order.

The reject rule is tests/test_torch_driver_reject.py (two cases, dealt
beside tests/test_sharding.py).
"""
import dataclasses
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu import run as jrun
from commander_tpu.io.params import Params as JParams
from commander_tpu.io.params import lower_params as j_lower
from commander_tpu.sphere.alm import random_alm_white as j_random_alm_white
from commander_tpu_torch import run as trun
from commander_tpu_torch.driver import loop, model as tmodel
from commander_tpu_torch.io.chain import ChainFile
from commander_tpu_torch.io.params import Params, lower_params
from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sampling import tod_gibbs
from commander_tpu_torch.sphere import sht as tsht
from test_torch_differential import jax_diff_pass_draws
from test_torch_tod import jax_pass_draws

torch.set_num_threads(2)

PARAMS = "param_tutorial_full.txt"
NSIDE, LMAX = 16, 32


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _cfgs(*overrides):
    """The JAX and the port's lowering of the file with `overrides`."""
    jp = JParams.load(PARAMS)
    for o in overrides:
        k, v = o[2:].split("=", 1)
        jp.table[k] = v
    return j_lower(jp), lower_params(Params.load(PARAMS, overrides))


def _truth(jcfg, nside=NSIDE, lmax=LMAX):
    """JAX build_model at the test size: its outputs and truth alms."""
    out = jrun.build_model(jcfg, nside=nside, lmax=lmax, synthetic=True,
                           dtype="float64", pol=True)
    truth = out[7]
    return out, truth[0] + 1j * truth[1]


def step_draws(fk, model, nslot=0):
    """The draws of one gibbs_step under key fk, as run() makes them:
    (next, k_amp, k_cl) = split(fk, 3), compute_rhs_joint's draws under
    k_amp, the binned components' gammas under fold_in(k_cl, c) and, with
    nslot > 0, the fast path's index uniforms under fold_in(next, 17).
    Returns (draws, next)."""
    sys = model.sys
    C, S, nl = len(model.diffuse), model.meta["nmaps"], model.meta["lmax"] + 1
    ntemp = 0 if model.ts is None else model.ts.ntemp
    nsrc = 0 if model.ps is None else model.ps.pix.shape[0]
    nbins = max([len(model.cl_cfg.bin_starts)]
                + [len(cc.bin_starts) for cc in model.cl_cfgs])
    nxt, k_amp, k_cl = jax.random.split(fk, 3)
    k1, k2 = jax.random.split(k_amp)
    d = {"eta1": np.array(jax.random.normal(k1, tuple(sys.data.shape),
                                            jnp.float64)),
         "eta2": np.array(j_random_alm_white(k2, (C, S, nl, nl),
                                             jnp.float64))}
    if ntemp:
        kt, k2 = jax.random.split(k2)
        d["eta_t"] = np.array(jax.random.normal(kt, (ntemp,), jnp.float64))
    if nsrc:
        kp, k2 = jax.random.split(k2)
        d["eta_p"] = np.array(jax.random.normal(kp, (nsrc,), jnp.float64))
    gamma = np.zeros((C, S, nbins))
    for c, cc in enumerate(model.cl_cfgs):
        if cc.kind != "binned":
            continue
        idx = np.searchsorted(np.asarray(cc.bin_starts), np.arange(nl),
                              side="right") - 1
        nmodes = np.bincount(idx, weights=2.0 * np.arange(nl) + 1.0,
                             minlength=len(cc.bin_starts))
        shape = np.maximum(-1.0 + nmodes / 2.0, 0.5)
        gamma[c, :, :len(shape)] = np.asarray(jax.random.gamma(
            jax.random.fold_in(k_cl, c),
            jnp.asarray(shape)[None, :].repeat(S, 0)))
    d["gamma"] = gamma
    if nslot:
        k_ind, u = jax.random.fold_in(nxt, 17), []
        for _ in range(nslot):
            k_ind, k = jax.random.split(k_ind)
            u.append(float(jax.random.uniform(k, (1,), jnp.float64)[0]))
        d["u"] = np.asarray(u)
    return {k: torch.as_tensor(v) for k, v in d.items()}, nxt


def replay(jcfg, model, chain=1, first=None):
    """draws(attempt, bands, npasses) of the port's loop: run()'s own, from
    its key chain (module docstring): each new attempt takes the next split
    of skey and, with TOD bands, one split of tkey = fold_in(key, 991) per
    band (process_tod's draws through its own splits); attempt 0 is the TOD
    warm start: gibbs_step's draws under the state's key (the chain key, or
    fold_in(key, max(first, 1)) where a sample seeds the state: pass
    `first`, the resume point), then one split of fold_in(key, 772) per
    pass and band. The chains start anew in every run (a resume too).
    run()'s draws are float64 in either dtype (its data are)."""
    key = jax.random.fold_in(jax.random.PRNGKey(jcfg.base_seed), chain)
    skey = jax.random.fold_in(key, 552)
    tkey = jax.random.fold_in(key, 991)
    nslot = len([1 for d in model.diffuse for _ in d.theta0
                 if d.sed not in ("cmb", "md", "template", "line")])
    gain_bands = [b for b, band in enumerate(jcfg.bands)
                  if band.sample_gain and band.gain_prior_rms >= 0]
    made = {}
    tod_row = tod_draws_row

    def draws(attempt, bands=None, npasses=0):
        nonlocal skey, tkey
        if attempt == 0:
            k0 = key if first is None else jax.random.fold_in(
                key, max(first, 1))
            d, k = step_draws(k0, model)[0], jax.random.fold_in(key, 772)
            d["tod"] = []
            for _ in range(npasses):
                k, row = tod_row(k, bands)
                d["tod"].append(row)
            return d
        if attempt not in made:
            skey, fk = jax.random.split(skey)
            d = step_draws(fk, model, nslot)[0]
            d["eps_gain"], skey = gain_eps(jcfg, gain_bands, skey)
            if bands:
                tkey, d["tod"] = tod_row(tkey, bands)
            made[attempt] = d
        return made[attempt]

    return draws


def tod_draws_row(k, bands):
    """One split of k per band with TOD (None: none, and no split), each
    into process_tod's draws, or process_tod_diff's on a differential band:
    (k after, the row)."""
    row = []
    for band in bands:
        if band is None:
            row.append(None)
            continue
        k, kb = jax.random.split(k)
        if band.kind == "diff":
            row.append(jax_diff_pass_draws(kb, tuple(band.block.tod.shape),
                                           band.block.mask.cpu().numpy()))
            continue
        blk = SimpleNamespace(tod=SimpleNamespace(
            shape=tuple(band.block.tod.shape)),
            mask=jnp.asarray(band.block.mask.cpu().numpy(), jnp.float64))
        row.append({n: tuple(torch.as_tensor(x) for x in v)
                    if isinstance(v, tuple) else torch.as_tensor(v)
                    for n, v in jax_pass_draws(
                        kb, band.cfg, blk, 12 * band.cfg.nside ** 2).items()})
    return k, row


def gain_eps(jcfg, gain_bands, skey):
    """One split of skey per gain-sampling band (soft prior), each into a
    normal: ((B,) eps, the split key) as run()'s gain loop takes them."""
    eps = np.zeros(len(jcfg.bands))
    for b in gain_bands:
        skey, gk = jax.random.split(skey)
        eps[b] = float(jax.random.normal(gk, (), jnp.float64))
    return torch.as_tensor(eps), skey


def _samples(path):
    with ChainFile(path, "r") as ch:
        return {i: ch.read_sample(i) for i in range(1, ch.last_sample() + 1)
                if ch.sample_name(i) in ch.f.root.members}


def _same_samples(got, ref, its):
    for i in its:
        g, r = got[i], ref[i]
        assert set(g["comps"]) == set(r["comps"])
        for name in r["comps"]:
            assert _rel(g["comps"][name]["alm"], r["comps"][name]["alm"]) \
                <= 1e-8, (i, name)
            for k in ("Dl", "specind"):
                a, b = g["comps"][name][k], r["comps"][name][k]
                assert a.shape == b.shape
                assert np.all(np.abs(a - b) <= 1e-8 * np.maximum(
                    1.0, np.abs(b))), (i, name, k)
        for k in ("md_amps", "ptsrc_amps", "chisq", "cg_iters"):
            a, b = np.asarray(g["aux"][k]), np.asarray(r["aux"][k])
            assert np.all(np.abs(a - b) <= 1e-8 * np.maximum(1.0, np.abs(b))
                          ), (i, k)
        assert np.allclose(g["gain"], r["gain"], rtol=0, atol=1e-10)


def _jax_run(jcfg, outdir, niter, chain_from=None, nside=NSIDE, lmax=LMAX):
    if chain_from:
        os.makedirs(outdir, exist_ok=True)
        shutil.copy(chain_from, os.path.join(outdir, "chain_c0001.h5"))
    _, path = jrun.run(jcfg, nside=nside, lmax=lmax, synthetic=True,
                       niter=niter, outdir=str(outdir), dtype="float64",
                       verbose=False, pol=True)
    return path


def _port_run(tcfg, jcfg, model, outdir, niter, a_true, chain_from=None,
              nside=NSIDE, lmax=LMAX):
    """The port's loop with run()'s draws replayed (model: the port's
    build_model of the configuration, for the draws' shapes)."""
    if chain_from:
        os.makedirs(outdir, exist_ok=True)
        shutil.copy(chain_from, os.path.join(outdir, "chain_c0001.h5"))
    with pytest.MonkeyPatch.context() as mp:
        # run()'s index phase maps the T/E/B amplitudes with the spin-0
        # transform (a declared divergence, ROADMAP queue 3): its form here
        mp.setattr(tfg, "_amp_synth", tsht.alm2map)
        return loop.run(tcfg, nside=nside, lmax=lmax, synthetic=True,
                        niter=niter, outdir=str(outdir), dtype=torch.float64,
                        verbose=False, pol=True, device="cpu",
                        draws=replay(jcfg, model), a_true=a_true)


def _port_model(tcfg, truth, nside=NSIDE, lmax=LMAX):
    return tmodel.build_model(tcfg, nside=nside, lmax=lmax, synthetic=True,
                              dtype=torch.float64, pol=True, device="cpu",
                              a_true=truth)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """The file's 2-iteration chain by both drivers, and a resume of each to
    3 iterations from the 2-sample JAX chain."""
    jcfg, tcfg = _cfgs()
    jout, truth = _truth(jcfg)
    root = tmp_path_factory.mktemp("driver")
    model = _port_model(tcfg, truth)
    jpath = _jax_run(jcfg, root / "jax", 2)
    tres = _port_run(tcfg, jcfg, model, root / "port", 2, truth)
    jres3 = _jax_run(jcfg, root / "jax3", 3, chain_from=jpath)
    tres3 = _port_run(tcfg, jcfg, model, root / "port3", 3, truth,
                      chain_from=jpath)
    # a fresh chain warm-started from the JAX chain's sample 1, writing the
    # chi^2 and residual FITS maps
    ji, ti = _cfgs(f"--INIT_CHAIN={jpath}:1", "--OUTPUT_CHISQ_MAP=.true.",
                   "--OUTPUT_RESIDUAL_MAPS=.true.")
    jinit = _jax_run(ji, root / "jax_init", 1)
    tinit = _port_run(ti, ji, model, root / "port_init", 1, truth)
    return dict(jcfg=jcfg, tcfg=tcfg, jout=jout, truth=truth, jpath=jpath,
                model=model, tres=tres, jres3=jres3, tres3=tres3, root=root,
                jinit=jinit, tinit=tinit)


def test_chain_matches_the_jax_driver(chains):
    """run()'s 2 samples (alms, D_l, indices, md / source amplitudes,
    chi^2, CG iterations, gains) from the port's loop with run()'s draws, to
    1e-8; each package's ChainFile reads the other's file the same."""
    from commander_tpu.io.chain import ChainFile as JChainFile

    got, ref = _samples(chains["tres"].chain_path), _samples(chains["jpath"])
    assert sorted(got) == sorted(ref) == [1, 2]
    _same_samples(got, ref, (1, 2))
    assert all(r["ok"] for r in chains["tres"].records)
    with JChainFile(chains["tres"].chain_path, "r") as jc:
        s = jc.read_sample(2)
        assert np.array_equal(s["comps"]["cmb"]["alm"],
                              got[2]["comps"]["cmb"]["alm"])
        meta = jc.read_metadata()
    assert meta["comps"] == "cmb,synch,dust,ff,ame" and meta["nside"] == NSIDE


def test_resume_from_a_jax_chain_matches(chains):
    """Resume to 3 iterations from the JAX driver's 2-sample chain: both
    drop sample 2, restart from sample 1's alms and gains, and write the
    same samples 2 and 3."""
    got, ref = _samples(chains["tres3"].chain_path), _samples(
        chains["jres3"])
    assert sorted(got) == sorted(ref) == [1, 2, 3]
    _same_samples(got, ref, (2, 3))
    assert [r["it"] for r in chains["tres3"].records] == [2, 3]


def test_init_chain_from_a_jax_chain_matches(chains):
    """INIT_CHAIN = <JAX chain>:1 seeds a new chain: both drivers report
    the warm start and write the same first sample. (The fast path's
    amplitude draw does not depend on the previous alms, so the sample
    equals the cold start's: what the warm start carries here is the
    state, and the gains.)"""
    got, ref = _samples(chains["tinit"].chain_path), _samples(
        chains["jinit"])
    _same_samples(got, ref, (1,))
    for path in (chains["tinit"].chain_path, chains["jinit"]):
        status = open(os.path.join(os.path.dirname(path),
                                   "comm_status.txt")).read()
        assert f"warm start from {chains['jpath']}:1" in status


@pytest.mark.parametrize("name", ["chisq_k000001.fits",
                                  "res_030_k000001.fits",
                                  "res_070_k000001.fits"])
def test_fits_outputs_match(chains, name):
    """OUTPUT_CHISQ_MAP / OUTPUT_RESIDUAL_MAPS: the chi^2 map (summed over
    bands) and each band's residual maps, as float32 FITS, to 1e-6 of
    their max (the float32 rounding of the written values)."""
    from commander_tpu.io import fits as jfits

    got = jfits.read_map(os.path.join(
        os.path.dirname(chains["tinit"].chain_path), name))
    ref = jfits.read_map(os.path.join(os.path.dirname(chains["jinit"]),
                                      name))
    assert got.shape == ref.shape == (3, 12 * NSIDE ** 2)
    assert _rel(got, ref) <= 1e-6


def test_build_model_matches(chains):
    """build_model (synthetic branch) field by field: F, b_l with the pixel
    window, cl0, masks, the C_l configs, md / relquad templates and their
    priors, source stamps 1e-12; data and the noiseless sky 1e-10."""
    from commander_tpu.instrument.beam import gaussian_bl, pixel_window

    jout, m = chains["jout"], chains["model"]
    plan, sys, diffuse, bps, cl_cfg, cl0, meta, _, _, ts, ps, cl_cfgs = jout
    for f in ("F", "bl", "cl", "inv_rms", "inv_rms2", "tri"):
        assert _rel(getattr(m.sys, f).numpy(), getattr(sys, f)) <= 1e-12, f
    for f in ("data",):
        assert _rel(getattr(m.sys, f).numpy(), getattr(sys, f)) <= 1e-10, f
    assert _rel(m.meta["sky_true"].numpy(), meta["sky_true"]) <= 1e-10
    # b_l carries the pixel window (run.py:194)
    pw = pixel_window(NSIDE, LMAX)
    assert _rel(m.sys.bl[0, 0].numpy(),
                gaussian_bl(chains["tcfg"].bands[0].beam_fwhm_arcmin, LMAX)
                * pw) <= 1e-12
    assert _rel(m.cl0, cl0) <= 1e-12
    assert dataclasses.asdict(m.cl_cfg) == dataclasses.asdict(cl_cfg)
    assert [dataclasses.asdict(c) for c in m.cl_cfgs] == \
        [dataclasses.asdict(c) for c in cl_cfgs]
    assert [d.name for d in m.diffuse] == [d.name for d in diffuse]
    assert [d.theta0 for d in m.diffuse] == [d.theta0 for d in diffuse]
    assert _rel(m.ts.dense().numpy(), ts.maps) <= 1e-12
    for f in ("prior_mean", "prior_istd"):
        assert _rel(getattr(m.ts, f).numpy(), getattr(ts, f)) <= 1e-12
    assert np.array_equal(m.ps.pix.numpy(), np.asarray(ps.pix))
    assert _rel(m.ps.stamp.numpy(), ps.stamp) <= 1e-12
    assert m.meta["template_names"] == meta["template_names"]
    assert np.array_equal(m.meta["ptsrc_true"], meta["ptsrc_true"])


def test_build_model_from_fits_matches(tmp_path):
    """The FITS branch: band maps, rms and masks written at nside 32 and
    ud-graded to 16, a b_l table, a Cl bin file: sys and the C_l configs of
    both packages 1e-12."""
    from commander_tpu.io import fits as jfits

    rng = np.random.default_rng(3)
    npix = 12 * 32 * 32
    over = []
    for i in (1, 2, 3):
        jfits.write_map(str(tmp_path / f"map{i}.fits"),
                        rng.standard_normal((3, npix)) * 30)
        jfits.write_map(str(tmp_path / f"rms{i}.fits"),
                        rng.uniform(5, 15, (3, npix)))
        jfits.write_map(str(tmp_path / f"mask{i}.fits"),
                        (rng.random((3, npix)) > 0.2).astype(float))
        over += [f"--BAND_MAPFILE00{i}=map{i}.fits",
                 f"--BAND_NOISEFILE00{i}=rms{i}.fits",
                 f"--BAND_MASKFILE00{i}=mask{i}.fits"]
    _write_bl_table(tmp_path / "bl.fits", np.linspace(1.0, 0.5, 40)[:, None]
                    * np.array([1.0, 0.9, 0.8]))
    (tmp_path / "bins.dat").write_text("2 10 SSSSSS\n11 20 S00S0S\n")
    over += ["--BAND_BEAM_B_L_FILE002=bl.fits", "--COMP_CL_TYPE01=binned",
             "--COMP_CL_BIN_FILE01=bins.dat"]
    jcfg, tcfg = _cfgs(*over)
    jo = jrun.build_model(jcfg, nside=NSIDE, lmax=LMAX, dtype="float64",
                          pol=True, data_dir=str(tmp_path))
    to = tmodel.build_model(tcfg, nside=NSIDE, lmax=LMAX,
                            dtype=torch.float64, pol=True, device="cpu",
                            data_dir=str(tmp_path))
    for f in ("F", "bl", "cl", "data", "inv_rms", "inv_rms2"):
        assert _rel(getattr(to.sys, f).numpy(), getattr(jo[1], f)) <= 1e-12
    assert [dataclasses.asdict(c) for c in to.cl_cfgs] == \
        [dataclasses.asdict(c) for c in jo[11]]
    assert to.cl_cfgs[0].sample_bins


def _write_bl_table(path, cols):
    """A b_l BINTABLE (one row per ell, one column per spectrum) through
    the port's FITS card writer."""
    from commander_tpu_torch.io import fits as tfits

    nl, nc = cols.shape
    hdr = {"XTENSION": "BINTABLE", "BITPIX": 8, "NAXIS": 2,
           "NAXIS1": 8 * nc, "NAXIS2": nl, "PCOUNT": 0, "GCOUNT": 1,
           "TFIELDS": nc}
    for i in range(nc):
        hdr[f"TTYPE{i + 1}"] = f"C{i}"
        hdr[f"TFORM{i + 1}"] = "1D"
    table = np.empty(nl, dtype=[(f"c{i}", ">f8") for i in range(nc)])
    for i in range(nc):
        table[f"c{i}"] = cols[:, i]
    data = table.tobytes()
    with open(path, "wb") as f:
        f.write(tfits._cards({"SIMPLE": True, "BITPIX": 8, "NAXIS": 0,
                              "EXTEND": True}))
        f.write(tfits._cards(hdr))
        f.write(data + b"\0" * ((-len(data)) % 2880))


def _status(outdir):
    """The accept (True) / reject (False) sequence of a status file."""
    out = []
    with open(os.path.join(outdir, "comm_status.txt")) as f:
        for line in f:
            if " iter " in line and "tod" not in line:
                out.append("REJECTED" not in line)
    return out


def test_output_input_model_matches(tmp_path):
    """OUTPUT_INPUT_MODEL: both drivers write the input model as sample
    999999 (alms, D_l, indices, gains) and stop."""
    jcfg, tcfg = _cfgs("--OUTPUT_INPUT_MODEL=.true.")
    _, truth = _truth(jcfg, 8, 16)
    jpath = _jax_run(jcfg, tmp_path / "jax", 1, nside=8, lmax=16)
    res = loop.run(tcfg, nside=8, lmax=16, synthetic=True, niter=1,
                   outdir=str(tmp_path / "port"), dtype=torch.float64,
                   verbose=False, pol=True, device="cpu", a_true=truth)
    got, ref = _samples(res.chain_path), _samples(jpath)
    assert sorted(got) == sorted(ref) == [999999] and not res.records
    g, r = got[999999], ref[999999]
    for name in r["comps"]:
        for k in ("alm", "Dl", "specind"):
            a, b = g["comps"][name][k], r["comps"][name][k]
            assert a.shape == b.shape and (not b.size or _rel(a, b) <= 1e-12)
    assert np.array_equal(g["gain"], r["gain"])


SCALE = ["--NUM_SMOOTHING_SCALES=1", "--SMOOTHING_SCALE_FWHM01=600",
         "--SMOOTHING_SCALE_FWHM_POSTPROC01=600",
         "--SMOOTHING_SCALE_NSIDE01=4", "--SMOOTHING_SCALE_LMAX01=8"]
# the TOD cases' TOD, cut to a size the CPU runs in seconds
SMALL_TOD = ["--SYNTH_TOD_NSCAN=4", "--SYNTH_TOD_NTOD=2048"]
# (id, arguments, what the configuration does): "runs" -- run()'s host loop,
# ported; "raises" -- not ported
REFUSED = [
    ("--pixind", ["--pixind"], "runs"), ("--te-cl", ["--te-cl"], "runs"),
    ("--cg-groups", ["--cg-groups"], "runs"),
    ("--RESAMPLE_CMB=.true.", ["--RESAMPLE_CMB=.true."], "runs"),
    ("--COMP_LMAX_IND02=8", ["--COMP_LMAX_IND02=8"], "runs"),
    ("--COMP_BETA_SMOOTHING_SCALE02=1",
     ["--pixind", "--COMP_BETA_SMOOTHING_SCALE02=1"] + SCALE, "runs"),
    ("--COMP_BETA_POLTYPE02=2", ["--COMP_BETA_POLTYPE02=2"], "runs"),
    ("ALMSAMP_PIXREG", ["--COMP_LMAX_IND02=8", "--ALMSAMP_PIXREG=.true.",
                        "--COMP_BETA_NUM_PIXREG02=12"], "runs"),
    ("--OUTPUT_EVERY_NTH_CG_ITERATION=2",
     ["--OUTPUT_EVERY_NTH_CG_ITERATION=2"], "runs"),
    ("--tod", ["--tod"] + SMALL_TOD, "runs"),
    ("--pixind --tod --f32", ["--pixind", "--tod", "--f32"] + SMALL_TOD,
     "runs"),
    ("--COMP_LMAX_IND02=8 --tod --f32",
     ["--COMP_LMAX_IND02=8", "--tod", "--f32"] + SMALL_TOD, "runs"),
    ("--tod --f32 --BAND_SAMP_BANDPASS001=.true.",
     ["--tod", "--f32", "--BAND_SAMP_BANDPASS001=.true."] + SMALL_TOD,
     "runs"),
    ("--tod --f32 --TOD_OUTPUT_4D_MAP_EVERY_NTH_ITER=1",
     ["--tod", "--f32", "--TOD_OUTPUT_4D_MAP_EVERY_NTH_ITER=1"] + SMALL_TOD,
     "runs"),
    ("--tod --BAND_TOD_TYPE001=WMAP --BAND_TOD_FILELIST001=files.txt",
     ["--tod", "--BAND_TOD_TYPE001=WMAP", "--BAND_TOD_FILELIST001=files.txt"],
     "raises"),
    ("--tod --f32 --SAMPLE_TOD_MONOPOLE=.true.",
     ["--tod", "--f32", "--SAMPLE_TOD_MONOPOLE=.true."] + SMALL_TOD, "runs"),
    ("--tod --f32 --BAND_TOD_TYPE002=none",
     ["--tod", "--f32", "--BAND_TOD_TYPE002=none"] + SMALL_TOD, "runs"),
    ("--tod --f32 --BAND_POLARIZATION002=.false.",
     ["--tod", "--f32", "--BAND_POLARIZATION002=.false."] + SMALL_TOD,
     "runs"),
    ("--tod --f32 --BAND_TOD_TYPE002=WMAP",
     ["--tod", "--f32", "--BAND_TOD_TYPE002=WMAP"] + SMALL_TOD, "runs"),
    ("--tod --SAMPLE_TOD_MONOPOLE=.true. --BAND_TOD_TYPE002=WMAP",
     ["--tod", "--SAMPLE_TOD_MONOPOLE=.true.", "--BAND_TOD_TYPE002=WMAP",
      "--tod-mono-guard"] + SMALL_TOD, "runs"),
    ("--tod --BAND_TOD_TYPE002=WMAP --BAND_SAMP_BANDPASS002=.true.",
     ["--tod", "--BAND_TOD_TYPE002=WMAP", "--BAND_SAMP_BANDPASS002=.true."],
     "raises"),
]


@pytest.mark.parametrize("args,what", [c[1:] for c in REFUSED],
                         ids=[c[0] for c in REFUSED])
def test_host_loop_configurations_raise(tmp_path, args, what):
    """What leaves run()'s fast path: its host loop runs (2 iterations at
    nside 8, a chain whose samples carry the theta_map entries of the
    map-valued indices, or the per-Stokes-group values; with --tod the TOD
    states of the bands with TOD); what is not ported raises
    NotImplementedError naming ROADMAP, before any work."""
    argv = [PARAMS, "--synthetic", "--pol", "--cpu", "--nside", "8",
            "--lmax", "16", "--niter", "2", "--outdir", str(tmp_path)] + args
    if what == "raises":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            trun.main(argv)
        assert not os.path.exists(tmp_path / "chain_c0001.h5")
        return
    (res,) = trun.main(argv)
    assert res.host is not None
    with ChainFile(res.chain_path, "r") as ch:
        assert ch.last_sample() == 2
        s = ch.read_sample(2)
    comps = s["comps"]
    maps = {(c, k) for c, f in comps.items() for k in f
            if k.startswith("theta_map")}
    if "--pixind" in args or "--COMP_LMAX_IND02=8" in args:
        assert ("synch", "theta_map0") in maps
        tm = comps["synch"]["theta_map0"]
        assert tm.shape == (12 * 8 * 8,) and np.all(np.isfinite(tm))
        assert np.isclose(comps["synch"]["specind"][0], tm.mean())
    else:
        assert not maps
    if "--COMP_BETA_POLTYPE02=2" in args:
        assert comps["synch"]["specind_pol0"].shape == (1,)
    assert np.isfinite(s["aux"]["chisq"])
    if "--te-cl" in args:
        assert res.state.cl_bins.shape[1] == 3
        assert bool(torch.all(torch.isfinite(res.state.cl_bins)))
    if "--tod" in args:
        with ChainFile(res.chain_path, "r") as ch:
            tod = ch.read_tod_state(2)
        want = {"030", "044", "070"} - (
            {"044"} if "--BAND_TOD_TYPE002=none" in args else set())
        assert set(tod) == want
        if "--SAMPLE_TOD_MONOPOLE=.true." in args:
            # monopoles on the LFI bands only (run.py:711)
            lfi = {k: v for k, v in tod.items()
                   if "--BAND_TOD_TYPE002=WMAP" not in args or k != "044"}
            assert all(abs(v["mono"].sum()) < 1e-3 for v in lfi.values())
            assert "--BAND_TOD_TYPE002=WMAP" not in args \
                or "mono" not in tod["044"]
        if "--BAND_TOD_TYPE002=WMAP" in args:
            # the differential band's block: half the scans (run.py:754)
            assert res.bands[1].kind == "diff" \
                and tod["044"]["gain"].shape[0] == res.bands[0].block.nscan \
                // 2
    if "--TOD_OUTPUT_4D_MAP_EVERY_NTH_ITER=1" in args:
        assert (tmp_path / "tod_4D_044_k000002.h5").exists()
    if "--OUTPUT_EVERY_NTH_CG_ITERATION=2" in args:
        # the file's md and source rows keep run() off its dumping CG
        # (run.py:1581-1582); test_torch_host_driver.py has the dumps
        assert not list(tmp_path.glob("cg_amp_k*.npz"))


def test_main_end_to_end_and_the_card_default(tmp_path, monkeypatch):
    """main([... "--cpu"]) writes the chain, the sigma_l files and the
    status file; --KEY=value overrides reach the configuration; without
    --cpu and without a card it raises."""
    out = tmp_path / "out"
    res = trun.main([PARAMS, "--synthetic", "--pol", "--cpu", "--nside",
                     "8", "--lmax", "16", "--niter", "2", "--outdir",
                     str(out), "--THINNING_FACTOR=2"])
    (r,) = res
    assert [x["it"] for x in r.records if x["ok"]] == [1, 2]
    with ChainFile(r.chain_path, "r") as ch:
        assert ch.last_sample() == 2 and "000001" not in ch.f.root.members
    assert (out / "sigma_l_cmb_k000002.dat").exists()
    assert "done" in (out / "comm_status.txt").read_text()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=.cpu"):
        trun.main([PARAMS, "--synthetic", "--niter", "1", "--outdir",
                   str(tmp_path / "card")])


def test_a_templated_band_leaves_the_deferred_route(tmp_path):
    """run()'s _accel_tod_ok (run.py:1727-1733), the port alone: with
    fullgibbs="encoded" a chain of plain TOD bands keeps the deferred route,
    and one whose band carries a zodi template (or sidelobe inputs) goes to
    the host loop (counted phase calls)."""
    _, tcfg = _cfgs("--SYNTH_TOD_NSCAN=4", "--SYNTH_TOD_NTOD=1024",
                    "--SYNTH_TOD_NDET=2", "--BAND_TOD_TYPE002=none",
                    "--BAND_TOD_TYPE003=none")
    real_sim = tod_gibbs.simulate_bands

    def with_zodi(*a, **k):
        bands = real_sim(*a, **k)
        return [bands[0]._replace(zodi=torch.zeros_like(
            bands[0].block.tod))] + list(bands[1:])
    for templated in (False, True):
        calls = {"host_tod_phase": 0, "tod_phase": 0}

        def spy(name, fn):
            def wrapped(*a, **k):
                calls[name] += 1
                return fn(*a, **k)
            return wrapped
        with pytest.MonkeyPatch.context() as mp:
            for name in calls:
                mp.setattr(loop, name, spy(name, getattr(loop, name)))
            if templated:
                mp.setattr(tod_gibbs, "simulate_bands", with_zodi)
            res = loop.run(tcfg, nside=NSIDE, lmax=LMAX, synthetic=True,
                           niter=1, outdir=str(tmp_path / str(templated)),
                           dtype=torch.float64, verbose=False, pol=True,
                           tod=True, device="cpu", fullgibbs="encoded")
        assert res.bands[0].has_templates == templated
        assert calls == ({"host_tod_phase": 1, "tod_phase": 0} if templated
                         else {"host_tod_phase": 0, "tod_phase": 1}), calls
