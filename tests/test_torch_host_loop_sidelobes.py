"""run()'s host TOD loop with a band that carries the sidelobe and zodi
terms, float64 on the CPU: the port's chain against
commander_tpu.run.run(tod=True, dtype="float64") at nside 16 / lmax 32
(param_tutorial_full.txt --pol, cmb, synch and dust; band 030 from TOD, 32
scans x 2 detectors x 4096 samples, its bandpass sampled on the TOD chi^2;
bands 044 and 070 at map level), one iteration, with run()'s draws
replayed attempt by attempt (test_torch_host_loop_tod.host_tod_replay).

Band 030 carries, in both packages alike (attached by monkeypatch to each
package's synthetic TOD set-up; nothing in commander_tpu changes), what
run._setup_tod_aux gives an archive band: two detectors' sidelobe beams at
lmax 12 with M = 2 beam modes (sl_blm), their plan and conviqt tables at
nside 8, the samples' pixels degraded to nside 8 (sl_pix), and a zodi
template from a made-up satpos (zodi); and its TOD holds the sidelobe
signal of the band's true sky and that zodi signal, injected the way
tests/test_tod_driver_physics.py injects them (a sidelobe signal the model
cannot follow, of a sky unrelated to the band's, makes the two chains part
at 5e-8 of the alms: rounding that the misfit amplifies, measured). The
f-maps are rebuilt from the band alms at the warm start and at the
iteration, and both the pass and the bandpass move carry the terms.

Held to test_torch_host_loop_tod.py's bounds for its 1e-8 case: the sample
(alms, D_l, indices, chi^2; the CG iterations equal) and the band's TOD
state as run() writes them to 1e-8, bp_delta to 1e-6, the
accept / reject sequence and the bandpass acceptances equal. Both packages
must have evaluated the sidelobe term (counted calls).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu import run as jrun
from commander_tpu.sampling import mh as jmh
from commander_tpu.sphere import sht as jsht
from commander_tpu.tod import conviqt as JC
from commander_tpu.tod import zodi as JZ
from commander_tpu_torch import convert
from commander_tpu_torch.driver import loop
from commander_tpu_torch.sampling import chisq as tchisq
from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sampling import tod_gibbs
from commander_tpu_torch.sphere import sht as tsht
from commander_tpu_torch.tod import process as TP
from commander_tpu_torch.tod import sim as tsim
from commander_tpu_torch.tod.model import TodBlock
import test_torch_host_loop_tod as hlt
from test_torch_driver import (_cfgs, _port_model, _rel, _samples, _status,
                               _truth)

torch.set_num_threads(2)

NSIDE, LMAX = 16, 32
NS_SL, L_SL, M_SL = 8, 12, 2
# 32 scans x 4096 samples: at 8 x 2048 the T/Q/U system solves ~2/3 of the
# pixels, its CG takes ~265 iterations and two float64 solvers part at
# 4e-5 of the alms without either term (measured); here 61-73 iterations
# and 1e-12
OVER = ("--SYNTH_TOD_NSCAN=32", "--SYNTH_TOD_NTOD=4096", "--SYNTH_TOD_NDET=2",
        "--BAND_SAMP_BANDPASS001=.true.", "--BAND_TOD_TYPE002=none",
        "--BAND_TOD_TYPE003=none", "--INCLUDE_COMP04=.false.",
        "--INCLUDE_COMP05=.false.", "--INCLUDE_COMP06=.false.",
        "--INCLUDE_COMP07=.false.", "--INCLUDE_COMP08=.false.")
# the reference interp, unspied (the injection is made with it)
_INTERP = JC.conviqt_interp


def _aux(block_pix, ndet, alm_T):
    """The band's aux entries (numpy) and the f-maps of the injected
    sidelobe signal: sidelobe beams, the nside-8 plan and tables, sl_pix, a
    zodi template in uK_CMB from a made-up satpos; the f-maps of the band's
    true temperature alms alm_T."""
    rng = np.random.default_rng(21)
    nl = L_SL + 1
    blm = np.zeros((ndet, nl, M_SL + 1), np.complex128)
    for d in range(ndet):
        for m in range(M_SL + 1):
            v = rng.normal(size=nl) + (1j * rng.normal(size=nl) if m else 0)
            v[:m] = 0.0
            blm[d, :, m] = v * np.exp(-0.3 * np.arange(nl))
        blm[d] *= 0.02 / np.abs(blm[d]).max()
    pix = np.asarray(block_pix)
    Ns = pix.shape[0]
    satpos = np.stack([np.linspace(0.0, 300.0, Ns), np.zeros(Ns)], axis=-1)
    nu = 30e9
    zodi = np.asarray(JZ.zodi_tod_template(NSIDE, jnp.asarray(pix),
                                           jnp.asarray(satpos), nu)) \
        * JZ.mjysr_to_uk_cmb(nu) * 200.0
    sl_pix = JC.degrade_table(NSIDE, NS_SL)[pix]
    plan_sl = jsht.get_plan(NS_SL, L_SL, dtype="float64")
    tables = JC.conviqt_tables(NS_SL, L_SL, M_SL, "float64")
    fm = np.asarray(JC.build_sl_fmaps(plan_sl, tables,
                                      jnp.asarray(alm_T[:nl, :nl]),
                                      jnp.asarray(blm)))
    return dict(blm=blm, plan=plan_sl, tables=tables, sl_pix=sl_pix,
                zodi=zodi, fmaps=fm, pix=pix)


def _inject(aux, pix, psi):
    s_sl = np.stack([np.asarray(_INTERP(
        jnp.asarray(aux["fmaps"][d]), jnp.asarray(aux["sl_pix"][:, d]),
        jnp.asarray(psi[:, d]))) for d in range(pix.shape[1])], axis=1)
    return s_sl + aux["zodi"]


def _runs(root):
    jcfg, tcfg = _cfgs(*OVER)
    for b in (1, 2):
        jcfg.bands[b] = dataclasses.replace(jcfg.bands[b], tod_type="none")
    _, truth = _truth(jcfg, NSIDE, LMAX)
    model = _port_model(tcfg, truth, NSIDE, LMAX)
    made, seen = {}, {"jax_bp": [], "jax_sl": 0, "port_sl": 0}
    j_setup, j_acc = jrun._setup_synthetic_tod, jmh.accept_bandpass_tod
    j_interp, t_interp = JC.conviqt_interp, TP.conviqt_interp_dets
    t_sim, real_sim = tod_gibbs.simulate_bands, tsim.simulate_tod

    def j_setup_spy(*a, **k):
        blocks = j_setup(*a, **k)
        tcfg_b, blk, st, kind, aux = blocks[0]
        # the band's true temperature alms: bl_0 sum_c F_0c a_c
        sys = a[2]
        aT = np.einsum("c,clm->lm", np.asarray(sys.F)[0, :, 0],
                       truth[:, 0]) * np.asarray(sys.bl)[0, 0][:, None]
        made.update(_aux(blk.pix, blk.ndet, aT))
        inj = _inject(made, np.asarray(blk.pix), np.asarray(blk.psi))
        made["inj"] = inj
        blk = dataclasses.replace(blk, tod=blk.tod + jnp.asarray(inj))
        aux = dict(aux, sl_blm=jnp.asarray(made["blm"]),
                   sl_plan=made["plan"], sl_tables=made["tables"],
                   sl_pix=jnp.asarray(made["sl_pix"]),
                   zodi=jnp.asarray(made["zodi"]))
        blocks[0] = (tcfg_b, blk, st, kind, aux)
        return blocks

    def t_sim_spy(*a, **k):
        bands = t_sim(*a, **k)
        band = bands[0]
        blk = band.block
        np.testing.assert_array_equal(blk.pix.numpy(), made["pix"])
        blk = TodBlock(tod=blk.tod + torch.as_tensor(made["inj"]),
                       pix=blk.pix, psi=blk.psi, mask=blk.mask,
                       vsun=blk.vsun, fsamp=blk.fsamp, satpos=blk.satpos)
        blk.pixel_runs(12 * NSIDE ** 2)
        bands[0] = band._replace(block=blk, **convert.tod_aux(dict(
            sl_blm=made["blm"], sl_plan=dict(nside=NS_SL, lmax=L_SL),
            sl_tables=[(np.asarray(p), np.asarray(n))
                       for p, n in made["tables"]],
            sl_pix=made["sl_pix"], zodi=made["zodi"]), device="cpu"))
        return bands

    def j_acc_spy(*a, **k):
        out = j_acc(*a, **k)
        seen["jax_bp"].append(bool(out[1]))
        return out

    def j_interp_spy(*a, **k):
        seen["jax_sl"] += 1
        return j_interp(*a, **k)

    def t_interp_spy(*a, **k):
        seen["port_sl"] += 1
        return t_interp(*a, **k)

    def sim(*a, **k):
        # run._setup_synthetic_tod simulates every orbital dipole at 30 GHz
        return real_sim(*a, **dict(k, nu=30e9))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrun, "_setup_synthetic_tod", j_setup_spy)
        mp.setattr(jmh, "accept_bandpass_tod", j_acc_spy)
        mp.setattr(JC, "conviqt_interp", j_interp_spy)
        mp.setattr(TP, "conviqt_interp_dets", t_interp_spy)
        mp.setattr(tod_gibbs, "simulate_bands", t_sim_spy)
        mp.setattr(tod_gibbs, "simulate_tod", sim)
        mp.setattr(tchisq, "_REFERENCE_FORM", True)
        mp.setattr(tfg, "_amp_synth", tsht.alm2map)
        # host_tod_replay draws the index step's inputs at its module's size
        mp.setattr(hlt, "NSIDE", NSIDE)
        mp.setattr(hlt, "LMAX", LMAX)
        _, jpath = jrun.run(jcfg, nside=NSIDE, lmax=LMAX, synthetic=True,
                            niter=1, outdir=str(root / "jax"),
                            dtype="float64", verbose=False, pol=True,
                            tod=True)
        port = loop.run(tcfg, nside=NSIDE, lmax=LMAX, synthetic=True,
                        niter=1, outdir=str(root / "port"),
                        dtype=torch.float64, verbose=False, pol=True,
                        tod=True, device="cpu", a_true=truth,
                        draws=hlt.host_tod_replay(jcfg, tcfg, model, False))
    return jpath, port, seen


def test_host_loop_with_sidelobes_and_zodi_matches_run(tmp_path):
    jpath, port, seen = _runs(tmp_path)
    band = port.bands[0]
    assert band.has_templates and band.sl_pix is not None
    assert port.bands[1] is None and port.bands[2] is None
    # the term was evaluated in the passes and the bandpass move
    assert seen["port_sl"] >= 5 and seen["jax_sl"] > 0
    got, ref = _samples(port.chain_path), _samples(jpath)
    assert sorted(got) == sorted(ref) == [1]
    g, r = got[1], ref[1]
    assert set(g["comps"]) == set(r["comps"]) == {"cmb", "synch", "dust"}
    for name, c in r["comps"].items():
        assert _rel(g["comps"][name]["alm"], c["alm"]) <= 1e-8, name
        for k in ("Dl", "specind"):
            assert np.all(np.abs(g["comps"][name][k] - c[k]) <= 1e-8
                          * np.maximum(1.0, np.abs(c[k]))), (name, k)
    assert abs(g["aux"]["chisq"] - r["aux"]["chisq"]) <= 1e-8 * abs(
        r["aux"]["chisq"])
    assert int(g["aux"]["cg_iters"]) == int(r["aux"]["cg_iters"])
    assert np.abs(got[1]["aux"]["bp_delta"]
                  - ref[1]["aux"]["bp_delta"]).max() <= 1e-6
    hlt._same_tod(port.chain_path, jpath, (1,))
    assert [r["ok"] for r in port.records] == _status(
        str(tmp_path / "jax"))
    bp = [r["accepted"] for rec in port.records for r in rec["bp"].values()]
    assert bp == seen["jax_bp"] and len(bp) >= 1

