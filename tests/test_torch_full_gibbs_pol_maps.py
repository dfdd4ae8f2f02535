"""The index phase's spin-0 amplitude maps of a T/Q/U step
(full_gibbs._amp_synth) against the residuals' synthesis, on
test_torch_full_gibbs_pol.py's problem: one case, kept apart from that
file so that both are dealt beside tests/test_sharding.py (ROADMAP
"Tier-1 verify").
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from commander_tpu.sphere.alm import random_alm_white as j_random_alm_white
from commander_tpu.sphere.alm import triangle_mask as j_triangle_mask
from commander_tpu_torch import convert
from commander_tpu_torch.sampling import amplitude as tamp
from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sampling import gibbs as tgibbs
from commander_tpu_torch.sphere import sht as tsht

from test_torch_full_gibbs import BETA_TRUE, BINS
from test_torch_full_gibbs_pol import LMAX, NL, problems


def test_spin0_amplitude_maps_differ_from_the_residuals_synthesis(
        problems, monkeypatch):
    """The divergence the port does not copy: on (3, nl, nm) T/E/B alms the
    spin-0 transform gives the T row of the T/Q/U synthesis and, in the Q
    and U rows, maps that are not the polarization field (relative
    difference of order 1)."""
    pb = problems[3]
    a = np.array(j_random_alm_white(jax.random.PRNGKey(1), (3, NL, NL))
                   * jnp.asarray(j_triangle_mask(NL, NL)))
    a[1:, :2] = 0.0
    a = torch.as_tensor(a)
    teb = tamp._synth(pb.plan_t, a)
    spin0 = tsht.alm2map(pb.plan_t, a)
    assert torch.allclose(teb[0], spin0[0], rtol=0, atol=1e-12)
    for s in (1, 2):
        rel = float((teb[s] - spin0[s]).norm() / teb[s].norm())
        assert rel > 0.5, rel
    # and what it does to the draw: with the same draws the port's form
    # moves beta from -3.1 toward the truth, the spin-0 form away from it
    slots = tfg.make_index_slots(pb.comps_t)
    beta = {}
    for spin0_form in (False, True):
        if spin0_form:
            monkeypatch.setattr(tfg, "_amp_synth", tsht.alm2map)
        gen = torch.Generator()
        gen.manual_seed(3)
        state = tgibbs.init_state(2, 3, LMAX, len(BINS), device="cpu")
        _, th, _ = tfg.full_gibbs_step(
            dataclasses.replace(pb.gcfg_t, cg_tol=1e-8), pb.comps_t,
            pb.bps_t, slots, pb.sys_t, pb.plan_t, state,
            convert.thetas([-3.1], device="cpu"), gen, beam_consistent=True)
        beta[spin0_form] = float(th[0])
    assert abs(beta[False] - BETA_TRUE) < 0.3 < abs(beta[True] - BETA_TRUE)
