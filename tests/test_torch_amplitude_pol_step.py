"""A whole polarized gibbs_step (T/Q/U amplitudes and C_l) against the JAX
package's with its own draws, float64 on the CPU, on
test_torch_amplitude_pol.py's problem, in sampling and in optimize mode:
its two cases, kept apart from that file so that they are dealt beside
tests/test_sharding.py (ROADMAP "Tier-1 verify"). Tolerances as there.
"""
import pytest
import torch

from commander_tpu_torch.sampling import gibbs as tgibbs

from test_torch_amplitude_pol import (_gibbs_problem, _j_gibbs_step,
                                      _jax_draws, _rel, plans)


@pytest.mark.parametrize("optimize", [False, True])
def test_polarized_gibbs_step_matches(plans, optimize):
    pj, pt = plans
    sys_j, cfg_j, st_j, sys_t, cfg_t, st_t = _gibbs_problem(optimize)
    new_j = _j_gibbs_step(cfg_j, sys_j, pj, st_j)
    new_t = tgibbs.gibbs_step(cfg_t, sys_t, pt, st_t,
                              draws=_jax_draws(st_j, sys_j, cfg_j))
    assert _rel(new_t.a, new_j.a) <= 1e-8
    assert _rel(new_t.cl_bins, new_j.cl_bins) <= 1e-8
    # the fixed-prior component keeps its bins, E/B hold no power below 2
    assert torch.equal(new_t.cl_bins[1], st_t.cl_bins[1])
    assert float(new_t.a[:, 1:, :2].abs().max()) == 0.0
    assert new_t.it == 1
