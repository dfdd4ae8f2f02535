"""A whole full_gibbs_step (sampling/full_gibbs.py) against the JAX package's
tpu_gibbs.full_gibbs_step with the JAX step's own draws, float64 on the
CPU, on test_torch_full_gibbs.py's problem, with and without the
beam-consistent index lnL: its two cases, kept apart from that file so
that they are dealt beside tests/test_sharding.py (ROADMAP "Tier-1
verify"). Tolerances as there.
"""
import pytest

from test_torch_full_gibbs import BETA_TRUE, check_step_matches, problems


@pytest.mark.parametrize("beam_consistent", [False, True])
def test_full_gibbs_step_matches_with_jax_draws(problems, beam_consistent):
    """Without the beams in the index likelihood: CMB + synchrotron, one
    slot. With them: dust too, so synch beta, then dust beta given it, then
    dust T_d given both: the sequential conditioning, slot for slot."""
    th = check_step_matches(problems["dust" if beam_consistent else 1],
                            beam_consistent)
    assert len(th) == (3 if beam_consistent else 1)
    # the step moved beta_s off its start value, toward the truth
    assert abs(th[0] - BETA_TRUE) < abs(-3.1 - BETA_TRUE)
