"""The port's whole Gibbs iteration against the JAX package's at S = 3
(T/Q/U maps, T/E/B amplitudes), float64 on the CPU, nside 8 / lmax 16: the
problem, the draws and the comparison of tests/test_torch_full_gibbs.py
(theta and amplitudes to 1e-8 with the JAX step's own draws).

The reference synthesizes the index phase's amplitude maps with the spin-0
transform on all of T/E/B while its residual uses the T/Q/U synthesis. The
port does not copy that; for the comparison the test swaps the spin-0
transform into the one place the port's index phase synthesizes amplitude
maps (full_gibbs._amp_synth), and tests/test_torch_full_gibbs_pol_maps.py
shows how far the two forms are apart.
"""

import pytest
import torch

from commander_tpu_torch.sampling import full_gibbs as tfg
from commander_tpu_torch.sphere import sht as tsht
from test_torch_full_gibbs import _problem, check_step_matches

# small shapes: one torch thread, so that test workers sharing the cores
# do not oversubscribe them
torch.set_num_threads(1)

NSIDE, LMAX = 8, 16
NL = LMAX + 1


@pytest.fixture(scope="module")
def problems():
    return {3: _problem(3, nside=NSIDE, lmax=LMAX)}


@pytest.mark.parametrize("beam_consistent", [False, True])
def test_polarized_full_gibbs_step_matches_with_jax_draws(
        problems, beam_consistent, monkeypatch):
    monkeypatch.setattr(tfg, "_amp_synth", tsht.alm2map)
    check_step_matches(problems[3], beam_consistent)


