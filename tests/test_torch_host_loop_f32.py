"""The float32 CG at nside 1024's signal-to-noise in both packages, on
test_torch_host_loop.py's problem (its two noise levels): kept apart from
that file so that its two cases are dealt beside tests/test_sharding.py
(ROADMAP "Tier-1 verify"). Tolerances as there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commander_tpu.sampling import amplitude as jamp
from commander_tpu.sphere import sht as jsht
from commander_tpu_torch import convert
from commander_tpu_torch.sampling import amplitude as tamp
from commander_tpu_torch.sphere import sht as tsht

from test_torch_host_loop import LMAX, NSIDE, T, _fields, world


@pytest.mark.parametrize("noise", [1.0, 1.0 / 128])
def test_float32_cg_at_full_width_signal_to_noise(world, noise):
    """The file's whole model (five components on three bands, T/Q/U) with
    its noise rms scaled by `noise`: 1/128 gives each mode at nside 8 the
    signal-to-noise of nside 1024 at the file's rms (12 * 1024^2 / 768 =
    128^2 times the pixels). There the directions the data fix weigh ~1e8
    against those the priors alone fix, past what float32 vectors hold:
    the port's float32 CG breaks down or stalls and the JAX package's
    stalls, far from the tolerance, where float64 converges in a few
    iterations in both; at the file's own rms float32 converges too."""
    f = _fields(world["jout"][1])
    f["inv_rms2"] = f["inv_rms2"] / noise ** 2
    f["inv_rms"] = f["inv_rms"] / noise
    rng = np.random.default_rng(5)
    C, S, nl = f["F"].shape[1], 3, LMAX + 1
    eta1 = rng.standard_normal(f["data"].shape)
    eta2 = (rng.standard_normal((C, S, nl, nl))
            + 1j * rng.standard_normal((C, S, nl, nl))) * np.tril(
                np.ones((nl, nl)))
    eta2[..., 0] = eta2[..., 0].real
    f32 = {k: (v.astype(np.float32) if v is not None and v.dtype == np.float64
               else v) for k, v in f.items()}
    got = {}
    for name, fields, dt in (("f64", f, torch.float64),
                             ("f32", f32, torch.float32)):
        sys_t = convert.amplitude_system(fields, device="cpu")
        plan_t = tsht.get_plan(NSIDE, LMAX, spin2=True, dtype=dt,
                               device="cpu")
        cdt = torch.complex128 if dt == torch.float64 else torch.complex64
        _, res = tamp.sample_amplitudes(sys_t, plan_t, eta1=T(eta1).to(dt),
                                        eta2=T(eta2).to(cdt), tol=1e-6,
                                        maxiter=100)
        got["port_" + name] = res
        sys_j = jamp.AmplitudeSystem(**{
            k: None if v is None else jnp.asarray(v)
            for k, v in fields.items()})
        plan_j = jsht.get_plan(NSIDE, LMAX, spin2=True,
                               dtype="float64" if dt == torch.float64
                               else "float32")
        _, res_j = jax.jit(lambda s, p: jamp.sample_amplitudes(
            s, p, jax.random.PRNGKey(1), tol=1e-6, maxiter=100))(sys_j, plan_j)
        got["jax_" + name] = res_j
    for k in ("port_f64", "jax_f64"):
        assert bool(got[k].converged) and int(got[k].iters) <= 10, k
    if noise == 1.0:
        for k in ("port_f32", "jax_f32"):
            assert bool(got[k].converged) and int(got[k].iters) <= 10, k
    else:
        for k in ("port_f32", "jax_f32"):
            assert float(got[k].rel_res) > 1e-3, (k, float(got[k].rel_res))
