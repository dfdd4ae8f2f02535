"""The port's default device is the CUDA card, with no fallback; and the
port imports neither JAX nor the JAX package.

The entry points take device=None and resolve it in
commander_tpu_torch.utils.device: where no card is present they raise, and
the CPU is used only when asked for by name (as every CPU test does).
"""
import os
import re

import pytest
import torch

import numpy as np

from commander_tpu_torch import convert, entry
from commander_tpu_torch.instrument import bandpass, noise
from commander_tpu_torch.model import mixing
from commander_tpu_torch.sampling import gibbs, specind
from commander_tpu_torch.sampling.tod_gibbs import simulate_bands
from commander_tpu_torch.sphere import sht, sht_otf
from commander_tpu_torch.tod.sim import simulate_tod
from commander_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default resolves to it")


def _tensors(out):
    """The tensors an entry point returned: itself, a tuple of tensors, or
    the fields of its first object."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, tuple) and all(isinstance(v, torch.Tensor)
                                      for v in out):
        return list(out)
    first = out[0] if isinstance(out, tuple) else out
    return [v for v in vars(first).values() if isinstance(v, torch.Tensor)]


# the functions that can be called with plain Python values alone (floats,
# numpy): nothing among their arguments fixes a device
_BP = bandpass.tophat_bandpass(44e9, 0.2, 5)
_SYNCH = mixing.DiffuseComponent("synch", "power_law", 30e9, theta0=(-3.1,))

ENTRY_POINTS = {
    "mixing_matrix": lambda **kw: mixing.mixing_matrix(
        entry.components(), [_BP, bandpass.delta_bandpass(70e9)], **kw),
    "mixing_matrix(thetas floats)": lambda **kw: mixing.mixing_matrix(
        entry.components(), [_BP], thetas=[(), (-2.9,), (1.5, 21.0)],
        deltas=[0.1e9], **kw),
    "mixing_element": lambda **kw: mixing.mixing_element(_SYNCH, _BP, **kw),
    "mixing_element(line)": lambda **kw: mixing.mixing_element(
        mixing.DiffuseComponent("co", "line", 115e9, theta0=(0.0, 1.0)), _BP,
        band_index=1, **kw),
    "Bandpass.weights": lambda **kw: _BP.weights(**kw),
    "Bandpass.weights(shift)": lambda **kw: _BP.weights(0.2e9, **kw),
    "Bandpass.nodes": lambda **kw: _BP.nodes(**kw),
    "Bandpass.integrate": lambda **kw: _BP.integrate(np.ones(5), **kw),
    "SpecIndConfig.grid": lambda **kw: specind.SpecIndConfig(
        -4.0, -2.0, 8).grid(**kw),
    "build_preset": lambda **kw: entry.build_preset("entry", **kw),
    "build_problem": lambda **kw: entry.build_problem(8, 16, **kw),
    "init_state": lambda **kw: gibbs.init_state(3, 1, 16, 4, **kw),
    "get_plan": lambda **kw: sht.get_plan(8, 16, **kw),
    "legendre_otf": lambda **kw: sht_otf.legendre_otf(8, 16, 0, **kw),
    "convert.gibbs_state": lambda **kw: convert.gibbs_state(
        {"a": [[0j]], "cl_bins": [[1.0]]}, **kw),
    "build_preset(entry_pol)": lambda **kw: entry.build_preset(
        "entry_pol", nside=8, lmax=16, **kw),
    "build_preset(tutorial_pol)": lambda **kw: entry.build_preset(
        "tutorial_pol", nside=8, lmax=16, **kw),
    "build_preset(entry_full) spin2": lambda **kw: entry.build_preset(
        "entry_full", nside=8, lmax=16, **kw),
    "get_plan(spin2)": lambda **kw: sht.get_plan(8, 16, spin2=True, **kw),
    "convert.amplitude_system": lambda **kw: convert.amplitude_system(
        dict({k: np.ones((1, 1, 1)) for k in (
            "F", "bl", "inv_rms2", "inv_rms", "cl", "data", "tri")},
            inv_qu=np.ones((1, 1, 2, 2))), **kw),
    "convert.diagonal_noise": lambda **kw: convert.diagonal_noise(
        {"rms": np.ones((3, 4)), "mask": np.ones((3, 4))}, **kw),
    "convert.qucov_noise": lambda **kw: convert.qucov_noise(
        {"rms_T": np.ones(4), "inv_QU": np.ones((4, 2, 2)),
         "sqrt_inv_QU": np.ones((4, 2, 2)), "mask": np.ones((3, 4))}, **kw),
    "DiagonalNoise.create": lambda **kw: noise.DiagonalNoise.create(
        np.ones((3, 4)), **kw),
    "QUCovNoise.create": lambda **kw: noise.QUCovNoise.create(
        np.ones(4), np.tile(np.eye(2), (4, 1, 1)), **kw),
    "build_preset(entry_tod) spin2": lambda **kw: entry.build_preset(
        "entry_tod", nside=4, lmax=8, tod=dict(nscan=2, ndet=2, ntod=64),
        **kw),
    "simulate_bands": lambda **kw: simulate_bands(
        2, np.ones((1, 1, 48)), np.ones((1, 1, 48)), [30e9], nscan=2,
        ndet=2, ntod=64, **kw)[0].block,
    "simulate_tod": lambda **kw: simulate_tod(2, np.ones((3, 48)), nscan=2,
                                              ntod=64, pol=True, **kw),
    "convert.tod_block": lambda **kw: convert.tod_block(
        {"tod": np.ones((1, 1, 4)), "pix": np.zeros((1, 1, 4)),
         "psi": np.ones((1, 1, 4)), "mask": np.ones((1, 1, 4)),
         "vsun": np.ones((1, 3)), "fsamp": 10.0}, **kw),
    "convert.tod_state": lambda **kw: convert.tod_state(
        {k: np.ones((1, 1)) for k in ("gain", "sigma0", "alpha", "fknee",
                                      "n_corr")}, **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_a_card(name):
    """No card and no device given: the helper's error, not a CPU run."""
    _no_card()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cpu_by_name_builds(name):
    out = ENTRY_POINTS[name](device="cpu")
    tensors = _tensors(out)
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    first = out[0] if isinstance(out, tuple) else out
    if isinstance(first, torch.Tensor):
        return
    otfs = [v for v in vars(first).values()
            if isinstance(v, sht_otf.LegendreOTF)]
    assert ("spin2" in name or "_pol" in name) == (len(otfs) == 3)
    assert all(o.x.device.type == "cpu" for o in otfs)


def test_band_sz_conversion_default_device():
    """It returns a float, so its device shows only in the error."""
    _no_card()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bandpass.band_sz_conversion(_BP)
    assert np.isfinite(bandpass.band_sz_conversion(_BP, device="cpu"))


def test_tensor_arguments_fix_the_device():
    """A tensor among the parameters decides where F is built: no device
    needs naming, and none is asked of the default."""
    beta = torch.tensor(-3.0, dtype=torch.float64)
    F = mixing.mixing_matrix(entry.components(), [_BP],
                             thetas=[(), (beta,), (1.5, 21.0)])
    assert F.device.type == "cpu" and F.shape == (1, 3)
    assert mixing.mixing_element(_SYNCH, _BP, (beta,)).device.type == "cpu"
    assert _BP.weights(torch.tensor(0.1e9, dtype=torch.float64)
                       )[1].device.type == "cpu"


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    assert resolve_device("cuda:0") == torch.device("cuda", 0)  # not probed
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA card"):
            resolve_device(None)


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for top in ("commander_tpu_torch", "torch_tools"):
        for d, _, names in os.walk(os.path.join(ROOT, top)):
            files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                     r"from\s+commander_tpu(\s|\.)|import\s+commander_tpu\b)",
                     re.M)
    files = _port_sources()
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            hit = pat.search(f.read())
        assert hit is None, f"{path}: {hit.group(0).strip()}"
