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

from commander_tpu_torch import convert, entry
from commander_tpu_torch.sampling import gibbs
from commander_tpu_torch.sphere import sht, sht_otf
from commander_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default resolves to it")


ENTRY_POINTS = {
    "build_preset": lambda **kw: entry.build_preset("entry", **kw),
    "build_problem": lambda **kw: entry.build_problem(8, 16, **kw),
    "init_state": lambda **kw: gibbs.init_state(3, 1, 16, 4, **kw),
    "get_plan": lambda **kw: sht.get_plan(8, 16, **kw),
    "legendre_otf": lambda **kw: sht_otf.legendre_otf(8, 16, 0, **kw),
    "convert.gibbs_state": lambda **kw: convert.gibbs_state(
        {"a": [[0j]], "cl_bins": [[1.0]]}, **kw),
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
    first = out[0] if isinstance(out, tuple) else out
    tensors = [v for v in vars(first).values() if isinstance(v, torch.Tensor)]
    assert tensors and all(t.device.type == "cpu" for t in tensors)


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
