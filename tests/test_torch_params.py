"""The port's parameter-file layer (commander_tpu_torch.io.params) against
the JAX package's: the same lowered RunConfig, field for field, from every
parameter file in the repository and the tests' own fixture files, and the
grammar (@INCLUDE, Fortran literals, quoted values, --KEY=value overrides).
Exact equality: the lowering is plain Python on both sides."""
import dataclasses

import pytest

from commander_tpu.io.params import Params as JParams
from commander_tpu.io.params import lower_params as j_lower
from commander_tpu.io.params import parse_value as j_parse
from commander_tpu_torch.io.params import Params, lower_params, parse_value

# the tests' own parameter files: written by these fixture functions
FIXTURE_TEXT = (
    "KEY_A = 3        # comment\n"
    "KEY_B = 'quoted value'  trailing\n"
    "NUMBAND = 2\n"
    "INCLUDE_BAND001 = .true.\n"
    "BAND_LABEL001 = x  # c\n"
    "BAND_NSIDE001 = 16\nBAND_LMAX001 = 32\n"
    "BAND_NOMINAL_FREQ001 = 30.\n"
    "INCLUDE_BAND002 = .false.\n")


def _fixture_file(kind, tmp_path):
    if kind == "test_io":
        f = tmp_path / "p.txt"
        f.write_text(FIXTURE_TEXT)
        return f
    if kind.startswith("test_fullgibbs_driver"):
        from test_fullgibbs_driver import _cfg
        _cfg(tmp_path, "fg", specind=kind.endswith("specind"))
        return tmp_path / "param_fg.txt"
    from test_gain_fidelity import _mini_cfg
    _mini_cfg(tmp_path, extra_band=("BAND_SAMP_GAIN001 = .true.",
                                    "BAND_GAIN_PRIOR_RMS001 = -0.01"),
              extra_global=("NUMITER_RESAMPLE_HARD_GAIN_PRIORS = 2",))
    return tmp_path / "param.txt"


FILES = ["param_tutorial_full.txt", "param_index_recovery.txt",
         "param_tutorial_scale.txt", "test_io", "test_fullgibbs_driver",
         "test_fullgibbs_driver_specind", "test_gain_fidelity"]


@pytest.mark.parametrize("name", FILES)
def test_lower_params_matches(name, tmp_path):
    """Every field of the lowered RunConfig (bands and components too)."""
    path = name if name.endswith(".txt") else str(_fixture_file(name,
                                                                tmp_path))
    got = dataclasses.asdict(lower_params(Params.load(path)))
    ref = dataclasses.asdict(j_lower(JParams.load(path)))
    assert got == ref
    assert got["bands"] or name == "test_io"


def test_grammar_and_overrides(tmp_path):
    """parse_value as the JAX package's; @INCLUDE with a relative path;
    --KEY=value overrides replace keys after the file is read."""
    for s in (".true.", ".FALSE.", "1.d-8", "2D3", "163425", "none", "",
              "uK_cmb", "-3.1", "030"):
        assert parse_value(s) == j_parse(s) or (
            parse_value(s) is j_parse(s))
    (tmp_path / "inc.txt").write_text("FROM_INC = 42\nMAIN_KEY = 0\n")
    f = tmp_path / "main.txt"
    f.write_text("@INCLUDE inc.txt\nMAIN_KEY = 1\nCG_MAXITER = 7\n")
    p = Params.load(str(f), ["--CG_MAXITER=9", "--NEW_KEY='a b'"])
    assert p.get("FROM_INC") == 42 and p.get("MAIN_KEY") == 1
    assert p.get("CG_MAXITER") == 9 and p.get("NEW_KEY") == "a b"
    assert p.get("MISSING", 5) == 5
    with pytest.raises(ValueError):
        Params.load(str(f), ["--NOEQUALS"])
    cfg = lower_params(Params.load("param_tutorial_full.txt",
                                   ["--BAND_LABEL002=044b",
                                    "--NUM_GIBBS_ITER=3"]))
    assert cfg.num_gibbs_iter == 3 and cfg.bands[1].label == "044b"
    assert cfg.bands[0].label == "030"
