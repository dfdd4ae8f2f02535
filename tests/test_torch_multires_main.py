"""The program's --multires route end to end (python -m commander_tpu_torch
... --multires) against the JAX package's run_multires, on the CPU: one
case, kept apart from test_torch_multires.py so that its two chains are
dealt beside tests/test_sharding.py (ROADMAP "Tier-1 verify").
"""
import numpy as np

from commander_tpu.io.params import Params, lower_params
from commander_tpu.run import run_multires
from commander_tpu_torch import run as trun
from test_torch_multires import PARAMS, _chain_mr



def test_main_multires_end_to_end(tmp_path):
    """python -m commander_tpu_torch param_tutorial_full.txt --multires
    --synthetic --pol --cpu --max-nside 4 --niter 2: the chain file holds
    two samples with the datasets, shapes and dtypes of run_multires' own
    file for the same command, and the status file ends in done."""
    from commander_tpu.io.chain import ChainFile as JChainFile
    from commander_tpu_torch.io.chain import ChainFile

    argv = [PARAMS, "--multires", "--synthetic", "--pol", "--max-nside", "4",
            "--niter", "2"]
    ((st, path, _),) = trun.main(argv + ["--cpu", "--outdir",
                                         str(tmp_path / "port")])
    assert st.it == 2 and "done" in (tmp_path / "port" /
                                     "comm_status.txt").read_text()
    _, jpath, _ = run_multires(lower_params(Params.load(PARAMS)), niter=2,
                               outdir=str(tmp_path / "jax"), synthetic=True,
                               verbose=False, pol=True, max_nside=4)
    got, ref = _chain_mr(path, JChainFile), _chain_mr(jpath, ChainFile)
    assert len(got) == len(ref) == 2

    def layout(s):
        return ({n: (v["alm"].shape, v["alm"].dtype)
                 for n, v in s["comps"].items()},
                {k: np.shape(v) for k, v in s["aux"].items()},
                s["gain"].shape)
    for g, r in zip(got, ref):
        assert layout(g) == layout(r)
        assert all(np.isfinite(v["alm"]).all() for v in g["comps"].values())
