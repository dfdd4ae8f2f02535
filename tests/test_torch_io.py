"""The port's file layer against the JAX package's: FITS maps and b_l
tables (io/fits.py, instrument/files.py), the chain file (io/chain.py on the
port's own HDF5 reader and writer, io/hdf5.py, against the JAX ChainFile on
h5py), and the C_l file layer (model/cl.py: read_cl_bin_file,
write_sigma_l). Every comparison is exact: the same bits, bytes or values.
"""

import h5py
import numpy as np
import pytest
import torch

from commander_tpu.instrument import files as jfiles
from commander_tpu.io import chain as jchain
from commander_tpu.io import fits as jfits
from commander_tpu.model import cl as jcl
from commander_tpu_torch.instrument import files as tfiles
from commander_tpu_torch.io import chain as tchain
from commander_tpu_torch.io import fits as tfits
from commander_tpu_torch.io import hdf5
from commander_tpu_torch.model import cl as tcl

PACKAGES = {"jax": (jfits, jchain), "port": (tfits, tchain)}


@pytest.mark.parametrize("nest", [False, True])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_fits_maps_cross_read(tmp_path, writer, reader, nest):
    """Maps written by one package read by the other bit for bit (T and
    T/Q/U, RING and NESTED), and the same bytes from both writers."""
    rng = np.random.default_rng(1)
    for nmaps in (1, 3):
        maps = rng.standard_normal((nmaps, 12 * 8 * 8)) * 100
        path = str(tmp_path / f"{writer}_{nmaps}.fits")
        PACKAGES[writer][0].write_map(path, maps, nest=nest, unit="K")
        got = PACKAGES[reader][0].read_map(path)
        ref = PACKAGES[writer][0].read_map(path)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
        assert np.array_equal(got, maps.astype(np.float32).astype(
            np.float64))
        other = str(tmp_path / f"other_{nmaps}.fits")
        PACKAGES[reader][0].write_map(other, maps, nest=nest, unit="K")
        assert open(path, "rb").read() == open(other, "rb").read()


@pytest.mark.parametrize("lmax", [10, 40])
def test_beam_tables_cross_read(tmp_path, lmax):
    """A b_l table (TT, EE, BB; big-endian float64 and float32 columns)
    written with either package's FITS cards, read by both loaders to the
    same values, padded with zeros or cut at lmax."""
    from test_torch_driver import _write_bl_table

    cols = np.stack([np.linspace(1, 0.2, 25), np.linspace(1, 0.3, 25),
                     np.linspace(1, 0.4, 25)], axis=1)
    path = tmp_path / "bl.fits"
    _write_bl_table(path, cols)
    got = tfiles.load_beam_bl_fits(str(path), lmax)
    ref = jfiles.load_beam_bl_fits(str(path), lmax)
    assert got.shape == (lmax + 1, 3) and np.array_equal(got, ref)
    n = min(lmax + 1, 25)
    assert np.array_equal(got[:n], cols[:n]) and not got[n:].any()
    alm = np.tril(np.arange(36.0).reshape(6, 6)) * (1 + 0.5j)
    alm[:, 0] = alm[:, 0].real
    assert np.array_equal(tfiles._complex_to_realpacked(alm),
                          jfiles._complex_to_realpacked(alm))
    vals = jfiles._complex_to_realpacked(alm)
    assert np.array_equal(tfiles._realpacked_to_complex(vals, 5, 5),
                          jfiles._realpacked_to_complex(vals, 5, 5))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfiles.load_bandpass_hdf(str(path), "det")


def _sample(rng, lmax, S):
    a = (rng.standard_normal((S, lmax + 1, lmax + 1))
         + 1j * rng.standard_normal((S, lmax + 1, lmax + 1)))
    a = a * np.tril(np.ones((lmax + 1, lmax + 1)))
    a[..., 0] = a[..., 0].real
    return {"cmb": {"alm": a, "Dl": rng.random((S, lmax + 1)),
                    "specind": np.zeros(0)},
            "synch": {"alm": 2 * a, "Dl": rng.random((S, lmax + 1)),
                      "specind": np.array([-3.1])}}


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_chain_files_cross_read(tmp_path, writer, reader):
    """Samples (alms packed, D_l, indices, gains, aux scalars and arrays),
    TOD states (float32 and float64) and metadata written by one package's
    ChainFile, appended to by the other's, and read by both: the same
    arrays, dtypes and shapes."""
    W, R = PACKAGES[writer][1].ChainFile, PACKAGES[reader][1].ChainFile
    rng = np.random.default_rng(2)
    path = str(tmp_path / "chain.h5")
    comps = _sample(rng, 6, 3)
    tod = dict(gain=rng.random((4, 2)).astype(np.float32),
               sigma0=rng.random((4, 2)), alpha=np.full((4, 2), -1.0),
               fknee=rng.random((4, 2)), bp_delta=np.zeros(1))
    with W(path) as ch:
        ch.write_metadata({"nside": 16, "comps": "cmb,synch", "x": 0.5})
        ch.write_sample(1, comps, gains=np.ones(3),
                        extra={"chisq": 3.5, "cg_iters": 7,
                               "md_amps": rng.random(13)})
        ch.write_tod_state(1, "030", tod)
    with R(path) as ch:                    # append with the other package
        ch.write_sample(2, comps, gains=np.full(3, 2.0))
    for C in (R, W):
        with C(path, "r") as ch:
            assert ch.last_sample() == 2
            s = ch.read_sample(1)
            ref = jchain.unpack_alm_real(jchain.pack_alm_real(
                comps["cmb"]["alm"], 6), 6)
            assert np.array_equal(s["comps"]["cmb"]["alm"], ref)
            assert np.array_equal(s["comps"]["synch"]["specind"], [-3.1])
            assert s["comps"]["cmb"]["specind"].shape == (0,)
            assert float(s["aux"]["chisq"]) == 3.5
            assert int(s["aux"]["cg_iters"]) == 7
            assert s["aux"]["md_amps"].shape == (13,)
            t = ch.read_tod_state(1)["030"]
            assert t["gain"].dtype == np.float32
            assert np.array_equal(t["gain"], tod["gain"])
            assert ch.read_tod_state(2) == {}
            assert np.array_equal(ch.read_sample(2)["gain"], [2.0] * 3)
            meta = ch.read_metadata()
            assert meta["comps"] == "cmb,synch" and meta["nside"] == 16


def test_hdf5_subset_against_h5py(tmp_path):
    """The narrow HDF5 writer against h5py: 300 groups (a two-level group
    B-tree), scalar / empty / big-endian / integer datasets, string and
    numeric attributes, replaced members, h5py appending to the file and
    the port reading h5py's additions; and a file h5py wrote, read and
    extended by the port."""
    path = str(tmp_path / "t.h5")
    with hdf5.File(path, "w") as f:
        g = f.require_group("a/b")
        g.attrs.update(lmax=4, name="x y", f=1.5)
        f.write_dataset(g, "v", np.arange(6.0).reshape(2, 3))
        f.write_dataset(g, "v", np.arange(3, dtype=">i4"))    # replaced
        f.write_dataset(g, "s", np.float32(2.5))
        f.write_dataset(g, "e", np.zeros(0))
        for i in range(300):
            f.write_dataset(f.require_group(f"{i:06d}"), "k", np.full(2, i))
            if i % 97 == 0:
                f.flush()
    with h5py.File(path, "a") as h:
        assert len(h.keys()) == 301
        assert h["a/b/v"].dtype == np.dtype("<i4")   # stored little-endian
        assert np.array_equal(h["a/b/v"][()], [0, 1, 2])
        assert h["a/b/s"][()] == np.float32(2.5) and h["a/b/s"].shape == ()
        assert h["a/b/e"].shape == (0,)
        assert dict(h["a/b"].attrs) == {"lmax": 4, "name": "x y", "f": 1.5}
        assert np.array_equal(h["000299/k"][()], [299, 299])
        h.create_dataset("from_h5py", data=np.ones(4))
        h["a"].attrs["t"] = "added"
    with hdf5.File(path, "a") as f:
        assert np.array_equal(f.read_dataset(f.get("from_h5py")), np.ones(4))
        assert f.get("a").attrs["t"] == "added"
        f.write_dataset(f.root, "last", np.arange(2))
    with h5py.File(path, "r") as h:
        assert np.array_equal(h["last"][()], [0, 1])
        assert np.array_equal(h["000150/k"][()], [150, 150])
    with pytest.raises(ValueError):
        hdf5.File(path, "r").write_dataset(hdf5.Group(), "x", np.ones(1))
    other = str(tmp_path / "h.h5")
    with h5py.File(other, "w") as h:
        h.create_dataset("d", data=np.arange(5, dtype="<u2"))
        h.attrs["s"] = "str"
        h.create_group("g").attrs["n"] = np.int32(3)
    with hdf5.File(other, "a") as f:
        assert np.array_equal(f.read_dataset(f.get("d")), np.arange(5))
        assert f.root.attrs["s"] == "str" and f.get("g").attrs["n"] == 3
        f.write_dataset(f.get("g"), "z", np.eye(2))
    with h5py.File(other, "r") as h:
        assert np.array_equal(h["g/z"][()], np.eye(2))


def test_cl_file_layer_matches(tmp_path):
    """read_cl_bin_file (filler bins, per-spectrum flags, bins beyond lmax)
    and write_sigma_l (T and T/E/B) as the JAX package's: the same bins and
    the same file bytes."""
    (tmp_path / "bins.dat").write_text(
        "# l1 l2 TT TE TB EE EB BB\n2 10 S S 0 S 0 S\n14 20 M 0 0 0 0 S\n"
        "21 60 SSSSSS\n")
    for lmax in (30, 80):
        got = tcl.read_cl_bin_file(str(tmp_path / "bins.dat"), lmax)
        ref = jcl.read_cl_bin_file(str(tmp_path / "bins.dat"), lmax)
        assert got[0] == ref[0] and np.array_equal(got[1], ref[1])
    rng = np.random.default_rng(4)
    for nspec in (1, 6):
        sig = rng.random((nspec, 21))
        tcl.write_sigma_l(str(tmp_path / "t.dat"), torch.as_tensor(sig), 20)
        jcl.write_sigma_l(str(tmp_path / "j.dat"), sig, 20)
        assert (tmp_path / "t.dat").read_bytes() == \
            (tmp_path / "j.dat").read_bytes()
