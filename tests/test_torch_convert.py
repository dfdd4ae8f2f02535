"""The port's converters (commander_tpu_torch/tod/convert.py) against
commander_tpu.tod.convert on tests/test_convert.py's fixtures: the same
filelist text, and archives that both packages' readers read as the JAX
converter's; the quaternion pointing and the frame-flag spreading equal."""
import os

import numpy as np
import pytest

from commander_tpu.tod import convert as JC
from commander_tpu.tod import loader as JL
from commander_tpu_torch.tod import convert as TC
from commander_tpu_torch.tod import loader as TL
from test_convert import DETS, NSIDE, _wmap_day, _write_l2


def _same_blocks(bj, bt, fields):
    for k in fields:
        assert np.array_equal(np.asarray(getattr(bj, k)),
                              np.asarray(getattr(bt, k))), k


def _filelist(path):
    with open(path) as f:
        return f.read()


def test_l2_converter(tmp_path):
    od = [_write_l2(str(tmp_path / f"LFI_030_OD009{i}.h5"), seed=i)
          for i in (1, 2)]
    pj = JC.read_l2_od(od[0], DETS)
    pt = TC.read_l2_od(od[0], DETS)
    assert [p["pid"] for p in pt] == [p["pid"] for p in pj]
    for a, b in zip(pj, pt):
        for d in DETS:
            for k, v in a["det"][d].items():
                assert np.array_equal(b["det"][d][k], v), (d, k)
    fj = JC.convert_l2_to_archive(od, DETS, NSIDE, 30.0,
                                  str(tmp_path / "j"), band_label="030")
    ft = TC.convert_l2_to_archive(od, DETS, NSIDE, 30.0,
                                  str(tmp_path / "t"), band_label="030")
    assert _filelist(ft) == _filelist(fj)
    fields = ("tod", "pix", "psi", "mask", "vsun", "satpos")
    bj, sj, _ = JL.load_band_tod(fj)
    for reader in (lambda f: JL.load_band_tod(f),
                   lambda f: TL.load_band_tod(f, device="cpu")):
        bt, st, mt = reader(ft)
        _same_blocks(bj, bt, fields)
    assert mt["nscan"] == 6 and float(bt.satpos[0, 0]) == 120.0


def test_litebird_converter(tmp_path):
    rng = np.random.default_rng(3)
    fsamp, n = 4.0, 256
    t = np.arange(n) / fsamp
    dets = ["0001a", "0001b"]
    det_files = {d: dict(theta=np.mod(0.4 + 0.01 * t + 0.001 * i, np.pi),
                         phi=np.mod(0.5 * t, 2 * np.pi),
                         psi=np.mod(0.2 * t + i, 2 * np.pi),
                         tod=rng.standard_normal(n))
                 for i, d in enumerate(dets)}
    # one detector from an HDF file, as litebirdtohdf5.py's inputs come
    import h5py
    hpath = str(tmp_path / "0001b.h5")
    with h5py.File(hpath, "w") as f:
        for k, v in det_files["0001b"].items():
            f.create_dataset(k, data=v)
    kw = dict(band_label="LFT_40", chunk_seconds=16.0,
              polang=np.radians([0.0, 90.0]))
    fj = JC.convert_litebird_to_archive(det_files, dets, NSIDE, fsamp,
                                        str(tmp_path / "j"), **kw)
    ft = TC.convert_litebird_to_archive(dict(det_files, **{"0001b": hpath}),
                                        dets, NSIDE, fsamp,
                                        str(tmp_path / "t"), **kw)
    assert _filelist(ft) == _filelist(fj)
    bj, _, mj = JL.load_band_tod(fj)
    bt, _, mt = TL.load_band_tod(ft, device="cpu")
    _same_blocks(bj, bt, ("tod", "pix", "psi", "mask", "vsun"))
    assert np.array_equal(mt["polang"], mj["polang"])
    assert bt.nscan == 4


@pytest.mark.parametrize("n_per_day", [1, 2])
def test_wmap_converter(tmp_path, n_per_day):
    days = [_wmap_day(NSIDE, seed=1), _wmap_day(NSIDE, seed=2)]
    day = days[0]
    for los, pol in (("losA", "polA"), ("losB", "polB")):
        pj, qj = JC.quat_to_pointing(day["quat"], day[los], day[pol], NSIDE)
        pt, qt = TC.quat_to_pointing(day["quat"], day[los], day[pol], NSIDE)
        assert np.array_equal(pt, pj) and np.array_equal(qt, qj)
    assert np.array_equal(TC._q2m(day["quat"]), JC._q2m(day["quat"]))
    assert np.array_equal(TC._flags_to_tod_rate(day["daflags"], 1000),
                          JC._flags_to_tod_rate(day["daflags"], 1000))
    kw = dict(band_label="K1", n_per_day=n_per_day, x_im=[0.01, -0.02])
    fj = JC.convert_wmap_to_archive(days, ["K113", "K114"], NSIDE, 12.0,
                                    str(tmp_path / "j"), **kw)
    ft = TC.convert_wmap_to_archive(days, ["K113", "K114"], NSIDE, 12.0,
                                    str(tmp_path / "t"), **kw)
    assert _filelist(ft) == _filelist(fj)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    fields = ("tod", "pixA", "psiA", "pixB", "psiB", "mask", "vsun")
    for name in (n for n in names if n.endswith(".h5")):
        bj, sj, mj = JL.read_archive_diff(str(tmp_path / "j" / name),
                                          bad_flag_bits=1)
        bt, st, mt = TL.read_archive_diff(str(tmp_path / "t" / name),
                                          bad_flag_bits=1, device="cpu")
        _same_blocks(bj, bt, fields)
        assert np.array_equal(np.asarray(sj.gain), st.gain.numpy())
        assert np.array_equal(mt["x_im"], mj["x_im"])
        assert 0 < float(bt.mask.mean()) <= 1.0
