"""joint.febecop_stamp_ptsrc (the FEBeCoP effective-beam stamps) against the
JAX package's, on the CPU: a beam file written by h5py with its defaults
(one group per band label, in it one group per source's centre pixel with
`indices` and `values`), read by the port's io/hdf5.py and by h5py on the
JAX side, at nside 16 with the stamps at nside_febecop 32 (degraded by
NEST parents) and 8 (upgraded to NEST children), and at 16 itself. The
PtsrcSet's pixels equal, its stamps to 1e-12 of their max (host float64
arithmetic in the same order; the tolerance is for the sums' rounding).
"""
import h5py
import numpy as np
import pytest
import torch

from commander_tpu.sampling import joint as jjoint
from commander_tpu.sphere import healpix as jhp
from commander_tpu_torch.sampling import joint as tjoint

NSIDE = 16
LABELS = ("030", "044")


def _beam_file(path, nside_fb, theta, phi, labels):
    """Per band and source a stamp of 40 pixels around the centre at
    nside_fb with a Gaussian-like response and some negative sidelobes."""
    rng = np.random.default_rng(nside_fb)
    vec = jhp.pix2vec_ring(nside_fb)
    centers = jhp.ang2pix_ring(nside_fb, theta, phi)
    with h5py.File(path, "w") as f:
        for b, lab in enumerate(labels):
            grp = f.create_group(lab) if lab else f
            for c in centers:
                d = vec @ vec[c]
                ind = np.argsort(-d)[:40]
                val = np.exp(-(1 - d[ind]) * 2e3 * (b + 1)) \
                    - 0.01 * rng.uniform(size=40)
                g = grp.create_group(str(int(c)))
                g["indices"] = ind.astype(np.int64)
                g["values"] = val.astype(np.float32)


@pytest.mark.parametrize("nside_fb,labels", [(32, LABELS), (8, LABELS),
                                             (16, None)])
def test_febecop_stamps_match(tmp_path, nside_fb, labels):
    rng = np.random.default_rng(1)
    nsrc = 5
    theta = rng.uniform(0.3, 2.8, nsrc)
    phi = rng.uniform(0.0, 2 * np.pi, nsrc)
    nb = 2 if labels else 1
    F = rng.uniform(0.5, 2.0, (nb, nsrc))
    path = str(tmp_path / "febecop.h5")
    _beam_file(path, nside_fb, theta, phi, labels or (None,))
    ref = jjoint.febecop_stamp_ptsrc(path, NSIDE, theta, phi, F, nside_fb,
                                     band_labels=labels, npatch=24)
    got = tjoint.febecop_stamp_ptsrc(path, NSIDE, theta, phi, F, nside_fb,
                                     band_labels=labels, npatch=24,
                                     device="cpu")
    assert got.npix == 12 * NSIDE ** 2
    np.testing.assert_array_equal(got.pix.numpy(), np.asarray(ref.pix))
    want = np.asarray(ref.stamp)
    assert got.stamp.shape == want.shape and got.stamp.dtype == torch.float64
    assert np.abs(got.stamp.numpy() - want).max() <= 1e-12 * np.abs(
        want).max()
    assert torch.equal(got.prior_istd, torch.zeros(nsrc, dtype=torch.float64))
