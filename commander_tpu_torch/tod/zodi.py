"""Zodiacal-light emission: the Kelsall interplanetary-dust model integrated
along each sample's line of sight (torch).

Counterpart of commander_tpu.tod.zodi (comm_zodi_mod.f90,
compute_zodi_template :372): the Kelsall et al. (1998) components (the
smooth cloud, three dust bands, the circumsolar ring and the Earth-trailing
feature), in heliocentric ecliptic coordinates with the observer at
earth_pos (AU); the emission is a blackbody at the local dust temperature
T(R) = T0 R^-delta times the density, at the band's effective frequency.
The line-of-sight integral is one (samples x nodes) tensor, made a chunk of
scans at a time (one LFI band at full width, 96 scans x 4 detectors x 131072
samples x 25 nodes x 3 coordinates, is ~30 GB in float64 in one piece).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.constants import C_LIGHT, H_OVER_K, H_PLANCK, K_BOLTZ, T_CMB

AU = 1.495978707e11  # m

# bytes of one (samples x nodes) float64 plane that a chunk of scans may
# take in zodi_tod_template (the integrand holds ~10 of them at once)
CHUNK_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class KelsallCloud:
    """Smooth cloud parameters (Kelsall Table 1 defaults)."""
    n0: float = 1.13e-7      # density at 1 AU [AU^-1]
    alpha: float = 1.34
    beta: float = 4.14
    gamma: float = 0.942
    mu: float = 0.189
    incl: float = 2.03 * np.pi / 180.0   # inclination [rad]
    omega: float = 77.7 * np.pi / 180.0  # ascending node [rad]
    x0: float = 0.0119       # offsets [AU]
    y0: float = 0.00548
    z0: float = -0.00215
    T0: float = 286.0        # dust temperature at 1 AU [K]
    delta: float = 0.467


def _cloud_density(cfg: KelsallCloud, x, y, z):
    xp, yp, zp = x - cfg.x0, y - cfg.y0, z - cfg.z0
    R = torch.sqrt(xp ** 2 + yp ** 2 + zp ** 2)
    # height above the tilted midplane
    zc = xp * np.sin(cfg.omega) * np.sin(cfg.incl) \
        - yp * np.cos(cfg.omega) * np.sin(cfg.incl) + zp * np.cos(cfg.incl)
    zeta = torch.abs(zc) / torch.clamp(R, min=1e-6)
    g = torch.where(zeta < cfg.mu, zeta ** 2 / (2.0 * cfg.mu),
                    zeta - cfg.mu / 2.0)
    return cfg.n0 * R ** (-cfg.alpha) * torch.exp(-cfg.beta * g ** cfg.gamma)


@dataclasses.dataclass(frozen=True)
class KelsallBand:
    """Dust band component (Kelsall Table 1, three bands)."""
    n0: float
    delta_zeta: float       # rad
    v: float
    p: float
    delta_r: float          # AU

    def density(self, x, y, z):
        R = torch.sqrt(x ** 2 + y ** 2 + z ** 2)
        zr = torch.abs(z) / torch.clamp(R, min=1e-6) / self.delta_zeta
        return (3.0 * self.n0 / R) * torch.exp(-(zr ** 6)) \
            * (self.v + zr ** self.p) \
            * (1.0 - torch.exp(-((R / self.delta_r) ** 20)))


BAND1 = KelsallBand(n0=5.6e-10, delta_zeta=8.78e-2, v=0.1, p=4.0, delta_r=1.5)
BAND2 = KelsallBand(n0=1.99e-9, delta_zeta=3.49e-2, v=0.9, p=4.0,
                    delta_r=0.94)
BAND3 = KelsallBand(n0=1.44e-10, delta_zeta=2.63e-2, v=0.05, p=4.0,
                    delta_r=1.5)


@dataclasses.dataclass(frozen=True)
class KelsallRing:
    """Circumsolar ring + Earth-trailing feature (Kelsall Table 1)."""
    n0_ring: float = 1.83e-8
    R_ring: float = 1.03
    sigma_r_ring: float = 0.025
    sigma_z_ring: float = 0.054
    n0_feat: float = 1.9e-8
    R_feat: float = 1.06
    sigma_r_feat: float = 0.10
    sigma_z_feat: float = 0.091
    theta_feat: float = -10.0 * np.pi / 180.0
    sigma_theta_feat: float = 12.1 * np.pi / 180.0

    def density(self, x, y, z, earth_lon):
        R = torch.sqrt(x ** 2 + y ** 2 + z ** 2)
        ring = self.n0_ring * torch.exp(
            -((R - self.R_ring) ** 2) / (2 * self.sigma_r_ring ** 2)
            - torch.abs(z) / self.sigma_z_ring)
        theta = torch.atan2(y, x) - (earth_lon + self.theta_feat)
        theta = torch.atan2(torch.sin(theta), torch.cos(theta))
        feat = self.n0_feat * torch.exp(
            -((R - self.R_feat) ** 2) / (2 * self.sigma_r_feat ** 2)
            - torch.abs(z) / self.sigma_z_feat
            - theta ** 2 / (2 * self.sigma_theta_feat ** 2))
        return ring + feat


def _planck_MJysr(nu, T):
    """Blackbody intensity in MJy/sr."""
    x = nu * H_OVER_K / torch.clamp(T, min=1.0)
    # grouped so that no float32 intermediate under- or overflows
    # (utils/constants.H_OVER_K): h nu ~ 8e-21, (nu / c)^2 ~ 1e9
    B = 2.0 * (H_PLANCK * nu) * (nu / C_LIGHT) ** 2 / torch.expm1(x)
    return B * 1e20


def zodi_template(cfg: KelsallCloud, nu: float, earth_pos: torch.Tensor,
                  los_vec: torch.Tensor, r_max: float = 5.2,
                  n_nodes: int = 25, bands: tuple = (),
                  ring: KelsallRing | None = None) -> torch.Tensor:
    """Line-of-sight-integrated zodi intensity [MJy/sr].

    earth_pos: (..., 3) observer position [AU] (broadcast over samples);
    los_vec: (..., 3) unit pointing in ecliptic coordinates. The dust bands
    (BAND1..3) and the ring / feature add their densities where given
    (compute_zodi_template takes the same set)."""
    s_nodes = torch.linspace(0.02, r_max, n_nodes, dtype=los_vec.dtype,
                             device=los_vec.device)
    ds = s_nodes[1] - s_nodes[0]
    pos = earth_pos[..., None, :] + los_vec[..., None, :] * s_nodes[:, None]
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    del pos
    R = torch.sqrt(x ** 2 + y ** 2 + z ** 2)
    T = cfg.T0 * torch.clamp(R, min=1e-6) ** (-cfg.delta)
    dens = _cloud_density(cfg, x, y, z)
    for b in bands:
        dens = dens + b.density(x, y, z)
    if ring is not None:
        earth_lon = torch.atan2(earth_pos[..., 1], earth_pos[..., 0])
        dens = dens + ring.density(x, y, z, earth_lon[..., None])
    # n(s) B(T(s)) ds with s in AU: the Kelsall densities are normalized
    # for AU path lengths
    return torch.sum(dens * _planck_MJysr(nu, T), dim=-1) * ds


def _gal2ecl_matrix() -> np.ndarray:
    """Galactic -> ecliptic as (equatorial -> ecliptic) @ (galactic ->
    equatorial), from the obliquity 23.4392911 deg and the IAU 1958
    galactic pole and centre."""
    eps = np.radians(23.4392911)
    equ2ecl = np.array([[1, 0, 0],
                        [0, np.cos(eps), np.sin(eps)],
                        [0, -np.sin(eps), np.cos(eps)]])
    # galactic -> equatorial (J2000; columns = the galactic axes)
    gal2equ = np.array([
        [-0.0548755604, +0.4941094279, -0.8676661490],
        [-0.8734370902, -0.4448296300, -0.1980763734],
        [-0.4838350155, +0.7469822445, +0.4559837762]])
    return equ2ecl @ gal2equ


# the galactic -> ecliptic rotation (the reference precomputes it with
# getEcl2GalMatrix, comm_zodi_mod.f90:324-367)
GAL2ECL = _gal2ecl_matrix()


def zodi_tod_template(nside: int, pix: torch.Tensor, satpos, nu: float,
                      r_sat: float = 1.0,
                      cloud: KelsallCloud = KelsallCloud(),
                      bands: tuple = (BAND1, BAND2, BAND3),
                      ring: KelsallRing | None = None, n_nodes: int = 25,
                      r_max: float = 5.2) -> torch.Tensor:
    """The zodi signal of a TOD block [MJy/sr], float64 on pix's device
    (compute_zodi_template, comm_zodi_mod.f90:372-513).

    pix: (Ns, ...) RING pixels (galactic); satpos: (Ns, 2) the observatory's
    ecliptic (lon, lat) [deg] per scan (an array, or a tensor on any
    device, as an archive block carries it); nu: the band frequency [Hz]. The
    observer sits r_sat AU from the Sun at (lon, lat); the lines of sight
    are the galactic pixel vectors rotated to ecliptic. Scans go through
    in chunks of at most CHUNK_BYTES per (samples x nodes) plane."""
    from ..sphere import healpix

    dev = pix.device
    f64 = torch.float64
    ecl = torch.as_tensor(healpix.pix2vec_ring(nside) @ GAL2ECL.T,
                          dtype=f64).to(dev)                 # (npix, 3)
    sp = torch.as_tensor(satpos, dtype=f64).to(dev)  # array or tensor
    lon, lat = torch.deg2rad(sp[:, 0]), torch.deg2rad(sp[:, 1])
    earth = r_sat * torch.stack([torch.cos(lat) * torch.cos(lon),
                                 torch.cos(lat) * torch.sin(lon),
                                 torch.sin(lat)], dim=-1)    # (Ns, 3)
    per_scan = max(1, pix[0].numel()) * n_nodes * 8
    step = max(1, CHUNK_BYTES // per_scan)
    extra = (1,) * (pix.ndim - 1)
    out = torch.empty(pix.shape, dtype=f64, device=dev)
    for s0 in range(0, pix.shape[0], step):
        e = earth[s0:s0 + step]
        out[s0:s0 + step] = zodi_template(
            cloud, nu, e.reshape(e.shape[:1] + extra + (3,)),
            ecl[pix[s0:s0 + step]], r_max=r_max, n_nodes=n_nodes,
            bands=bands, ring=ring)
    return out


def mjysr_to_uk_rj(nu: float) -> float:
    """MJy/sr -> uK_RJ at frequency nu [Hz] (dB/dT_RJ = 2 k nu^2 / c^2)."""
    dbdt = 2.0 * K_BOLTZ * nu * nu / (C_LIGHT * C_LIGHT)
    return 1e-20 / dbdt * 1e6


def mjysr_to_uk_cmb(nu: float) -> float:
    """MJy/sr -> uK_CMB at frequency nu [Hz] (dB/dT at T_CMB)."""
    x = nu * (H_OVER_K / T_CMB)
    g = np.expm1(x) ** 2 / (x * x * np.exp(x))
    return mjysr_to_uk_rj(nu) * g
