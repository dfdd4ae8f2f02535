"""TOD data model and the per-scan operations of one band's TOD Gibbs pass
(torch).

Counterpart of commander_tpu.tod.model (the reference's comm_tod_* modules):
  * data model      TodBlock, TodState
  * pointing        project_sky, orbital_dipole, orbital_dipole_4pi
  * corr. noise     sample_ncorr (mean fill), sample_ncorr_sm (Woodbury CG)
  * noise PSD       sample_noise_psd (sigma0 from sample differences, the
                    (alpha, fknee) grid as one float64 GEMM)
  * gain            sample_gain_perscan, smooth_gain, smooth_gain_wiener,
                    sample_abscal, sample_relcal
  * mapmaking       bin_tod / bin_tod_mono (per-pixel normal equations),
                    finalize_binned_map (closed-form 3x3 solves), sample_mono

Every function is batched over (nscan, ndet, ntod) arrays with a sample mask.
Arrays stay in the data dtype (float32 on the card); every sum over samples
is float64, and so are the per-pixel normal equations and their solves (the
determinant condition det > 1e-3 a d f is a cancellation).

Mapmaking sums samples per pixel without atomics: a block's pointing never
changes, so its samples are sorted by pixel once (TodBlock.pixel_runs, a
stable sort), and each pass gathers its weighted samples in that order, a
chunk of pixels at a time, and sums the runs of equal pixels with
torch.segment_reduce. Each pixel's sum runs in sample order, so a seeded
pass gives the same bits twice on the card, where index_add_ and
scatter_add_ add with float atomics.

Randomness: each sampler takes a torch.Generator or its draws ready-made
(the reference's own jax.random draws, in the parity tests).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..model.cl import gamma_marsaglia_tsang
from ..utils.constants import C_LIGHT, H_OVER_K, T_CMB
from ..utils.device import rand, randn

F64 = torch.float64


# samples per chunk of the float64 binning planes: 9 planes of 8 bytes make
# 600 MB per chunk, where one (N, 9) array of a band's 5e7 samples is 3.6 GB
CHUNK_SAMPLES = 1 << 23


class PixelRuns(NamedTuple):
    """The samples of a block sorted by pixel: `order` (N,) int32 sample
    indices in a stable sort of the flattened pointing, `offsets` (nseg + 1,)
    int64 start of each pixel's run in that order, and `chunks`, host ints
    (p0, p1, s0, s1): the runs of pixels [p0, p1) hold the sorted samples
    [s0, s1), about CHUNK_SAMPLES each."""
    order: torch.Tensor
    offsets: torch.Tensor
    chunks: tuple


def pixel_runs(keys: torch.Tensor, nseg: int,
               chunk: int = CHUNK_SAMPLES) -> PixelRuns:
    """PixelRuns of integer keys in [0, nseg) (any shape, flattened). Reads
    the chunk bounds back to the host once."""
    k = keys.reshape(-1)
    order = torch.argsort(k, stable=True)
    ks = k.index_select(0, order)
    bounds = torch.arange(nseg + 1, dtype=ks.dtype, device=ks.device)
    offsets = torch.searchsorted(ks, bounds)
    nchunk = max(1, -(-k.numel() // chunk))
    p = [nseg * i // nchunk for i in range(nchunk + 1)]
    s = offsets[p].tolist()
    return PixelRuns(order.to(torch.int32), offsets,
                     tuple((p[i], p[i + 1], s[i], s[i + 1])
                           for i in range(nchunk)))


def _run_sums(runs: PixelRuns, planes_of, m: int) -> torch.Tensor:
    """(m, nseg) float64 sums over each run of the (n, m) planes that
    planes_of(sample indices) gives for the sorted samples of a chunk; an
    empty run sums to 0. Within a run the samples are added in their
    original order, with no atomics."""
    out = torch.empty((m, runs.offsets.numel() - 1), dtype=F64,
                      device=runs.order.device)
    for p0, p1, s0, s1 in runs.chunks:
        out[:, p0:p1] = torch.segment_reduce(
            planes_of(runs.order[s0:s1]), "sum",
            offsets=runs.offsets[p0:p1 + 1] - s0, axis=0, unsafe=True).T
    return out


@dataclasses.dataclass(frozen=True)
class TodBlock:
    """One band's TOD, bucketed to a common padded length.

    Shapes: nscan=Ns, ndet=Nd, ntod=Nt (padded)."""
    tod: torch.Tensor     # (Ns, Nd, Nt) raw data
    pix: torch.Tensor     # (Ns, Nd, Nt) int32 RING pixel of each sample
    psi: torch.Tensor     # (Ns, Nd, Nt) polarization angle [rad]
    mask: torch.Tensor    # (Ns, Nd, Nt) 1 = good sample (flags+padding)
    vsun: torch.Tensor    # (Ns, 3) satellite velocity [m/s] per scan
    fsamp: float          # sampling frequency [Hz]
    # (Ns, 2) observatory ecliptic (lon, lat) [deg] per scan, or None
    satpos: torch.Tensor | None = None

    @property
    def nscan(self):
        return self.tod.shape[0]

    @property
    def ndet(self):
        return self.tod.shape[1]

    @property
    def ntod(self):
        return self.tod.shape[2]

    def pixel_runs(self, npix: int) -> PixelRuns:
        """The pointing sorted by pixel, made at the first call and kept on
        the block (its pointing never changes)."""
        cache = self.__dict__.setdefault("_runs", {})
        if npix not in cache:
            cache[npix] = pixel_runs(self.pix, npix)
        return cache[npix]

    def to(self, device, dtype=None) -> "TodBlock":
        """The block on `device`, its float arrays in `dtype` (default: as
        they are); pix stays int32."""
        f = lambda x: None if x is None else x.to(device, dtype or x.dtype)
        return TodBlock(tod=f(self.tod), pix=self.pix.to(device),
                        psi=f(self.psi), mask=f(self.mask), vsun=f(self.vsun),
                        fsamp=self.fsamp, satpos=f(self.satpos))


@dataclasses.dataclass(frozen=True)
class TodState:
    """Sampled per-scan/per-det instrument state."""
    gain: torch.Tensor     # (Ns, Nd) total gain per scan
    sigma0: torch.Tensor   # (Ns, Nd) white-noise level (tod units)
    alpha: torch.Tensor    # (Ns, Nd) 1/f slope
    fknee: torch.Tensor    # (Ns, Nd) knee frequency [Hz]
    n_corr: torch.Tensor   # (Ns, Nd, Nt) correlated-noise realization

    def to(self, device, dtype=None) -> "TodState":
        return TodState(**{f.name: getattr(self, f.name).to(
            device, dtype or getattr(self, f.name).dtype)
            for f in dataclasses.fields(self)})


def _sum64(x, dim=None, keepdim=False):
    if dim is None:
        return torch.sum(x, dtype=F64)
    return torch.sum(x, dim=dim, keepdim=keepdim, dtype=F64)


def _normal(given, shape, like: torch.Tensor, generator, dtype=None):
    """Standard normal draws: `given` as passed (moved to like's device and
    dtype), else from `generator`."""
    dtype = like.dtype if dtype is None else dtype
    if given is not None:
        return torch.as_tensor(given).to(device=like.device, dtype=dtype)
    if generator is None:
        raise ValueError("pass a torch.Generator or the draws")
    return randn(tuple(shape), generator, dtype, like.device)


def _gather(v: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """v[pix] for a (npix,) map and int32 pixel indices of any shape."""
    return v.index_select(0, pix.reshape(-1)).reshape(pix.shape)


def _clamp_var(sigma0):
    return torch.clamp(sigma0 ** 2, min=1e-30)


# ---------------------------------------------------------------------------
# Pointing: sky maps <-> TOD
# ---------------------------------------------------------------------------

def project_sky(maps, pix, psi, pol: bool):
    """s[t] = T[pix] (+ Q[pix] cos 2psi + U[pix] sin 2psi).

    maps: (S, npix) shared across detectors, or (Nd, S, npix) per-detector
    sky maps (the reference's map_sky(:,:,det,:)); pix/psi: (Ns, Nd, Nt) or
    any (..., Nt)."""
    if maps.ndim == 3 and pix.ndim == 3:
        return torch.stack([project_sky(maps[d], pix[:, d], psi[:, d], pol)
                            for d in range(maps.shape[0])], dim=1)
    T = _gather(maps[0], pix)
    if not pol or maps.shape[0] == 1:
        return T
    return T + _gather(maps[1], pix) * torch.cos(2.0 * psi) \
        + _gather(maps[2], pix) * torch.sin(2.0 * psi)


def _quad_factor(nu: float) -> float:
    """The orbital dipole's frequency-dependent quadrupole factor."""
    x = nu * (H_OVER_K / T_CMB)
    return x * (math.exp(x) + 1.0) / (2.0 * math.expm1(x))


def orbital_dipole(vsun, pix_vec, nu: float, pix):
    """Pencil-beam orbital CMB dipole template in uK_cmb with the
    relativistic quadrupole correction (comm_tod_orbdipole_mod.f90:161-221).

    vsun: (Ns, 3) m/s; pix_vec: (npix, 3) unit vectors; pix: (Ns, Nd, Nt).
    b.n is summed over one gathered axis of pix_vec at a time (no (Ns, Nd,
    Nt, 3) array)."""
    beta = vsun / C_LIGHT                                  # (Ns, 3)
    b_dot_n = sum(beta[:, k, None, None] * _gather(pix_vec[:, k], pix)
                  for k in range(3))
    q = _quad_factor(nu)
    return (T_CMB * 1e6) * (b_dot_n + q * b_dot_n ** 2)


def beam_moments_orbdipole(beam_map, pix_vec):
    """First/second angular moments of a 4pi beam map (beam frame, z =
    boresight): S_k = sum_p b_p n_kp, S_jk = sum_p b_p n_jp n_kp, B0 = sum_p
    b_p (the reference's orb_dp_s table). Returns (S1 (3,), S2 (3,3), B0)."""
    S1 = torch.einsum("p,pk->k", beam_map, pix_vec)
    S2 = torch.einsum("p,pj,pk->jk", beam_map, pix_vec, pix_vec)
    return S1, S2, torch.sum(beam_map)


def _euler_zyz(psi, theta, phi):
    """Rotation matrix R = Rz(psi) Ry(theta) Rz(phi), batched over leading
    dims (the reference's compute_euler_matrix_zyz)."""
    cps, sps = torch.cos(psi), torch.sin(psi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    cph, sph = torch.cos(phi), torch.sin(phi)
    r00 = cps * cth * cph - sps * sph
    r01 = -cps * cth * sph - sps * cph
    r02 = cps * sth
    r10 = sps * cth * cph + cps * sph
    r11 = -sps * cth * sph + cps * cph
    r12 = sps * sth
    r20 = -sth * cph
    r21 = sth * sph
    r22 = cth
    return torch.stack([torch.stack([r00, r01, r02], -1),
                        torch.stack([r10, r11, r12], -1),
                        torch.stack([r20, r21, r22], -1)], -2)


def orbital_dipole_4pi(vsun, theta_pix, phi_pix, psi, pix, moments,
                       nu: float):
    """Beam-convolved (4pi) orbital dipole template in uK_cmb: v_sun rotated
    into the beam frame with R(-psi, -theta, -phi) and contracted with the
    beam moments (comm_tod_orbdipole_mod.f90:190-288, without the spline
    subsampling). theta_pix/phi_pix: (npix,); psi/pix: (Ns, Nd, Nt);
    moments: beam_moments_orbdipole's."""
    S1, S2, B0 = moments
    th = _gather(theta_pix, pix)
    ph = _gather(phi_pix, pix)
    R = _euler_zyz(-psi, -th, -ph)                         # (Ns,Nd,Nt,3,3)
    vn = torch.einsum("sdtjk,sk->sdtj", R, vsun / C_LIGHT)
    q = _quad_factor(nu)
    lin = torch.einsum("sdtj,j->sdt", vn, S1)
    quad = torch.einsum("sdtj,jk,sdtk->sdt", vn, S2, vn)
    return (T_CMB * 1e6) * (lin + q * quad) / B0


# ---------------------------------------------------------------------------
# 1/f noise model and FFT-space operations
# ---------------------------------------------------------------------------

def psd_1f(freqs, sigma0, alpha, fknee):
    """The correlated part of the noise PSD, S_corr(f) = sigma0^2
    (f/fknee)^alpha: freqs (F,), params (...,) -> (..., F)."""
    f = torch.clamp(freqs, min=1e-12)
    return sigma0[..., None] ** 2 * (f / fknee[..., None]) ** alpha[..., None]


def _rfftfreq(n: int, fsamp: float, like: torch.Tensor):
    """rfft frequencies in float64, then in like's dtype."""
    return torch.fft.rfftfreq(n, 1.0 / fsamp, dtype=F64,
                              device=like.device).to(like.dtype)


def sample_ncorr(resid, mask, sigma0, alpha, fknee, fsamp,
                 generator: torch.Generator | None = None, eta=None):
    """Draw n_corr | resid from the conditional Gaussian in Fourier space
    (comm_tod_noise_mod.f90:140-182): per frequency bin
      n_f ~ N( S_c/(S_c + S_w) r_f,  (1/S_c + 1/S_w)^-1 )
    with S_w = sigma0^2 and S_c the 1/f PSD. Masked samples are filled with
    the unmasked mean of their (scan, det). eta: optional (re, im) standard
    normal draws of the rfft's shape. (Ns, Nd, Nt) in and out."""
    Nt = resid.shape[-1]
    mean = (_sum64(resid * mask, -1, True)
            / torch.clamp(_sum64(mask, -1, True), min=1.0)).to(resid.dtype)
    r = torch.where(mask > 0.5, resid, mean)
    rf = torch.fft.rfft(r, dim=-1)
    freqs = _rfftfreq(Nt, fsamp, resid)
    S_w = (sigma0 ** 2)[..., None]
    S_c = psd_1f(freqs, sigma0, alpha, fknee)
    W = S_c / (S_c + S_w)
    var = 1.0 / (1.0 / torch.clamp(S_c, min=1e-30)
                 + 1.0 / torch.clamp(S_w, min=1e-30))
    eta = (None, None) if eta is None else eta
    eta_re = _normal(eta[0], rf.shape, resid, generator)
    eta_im = _normal(eta[1], rf.shape, resid, generator)
    # unit-variance complex noise with rfft symmetry: DC and Nyquist real
    nfreq = rf.shape[-1]
    scale = torch.full((nfreq,), math.sqrt(0.5), dtype=resid.dtype,
                       device=resid.device)
    scale[:1].fill_(1.0)
    if Nt % 2 == 0:
        scale[-1:].fill_(1.0)
    scale_im = scale.clone()
    scale_im[:1].fill_(0.0)
    if Nt % 2 == 0:
        scale_im[-1:].fill_(0.0)
    nf = W * rf + torch.sqrt(var * Nt) * torch.complex(eta_re * scale,
                                                       eta_im * scale_im)
    nf[..., :1].zero_()   # no monopole in n_corr (degenerate with mono)
    return torch.fft.irfft(nf, n=Nt, dim=-1)


def _mirror_fourier_apply(x, fmat):
    """Multiply by a Fourier-diagonal operator with mirrored (even) extension
    to 2*Nt (the reference's apply_fourier_mat, comm_tod_noise_mod.f90:
    433-466). x (..., Nt), fmat (..., Nt+1)."""
    Nt = x.shape[-1]
    xe = torch.cat([x, torch.flip(x, dims=(-1,))], dim=-1)
    xf = torch.fft.rfft(xe, dim=-1) * fmat
    return torch.fft.irfft(xf, n=2 * Nt, dim=-1)[..., :Nt]


def sample_ncorr_sm(resid, mask, sigma0, alpha, fknee, fsamp,
                    n_iter: int = 15,
                    generator: torch.Generator | None = None, draws=None):
    """Exact masked n_corr draw via Sherman-Morrison/Woodbury CG (the
    reference's get_ncorr_sm_cg, comm_tod_noise_mod.f90:308-466): in
    whitened units the conditional precision is diag(mask) + invNcorr
    (Fourier-diagonal with mirrored extension), and Woodbury reduces its
    inverse to a CG over the masked samples, here a fixed n_iter iterations
    batched over (scan, det) with float64 inner products.

    Without a generator and draws: the conditional (Wiener) mean. draws:
    optional (d, r) standard normal (Ns, Nd, Nt) arrays. Returns n_corr in
    data units."""
    Nt = resid.shape[-1]
    dt = resid.dtype
    s0 = torch.clamp(sigma0[..., None], min=1e-30)
    x = resid / s0 * mask
    freqs = _rfftfreq(2 * Nt, fsamp, resid)
    ratio = freqs / fknee[..., None]
    invNcorr = torch.where(freqs > 0, torch.where(ratio > 0, ratio, 1.0)
                           ** (-alpha[..., None]), 0.0)
    invM = 1.0 / (1.0 + invNcorr)
    gap = 1.0 - mask

    if generator is None and draws is None:
        b = x
    else:
        draws = (None, None) if draws is None else draws
        d = _normal(draws[0], resid.shape, resid, generator)
        r = _normal(draws[1], resid.shape, resid, generator)
        b = x + d * mask + _mirror_fourier_apply(r, torch.sqrt(invNcorr))

    # Woodbury inner solve on the gaps: (I - P_g invM P_g) xp = P_g invM b
    bp = gap * _mirror_fourier_apply(b, invM)

    def Ap(p):
        return p - gap * _mirror_fourier_apply(gap * p, invM)

    def dot(u, v):
        return _sum64(u * v, -1, True)

    xp = torch.zeros_like(bp)
    rvec = bp
    p = rvec
    r2 = dot(rvec, rvec)
    for _ in range(n_iter):
        Adp = Ap(p)
        denom = dot(p, Adp)
        alp = torch.where(denom > 0, r2 / torch.clamp(denom, min=1e-300),
                          0.0).to(dt)
        xp = xp + alp * p
        rvec = rvec - alp * Adp
        r2n = dot(rvec, rvec)
        bet = torch.where(r2 > 0, r2n / torch.clamp(r2, min=1e-300),
                          0.0).to(dt)
        p = rvec + bet * p
        r2 = r2n
    n_w = _mirror_fourier_apply(gap * xp + b, invM)
    return n_w * sigma0[..., None]


def multiply_inv_N_white(x, mask, sigma0):
    """White-noise weighting x * mask / sigma0^2 (multiply_inv_N,
    comm_tod_noise_mod.f90:1366, white limit)."""
    return x * mask / _clamp_var(sigma0[..., None])


def sample_noise_psd(resid, mask, fsamp, alpha_grid, fknee_grid,
                     sigma0_fix=None, generator: torch.Generator | None = None,
                     gamma=None, u=None):
    """Draw (sigma0, alpha, fknee) | residual.

    sigma0^2: the sample-to-sample difference variance over unmasked pairs
    divided by 2 (sample_noise_psd, comm_tod_noise_mod.f90:800), drawn as
    var * npair / chi2(npair). (alpha, fknee): inversion sampling of the
    periodogram likelihood on the grid (psd_grid_cdf, float64) at the new
    sigma0.

    alpha_grid, fknee_grid: 1-d tensors. gamma: optional (Ns, Nd)
    Gamma(npair/2, 1) variates; u: optional (Ns, Nd) uniforms. Returns
    (sigma0, alpha, fknee) in the residual's dtype."""
    dt = resid.dtype
    d = resid[..., 1:] - resid[..., :-1]
    m2 = mask[..., 1:] * mask[..., :-1]
    npair = torch.clamp(_sum64(m2, -1), min=1.0)
    var = _sum64(d ** 2 * m2, -1) / npair / 2.0
    if gamma is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or the gamma draws")
        gamma = gamma_marsaglia_tsang(generator, npair / 2.0)
    g = torch.as_tensor(gamma).to(device=resid.device, dtype=F64) \
        * 2.0 / npair
    if sigma0_fix is None:
        sigma0 = torch.sqrt(var / torch.clamp(g, min=1e-12))
    else:
        sigma0 = torch.as_tensor(sigma0_fix).to(device=resid.device,
                                                dtype=F64)

    cdf = psd_grid_cdf(resid, mask, fsamp, alpha_grid, fknee_grid, sigma0)
    if u is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or the uniform draws")
        u = rand(tuple(cdf.shape[:-1]), generator, F64, resid.device)
    u = torch.as_tensor(u).to(device=resid.device, dtype=F64)
    Gf = fknee_grid.shape[0]
    idx = torch.sum(cdf < u[..., None] * cdf[..., -1:], dim=-1)
    idx = torch.clamp(idx, max=cdf.shape[-1] - 1)
    return (sigma0.to(dt), alpha_grid.index_select(0, (idx // Gf).reshape(-1))
            .reshape(idx.shape).to(dt),
            fknee_grid.index_select(0, (idx % Gf).reshape(-1))
            .reshape(idx.shape).to(dt))


def psd_grid_cdf(resid, mask, fsamp, alpha_grid, fknee_grid, sigma0):
    """The unnormalized CDF (..., Ga * Gf) over the (alpha, fknee) grid
    (alpha major) of the periodogram likelihood lnL = -sum_f [P/S + ln S],
    S = sigma0^2 (1 + (f/fknee)^alpha), from its maximum, in float64; P .
    (1/S) is one GEMM of (scan x det) against (frequency x grid point)."""
    Nt = resid.shape[-1]
    rf = torch.fft.rfft(resid * mask, dim=-1)[..., 1:]
    P = (rf.real.to(F64) ** 2 + rf.imag.to(F64) ** 2) / Nt   # periodogram
    del rf
    freqs = torch.fft.rfftfreq(Nt, 1.0 / fsamp, dtype=F64,
                               device=resid.device)[1:]
    ag, fg = alpha_grid.to(F64), fknee_grid.to(F64)
    Ga, Gf = ag.shape[0], fg.shape[0]
    Sg = 1.0 + (freqs / fg[:, None]) ** ag[:, None, None]     # (Ga, Gf, F)
    log_sum = torch.log(Sg).sum(-1).reshape(Ga * Gf)
    inv_S = torch.reciprocal_(Sg).reshape(Ga * Gf, -1)
    s02 = torch.clamp(sigma0.to(F64) ** 2, min=1e-30)
    t1 = (P @ inv_S.T) / s02[..., None]
    t2 = log_sum + freqs.shape[0] * torch.log(s02)[..., None]
    lnl = -(t1 + t2)
    lnl = lnl - lnl.max(dim=-1, keepdim=True).values
    return torch.cumsum(torch.exp(lnl), dim=-1)


# ---------------------------------------------------------------------------
# Gain sampling
# ---------------------------------------------------------------------------

def sample_gain_perscan(tod, s_ref, mask, sigma0, prior_mean=None,
                        prior_istd=0.0, generator: torch.Generator | None
                        = None, eta=None):
    """Per-scan per-det gain GLS fit g = <s,d>/<s,s> with white-noise weights
    plus a Gaussian draw (comm_tod_gain_mod.f90:37-142). s_ref: the
    calibration reference signal (sky + orbital dipole). eta: optional (Ns,
    Nd) standard normals."""
    w = mask / _clamp_var(sigma0[..., None])
    num = _sum64(s_ref * tod * w, -1)
    den = _sum64(s_ref * s_ref * w, -1)
    if prior_mean is not None:
        num = num + prior_mean * prior_istd ** 2
        den = den + prior_istd ** 2
    mean = num / torch.clamp(den, min=1e-30)
    std = 1.0 / torch.sqrt(torch.clamp(den, min=1e-30))
    eta = _normal(eta, mean.shape, tod, generator)
    return (mean + std * eta).to(tod.dtype)


def smooth_gain(gain, window: int):
    """Boxcar smoothing of per-scan gains over the scan axis, edges padded
    with the end values."""
    Ns = gain.shape[0]
    w = min(window, Ns)
    pad = w // 2
    gp = torch.cat([gain[:1].expand(pad, -1), gain,
                    gain[-1:].expand(w - 1 - pad, -1)], dim=0)
    return (gp.unfold(0, w, 1) * (1.0 / w)).sum(-1)


def smooth_gain_wiener(gain_raw, sigma_g, fknee_scan: float = 0.05,
                       alpha: float = -2.0, sample: bool = True,
                       generator: torch.Generator | None = None, eta=None):
    """Wiener smoothing (plus fluctuation) of per-scan gains over the scan
    axis (sample_smooth_gain, comm_tod_gain_mod.f90:143-453): the deviation
    from the scan mean gets the prior P(f) = (f/fknee)^alpha in scan
    frequency against the mean GLS variance; the scan mean is kept exactly.
    eta: optional (re, im) standard normals of shape (Ns//2 + 1, Nd)."""
    Ns = gain_raw.shape[0]
    mean = torch.mean(gain_raw, dim=0, keepdim=True)
    d = gain_raw - mean
    var_meas = torch.mean(sigma_g ** 2, dim=0)            # (Nd,)
    f = _rfftfreq(Ns, 1.0, gain_raw)
    P = torch.where(f > 0, (torch.clamp(f, min=1e-6) / fknee_scan) ** alpha,
                    0.0)
    P = P[:, None] * var_meas[None, :]
    df = torch.fft.rfft(d, dim=0)
    W = P / (P + var_meas[None, :] * Ns / Ns)
    post_var = 1.0 / (1.0 / torch.clamp(P, min=1e-30)
                      + 1.0 / torch.clamp(var_meas[None, :], min=1e-30))
    sm = W * df
    if sample:
        eta = (None, None) if eta is None else eta
        e = torch.complex(_normal(eta[0], df.shape, gain_raw, generator),
                          _normal(eta[1], df.shape, gain_raw, generator))
        sm = sm + torch.sqrt(post_var * Ns / 2.0) * e
        im = sm.imag.clone()
        im[:1].fill_(0.0)
        sm = torch.complex(sm.real, im)
    return mean + torch.fft.irfft(sm, n=Ns, dim=0)


def sample_abscal(tod_resid, s_orb, mask, sigma0,
                  generator: torch.Generator | None = None, eta=None):
    """Absolute calibration from the orbital dipole: one gain factor across
    all scans and detectors (sample_abscal_from_orbital,
    comm_tod_gain_mod.f90:534-576). Returns a 0-d tensor; eta: optional
    0-d standard normal."""
    w = mask / _clamp_var(sigma0[..., None])
    num = _sum64(s_orb * tod_resid * w)
    den = _sum64(s_orb * s_orb * w)
    mean = num / torch.clamp(den, min=1e-30)
    std = 1.0 / torch.sqrt(torch.clamp(den, min=1e-30))
    eta = _normal(eta, (), tod_resid, generator)
    return (mean + std * eta).to(tod_resid.dtype)


def sample_relcal(tod_resid, s_tot, mask, sigma0,
                  generator: torch.Generator | None = None, eta=None):
    """Per-detector relative calibration offsets with sum_i Delta g_i = 0
    (sample_relcal, comm_tod_gain_mod.f90:577-625): per-det GLS accumulators
    (A_i, b_i) with the fluctuation sqrt(A_i) eta on b, the constraint
    through a Lagrange row of the (ndet + 1) bordered system, solved in
    float64 on the device. eta: optional (Nd,) standard normals."""
    nd = tod_resid.shape[1]
    w = mask / _clamp_var(sigma0[..., None])
    A = _sum64(s_tot * s_tot * w, (0, 2))                  # (Nd,)
    b = _sum64(s_tot * tod_resid * w, (0, 2))
    b = b + torch.sqrt(torch.clamp(A, min=0.0)) \
        * _normal(eta, (nd,), tod_resid, generator).to(F64)
    half = torch.full((nd, 1), 0.5, dtype=F64, device=A.device)
    M = torch.cat([torch.cat([torch.diag(A), half], dim=1),
                   torch.cat([torch.ones_like(half.T),
                              torch.zeros_like(half[:1])], dim=1)], dim=0)
    rhs = torch.cat([b, torch.zeros_like(b[:1])])
    x = torch.linalg.solve_ex(M, rhs)[0]
    return x[:nd].to(tod_resid.dtype)


# ---------------------------------------------------------------------------
# Mapmaking
# ---------------------------------------------------------------------------

def bin_tod_mono(calib_tod, pix, psi, mask, inv_var, npix: int, pol: bool,
                 runs: PixelRuns | None = None):
    """Normal equations with per-detector monopole columns (the sys_mono
    branch of bin_TOD, comm_tod_mapmaking_mod.f90:34-94): u = (1, cos2psi,
    sin2psi, e_det). Returns float64 (A (npix, k+Nd, k+Nd), b (npix,
    k+Nd)). runs: pixel_runs(pix, npix), made here when not given."""
    Ns, Nd, Nt = calib_tod.shape
    runs = pixel_runs(pix, npix) if runs is None else runs
    w_all = (mask * inv_var[..., None]).reshape(-1)
    k = 3 if pol else 1
    m = k + Nd

    def planes(idx):
        w = w_all.index_select(0, idx).to(F64)
        d = calib_tod.reshape(-1).index_select(0, idx).to(F64)
        cols = [torch.ones_like(d)]
        if pol:
            ps = psi.reshape(-1).index_select(0, idx).to(F64)
            cols += [torch.cos(2 * ps), torch.sin(2 * ps)]
        det_id = (idx // Nt) % Nd
        cols += [(det_id == j).to(F64) for j in range(Nd)]
        u = torch.stack(cols, -1)                          # (n, k+Nd)
        return torch.cat([(w[:, None, None] * u[:, :, None] * u[:, None, :])
                          .reshape(-1, m * m), (w * d)[:, None] * u], dim=1)

    sums = _run_sums(runs, planes, m * m + m)
    return sums[:m * m].T.reshape(npix, m, m), sums[m * m:].T


# the monopole guard's bound on a Stokes block's eigenvalue ratio
MONO_RCOND = 1e-6


def sym3_eig_range(A: torch.Tensor):
    """(smallest, largest) eigenvalue of each symmetric (..., 3, 3) block in
    closed form (the trigonometric solution of the characteristic cubic),
    elementwise on any device: a batched eigensolver refuses batches of
    millions of blocks on the card."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    p1 = A[..., 0, 1] ** 2 + A[..., 0, 2] ** 2 + A[..., 1, 2] ** 2
    p2 = ((A[..., 0, 0] - q) ** 2 + (A[..., 1, 1] - q) ** 2
          + (A[..., 2, 2] - q) ** 2 + 2.0 * p1)
    p = torch.sqrt(p2 / 6.0)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    Bm = (A - q[..., None, None] * eye) / torch.where(
        p > 0, p, 1.0)[..., None, None]
    r = torch.clamp(torch.linalg.det(Bm) / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    hi = q + 2.0 * p * torch.cos(phi)
    lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    return lo, hi


def sample_mono(A, b, nmaps: int, nstep: int = 1000,
                sigma_prop: float = 0.03, mono0=None,
                generator: torch.Generator | None = None, eta=None,
                guard: bool = False):
    """Per-detector monopole draw, zero-sum constrained (sample_mono,
    comm_tod_mapmaking_mod.f90:300-438). The Stokes block is marginalized
    per pixel in closed form, which leaves a quadratic chi^2(m) = m^T Q m -
    2 l^T m: the conditional is Gaussian N(Q^-1 l, Q^-1) on the zero-sum
    subspace and is drawn directly (the target of the reference's random
    walk; nstep and sigma_prop are unused). A, b from bin_tod_mono. eta:
    optional (Nd - 1,) standard normals. Returns (mono (Nd,), 1 where the
    system was usable, else 0 with mono0 kept).

    Each hit pixel's Stokes block is solved as the JAX package solves it,
    without a guard beyond its 1e-20 ridge (ROADMAP queue 3 item 4a). A
    pixel seen at fewer than three polarization angles has a singular
    block, and its solve is rounding noise: finite garbage in one LU, NaN
    (the draw then unusable, mono0 kept) in another. guard (port-only, off
    by default) leaves out of Q and l every pixel whose block's smallest
    eigenvalue is below MONO_RCOND of its largest."""
    k = nmaps
    nd = A.shape[-1] - k
    dt, dev = A.dtype, A.device
    hit = A[:, 0, 0] > 0
    eye_k = torch.eye(k, dtype=dt, device=dev)
    Ass = A[:, :k, :k] + (~hit)[:, None, None] * eye_k + 1e-20 * eye_k
    Asd = A[:, :k, k:]                                   # (npix, k, Nd)
    Add = A[:, k:, k:]
    bs = b[:, :k]
    bd = b[:, k:]
    if guard and k > 1:
        lo, hi = sym3_eig_range(A[:, :k, :k])
        hit = hit & (lo > MONO_RCOND * hi)
        Ass = torch.where(hit[:, None, None], Ass, eye_k)
    X = torch.linalg.solve_ex(Ass, Asd)[0]               # (npix, k, Nd)
    Q = torch.sum(torch.where(hit[:, None, None], Add - torch.einsum(
        "pki,pkj->pij", Asd, X), 0.0), 0)
    l = torch.sum(torch.where(hit[:, None], bd - torch.einsum(
        "pki,pk->pi", X, bs), 0.0), 0)
    # orthonormal basis of the zero-sum subspace (Householder of ones)
    eye = torch.eye(nd, dtype=dt, device=dev)
    e = torch.ones(nd, dtype=dt, device=dev) / math.sqrt(nd)
    uh = e - eye[0]
    uh = uh / torch.clamp(torch.linalg.norm(uh), min=1e-30)
    V = (eye - 2.0 * torch.outer(uh, uh))[:, 1:].T       # (nd-1, nd)
    # a degenerate system (all scans rejected: Q ~ 0) keeps mono0
    tr = torch.trace(Q)
    ok = tr > 0
    tr_safe = torch.where(ok, tr, 1.0)
    eye1 = torch.eye(nd - 1, dtype=dt, device=dev)
    Qv = V @ Q @ V.T + 1e-7 * tr_safe * eye1
    Qv = torch.where(ok, Qv, eye1)
    lv = torch.where(ok, V @ l, 0.0)
    L = torch.linalg.cholesky_ex(Qv)[0]
    mean_v = torch.cholesky_solve(lv[:, None], L)[:, 0]
    eta = _normal(eta, (nd - 1,), A, generator)
    fluc_v = torch.linalg.solve_triangular(L.T, eta[:, None],
                                           upper=True)[:, 0]
    m = V.T @ (mean_v + fluc_v)
    m0 = torch.zeros(nd, dtype=dt, device=dev) if mono0 is None \
        else torch.as_tensor(mono0).to(device=dev, dtype=dt)
    return torch.where(ok, m, m0), ok.to(dt)


def bin_tod(calib_tod, pix, psi, mask, inv_var, npix: int, pol: bool,
            runs: PixelRuns | None = None):
    """Per-pixel normal equations of calibrated TOD: A = sum_t w_t u_t u_t^T,
    b = sum_t w_t d_t u_t with u = (1, cos2psi, sin2psi) (or (1,)), w =
    mask * inv_var (bin_TOD, comm_tod_mapmaking_mod.f90:34-94). Returns the
    packed float64 planes A (6 or 1, npix) (upper triangle: 00, 01, 02, 11,
    12, 22) and b (3 or 1, npix). The samples are gathered in pixel order a
    chunk at a time (runs: pixel_runs(pix, npix), made here when not given)
    and each pixel's run summed in float64."""
    runs = pixel_runs(pix, npix) if runs is None else runs
    w_all = (mask * inv_var[..., None]).reshape(-1)
    take = lambda x, idx: x.reshape(-1).index_select(0, idx).to(F64)

    def planes(idx):
        w, d = take(w_all, idx), take(calib_tod, idx)
        if not pol:
            return torch.stack([w, w * d], dim=1)
        ps = take(psi, idx)
        c, s = torch.cos(2.0 * ps), torch.sin(2.0 * ps)
        wd = w * d
        return torch.stack([w, w * c, w * s, w * c * c, w * c * s, w * s * s,
                            wd, wd * c, wd * s], dim=1)

    sums = _run_sums(runs, planes, 9 if pol else 2)
    return (sums[:6], sums[6:]) if pol else (sums[:1], sums[1:])


def pack_sym3(A):
    """(npix, 3, 3) symmetric -> packed (6, npix) upper components."""
    return torch.stack([A[:, 0, 0], A[:, 0, 1], A[:, 0, 2],
                        A[:, 1, 1], A[:, 1, 2], A[:, 2, 2]])


def finalize_binned_map(A, b, reg: float = 1e-20,
                        generator: torch.Generator | None = None, eta=None):
    """Solve the packed per-pixel systems in closed form (finalize_binned_map,
    comm_tod_mapmaking_mod.f90:96-299): returns (maps (k, npix), rms (k,
    npix), white-noise fluctuation map), in A's dtype (float64 from
    bin_tod). Unhit pixels, and polarized pixels whose 3x3 system fails
    det > 1e-3 a d f (fewer than three well-spread angles), get 0 map and 0
    rms. eta: optional (k, npix) standard normals."""
    eta = _normal(eta, b.shape, b, generator)
    hit = A[0] > 0
    if A.shape[0] == 1:
        a = torch.where(hit, A[0] + reg, 1.0)
        inv = torch.where(hit, 1.0 / a, 0.0)
        m = inv * b[0]
        rms = torch.sqrt(inv)
        return m[None], rms[None] * hit[None].to(rms.dtype), \
            (torch.sqrt(inv) * eta[0])[None]
    a = torch.where(hit, A[0] + reg, 1.0)
    bq = torch.where(hit, A[1], 0.0)
    c = torch.where(hit, A[2], 0.0)
    dd = torch.where(hit, A[3] + reg, 1.0)
    e = torch.where(hit, A[4], 0.0)
    f = torch.where(hit, A[5] + reg, 1.0)
    # symmetric 3x3 inverse by cofactors (elementwise planes)
    C00 = dd * f - e * e
    C01 = c * e - bq * f
    C02 = bq * e - c * dd
    det = a * C00 + bq * C01 + c * C02
    # undersampled polarized pixels are treated as unhit, and rejected
    # pixels reset to the identity before any division
    hit = hit & (det > 1e-3 * a * dd * f)
    det = torch.where(torch.abs(det) > 1e-30, det, 1.0)
    i00 = torch.where(hit, C00 / det, 1.0)
    i01 = torch.where(hit, C01 / det, 0.0)
    i02 = torch.where(hit, C02 / det, 0.0)
    i11 = torch.where(hit, (a * f - c * c) / det, 1.0)
    i12 = torch.where(hit, (c * bq - a * e) / det, 0.0)
    i22 = torch.where(hit, (a * dd - bq * bq) / det, 1.0)
    m = torch.stack([i00 * b[0] + i01 * b[1] + i02 * b[2],
                     i01 * b[0] + i11 * b[1] + i12 * b[2],
                     i02 * b[0] + i12 * b[1] + i22 * b[2]])
    rms = torch.sqrt(torch.clamp(torch.stack([i00, i11, i22]), min=0.0))
    # explicit Cholesky of the 3x3 inverse for the fluctuation draw
    L00 = torch.sqrt(torch.clamp(i00, min=1e-30))
    L10 = i01 / L00
    L20 = i02 / L00
    L11 = torch.sqrt(torch.clamp(i11 - L10 * L10, min=1e-30))
    L21 = (i12 - L20 * L10) / L11
    L22 = torch.sqrt(torch.clamp(i22 - L20 * L20 - L21 * L21, min=0.0))
    fluct = torch.stack([L00 * eta[0],
                         L10 * eta[0] + L11 * eta[1],
                         L20 * eta[0] + L21 * eta[1] + L22 * eta[2]])
    z = hit[None].to(m.dtype)
    return m * z, rms * z, fluct * z
