"""SED library: every diffuse component type of the reference (torch).

Counterpart of commander_tpu.model.seds: each SED is a function of frequency
[Hz] and the component's spectral parameters, returning the
brightness-temperature (uK_RJ) response normalized so the component amplitude
is in its natural unit at its reference frequency.

Frequencies and parameters are torch tensors or plain floats (numpy arrays
are taken as host tensors). Everything broadcasts: nu can be (nnode,) while a
parameter is a 0-d tensor or a (..., 1) map column. The result lies on the
device of the first tensor argument (the CPU when all are floats) and is
float64 unless every tensor argument is float32. The module-level tables
(spinning dust, physical dust) stay host numpy and are moved to the
arguments' device at use, once per device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.constants import C_LIGHT, H_OVER_K, H_PLANCK, K_BOLTZ, T_CMB


def _like(*args):
    """(dtype, device) of the first tensor argument; float64 on the CPU when
    there is none."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return (a.dtype if a.is_floating_point() else torch.float64,
                    a.device)
    return torch.float64, torch.device("cpu")


def _tensor(x, *others):
    """x as a tensor beside `others`. A Python number becomes a 0-d tensor
    filled on the device (no host-to-device copy, so no sync on a card)."""
    if isinstance(x, torch.Tensor):
        return x
    dtype, device = _like(*others)
    if isinstance(x, (int, float)):
        return torch.full((), float(x), dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def x_of(nu):
    """Dimensionless h nu / k T_cmb (prescaled h/k, constants.H_OVER_K)."""
    return nu * (H_OVER_K / T_CMB)


def thermo_to_rj(nu):
    """dT_RJ / dT_cmb at frequency nu: x^2 e^x / (e^x - 1)^2."""
    x = x_of(_tensor(nu))
    ex = torch.exp(x)
    return x * x * ex / torch.square(ex - 1.0)


def sed_cmb(nu, theta=()):
    """CMB: amplitude in uK_cmb, response in uK_RJ."""
    return thermo_to_rj(nu)


def sed_powlaw(nu, nu_ref, beta):
    """Power law (synchrotron): (nu/nu_ref)^beta."""
    nu = _tensor(nu, beta)
    return torch.exp(beta * torch.log(nu / nu_ref))


def sed_curved_powlaw(nu, nu_ref, beta, c_run):
    """Power law with curvature: (nu/nu0)^(beta + C log(nu/nu0))."""
    nu = _tensor(nu, beta, c_run)
    lr = torch.log(nu / nu_ref)
    return torch.exp((beta + c_run * lr) * lr)


def sed_mbb(nu, nu_ref, beta, T_d):
    """Modified blackbody (thermal dust):
    (nu/nu0)^(beta+1) (exp(h nu0/k T)-1)/(exp(h nu/k T)-1)."""
    nu = _tensor(nu, beta, T_d)
    T_d = _tensor(T_d, nu)
    x0 = H_OVER_K * nu_ref / T_d
    x = H_OVER_K * nu / T_d
    return torch.exp((beta + 1.0) * torch.log(nu / nu_ref)) \
        * torch.expm1(x0) / torch.expm1(x)


def _gaunt(nu, T_e):
    """Free-free Gaunt factor (Draine 2011 form used by the reference)."""
    nu9 = nu / 1e9
    Te4 = T_e / 1e4
    return torch.log(torch.exp(5.960 - (math.sqrt(3.0) / math.pi)
                               * torch.log(nu9 * Te4 ** (-1.5))) + math.e)


def sed_freefree(nu, nu_ref, T_e):
    """Free-free, amplitude uK_RJ at nu_ref:
    g_ff(nu;Te)/g_ff(nu0;Te) (nu0/nu)^2 exp(-h (nu - nu0)/k Te)."""
    nu = _tensor(nu, T_e)
    T_e = _tensor(T_e, nu)
    g = _gaunt(nu, T_e) / _gaunt(_tensor(nu_ref, nu), T_e)
    expf = torch.exp(-H_OVER_K * (nu - nu_ref) / T_e)
    return g * torch.square(nu_ref / nu) * expf


# --- spinning dust: template SED shifted in peak frequency -----------------
# Log-log interpolation of a tabulated j(nu)/nu^2 template, shifted so that
# its peak lands at nu_p. The built-in table is an analytic stand-in
# (log-normal bump, peak 30 GHz); set_spindust_template installs a real one
# (SpDust2).

_SPD_LOGNU = np.log(np.geomspace(0.05e9, 3000e9, 512))
_sig = 0.7
_SPD_LOGJ = (-2.0 * _SPD_LOGNU) + (-0.5 * ((_SPD_LOGNU - np.log(30e9)) / _sig) ** 2)
# native peak of the stored template, defined as the loader defines it
# (argmax of the raw emissivity j), so that nu_p means the same thing for the
# built-in and a loaded table
_SPD_PEAK = float(np.exp(_SPD_LOGNU[np.argmax(_SPD_LOGJ + 2.0 * _SPD_LOGNU)]))

# device copies of the module-level tables, keyed by (table name, device);
# the setters empty it
_ON_DEVICE: dict = {}


def _table(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.as_tensor(
            np.asarray(globals()[name], np.float64), device=device)
    return _ON_DEVICE[key]


def set_spindust_template(nu, j_emission, peak_hz):
    """Install a tabulated spinning-dust emissivity template (e.g. SpDust2)."""
    global _SPD_LOGNU, _SPD_LOGJ, _SPD_PEAK
    _SPD_LOGNU = np.log(np.asarray(nu))
    _SPD_LOGJ = np.log(np.asarray(j_emission) / np.asarray(nu) ** 2)
    _SPD_PEAK = float(peak_hz)
    _ON_DEVICE.clear()


def load_spindust_template(path):
    """Load a SpDust2-style two-column ASCII emissivity file (nu [GHz], j_nu;
    '#' comments) and install it, with the native peak taken at the
    emissivity maximum."""
    tbl = np.loadtxt(path, comments="#")
    nu = np.asarray(tbl[:, 0], np.float64) * 1e9
    j = np.asarray(tbl[:, 1], np.float64)
    order = np.argsort(nu)
    nu, j = nu[order], j[order]
    set_spindust_template(nu, j, nu[int(np.argmax(j))])


def _searchsorted(table, x, right=False):
    """torch.searchsorted of a 1-d table for x of any shape, 0-d included."""
    return torch.searchsorted(table, x.reshape(-1).contiguous(),
                              right=right).reshape(x.shape)


def _take(table, idx):
    """table[idx] along the table's last axis for an index tensor of any
    shape. A 0-d index tensor is never used as an index itself: torch reads
    it back to the host as a Python integer, which waits for the card."""
    return table[..., idx.reshape(-1)].reshape(table.shape[:-1] + idx.shape)


def _interp(x, xp, fp, left, right):
    """Piecewise-linear interpolation of (xp, fp) at x, with constant values
    outside the table (numpy.interp's rule)."""
    x = x.to(xp.dtype)
    i = torch.clamp(_searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    f0, f1, x0, x1 = _take(fp, i - 1), _take(fp, i), _take(xp, i - 1), \
        _take(xp, i)
    dx = x1 - x0
    f = torch.where(dx == 0, f1, f0 + ((x - x0) / dx) * (f1 - f0))
    f = torch.where(x < xp[0], torch.full_like(f, left), f)
    return torch.where(x > xp[-1], torch.full_like(f, right), f)


def _spd_interp(lognu):
    return _interp(lognu, _table("_SPD_LOGNU", lognu.device),
                   _table("_SPD_LOGJ", lognu.device), -300.0, -300.0)


def sed_spindust(nu, nu_ref, nu_p):
    """Spinning dust (AME), 1-parameter peak shift:
    S(nu; nu_p) = (nu_ref/nu)^2 f(nu nu_p0/nu_p) / f(nu_ref nu_p0/nu_p),
    f the tabulated intensity template and nu_p0 its native peak."""
    nu = _tensor(nu, nu_p)
    nu_p = _tensor(nu_p, nu)
    shift = math.log(_SPD_PEAK) - torch.log(nu_p)
    num = _spd_interp(torch.log(nu) + shift)
    den = _spd_interp(math.log(nu_ref) + shift)
    # the stored logJ = log(j/nu^2) carries the (nu_ref/nu)^2 intensity -> RJ
    # factor inside the difference
    return torch.exp(num - den)


def sed_spindust2(nu, nu_ref, nu_p, alpha):
    """2-parameter AME: peak shift and power-law tilt,
    S_spindust (nu/nu_ref)^alpha."""
    nu = _tensor(nu, nu_p, alpha)
    return sed_spindust(nu, nu_ref, nu_p) \
        * torch.exp(alpha * torch.log(nu / nu_ref))


# --- physical dust: multi-grain emission tables + U-distribution integral --
#   SED(nu; logUmin) = [ (1-gamma) sum_i A_i e_i(wav, logUmin)
#                        + gamma  sum_i A_i int e_i(wav, logU(u)) f(u) du ]
#                      / (same at nu_ref) * (nu_ref/nu)^3
# with f(u) du the Aniano et al. (2012) power-law radiation-field distribution
# between Umin = 10^theta and Umax. The default table is generated from
# modified-blackbody grain curves with T_i(U) = T0_i U^(1/6);
# set_physdust_model installs real DL07-style tables.

def _default_physdust_table():
    wav = np.geomspace(1.0, 3.0e6, 600)                       # um
    logU = np.linspace(-0.5, 0.5, 11)
    T0 = np.array([16.0, 19.0, 23.0, 9.0])
    beta_g = np.array([1.5, 1.7, 2.0, 1.2])
    nu = C_LIGHT / (wav * 1e-6)                               # (nnu,)
    T = T0[:, None, None] * (10.0 ** logU[None, None, :]) ** (1.0 / 6.0)
    x = H_PLANCK * nu[None, :, None] / (K_BOLTZ * T)
    # nu * I_nu with I_nu = Planck * nu^beta opacity (the (nu_ref/nu)^3
    # factor of sed_physdust assumes nu I_nu tables)
    log_e = ((4.0 + beta_g[:, None, None]) * np.log(nu[None, :, None])
             - np.log(np.expm1(np.clip(x, 1e-10, 700.0))))
    # a global offset cancels in the SED ratio; keep exp() in range
    log_e -= log_e.max()
    return np.log(wav), logU, log_e, np.array([1.0, 0.7, 0.3, 0.2])


_PD_LOGWAV, _PD_LOGU, _PD_LOGE, _PD_AMPS = _default_physdust_table()
_PD_PARS = {"log_umax": 0.5, "gamma": 0.0, "alpha": 2.0}


def set_physdust_model(wav_um, logU_grid, log_emission, amps,
                       log_umax=0.5, gamma=0.0, alpha=2.0):
    """Install physical-dust emission tables and auxiliary parameters
    (log_umax, gamma, alpha, amps)."""
    global _PD_LOGWAV, _PD_LOGU, _PD_LOGE, _PD_AMPS, _PD_PARS
    _PD_LOGWAV = np.log(np.asarray(wav_um))
    _PD_LOGU = np.asarray(logU_grid)
    # a global offset cancels in the SED ratio; keep exp() in range
    _PD_LOGE = np.asarray(log_emission) - np.max(log_emission)
    _PD_AMPS = np.asarray(amps)
    _PD_PARS = {"log_umax": float(log_umax), "gamma": float(gamma),
                "alpha": float(alpha)}
    _ON_DEVICE.clear()


def _pd_interp2(logwav, logu):
    """Bilinear interpolation of log e_i over (log wav, logU); returns the
    amp-weighted linear-space sum over grain components. Broadcasts logwav
    against a 0-d or array logu."""
    dev = logwav.device
    lw, lu = _table("_PD_LOGWAV", dev), _table("_PD_LOGU", dev)
    tbl = _table("_PD_LOGE", dev)                              # (nc, nw, nu)
    logwav, logu = torch.broadcast_tensors(logwav.to(lw.dtype),
                                           logu.to(lw.dtype))
    iw = torch.clamp(_searchsorted(lw, logwav) - 1, 0, lw.shape[0] - 2)
    iu = torch.clamp(_searchsorted(lu, logu) - 1, 0, lu.shape[0] - 2)
    fw = torch.clamp((logwav - _take(lw, iw))
                     / (_take(lw, iw + 1) - _take(lw, iw)), 0.0, 1.0)
    fu = torch.clamp((logu - _take(lu, iu))
                     / (_take(lu, iu + 1) - _take(lu, iu)), 0.0, 1.0)
    # one flat index into the (nw * nu) plane of each grain's table
    flat = tbl.reshape(tbl.shape[0], -1)
    at = lambda i, j: _take(flat, i * tbl.shape[2] + j)
    v00, v10, v01, v11 = at(iw, iu), at(iw + 1, iu), at(iw, iu + 1), \
        at(iw + 1, iu + 1)
    loge = (v00 * (1 - fw) * (1 - fu) + v10 * fw * (1 - fu)
            + v01 * (1 - fw) * fu + v11 * fw * fu)
    return torch.tensordot(_table("_PD_AMPS", dev), torch.exp(loge), dims=1)


def _pd_emission(nu, log_umin, n_u: int = 100):
    """(1-gamma) delta term + gamma U-distribution integral at frequency nu
    (broadcasts over nu)."""
    logwav = torch.log(C_LIGHT / nu * 1e6)
    gamma = _PD_PARS["gamma"]
    alpha = _PD_PARS["alpha"]
    out = (1.0 - gamma) * _pd_interp2(logwav, log_umin)
    if gamma != 0.0:
        log_umax = _PD_PARS["log_umax"]
        umin = 10.0 ** log_umin
        umax = 10.0 ** log_umax
        jj = torch.arange(n_u, dtype=nu.dtype, device=nu.device) / (n_u - 1.0)
        uval = umin * (umax / umin) ** jj                      # (n_u,)
        du = umin * ((umax / umin) ** (1.0 / (n_u - 1.0)) - 1.0)
        if alpha != 1.0:
            fdu = (uval ** (1.0 - alpha) * du * gamma * (alpha - 1.0)
                   / (umin ** (1.0 - alpha) - umax ** (1.0 - alpha)))
        else:
            fdu = du * gamma / torch.log(umax / umin) * torch.ones_like(uval)
        vals = _pd_interp2(logwav[..., None],
                           torch.log10(uval)
                           * torch.ones_like(logwav[..., None]))
        out = out + torch.sum(vals * fdu, dim=-1)
    return out


def sed_physdust(nu, nu_ref, log_umin):
    """Physical (multi-grain) dust SED, parameter theta = log10 Umin.
    Emission ratio normalized at nu_ref, converted to brightness-temperature
    units by (nu_ref/nu)^3; zero below 2 GHz."""
    nu = _tensor(nu, log_umin)
    log_umin = _tensor(log_umin, nu)
    num = _pd_emission(nu, log_umin)
    den = _pd_emission(_tensor(nu_ref, nu), log_umin)
    sed = (num / den) * (nu_ref / nu) ** 3
    return torch.where(nu < 2e9, torch.zeros_like(sed), sed)


def sed_line(nu, nu_ref, width_hz=1e6):
    """Line emission (CO): delta response at the line frequency. The mixing
    matrix assigns per-band line ratios itself (mixing_element); this form
    serves quadrature integrals."""
    nu = _tensor(nu)
    return torch.where(torch.abs(nu - nu_ref) < width_hz,
                       torch.ones_like(nu), torch.zeros_like(nu))


SED_REGISTRY = {
    "cmb": sed_cmb,
    "power_law": sed_powlaw,
    "curved_power_law": sed_curved_powlaw,
    "MBB": sed_mbb,
    "freefree": sed_freefree,
    "spindust": sed_spindust,
    "spindust2": sed_spindust2,
    "physdust": sed_physdust,
    "line": sed_line,
}

# number of spectral parameters per type (theta columns)
SED_NPAR = {
    "cmb": 0, "power_law": 1, "curved_power_law": 2, "MBB": 2,
    "freefree": 1, "spindust": 1, "spindust2": 2, "physdust": 1,
    "line": 0, "md": 0, "template": 0, "cmb_relquad": 0,
}
