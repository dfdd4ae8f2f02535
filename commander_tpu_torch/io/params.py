"""Commander parameter-file parser and the typed run configuration.

The port's own copy of commander_tpu.io.params (plain Python): the
reference's flat ``KEY = value`` files (comm_param_mod.f90:
read_paramfile_to_ascii :2076-2141 with @INCLUDE directives; indexed keys
like BAND_NSIDE001 / COMP_TYPE02 encode arrays), lowered into the
dataclasses that drive the driver (driver/model.py, driver/loop.py) and the
presets (entry.py). Field names, defaults and lowering are the JAX
package's, so a config lowered by either package has the same fields.

Grammar notes mirrored from the reference:
  * '#' starts a comment; the value is the first whitespace token unless
    quoted (extra tokens are treated as trailing comment, e.g.
    ``CG_CONVERGENCE_CRITERION = fixed_iter chisq``).
  * Fortran literals: .true./.false., 1.d0 exponents.
  * ``@INCLUDE file`` splices another parameter file.
  * ``--KEY=value`` overrides (Params.override) replace a key after the
    file is read, as the reference's command-line overrides do.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional


def _strip_value(raw: str) -> str:
    raw = raw.strip()
    if not raw:
        return raw
    if raw[0] in "'\"":
        q = raw[0]
        end = raw.find(q, 1)
        return raw[1:end] if end > 0 else raw[1:]
    # first whitespace-separated token
    return raw.split()[0]


def parse_value(s: str):
    """Typed conversion with Fortran literal support."""
    low = s.lower()
    if low in (".true.", "true"):
        return True
    if low in (".false.", "false"):
        return False
    if low in ("none", ""):
        return None
    t = re.sub(r"[dD]([+-]?\d)", r"e\1", s)
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    return s


def read_paramfile(path: str) -> dict[str, str]:
    """Flat KEY -> raw string value (includes expanded, later keys win)."""
    out: dict[str, str] = {}
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("*"):
                continue
            if line.startswith("@INCLUDE"):
                inc = line.split(None, 1)[1].strip().strip("'\"")
                if not os.path.isabs(inc):
                    inc = os.path.join(base, inc)
                out.update(read_paramfile(inc))
                continue
            if "=" not in line:
                continue
            key, raw = line.split("=", 1)
            out[key.strip()] = raw.strip()   # keep full raw; strip on access
    return out


class Params:
    """Typed access over the flat dictionary, with indexed-key helpers."""

    def __init__(self, table: dict[str, str]):
        self.table = table

    @classmethod
    def load(cls, path: str, overrides=()) -> "Params":
        """The file at `path`, then `overrides`: "--KEY=value" (or
        "KEY=value") strings, each replacing KEY."""
        p = cls(read_paramfile(path))
        p.override(overrides)
        return p

    def override(self, items):
        """Apply "--KEY=value" overrides in order (later ones win)."""
        for item in items:
            s = str(item)
            s = s[2:] if s.startswith("--") else s
            if "=" not in s:
                raise ValueError(f"parameter override {item!r} is not "
                                 f"--KEY=value")
            key, raw = s.split("=", 1)
            self.table[key.strip()] = raw.strip()

    def get(self, key: str, default=None):
        if key not in self.table:
            return default
        return parse_value(_strip_value(self.table[key]))

    def get_indexed(self, prefix: str, i: int, default=None, width: int = 0,
                    raw: bool = False):
        """BAND_NSIDE001-style lookup; tries widths 3 and 2 like the
        reference's itext formats. raw=True returns the uncoerced string
        token (labels like '030' must not collapse to int 30)."""
        for w in ([width] if width else [3, 2]):
            k = f"{prefix}{i:0{w}d}"
            if k in self.table:
                tok = _strip_value(self.table[k])
                return tok if raw else parse_value(tok)
        return default


# --------------------------------------------------------------------------
# Typed model configuration (lowered form)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class BandConfig:
    label: str
    nside: int
    lmax: int
    unit: str
    polarized: bool
    nominal_freq_ghz: float
    mapfile: Optional[str] = None
    noisefile: Optional[str] = None
    maskfile: Optional[str] = None
    beamfile: Optional[str] = None
    beam_fwhm_arcmin: float = 0.0
    bandpass_type: str = "delta"
    bandpassfile: Optional[str] = None
    noise_format: str = "rms"
    gain_prior_mean: float = 1.0
    gain_prior_rms: float = 0.0
    sample_gain: bool = False
    gain_calib_comp: str = "all"           # BAND_GAIN_CALIB_COMP
    gain_lmin: int = -1                    # BAND_GAIN_LMIN
    gain_lmax: int = -1                    # BAND_GAIN_LMAX
    maskfile_calib: Optional[str] = None   # BAND_MASKFILE_CALIB (gain mask)
    gain_apod_fwhm: float = 0.0            # BAND_GAIN_APOD_FWHM (arcmin)
    tod_type: str = "none"
    sample_bandpass: bool = False          # BAND_SAMP_BANDPASS
    bandpass_model: str = "additive_shift"  # BAND_BANDPASS_MODEL
    tod_filelist: Optional[str] = None     # BAND_TOD_FILELIST
    tod_flag: int = 0                      # BAND_TOD_FLAG (bad-flag bits)
    tod_start_scan: int = 1                # BAND_TOD_START_SCANID
    tod_end_scan: int = 2 ** 31 - 1        # BAND_TOD_END_SCANID
    tod_detectors: Optional[tuple] = None  # BAND_TOD_DETECTOR_LIST
    tod_rimo: Optional[str] = None         # BAND_TOD_RIMO (instrument HDF)
    tod_bp_delta_init: float = 0.0         # BAND_TOD_BP_INIT_PROP (shift)


@dataclasses.dataclass
class ComponentParamConfig:
    label: str
    ctype: str
    cclass: str
    polarized: bool
    nside: int
    lmax_amp: int
    lmin_amp: int
    lmax_ind: int
    unit: str
    nu_ref_t_ghz: float
    cl_type: Optional[str]
    cl_amp_def: tuple
    cl_beta_def: tuple
    cl_lpivot: int
    mask: Optional[str]
    sed_template: Optional[str] = None    # COMP_SED_TEMPLATE (spindust/physdust)
    indices: dict = dataclasses.field(default_factory=dict)  # name -> (default, prior_mean, prior_rms, min, max, sample)
    cl_bin_file: Optional[str] = None     # COMP_CL_BIN_FILE (binned type)
    cl_poltype: int = 1                   # COMP_CL_POLTYPE
    cg_samp_groups: tuple = ()            # COMP_CG_SAMPLE_GROUP (may list several)
    cg_samp_group_maxiter: int = 0        # COMP_CG_SAMP_GROUP_MAXITER
    catalog: Optional[str] = None         # COMP_CATALOG (ptsrc)
    template_file: Optional[str] = None   # COMP_TEMPLATE_DEFINITION_FILE
    amp_prior_mean: float = 0.0           # COMP_PRIOR_GAUSS_MEAN (templates)
    amp_prior_rms: float = 0.0            # COMP_PRIOR_GAUSS_RMS
    amp_default: float = 1.0              # COMP_DEFAULT_AMPLITUDE


@dataclasses.dataclass
class RunConfig:
    operation: str
    num_gibbs_iter: int
    numchain: int
    base_seed: int
    cg_maxiter: int
    cg_tol: float
    cg_miniter: int
    output_dir: str
    thinning: int
    output_chisq_map: bool
    output_residual_maps: bool
    sample_amps: bool
    sample_specind: bool
    sample_powspec: bool
    enable_tod: bool
    bands: list
    comps: list
    smoothing_scales: list = dataclasses.field(default_factory=list)
    output_input_model: bool = False      # OUTPUT_INPUT_MODEL
    output_debug_seds: bool = False       # OUTPUT_DEBUG_SEDS
    # synthetic-TOD scale (driver --synthetic runs without archives;
    # production-scale e2e raises these to realistic scans/samples)
    synth_tod_nscan: int = 8
    synth_tod_ndet: int = 2
    synth_tod_ntod: int = 4096
    # per-sample white-noise sigma0 as a multiple of the mean map-level
    # rms. The historical test default (0.05) makes binned maps ~100x
    # more precise than the map-noise config — good for tight gain/PSD
    # recovery tests, catastrophic for CG conditioning at scale; the
    # flagship configs set ~sqrt(hits/pixel) so binned rms matches the
    # map-level rms.
    synth_tod_sigma0_scale: float = 0.05
    synth_tod_fknee: float = 0.3       # SYNTH_TOD_FKNEE [Hz]
    output_cg_freq: int = 0               # OUTPUT_EVERY_NTH_CG_ITERATION
    almsamp_pixreg: bool = False          # ALMSAMP_PIXREG
    init_chain: 'Optional[str]' = None    # INIT_CHAIN / INIT_CHAIN01 ('file:samp')
    resample_cmb: bool = False            # RESAMPLE_CMB
    numsamp_per_resamp: int = 1           # NUMSAMP_PER_RESAMP
    first_samp_resamp: int = 1            # FIRST_SAMPLE_FOR_CMB_RESAMP
    last_samp_resamp: int = 1             # LAST_SAMPLE_FOR_CMB_RESAMP
    cg_precond: str = "diagonal"          # CG_PRECOND_TYPE
    cg_lmax_precond: int = -1             # CG_LMAX_PRECOND (low-l dense)
    cg_conv_crit: str = "residual"        # CG_CONVERGENCE_CRITERION
    # user-defined CG sampling groups (CG_SAMPLING_GROUPxx keys):
    # list of dicts {comps: [labels], mask: str|None, maxiter: int}
    cg_user_groups: list = dataclasses.field(default_factory=list)
    include_tod_zodi: bool = False        # TOD_INCLUDE_ZODI
    sample_tod_mono: bool = False         # SAMPLE_TOD_MONOPOLE (TOD-level
    #                                       per-det monopoles; sample_mono,
    #                                       comm_tod_mapmaking_mod.f90:300)
    tod_num_bp_prop: int = 1              # NUM_BP_PROPOSALS_PER_ITER
    tod_4d_nth_iter: int = 0              # TOD_OUTPUT_4D_MAP_EVERY_NTH_ITER
    resamp_hard_gain_nth: int = 0         # NUMITER_RESAMPLE_HARD_GAIN_PRIORS


# per-type spectral index key names in the reference param files
_IND_KEYS = {
    "power_law": [("BETA", "DEFAULT_BETA")],
    "curved_power_law": [("BETA", "DEFAULT_BETA"), ("C_S", "DEFAULT_C_S")],
    "MBB": [("BETA", "DEFAULT_BETA"), ("T", "DEFAULT_T")],
    "freefree": [("T_E", "DEFAULT_T_E")],
    "spindust": [("NU_P", "DEFAULT_NU_P")],
    "spindust2": [("NU_P", "DEFAULT_NU_P"), ("ALPHA", "DEFAULT_ALPHA")],
    "physdust": [("U", "DEFAULT_U")],
}


def lower_params(p: Params) -> RunConfig:
    """Lower a Commander parameter table to the typed RunConfig."""
    nb = int(p.get("NUMBAND", 0))
    bands = []
    for i in range(1, nb + 1):
        if not p.get_indexed("INCLUDE_BAND", i, False):
            continue
        bands.append(BandConfig(
            label=str(p.get_indexed("BAND_LABEL", i, f"band{i}",
                                    raw=True)),
            nside=int(p.get_indexed("BAND_NSIDE", i, 64)),
            lmax=int(p.get_indexed("BAND_LMAX", i, 128)),
            unit=str(p.get_indexed("BAND_UNIT", i, "uK_cmb")),
            polarized=bool(p.get_indexed("BAND_POLARIZATION", i, False)),
            nominal_freq_ghz=float(p.get_indexed("BAND_NOMINAL_FREQ", i, 100.0)),
            mapfile=p.get_indexed("BAND_MAPFILE", i),
            noisefile=p.get_indexed("BAND_NOISEFILE", i),
            maskfile=p.get_indexed("BAND_MASKFILE", i),
            beamfile=p.get_indexed("BAND_BEAM_B_L_FILE", i),
            beam_fwhm_arcmin=float(
                p.get_indexed("BAND_BEAM_FWHM", i, 0.0) or 0.0),
            bandpass_type=str(p.get_indexed("BAND_BANDPASS_TYPE", i, "delta")),
            bandpassfile=p.get_indexed("BAND_BANDPASSFILE", i),
            noise_format=str(p.get_indexed("BAND_NOISE_FORMAT", i, "rms")),
            gain_prior_mean=float(p.get_indexed("BAND_GAIN_PRIOR_MEAN", i, 1.0)),
            gain_prior_rms=float(p.get_indexed("BAND_GAIN_PRIOR_RMS", i, 0.0)),
            sample_gain=bool(p.get_indexed("BAND_SAMP_GAIN", i, False)),
            gain_calib_comp=str(p.get_indexed("BAND_GAIN_CALIB_COMP", i,
                                              "all")),
            gain_lmin=int(p.get_indexed("BAND_GAIN_LMIN", i, -1)),
            gain_lmax=int(p.get_indexed("BAND_GAIN_LMAX", i, -1)),
            maskfile_calib=p.get_indexed("BAND_MASKFILE_CALIB", i),
            gain_apod_fwhm=float(p.get_indexed("BAND_GAIN_APOD_FWHM", i,
                                               0.0) or 0.0),
            tod_type=str(p.get_indexed("BAND_TOD_TYPE", i, "none")),
            tod_filelist=p.get_indexed("BAND_TOD_FILELIST", i),
            tod_flag=int(p.get_indexed("BAND_TOD_FLAG", i, 0)),
            tod_start_scan=int(p.get_indexed("BAND_TOD_START_SCANID", i, 1)),
            tod_end_scan=int(p.get_indexed("BAND_TOD_END_SCANID", i,
                                           2 ** 31 - 1)),
            tod_detectors=(tuple(
                s.strip() for s in str(p.get_indexed(
                    "BAND_TOD_DETECTOR_LIST", i)).split(","))
                if p.get_indexed("BAND_TOD_DETECTOR_LIST", i) else None),
            tod_rimo=p.get_indexed("BAND_TOD_RIMO", i),
            sample_bandpass=bool(p.get_indexed("BAND_SAMP_BANDPASS", i,
                                               False)),
            bandpass_model=str(p.get_indexed("BAND_BANDPASS_MODEL", i,
                                             "additive_shift")),
        ))

    comps = []
    i = 0
    while True:
        i += 1
        label = p.get_indexed("COMP_LABEL", i)
        if label is None:
            break
        if not p.get_indexed("INCLUDE_COMP", i, True):
            continue
        ctype = str(p.get_indexed("COMP_TYPE", i, "cmb"))
        indices = {}
        for name, defkey in _IND_KEYS.get(ctype, []):
            default = p.get_indexed(f"COMP_{defkey}", i)
            # reference key grammar: COMP_PRIOR_GAUSS_<NAME>_MEAN/RMS and
            # COMP_PRIOR_UNI_<NAME>_LOW/HIGH (see param_tutorial.txt)
            pm = p.get_indexed(f"COMP_PRIOR_GAUSS_{name}_MEAN", i)
            pr = p.get_indexed(f"COMP_PRIOR_GAUSS_{name}_RMS", i)
            lo = p.get_indexed(f"COMP_PRIOR_UNI_{name}_LOW", i)
            hi = p.get_indexed(f"COMP_PRIOR_UNI_{name}_HIGH", i)
            ss = p.get_indexed(f"COMP_{name}_SMOOTHING_SCALE", i, 0)
            lt = p.get_indexed(f"COMP_{name}_INT_LNLTYPE", i, "chisq")
            ltp = p.get_indexed(f"COMP_{name}_POL_LNLTYPE", i, None)
            pt = p.get_indexed(f"COMP_{name}_POLTYPE", i, 1)
            # pixel-region keys (COMP_<PAR>_T_NUM_PIXREG / _FIX_PIXREG /
            # _PIXREG_PRIORS, COMP_<PAR>_PIXREG_MAP;
            # comm_param_mod.f90:807-848)
            npr = p.get_indexed(f"COMP_{name}_T_NUM_PIXREG", i,
                                p.get_indexed(f"COMP_{name}_NUM_PIXREG",
                                              i, 0))
            prmap = p.get_indexed(f"COMP_{name}_PIXREG_MAP", i)
            prpri = p.get_indexed(f"COMP_{name}_T_PIXREG_PRIORS", i,
                                  p.get_indexed(
                                      f"COMP_{name}_PIXREG_PRIORS", i))
            prfix = p.get_indexed(f"COMP_{name}_T_FIX_PIXREG", i,
                                  p.get_indexed(
                                      f"COMP_{name}_FIX_PIXREG", i))
            indices[name.lower()] = dict(default=default, prior_mean=pm,
                                         prior_rms=pr, low=lo, high=hi,
                                         smoothing_scale=int(ss or 0),
                                         lnl_type=str(lt or "chisq"),
                                         lnl_type_pol=str(ltp) if ltp
                                         else str(lt or "chisq"),
                                         poltype=int(pt or 1),
                                         num_pixreg=int(npr or 0),
                                         pixreg_map=prmap,
                                         pixreg_priors=str(prpri)
                                         if prpri is not None else None,
                                         fix_pixreg=str(prfix)
                                         if prfix is not None else None)
        # COMP_CG_SAMPLE_GROUP may list several group ids ('0  1'); keep
        # the full token list (comm_comp_mod CG sampling-group membership)
        cgg = ()
        for w in (3, 2):
            k = f"COMP_CG_SAMPLE_GROUP{i:0{w}d}"
            if k in p.table:
                raw = p.table[k].split("#", 1)[0]
                cgg = tuple(int(t) for t in raw.split()
                            if t.lstrip("-").isdigit())
                break
        comps.append(ComponentParamConfig(
            label=str(label), ctype=ctype,
            cclass=str(p.get_indexed("COMP_CLASS", i, "diffuse")),
            polarized=bool(p.get_indexed("COMP_POLARIZATION", i, False)),
            nside=int(p.get_indexed("COMP_NSIDE", i, 64)),
            lmax_amp=int(p.get_indexed("COMP_LMAX_AMP", i, 128)),
            lmin_amp=int(p.get_indexed("COMP_LMIN_AMP", i, 0)),
            lmax_ind=int(p.get_indexed("COMP_LMAX_IND", i, 0) or 0),
            unit=str(p.get_indexed("COMP_UNIT", i, "uK_RJ")),
            nu_ref_t_ghz=_nu_ref(p, i),
            cl_type=p.get_indexed("COMP_CL_TYPE", i),
            cl_amp_def=(p.get_indexed("COMP_CL_DEFAULT_AMP_T", i, 1.0),
                        p.get_indexed("COMP_CL_DEFAULT_AMP_E", i, 1.0),
                        p.get_indexed("COMP_CL_DEFAULT_AMP_B", i, 1.0)),
            cl_beta_def=(p.get_indexed("COMP_CL_DEFAULT_BETA_T", i, 0.0),
                         p.get_indexed("COMP_CL_DEFAULT_BETA_E", i, 0.0),
                         p.get_indexed("COMP_CL_DEFAULT_BETA_B", i, 0.0)),
            cl_lpivot=int(p.get_indexed("COMP_CL_L_PIVOT", i, 50) or 50),
            mask=p.get_indexed("COMP_MASK", i),
            sed_template=p.get_indexed("COMP_SED_TEMPLATE", i),
            indices=indices,
            cl_bin_file=p.get_indexed("COMP_CL_BIN_FILE", i),
            cl_poltype=int(p.get_indexed("COMP_CL_POLTYPE", i, 1) or 1),
            cg_samp_groups=cgg,
            cg_samp_group_maxiter=int(
                p.get_indexed("COMP_CG_SAMP_GROUP_MAXITER", i, 0) or 0),
            catalog=p.get_indexed("COMP_CATALOG", i),
            template_file=p.get_indexed("COMP_TEMPLATE_DEFINITION_FILE", i),
            amp_prior_mean=float(
                p.get_indexed("COMP_PRIOR_GAUSS_MEAN", i, 0.0) or 0.0),
            amp_prior_rms=float(
                p.get_indexed("COMP_PRIOR_GAUSS_RMS", i, 0.0) or 0.0),
            amp_default=float(
                p.get_indexed("COMP_DEFAULT_AMPLITUDE", i, 1.0) or 1.0),
        ))

    return RunConfig(
        operation=str(p.get("OPERATION", "sample")),
        num_gibbs_iter=int(p.get("NUM_GIBBS_ITER", 10)),
        numchain=int(p.get("NUMCHAIN", 1)),
        base_seed=int(p.get("BASE_SEED", 0)),
        cg_maxiter=int(p.get("CG_MAXITER", 300)),
        cg_tol=float(p.get("CG_TOLERANCE", 1e-8)),
        cg_miniter=int(p.get("CG_MINITER", 0)),
        output_dir=str(p.get("OUTPUT_DIRECTORY", "./chains")),
        thinning=int(p.get("THINNING_FACTOR", 1)),
        output_chisq_map=bool(p.get("OUTPUT_CHISQ_MAP", False)),
        output_residual_maps=bool(p.get("OUTPUT_RESIDUAL_MAPS", False)),
        sample_amps=bool(p.get("SAMPLE_SIGNAL_AMPLITUDES", True)),
        sample_specind=bool(p.get("SAMPLE_SPECTRAL_INDICES", False)),
        sample_powspec=bool(p.get("SAMPLE_POWSPEC", False)),
        enable_tod=bool(p.get("ENABLE_TOD_ANALYSIS", False)),
        include_tod_zodi=bool(p.get("TOD_INCLUDE_ZODI", False)),
        sample_tod_mono=bool(p.get("SAMPLE_TOD_MONOPOLE", False)),
        tod_num_bp_prop=int(p.get("NUM_BP_PROPOSALS_PER_ITER", 1)),
        tod_4d_nth_iter=int(p.get("TOD_OUTPUT_4D_MAP_EVERY_NTH_ITER", 0)
                            or 0),
        resamp_hard_gain_nth=int(
            p.get("NUMITER_RESAMPLE_HARD_GAIN_PRIORS", 0) or 0),
        output_input_model=bool(p.get("OUTPUT_INPUT_MODEL", False)),
        output_debug_seds=bool(p.get("OUTPUT_DEBUG_SEDS", False)),
        synth_tod_nscan=int(p.get("SYNTH_TOD_NSCAN", 8) or 8),
        synth_tod_ndet=int(p.get("SYNTH_TOD_NDET", 2) or 2),
        synth_tod_ntod=int(p.get("SYNTH_TOD_NTOD", 4096) or 4096),
        synth_tod_sigma0_scale=float(
            p.get("SYNTH_TOD_SIGMA0_SCALE", 0.05) or 0.05),
        synth_tod_fknee=float(p.get("SYNTH_TOD_FKNEE", 0.3) or 0.3),
        output_cg_freq=int(p.get("OUTPUT_EVERY_NTH_CG_ITERATION", 0)
                           or 0),
        almsamp_pixreg=bool(p.get("ALMSAMP_PIXREG", False)),
        init_chain=(lambda v: None if v is None or str(v).lower() == "none"
                    else str(v))(p.get("INIT_CHAIN",
                                       p.get_indexed("INIT_CHAIN", 1))),
        cg_precond=str(p.get("CG_PRECOND_TYPE", "diagonal")),
        cg_lmax_precond=int(p.get("CG_LMAX_PRECOND", -1) or -1),
        cg_conv_crit=str(p.get("CG_CONVERGENCE_CRITERION", "residual")),
        cg_user_groups=[
            dict(comps=[t.strip() for t in
                        str(p.get_indexed("CG_SAMPLING_GROUP", g, "")
                            ).split(",") if t.strip()],
                 mask=p.get_indexed("CG_SAMPLING_GROUP_MASK", g),
                 maxiter=int(p.get_indexed("CG_SAMPLING_GROUP_MAXITER",
                                           g, 0) or 0))
            for g in range(1, int(p.get("NUM_CG_SAMPLING_GROUPS", 0)) + 1)],
        resample_cmb=bool(p.get("RESAMPLE_CMB", False)),
        numsamp_per_resamp=int(p.get("NUMSAMP_PER_RESAMP", 1)),
        first_samp_resamp=int(p.get("FIRST_SAMPLE_FOR_CMB_RESAMP", 1)),
        last_samp_resamp=int(p.get("LAST_SAMPLE_FOR_CMB_RESAMP", 1)),
        bands=bands, comps=comps,
        smoothing_scales=[
            dict(fwhm=float(p.get_indexed("SMOOTHING_SCALE_FWHM", k, 0.0)
                            or 0.0),
                 fwhm_postproc=float(
                     p.get_indexed("SMOOTHING_SCALE_FWHM_POSTPROC", k, 0.0)
                     or 0.0),
                 lmax=int(p.get_indexed("SMOOTHING_SCALE_LMAX", k, 0) or 0),
                 nside=int(p.get_indexed("SMOOTHING_SCALE_NSIDE", k, 0)
                           or 0))
            for k in range(1, int(p.get("NUM_SMOOTHING_SCALES", 0)) + 1)],
    )


def _nu_ref(p: Params, i: int) -> float:
    """COMP_NU_REF_T is written as 'count freq' pairs in some files
    ('1  100.'); _strip_value keeps the first token, so check both."""
    v = p.get_indexed("COMP_NU_REF_T", i, 100.0)
    raw = None
    for w in (3, 2):
        k = f"COMP_NU_REF_T{i:0{w}d}"
        if k in p.table:
            raw = p.table[k]
    if raw is not None:
        toks = raw.split()
        if len(toks) >= 2:
            return float(re.sub(r"[dD]([+-]?\d)", r"e\1", toks[-1]))
    return float(v)
