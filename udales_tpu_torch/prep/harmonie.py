"""HARMONIE NWP surface-radiation coupling (udprep harmonie_radiation.py).

Bridges HARMONIE accumulated surface radiation (``ssrd`` shortwave /
``strd`` longwave, J/m^2 accumulated since forecast start) to this
package's time-dependent radiation inputs:

  1. accumulated -> instantaneous flux decomposition on the NWP's native
     output cadence (tools/python/udprep/harmonie_radiation.py:448-490),
     with the negative-flux tolerance and the exact energy-conservation
     invariant  sum(flux_i * dt) == accum(end) - accum(start),
  2. interpolation onto the uDALES model times (:493-498),
  3. direct/diffuse split of global horizontal irradiance against solar
     position using the Erbs et al. diffuse-fraction correlation and the
     extraterrestrial clearness index (:501-558),
  4. facet mapping through the existing direct-shortwave / view-factor /
     reflection machinery (:813-893 -> `prep.weather.shortwave_from_weather`),
  5. writers: `timedepsw.inp` / `timedeplw.inp` in this package's
     time-major solver layout or the reference's transposed layout
     (:747-790), plus the measured-weather table schema that
     `prep.weather.read_weather_table` consumes (so a HARMONIE forecast can
     drive the whole isolar=3 pathway unchanged).

The GRIB download/decoding plumbing of the reference (:236-305, demo-data
fetch, cfgrib datasets, Lambert-93 masking) is deliberately thin here: the
core math is exposed on plain arrays, and `read_accumulated_table` provides
a dependency-free on-disk format.  `grib_mean_accumulation` gates the
optional xarray/cfgrib path behind a clear ImportError.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np

from .solar import nsun_from_angles, solar_position

SOLAR_CONSTANT_W_M2 = 1367.0
MIN_DIRECT_COS_ZENITH = 1.0e-2
ACCUMULATED_FLUX_TOLERANCE_W_M2 = 1.0e-2


# ---------------------------------------------------------------------------
# accumulated -> instantaneous flux
# ---------------------------------------------------------------------------

def accumulated_to_flux(offsets_seconds, accumulated_j_m2,
                        start_offset_seconds: int | None = None,
                        tolerance: float = ACCUMULATED_FLUX_TOLERANCE_W_M2):
    """Decompose an accumulated-energy series into mean fluxes.

    `offsets_seconds` are forecast offsets (seconds since the NWP cycle
    start, uniformly spaced); `accumulated_j_m2[i]` is the energy
    accumulated over [0, offsets[i]].  The FIRST entry is the lead anchor:
    one cadence interval before the case start (or the forecast start
    itself, where the accumulation is 0).  Returns ``(model_times, flux)``
    for entries 1.. where ``flux[i]`` is the mean W/m^2 over the interval
    ENDING at offsets[i+1] and ``model_times = offsets[1:] -
    start_offset`` (default start_offset = offsets[1], so the first flux
    lands at model time 0 — exactly harmonie_radiation.py:448-490, which
    differences each cadence point against the previous one).

    Conservation invariant (tested):
        sum(flux * interval) == accum[last] - accum[first]
    Negative differenced fluxes beyond `tolerance` raise; smaller negative
    roundoff is clamped to zero.
    """
    offsets = np.asarray(offsets_seconds, np.int64)
    accum = np.asarray(accumulated_j_m2, np.float64)
    if offsets.size < 2 or offsets.size != accum.size:
        raise ValueError("need matching offsets/accumulated series, >= 2 "
                         "entries (the first is the lead anchor)")
    steps = np.diff(offsets)
    if np.any(steps <= 0) or np.any(steps != steps[0]):
        raise ValueError("offsets must be uniformly increasing")
    interval = int(steps[0])
    if int(offsets[0]) < 0:
        raise ValueError(
            "Cannot difference accumulated radiation before forecast start: "
            f"lead anchor at {int(offsets[0])} s < 0.")
    if start_offset_seconds is None:
        start_offset_seconds = int(offsets[1])

    flux = np.diff(accum) / float(interval)
    bad = flux < -tolerance
    if np.any(bad):
        i = int(np.flatnonzero(bad)[0])
        raise ValueError(
            f"Negative accumulated-radiation flux at forecast offset "
            f"{int(offsets[i + 1])} s: {flux[i]:.6f} W/m2")
    flux = np.maximum(0.0, flux)
    model_times = offsets[1:].astype(np.float64) - float(start_offset_seconds)
    return model_times, flux


def read_accumulated_table(path: str | Path):
    """Dependency-free accumulated-series format: comment lines with '#',
    then rows ``offset_seconds  accumulated_J_m2``."""
    d = np.loadtxt(Path(path), comments="#", ndmin=2)
    return d[:, 0].astype(np.int64), d[:, 1]


def grib_mean_accumulation(path, field="ssrd", type_of_level="surface",
                           mask=None):
    """Spatial-mean accumulated value from one HARMONIE GRIB file
    (harmonie_radiation.py:405-445).  Requires xarray + cfgrib (not baked
    into this image) — gated with a clear error."""
    try:
        import xarray as xr  # noqa: F401
    except ImportError as exc:  # pragma: no cover - optional dependency
        raise ImportError(
            "GRIB ingestion needs xarray+cfgrib; convert the HARMONIE "
            "series to the plain-text accumulated table "
            "(read_accumulated_table) instead") from exc
    ds = xr.open_dataset(
        path, engine="cfgrib",
        backend_kwargs={"filter_by_keys": {"shortName": field,
                                           "typeOfLevel": type_of_level},
                        "indexpath": ""})
    try:
        name = field if field in ds.data_vars else list(ds.data_vars)[0]
        vals = ds[name].values
        if mask is not None:
            vals = vals[mask]
        return float(np.nanmean(vals, dtype=np.float64))
    finally:
        ds.close()


def interpolate_flux_to_times(source_times, source_flux, target_times):
    """(harmonie_radiation.py:493-498)."""
    source_times = np.asarray(source_times, np.float64)
    if source_times.size == 0:
        raise ValueError("source_times is empty")
    return np.interp(np.asarray(target_times, np.float64), source_times,
                     np.asarray(source_flux, np.float64))


def make_model_times(runtime: float, dt: float, nt: int | None = None):
    """uDALES sample times 0..runtime at dtSP (or exactly nt samples,
    harmonie_radiation.py:315-319)."""
    if nt is not None and int(nt) > 0:
        return np.linspace(0.0, float(runtime), int(nt))
    return np.arange(0.0, float(runtime) + 0.5 * float(dt), float(dt))


# ---------------------------------------------------------------------------
# GHI -> (DNI, Dsky) split
# ---------------------------------------------------------------------------

def extraterrestrial_horizontal_irradiance(when: datetime,
                                           cos_zenith: float) -> float:
    """I0h with the +-3.3% orbital eccentricity correction
    (harmonie_radiation.py:501-509)."""
    if cos_zenith <= 0.0:
        return 0.0
    doy = int(when.timetuple().tm_yday)
    ecc = 1.0 + 0.033 * math.cos(2.0 * math.pi * doy / 365.0)
    return SOLAR_CONSTANT_W_M2 * ecc * cos_zenith


def erbs_diffuse_fraction(clearness_index: float) -> float:
    """Erbs et al. (1982) diffuse fraction of GHI
    (harmonie_radiation.py:512-525)."""
    kt = max(0.0, float(clearness_index))
    if kt <= 0.22:
        return 1.0 - 0.09 * kt
    if kt <= 0.80:
        return (0.9511 - 0.1604 * kt + 4.388 * kt ** 2
                - 16.638 * kt ** 3 + 12.336 * kt ** 4)
    return 0.165


def split_ghi_erbs(ghi: float, zenith_deg: float, when: datetime,
                   min_direct_cos_zenith: float = MIN_DIRECT_COS_ZENITH):
    """GHI -> (DNI, Dsky) in W/m^2 (harmonie_radiation.py:528-558).

    Near-horizontal sun (cos z < min_direct_cos_zenith, matching the ray
    tracer's skip threshold) treats all positive GHI as diffuse.  Energy
    closure (tested): dni * cos(z) + dsky == ghi whenever dni > 0.
    """
    ghi = max(0.0, float(ghi))
    if ghi <= 0.0:
        return 0.0, 0.0
    cos_zen = math.cos(math.radians(float(zenith_deg)))
    if zenith_deg >= 90.0 or cos_zen <= 0.0:
        return 0.0, 0.0
    if cos_zen < min_direct_cos_zenith:
        return 0.0, ghi
    i0h = extraterrestrial_horizontal_irradiance(when, cos_zen)
    if i0h <= 0.0:
        return 0.0, ghi
    fd = min(1.0, max(0.0, erbs_diffuse_fraction(ghi / i0h)))
    dsky = min(ghi, max(0.0, fd * ghi))
    dni = max(0.0, (ghi - dsky) / cos_zen)
    return dni, dsky


# ---------------------------------------------------------------------------
# atmosphere preparation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShortwaveAtmosphere:
    """Per-sample atmospheric shortwave forcing
    (harmonie_radiation.py:51-60).  `azimuth_local` is solver-frame
    (metereological azimuth minus xazimuth)."""
    times: np.ndarray
    ghi: np.ndarray
    dni: np.ndarray
    dsky: np.ndarray
    zenith: np.ndarray
    azimuth_local: np.ndarray


def shortwave_atmosphere(times, ghi, start: datetime, latitude: float,
                         longitude: float, timezone: float = 0.0,
                         xazimuth: float = 0.0) -> ShortwaveAtmosphere:
    """Solar geometry + Erbs split at each model time
    (harmonie_radiation.py:561-605), using this package's NOAA solar
    position (`prep.solar.solar_position`)."""
    times = np.asarray(times, np.float64)
    ghi = np.asarray(ghi, np.float64)
    dni = np.zeros_like(ghi)
    dsky = np.zeros_like(ghi)
    zen = np.zeros_like(ghi)
    azl = np.zeros_like(ghi)
    for i, t in enumerate(times):
        when = start + timedelta(seconds=float(t))
        z, a = solar_position(when, latitude, longitude, timezone)
        dni[i], dsky[i] = split_ghi_erbs(float(ghi[i]), z, when)
        zen[i] = z
        azl[i] = a - xazimuth
    return ShortwaveAtmosphere(times=times, ghi=ghi, dni=dni, dsky=dsky,
                               zenith=zen, azimuth_local=azl)


def harmonie_shortwave_atmosphere(offsets_seconds, accumulated_ssrd,
                                  start: datetime, runtime: float,
                                  dtSP: float, latitude: float,
                                  longitude: float, timezone: float = 0.0,
                                  xazimuth: float = 0.0,
                                  nt: int | None = None,
                                  start_offset_seconds: int | None = None):
    """ssrd accumulated series -> ShortwaveAtmosphere on model times
    (the no-I/O core of prepare_harmonie_ssrd_atmosphere,
    harmonie_radiation.py:608-674)."""
    native_t, native_ghi = accumulated_to_flux(
        offsets_seconds, accumulated_ssrd,
        start_offset_seconds=start_offset_seconds)
    times = make_model_times(runtime, dtSP, nt)
    if float(times[-1]) > float(native_t[-1]) + 1e-9:
        raise ValueError(
            f"model times reach {times[-1]:.0f} s but the HARMONIE series "
            f"ends at {native_t[-1]:.0f} s")
    ghi = interpolate_flux_to_times(native_t, native_ghi, times)
    return shortwave_atmosphere(times, ghi, start, latitude, longitude,
                                timezone, xazimuth)


def harmonie_longwave_series(offsets_seconds, accumulated_strd,
                             runtime: float, ntimedeplw: int,
                             start_offset_seconds: int | None = None):
    """strd accumulated series -> (times, LWsky W/m^2)
    (prepare_harmonie_strd_longwave, harmonie_radiation.py:675-744)."""
    native_t, native_lw = accumulated_to_flux(
        offsets_seconds, accumulated_strd,
        start_offset_seconds=start_offset_seconds)
    times = np.linspace(0.0, float(runtime), max(2, int(ntimedeplw)))
    return times, interpolate_flux_to_times(native_t, native_lw, times)


# ---------------------------------------------------------------------------
# facet mapping + writers
# ---------------------------------------------------------------------------

def map_atmosphere_to_facets(tris, normals, atmos: ShortwaveAtmosphere,
                             albedo=None, vf=None, svf=None, subdiv: int = 2):
    """Per-time facet shortwave through the shading/reflection machinery
    (harmonie_radiation.py:813-893).  With vf/svf the rows are absorbed
    netsw after inter-facet reflections; otherwise the non-scattering
    closure knet = (1-al)(sdir + dsky*fss) with fss = (1+nz)/2.

    Returns (sdir (nt, nfcts), knet (nt, nfcts))."""
    from .weather import shortwave_from_weather
    n = len(tris)
    nt = atmos.times.size
    alb = np.full(n, 0.3) if albedo is None else np.asarray(albedo, float)
    fss = (1.0 + np.asarray(normals, float)[:, 2]) * 0.5
    sdir_all = np.zeros((nt, n))
    knet_all = np.zeros((nt, n))
    for i in range(nt):
        state = dict(zenith=float(atmos.zenith[i]),
                     azimuth=float(atmos.azimuth_local[i]),
                     I=float(atmos.dni[i]), Dsky=float(atmos.dsky[i]))
        out = shortwave_from_weather(tris, normals, state, xazimuth=0.0,
                                     albedo=alb, vf=vf, svf=svf,
                                     subdiv=subdiv)
        sdir_all[i] = out["sdir"]
        if out["netsw"] is not None:
            knet_all[i] = out["netsw"]
        else:
            knet_all[i] = (1.0 - alb) * (out["sdir"]
                                         + float(atmos.dsky[i]) * fss)
    return sdir_all, knet_all


def write_timedepsw(path, times, knet, layout: str = "solver"):
    """timedepsw.inp writer.  layout='solver': this package's time-major
    rows ``t  netsw_1..netsw_nfcts`` (timedep.Timedep.load); 'reference':
    the transposed times-row + (nfcts x nt) block of
    harmonie_radiation.py:747-760."""
    path = Path(path)
    times = np.asarray(times, float)
    knet = np.asarray(knet, float)        # (nt, nfcts)
    with open(path, "w") as f:
        if layout == "reference":
            f.write("# time-dependent net shortwave on facets [W/m2]. "
                    "First line: times (1 x nt), then netsw (nfcts x nt)\n")
            np.savetxt(f, times[None, :], fmt="%9.2f")
            np.savetxt(f, knet.T, fmt="%9.4f")
        else:
            f.write("# time then net shortwave per facet [W/m2] "
                    "(HARMONIE ssrd)\n")
            for t, row in zip(times, knet):
                f.write(f"{t:12.2f} " + " ".join(f"{v:.4f}" for v in row)
                        + "\n")
    return path


def write_timedeplw(path, times, lwsky):
    """timedeplw.inp: header + ``t LWsky`` rows (consumed by
    timedep.Timedep.load; reference layout harmonie_radiation.py:779-790
    minus its second header line, which numpy-style readers reject)."""
    path = Path(path)
    with open(path, "w") as f:
        f.write("# time-varying sky longwave flux [W/m2] (HARMONIE strd)\n")
        for t, v in zip(np.asarray(times, float), np.asarray(lwsky, float)):
            f.write(f"{t:13.6f} {v:12.6f}\n")
    return path


def write_weather_table(path, atmos: ShortwaveAtmosphere, start: datetime):
    """Emit the measured-weather table schema (`date TIME SOLAR SOLAR_1
    HELIOM DIFSOLAR`) that `prep.weather.read_weather_table` /
    `weather_day_series` consume — a HARMONIE forecast can then drive the
    entire isolar=3 pathway unchanged.  SOLAR_1 is the meteorological
    azimuth (solver azimuth = SOLAR_1 + 90, weather.py:66)."""
    path = Path(path)
    with open(path, "w") as f:
        f.write("date TIME SOLAR SOLAR_1 HELIOM DIFSOLAR\n")
        for i, t in enumerate(np.asarray(atmos.times, float)):
            when = start + timedelta(seconds=float(t))
            date_val = int(when.strftime("%d%m%y"))
            tday = (when.hour * 3600 + when.minute * 60 + when.second)
            az_met = float(atmos.azimuth_local[i]) - 90.0
            f.write(f"{date_val} {tday} {atmos.zenith[i]:.4f} "
                    f"{az_met:.4f} {atmos.dni[i]:.4f} "
                    f"{atmos.dsky[i]:.4f}\n")
    return path


def generate_timedepsw_from_harmonie(tris, normals, offsets_seconds,
                                     accumulated_ssrd, start: datetime,
                                     runtime: float, dtSP: float,
                                     latitude: float, longitude: float,
                                     timezone: float = 0.0,
                                     xazimuth: float = 0.0, albedo=None,
                                     vf=None, svf=None, subdiv: int = 2,
                                     outpath=None, expnr: str | None = None,
                                     layout: str = "solver"):
    """End-to-end isolar=3-from-HARMONIE pathway
    (generate_timedepsw_from_harmonie, harmonie_radiation.py:894-998,
    minus the demo-data download): accumulated ssrd -> flux -> Erbs split
    -> facet shading/reflections -> timedepsw.inp.

    Returns (times, sdir (nt,nfcts), knet (nt,nfcts), atmosphere)."""
    atmos = harmonie_shortwave_atmosphere(
        offsets_seconds, accumulated_ssrd, start, runtime, dtSP,
        latitude, longitude, timezone, xazimuth)
    sdir, knet = map_atmosphere_to_facets(tris, normals, atmos, albedo,
                                          vf, svf, subdiv)
    if outpath is not None:
        p = Path(outpath)
        if p.is_dir():
            p = p / f"timedepsw.inp.{expnr or '000'}"
        write_timedepsw(p, atmos.times, knet, layout)
    return atmos.times, sdir, knet, atmos
