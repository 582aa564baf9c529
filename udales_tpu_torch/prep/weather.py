"""Measured-weather shortwave pathway (udprep isolar=3).

The reference drives EB preprocessing from a measured weather table
(`weatherfname`, tools/python/udprep/udprep_radiation.py:726-768 for the
time-dependent series and :1003-1015 for a single shot): columns hold the
observation date, seconds-of-day TIME, solar zenith (SOLAR), azimuth
(SOLAR_1, meteorological; the solver frame adds 90 deg), direct-beam
irradiance (HELIOM) and diffuse sky irradiance (DIFSOLAR).  This module
reads that table and feeds the same per-sample quantities into this
package's shading/reflection kernels, so EB cases driven by measured
weather can be prepared from scratch."""
from __future__ import annotations

from datetime import datetime
from pathlib import Path

import numpy as np

_MIN_SUN_VERTICAL = 1e-2


def read_weather_table(path: str | Path) -> dict:
    """Parse a whitespace- or comma-delimited weather table with a header
    row of column names (case preserved); returns dict of 1-D arrays."""
    path = Path(path)
    lines = [ln for ln in path.read_text().splitlines()
             if ln.strip() and not ln.strip().startswith("#")]
    if not lines:
        raise ValueError(f"weather file is empty: {path}")
    header = lines[0]
    delim = "," if "," in header else None
    names = [n.strip() for n in (header.split(",") if delim else
                                 header.split())]
    rows = []
    for ln in lines[1:]:
        parts = ln.split(",") if delim else ln.split()
        if len(parts) != len(names):
            continue
        rows.append([float(p) for p in parts])
    arr = np.asarray(rows, float)
    return {n: arr[:, i] for i, n in enumerate(names)}


def _nsun(zenith_deg: float, azimuth_solver_deg: float) -> np.ndarray:
    """Sun vector in the solver frame from weather-table angles
    (udprep solar.py nsun_from_angles convention)."""
    z = np.radians(zenith_deg)
    a = np.radians(azimuth_solver_deg)
    return np.array([np.sin(z) * np.cos(a), -np.sin(z) * np.sin(a),
                     np.cos(z)])


def weather_day_series(path: str | Path, start: datetime):
    """The day's (t, zenith, azimuth, I, Dsky) series rolled so index 0 is
    `start.hour` (the reference's np.roll(shift=-hour) alignment), plus a
    periodic-day interpolator for each quantity."""
    w = read_weather_table(path)
    date_val = int(start.strftime("%d%m%y"))
    rows = w["date"] == date_val
    if not np.any(rows):
        raise ValueError(f"No weather data for date {date_val} in {path}")
    t = w["TIME"][rows] if "TIME" in w else w["time"][rows]
    shift = -start.hour
    series = {
        "zenith": np.roll(w["SOLAR"][rows], shift),
        "azimuth": np.roll(w["SOLAR_1"][rows] + 90.0, shift),
        "I": np.roll(w["HELIOM"][rows], shift),
        "Dsky": np.roll(w["DIFSOLAR"][rows], shift),
    }
    x = np.concatenate([t, [86400.0]])

    def interp(y):
        yy = np.concatenate([y, [y[0]]])
        try:  # the reference interpolates with makima
            from scipy.interpolate import Akima1DInterpolator
            return Akima1DInterpolator(x, yy, method="makima")
        except Exception:
            return lambda q: np.interp(q, x, yy)
    return t, series, {k: interp(v) for k, v in series.items()}


def weather_single_shot(path: str | Path, when: datetime) -> dict:
    """Exact-row lookup for one (date, hour) — the isolar=3 netsw.inp
    single-shot pathway (udprep_radiation.py:1003)."""
    w = read_weather_table(path)
    date_val = int(when.strftime("%d%m%y"))
    t = w["TIME"] if "TIME" in w else w["time"]
    rows = (w["date"] == date_val) & (t == when.hour * 3600)
    if not np.any(rows):
        raise ValueError(f"No weather data for {when} in {path}")
    i = int(np.flatnonzero(rows)[0])
    return dict(zenith=float(w["SOLAR"][i]),
                azimuth=float(w["SOLAR_1"][i]) + 90.0,
                I=float(w["HELIOM"][i]), Dsky=float(w["DIFSOLAR"][i]))


def shortwave_from_weather(tris, normals, state: dict, xazimuth: float = 0.0,
                           albedo=None, vf=None, svf=None, subdiv: int = 2):
    """Shaded direct beam + reflective closure for one weather sample.
    Returns dict(sdir, netsw) — netsw None without vf/svf."""
    from .radiation import direct_shortwave
    from .solar import net_shortwave_reflected
    n = len(tris)
    zen, I = state["zenith"], state["I"]
    if not (zen < 90.0 and I > 0.0
            and abs(np.cos(np.radians(zen))) >= _MIN_SUN_VERTICAL):
        sdir = np.zeros(n)
    else:
        nsun = _nsun(zen, state["azimuth"] - xazimuth)
        try:
            from . import native
            native.get_radiation_lib()
            sdir = native.direct_shortwave(tris, normals, nsun, I,
                                           subdiv=subdiv)
        except Exception:
            sdir = direct_shortwave(tris, normals, nsun, I, subdiv=subdiv)
    netsw = None
    if vf is not None and svf is not None:
        alb = np.full(n, 0.3) if albedo is None else np.asarray(albedo)
        netsw = net_shortwave_reflected(sdir, state["Dsky"], vf, svf, alb)
    return dict(sdir=sdir, netsw=netsw)


def generate_timedepsw_weather(tris, normals, weather_path, start: datetime,
                               runtime: float, dtSP: float,
                               xazimuth: float = 0.0, albedo=None, vf=None,
                               svf=None, subdiv: int = 2, outpath=None,
                               expnr: str | None = None):
    """timedepsw.inp rows from a measured weather series (the isolar=3
    equivalent of solar.generate_timedepsw).  Returns (t, netsw table)."""
    _, _, interps = weather_day_series(weather_path, start)
    times = np.arange(0.0, runtime + 0.5 * dtSP, dtSP)
    rows = []
    for tsec in times:
        tday = (start.minute * 60 + start.second + float(tsec)) % 86400.0
        state = {k: float(f(tday)) for k, f in interps.items()}
        out = shortwave_from_weather(tris, normals, state, xazimuth,
                                     albedo, vf, svf, subdiv)
        rows.append(out["netsw"] if out["netsw"] is not None
                    else out["sdir"])
    table = np.stack(rows)
    if outpath is not None:
        p = Path(outpath)
        p = p / f"timedepsw.inp.{expnr or '000'}" if p.is_dir() else p
        with open(p, "w") as f:
            f.write("# time then net shortwave per facet [W/m2]\n")
            for tsec, row in zip(times, table):
                f.write(f"{tsec:12.2f} "
                        + " ".join(f"{v:.3f}" for v in row) + "\n")
    return times, table
