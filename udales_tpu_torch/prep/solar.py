"""Solar position, clear-sky irradiance, and net-shortwave assembly.

Replaces tools/python/udprep/solar.py (NREL-SPA port, ~1200 LoC) and the
netsw chain of udprep_radiation/_radiation_compute for generating
``netsw.inp``/``Sdir.txt``/``timedepsw`` inputs from scratch.

This is an INDEPENDENT implementation: solar geometry uses the standard
NOAA "General Solar Position Calculations" (Meeus-based low-precision
formulas, accuracy ~0.1 deg — ample for facet irradiation), not a port of
the reference's SPA.  The reference's own SPA is used as a test oracle
(tests/test_solar.py).  ASHRAE clear-sky coefficients are the published
handbook table (physical constants, also used by tools/SEB/ASHRAE.m).

Conventions (matching udprep): zenith from vertical, azimuth clockwise
from north; the sun direction vector in LOCAL grid coordinates is
``nsun = [sin z cos a_l, -sin z sin a_l, cos z]`` with
``a_l = azimuth - xazimuth`` (solar.py nsun_from_angles semantics).
"""
from __future__ import annotations

import math
from datetime import datetime, timedelta

import numpy as np

# ASHRAE clear-sky coefficients per month: (A: apparent extraterrestrial
# irradiance W/m^2, B: atmospheric extinction, C: diffuse ratio) — ASHRAE
# Handbook of Fundamentals table (same constants as tools/SEB/ASHRAE.m).
_ASHRAE_ABC = {
    1: (1230.0, 0.142, 0.058), 2: (1215.0, 0.144, 0.060),
    3: (1186.0, 0.156, 0.071), 4: (1136.0, 0.180, 0.097),
    5: (1104.0, 0.196, 0.121), 6: (1088.0, 0.205, 0.134),
    7: (1085.0, 0.207, 0.136), 8: (1107.0, 0.201, 0.122),
    9: (1151.0, 0.177, 0.092), 10: (1192.0, 0.160, 0.073),
    11: (1221.0, 0.149, 0.063), 12: (1234.0, 0.142, 0.057),
}


def solar_position(when: datetime, latitude: float, longitude: float,
                   timezone: float = 0.0):
    """Solar (zenith, azimuth) in degrees; azimuth clockwise from north.

    NOAA low-precision algorithm: fractional year -> equation of time +
    declination Fourier series -> true solar time -> hour angle ->
    spherical triangle."""
    doy = when.timetuple().tm_yday
    hours = when.hour + when.minute / 60.0 + when.second / 3600.0
    g = 2.0 * math.pi / 365.0 * (doy - 1 + (hours - 12.0) / 24.0)
    eqtime = 229.18 * (0.000075 + 0.001868 * math.cos(g)
                       - 0.032077 * math.sin(g)
                       - 0.014615 * math.cos(2 * g)
                       - 0.040849 * math.sin(2 * g))
    decl = (0.006918 - 0.399912 * math.cos(g) + 0.070257 * math.sin(g)
            - 0.006758 * math.cos(2 * g) + 0.000907 * math.sin(2 * g)
            - 0.002697 * math.cos(3 * g) + 0.00148 * math.sin(3 * g))
    time_offset = eqtime + 4.0 * longitude - 60.0 * timezone
    tst = hours * 60.0 + time_offset
    ha = math.radians(tst / 4.0 - 180.0)
    lat = math.radians(latitude)
    cos_zen = (math.sin(lat) * math.sin(decl)
               + math.cos(lat) * math.cos(decl) * math.cos(ha))
    zen = math.degrees(math.acos(max(-1.0, min(1.0, cos_zen))))
    az = math.degrees(math.atan2(
        math.sin(ha),
        math.cos(ha) * math.sin(lat) - math.tan(decl) * math.cos(lat)))
    az = (az + 180.0) % 360.0
    return zen, az


def solar_strength_ashrae(month: int, zenith_deg: float):
    """ASHRAE clear-sky direct-normal + diffuse-sky irradiance [W/m^2]."""
    a, b, c = _ASHRAE_ABC[month]
    cz = math.cos(math.radians(zenith_deg))
    if cz <= 0.0:
        return 0.0, 0.0
    direct = a * math.exp(-b / cz)
    return direct, c * direct


def nsun_from_angles(zenith_deg: float, azimuth_deg: float) -> np.ndarray:
    """Sun direction in local grid coordinates (udprep convention: +x at
    azimuth, -y at azimuth+90)."""
    z = math.radians(zenith_deg)
    a = math.radians(azimuth_deg)
    return np.array([math.sin(z) * math.cos(a),
                     -math.sin(z) * math.sin(a), math.cos(z)])


def solar_state(when: datetime, latitude: float, longitude: float,
                timezone: float = 0.0, xazimuth: float = 0.0):
    """(nsun, zenith, local azimuth, I, Dsky) for a date/time/site —
    the isolar=2 pathway of udprep (solar position + ASHRAE strength)."""
    zen, az = solar_position(when, latitude, longitude, timezone)
    az_local = az - xazimuth
    I, dsky = solar_strength_ashrae(when.month, zen)
    return nsun_from_angles(zen, az_local), zen, az_local, I, dsky


def net_shortwave_reflected(sdir, dsky, vf, svf, albedo, tol: float = 0.01,
                            max_iter: int = 200):
    """Absorbed shortwave per facet including inter-facet reflections
    (tools/SEB/netShortwave.m semantics): seed each facet with
    direct + svf-weighted diffuse, then bounce the reflected fraction
    through the view-factor matrix until the added absorption is < tol."""
    sdir = np.asarray(sdir, float)
    albedo = np.asarray(albedo, float)
    kin = sdir + dsky * np.asarray(svf, float)
    knet = (1.0 - albedo) * kin
    kout = albedo * kin
    for _ in range(max_iter):
        kin = vf @ kout
        kadd = (1.0 - albedo) * kin
        kout = albedo * kin
        knet = knet + kadd
        if kadd.max() < tol * max(knet.max(), 1e-12):
            break
    return knet


def generate_timedepsw(tris, normals, start: datetime, runtime: float,
                       dtSP: float, latitude: float, longitude: float,
                       timezone: float = 0.0, xazimuth: float = 0.0,
                       albedo=None, vf=None, svf=None, subdiv: int = 2,
                       outpath=None, expnr: str | None = None):
    """Time-dependent facet net shortwave (udprep
    run_short_wave_timedep -> timedepsw.inp, consumed by
    modtimedep.f90:425 timedepsw): the solar state is advanced every
    `dtSP` seconds over `runtime` from `start`, and each sample's shaded
    direct beam + diffuse/reflection closure is written as one row
    ``t  netsw_1..netsw_nfcts``.

    Returns (t_seconds (nt,), netsw (nt, nfcts))."""
    times = np.arange(0.0, runtime + 0.5 * dtSP, dtSP)
    rows = []
    for tsec in times:
        when = start + timedelta(seconds=float(tsec))
        out = generate_shortwave(tris, normals, when, latitude, longitude,
                                 timezone, xazimuth, albedo=albedo, vf=vf,
                                 svf=svf, subdiv=subdiv)
        nsw = out["netsw"]
        if nsw is None:
            nsw = out["sdir"]
        rows.append(np.asarray(nsw))
    table = np.stack(rows)
    if outpath is not None:
        exp = expnr or "000"
        from pathlib import Path
        p = Path(outpath)
        p = p / f"timedepsw.inp.{exp}" if p.is_dir() else p
        with open(p, "w") as f:
            f.write("# time then net shortwave per facet [W/m2]\n")
            for tsec, row in zip(times, table):
                f.write(f"{tsec:12.2f} "
                        + " ".join(f"{v:.3f}" for v in row) + "\n")
    return times, table


def generate_shortwave(tris, normals, when: datetime, latitude: float,
                       longitude: float, timezone: float = 0.0,
                       xazimuth: float = 0.0, albedo=None, vf=None,
                       svf=None, subdiv: int = 2):
    """Full from-scratch shortwave preprocessing for an EB case: solar
    state from date/site, shaded direct beam, and (when vf/svf given)
    reflective netsw — the outputs written as Sdir.txt / netsw.inp.

    Returns dict(sdir, netsw, zenith, azimuth, I, Dsky)."""
    from .radiation import direct_shortwave
    nsun, zen, az_local, I, dsky = solar_state(
        when, latitude, longitude, timezone, xazimuth)
    if I <= 0.0:
        sdir = np.zeros(len(tris))
    else:
        try:
            from . import native
            native.get_radiation_lib()
            sdir = native.direct_shortwave(tris, normals, nsun, I,
                                           subdiv=subdiv)
        except Exception:
            sdir = direct_shortwave(tris, normals, nsun, I, subdiv=subdiv)
    netsw = None
    if albedo is not None and svf is not None:
        if vf is not None:
            netsw = net_shortwave_reflected(sdir, dsky, vf, svf, albedo)
        else:
            netsw = (1.0 - np.asarray(albedo)) * (sdir + dsky
                                                  * np.asarray(svf))
    return dict(sdir=sdir, netsw=netsw, zenith=zen, azimuth=az_local,
                I=I, Dsky=dsky)
