"""Readers for the reference ASCII input files (Appendix A.1 of SURVEY.md);
the port's own copy of ``udales_tpu/io/inputs.py`` (NumPy only).

Formats follow src/modstartup.f90 (prof.inp :1008+, lscale.inp :2050-2097,
scalar.inp) and src/readinput.f90 (sparse i,j,k point lists).
All loaders return NumPy arrays; the solver converts on device placement.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


def read_prof_inp(path: str | Path, ktot: int):
    """prof.inp: 2 header lines, columns z thl qt u v e12
    (modstartup.f90:1110-1130)."""
    d = np.loadtxt(path, skiprows=2)
    assert d.shape[0] >= ktot, f"prof.inp has {d.shape[0]} rows < ktot={ktot}"
    d = d[:ktot]
    return dict(zf=d[:, 0], thl=d[:, 1], qt=d[:, 2], u=d[:, 3], v=d[:, 4],
                e12=d[:, 5])


def read_lscale_inp(path: str | Path, ktot: int):
    """lscale.inp: columns z ug vg pgx pgy wfls dqtdxls dqtdyls dqtdtls dthlrad
    (modstartup.f90:2056-2068)."""
    d = np.loadtxt(path, skiprows=2)[:ktot]
    return dict(z=d[:, 0], ug=d[:, 1], vg=d[:, 2], pgx=d[:, 3], pgy=d[:, 4],
                wfls=d[:, 5], dqtdx=d[:, 6], dqtdy=d[:, 7], dqtdt=d[:, 8],
                thlpcar=d[:, 9])


def read_scalar_inp(path: str | Path, ktot: int, nsv: int):
    """scalar.inp: z sca1..scaN."""
    d = np.loadtxt(path, skiprows=2)[:ktot]
    return d[:, 1:1 + nsv].T.copy()   # (nsv, ktot)


def large_scale_pressure_gradient(ls: dict, cfg) -> tuple[np.ndarray, np.ndarray]:
    """dpdxl/dpdyl profiles (modstartup.f90:2105-2119)."""
    import math
    phi = cfg.physics.xlat * math.pi / 180.0
    om23_gs = 2.0 * 7.292e-5 * math.sin(phi)
    dpdx = cfg.physics.dpdx
    if cfg.physics.lprofforc:
        dpdxl = -ls["pgx"] - dpdx
        dpdyl = -ls["pgy"]
    else:
        dpdxl = om23_gs * ls["vg"] - ls["pgx"] - dpdx
        dpdyl = -om23_gs * ls["ug"] - ls["pgy"]
    return dpdxl, dpdyl


def read_sparse_ijk(path: str | Path, n_expected: int | None = None):
    """Sparse global (i,j,k) point list, 1 header line, 1-based Fortran indices
    (src/readinput.f90:31-117). Returns 0-based (n,3) int array."""
    pts = np.loadtxt(path, skiprows=1, dtype=np.int64, ndmin=2)
    if pts.size == 0:
        return np.zeros((0, 3), np.int64)
    if n_expected is not None and len(pts) != n_expected:
        raise ValueError(f"{path}: expected {n_expected} points, got {len(pts)}")
    return pts - 1


def read_facet_sections(path: str | Path):
    """facet_sections_*.txt: header '# facet area flux point distance';
    rows `facetid area bndptid dist` (modibm.f90:350-357).
    Returns (facet_ids0, areas, bndpt_ids0, distances)."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # empty section files are valid
        d = np.loadtxt(path, skiprows=1, ndmin=2)
    if d.size == 0:
        return (np.zeros(0, np.int64), np.zeros(0), np.zeros(0, np.int64),
                np.zeros(0))
    return (d[:, 0].astype(np.int64) - 1, d[:, 1],
            d[:, 2].astype(np.int64) - 1, d[:, 3])


def read_facets_inp(path: str | Path):
    """facets.inp: header, rows `walltype nx ny nz` (initfac.f90:207+)."""
    d = np.loadtxt(path, skiprows=1, ndmin=2)
    return d[:, 0].astype(np.int64), d[:, 1:4]


def read_column_file(path: str | Path, skiprows: int = 1):
    """Generic one-value-per-line facet file (facetarea.inp, svf.inp, ...)."""
    return np.loadtxt(path, skiprows=skiprows)


@dataclass
class CaseInputs:
    """All per-experiment inputs for a reference case directory."""
    prof: dict
    lscale: dict
    scalar: np.ndarray | None

    @classmethod
    def load(cls, case_dir: str | Path, expnr: str, ktot: int, nsv: int = 0):
        case_dir = Path(case_dir)
        prof = read_prof_inp(case_dir / f"prof.inp.{expnr}", ktot)
        lscale = read_lscale_inp(case_dir / f"lscale.inp.{expnr}", ktot)
        scalar = None
        sp = case_dir / f"scalar.inp.{expnr}"
        if nsv > 0 and sp.exists():
            scalar = read_scalar_inp(sp, ktot, nsv)
        return cls(prof=prof, lscale=lscale, scalar=scalar)
