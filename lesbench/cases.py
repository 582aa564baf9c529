"""The benchmark's case directories, staged from its configuration files
with the frozen staging in ``reference/les/cases.py`` (never the
program's), once per checkout, into ``.lesbench_cache/`` at the checkout's
root.

A case is staged into a directory of its own process and renamed into
place when it is whole, so that a first run cut short leaves no
half-staged case behind for the next run to load.

A configuration's domain is its namelist's ``&DOMAIN`` (``itot``,
``jtot``, ``ktot``, ``xlen``, ``ylen``) on cells of ``geometry.cell_m``,
``ktot`` of them high; a cubic configuration may also state it as ``n``,
which then has to agree.

A configuration's ``case`` is the kind of case it stages: ``urban`` (the
building array), ``urban_driven`` (the same behind a driver inlet, from
its ``driver`` block) or ``urban_dispersion`` (the same with the scalars,
source rows, tree boxes and tree parameters of its ``air`` block, written
as they are, and its namelist's ``SCALARS``, ``CHEMISTRY`` and ``TREES``
groups; see ``reference.les.cases.stage_urban_dispersion``).  Trees are not solid:
the geometry check sees the buildings alone.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np

from .reference.les import cases as frozen
from .reference.les.config import parse_namelists

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".lesbench_cache"


def layout(cfg: dict) -> frozen.Layout:
    """The building array of a configuration's ``geometry``, in m."""
    g = cfg["geometry"]
    return frozen.Layout(*g["box_m"], *g["street_m"], g["facet_edge_m"])


def domain(cfg: dict) -> frozen.Domain:
    """The configuration's domain (see the module's docstring); raises
    where its ``n`` disagrees with ``&DOMAIN``, or where ``&DOMAIN``'s
    lengths are not its cells of ``cell_m``."""
    d, cell = cfg["namelist"]["DOMAIN"], cfg["geometry"]["cell_m"]
    dom = frozen.Domain(int(d["itot"]), int(d["jtot"]), int(d["ktot"]),
                        float(d["xlen"]), float(d["ylen"]),
                        float(d["ktot"] * cell))
    if "n" in cfg and (dom.itot, dom.jtot, dom.ktot) != (cfg["n"],) * 3:
        raise ValueError(f"configuration {cfg['name']}: n = {cfg['n']}, "
                         f"its &DOMAIN states {dom.itot} x {dom.jtot} x "
                         f"{dom.ktot}")
    if (dom.xlen, dom.ylen) != (dom.itot * cell, dom.jtot * cell):
        raise ValueError(f"configuration {cfg['name']}: &DOMAIN xlen, ylen "
                         f"= {dom.xlen}, {dom.ylen} m are not its "
                         f"{dom.itot} x {dom.jtot} cells of {cell} m")
    return dom


def _stage_into(cfg: dict, dom: frozen.Domain, root: Path) -> Path:
    """Stage the configuration's case over its domain `dom` under `root`;
    returns its directory."""
    if cfg["case"] == "urban":
        return frozen.stage_urban(dom, root, layout(cfg))
    if cfg["case"] == "urban_driven":
        d = cfg["driver"]
        return frozen.stage_urban_driven(dom, root, nt=d["nt"],
                                         chunk=d["chunk"],
                                         dtdriver=d["dtdriver"],
                                         layout=layout(cfg))
    if cfg["case"] == "urban_dispersion":
        groups = {g: v for g, v in cfg["namelist"].items()
                  if g in frozen.AIR_GROUPS}
        return frozen.stage_urban_dispersion(dom, root, layout(cfg),
                                             cfg["air"], groups)
    raise ValueError(f"configuration {cfg['name']}: no staged case of kind "
                     f"{cfg['case']!r}")


def case_name(cfg: dict) -> str:
    """The name of a configuration's case directory: its name and a hash
    of the whole configuration, so that another size or series never
    finds a case staged for the old one."""
    key = hashlib.sha1(json.dumps(cfg, sort_keys=True).encode())
    return f"{cfg['name']}-{key.hexdigest()[:12]}"


def case_dir(cfg: dict, cache: Path = CACHE) -> Path:
    """The staged case directory of a configuration (staged now unless a
    whole one is in `cache`; named by `case_name`), checked against the
    file's namelist and geometry."""
    dom = domain(cfg)
    final = cache / case_name(cfg)
    if not final.exists():
        tmp = cache / f".{final.name}.partial.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        try:
            staged = _stage_into(cfg, dom, tmp)
            try:
                os.rename(staged, final)
            except OSError:
                if not final.exists():      # not another process's
                    raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    check_namelist(cfg, final / "namoptions.900")
    check_geometry(cfg, final)
    return final


def solid_cells(cfg: dict) -> np.ndarray:
    """The (i, j, k) cells, from 1, whose centres lie inside a building of
    the configuration's ``geometry``, as rows of an array: an aligned
    array of ``cubes`` boxes ``box_m`` along streets ``street_m``, the
    first box a half street in from the domain's corner, on cells of
    ``cell_m``."""
    g = cfg["geometry"]
    (hx, hy, hz), (cx, cy) = g["box_m"], g["street_m"]
    cell = g["cell_m"]
    span = lambda lo, hi: np.arange(int(round(lo / cell)) + 1,
                                    int(round(hi / cell)) + 1)
    boxes = []
    for a in range(g["cubes"][0]):
        x0 = cx / 2 + a * (hx + cx)
        for b in range(g["cubes"][1]):
            y0 = cy / 2 + b * (hy + cy)
            ijk = np.meshgrid(span(x0, x0 + hx), span(y0, y0 + hy),
                              span(0, hz), indexing="ij")
            boxes.append(np.stack([c.ravel() for c in ijk], axis=1))
    return np.concatenate(boxes)


def _cell_keys(rows: np.ndarray) -> np.ndarray:
    """The distinct cells of (i, j, k) rows (each under 2**21), as sorted
    integer keys."""
    rows = rows.astype(np.int64).reshape(-1, 3)
    return np.unique((rows[:, 0] << 42) | (rows[:, 1] << 21) | rows[:, 2])


def check_geometry(cfg: dict, case: Path) -> None:
    """Raise unless the staged case's solid cells (``solid_c.txt``) are
    exactly the buildings the configuration's ``geometry`` states."""
    staged = _cell_keys(np.loadtxt(case / "solid_c.txt", skiprows=1,
                                   dtype=np.int64, ndmin=2))
    want = _cell_keys(solid_cells(cfg))
    if not np.array_equal(staged, want):
        differ = np.setxor1d(staged, want, assume_unique=True).size
        raise ValueError(f"{case}: {staged.size} solid cells staged, the "
                         f"configuration {cfg['name']}'s geometry has "
                         f"{want.size} ({differ} differ)")


def check_namelist(cfg: dict, path: Path) -> None:
    """Raise unless every namelist value of the configuration file is the
    staged case's."""
    staged = parse_namelists(path.read_text())
    for group, values in cfg["namelist"].items():
        for key, want in values.items():
            got = staged.get(group, {}).get(key.lower())
            if isinstance(got, tuple):
                got = got[0]
            if got is None or (float(got) != float(want)
                               if not isinstance(want, bool)
                               else bool(got) != want):
                raise ValueError(f"{path}: &{group} {key} = {got!r}, the "
                                 f"configuration {cfg['name']} states "
                                 f"{want!r}")
