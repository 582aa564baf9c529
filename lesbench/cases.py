"""The benchmark's case directories, staged from its configuration files
with the frozen staging in ``reference/les/cases.py`` (never the
program's), once per checkout, into ``.lesbench_cache/`` at the checkout's
root.

A case is staged into a directory of its own process and renamed into
place when it is whole, so that a first run cut short leaves no
half-staged case behind for the next run to load.
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


def _stage_into(cfg: dict, root: Path) -> Path:
    """Stage the configuration's case under `root`; returns its directory."""
    n = cfg["n"]
    if cfg["case"] == "urban":
        return frozen.stage_urban(n, root, layout(cfg))
    if cfg["case"] == "urban_driven":
        d = cfg["driver"]
        return frozen.stage_urban_driven(n, root, nt=d["nt"],
                                         chunk=d["chunk"],
                                         dtdriver=d["dtdriver"],
                                         layout=layout(cfg))
    raise ValueError(f"configuration {cfg['name']}: no staged case of kind "
                     f"{cfg['case']!r}")


def case_dir(cfg: dict, cache: Path = CACHE) -> Path:
    """The staged case directory of a configuration (staged now unless a
    whole one is in `cache`), checked against the file's namelist.  Its
    name carries a hash of the configuration, so that another size or
    series never finds a case staged for the old one."""
    key = hashlib.sha1(json.dumps(cfg, sort_keys=True).encode())
    final = cache / f"{cfg['name']}-{key.hexdigest()[:12]}"
    if not final.exists():
        tmp = cache / f".{final.name}.partial.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        try:
            staged = _stage_into(cfg, tmp)
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


def solid_cells(cfg: dict) -> set:
    """The (i, j, k) cells, from 1, whose centres lie inside a building of
    the configuration's ``geometry``: an aligned array of ``cubes``
    boxes ``box_m`` along streets ``street_m``, the first box a half
    street in from the domain's corner, on 1 m cells."""
    g = cfg["geometry"]
    (hx, hy, hz), (cx, cy) = g["box_m"], g["street_m"]
    cell = g["cell_m"]
    span = lambda lo, hi: range(int(round(lo / cell)) + 1,
                                int(round(hi / cell)) + 1)
    out = set()
    for a in range(g["cubes"][0]):
        x0 = cx / 2 + a * (hx + cx)
        for b in range(g["cubes"][1]):
            y0 = cy / 2 + b * (hy + cy)
            out.update((i, j, k) for i in span(x0, x0 + hx)
                       for j in span(y0, y0 + hy) for k in span(0, hz))
    return out


def check_geometry(cfg: dict, case: Path) -> None:
    """Raise unless the staged case's solid cells (``solid_c.txt``) are
    exactly the buildings the configuration's ``geometry`` states."""
    rows = np.loadtxt(case / "solid_c.txt", skiprows=1, dtype=np.int64,
                      ndmin=2)
    staged = set(map(tuple, rows.tolist()))
    want = solid_cells(cfg)
    if staged != want:
        raise ValueError(f"{case}: {len(staged)} solid cells staged, the "
                         f"configuration {cfg['name']}'s geometry has "
                         f"{len(want)} ({len(staged ^ want)} differ)")


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
