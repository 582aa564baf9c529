"""Small copies of the benchmark's configurations and cells for the CPU
tests: the same case with n cells along x, its domain, buildings and
air-quality placement scaled with it, the driven series shortened."""
from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def small_config(name: str | dict, n: int = 16) -> dict:
    """The configuration `name` (a file of ``configs/``, or a configuration
    itself) with n cells along x: every count and length of its domain,
    its buildings and its ``air`` block's rows (source positions and
    widths, tree boxes) scaled by n / itot, so that a cubic case stays
    cubic (and keeps its ``n``)."""
    cfg = copy.deepcopy(name if isinstance(name, dict) else json.loads(
        (HERE / "configs" / f"{name}.json").read_text()))
    name = cfg["name"]
    dom = cfg["namelist"]["DOMAIN"]
    scale = n / dom["itot"]

    def cells(count):
        assert (count * scale).is_integer(), (name, n, count)
        return int(count * scale)
    if "n" in cfg:
        cfg["n"] = n
    cfg["namelist"]["DOMAIN"] = dict(
        itot=n, jtot=cells(dom["jtot"]), ktot=cells(dom["ktot"]),
        xlen=dom["xlen"] * scale, ylen=dom["ylen"] * scale)
    cfg["namelist"].get("WALLS", {}).pop("nfcts", None)   # n-dependent
    g = cfg["geometry"]
    for key in ("box_m", "street_m"):
        g[key] = [v * scale for v in g[key]]
    g["h_m"] *= scale
    g["facet_edge_m"] *= scale
    if "air" in cfg:
        air = cfg["air"]
        # source rows: positions and sigma in m scale, SS stays; tree
        # boxes of cells (from 1, inclusive) keep the lengths they span
        for kind, last in (("lines", 6), ("points", 3)):
            for rows in air.get(kind, []):
                for r in rows:
                    r[:last] = [v * scale for v in r[:last]]
                    r[-1] *= scale
        span = lambda lo, hi: [round((lo - 1) * scale) + 1,
                               round(hi * scale)]
        air["trees"] = [span(il, iu) + span(jl, ju) + span(kl, ku) + [p]
                        for il, iu, jl, ju, kl, ku, p in air.get("trees", [])]
    if "driver" in cfg:
        cfg["driver"]["nt"] = 200
        cfg["namelist"]["DRIVER"]["driverstore"] = 200
    return cfg


def dispersion_config(n: int = 32) -> dict:
    """The test-local dispersion configuration
    (``tests/urban_cubes_dispersion.json``: Coceal's 2 x 2 cubes at 128^3
    with NO, NO2 and O3 from line sources and a stack, the chemistry and
    tree blocks) cut to n cells along x."""
    return small_config(json.loads((HERE / "tests"
                                    / "urban_cubes_dispersion.json")
                                   .read_text()), n)


def small_work(name: str, **changes) -> dict:
    work = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    work.update(changes)
    return work
