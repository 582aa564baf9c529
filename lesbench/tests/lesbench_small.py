"""Small copies of the benchmark's configurations and cells for the CPU
tests: the same case with n cells along x, its domain and buildings scaled
with it, the driven series shortened."""
from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def small_config(name: str, n: int = 16) -> dict:
    """The configuration `name` with n cells along x: every count and
    length of its domain and buildings scaled by n / itot, so that a
    cubic case stays cubic (and keeps its ``n``)."""
    cfg = copy.deepcopy(json.loads((HERE / "configs" / f"{name}.json")
                                   .read_text()))
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
    if "driver" in cfg:
        cfg["driver"]["nt"] = 200
        cfg["namelist"]["DRIVER"]["driverstore"] = 200
    return cfg


def small_work(name: str, **changes) -> dict:
    work = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    work.update(changes)
    return work
