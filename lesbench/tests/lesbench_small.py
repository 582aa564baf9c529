"""Small copies of the benchmark's configurations and cells for the CPU
tests: the same case at n^3 cells (its buildings scaled with it), the
driven series shortened."""
from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def small_config(name: str, n: int = 16) -> dict:
    cfg = copy.deepcopy(json.loads((HERE / "configs" / f"{name}.json")
                                   .read_text()))
    cfg["n"] = n
    cfg["namelist"]["DOMAIN"] = dict(itot=n, jtot=n, ktot=n, xlen=float(n),
                                     ylen=float(n))
    cfg["namelist"].get("WALLS", {}).pop("nfcts", None)   # n-dependent
    g = cfg["geometry"]
    scale = n / cfg_n(name)
    for key in ("box_m", "street_m"):
        g[key] = [v * scale for v in g[key]]
    g["h_m"] *= scale
    g["facet_edge_m"] *= scale
    if "driver" in cfg:
        cfg["driver"]["nt"] = 200
        cfg["namelist"]["DRIVER"]["driverstore"] = 200
    return cfg


def cfg_n(name: str) -> int:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())["n"]


def small_work(name: str, **changes) -> dict:
    work = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    work.update(changes)
    return work
