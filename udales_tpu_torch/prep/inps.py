"""&INPS-driven case preprocessing (the port's own copy of
``udales_tpu/prep/inps.py``; NumPy only).

The reference's udprep is configured from the case's own namoptions file:
every preprocessing parameter lives in the ``&INPS`` group (plus the solver
groups &DOMAIN/&SCALARS it shares), see tools/python/udprep/udprep.py:44
(Section specs) and tools/python/udprep/defaults.json for the field
inventory.  This module maps that group onto :class:`PrepConfig` so a
shipped reference case can be regenerated end-to-end from its
``namoptions.<expnr>`` + STL alone (``prepare_from_case``; the
port has no command-line entry for it yet).
"""
from __future__ import annotations

from dataclasses import replace
from pathlib import Path

from ..config import parse_namelists
from .prep import PrepConfig


def _get(groups: dict, gname: str, key: str, default=None):
    return groups.get(gname, {}).get(key.lower(), default)


def prep_config_from_namoptions(nam_path: str | Path):
    """Build (PrepConfig, stl_name, extras) from a namoptions file.

    `extras` carries preprocessing inputs PrepConfig does not model as
    scalars (line/point scalar sources, z-stretching flags).  Field names
    follow tools/python/udprep/defaults.json.
    """
    nam_path = Path(nam_path)
    g = parse_namelists(nam_path.read_text())
    inps = g.get("INPS", {})
    if not inps:
        raise ValueError(f"{nam_path} has no &INPS group — nothing to "
                         "preprocess (the reference udprep requires it too)")
    expnr = str(_get(g, "RUN", "iexpnr", nam_path.suffix[1:]))

    cfg = PrepConfig(
        itot=int(_get(g, "DOMAIN", "itot", 64)),
        jtot=int(_get(g, "DOMAIN", "jtot", 64)),
        ktot=int(_get(g, "DOMAIN", "ktot", 64)),
        xlen=float(_get(g, "DOMAIN", "xlen", 64.0)),
        ylen=float(_get(g, "DOMAIN", "ylen", 64.0)),
        zsize=float(inps.get("zsize", _get(g, "DOMAIN", "ktot", 64))),
        expnr=expnr,
    )
    scalar_map = dict(
        u0="u0", v0="v0", thl0="thl0", qt0="qt0", tke="e12", lapse="lapse", dpdx="dpdx",
        fact="facT0", dpdy="dpdy", w_s="w_s", r="R", dqtdxls="dqtdxls",
        dqtdyls="dqtdyls", dqtdtls="dqtdtls",
        solarazimuth="azimuth_deg", solarzenith="zenith_deg",
        i="I_dir", dsky="D_diff", albedo="albedo",
        latitude="latitude", longitude="longitude", timezone="timezone",
        xazimuth="xazimuth",
    )
    updates = {}
    for nml_key, field in scalar_map.items():
        if nml_key in inps:
            updates[field] = float(inps[nml_key])
    for flag in ("stl_ground", "diag_neighbs"):   # default true (udprep)
        if flag in inps:
            updates[flag] = bool(inps[flag])
    # udprep defaults differ from PrepConfig's standalone defaults
    # (tools/python/udprep/defaults.json: tke=0, u0=0, thl0=288, facT=288)
    updates.setdefault("e12", 0.0)
    updates.setdefault("u0", 0.0)
    updates.setdefault("thl0", 288.0)
    updates.setdefault("facT0", 288.0)
    # radiation pathway: &EB lEB or &INPS isolar/lEB turn it on
    leb = bool(inps.get("leb", _get(g, "ENERGYBALANCE", "leb", False)))
    isolar = int(inps.get("isolar", 1))
    if leb:
        updates["with_radiation"] = True
        if isolar == 2 and all(k in inps for k in
                               ("year", "month", "day", "hour")):
            updates["solar_datetime"] = (
                f"{int(inps['year']):04d}-{int(inps['month']):02d}-"
                f"{int(inps['day']):02d}T{int(inps['hour']):02d}:"
                f"{int(inps.get('minute', 0)):02d}:"
                f"{int(inps.get('second', 0)):02d}")
        elif isolar == 3:
            updates["weather_file"] = str(
                inps.get("weatherfname", "weather.txt"))
    if bool(inps.get("lfactlyrs", _get(g, "ENERGYBALANCE", "lfactlyrs",
                                        False))):
        updates["lfacTlyrs"] = True
        if inps.get("fact_file"):
            fp = Path(str(inps["fact_file"]))
            updates["facT_file"] = str(fp if fp.is_absolute()
                                       else nam_path.parent / fp)
    if "nfaclyrs" in inps:
        updates["nfaclyrs"] = int(inps["nfaclyrs"])
    for flag in ("lprofforc", "lcoriol"):
        if bool(inps.get(flag, False)):
            updates[flag] = True
    ph = g.get("PHYSICS", {})
    updates["has_flow_forcing"] = any(
        bool(inps.get(k, ph.get(k, False)))
        for k in ("luoutflowr", "lvoutflowr", "luvolflowr", "lvvolflowr",
                  "lnudge"))
    if bool(inps.get("read_types", False)) and inps.get("types_path"):
        tp = Path(str(inps["types_path"]))
        updates["types_file"] = str(tp if tp.is_absolute()
                                    else nam_path.parent / tp)
    if bool(inps.get("lzstretch", False)):
        updates["lzstretch"] = True
        for flag, meth in (("lstretchexp", "exp"),
                           ("lstretchexpcheck", "expcheck"),
                           ("lstretchtanh", "tanh"),
                           ("lstretch2tanh", "2tanh")):
            if bool(inps.get(flag, False)):
                updates["stretch_method"] = meth
        for k in ("hlin", "dzlin", "stretchconst"):
            if k in inps:
                updates[k] = float(inps[k])
    if bool(inps.get("ltrees", False)) and inps.get("treesfile"):
        updates["trees_file"] = str((nam_path.parent
                                     / str(inps["treesfile"])))
    cfg = replace(cfg, **updates)

    stl = inps.get("stl_file")
    extras = {
        "driver": (dict(jobnr=int(inps.get("driverjobnr",
                                           _get(g, "DRIVER", "driverjobnr",
                                                0))),
                        outpath=str(inps.get("driveroutpath", ".")),
                        timeidx=(int(inps["drivertimeidx"])
                                 if "drivertimeidx" in inps else None))
                   if int(inps.get("idriver",
                                   _get(g, "DRIVER", "idriver", 0))) == 2
                   else None),
        "nsv": int(_get(g, "SCALARS", "nsv", 0)),
        "sv0": [float(inps.get(f"sv{n}0", 0.0)) for n in range(1, 6)],
        "lzstretch": bool(inps.get("lzstretch", False)),
        "line_sources": [],
        "point_sources": [],
    }
    # scalar line sources (udprep_scalars.py:119: xSb..sigSl under &INPS)
    if bool(_get(g, "SCALARS", "lscasrcl", False)) or "ssl" in inps:
        n_l = int(_get(g, "SCALARS", "nscasrcl", 1))
        vals = {k: inps.get(k) for k in
                ("xsb", "ysb", "zsb", "xse", "yse", "zse", "ssl", "sigsl")}
        if any(v is None for v in vals.values()):
            raise ValueError("Must set appropriate xSb, ySb, zSb, xSe, ySe, "
                             "zSe, SSl and sigSl under &INPS for a scalar "
                             "line source.")
        as_list = {k: (list(v) if isinstance(v, tuple) else [v] * n_l)
                   for k, v in vals.items()}
        for i in range(n_l):
            extras["line_sources"].append(
                tuple(float(as_list[k][i]) for k in
                      ("xsb", "ysb", "zsb", "xse", "yse", "zse",
                       "ssl", "sigsl")))
    if bool(_get(g, "SCALARS", "lscasrc", False)) or "ssp" in inps:
        n_p = int(_get(g, "SCALARS", "nscasrc", 1))
        vals = {k: inps.get(k) for k in ("xs", "ys", "zs", "ssp", "sigsp")}
        if any(v is None for v in vals.values()):
            raise ValueError("Must set appropriate xS, yS, zS, SSp and sigSp "
                             "under &INPS for a scalar point source.")
        as_list = {k: (list(v) if isinstance(v, tuple) else [v] * n_p)
                   for k, v in vals.items()}
        for i in range(n_p):
            extras["point_sources"].append(
                tuple(float(as_list[k][i]) for k in
                      ("xs", "ys", "zs", "ssp", "sigsp")))
    return cfg, stl, extras


def prepare_from_case(case_dir: str | Path, outdir: str | Path | None = None,
                      expnr: str | None = None) -> dict:
    """One-command regeneration of a case's preprocessed inputs from its own
    namoptions + STL (the reference workflow: udprep.run_all)."""
    case_dir = Path(case_dir)
    if expnr is None:
        nam = sorted(case_dir.glob("namoptions.*"))[0]
    else:
        nam = case_dir / f"namoptions.{expnr}"
    cfg, stl, extras = prep_config_from_namoptions(nam)
    if stl is None:
        raise ValueError(f"&INPS in {nam} sets no stl_file")
    outdir = Path(outdir) if outdir is not None else case_dir
    from .prep import prepare_case
    counts = prepare_case(case_dir / stl, outdir, cfg, extras=extras)
    _patch_walls_namelist(nam, outdir / nam.name, counts)
    # sanity switch (udprep_seb.py:27-37): a stability momentum wall
    # function needs an evolved air temperature and a facet temperature
    import re
    import warnings as _w
    text = (outdir / nam.name).read_text()
    iwm = re.search(r"iwallmom\s*=\s*(\d+)", text)
    iwt = re.search(r"iwalltemp\s*=\s*(\d+)", text)
    ltq = bool(_get(parse_namelists(text), "PHYSICS", "ltempeq", False))
    if iwm and int(iwm.group(1)) == 2 and (
            not ltq or (iwt and int(iwt.group(1)) == 1)):
        _w.warn("Changing to neutral wall function: iwallmom=2 requires "
                "an evolved air temperature and a facet wall temperature; "
                "setting iwallmom=3 (udprep_seb.py:27)", stacklevel=2)
        (outdir / nam.name).write_text(
            re.sub(r"(iwallmom\s*=\s*)\d+", r"\g<1>3", text))
    # driven cases (idriver=2): initialize the profiles from the
    # precursor's slab statistics so the initial state matches the inflow
    # (udprep_forcing.py:155-210 update_prof_from_driver)
    drv = extras.get("driver")
    if drv is not None:
        update_prof_from_driver(outdir, cfg.expnr, drv["jobnr"],
                                drv["outpath"], drv.get("timeidx"))
    return counts


def update_prof_from_driver(case_dir: str | Path, expnr: str,
                            driverjobnr: int, driveroutpath: str | Path,
                            drivertimeidx: int | None = None) -> bool:
    """Overwrite prof.inp's thl/qt/u/v/tke columns with the precursor's
    xytdump slab profiles (udprep_forcing.py update_prof_from_driver).
    Returns False (leaving prof.inp untouched, with a warning) when the
    precursor output is missing — the reference's behaviour."""
    import warnings

    import numpy as np
    case_dir = Path(case_dir)
    prof_p = case_dir / f"prof.inp.{expnr}"
    if not prof_p.exists():
        raise FileNotFoundError(f"{prof_p} not found for driver update")
    xyt = Path(driveroutpath) / f"xytdump.{int(driverjobnr):03d}.nc"
    if not xyt.exists():
        warnings.warn(f"Driver output {xyt} not found; prof.inp kept",
                      stacklevel=2)
        return False
    from scipy.io import netcdf_file
    with netcdf_file(str(xyt), "r", mmap=False) as f:
        data = {k: np.array(v[:]) for k, v in f.variables.items()
                if k in ("uxyt", "vxyt", "thlxyt", "qtxyt", "tketxyc")}
    nt = data["uxyt"].shape[0]
    idx = (drivertimeidx if drivertimeidx is not None
           and 0 <= drivertimeidx < nt else nt - 1)
    pr = np.loadtxt(prof_p, skiprows=2)
    hdr = prof_p.read_text().splitlines()[:2]
    pr[:, 1] = data["thlxyt"][idx]
    pr[:, 2] = data["qtxyt"][idx]
    pr[:, 3] = data["uxyt"][idx]
    pr[:, 4] = data["vxyt"][idx]
    pr[:, 5] = np.maximum(data["tketxyc"][idx], 0.0)
    with open(prof_p, "w") as f:
        f.write("\n".join(hdr) + "\n")
        np.savetxt(f, pr, fmt="%14.6e")
    return True


def _patch_walls_namelist(nam_in: Path, nam_out: Path, counts: dict):
    """Rewrite the &WALLS counts in a namoptions copy (the reference udprep
    writes them back into the case file, udprep_ibm.py write_outputs)."""
    text = nam_in.read_text()
    keys = (["nfcts"] + [f"nsolpts_{w}" for w in "uvwc"]
            + [f"nbndpts_{w}" for w in "uvwc"]
            + [f"nfctsecs_{w}" for w in "uvwc"])
    lines = []
    in_walls = False
    seen = set()
    for line in text.splitlines():
        s = line.strip()
        if s.upper().startswith("&WALLS"):
            in_walls = True
        elif in_walls and s == "/":
            for k in keys:
                if k not in seen:
                    lines.append(f"{k} = {counts[k]}")
            in_walls = False
        elif in_walls:
            key = s.split("=")[0].strip().lower()
            if key in keys:
                lines.append(f"{key} = {counts[key]}")
                seen.add(key)
                continue
        lines.append(line)
    if "&WALLS" not in text.upper():
        lines.append("&WALLS")
        lines.extend(f"{k} = {counts[k]}" for k in keys)
        lines.append("/")
    nam_out.write_text("\n".join(lines) + "\n")
