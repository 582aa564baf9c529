"""Case preparation — the udprep equivalent (the port's own copy of
``udales_tpu/prep/prep.py``).

Generates a complete, runnable case directory from an STL geometry + domain
parameters: all IBM inputs, facet property files, initial profiles, and a
namoptions file with the &WALLS counts filled in (the reference pipeline:
tools/python/udprep orchestrating the Fortran kernels, SURVEY.md A.3)."""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..grid import Grid
from .ibmprep import IBMPreproc


# default wall-type table rows (factypes.inp layout, initfac.f90:166-193):
# id lGR z0 z0h al em d1 d2 d3 C1 C2 C3 l1 l2 l3 k1 k2 k3 k4
DEFAULT_FACTYPES = [
    # bounding walls (no SEB)
    [-101, 0, 0.00, 0.00000, 0.50, 0.85] + [0.0] * 3 + [0.0] * 3
    + [0.0] * 3 + [0.0] * 4,
    # asphalt floor
    [-1, 0, 0.05, 0.00035, 0.50, 0.85, 0.1, 0.2, 0.2,
     1.875e6, 1.875e6, 1.875e6, 0.75, 0.75, 0.75,
     4e-7, 4e-7, 4e-7, 4e-7],
    # concrete wall
    [1, 0, 0.05, 0.00035, 0.50, 0.85, 0.1, 0.2, 0.2,
     2.5e6, 2.5e6, 2.5e6, 1.28, 1.28, 1.28,
     5e-7, 5e-7, 5e-7, 5e-7],
]


@dataclass
class PrepConfig:
    itot: int = 64
    jtot: int = 64
    ktot: int = 64
    xlen: float = 64.0
    ylen: float = 64.0
    zsize: float = 64.0
    expnr: str = "901"
    u0: float = 1.5
    v0: float = 0.0
    thl0: float = 288.0
    qt0: float = 0.0
    e12: float = 5e-5
    lapse: float = 0.0        # thl lapse rate [K/m] (generate_prof)
    dpdx: float = 0.0
    dpdy: float = 0.0
    # large-scale forcing profile generation (udprep ForcingSection,
    # udprep_forcing.py generate_lscale)
    w_s: float = 0.0          # subsidence velocity
    R: float = 0.0            # radiative cooling dthlrad
    dqtdxls: float = 0.0
    dqtdyls: float = 0.0
    dqtdtls: float = 0.0
    lprofforc: bool = False
    lcoriol: bool = False
    has_flow_forcing: bool = False   # any *outflowr/*volflowr/nudge switch
    floor_type: int = -1
    wall_type: int = 1
    # IBM preprocessing flags (udprep defaults.json: both default true)
    stl_ground: bool = True
    diag_neighbs: bool = True
    # radiation
    with_radiation: bool = False
    zenith_deg: float = 45.0
    azimuth_deg: float = 180.0
    I_dir: float = 800.0
    D_diff: float = 120.0
    albedo: float = 0.3
    facT0: float = 295.0
    vf_subdiv: int = 1
    vf_exact_close: bool = True   # contour-integral fixup for close pairs
    # date/site solar state (isolar=2 pathway): overrides zenith/azimuth/
    # I_dir/D_diff when set, e.g. "2011-09-30T11:00"
    solar_datetime: str | None = None
    latitude: float = 51.5
    longitude: float = -0.13
    timezone: float = 0.0
    xazimuth: float = 0.0
    # vegetation: legacy trees.inp block file (expanded to veg.inp)
    trees_file: str | None = None
    # weather-series shortwave (udprep isolar=3): path to a measured series
    weather_file: str | None = None
    # layered initial facet temperatures from a previous run's facT.nc
    # (udprep SEBSection write_Tfacinit_layers)
    lfacTlyrs: bool = False
    facT_file: str | None = None
    nfaclyrs: int = 3
    # per-facet wall types from a file (udprep read_types/types_path)
    types_file: str | None = None
    # stretched vertical grid (udprep GridSection; prep/zgrid.py)
    lzstretch: bool = False
    stretch_method: str = "tanh"   # exp | expcheck | tanh | 2tanh
    hlin: float | None = None
    dzlin: float | None = None
    stretchconst: float = 1.5


def prepare_case(stl_path: str | Path, outdir: str | Path,
                 cfg: PrepConfig, extras: dict | None = None) -> dict:
    """Run the full preprocessing chain; returns the &WALLS counts.

    `extras` (from prep/inps.py): scalar initial values + point/line
    sources parsed from the case's &INPS/&SCALARS groups."""
    extras = extras or {}
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    if cfg.lzstretch:
        from .zgrid import zgrid_centers
        zf = zgrid_centers(cfg.ktot, cfg.zsize, lzstretch=True,
                           method=cfg.stretch_method, hlin=cfg.hlin,
                           dzlin=cfg.dzlin, stretchconst=cfg.stretchconst)
        grid = Grid(cfg.itot, cfg.jtot, cfg.ktot, cfg.xlen, cfg.ylen, zf,
                    dtype=np.float64)
    else:
        grid = Grid.uniform(cfg.itot, cfg.jtot, cfg.ktot, cfg.xlen,
                            cfg.ylen, cfg.zsize, dtype=np.float64)
    pp = IBMPreproc.from_stl(stl_path, grid, stl_ground=cfg.stl_ground,
                             diag_neighbs=cfg.diag_neighbs)
    facet_types = None
    if cfg.types_file is not None:
        # headerless or one-line-header list of per-facet type ids
        # (udprep_ibm.py _load_facet_types)
        for skiprows in (0, 1):
            try:
                vals = np.atleast_1d(np.loadtxt(cfg.types_file,
                                                skiprows=skiprows))
            except ValueError:
                continue
            if len(vals) == len(pp.tris):
                facet_types = vals.astype(int)
                break
        if facet_types is None:
            raise ValueError(f"{cfg.types_file} does not carry "
                             f"{len(pp.tris)} facet types")
    counts = pp.run(outdir, cfg.expnr, cfg.floor_type, cfg.wall_type,
                    facet_types=facet_types)

    # factypes + initial facet temperatures (an existing authored
    # factypes.inp is never overwritten, as in udprep)
    ftpath = outdir / f"factypes.inp.{cfg.expnr}"
    if not ftpath.exists():
        with open(ftpath, "w") as f:
            f.write("# walltype, 3 layers per type\n# id lGR z0 z0h al em "
                    "d1 d2 d3 C1 C2 C3 l1 l2 l3 k1 k2 k3 k4\n#\n")
            for row in DEFAULT_FACTYPES:
                f.write(" ".join(f"{v:g}" for v in row) + "\n")
    nfcts = counts["nfcts"]
    if cfg.lfacTlyrs and cfg.facT_file:
        write_tfacinit_layers(outdir, cfg.expnr, cfg.facT_file, nfcts,
                              cfg.nfaclyrs)
    else:
        with open(outdir / f"Tfacinit.inp.{cfg.expnr}", "w") as f:
            f.write("# initial facet temperature\n")
            for _ in range(nfcts):
                f.write(f"{cfg.facT0:.2f}\n")

    # profiles; the thl lapse integrates over the (possibly stretched)
    # half-level spacings (udprep_forcing.py:59-65)
    zf = grid.zf
    thl = np.full(len(zf), cfg.thl0)
    if cfg.lapse:
        dzt = grid.dzf
        for k in range(len(zf) - 1):
            thl[k + 1] = thl[k] + cfg.lapse * 0.5 * (dzt[k] + dzt[k + 1])
    with open(outdir / f"prof.inp.{cfg.expnr}", "w") as f:
        f.write("# generated by udales_tpu prep\n# z thl qt u v tke\n")
        for z, t in zip(zf, thl):
            f.write(f"{z:14.6f} {t:12.4f} {cfg.qt0:12.6f} "
                    f"{cfg.u0:12.4f} {cfg.v0:12.4f} {cfg.e12:12.6f}\n")
    # large-scale forcing columns (udprep_forcing.py:233-276): geostrophic
    # wind under lprofforc/lcoriol, else pressure gradients when no other
    # forcing switch drives the flow; subsidence/moisture/radiation always
    ug = vg = pgx = pgy = 0.0
    if cfg.lprofforc or cfg.lcoriol:
        ug, vg = cfg.u0, cfg.v0
    elif not cfg.has_flow_forcing:
        pgx, pgy = cfg.dpdx, cfg.dpdy
    with open(outdir / f"lscale.inp.{cfg.expnr}", "w") as f:
        f.write("# generated\n# z ug vg pgx pgy wfls dqtdx dqtdy dqtdt "
                "dthlrad\n")
        for z in zf:
            f.write(f"{z:14.6f} {ug:.6f} {vg:.6f} {pgx:.8f} {pgy:.8f} "
                    f"{cfg.w_s:.6f} {cfg.dqtdxls:.8f} {cfg.dqtdyls:.8f} "
                    f"{cfg.dqtdtls:.8f} {cfg.R:.8f}\n")

    # scalars: initial profiles + point/line sources (the reference's
    # udprep_scalars section; file layouts modscalsource.f90:300,342)
    nsv = int(extras.get("nsv", 0))
    if nsv > 0:
        sv0 = extras.get("sv0", [0.0] * 5)
        with open(outdir / f"scalar.inp.{cfg.expnr}", "w") as f:
            f.write("# generated by udales_tpu prep\n# z scaN, N=1..nsv\n")
            for z in zf:
                f.write(f"{z:14.6f} " + " ".join(
                    f"{sv0[n]:12.6f}" for n in range(nsv)) + "\n")
    for name, rows, hdr in (
            ("scalarsourcel", extras.get("line_sources", []),
             "#xSb ySb zSb xSe ySe zSe SS sigS"),
            ("scalarsourcep", extras.get("point_sources", []),
             "#xS yS zS SS sigS")):
        if rows:
            with open(outdir / f"{name}.inp.1.{cfg.expnr}", "w") as f:
                f.write(f"# Scalar source data\n{hdr}\n")
                for r in rows:
                    f.write(" ".join(f"{v:.6f}" for v in r) + "\n")

    if cfg.with_radiation or cfg.trees_file is not None:
        raise NotImplementedError("the benchmark's frozen staging writes no "
                                  "radiation or vegetation inputs")

    # info.txt with the &WALLS counts (reference examples ship the same)
    with open(outdir / "info.txt", "w") as f:
        f.write(f"&WALLS\nnfcts = {counts['nfcts']}\n")
        for w in ("u", "v", "w", "c"):
            f.write(f"nsolpts_{w} = {counts[f'nsolpts_{w}']}\n")
        for w in ("u", "v", "w", "c"):
            f.write(f"nbndpts_{w} = {counts[f'nbndpts_{w}']}\n")
        for w in ("u", "v", "w", "c"):
            f.write(f"nfctsecs_{w} = {counts[f'nfctsecs_{w}']}\n")
        f.write("/\n")
    return counts


def make_box_stl(path: str | Path, x0, x1, y0, y1, z1,
                 xlen: float, ylen: float, floor: bool = True):
    """Write an STL with one box building (roof + 4 walls) and an optional
    floor covering the domain (simple test-geometry generator, the udgeom
    analogue)."""
    from .stl import write_stl
    tris = []

    def quad(a, b, c, d):
        tris.append([a, b, c])
        tris.append([a, c, d])

    if floor:
        # floor ring around the building footprint (z=0)
        quad((0, 0, 0), (xlen, 0, 0), (xlen, y0, 0), (0, y0, 0))
        quad((0, y1, 0), (xlen, y1, 0), (xlen, ylen, 0), (0, ylen, 0))
        quad((0, y0, 0), (x0, y0, 0), (x0, y1, 0), (0, y1, 0))
        quad((x1, y0, 0), (xlen, y0, 0), (xlen, y1, 0), (x1, y1, 0))
    # roof
    quad((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1))
    # walls (outward normals)
    quad((x0, y0, 0), (x0, y0, z1), (x0, y1, z1), (x0, y1, 0))   # -x
    quad((x1, y0, 0), (x1, y1, 0), (x1, y1, z1), (x1, y0, z1))   # +x
    quad((x0, y0, 0), (x1, y0, 0), (x1, y0, z1), (x0, y0, z1))   # -y
    quad((x0, y1, 0), (x0, y1, z1), (x1, y1, z1), (x1, y1, 0))   # +y
    arr = np.asarray(tris, np.float64)
    write_stl(path, arr)
    return arr


def make_box_array_stl(path: str | Path, nbx: int, nby: int, frac: float,
                       height: float, xlen: float, ylen: float):
    """Write an STL with a regular nbx x nby array of box buildings
    (footprint = `frac` of the pitch in each direction, aligned-array urban
    canopy) plus the surrounding floor, decomposed as a per-cell ring so
    the surface stays watertight against the building footprints."""
    from .stl import write_stl
    tris = []

    def quad(a, b, c, d):
        tris.append([a, b, c])
        tris.append([a, c, d])

    px, py = xlen / nbx, ylen / nby
    off = (1.0 - frac) / 2.0
    for ib in range(nbx):
        for jb in range(nby):
            cx, cy = ib * px, jb * py
            x0, x1 = cx + off * px, cx + (off + frac) * px
            y0, y1 = cy + off * py, cy + (off + frac) * py
            # floor ring of this cell
            quad((cx, cy, 0), (cx + px, cy, 0), (cx + px, y0, 0), (cx, y0, 0))
            quad((cx, y1, 0), (cx + px, y1, 0), (cx + px, cy + py, 0),
                 (cx, cy + py, 0))
            quad((cx, y0, 0), (x0, y0, 0), (x0, y1, 0), (cx, y1, 0))
            quad((x1, y0, 0), (cx + px, y0, 0), (cx + px, y1, 0),
                 (x1, y1, 0))
            # roof + walls (outward normals)
            z1 = height
            quad((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1))
            quad((x0, y0, 0), (x0, y0, z1), (x0, y1, z1), (x0, y1, 0))
            quad((x1, y0, 0), (x1, y1, 0), (x1, y1, z1), (x1, y0, z1))
            quad((x0, y0, 0), (x1, y0, 0), (x1, y0, z1), (x0, y0, z1))
            quad((x0, y1, 0), (x0, y1, z1), (x1, y1, z1), (x1, y1, 0))
    arr = np.asarray(tris, np.float64)
    write_stl(path, arr)
    return arr


def write_tfacinit_layers(outdir: str | Path, expnr: str,
                          facT_file: str | Path, nfcts: int,
                          nfaclyrs: int):
    """Tfacinit_layers.inp from a previous run's facT output (udprep
    SEBSection write_Tfacinit_layers): the last time slice of the "T"
    variable, accepting either the (nt, nfcts, nlayers) layout this
    framework writes or the (nfcts, nlayers, nt) layout the reference
    slices with Tfac[:, :, -1]."""
    from scipy.io import netcdf_file
    with netcdf_file(str(facT_file), "r", mmap=False) as f:
        if "T" not in f.variables:
            raise ValueError(f"{facT_file} missing variable 'T'")
        T = np.array(f.variables["T"][:])
    if T.ndim != 3:
        raise ValueError(f"facT 'T' must be 3-D, got shape {T.shape}")
    if T.shape[1] == nfcts:
        Tl = T[-1]                    # (nt, nfcts, L) -> last time
    elif T.shape[0] == nfcts:
        Tl = T[:, :, -1]              # (nfcts, L, nt) -> last time
    else:
        raise ValueError(f"facT 'T' shape {T.shape} does not carry "
                         f"nfcts={nfcts} facets")
    Tl = Tl[:, :nfaclyrs]
    p = Path(outdir) / f"Tfacinit_layers.inp.{expnr}"
    with open(p, "w") as f:
        f.write("# Initial facet temperatures in radiative equilibrium\n")
        np.savetxt(f, Tl, fmt="%.4f")
