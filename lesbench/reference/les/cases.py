"""Case staging: the urban building-array case of ``bench.py``, plain and
driven by precursor planes.

``stage_urban(n, root)`` writes the same case directory as
``bench._stage_urban(n)`` (``root/urban{n}v2``, experiment ``900``): a 4x4
aligned array of blocks n/8 wide and n/4 tall at lambda_p = 0.25,
generated by the port's own host-side NumPy preprocessing
(``udales_tpu_torch.prep``), plus the namelist.  The files are
byte-identical to the JAX package's.  ``stage_urban(n, root, layout)``
stages another aligned array of the same kind (``Layout``), such as
Coceal et al.'s 2 x 2 cubes of side n/4.  In place of n, a ``Domain``
stages a domain that is not n^3 (``root/urban{itot}x{jtot}x{ktot}v2``),
such as Coceal's cubes repeated 8 x 8 at 512 x 512 x 128.

``stage_urban_driven(n, root)`` stages the same array with an open x
boundary: a ``BCxm = 3`` driver inlet replayed from synthesized precursor
planes through the ``lchunkread`` window, and a convective outlet
(``root/urban{n}drv``).

``stage_urban_dispersion(dom, root, layout, air, groups)`` stages the same
array as a street-canyon air-quality case (``root/urban{n}disp``): the
scalars, their source rows, the chemistry and the tree cells that a
configuration's ``air`` block and namelist groups state, written as they
are.
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np

from .io.driverfiles import write_driver_files
from .prep.prep import PrepConfig, prepare_case
from .prep.udgeom import create_cubes

_NAMELIST = """&RUN
iexpnr = 900
ladaptive = .true.
dtmax = 0.5
libm = .true.
/
&DOMAIN
itot = {itot}
jtot = {jtot}
ktot = {ktot}
xlen = {xlen}
ylen = {ylen}
/
&PHYSICS
ltempeq = .true.
lbuoyancy = .true.
luvolflowr = .true.
uflowrate = 1.5
/
&WALLS
{walls}
iwalltemp = 2
/
&BC
thls = 295.
thl_top = 285.
BCtopT = 2
z0 = 0.05
z0h = 0.00035
/
&NAMSUBGRID
lvreman = .true.
/
"""

_DRIVEN_BC = "&BC\nBCxm = 3\nBCxT = 3\nBCxq = 3\nBCxs = 3\n"
_DRIVER_NAMELIST = """&DRIVER
idriver = 2
driverjobnr = 900
tdriverstart = 0.
lchunkread = .true.
chunkread_size = {chunk}
driverstore = {nt}
/
"""

# the flat neutral ABL of ``entry._build`` as a case directory: experiment
# 901 records inlet planes at the last u face, experiment 902 replays them
class Layout(NamedTuple):
    """An aligned array of boxes (``create_cubes`` with ``"AC"``), in m:
    each box `Hx` x `Hy` x `Hz`, streets `Cx` and `Cy` wide between them,
    facets cut at `edge`."""
    Hx: float
    Hy: float
    Hz: float
    Cx: float
    Cy: float
    edge: float


class Domain(NamedTuple):
    """A case's domain: `itot` x `jtot` x `ktot` cells over `xlen` x `ylen`
    m, and a uniform z grid `zsize` m high."""
    itot: int
    jtot: int
    ktot: int
    xlen: float
    ylen: float
    zsize: float


def cubic(n: int) -> Domain:
    """The n^3 domain of 1 m cells."""
    return Domain(n, n, n, float(n), float(n), float(n))


def _domain(size: int | Domain) -> Domain:
    return size if isinstance(size, Domain) else cubic(size)


def _tag(dom: Domain) -> str:
    """``n`` for an n^3 domain of 1 m cells, ``{itot}x{jtot}x{ktot}``
    otherwise: the part of a case directory's name that gives its size."""
    n = dom.itot
    return str(n) if dom == cubic(n) else f"{n}x{dom.jtot}x{dom.ktot}"


def _real(x: float) -> str:
    """A length as the namelist states it: ``128.`` for 128 m."""
    return f"{int(x)}." if float(x).is_integer() else repr(float(x))


def default_layout(n: int) -> Layout:
    """``bench._stage_urban``'s array: a 4 x 4 array at pitch p = n/4 of
    blocks p/2 wide and p tall along streets p/2 wide."""
    p = n / 4.0
    return Layout(p / 2, p / 2, p, p / 2, p / 2, p / 2)


def stage_urban(n: int | Domain, root, layout: Layout | None = None) \
        -> Path:
    """Generate (once; an existing namelist is reused) the n^3 urban case,
    or that of the ``Domain`` `n`, under `root` and return its directory.
    Heated facets (facT0 = 295 K, iwalltemp = 2), Vreman, buoyancy, fixed
    volume flow rate 1.5 m/s.  `layout` (default ``default_layout(n)``) is
    the building array."""
    dom = _domain(n)
    return _stage(dom, Path(root) / f"urban{_tag(dom)}v2", _NAMELIST,
                  layout=layout)


def driver_planes(jtot: int, ktot: int, nt: int, dtdriver: float = 1.0) \
        -> tuple[np.ndarray, dict]:
    """Synthetic precursor planes as ``bench._stage_950_replay`` makes them:
    `nt` records `dtdriver` seconds apart of a log profile u*/kappa ln(z/z0)
    (u* = 0.4, z0 = 0.05) with N(0, 0.05) noise on u and v, N(0, 0.02) on w, and
    thl = 290 K, from ``np.random.default_rng(7)``; 1 m cells, (nt, jtot,
    ktot) each.  The w planes are zero at the impermeable floor; the top
    face, which lies beyond the planes' ktot levels, is written as the
    writer pads it and is zeroed again by the w ghost rule."""
    t = dtdriver * np.arange(nt, dtype=np.float64)
    rng = np.random.default_rng(7)
    z = np.arange(ktot) + 0.5
    uprof = 0.4 / 0.41 * np.log(np.maximum(z, 0.06) / 0.05)
    shape = (nt, jtot, ktot)
    planes = {
        "u": uprof[None, None, :] + 0.05 * rng.standard_normal(shape),
        "v": 0.05 * rng.standard_normal(shape),
        "w": 0.02 * rng.standard_normal(shape),
        "thl": np.full(shape, 290.0),
    }
    planes["w"][:, :, 0] = 0.0
    return t, planes


def stage_urban_driven(n: int | Domain, root, nt: int = 120,
                       chunk: int = 16, dtdriver: float = 1.0,
                       layout: Layout | None = None) -> Path:
    """The `stage_urban` case driven through an open x boundary: ``&BC
    BCxm = BCxT = BCxq = BCxs = 3`` (driver inlet, convective outlet) and
    ``&DRIVER idriver = 2, driverjobnr = 900, lchunkread, chunkread_size =
    chunk, driverstore = nt``, with `driver_planes(jtot, ktot, nt,
    dtdriver)` written as the reference's ``?driver_*.900`` files and their
    mean u profile as the start profile of prof.inp.  Its own directory,
    generated once:
    ``root/urban{n}drv`` (``root/urban{n}drv_nt{nt}_chunk{chunk}_dt{dtdriver}``
    for other than the default series of 120 records 1 s apart read 16 at a
    time).  With the inflow's 5 to 8 m/s in 1 m cells the adaptive step is
    about 0.05 s, so a run of tens of steps crosses a window only with
    records closer than 1 s."""
    dom = _domain(n)
    tag = _tag(dom)
    name = f"urban{tag}drv" if (nt, chunk, dtdriver) == (120, 16, 1.0) \
        else f"urban{tag}drv_nt{nt}_chunk{chunk}_dt{dtdriver:g}"
    assert _NAMELIST.count("&BC\n") == 1
    namelist = _NAMELIST.replace("&BC\n", _DRIVEN_BC) + _DRIVER_NAMELIST

    def write_planes(case):
        t, planes = driver_planes(dom.jtot, dom.ktot, nt, dtdriver)
        write_driver_files(case, "900", t, planes, dom.jtot, dom.ktot)
        # start the interior from the inflow's mean profile and not from
        # stage_urban's uniform 1.5 m/s, which the first projection would
        # have to accelerate fourfold in one step
        prof = case / "prof.inp.900"
        head, rows = prof.read_text().splitlines()[:2], np.loadtxt(
            prof, skiprows=2)
        rows[:, 3] = planes["u"].mean(axis=(0, 1))
        prof.write_text("\n".join(head + [
            f"{r[0]:14.6f} {r[1]:12.4f} {r[2]:12.6f} {r[3]:12.4f} "
            f"{r[4]:12.4f} {r[5]:12.6f}" for r in rows]) + "\n")
    return _stage(dom, Path(root) / name, namelist, before=write_planes,
                  layout=layout, nt=nt, chunk=chunk)


# the namelist groups a dispersion configuration adds to the template
AIR_GROUPS = ("SCALARS", "CHEMISTRY", "TREES")
_LINE_HEADER = "# Scalar source data\n#xSb ySb zSb xSe ySe zSe SS sigS\n"
_POINT_HEADER = "# Scalar source data\n#xS yS zS SS sigS\n"


def _source_rows(dom: Domain, air: dict) -> tuple[int, int, int]:
    """(nsv, line rows, point rows a scalar) of an `air` block; raises
    unless every scalar has a background and as many line (point) rows as
    the others, each row of 8 (5) numbers with sigma > 0, and every row's
    3 sigma support stays inside the domain `dom` but at the floor: a
    point's in x, y and up; a line's ends inside, its reach across x (y)
    inside where it runs at one x (y), and its reach up under the top.
    Neither package's sources wrap around a periodic side."""
    nsv = len(air["species"])
    if len(air["background"]) != nsv:
        raise ValueError(f"{nsv} species, {len(air['background'])} "
                         f"backgrounds")
    counts = []
    for kind, width in (("lines", 8), ("points", 5)):
        per = air.get(kind, [])
        if per and len(per) != nsv:
            raise ValueError(f"{kind}: rows for {len(per)} scalars, "
                             f"{nsv} species")
        if len({len(rows) for rows in per}) > 1:
            raise ValueError(f"{kind}: each scalar needs as many rows")
        counts.append(len(per[0]) if per else 0)
        for rows in per:
            for r in rows:
                if len(r) != width or r[-1] <= 0:
                    raise ValueError(f"{kind} row {r}: {width} numbers, "
                                     f"sigma > 0")
                reach = 3.0 * r[-1]
                ends = (r[:3], r[3:6]) if width == 8 else (r[:3],)
                top = max(e[2] for e in ends) + reach
                out = top > dom.zsize or any(
                    not 0.0 <= e[2] <= dom.zsize for e in ends)
                for a, size in ((0, dom.xlen), (1, dom.ylen)):
                    lo = min(e[a] for e in ends)
                    hi = max(e[a] for e in ends)
                    pad = reach if lo == hi else 0.0
                    out |= lo - pad < 0.0 or hi + pad > size
                if out:
                    raise ValueError(f"{kind} row {r}: its 3 sigma support "
                                     f"leaves the domain")
    return nsv, counts[0], counts[1]


def tree_cells(air: dict) -> list[tuple[int, int, int, int]]:
    """The (i, j, k, id) tree cells, from 1, of an `air` block's ``trees``
    boxes ``(il, iu, jl, ju, kl, ku, id)`` (inclusive), sorted; raises
    where a box is empty, names an id that ``tree_params`` lacks, or
    overlaps another."""
    ids = {int(r[0]) for r in air.get("tree_params", [])}
    cells = {}
    for il, iu, jl, ju, kl, ku, pid in air.get("trees", []):
        if il > iu or jl > ju or kl > ku or pid not in ids:
            raise ValueError(f"tree box {(il, iu, jl, ju, kl, ku, pid)}: "
                             f"empty, or no tree_params row {pid}")
        for ijk in np.ndindex(iu - il + 1, ju - jl + 1, ku - kl + 1):
            at = (il + ijk[0], jl + ijk[1], kl + ijk[2])
            if at in cells:
                raise ValueError(f"tree cell {at} is in two boxes")
            cells[at] = pid
    return sorted(at + (pid,) for at, pid in cells.items())


def _refuse_misplaced(dom: Domain, air: dict, solid: set) -> None:
    """Raise where a tree cell lies outside the domain `dom` or in a
    `solid` cell ((i, j, k) from 1), or a source row's point or line
    passes through one (the line sampled at a quarter cell)."""
    for i, j, k, _ in tree_cells(air):
        if not (1 <= i <= dom.itot and 1 <= j <= dom.jtot
                and 1 <= k <= dom.ktot) or (i, j, k) in solid:
            raise ValueError(f"tree cell {(i, j, k)} lies outside the "
                             f"domain or in a building")
    cell = np.array([dom.xlen / dom.itot, dom.ylen / dom.jtot,
                     dom.zsize / dom.ktot])
    top = np.array([dom.itot, dom.jtot, dom.ktot])
    for kind in ("lines", "points"):
        for rows in air.get(kind, []):
            for r in rows:
                ends = np.array([r[:3], r[3:6]] if kind == "lines"
                                else [r[:3]], dtype=np.float64)
                steps = int(np.ceil(np.abs(ends[-1] - ends[0]).max()
                                    / (cell.min() / 4))) + 1
                at = ends[0] + np.linspace(0.0, 1.0, steps)[:, None] \
                    * (ends[-1] - ends[0])
                ijk = np.minimum((at // cell).astype(np.int64), top - 1) + 1
                if any(tuple(c) in solid for c in ijk):
                    raise ValueError(f"{kind} row {r} passes through a "
                                     f"building")


def _namelist_groups(groups: dict) -> str:
    """Namelist groups as text: booleans as .true./.false., strings
    quoted."""
    fmt = lambda v: ((".true." if v else ".false.") if isinstance(v, bool)
                     else f"'{v}'" if isinstance(v, str) else repr(v))
    return "".join(f"&{name}\n" + "".join(f"{k} = {fmt(v)}\n"
                                         for k, v in kv.items()) + "/\n"
                   for name, kv in groups.items())


def stage_urban_dispersion(n: int | Domain, root, layout: Layout, air: dict,
                           groups: dict) -> Path:
    """The `stage_urban` array as a street-canyon air-quality case, its flow
    and walls unchanged, from a configuration's `air` block and its
    namelist `groups` (``SCALARS``, ``CHEMISTRY``, ``TREES``), which are
    written into the namelist as given.  The block states, for scalars
    ``species`` with their ``background``s (``scalar.inp``), the rows of
    uDALES's input files, written as they are: ``lines[n]``, scalar n+1's
    line sources (xSb ySb zSb xSe ySe zSe SS sigS, m;
    ``scalarsourcel.inp.<n+1>.900``), ``points[n]`` its point sources (xS
    yS zS SS sigS; ``scalarsourcep.inp.<n+1>.900``), ``trees``, boxes of
    tree cells (il iu jl ju kl ku id, from 1, inclusive; ``veg.inp``, a
    cell a row), and ``tree_params`` (id lad cd ud dec lsize rs;
    ``veg_params.inp``).  Raises, before anything is written, where a
    source's support leaves the domain (`_source_rows`) or ``SCALARS`` or
    ``TREES`` states other counts or switches than the rows; and once the
    buildings are staged, where a tree cell or a source lies in one.  Its
    own directory, generated once: ``root/urban{n}disp``."""
    dom = _domain(n)
    nsv, nlines, npoints = _source_rows(dom, air)
    trees = tree_cells(air)
    stated = {k.lower(): v for g in ("SCALARS", "TREES")
              for k, v in groups.get(g, {}).items()}
    implied = dict(nsv=nsv, nscasrcl=nlines, nscasrc=npoints,
                   lscasrcl=nlines > 0, lscasrc=npoints > 0,
                   ltrees=bool(trees))
    for key, want in implied.items():
        # a switch left out is off; a count left out is the rows'
        got = stated.get(key, False if key.startswith("l") else want)
        if got != want:
            raise ValueError(f"{key} = {got}, the air block's rows say "
                             f"{want}")
    namelist = _NAMELIST + _namelist_groups(groups)

    def write_air(case):
        solid = {tuple(r) for r in np.loadtxt(
            case / "solid_c.txt", skiprows=1, dtype=np.int64, ndmin=2)}
        _refuse_misplaced(dom, air, solid)
        row = lambda vals: " ".join(f"{v:.6f}" for v in vals) + "\n"
        for kind, stem, head in (("lines", "scalarsourcel", _LINE_HEADER),
                                 ("points", "scalarsourcep", _POINT_HEADER)):
            for s, rows in enumerate(air.get(kind, [])):
                (case / f"{stem}.inp.{s + 1}.900").write_text(
                    head + "".join(row(r) for r in rows))
        if trees:
            (case / "veg.inp.900").write_text(
                "# position (i,j,k) id\n" + "".join(
                    f"{i:7d} {j:7d} {k:7d} {p:7d}\n"
                    for i, j, k, p in trees))
            (case / "veg_params.inp.900").write_text(
                "# id lad cd ud dec lsize r_s\n" + "".join(
                    f"{int(r[0]):7d} " + " ".join(f"{v:12.6f}"
                                                  for v in r[1:]) + "\n"
                    for r in air["tree_params"]))
    return _stage(dom, Path(root) / f"urban{_tag(dom)}disp", namelist,
                  before=write_air, layout=layout,
                  extras=dict(nsv=nsv, sv0=list(air["background"])))


def with_namelist(case, dest, **groups) -> Path:
    """A copy of the staged `case` directory at `dest` whose namelist gains
    the given groups, for example ``with_namelist(case, dest,
    OUTPUT=dict(lxytdump=True, tsample=0.5), RUN=dict(trestart=4.0))``: the
    namelist parser merges the groups of one name, so an entry given here
    overrides the case's.  Booleans are written as .true./.false., strings
    quoted."""
    import shutil
    dest = Path(dest)
    shutil.copytree(case, dest, dirs_exist_ok=True)
    nam = sorted(dest.glob("namoptions.*"))[0]
    nam.write_text(nam.read_text() + _namelist_groups(groups))
    return dest


def _stage(dom: Domain, case: Path, namelist: str, before=None,
           layout: Layout | None = None, extras: dict | None = None,
           **values) -> Path:
    """Stage the array `layout` (default ``default_layout(dom.itot)``) over
    the domain `dom` under `case` unless its namelist, which is written
    last, exists.  `extras` are ``prepare_case``'s scalar inputs,
    `before(case)` writes further inputs."""
    nam = case / "namoptions.900"
    if nam.exists():
        return case
    case.mkdir(parents=True, exist_ok=True)
    lay = layout or default_layout(dom.itot)
    create_cubes(dom.xlen, dom.ylen, lay.Hx, lay.Hy, lay.Hz, lay.Cx, lay.Cy,
                 "AC", edgelength=lay.edge).save(case / "geom.stl")
    counts = prepare_case(case / "geom.stl", case, PrepConfig(
        itot=dom.itot, jtot=dom.jtot, ktot=dom.ktot, xlen=dom.xlen,
        ylen=dom.ylen, zsize=dom.zsize, expnr="900", u0=1.5, thl0=290.0,
        facT0=295.0, with_radiation=False, vf_subdiv=1), extras)
    if before is not None:
        before(case)
    nam.write_text(namelist_text(namelist, dom, counts, **values))
    return case


def namelist_text(namelist: str, dom: Domain, counts: dict,
                  **values) -> str:
    """The template `namelist` written for the domain `dom`, with the
    &WALLS counts of ``prepare_case`` and further `values`."""
    walls = "\n".join(
        [f"nfcts = {counts['nfcts']}"]
        + [f"nsolpts_{w} = {counts[f'nsolpts_{w}']}" for w in "uvwc"]
        + [f"nbndpts_{w} = {counts[f'nbndpts_{w}']}" for w in "uvwc"]
        + [f"nfctsecs_{w} = {counts[f'nfctsecs_{w}']}" for w in "uvwc"])
    return namelist.format(
        itot=dom.itot, jtot=dom.jtot, ktot=dom.ktot, xlen=_real(dom.xlen),
        ylen=_real(dom.ylen), walls=walls, **values)
