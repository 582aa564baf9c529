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
    fmt = lambda v: ((".true." if v else ".false.") if isinstance(v, bool)
                     else f"'{v}'" if isinstance(v, str) else repr(v))
    extra = "".join(
        f"&{name}\n" + "".join(f"{k} = {fmt(v)}\n" for k, v in kv.items())
        + "/\n" for name, kv in groups.items())
    nam.write_text(nam.read_text() + extra)
    return dest


def _stage(dom: Domain, case: Path, namelist: str, before=None,
           layout: Layout | None = None, **values) -> Path:
    """Stage the array `layout` (default ``default_layout(dom.itot)``) over
    the domain `dom` under `case` unless its namelist, which is written
    last, exists.  `before(case)` writes further inputs."""
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
        facT0=295.0, with_radiation=False, vf_subdiv=1))
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
