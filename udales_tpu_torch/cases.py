"""Case staging: the urban building-array case of ``bench.py``, plain, with
the facet energy balance and driven by precursor planes, and a flat
precursor / replay pair.

``stage_urban(n, root)`` writes the same case directory as
``bench._stage_urban(n)`` (``root/urban{n}v2``, experiment ``900``): a 4x4
aligned cube array at lambda_p = 0.25 with H = n/4 m, generated by the
port's own host-side NumPy preprocessing (``udales_tpu_torch.prep``), plus
the namelist.  The files are byte-identical to the JAX package's.

``stage_urban_eb(n, root)`` stages the same array with the radiation inputs
(view factors, sky view factors, net shortwave) and a namelist that
switches the facet energy balance on (``root/urban{n}eb``).

``stage_urban_driven(n, root)`` stages the same array with an open x
boundary: a ``BCxm = 3`` driver inlet replayed from synthesized precursor
planes through the ``lchunkread`` window, and a convective outlet
(``root/urban{n}drv``).  ``stage_precursor(n, root)`` stages the flat
periodic case that records such planes (``idriver = 1``) beside the open-x
case that replays them.
"""
from __future__ import annotations

from pathlib import Path

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
itot = {n}
jtot = {n}
ktot = {n}
xlen = {n}.
ylen = {n}.
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

# sparse view factors, three wall layers, and a dtEB that lets the balance
# fire several times in a 50-step run at dtmax = 0.5; the interior
# temperatures bldT / flrT default to 0 K, so they are set to the facets'
# initial 295 K
_EB_NAMELIST = """&ENERGYBALANCE
lEB = .true.
lvfsparse = .true.
nfaclyrs = 3
skyLW = 350.
dtEB = {dtEB:g}
bldT = 295.
flrT = 295.
/
"""


# a driver inlet for `stage_urban_driven`: inflow planes for every
# prognostic variable, replayed from experiment 900's driver files
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
_FLAT_NAMELIST = """&RUN
iexpnr = {expnr}
ladaptive = .true.
dtmax = 0.5
/
&DOMAIN
itot = {n}
jtot = {n}
ktot = {n}
xlen = {n}.
ylen = {n}.
/
&WALLS
lbottom = .true.
/
&BC
thls = 288.
z0 = 0.03
z0h = 0.003
{bc}/
&DRIVER
{driver}/
"""
PRECURSOR_EXPNR, REPLAY_EXPNR = "901", "902"


def stage_urban(n: int, root) -> Path:
    """Generate (once; an existing namelist is reused) the n^3 urban case
    under `root` and return its directory.  Heated facets (facT0 = 295 K,
    iwalltemp = 2), Vreman, buoyancy, fixed volume flow rate 1.5 m/s."""
    return _stage(n, Path(root) / f"urban{n}v2", False, _NAMELIST)


def stage_urban_eb(n: int, root, dtEB: float = 2.0) -> Path:
    """The `stage_urban` case with the facet surface energy balance: the
    same cube array staged with the radiation inputs (svf.inp, vfsparse.inp,
    netsw.inp) and ``&ENERGYBALANCE lEB, lvfsparse, nfaclyrs = 3,
    skyLW = 350., dtEB, bldT = flrT = 295.`` added to the namelist.  Its own
    directory, generated once: ``root/urban{n}eb``, or
    ``root/urban{n}eb_dtEB{dtEB}`` for another interval than 2 s (a short
    run that must see the balance fire several times)."""
    name = f"urban{n}eb" if dtEB == 2.0 else f"urban{n}eb_dtEB{dtEB:g}"
    return _stage(n, Path(root) / name, True, _NAMELIST + _EB_NAMELIST,
                  dtEB=dtEB)


def driver_planes(n: int, nt: int, dtdriver: float = 1.0) \
        -> tuple[np.ndarray, dict]:
    """Synthetic precursor planes as ``bench._stage_950_replay`` makes them:
    `nt` records `dtdriver` seconds apart of a log profile u*/kappa ln(z/z0)
    (u* = 0.4, z0 = 0.05) with N(0, 0.05) noise on u and v, N(0, 0.02) on w, and
    thl = 290 K, from ``np.random.default_rng(7)``; 1 m cells, (nt, n, n)
    each.  The w planes are zero at the impermeable floor; the top face,
    which lies beyond the planes' n levels, is written as the writer pads
    it and is zeroed again by the w ghost rule."""
    t = dtdriver * np.arange(nt, dtype=np.float64)
    rng = np.random.default_rng(7)
    z = np.arange(n) + 0.5
    uprof = 0.4 / 0.41 * np.log(np.maximum(z, 0.06) / 0.05)
    planes = {
        "u": uprof[None, None, :] + 0.05 * rng.standard_normal((nt, n, n)),
        "v": 0.05 * rng.standard_normal((nt, n, n)),
        "w": 0.02 * rng.standard_normal((nt, n, n)),
        "thl": np.full((nt, n, n), 290.0),
    }
    planes["w"][:, :, 0] = 0.0
    return t, planes


def stage_urban_driven(n: int, root, nt: int = 120, chunk: int = 16,
                       dtdriver: float = 1.0) -> Path:
    """The `stage_urban` case driven through an open x boundary: ``&BC
    BCxm = BCxT = BCxq = BCxs = 3`` (driver inlet, convective outlet) and
    ``&DRIVER idriver = 2, driverjobnr = 900, lchunkread, chunkread_size =
    chunk, driverstore = nt``, with `driver_planes(n, nt, dtdriver)` written
    as the reference's ``?driver_*.900`` files and their mean u profile as the
    start profile of prof.inp.  Its own directory, generated once:
    ``root/urban{n}drv`` (``root/urban{n}drv_nt{nt}_chunk{chunk}_dt{dtdriver}``
    for other than the default series of 120 records 1 s apart read 16 at a
    time).  With the inflow's 5 to 8 m/s in 1 m cells the adaptive step is
    about 0.05 s, so a run of tens of steps crosses a window only with
    records closer than 1 s."""
    name = f"urban{n}drv" if (nt, chunk, dtdriver) == (120, 16, 1.0) \
        else f"urban{n}drv_nt{nt}_chunk{chunk}_dt{dtdriver:g}"
    assert _NAMELIST.count("&BC\n") == 1
    namelist = _NAMELIST.replace("&BC\n", _DRIVEN_BC) + _DRIVER_NAMELIST

    def write_planes(case):
        t, planes = driver_planes(n, nt, dtdriver)
        write_driver_files(case, "900", t, planes, n, n)
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
    return _stage(n, Path(root) / name, False, namelist, before=write_planes,
                  nt=nt, chunk=chunk)


def stage_precursor(n: int, root, dtdriver: float = 0.5) -> Path:
    """A flat neutral ABL (rough floor, -1e-4 pressure gradient, u = 1 m/s)
    of n^3 1 m cells under ``root/flat{n}pre``, twice: experiment 901 is
    periodic and records its inlet planes every `dtdriver` seconds
    (``idriver = 1``, ``iplane = n``: the last u face, which wraps to the
    first), experiment 902 has a ``BCxm = 3`` driver inlet that replays
    experiment 901's ``?driver_*`` files.  Step 901 with a
    ``sim.DriverRecorder`` writing into the directory, then load 902."""
    case = Path(root) / f"flat{n}pre"
    if (case / f"namoptions.{REPLAY_EXPNR}").exists():
        return case
    case.mkdir(parents=True, exist_ok=True)
    z = np.arange(n) + 0.5
    record = f"idriver = 1\ntdriverstart = 0.\ndtdriver = {dtdriver:g}\n" \
             f"iplane = {n}\n"
    replay = f"idriver = 2\ndriverjobnr = {PRECURSOR_EXPNR}\n" \
             f"tdriverstart = 0.\n"
    for expnr, bc, driver in ((PRECURSOR_EXPNR, "", record),
                              (REPLAY_EXPNR, _DRIVEN_BC[4:], replay)):
        with open(case / f"prof.inp.{expnr}", "w") as f:
            f.write("# flat neutral ABL\n# z thl qt u v tke\n")
            for zk in z:
                f.write(f"{zk:14.6f} {288.0:12.4f} {0.0:12.6f} {1.0:12.4f} "
                        f"{0.0:12.4f} {5e-5:12.6f}\n")
        with open(case / f"lscale.inp.{expnr}", "w") as f:
            f.write("# flat neutral ABL\n# z ug vg pgx pgy wfls dqtdx dqtdy "
                    "dqtdt dthlrad\n")
            for zk in z:
                f.write(f"{zk:14.6f} 0. 0. {1e-4:.8f} 0. 0. 0. 0. 0. 0.\n")
    # the replay namelist is written last: it marks the case as staged
    for expnr, bc, driver in ((PRECURSOR_EXPNR, "", record),
                              (REPLAY_EXPNR, _DRIVEN_BC[4:], replay)):
        (case / f"namoptions.{expnr}").write_text(_FLAT_NAMELIST.format(
            n=n, expnr=expnr, bc=bc, driver=driver))
    return case


def _stage(n: int, case: Path, with_radiation: bool, namelist: str,
           before=None, **values) -> Path:
    """Stage the cube array under `case` unless its namelist, which is
    written last, exists.  `before(case)` writes further inputs."""
    nam = case / "namoptions.900"
    if nam.exists():
        return case
    case.mkdir(parents=True, exist_ok=True)
    pitch = n / 4.0
    create_cubes(float(n), float(n), pitch / 2, pitch / 2, pitch,
                 pitch / 2, pitch / 2, "AC",
                 edgelength=pitch / 2).save(case / "geom.stl")
    counts = prepare_case(case / "geom.stl", case, PrepConfig(
        itot=n, jtot=n, ktot=n, xlen=float(n), ylen=float(n),
        zsize=float(n), expnr="900", u0=1.5, thl0=290.0, facT0=295.0,
        with_radiation=with_radiation, vf_subdiv=1))
    walls = "\n".join(
        [f"nfcts = {counts['nfcts']}"]
        + [f"nsolpts_{w} = {counts[f'nsolpts_{w}']}" for w in "uvwc"]
        + [f"nbndpts_{w} = {counts[f'nbndpts_{w}']}" for w in "uvwc"]
        + [f"nfctsecs_{w} = {counts[f'nfctsecs_{w}']}" for w in "uvwc"])
    if before is not None:
        before(case)
    nam.write_text(namelist.format(n=n, walls=walls, **values))
    return case
