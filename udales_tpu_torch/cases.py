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

``stage_urban_dispersion(n, root)`` stages the same array as an air-quality
case: traffic NOx from line sources in the street canyons and a rooftop
stack, NO-NO2-O3 chemistry over an ozone background, trees in the canyons,
and optionally purifiers, roof heat pumps and the one-equation closure
(``root/urban{n}disp...``).

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

# the air-quality additions of `stage_urban_dispersion`: three kappa-advected
# scalars (NO, NO2, O3) with line and point sources, the null cycle with the
# rate constants of tests/test_physics.py, and trees (VegParams' defaults)
_DISP_NAMELIST = """&SCALARS
nsv = 3
lscasrcl = .true.
nscasrcl = {nlines}
lscasrc = .true.
nscasrc = 1
/
&CHEMISTRY
lchem = .true.
k1 = 4.7e-4
JNO2 = 8.9e-3
/
&TREES
ltrees = .true.
/
"""
_PURIFS_NAMELIST = """&PURIFS
lpurif = .true.
npurif = 2
Qpu = {Qpu:g}
epu = 0.9
/
"""
_HEATPUMP_NAMELIST = """&HEATPUMP
lheatpump = .true.
lfan_hp = .true.
nhppoints = {nhp}
QH_dot_hp = {QH:g}
Q_dot_hp = {Q:g}
/
"""
# scalar source strengths of NO per line and of the rooftop stack; NO2 gets
# 10% of NO's, O3 none; the ozone background of scalar.inp
NO_LINE, NO_STACK, NO2_SHARE, O3_BACKGROUND = 1.0, 5.0, 0.1, 80.0


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


def _dispersion_layout(n: int) -> dict:
    """The placement of the air-quality features on the n^3 cube array
    (cube pitch p = n/4, cubes p/2 wide and p tall, canyons p/2 wide; 1 m
    cells): line sources along y at z = 1 m with sigma = 1 m in the street
    canyons centred at x = p, 2p, 3p and at x = n - p/8 (the fourth canyon
    straddles x = 0, so its line sits in the canyon's inner half); a
    rooftop stack 2 m above the first cube; tree blocks (1-based cell
    boxes) half a canyon wide beside every cube of the three inner canyons,
    from p/8 to p/2 high; two purifier boxes at canyon crossings, blowing
    +x (ipu 1) and +y (ipu 3), 2 cells high; eight heat pumps on the roofs
    of the cubes of the first two rows (0-based cells)."""
    p = n // 4
    half = max(1, p // 8)
    lines = [(float(xc), 0.0, 1.0, float(xc), float(n), 1.0, NO_LINE, 1.0)
             for xc in (p, 2 * p, 3 * p, n - p / 8)]
    stack = [(p / 2, p / 2, p + 2.0, NO_STACK, 1.0)]
    kl, ku = max(1, p // 8), max(1, p // 2 - 1)
    trees = [(xc - half + 1, xc + half, cy - half + 1, cy + half, kl + 1,
              ku + 1)
             for xc in (p, 2 * p, 3 * p)
             for cy in (p * j - p // 2 for j in range(1, 5))]
    purifs = [(2 * p - half + 1, 2 * p + half, p - half + 1, p + half, 2, 3,
               1),
              (3 * p - half + 1, 3 * p + half, 2 * p - half + 1,
               2 * p + half, 2, 3, 3)]
    heatpumps = [(p * i - p // 2, p * j - p // 2, p)
                 for i in range(1, 5) for j in (1, 2)]
    return dict(lines=lines, stack=stack, trees=trees, purifs=purifs,
                heatpumps=heatpumps, half=half)


def stage_urban_dispersion(n: int, root, *, purifiers: bool = False,
                           heatpumps: bool = False,
                           sgs: str = "vreman") -> Path:
    """The `stage_urban` array as a street-canyon air-quality case, its
    flow and walls unchanged: ``&SCALARS nsv = 3`` (NO, NO2, O3), line
    sources (``lscasrcl``, scalarsourcel.inp.<n>) and one rooftop point
    source (``lscasrc``, scalarsourcep.inp.<n>) on NO, NO2 at 10% of NO's
    strength and O3 with the same sources at strength 0 (prep writes only
    the files of scalar 1; the files of scalars 2 and 3 are written here),
    an O3 background in scalar.inp, ``&CHEMISTRY lchem`` with k1 = 4.7e-4
    and JNO2 = 8.9e-3, and ``&TREES ltrees`` with a trees.inp of blocks in
    the canyons, expanded by prep with VegParams' defaults.  See
    `_dispersion_layout` for where each feature sits.  `purifiers` adds two
    purifier boxes (``&PURIFS``, 0.5 m/s through each box, epu = 0.9),
    `heatpumps` eight roof heat pumps with exhaust fans (``&HEATPUMP``,
    10 kW and 2 m^3/s each), ``sgs="oneeqn"`` the one-equation closure in
    place of Vreman.  Its own directory, generated once:
    ``root/urban{n}disp`` with ``_pu``, ``_hp``, ``_oneeqn`` appended for
    the variants."""
    if sgs not in ("vreman", "oneeqn"):
        raise ValueError(f"sgs must be 'vreman' or 'oneeqn', not {sgs!r}")
    lay = _dispersion_layout(n)
    name = (f"urban{n}disp" + ("_pu" if purifiers else "")
            + ("_hp" if heatpumps else "")
            + ("_oneeqn" if sgs == "oneeqn" else ""))
    case = Path(root) / name
    namelist = _NAMELIST + _DISP_NAMELIST.format(nlines=len(lay["lines"]))
    if sgs == "oneeqn":
        assert namelist.count("lvreman = .true.") == 1
        namelist = namelist.replace("lvreman = .true.", "loneeqn = .true.")
    # one purifier box is 2 half-canyons wide and 2 cells high
    Apu = 2 * lay["half"] * 2.0
    if purifiers:
        namelist += _PURIFS_NAMELIST.format(Qpu=0.5 * Apu)
    nhp = len(lay["heatpumps"])
    if heatpumps:
        namelist += _HEATPUMP_NAMELIST.format(nhp=nhp, QH=1e4 * nhp,
                                              Q=2.0 * nhp)
    zero = lambda rows, col: [r[:col] + (0.0,) + r[col + 1:] for r in rows]
    line_rows = {1: lay["lines"],
                 2: [r[:6] + (NO2_SHARE * r[6],) + r[7:] for r in lay["lines"]],
                 3: zero(lay["lines"], 6)}
    stack_rows = {1: lay["stack"],
                  2: [r[:3] + (NO2_SHARE * r[3],) + r[4:] for r in lay["stack"]],
                  3: zero(lay["stack"], 3)}

    def before(case):
        # the source files of scalars 2 and 3, in prep's layout
        for n_sv in (2, 3):
            for fname, rows, hdr in (
                    ("scalarsourcel", line_rows[n_sv],
                     "#xSb ySb zSb xSe ySe zSe SS sigS"),
                    ("scalarsourcep", stack_rows[n_sv], "#xS yS zS SS sigS")):
                with open(case / f"{fname}.inp.{n_sv}.900", "w") as f:
                    f.write(f"# Scalar source data\n{hdr}\n")
                    for r in rows:
                        f.write(" ".join(f"{v:.6f}" for v in r) + "\n")
        if purifiers:
            with open(case / "purifs.inp.900", "w") as f:
                f.write("# purifiers\n# il iu jl ju kl ku ipu\n")
                for r in lay["purifs"]:
                    f.write(" ".join(f"{v:d}" for v in r) + "\n")
        if heatpumps:
            with open(case / "heatpump.inp.900", "w") as f:
                f.write("# heat pump position (i,j,k)\n")
                for i, j, k in lay["heatpumps"]:
                    f.write(f"{i + 1:7d} {j + 1:7d} {k + 1:7d}\n")

    nam = case / "namoptions.900"
    if nam.exists():
        return case
    case.mkdir(parents=True, exist_ok=True)
    trees = case / "trees.inp.900"
    trees.write_text("# il iu jl ju kl ku\n" + "".join(
        " ".join(str(v) for v in t) + "\n" for t in lay["trees"]))
    extras = dict(nsv=3, sv0=[0.0, 0.0, O3_BACKGROUND, 0.0, 0.0],
                  line_sources=line_rows[1], point_sources=stack_rows[1])
    return _stage(n, case, False, namelist, before=before,
                  prep_kw=dict(trees_file=str(trees)), extras=extras)


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


def _stage(n: int, case: Path, with_radiation: bool, namelist: str,
           before=None, prep_kw=None, extras=None, **values) -> Path:
    """Stage the cube array under `case` unless its namelist, which is
    written last, exists.  `prep_kw` adds to the PrepConfig, `extras` are
    prepare_case's scalar inputs, `before(case)` writes further inputs."""
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
        with_radiation=with_radiation, vf_subdiv=1, **(prep_kw or {})),
        extras)
    walls = "\n".join(
        [f"nfcts = {counts['nfcts']}"]
        + [f"nsolpts_{w} = {counts[f'nsolpts_{w}']}" for w in "uvwc"]
        + [f"nbndpts_{w} = {counts[f'nbndpts_{w}']}" for w in "uvwc"]
        + [f"nfctsecs_{w} = {counts[f'nfctsecs_{w}']}" for w in "uvwc"])
    if before is not None:
        before(case)
    nam.write_text(namelist.format(n=n, walls=walls, **values))
    return case
