"""Case staging: the urban building-array case of ``bench.py``, plain and
with the facet energy balance.

``stage_urban(n, root)`` writes the same case directory as
``bench._stage_urban(n)`` (``root/urban{n}v2``, experiment ``900``): a 4x4
aligned cube array at lambda_p = 0.25 with H = n/4 m, generated by the
port's own host-side NumPy preprocessing (``udales_tpu_torch.prep``), plus
the namelist.  The files are byte-identical to the JAX package's.

``stage_urban_eb(n, root)`` stages the same array with the radiation inputs
(view factors, sky view factors, net shortwave) and a namelist that
switches the facet energy balance on (``root/urban{n}eb``).
"""
from __future__ import annotations

from pathlib import Path

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


def _stage(n: int, case: Path, with_radiation: bool, namelist: str,
           **values) -> Path:
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
    nam.write_text(namelist.format(n=n, walls=walls, **values))
    return case
