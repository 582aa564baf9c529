"""Case staging: the urban building-array case of ``bench.py``.

``stage_urban(n, root)`` writes the same case directory as
``bench._stage_urban(n)`` (``root/urban{n}v2``, experiment ``900``): a 4x4
aligned cube array at lambda_p = 0.25 with H = n/4 m, generated by the
port's own host-side NumPy preprocessing (``udales_tpu_torch.prep``), plus
the namelist.  The files are byte-identical to the JAX package's.
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


def stage_urban(n: int, root) -> Path:
    """Generate (once; an existing namelist is reused) the n^3 urban case
    under `root` and return its directory.  Heated facets (facT0 = 295 K,
    iwalltemp = 2), Vreman, buoyancy, fixed volume flow rate 1.5 m/s."""
    case = Path(root) / f"urban{n}v2"
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
        zsize=float(n), expnr="900", u0=1.5, thl0=290.0, facT0=295.0))
    walls = "\n".join(
        [f"nfcts = {counts['nfcts']}"]
        + [f"nsolpts_{w} = {counts[f'nsolpts_{w}']}" for w in "uvwc"]
        + [f"nbndpts_{w} = {counts[f'nbndpts_{w}']}" for w in "uvwc"]
        + [f"nfctsecs_{w} = {counts[f'nfctsecs_{w}']}" for w in "uvwc"])
    nam.write_text(_NAMELIST.format(n=n, walls=walls))
    return case
