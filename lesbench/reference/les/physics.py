"""The air-quality physics of the reference: scalar sources, the NO-NO2-O3
chemistry and the tree canopy, in plain PyTorch, written for the benchmark
from the equations that the measured package's docstrings cite for uDALES
(``src/modscalsource.f90:385-484``, ``src/modchem.f90:29-77``,
``src/vegetation.f90:351-437``).  Its code is not the package's, but its
reading of those routines is: the Fortran was not at hand, and every
choice listed under "Departures" below is the package's own.  So it is
independent of the package only as far as the analytic oracles of
``lesbench/tests/test_lesbench_air.py`` reach (moles kept, the
photostationary state and the explicit limit of the chemistry; the 3 sigma
support, linearity, symmetry and line integral of the sources; the drag
and deposition of a uniform flow).  A place where the package departs from
uDALES in these layers and the oracles cannot see, such as the linearised
chemistry below, this module shares.

Scalar sources.  A source adds a tendency that is constant in time, so the
field is built once, in float64, when the case is loaded.  A point source
of strength SS and width sigma at s adds to the cell at x

    SS exp(-|x - s|^2 / (2 sigma^2)) / (dx dy dz_k),  |x - s| <= 3 sigma,

and nothing beyond.  A line source is that kernel spread along a segment
with SS per unit length: integrating the truncated kernel along the line
through the cell's foot gives, at a distance r from the line,

    SS sqrt(2 pi) sigma exp(-r^2 / (2 sigma^2))
       erf(sqrt(9 sigma^2 - r^2) / (sqrt(2) sigma))

per unit volume of the cell, where r <= 3 sigma.  A cell whose foot lies
beyond an end of the segment takes r from that end (a line across the
whole domain has no such cell).  Neither kind
wraps around a periodic boundary.  SS is the kernel's peak, not its
integral: the case files state it so.

Chemistry.  The null cycle NO + O3 -> NO2 (k1), NO2 + hv -> NO + O3
(JNO2) on the molar concentrations c = sv / M of the first three scalars,
once a full step on the fields the third substep has integrated, over the
step's dt.  Backward Euler for the moles d that turn from NO2 into NO,

    d = dt (JNO2 (c2 - d) - k1 (c1 + d) (c3 + d)),

is taken to first order in d (the k1 d^2 term, second order in dt, is
left out, as the package leaves it out), so

    d = dt (JNO2 c2 - k1 c1 c3) / (1 + dt (JNO2 + k1 (c1 + c3))),

and NO + NO2 and NO2 + O3 keep their moles exactly.  The concentrations
that set d are taken in the fluid only (times the fluid mask): in a solid
cell d is 0.

Canopy.  Every tree cell has a leaf area density lad, a drag coefficient
cd and a deposition velocity ud.  The momentum drag is quadratic at each
velocity face,

    du/dt -= <lad cd> u |U|,

with <lad cd> the mean of the two cells the face divides (periodic in x
and y; 0 at the floor and top w faces) and |U| the speed at the face, the
other two components averaged from their four nearest faces.  Scalars
deposit on the leaves, dsv/dt -= lad ud sv.  Both act on the fields of
the step's start (``m``, the reference's um and svm), as ibmnorm leaves
them.

Departures and choices, each the same as the measured package's, none
checked against the Fortran:

- the chemistry is the linearised backward Euler above, not the fully
  implicit update (the package's docstring calls it fully implicit);
- a line source is the point kernel integrated along the line (the erf
  form above), and a cell beyond a segment's end takes r from the nearer
  end;
- no source wraps around a periodic side, and the face coefficients of
  the canopy wrap in x and y whatever the lateral boundary;
- the order in the substep, which the equations do not fix: the canopy
  after ibmnorm, the sources after it, both before the projection, the
  chemistry after the third substep's integrate.

The canopy's energy balance (``sveg``, moist runs), the road-network
sources (``lscasrcr``), purifiers and heat pumps are not here, and
``run._unsupported`` refuses a case that asks for them.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

# molar masses of NO, NO2 and O3 (g/mol), as modchem.f90 states them
M_NO, M_NO2, M_O3 = 30.006, 46.005, 47.997


# -- scalar sources -----------------------------------------------------------

def _centres(grid, device):
    """The cell centres' x, y, z as (nx, 1, 1), (1, ny, 1), (1, 1, nz)
    float64 tensors."""
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    return (f(grid.xf)[:, None, None], f(grid.yf)[None, :, None],
            f(grid.zf)[None, None, :])


def point_kernel(r2, sigma: float):
    """The truncated point kernel at squared distances `r2`, per unit
    strength."""
    s2 = sigma * sigma
    return torch.where(r2 <= 9.0 * s2, torch.exp(-r2 / (2.0 * s2)),
                       torch.zeros_like(r2))


def line_kernel(r2, sigma: float):
    """The truncated point kernel integrated along a line, at squared
    distances `r2` from the line, per unit strength and length."""
    s2 = sigma * sigma
    reach = torch.sqrt(torch.clamp(9.0 * s2 - r2, min=0.0) / (2.0 * s2))
    val = (math.sqrt(2.0 * math.pi) * sigma * torch.exp(-r2 / (2.0 * s2))
           * torch.special.erf(reach))
    return torch.where(r2 <= 9.0 * s2, val, torch.zeros_like(r2))


def source_field(grid, points, lines, device="cpu") -> torch.Tensor:
    """The sources' tendency (nsv, nx, ny, nz) in float64.  `points[n]` are
    scalar n's point sources, rows (x, y, z, SS, sigma); `lines[n]` its line
    sources, rows (xb, yb, zb, xe, ye, ze, SS, sigma); either may be None."""
    X, Y, Z = _centres(grid, device)
    dz = torch.as_tensor(np.asarray(grid.dzf, np.float64), device=device)
    inv_vol = 1.0 / (grid.dx * grid.dy * dz[None, None, :])
    nsv = len(points if points is not None else lines)
    out = torch.zeros((nsv, grid.itot, grid.jtot, grid.ktot),
                      dtype=torch.float64, device=device)
    for n in range(nsv):
        for x, y, z, ss, sig in (points[n] if points is not None else []):
            r2 = (X - x) ** 2 + (Y - y) ** 2 + (Z - z) ** 2
            out[n] += ss * point_kernel(r2, sig)
        for xb, yb, zb, xe, ye, ze, ss, sig in (lines[n] if lines is not None
                                                else []):
            ax, ay, az = xe - xb, ye - yb, ze - zb
            along = ((X - xb) * ax + (Y - yb) * ay + (Z - zb) * az) \
                / (ax * ax + ay * ay + az * az)
            t = torch.clamp(along, 0.0, 1.0)
            r2 = ((X - xb - t * ax) ** 2 + (Y - yb - t * ay) ** 2
                  + (Z - zb - t * az) ** 2)
            out[n] += ss * line_kernel(r2, sig)
    return out * inv_vol


def read_sources(case_dir, expnr: str, cfg):
    """(points, lines) of a case: for each scalar the first ``nscasrc``
    rows of ``scalarsourcep.inp.<n>.<expnr>`` and the first ``nscasrcl``
    of ``scalarsourcel.inp.<n>.<expnr>`` (two header lines each), where
    the switch is on."""
    sc = cfg.scalars
    case_dir = Path(case_dir)

    def rows(stem, count, width):
        out = []
        for n in range(1, sc.nsv + 1):
            text = (case_dir / f"{stem}.inp.{n}.{expnr}").read_text()
            vals = [[float(v) for v in line.split()]
                    for line in text.splitlines()[2:] if line.strip()]
            if len(vals) < count or any(len(v) != width for v in vals):
                raise ValueError(f"{stem}.inp.{n}.{expnr}: {count} rows of "
                                 f"{width} values expected")
            out.append(vals[:count])
        return out
    points = (rows("scalarsourcep", sc.nscasrc, 5)
              if sc.lscasrc and sc.nscasrc > 0 else None)
    lines = (rows("scalarsourcel", sc.nscasrcl, 8)
             if sc.lscasrcl and sc.nscasrcl > 0 else None)
    return points, lines


# -- chemistry ----------------------------------------------------------------

def chemistry(sv, dt, k1: float, jno2: float, fluid=1.0):
    """The first three scalars `sv` (NO, NO2, O3 in mass units, first axis)
    after one full step `dt` (a number or a 0-d tensor) of the null cycle;
    `fluid` is the fluid mask (or 1).  Scalars past the third pass
    through.  Returns a new tensor."""
    c_no = fluid * sv[0] / M_NO
    c_no2 = fluid * sv[1] / M_NO2
    c_o3 = fluid * sv[2] / M_O3
    d = dt * (jno2 * c_no2 - k1 * c_no * c_o3) \
        / (1.0 + dt * (jno2 + k1 * (c_no + c_o3)))
    out = sv.clone()
    out[0] = sv[0] + M_NO * d
    out[1] = sv[1] - M_NO2 * d
    out[2] = sv[2] + M_O3 * d
    return out


# -- canopy -------------------------------------------------------------------

class Canopy:
    """Drag and deposition of the tree cells.  `lad`, `cd`, `ud` are
    (nx, ny, nz) arrays, zero outside the trees; the face coefficients are
    made from them once, in float64, then held in `dtype` on `device`."""

    def __init__(self, lad, cd, ud, dtype=torch.float64, device="cpu"):
        f = lambda a: torch.as_tensor(np.asarray(a, np.float64))
        a = f(lad) * f(cd)
        nz = a.shape[2]
        face_x = 0.5 * (a + torch.roll(a, 1, dims=0))
        face_y = 0.5 * (a + torch.roll(a, 1, dims=1))
        face_z = torch.zeros(a.shape[:2] + (nz + 1,), dtype=torch.float64)
        face_z[:, :, 1:nz] = 0.5 * (a[:, :, 1:] + a[:, :, :-1])
        put = lambda t: t.to(dtype=dtype, device=device)
        self.face_x, self.face_y, self.face_z = (put(face_x), put(face_y),
                                                 put(face_z))
        self.deposition = put(f(lad) * f(ud))

    @classmethod
    def load(cls, case_dir, expnr: str, shape, dtype, device):
        """The canopy of ``veg.inp.<expnr>`` (a header line, then the tree
        cells' 1-based i j k and, optionally, a parameter id) and
        ``veg_params.inp.<expnr>`` (a header line, then rows id lad cd ud
        dec lsize rs; a cell without an id takes the first row's)."""
        case_dir = Path(case_dir)
        cells = np.loadtxt(case_dir / f"veg.inp.{expnr}", skiprows=1,
                           dtype=np.int64, ndmin=2)
        params = np.loadtxt(case_dir / f"veg_params.inp.{expnr}",
                            skiprows=1, ndmin=2)
        by_id = {int(r[0]): r for r in params}
        lad, cd, ud = (np.zeros(shape) for _ in range(3))
        for row in cells:
            p = by_id[int(row[3])] if len(row) > 3 else params[0]
            i, j, k = row[:3] - 1
            lad[i, j, k], cd[i, j, k], ud[i, j, k] = p[1], p[2], p[3]
        return cls(lad, cd, ud, dtype, device)

    def forcing(self, m, du, dv, dw, dsv):
        """(du, dv, dw, dsv) with the drag on the velocity of `m` (u, v on
        (nx, ny, nz), w on (nx, ny, nz + 1)) and the deposition of its
        scalars added."""
        u, v, w = m.u, m.v, m.w
        east = lambda t: torch.roll(t, -1, dims=0)   # the i + 1 neighbour
        west = lambda t: torch.roll(t, 1, dims=0)    # the i - 1 neighbour
        north = lambda t: torch.roll(t, -1, dims=1)
        south = lambda t: torch.roll(t, 1, dims=1)
        w_mid = 0.5 * (w[..., :-1] + w[..., 1:])     # w at the cell's height
        # at the u face (i - 1/2, j, k)
        v_u = 0.25 * (v + north(v) + west(v) + west(north(v)))
        w_u = 0.5 * (w_mid + west(w_mid))
        du = du - self.face_x * u * torch.sqrt(u * u + v_u * v_u + w_u * w_u)
        # at the v face (i, j - 1/2, k)
        u_v = 0.25 * (u + east(u) + south(u) + south(east(u)))
        w_v = 0.5 * (w_mid + south(w_mid))
        dv = dv - self.face_y * v * torch.sqrt(v * v + u_v * u_v + w_v * w_v)
        # at the interior w faces (i, j, k - 1/2), k = 1 .. nz - 1
        u_c = 0.5 * (u + east(u))                    # u at the cell's centre
        v_c = 0.5 * (v + north(v))
        u_w = 0.5 * (u_c[..., 1:] + u_c[..., :-1])
        v_w = 0.5 * (v_c[..., 1:] + v_c[..., :-1])
        wi = w[..., 1:-1]
        dw = dw.clone()
        dw[..., 1:-1] -= self.face_z[..., 1:-1] * wi \
            * torch.sqrt(wi * wi + u_w * u_w + v_w * v_w)
        if dsv.shape[0] > 0:
            dsv = dsv - self.deposition[None] * m.sv
        return du, dv, dw, dsv
