"""Open (inflow/outflow) lateral boundaries (port of
``udales_tpu.ops.openbc``).

The reference's non-periodic x machinery and its y mirror:
  - profile inlet `xmi_profile`/`xTi_profile`/... (modboundary.f90:688-905)
  - driver inlet `xmi_driver` etc. with time-interpolated precursor planes
    (moddriver.f90 readdriverfile/drivergen)
  - convective outlet `xmo_convective` etc. (modboundary.f90:908-996):
    the ie+1 ghost planes (and the extra outlet u face) are *prognostic*,
    advected out with d()/dt + uouttot d()/dx = 0
  - projected-velocity BCs `bcpup` (modboundary.f90:1247-1305).

State: the outlet planes live in an `XPlanes` / `YPlanes` dataclass carried
by each Fields set (c and m evolve separately, like the reference's u0/um
ghosts).

The time lookup of both driver modes picks its two records with
``index_select`` on a 1-element index tensor: indexing with a 0-d device
tensor would read the index back to the host and stall the step.

On a rank's block of an x/y split (``Grid.block``) the inlet planes and
driver series are the block's y rows (``ycut_series``), and a plane at a
global x index comes from the rank that holds it (``x_planes``), chosen by
Python integers fixed at load, never by a device value.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import BC_DRIVER, BC_PROFILE, Config
from ..grid import Grid
from ..io import hdf5

BC_RECYCLE = 5  # rescale-recycle inlet (modinlet.f90 inletgen, Lund 1998)


@dataclass(frozen=True)
class XPlanes:
    """Outlet (x = xlen) boundary planes."""
    u: torch.Tensor    # (ny, nz)   u face at x=nx (prognostic, tstep:262-264)
    v: torch.Tensor    # (ny, nz)   v ghost at ie+1
    w: torch.Tensor    # (ny, nz+1) w ghost at ie+1
    thl: torch.Tensor  # (ny, nz)
    qt: torch.Tensor   # (ny, nz)
    e12: torch.Tensor  # (ny, nz)
    sv: torch.Tensor   # (nsv, ny, nz)


def init_xplanes(fields, grid: Grid) -> XPlanes:
    """Outlet planes from the last interior column."""
    return XPlanes(u=fields.u[-1], v=fields.v[-1], w=fields.w[-1],
                   thl=fields.thl[-1], qt=fields.qt[-1], e12=fields.e12[-1],
                   sv=fields.sv[:, -1])


def _bracket(t, timee):
    """Clamped record index (1-element tensor) and weight of the linear
    interpolation in the series `t` at `timee`, without a host read."""
    idx = torch.clamp(
        torch.searchsorted(t, timee.to(t.dtype).reshape(1), right=True) - 1,
        0, t.shape[0] - 2)
    t0 = t.index_select(0, idx)[0]
    t1 = t.index_select(0, idx + 1)[0]
    a = torch.clamp((timee - t0) / torch.clamp(t1 - t0, min=1e-12), 0.0, 1.0)
    return idx, a


def _lerp(f, idx, a):
    return (1.0 - a) * f.index_select(0, idx)[0] \
        + a * f.index_select(0, idx + 1)[0]


def tile_profile(prof, n: int):
    """(nz,) profile -> (n, nz) plane (a broadcast view)."""
    return prof[None, :].expand(n, prof.shape[0])


def sv_planes(svprof, n: int, nz: int, like):
    """(nsv, nz) scalar profiles -> (nsv, n, nz) planes; (0, n, nz) zeros of
    `like`'s dtype and device where there are none."""
    if svprof is not None and svprof.shape[0]:
        return svprof[:, None, :].expand(svprof.shape[0], n, nz)
    return torch.zeros((0, n, nz), dtype=like.dtype, device=like.device)


@dataclass(frozen=True)
class Inlet:
    """Static or time-interpolated inlet condition.  For BC_PROFILE the
    planes are z-profiles broadcast along y; for BC_DRIVER they are (j, k)
    planes interpolated in time from a recorded series."""
    mode: int
    uprof: Optional[torch.Tensor] = None      # (nz,)
    vprof: Optional[torch.Tensor] = None
    thlprof: Optional[torch.Tensor] = None
    qtprof: Optional[torch.Tensor] = None
    e12prof: Optional[torch.Tensor] = None
    svprof: Optional[torch.Tensor] = None     # (nsv, nz)
    # driver series
    t: Optional[torch.Tensor] = None          # (nt,)
    u: Optional[torch.Tensor] = None          # (nt, ny, nz)
    v: Optional[torch.Tensor] = None
    w: Optional[torch.Tensor] = None          # (nt, ny, nz+1)
    thl: Optional[torch.Tensor] = None
    qt: Optional[torch.Tensor] = None
    sv: Optional[torch.Tensor] = None         # (nt, nsv, ny, nz)
    # recycle inlet
    irecy: int = 0         # recycle plane index (reference irecy=ib+iplane)

    def planes(self, timee, ny: int, nz: int):
        """Dict of inlet planes at time `timee` (linear interpolation for
        driver mode, moddriver.f90 drivergen idriver==2)."""
        if self.mode == BC_PROFILE:
            up = self.uprof
            return dict(
                u=tile_profile(up, ny), v=tile_profile(self.vprof, ny),
                w=torch.zeros((ny, nz + 1), dtype=up.dtype, device=up.device),
                thl=tile_profile(self.thlprof, ny),
                qt=tile_profile(self.qtprof, ny),
                e12=tile_profile(self.e12prof, ny),
                sv=sv_planes(self.svprof, ny, nz, up))
        # driver: clamp + lerp
        idx, a = _bracket(self.t, timee)
        lerp = lambda f: _lerp(f, idx, a)
        # thl/qt planes are absent for neutral/dry precursors (the reference
        # only writes h/qdriver under ltempeq&lhdriver / lmoist&lqdriver,
        # moddriver.f90:885-920): zeros of the u-plane shape
        zero = lambda: torch.zeros(self.u.shape[1:], dtype=self.u.dtype,
                                   device=self.u.device)
        return dict(u=lerp(self.u), v=lerp(self.v), w=lerp(self.w),
                    thl=lerp(self.thl) if self.thl is not None else zero(),
                    qt=lerp(self.qt) if self.qt is not None else zero(),
                    sv=(lerp(self.sv) if self.sv is not None
                        else torch.zeros((0,) + self.u.shape[1:],
                                         dtype=self.u.dtype,
                                         device=self.u.device)),
                    e12=None)


@dataclass(frozen=True)
class DriverWindow:
    """Rolling device window of a precursor driver series (the lchunkread
    equivalent, moddriver.f90:933).  Carried as a State leaf; the host swaps
    chunks between steps and every leaf keeps a fixed shape
    (W = chunkread_size records)."""
    t: torch.Tensor     # (W,) record times
    u: torch.Tensor     # (W, ny, nz)
    v: torch.Tensor     # (W, ny, nz)
    w: torch.Tensor     # (W, ny, nz+1)
    thl: torch.Tensor   # (W, ny, nz)  zeros if the precursor wrote no hdriver
    qt: torch.Tensor    # (W, ny, nz)
    sv: torch.Tensor    # (W, nsv, ny, nz)


def driver_window_planes(drv: DriverWindow, timee):
    """Inlet planes at `timee` from the current window (clamp + lerp, the
    drivergen interpolation of moddriver.f90 idriver==2)."""
    idx, a = _bracket(drv.t, timee)
    a = a.to(drv.u.dtype)
    lerp = lambda f: _lerp(f, idx, a)
    return dict(u=lerp(drv.u), v=lerp(drv.v), w=lerp(drv.w),
                thl=lerp(drv.thl), qt=lerp(drv.qt), sv=lerp(drv.sv),
                e12=None)


def x_planes(grid: Grid, pairs):
    """The y-z planes ``f[i]`` of (field, global x index i) `pairs`.  On a
    block of a split (``grid.mesh``), each from the rank of this rank's x
    row that holds it, in one all-reduce (this rank's y rows).  `grid` may
    be None: a whole domain."""
    mesh = None if grid is None else grid.mesh
    if mesh is None:
        return [f[i] for f, i in pairs]
    parts = []
    for f, i in pairs:
        owner, il = divmod(i, grid.itot)
        parts.append(f[il] if owner == mesh.cx else
                     torch.zeros(f.shape[1:], dtype=f.dtype, device=f.device))
    return mesh.axis_sum(parts, "x")


def y_means(grid: Grid, planes):
    """The means along their first (y) axis of (ny, ...) `planes`; on a
    block of a split, of the domain's y rows (one sum over the y column).
    `grid` may be None: a whole domain."""
    mesh = None if grid is None else grid.mesh
    if mesh is None:
        return [p.mean(dim=0) for p in planes]
    sums = mesh.axis_sum([p.sum(dim=0) for p in planes], "y")
    return [s / grid.global_shape[1] for s in sums]


def recycle_planes(inlet: Inlet, c, ny: int, nz: int, grid: Grid = None):
    """Rescale-recycle inlet (compact Lund-1998, modinlet.f90 inletgen:202):
    the inlet plane is the target mean profile plus the de-meaned
    fluctuations sampled at the recycle plane.  The inner/outer
    boundary-layer-thickness blending of the reference is condensed to a
    uniform rescale, which keeps its two essential properties (target mean,
    recycled turbulence); ``ops.inletgen`` is the full generator.  On a
    block of a split (`grid`), the recycle plane comes from the rank that
    holds it and its means are the domain's."""
    ir = inlet.irecy % (c.u.shape[0] if grid is None else grid.global_shape[0])
    pl = x_planes(grid, [(f, ir) for f in (c.u, c.v, c.w, c.thl, c.qt)])
    pl = [p - m[None] for p, m in zip(pl, y_means(grid, pl))]
    return dict(
        u=tile_profile(inlet.uprof, ny) + pl[0],
        v=tile_profile(inlet.vprof, ny) + pl[1],
        w=pl[2],
        thl=tile_profile(inlet.thlprof, ny) + pl[3],
        qt=tile_profile(inlet.qtprof, ny) + pl[4],
        e12=tile_profile(inlet.e12prof, ny),
        sv=sv_planes(inlet.svprof, ny, nz, c.u))


def _outflow_velocity(fixed: bool, flowrate: float, av, grid: Grid):
    if fixed:
        return torch.full((), flowrate, dtype=av.dtype, device=av.device)
    dzf = grid.t("dzf", av.device)
    return torch.sum(av * dzf) / float(grid.zh[-1] - grid.zh[1])


def uouttot_value(cfg: Config, u0av, grid: Grid):
    """Outflow advection velocity (modboundary.f90:142-161)."""
    return _outflow_velocity(cfg.physics.luvolflowr, cfg.physics.uflowrate,
                             u0av, grid)


def vouttot_value(cfg: Config, v0av, grid: Grid):
    """Outflow advection velocity for open-y (y mirror of uouttot)."""
    return _outflow_velocity(cfg.physics.lvvolflowr, cfg.physics.vflowrate,
                             v0av, grid)


@dataclass(frozen=True)
class YPlanes:
    """Outlet (y = ylen) boundary planes, the y mirror of XPlanes
    (ymo_convective and friends, modboundary.f90:1100-1190)."""
    u: torch.Tensor    # (nx, nz)   u ghost at je+1
    v: torch.Tensor    # (nx, nz)   v face at y=ny (prognostic)
    w: torch.Tensor    # (nx, nz+1) w ghost at je+1
    thl: torch.Tensor
    qt: torch.Tensor
    e12: torch.Tensor
    sv: torch.Tensor   # (nsv, nx, nz)


def init_yplanes(fields, grid: Grid) -> YPlanes:
    return YPlanes(u=fields.u[:, -1], v=fields.v[:, -1], w=fields.w[:, -1],
                   thl=fields.thl[:, -1], qt=fields.qt[:, -1],
                   e12=fields.e12[:, -1], sv=fields.sv[:, :, -1])


def convect_planes_y(by: YPlanes, fields, grid: Grid, rk3coef, vouttot,
                     inlet_planes) -> YPlanes:
    """Convective outlet update in y (ymo/yTo/yqo/yso_convective,
    modboundary.f90:1100-1190)."""
    fac = grid.dyi * rk3coef * vouttot
    cv = lambda g, i: g - (g - i) * fac
    return YPlanes(
        u=cv(by.u, fields.u[:, -1]),
        v=by.v,
        w=cv(by.w, fields.w[:, -1]),
        thl=cv(by.thl, fields.thl[:, -1]),
        qt=cv(by.qt, fields.qt[:, -1]),
        e12=cv(by.e12, fields.e12[:, -1]),
        sv=cv(by.sv, fields.sv[:, :, -1]) if by.sv.shape[0] else by.sv,
    )


def pad_x_open(f, lo_plane, hi_plane, h: int = 1):
    """Pad axis 0 with explicit ghost planes (each (ny[,+halo], nz...))."""
    return torch.cat([*([lo_plane[None]] * h), f, *([hi_plane[None]] * h)],
                     dim=0)


def ycut_series(d: dict, rows):
    """The y rows `rows` (a slice; None: all) of a dict of recorded series:
    u, v, w, thl, qt (nt, ny, nz[+1]) and sv (nt, nsv, ny, nz); ``t`` and
    anything else unchanged."""
    if rows is None:
        return d
    out = dict(d)
    for k in ("u", "v", "w", "thl", "qt"):
        if out.get(k) is not None:
            out[k] = out[k][:, rows]
    if out.get("sv") is not None:
        out["sv"] = out["sv"][:, :, rows]
    return out


def load_driver_inlet(path, dtype, device="cuda", rows=None) -> Inlet:
    """Load a recorded precursor-plane series (the h5 format written by
    ``sim.DriverRecorder``; the reference's per-y-rank unformatted ?driver
    files are the Fortran equivalent, moddriver.f90:515/750).  `dtype` is a
    torch dtype; `rows` the y rows of a split Model's block (None: all)."""
    d = ycut_series(dict(hdf5.read(path)), rows)
    get = lambda k: (torch.as_tensor(np.ascontiguousarray(d[k]), dtype=dtype,
                                     device=device) if k in d else None)
    return Inlet(mode=BC_DRIVER, t=get("t"), u=get("u"), v=get("v"),
                 w=get("w"), thl=get("thl"), qt=get("qt"), sv=get("sv"))


def convect_planes(bx: XPlanes, fields, grid: Grid, rk3coef, uouttot,
                   inlet_planes) -> XPlanes:
    """Convective outlet update (xmo/xTo/xqo/xso_convective,
    modboundary.f90:908-996): ghost -= (ghost - interior_last) * dxi *
    rk3coef * uouttot.  The outlet u face itself is integrated in the main
    update; here only the ghost planes advect."""
    fac = grid.dxi * rk3coef * uouttot
    cv = lambda g, i: g - (g - i) * fac
    return XPlanes(
        u=bx.u,
        v=cv(bx.v, fields.v[-1]),
        w=cv(bx.w, fields.w[-1]),
        thl=cv(bx.thl, fields.thl[-1]),
        qt=cv(bx.qt, fields.qt[-1]),
        e12=cv(bx.e12, fields.e12[-1]),
        sv=cv(bx.sv, fields.sv[:, -1]) if bx.sv.shape[0] else bx.sv,
    )
