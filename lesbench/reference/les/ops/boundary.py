"""Boundary conditions as ghost-cell construction (port of
``udales_tpu.ops.boundary``).

The k ghosts follow the reference's bottom and top rules
(modboundary.f90:115-389 `boundary`, :434 `closurebc`, :1494 `fluxtop`,
:1509 `valuetop`).  Laterally each direction is periodic (the wrap doubles
as the halo exchange, see ops/halo.py) or open: profile/driver inlet and
convective outlet (modboundary.f90:688-996 in x, :1017-1190 in y).  For an
open direction the ghost planes come from a context dict built per substep
(see ops/openbc.py): ``openx = {"inlet": {...interior-k planes...}, "bx":
XPlanes}``, ``openy = {"inlet": {...}, "by": YPlanes}``.  Under an x/y
process split (``parallel.mesh``) the halos of the block come from the
neighbouring ranks (width 2 for the kappa ghosts), and a block edge that is
the domain's open edge takes the plane instead (``split_pad``), in the
corner order of the single-device assembly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..config import (BCTOPM_FREESLIP, BCTOPM_NOSLIP, BCTOPM_PRESSURE,
                      BCTOP_VALUE, BC_PROFILE, Config, const)
from ..grid import Grid
from ..state import Fields
from .halo import pad_axis, pad_edge, pad_wrap, take_k


def _assemble(gk, h, lo_plane, hi_plane):
    """Pad y periodically, then attach explicit x ghost planes (already
    k-ghosted, shape (..., ny, nzg)).  Axes count from the end, so a
    leading stack axis rides along."""
    gy = pad_wrap(gk, -2, h)
    lo = pad_wrap(lo_plane, -2, h).unsqueeze(-3)
    hi = pad_wrap(hi_plane, -2, h).unsqueeze(-3)
    return torch.cat([*([lo] * h), gy, *([hi] * h)], dim=-3)


def _assemble_y(gk, h, lo_plane, hi_plane):
    """Pad x periodically, then attach explicit y ghost planes (already
    k-ghosted, shape (..., nx, nzg)): the open-y mirror of _assemble."""
    gx = pad_wrap(gk, -3, h)
    lo = pad_wrap(lo_plane, -2, h).unsqueeze(-2)
    hi = pad_wrap(hi_plane, -2, h).unsqueeze(-2)
    return torch.cat([*([lo] * h), gx, *([hi] * h)], dim=-2)


def _assemble_xy(gk, h, xlo, xhi, ylo, yhi):
    """Both directions open: attach the x ghost planes first, then the y
    planes (edge-extended across the new x ghosts) fill the y ghosts
    including the corners, the reference's ordering (modboundary.f90:96-103
    applies the x BC before the y BC, and the y loops run over the full x
    extent including ghosts)."""
    gx = torch.cat([*([xlo.unsqueeze(-3)] * h), gk,
                    *([xhi.unsqueeze(-3)] * h)], dim=-3)
    ylo_e = pad_edge(ylo, -2, h).unsqueeze(-2)
    yhi_e = pad_edge(yhi, -2, h).unsqueeze(-2)
    return torch.cat([*([ylo_e] * h), gx, *([yhi_e] * h)], dim=-2)


def _attach(g, dim, h, lo, hi, at_lo, at_hi, mesh, axis):
    """The halo of width h along `dim` from the ranks of the mesh's `axis`;
    where the block edge is the domain's open edge (`at_lo`, `at_hi`; `lo`
    not None), h copies of the plane `lo` (`hi`) in its place."""
    if lo is not None and at_lo and at_hi:
        # one rank along the axis: both ghosts are planes, no exchange
        return torch.cat([*([lo.unsqueeze(dim)] * h), g,
                          *([hi.unsqueeze(dim)] * h)], dim=dim)
    g = mesh.wrap(g, dim, h, axis)
    if lo is None or not (at_lo or at_hi):
        return g
    n = g.shape[dim]
    return torch.cat([
        torch.cat([lo.unsqueeze(dim)] * h, dim=dim) if at_lo
        else g.narrow(dim, 0, h),
        g.narrow(dim, h, n - 2 * h),
        torch.cat([hi.unsqueeze(dim)] * h, dim=dim) if at_hi
        else g.narrow(dim, n - h, h)], dim=dim)


def split_pad(gk, h, mesh, xlo=None, xhi=None, ylo=None, yhi=None):
    """Ghosts of width h of this rank's block `gk` (x and y axes -3 and -2)
    on `mesh`: halos from the neighbouring ranks, the open planes on the
    domain's open edges.  The corners are those of the single-device
    assembly: x first, and the y halo carries the x ghosts (periodic, or
    ``_assemble``; with y open too, the y planes edge-extended over the x
    ghosts, ``_assemble_xy``, which takes an x halo of the y planes on the
    ranks at a y edge); with only y open the y ghosts go first and the x
    halo carries their periodic neighbours (``_assemble_y``)."""
    ex0, ex1 = mesh.cx == 0, mesh.cx == mesh.px - 1
    ey0, ey1 = mesh.cy == 0, mesh.cy == mesh.py - 1
    if xlo is None and ylo is not None:
        g = _attach(gk, -2, h, ylo, yhi, ey0, ey1, mesh, "y")
        return _attach(g, -3, h, None, None, ex0, ex1, mesh, "x")
    g = _attach(gk, -3, h, xlo, xhi, ex0, ex1, mesh, "x")
    if ylo is not None and (ey0 or ey1):
        # the x halo of the y planes this row needs (every rank of an x row
        # shares cy, so the whole row exchanges or none of it does)
        st = torch.stack([p for p, e in ((ylo, ey0), (yhi, ey1)) if e])
        ext = _attach(st, -2, h, st.select(-2, 0), st.select(-2, -1), ex0,
                      ex1, mesh, "x").unbind(0)
        ylo = ext[0] if ey0 else ylo
        yhi = ext[-1] if ey1 else yhi
    return _attach(g, -2, h, ylo, yhi, ey0, ey1, mesh, "y")


def _dispatch(gk, h, cfg, xlo=None, xhi=None, ylo=None, yhi=None,
              mesh=None):
    """Assemble ghosts from whichever open-boundary planes exist; periodic
    wrap in any direction without planes; on a block of `mesh`, the halos
    from its neighbours (``split_pad``)."""
    if mesh is not None:
        return split_pad(gk, h, mesh, xlo, xhi, ylo, yhi)
    if xlo is not None and ylo is not None:
        return _assemble_xy(gk, h, xlo, xhi, ylo, yhi)
    if xlo is not None:
        return _assemble(gk, h, xlo, xhi)
    if ylo is not None:
        return _assemble_y(gk, h, ylo, yhi)
    return pad_wrap(pad_wrap(gk, -3, h), -2, h)


# --- per-field k-ghost rules (shared by interior tensors and planes) -------

def _kg_u(u, cfg):
    if cfg.bc.BCtopm == BCTOPM_NOSLIP:
        top = 2.0 * cfg.bc.Uinf - take_k(u, -1)
    else:
        top = take_k(u, -1)
    return pad_axis(u, u.ndim - 1, torch.zeros_like(take_k(u, 0)), top)


def _kg_v(v, cfg):
    if cfg.bc.BCtopm == BCTOPM_NOSLIP:
        top = 2.0 * cfg.bc.Vinf - take_k(v, -1)
    else:
        top = take_k(v, -1)
    return pad_axis(v, v.ndim - 1, torch.zeros_like(take_k(v, 0)), top)


def _kg_scalar(f, top):
    return pad_axis(f, f.ndim - 1, take_k(f, 0), top)


def ghost_u(u, cfg: Config, h: int = 1, openx=None, openy=None,
            mesh=None):
    """u ghosts: bottom ghost 0 (the molecular no-slip stress with the
    mirrored ekm of closurebc); top per BCtopm; x per BCxm (profile inlet
    ghost 2u(ib)-u(ib+1), modboundary.f90:699; driver ghost = driver plane
    :732; outlet face from the prognostic XPlanes).  Open-y: ymi_profile
    (:1017-1045)."""
    gk = _kg_u(u, cfg)
    xlo = xhi = ylo = yhi = None
    if openx is not None:
        if cfg.bc.BCxm == BC_PROFILE:
            xlo = 2.0 * gk[0] - gk[1]
        else:  # driver: ghost = inlet plane (== u[0], which is hard-set)
            xlo = gk[0]
        xhi = _kg_u(openx["bx"].u, cfg)
    if openy is not None:
        uprof_k = _kg_u(openy["inlet"]["u"].expand(u.shape[0], u.shape[2]),
                        cfg)
        ylo = 2.0 * uprof_k - gk[:, 0]
        yhi = _kg_u(openy["by"].u, cfg)
    return _dispatch(gk, h, cfg, xlo, xhi, ylo, yhi, mesh)


def ghost_v(v, cfg: Config, h: int = 1, openx=None, openy=None,
            mesh=None):
    gk = _kg_v(v, cfg)
    xlo = xhi = ylo = yhi = None
    if openx is not None:
        if cfg.bc.BCxm == BC_PROFILE:
            vprof_k = _kg_v(openx["inlet"]["v"].expand(v.shape[1:]), cfg)
            xlo = 2.0 * vprof_k - gk[0]
        else:
            xlo = _kg_v(openx["inlet"]["v"], cfg)
        xhi = _kg_v(openx["bx"].v, cfg)
    if openy is not None:
        # ymi_profile: v(jb)=vprof pinned in the update; ghost extrapolates
        ylo = 2.0 * gk[:, 0] - gk[:, 1]
        yhi = _kg_v(openy["by"].v, cfg)
    return _dispatch(gk, h, cfg, xlo, xhi, ylo, yhi, mesh)


def ghost_w(w, cfg: Config, h: int = 1, openx=None, openy=None,
            mesh=None):
    """w is a face tensor (nx, ny, nz+1); bottom/top faces impermeable
    (modboundary.f90:165-166, 177) except under the pressure top BC, where
    the top face is prognostic."""
    w = w.clone()
    w[..., 0] = 0.0
    if cfg.bc.BCtopm != BCTOPM_PRESSURE:
        w[..., -1] = 0.0
    xlo = xhi = ylo = yhi = None
    if openx is not None:
        if cfg.bc.BCxm == BC_PROFILE:
            xlo = -w[0]           # modboundary.f90:703
        else:
            xlo = openx["inlet"]["w"]
        xhi = openx["bx"].w
    if openy is not None:
        ylo = -w[:, 0]
        yhi = openy["by"].w
    return _dispatch(w, h, cfg, xlo, xhi, ylo, yhi, mesh)


def _scalar_top_ghost(f, ekh, grid: Grid, flux: float, value: float,
                      mode: int):
    """fluxtop / valuetop ghost plane (modboundary.f90:1494-1519)."""
    if mode == BCTOP_VALUE:
        return 2.0 * value - take_k(f, -1)
    if flux == 0.0:
        return take_k(f, -1)
    dzh_top = float(grid.dzh[-1])
    dzf_ke = float(grid.dzf[-1])
    denom = dzf_ke * ekh[..., -1:]
    return take_k(f, -1) + flux * (dzh_top ** 2) / denom


def _kg_plane(p):
    """(n, nz) plane -> (n, nz+2) with its own edge values as k ghosts."""
    return _kg_scalar(p, p[..., -1:])


def ghost_thl(thl, ekh, cfg: Config, grid: Grid, h: int = 1, openx=None,
              openy=None, mesh=None):
    top = _scalar_top_ghost(thl, ekh, grid, cfg.bc.wttop, cfg.bc.thl_top,
                            cfg.bc.BCtopT)
    gk = _kg_scalar(thl, top)
    xlo = xhi = ylo = yhi = None
    if openx is not None:
        # profile inlet: ghost = thlprof (modboundary.f90:778-783);
        # driver: plane
        xlo = _kg_plane(openx["inlet"]["thl"])
        xhi = _kg_plane(openx["bx"].thl)
    if openy is not None:
        # yTi_profile (modboundary.f90:1048-1062): ghost = 2 prof - thl(jb)
        prof_k = _kg_plane(openy["inlet"]["thl"].expand(thl.shape[0],
                                                        thl.shape[2]))
        ylo = 2.0 * prof_k - gk[:, 0]
        yhi = _kg_plane(openy["by"].thl)
    return _dispatch(gk, h, cfg, xlo, xhi, ylo, yhi, mesh)


def ghost_qt(qt, ekh, cfg: Config, grid: Grid, h: int = 1, openx=None,
             openy=None, mesh=None):
    top = _scalar_top_ghost(qt, ekh, grid, cfg.bc.wqtop, cfg.bc.qt_top,
                            cfg.bc.BCtopq)
    gk = _kg_scalar(qt, top)
    xlo = xhi = ylo = yhi = None
    if openx is not None:
        if cfg.bc.BCxq == BC_PROFILE:
            prof_k = _kg_plane(openx["inlet"]["qt"].expand(qt.shape[1:]))
            xlo = 2.0 * prof_k - gk[0]
        else:
            xlo = _kg_plane(openx["inlet"]["qt"])
        xhi = _kg_plane(openx["bx"].qt)
    if openy is not None:
        prof_k = _kg_plane(openy["inlet"]["qt"].expand(qt.shape[0],
                                                       qt.shape[2]))
        ylo = 2.0 * prof_k - gk[:, 0]
        yhi = _kg_plane(openy["by"].qt)
    return _dispatch(gk, h, cfg, xlo, xhi, ylo, yhi, mesh)


def ghost_e12(e12, cfg: Config, h: int = 1, openx=None, openy=None,
              mesh=None):
    if cfg.bc.BCtopm in (BCTOPM_FREESLIP, BCTOPM_PRESSURE):
        top = torch.full_like(take_k(e12, -1), const.e12min)
    else:
        top = take_k(e12, -1)
    gk = _kg_scalar(e12, top)
    xlo = xhi = ylo = yhi = None
    if openx is not None:
        xlo = gk[0]   # driver: extrapolate from interior (modboundary:757)
        xhi = _kg_plane(openx["bx"].e12)
    if openy is not None:
        ylo = gk[:, 0]
        yhi = _kg_plane(openy["by"].e12)
    return _dispatch(gk, h, cfg, xlo, xhi, ylo, yhi, mesh)


def _ghost_kappa(c, cfg: Config, h: int, hk: int, xin=None, xout=None,
                 yin=None, yout=None, mesh=None):
    """Kappa-layout ghosts of `c` (..., nx, ny, nz): replicated k ghosts,
    and in x/y the periodic wrap (over the ranks of `mesh`) or the open
    planes `xin`/`xout` (..., ny, nz) and `yin`/`yout` (..., nx, nz)."""
    g = pad_edge(c, -1, hk)
    kg2 = lambda p: pad_edge(p, -1, hk)
    xlo = xhi = ylo = yhi = None
    if xin is not None:
        if cfg.bc.BCxs == BC_PROFILE:
            xlo = 2.0 * kg2(xin) - kg2(c[..., 0, :, :])
        else:
            xlo = kg2(xin)
        xhi = kg2(xout)
    if yin is not None:
        # ysi_profile (modboundary.f90:1065-1097)
        ylo = 2.0 * kg2(yin) - kg2(c[..., :, 0, :])
        yhi = kg2(yout)
    return _dispatch(g, h, cfg, xlo, xhi, ylo, yhi, mesh)


def ghost_scalar_kappa(c, cfg: Config, h: int = 2, hk: int = 2, openx=None,
                       openy=None, sv_index: int = 0, mesh=None):
    """Scalar ghosts for the kappa scheme: halo 2 in x/y and 2 ghost cells
    in k (reference ihc=jhc=khc=2).  The open-boundary planes are read from
    the ``sv`` slot of the contexts at `sv_index`."""
    xin = xout = yin = yout = None
    if openx is not None:
        xin = openx["inlet"]["sv"][sv_index]
        xout = openx["bx"].sv[sv_index]
    if openy is not None:
        yin = openy["inlet"]["sv"][sv_index]
        yout = openy["by"].sv[sv_index]
    return _ghost_kappa(c, cfg, h, hk, xin, xout, yin, yout, mesh)


def ghost_sv(sv, cfg: Config, openx=None, openy=None, mesh=None):
    """Kappa ghosts of every passive scalar at once: `sv` (nsv, nx, ny, nz)
    -> (nsv, nx+4, ny+4, nz+4), each scalar as ``ghost_scalar_kappa`` with
    its own index gives it (udales_tpu ``make_ghosts``, boundary.py:310-316),
    in one set of launches."""
    xin = xout = yin = yout = None
    if openx is not None:
        xin, xout = openx["inlet"]["sv"], openx["bx"].sv
    if openy is not None:
        yin, yout = openy["inlet"]["sv"], openy["by"].sv
    return _ghost_kappa(sv, cfg, 2, 2, xin, xout, yin, yout, mesh)


def ghost_ek(ekm, ekh, cfg: Config, grid: Grid, h: int = 1, openx=None,
             openy=None, mesh=None):
    """closurebc (modboundary.f90:434-505).  The bottom ghost mirrors about
    the molecular value, 2*numol - ekm (bottom.py reads it at k=0); zero
    gradient at any inflow/outflow face (:467-475)."""
    numol = const.numol
    numolh = const.numol * const.prandtlmoli
    bot_m = 2.0 * numol - take_k(ekm, 0)
    bot_h = 2.0 * numolh - take_k(ekh, 0)
    if cfg.bc.BCtopm == BCTOPM_NOSLIP:
        top_m = 2.0 * numol - take_k(ekm, -1)
        top_h = 2.0 * numolh - take_k(ekh, -1)
    else:
        top_m = take_k(ekm, -1)
        top_h = take_k(ekh, -1)

    def mk(gk):
        xlo = gk[0] if openx is not None else None
        xhi = gk[-1] if openx is not None else None
        ylo = gk[:, 0] if openy is not None else None
        yhi = gk[:, -1] if openy is not None else None
        return _dispatch(gk, h, cfg, xlo, xhi, ylo, yhi, mesh)
    return (mk(pad_axis(ekm, 2, bot_m, top_m)),
            mk(pad_axis(ekh, 2, bot_h, top_h)))


@dataclass(frozen=True)
class Ghosts:
    """All ghosted views needed by one tendency evaluation."""
    u: torch.Tensor     # (nx+2h, ny+2h, nz+2)
    v: torch.Tensor
    w: torch.Tensor     # (nx+2h, ny+2h, nz+1)  faces
    thl: Optional[torch.Tensor]
    qt: Optional[torch.Tensor]
    e12: Optional[torch.Tensor]
    sv: Optional[torch.Tensor]  # (nsv, nx+4, ny+4, nz+4) kappa layout
    ekm: Optional[torch.Tensor]
    ekh: Optional[torch.Tensor]


def make_ghosts(f: Fields, ekm, ekh, cfg: Config, grid: Grid,
                h: int = 1, openx=None, openy=None) -> Ghosts:
    """Every ghosted view of one substep; on a block grid (``Grid.block``)
    the periodic halos come from the neighbouring ranks."""
    mesh = grid.mesh
    gm, gh = ghost_ek(ekm, ekh, cfg, grid, h, openx, openy, mesh)
    return Ghosts(
        u=ghost_u(f.u, cfg, h, openx, openy, mesh),
        v=ghost_v(f.v, cfg, h, openx, openy, mesh),
        w=ghost_w(f.w, cfg, h, openx, openy, mesh),
        thl=ghost_thl(f.thl, ekh, cfg, grid, h, openx, openy, mesh),
        qt=ghost_qt(f.qt, ekh, cfg, grid, h, openx, openy, mesh),
        e12=ghost_e12(f.e12, cfg, h, openx, openy, mesh),
        sv=(ghost_sv(f.sv, cfg, openx, openy, mesh) if f.sv.shape[0] > 0
            else f.sv),
        ekm=gm,
        ekh=gh,
    )
