"""Boundary conditions as ghost-cell construction (port of
``udales_tpu.ops.boundary``, closed-domain branches).

Lateral directions are periodic; the k ghosts follow the reference's bottom
and top rules (modboundary.f90:115-389 `boundary`, :434 `closurebc`, :1494
`fluxtop`, :1509 `valuetop`).  Open x/y boundaries (inflow/outflow, driver
planes) and the kappa-scheme scalar ghosts are not ported yet and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..config import (BCTOPM_FREESLIP, BCTOPM_NOSLIP, BCTOPM_PRESSURE,
                      BCTOP_VALUE, Config, const)
from ..grid import Grid
from ..state import Fields
from .halo import pad_axis, pad_periodic_xy, take_k


def _closed(openx, openy):
    if openx is not None or openy is not None:
        raise NotImplementedError(
            "open x/y boundaries are not ported to udales_tpu_torch yet")


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


def ghost_u(u, cfg: Config, h: int = 1, openx=None, openy=None):
    """u ghosts: bottom ghost 0 (the molecular no-slip stress with the
    mirrored ekm of closurebc); top per BCtopm; periodic x/y."""
    _closed(openx, openy)
    return pad_periodic_xy(_kg_u(u, cfg), h)


def ghost_v(v, cfg: Config, h: int = 1, openx=None, openy=None):
    _closed(openx, openy)
    return pad_periodic_xy(_kg_v(v, cfg), h)


def ghost_w(w, cfg: Config, h: int = 1, openx=None, openy=None):
    """w is a face tensor (nx, ny, nz+1); bottom/top faces impermeable
    (modboundary.f90:165-166, 177) except under the pressure top BC."""
    _closed(openx, openy)
    w = w.clone()
    w[..., 0] = 0.0
    if cfg.bc.BCtopm != BCTOPM_PRESSURE:
        w[..., -1] = 0.0
    return pad_periodic_xy(w, h)


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


def ghost_thl(thl, ekh, cfg: Config, grid: Grid, h: int = 1, openx=None,
              openy=None):
    _closed(openx, openy)
    top = _scalar_top_ghost(thl, ekh, grid, cfg.bc.wttop, cfg.bc.thl_top,
                            cfg.bc.BCtopT)
    return pad_periodic_xy(_kg_scalar(thl, top), h)


def ghost_qt(qt, ekh, cfg: Config, grid: Grid, h: int = 1, openx=None,
             openy=None):
    _closed(openx, openy)
    top = _scalar_top_ghost(qt, ekh, grid, cfg.bc.wqtop, cfg.bc.qt_top,
                            cfg.bc.BCtopq)
    return pad_periodic_xy(_kg_scalar(qt, top), h)


def ghost_e12(e12, cfg: Config, h: int = 1, openx=None, openy=None):
    _closed(openx, openy)
    if cfg.bc.BCtopm in (BCTOPM_FREESLIP, BCTOPM_PRESSURE):
        top = torch.full_like(take_k(e12, -1), const.e12min)
    else:
        top = take_k(e12, -1)
    return pad_periodic_xy(_kg_scalar(e12, top), h)


def ghost_scalar_kappa(c, cfg: Config, h: int = 2, hk: int = 2, openx=None,
                       openy=None, sv_index: int = 0):
    raise NotImplementedError(
        "kappa-scheme scalar ghosts are not ported to udales_tpu_torch yet")


def ghost_ek(ekm, ekh, cfg: Config, grid: Grid, h: int = 1, openx=None,
             openy=None):
    """closurebc (modboundary.f90:434-505).  The bottom ghost mirrors about
    the molecular value, 2*numol - ekm (bottom.py reads it at k=0)."""
    _closed(openx, openy)
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
    return (pad_periodic_xy(pad_axis(ekm, 2, bot_m, top_m), h),
            pad_periodic_xy(pad_axis(ekh, 2, bot_h, top_h), h))


@dataclass(frozen=True)
class Ghosts:
    """All ghosted views needed by one tendency evaluation."""
    u: torch.Tensor     # (nx+2h, ny+2h, nz+2)
    v: torch.Tensor
    w: torch.Tensor     # (nx+2h, ny+2h, nz+1)  faces
    thl: Optional[torch.Tensor]
    qt: Optional[torch.Tensor]
    e12: Optional[torch.Tensor]
    sv: Optional[torch.Tensor]
    ekm: Optional[torch.Tensor]
    ekh: Optional[torch.Tensor]


def make_ghosts(f: Fields, ekm, ekh, cfg: Config, grid: Grid,
                h: int = 1, openx=None, openy=None) -> Ghosts:
    if f.sv.shape[0] > 0:
        raise NotImplementedError(
            "passive scalars (nsv > 0) are not ported to udales_tpu_torch yet")
    gm, gh = ghost_ek(ekm, ekh, cfg, grid, h, openx, openy)
    return Ghosts(
        u=ghost_u(f.u, cfg, h, openx, openy),
        v=ghost_v(f.v, cfg, h, openx, openy),
        w=ghost_w(f.w, cfg, h, openx, openy),
        thl=ghost_thl(f.thl, ekh, cfg, grid, h, openx, openy),
        qt=ghost_qt(f.qt, ekh, cfg, grid, h, openx, openy),
        e12=ghost_e12(f.e12, cfg, h, openx, openy),
        sv=f.sv,
        ekm=gm,
        ekh=gh,
    )
