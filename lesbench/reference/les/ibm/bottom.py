"""Domain-floor wall functions (port of ``udales_tpu.ibm.bottom``;
`bottom`, src/modibm.f90:1997-2099).

Active when lbottom=.true.  Per lowest cell the reference cancels the
ghost-based SGS diffusion across the floor face, then subtracts the log-law
stress.  With this package's ghosts (u ghost below the floor = 0, ekm ghost
mirrored as 2*numol - ekm, scalar ghosts zero-flux) the cancellation term
for momentum is +u0*emom*dzhi*dzfi and the scalar diffusion through the
floor face is already zero.
"""
from __future__ import annotations

import math

import torch

from ..config import BCBOTM_WFNEUTRAL, BCBOT_FLUX, BCBOT_WF, Config, const
from ..grid import Grid
from .wallfn import UMIN, ctm_neutral, unom, unoh


def bottom_tendencies(g, cfg: Config, grid: Grid, nsv: int = 0):
    """Tendency contributions for (u, v, thl, qt, sv), non-zero only at
    k=0.  `g` is a Ghosts."""
    nx, ny, nz = grid.shape
    kw = dict(dtype=g.u.dtype, device=g.u.device)
    z3 = lambda: torch.zeros((nx, ny, nz), **kw)
    du, dv, dthl, dqt = z3(), z3(), z3(), z3()
    dsv = torch.zeros((nsv, nx, ny, nz), **kw)
    if not cfg.walls.lbottom:
        return du, dv, dthl, dqt, dsv

    z0 = cfg.bc.z0 if cfg.bc.z0 > 0 else 0.03
    z0h = cfg.bc.z0h if cfg.bc.z0h > 0 else z0 / 10.0
    thls = cfg.bc.thls if cfg.bc.thls > 0 else 288.0
    delta = 0.5 * float(grid.dzf[0])
    logdz = math.log(delta / z0)
    logzh = math.log(z0 / z0h)
    sqdz = math.sqrt(delta / z0)
    dzfi0 = float(grid.dzfi[0])
    dzhi0 = float(grid.dzhi[0])
    dzhiq0 = float(grid.dzhiq[0])
    dzf_g = [float(grid.dzf_g[0]), float(grid.dzf_g[1])]  # [0]=ghost, [1]=k0

    u0 = g.u[1:-1, 1:-1, 1]
    v0 = g.v[1:-1, 1:-1, 1]
    ekm0 = g.ekm[1:-1, 1:-1, 1]
    ekm_g = g.ekm[1:-1, 1:-1, 0]  # mirrored ghost 2*numol - ekm

    # ---- u component (wfuno case 91, modwallfunctions.f90:97-113) -------
    v_at_u = 0.25 * (g.v[1:-1, 1:-1, 1] + g.v[0:-2, 1:-1, 1]
                     + g.v[1:-1, 2:, 1] + g.v[0:-2, 2:, 1])
    utangInt = torch.clamp(u0 ** 2 + v_at_u ** 2, min=UMIN)
    if cfg.bc.BCbotm == BCBOTM_WFNEUTRAL:
        ctm = ctm_neutral(logdz)
    else:
        thl_at_u = 0.5 * (g.thl[1:-1, 1:-1, 1] + g.thl[0:-2, 1:-1, 1])
        dT = thl_at_u - thls
        Ribl0 = const.grav * delta * dT * 2.0 / ((2.0 * thls) * utangInt)
        ctm = unom(logdz, logzh, sqdz, Ribl0, cfg.walls.prandtlturb)
    tau_u = torch.sign(u0) * torch.abs(u0) * torch.sqrt(utangInt) * ctm
    emom_u = (dzf_g[0] * (ekm0 + g.ekm[0:-2, 1:-1, 1])
              + dzf_g[1] * (ekm_g + g.ekm[0:-2, 1:-1, 0])) * dzhiq0
    du[:, :, 0] = u0 * emom_u * dzhi0 * dzfi0 - tau_u * dzfi0

    # ---- v component ----------------------------------------------------
    u_at_v = 0.25 * (g.u[1:-1, 1:-1, 1] + g.u[1:-1, 0:-2, 1]
                     + g.u[2:, 0:-2, 1] + g.u[2:, 1:-1, 1])
    utangInt_v = torch.clamp(u_at_v ** 2 + v0 ** 2, min=UMIN)
    if cfg.bc.BCbotm == BCBOTM_WFNEUTRAL:
        ctm_v = ctm_neutral(logdz)
    else:
        thl_at_v = 0.5 * (g.thl[1:-1, 1:-1, 1] + g.thl[1:-1, 0:-2, 1])
        dT_v = thl_at_v - thls
        Ribl0_v = const.grav * delta * dT_v * 2.0 / ((2.0 * thls)
                                                     * utangInt_v)
        ctm_v = unom(logdz, logzh, sqdz, Ribl0_v, cfg.walls.prandtlturb)
    tau_v = torch.sign(v0) * torch.abs(v0) * torch.sqrt(utangInt_v) * ctm_v
    eomm_v = (dzf_g[0] * (ekm0 + g.ekm[1:-1, 0:-2, 1])
              + dzf_g[1] * (ekm_g + g.ekm[1:-1, 0:-2, 0])) * dzhiq0
    dv[:, :, 0] = v0 * eomm_v * dzhi0 * dzfi0 - tau_v * dzfi0

    # ---- temperature ----------------------------------------------------
    if cfg.physics.ltempeq:
        if cfg.bc.BCbotT == BCBOT_WF:
            # wfuno case 92 (modwallfunctions.f90:133-162)
            u_at_c = 0.5 * (g.u[1:-1, 1:-1, 1] + g.u[2:, 1:-1, 1])
            v_at_c = 0.5 * (g.v[1:-1, 1:-1, 1] + g.v[1:-1, 2:, 1])
            uInt = torch.clamp(u_at_c ** 2 + v_at_c ** 2, min=UMIN)
            dT_c = g.thl[1:-1, 1:-1, 1] - thls
            Ribl0_c = const.grav * delta * dT_c / (thls * uInt)
            flux, _ = unoh(logdz, logzh, sqdz, uInt, dT_c, Ribl0_c,
                           cfg.walls.prandtlturb)
            dthl[:, :, 0] = -flux * dzfi0
        else:  # fixed flux (BCbotT_flux)
            wtsurf = cfg.bc.wtsurf if cfg.bc.wtsurf > -900 else 0.0
            dthl[:, :, 0] = -wtsurf * dzfi0

    if cfg.physics.lmoist and cfg.bc.BCbotq == BCBOT_FLUX:
        wqsurf = cfg.bc.wqsurf if cfg.bc.wqsurf > -900 else 0.0
        dqt[:, :, 0] = wqsurf * dzfi0

    return du, dv, dthl, dqt, dsv
