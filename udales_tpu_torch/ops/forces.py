"""Body forces, Coriolis and flow-rate corrections (port of
``udales_tpu.ops.forces``; src/modforces.f90).

  - forces (:46-133): large-scale pressure gradient + buoyancy on w
  - coriolis / lprofforc (:600-717)
  - masscorr (:328-497): fixed volume-flow-rate correction (luvolflowr)
  - periodicEBcorr (:861-951): heat-buildup sink of periodic EB runs
Large-scale tendencies, nudging, sponge damping and the free-stream
controllers are not ported yet.
"""
from __future__ import annotations

import math
from functools import partial

import torch

from ..config import Config, const
from ..grid import Grid
from .stencil import kvec, sh, shw
from .thermo import avexy_masked


def forces(g, grid: Grid, cfg: Config, dpdxl, dpdyl, thv0h=None, thvh=None):
    """(du, dv, dw) tendencies (modforces.f90:46-133).  dpdxl/dpdyl are (nz,)
    profiles; buoyancy uses half-level thv on interior faces."""
    nx, ny, nz = grid.shape
    du = -dpdxl[None, None, :].expand(nx, ny, nz)
    dv = -dpdyl[None, None, :].expand(nx, ny, nz)
    dw = torch.zeros((nx, ny, nz + 1), dtype=du.dtype, device=du.device)
    if cfg.physics.lbuoyancy:
        dw[..., 1:nz] = const.grav * (thv0h[..., 1:nz]
                                      - thvh[None, None, 1:nz]) \
            / thvh[None, None, 1:nz]
    return du, dv, dw


def coriolis(g, grid: Grid, cfg: Config, ug=None, vg=None):
    """Coriolis force or geostrophic profile forcing (modforces.f90:600-717)."""
    nx, ny, nz = grid.shape
    dev, dt = g.u.device, g.u.dtype
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    Sw = partial(shw, nx=nx, ny=ny, nz=nz, h=1)
    phi = cfg.physics.xlat * math.pi / 180.0
    omega = 7.292e-5
    om22 = 2.0 * omega * math.cos(phi)
    om23 = 2.0 * omega * math.sin(phi)
    u, v, w = g.u, g.v, g.w
    if cfg.physics.lcoriol:
        du = ((S(v, 0, 0, 0) + S(v, 0, 1, 0) + S(v, -1, 0, 0) + S(v, -1, 1, 0))
              * om23 * 0.25
              - (Sw(w, 0, 0, 0) + Sw(w, 0, 0, 1) + Sw(w, -1, 0, 1)
                 + Sw(w, -1, 0, 0)) * om22 * 0.25)
        dv = -(S(u, 0, 0, 0) + S(u, 0, -1, 0) + S(u, 1, -1, 0)
               + S(u, 1, 0, 0)) * om23 * 0.25
        nf = nz - 1   # w faces 1..nz-1
        dzf = grid.t("dzf_g", dev)
        dzf_km = kvec(dzf, 1, nf)
        dzf_k = kvec(dzf, 2, nf)
        dzh_k = kvec(grid.t("dzh", dev), 1, nf)
        C = lambda A, di, dk: A[1 + di: 1 + di + nx, 1: 1 + ny,
                                1 + dk: 1 + dk + nf]
        dwf = ((dzf_km * (C(u, 0, 1) + C(u, 1, 1))
                + dzf_k * (C(u, 0, 0) + C(u, 1, 0))) / dzh_k) * om22 * 0.25
        zeros = torch.zeros((nx, ny, 1), dtype=dt, device=dev)
        return du, dv, torch.cat([zeros, dwf, zeros], dim=2)
    if cfg.physics.lprofforc:
        du = om23 * (ug[None, None, :] - S(u, 0, 0, 0))
        return (du, torch.zeros((nx, ny, nz), dtype=dt, device=dev),
                torch.zeros((nx, ny, nz + 1), dtype=dt, device=dev))
    z3 = torch.zeros((nx, ny, nz), dtype=dt, device=dev)
    return z3, z3, torch.zeros((nx, ny, nz + 1), dtype=dt, device=dev)


def masscorr_uvol(up, um, grid: Grid, cfg: Config, rk3coef, IIu=None):
    """Fixed volume-flow-rate correction, luvolflowr path
    (modforces.f90:394-422): a uniform udef so that the volume-averaged
    provisional u matches uflowrate.  `IIu` is the IBM u fluid mask of the
    slab averages (None: all fluid)."""
    nz = grid.ktot
    uvol = avexy_masked(up, IIu)
    uvolold = avexy_masked(um, IIu)
    dzf = grid.t("dzf_g", up.device)[1: nz + 1]
    zh_top = float(grid.zh[-1])
    uoutflow = rk3coef * torch.sum(uvol * dzf) / zh_top
    uflowrateold = torch.sum(uvolold * dzf) / zh_top
    udef = cfg.physics.uflowrate - (uoutflow + uflowrateold)
    return up + (udef / rk3coef).to(up.dtype)


def masscorr_vvol(vp, vm, grid: Grid, cfg: Config, rk3coef, IIv=None):
    """The lvvolflowr counterpart of `masscorr_uvol`; `IIv` is the IBM v
    fluid mask."""
    nz = grid.ktot
    vvol = avexy_masked(vp, IIv)
    vvolold = avexy_masked(vm, IIv)
    dzf = grid.t("dzf_g", vp.device)[1: nz + 1]
    zh_top = float(grid.zh[-1])
    voutflow = rk3coef * torch.sum(vvol * dzf) / zh_top
    vflowrateold = torch.sum(vvolold * dzf) / zh_top
    vdef = cfg.physics.vflowrate - (voutflow + vflowrateold)
    return vp + (vdef / rk3coef).to(vp.dtype)


def periodic_eb_corr(grid: Grid, cfg: Config, tot_Tflux, tot_qflux):
    """Heat-buildup volume sink for periodic energy-balance runs
    (modforces.f90:861-951, Grylls 2021): the domain-total sensible and
    latent wall fluxes (0-d tensors) -> (dthl, dqt) profiles (nz,)."""
    nz = grid.ktot
    xlen, ylen = grid.xlen, grid.ylen
    frac = cfg.eb.fraction
    sinkbase = cfg.eb.sinkbase
    abl_h = float(grid.zh[-1]) / frac
    M = nz - (sinkbase + 1) + 1
    kw = dict(dtype=tot_Tflux.dtype, device=tot_Tflux.device)
    k = torch.arange(nz, device=tot_Tflux.device)
    # Fortran k = sinkbase+1 .. ke (1-based) == 0-based k >= sinkbase
    above = (k >= sinkbase).to(kw["dtype"])
    top = (k == nz - 1).to(kw["dtype"])

    def profile(tot):
        R = tot / (xlen * ylen) / abl_h * nz / M
        phi = (1 - frac) * tot / (xlen * ylen * float(grid.dzf[-1]))
        return R * above + phi * top
    return profile(tot_Tflux), profile(tot_qflux)
