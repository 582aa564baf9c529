"""Body forces, Coriolis and flow-rate corrections (port of
``udales_tpu.ops.forces``; src/modforces.f90).

  - forces (:46-133): large-scale pressure gradient + buoyancy on w
  - coriolis / lprofforc (:600-717)
  - masscorr (:328-497): fixed volume-flow-rate correction (luvolflowr)
  - periodicEBcorr (:861-951): heat-buildup sink of periodic EB runs
  - lstend (:719-824), nudge (:826-859), fixuinf1 (:220-288), shiftedPBCs
    (:953-980), and modboundary.f90 grwdamp (:1447-1491)
"""
from __future__ import annotations

import math
from functools import partial

import numpy as np
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
    uvol = avexy_masked(up, IIu, mesh=grid.mesh)
    uvolold = avexy_masked(um, IIu, mesh=grid.mesh)
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
    vvol = avexy_masked(vp, IIv, mesh=grid.mesh)
    vvolold = avexy_masked(vm, IIv, mesh=grid.mesh)
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


def sponge_profile(grid: Grid, cfg: Config, device="cpu") -> torch.Tensor:
    """The sponge layer's damping rate tsc (nz,) of grwdamp
    (modboundary.f90 initboundary:45-59, rnu0 = 2.75e-3) in the grid's
    dtype on `device`; a Model builds it once, at load."""
    nz = grid.ktot
    rnu0 = 2.75e-3
    # lowest sponge level: &DOMAIN ksp (1-based as in the reference) or the
    # default ksp = kb-1 + max(min(3*kmax/4, kmax-15), 1) (modboundary.f90:47)
    ksp1 = cfg.domain.ksp if cfg.domain.ksp > 0 else \
        max(min(3 * nz // 4, nz - 15), 1)
    ksp = max(ksp1 - 1, 0)  # 0-based
    zf = grid.zf
    zspb, zspt = zf[ksp], zf[nz - 1]
    tsc = np.zeros(nz)
    tsc[ksp:] = rnu0 * np.sin(
        0.5 * np.pi * (zf[ksp:] - zspb) / (zspt - zspb)) ** 2
    return torch.as_tensor(tsc, dtype=grid.torch_dtype, device=device)


def grwdamp(c, grid: Grid, cfg: Config, u0av, v0av, thl0av, qt0av,
            ug=None, vg=None, tsc=None):
    """Sponge-layer gravity-wave damping (modboundary.f90:38-62, 1447-1491).
    `tsc` is `sponge_profile` on the fields' device (built here when None).
    Returns tendencies for (u, v, w, thl, qt)."""
    nx, ny, nz = grid.shape
    kw = dict(dtype=c.u.dtype, device=c.u.device)
    igrw = cfg.physics.igrw_damp
    if igrw == 0:
        z3 = torch.zeros((nx, ny, nz), **kw)
        return z3, z3, torch.zeros((nx, ny, nz + 1), **kw), z3, z3
    rnu0 = 2.75e-3
    if tsc is None:
        tsc = sponge_profile(grid, cfg, c.u.device)
    tsc = tsc[None, None, :]
    tscw = torch.cat([tsc[..., :1] * 0, tsc], dim=2)

    if igrw == 2:
        uref, vref = ug[None, None, :], vg[None, None, :]
    else:
        uref, vref = u0av[None, None, :], v0av[None, None, :]
    du = -(c.u - uref) * tsc
    dv = -(c.v - vref) * tsc
    dw = -c.w * tscw
    dthl = -(c.thl - thl0av[None, None, :]) * tsc
    dqt = -(c.qt - qt0av[None, None, :]) * tsc
    if igrw == 1 and cfg.physics.lcoriol:
        fac = (1.0 / (cfg.physics.geodamptime * rnu0)) * tsc
        du = du - (c.u - ug[None, None, :]) * fac
        dv = dv - (c.v - vg[None, None, :]) * fac
    return du, dv, dw, dthl, dqt


def nudge_top(c, grid: Grid, cfg: Config, unudge, vnudge, thlnudge, qtnudge,
              u0av=None, v0av=None, thl0av=None, qt0av=None):
    """Relax the SLAB MEAN to the profiles for levels k >= nnudge
    (modforces.f90:826-859): the tendency is uniform across each slab."""
    nx, ny, nz = grid.shape
    n = cfg.physics.nnudge
    z3 = torch.zeros((nx, ny, nz), dtype=c.u.dtype, device=c.u.device)
    if n <= 0:
        return z3, z3, z3, z3
    mask = (torch.arange(nz, device=c.u.device) >= n).to(c.u.dtype)
    tnudgei = 1.0 / cfg.physics.tnudge
    prof = lambda av, ref: (-mask * (av - ref) * tnudgei)[None, None, :]
    return (prof(u0av, unudge) + z3, prof(v0av, vnudge) + z3,
            prof(thl0av, thlnudge) + z3, prof(qt0av, qtnudge) + z3)


def lstend(c, grid: Grid, cfg: Config, whls, u0av, v0av, thl0av, qt0av,
           sv0av, dqtdtls=None):
    """Large-scale subsidence tendencies (modforces.f90:719-824): upwinded
    w_ls d(phi)/dz using slab-average profiles; horizontal LS gradients are
    zero unless provided.  Returns slab-uniform tendencies
    (du, dv, dthl, dqt, dsv profiles of shape (nz,) / (nsv, nz))."""
    nz = grid.ktot
    dzh = grid.t("dzh", whls.device)

    def subs(av):
        # downwind scheme (modforces.f90:792-814); lowest level only takes
        # the downward branch (:769-781)
        dn = whls[1:] * (torch.cat([av[1:], av[-1:]]) - av) \
            / dzh[1:]                                  # whls(k+1) branch
        up_ = whls[:nz] * (av - torch.cat([av[:1], av[:-1]])) \
            / torch.clamp(dzh[:nz], min=1e-30)         # whls(k) branch
        s = torch.where(whls[1:] < 0, dn, up_)
        s0 = torch.where(whls[1] < 0, dn[0], torch.zeros_like(dn[0]))
        return -torch.cat([s0[None], s[1:]])

    dthl = subs(thl0av)
    dqt = subs(qt0av)
    if dqtdtls is not None:
        dqt = dqt + dqtdtls
    if cfg.physics.lmomsubs:
        du = subs(u0av)
        dv = subs(v0av)
    else:
        du = torch.zeros_like(dthl)
        dv = torch.zeros_like(dthl)
    dsv = (torch.stack([subs(sv0av[n]) for n in range(sv0av.shape[0])])
           if sv0av.shape[0]
           else torch.zeros((0, nz), dtype=dthl.dtype, device=dthl.device))
    return du, dv, dthl, dqt, dsv


def fixuinf1(c, grid: Grid, cfg: Config, dt, u0av, v0av):
    """Free-stream velocity controller mode 1 (modforces.f90:220-288):
    uniform correction -(1/dt)(u0av(ke) - Uinf) applied on the last
    substep."""
    du = -(u0av[-1] - cfg.bc.Uinf) / dt
    dv = (-(v0av[-1] - cfg.bc.Vinf) / dt) if cfg.physics.lvinf else 0.0
    return du, dv


def shift_profile(grid: Grid, ds: float, device="cpu") -> torch.Tensor:
    """The spanwise-shift velocity profile vsx (the block's x cells) of
    shifted_pbcs (modforces.f90:953-980) in the grid's dtype on `device`;
    a Model builds it once, at load.  The outlet half is the domain's."""
    nx = grid.global_shape[0]
    ih = nx // 2
    xh = np.arange(nx + 1) * grid.dx      # the domain's (Grid.__init__)
    vsx = np.zeros(nx)
    vsx[ih + 1:] = (0.5 * np.pi * ds / (0.5 * grid.xlen)
                    * np.sin(np.pi * (xh[ih + 1: nx] - xh[ih])
                             / (0.5 * grid.xlen)))
    vsx = vsx[grid.i0: grid.i0 + grid.itot]
    return torch.as_tensor(vsx, dtype=grid.torch_dtype, device=device)


def shifted_pbcs(c, grid: Grid, cfg: Config, rk3coef, u0av, ds: float,
                 vsx=None):
    """Spanwise-shift nudging near the outlet half of the domain
    (modforces.f90:953-980), used with shifted periodic BCs.  `vsx` is
    `shift_profile` on the fields' device (built here when None).  On a
    block (``Grid.block``) the rank takes its part of the profile and its
    y neighbours from the mesh."""
    if vsx is None:
        vsx = shift_profile(grid, ds, c.u.device)
    vs = vsx[:, None, None] * u0av[None, None, :]
    mesh = grid.mesh
    if mesh is None:
        dyj = lambda f: (f - torch.roll(f, 1, dims=1)) * grid.dyi
    else:
        dyj = lambda f: (f - mesh.wrap(f, 1, 1, "y")[:, :-2]) * grid.dyi
    du = -vs * dyj(c.u)
    dv = -vs * dyj(c.v)
    dw = -torch.cat([vs, vs[:, :, -1:]], dim=2) * dyj(c.w)
    return du, dv, dw
