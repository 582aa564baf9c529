"""Thermodynamics diagnostics (port of ``udales_tpu.ops.thermo``).

Re-derivations of src/modthermodynamics.f90: the saturation adjustment
(thermo :434-504, all-or-nothing or Newton-Raphson), the hydrostatic base
profiles (diagfld :241-350 / fromztop :364-424), half-level interpolation
(calc_halflev :508-538) and d(theta_v)/dz of calthv (:130-235).

Slab averages follow avexy_ibm (modmpi.f90:621-662): all-solid slabs give
the sentinel -999.  On one rank's block of an x/y split (`mesh`,
``parallel.mesh``) the sums and counts are all-reduced over the ranks.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import Config, const
from ..grid import Grid


def avexy_masked(f, mask=None, sentinel=-999.0, mesh=None):
    """Mask-weighted slab (x, y) average per level.  `mask` is a 0/1 fluid
    indicator broadcastable to `f`; None means all fluid.  With `mesh`, `f`
    and `mask` are this rank's blocks and the average is the domain's."""
    if mesh is not None:
        return _avexy_split(f, mask, sentinel, mesh)
    if mask is None:
        return f.sum(dim=(0, 1)) / (f.shape[0] * f.shape[1])
    cnt = mask.sum(dim=(0, 1))
    s = (f * mask).sum(dim=(0, 1))
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1), sentinel)


def _avexy_split(f, mask, sentinel, mesh):
    """`avexy_masked` of the domain from this rank's block: local sums and
    counts, one all-reduce, the global division."""
    if mask is None:
        s = mesh.allreduce_sum(f.sum(dim=(0, 1)))
        return s / (f.shape[0] * f.shape[1] * mesh.px * mesh.py)
    s, cnt = mesh.allreduce_sum(torch.stack(torch.broadcast_tensors(
        (f * mask).sum(dim=(0, 1)), mask.sum(dim=(0, 1)))))
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1), sentinel)


def slab_mean(f, mesh=None):
    """Unmasked slab (x, y) average per level (of the domain, from this
    rank's block, with `mesh`)."""
    if mesh is not None:
        return _avexy_split(f, None, None, mesh)
    return f.mean(dim=(0, 1))


def _qsat_tetens(T, pressure):
    es = const.es0 * torch.exp(const.at * (T - const.tmelt) / (T - const.bt))
    return const.ep * es / (pressure - (1.0 - const.ep) * es)


def ql_sat_adjust(thl, qt, pressure, exner, lqlnr: bool = False, mesh=None):
    """All-or-nothing liquid water (modthermodynamics.f90:478-501), or the
    Newton-Raphson temperature iteration when ``lqlnr`` (:449-476), whose
    convergence test is the domain's over the ranks of `mesh`."""
    tl = torch.clamp(thl * exner, min=100.0)
    if lqlnr:
        return _ql_newton_raphson(tl, qt, pressure, mesh=mesh)
    qsl = _qsat_tetens(tl, pressure)
    b1 = const.rlv ** 2 / (tl ** 2 * const.cp * const.rv)
    qs = qsl * (1.0 + b1 * qt) / (1.0 + b1 * qsl)
    return torch.clamp(qt - qs, min=0.0)


def _ql_newton_raphson(tl, qt, pressure, maxit: int = 50, mesh=None):
    """Newton-Raphson saturation temperature (modthermodynamics.f90:449-476):
    iterate T until the largest relative update drops below 1e-5, at most
    `maxit` times.  The reference package stops a while-loop on that global
    error; here all `maxit` iterations run and a device-side flag
    freezes T once the error has dropped, which gives the same T without a
    host synchronisation per iteration.  On a block the largest update is
    the domain's (a MAX all-reduce an iteration)."""
    T = tl
    done = torch.zeros((), dtype=torch.bool, device=tl.device)
    for _ in range(maxit):
        qs = _qsat_tetens(T, pressure)
        Tn = T - (T + (const.rlv / const.cp) * qs - tl
                  - (const.rlv / const.cp) * qt) \
            / (1.0 + (const.rlv ** 2 * qs) / (const.rv * const.cp * T ** 2))
        err = torch.max(torch.abs(Tn - T) / Tn)
        if mesh is not None:
            err = mesh.allreduce_max(err)
        T = torch.where(done, T, Tn)
        done = done | ~(err > 1e-5)
    return torch.clamp(qt - _qsat_tetens(T, pressure), min=0.0)


@dataclass(frozen=True)
class ThermoDiag:
    """Diagnostics consumed by the dynamical core."""
    thv0h: torch.Tensor    # virtual potential temperature, half levels
    thvh: torch.Tensor     # slab-mean thv at half levels (nz+1,)
    dthvdz: torch.Tensor   # vertical thv gradient at cell centres
    ql0: torch.Tensor      # liquid water (zeros when dry)
    presf: torch.Tensor    # hydrostatic pressure, full levels (nz+1,)
    presh: torch.Tensor    # half levels (nz+1,)
    exnf: torch.Tensor
    exnh: torch.Tensor
    rhobf: torch.Tensor    # (nz,) base density (1 for Boussinesq)
    thl0av: torch.Tensor   # slab averages (nz,)
    u0av: torch.Tensor
    v0av: torch.Tensor
    qt0av: torch.Tensor


def _cumsum0(incr):
    """[0, cumsum(incr)]: cumulative increments starting from zero."""
    return torch.cat([incr.new_zeros(1), torch.cumsum(incr, dim=0)])


def hydrostatic_profiles(th0av_e, qt0av_e, ql0av_e, grid: Grid, cfg: Config,
                         thvs: float, ps: float):
    """fromztop (modthermodynamics.f90:364-424): pressures at full/half
    levels from hydrostatic balance, iterated twice as in diagfld.  Inputs
    are profiles of length nz+1 (levels kb..ke+kh)."""
    nz = grid.ktot
    dev = th0av_e.device
    rdocp = const.rd / const.cp
    dzf = grid.t("dzf_g", dev)
    dzh = grid.t("dzh", dev)
    zf0 = float(grid.zf[0])

    def one_pass(th0av):
        dzf_k = dzf[2: nz + 2]
        dzf_km = dzf[1: nz + 1]
        thetah = (th0av[1:] * dzf_km + th0av[:-1] * dzf_k) / (2.0 * dzh[1:])
        qth = (qt0av_e[1:] * dzf_km + qt0av_e[:-1] * dzf_k) / (2.0 * dzh[1:])
        qlh = (ql0av_e[1:] * dzf_km + ql0av_e[:-1] * dzf_k) / (2.0 * dzh[1:])
        thvh_half = thetah * (1.0 + (const.rv / const.rd - 1.0) * qth
                              - const.rv / const.rd * qlh)
        g_cp = const.grav * (const.pref0 ** rdocp) / const.cp
        p0 = ps ** rdocp - g_cp * zf0 / thvs
        incr = -g_cp * dzh[1:] / thvh_half
        presf = (p0 + _cumsum0(incr)) ** (1.0 / rdocp)
        thvf = th0av * (1.0 + (const.rv / const.rd - 1.0) * qt0av_e
                        - const.rv / const.rd * ql0av_e)
        incr_h = -g_cp * dzf[1: nz + 1] / thvf[:-1]
        presh = (ps ** rdocp + _cumsum0(incr_h)) ** (1.0 / rdocp)
        return presf, presh, thvf

    # the reference iterates twice (diagfld:291-318); both passes see the
    # same inputs (the caller folds ql into th0av_e), so one suffices
    presf, presh, thvf = one_pass(th0av_e)
    exnf = (presf / const.pref0) ** rdocp
    exnh = (presh / const.pref0) ** rdocp
    return presf, presh, exnf, exnh, thvf


def thermodynamics(c, cfg: Config, grid: Grid, masks=None) -> ThermoDiag:
    """Thermodynamics pass (modthermodynamics.f90:57-122).  `c` is
    a Fields (current substep); `masks` optionally gives the IBM fluid masks
    (``ibm.Masks``: c, u, v and the face mask w) that weight the slab
    averages, as in udales_tpu/ops/thermo.py:150-161; None is all fluid."""
    nx, ny, nz = grid.shape
    dev, dt = c.thl.device, c.thl.dtype

    thls = cfg.bc.thls if cfg.bc.thls > 0 else 288.0
    qts = cfg.bc.qts if cfg.bc.qts > 0 else 0.0
    thvs = thls * (1.0 + (const.rv / const.rd - 1.0) * qts)
    ps = cfg.physics.ps

    IIc = IIu = IIv = IIw = None
    if masks is not None:
        IIc, IIu, IIv, IIw = masks.c, masks.u, masks.v, masks.w
    mesh = grid.mesh
    u0av = avexy_masked(c.u, IIu, mesh=mesh)
    v0av = avexy_masked(c.v, IIv, mesh=mesh)
    thl0av = avexy_masked(c.thl, IIc, mesh=mesh)
    qt0av = avexy_masked(c.qt, IIc, mesh=mesh)

    # extended (ke+kh) profiles: zero-gradient top ghost
    ext = lambda p: torch.cat([p, p[-1:]])
    thl0av_e, qt0av_e = ext(thl0av), ext(qt0av)

    lmoist = cfg.physics.lmoist
    ql0 = torch.zeros((nx, ny, nz), dtype=dt, device=dev)
    ql0av = torch.zeros(nz + 1, dtype=dt, device=dev)
    th0av_e = thl0av_e
    if lmoist:
        # saturation needs presf: the dry hydrostatic profile first
        presf, _, exnf, _, _ = hydrostatic_profiles(
            thl0av_e, qt0av_e, ql0av, grid, cfg, thvs, ps)
        ql0 = ql_sat_adjust(c.thl, c.qt, presf[None, None, :nz],
                            exnf[None, None, :nz], cfg.dynamics.lqlnr, mesh)
        ql0av = ext(avexy_masked(ql0, IIc, mesh=mesh))
        th0av_e = thl0av_e + (const.rlv / const.cp) * ql0av / exnf
    presf, presh, exnf, exnh, _ = hydrostatic_profiles(
        th0av_e, qt0av_e, ql0av, grid, cfg, thvs, ps)

    # half-level fields (calc_halflev:508-538): k=0 is the surface value
    dzf_g = grid.t("dzf_g", dev)
    dzh = grid.t("dzh", dev)

    def halflev(f, surf):
        dzf_k = dzf_g[2: nz + 2][None, None, :]
        dzf_km = dzf_g[1: nz + 1][None, None, :]
        f_e = torch.cat([f, f[..., -1:]], dim=-1)
        fh = (f_e[..., 1:] * dzf_km + f_e[..., :-1] * dzf_k) / (
            2.0 * dzh[1:][None, None, :])
        return torch.cat([torch.full((nx, ny, 1), surf, dtype=dt, device=dev),
                          fh], dim=-1)

    thl0h = halflev(c.thl, thls)
    if lmoist:
        qt0h = halflev(c.qt, qts)
        ql0h = ql_sat_adjust(thl0h, qt0h, presh[None, None, :],
                             exnh[None, None, :], cfg.dynamics.lqlnr, mesh)
        # calthv moist branch (:142-200)
        thv0h = (thl0h + const.rlv * ql0h / (const.cp * exnh[None, None, :])) \
            * (1.0 + (const.rv / const.rd - 1.0) * qt0h
               - const.rv / const.rd * ql0h)
        dthvdz = _dthvdz_moist(c, ql0, grid, exnf[:nz])
    else:
        thv0h = thl0h
        dthvdz = _dthvdz_dry(c.thl, grid)

    # thvh slab average + lowest-level overrides (modthermodynamics:77-93)
    thvh = avexy_masked(thv0h, IIw, mesh=mesh)
    th0av_i = th0av_e[:nz]
    ql_ = ql0av[:nz]
    ov = lambda k: th0av_i[k] * (1.0 + (const.rv / const.rd - 1.0) * qt0av[k]
                                 - const.rv / const.rd * ql_[k])
    thvh = torch.cat([ov(0)[None], thvh[1:]])
    first = torch.arange(nz + 1, device=dev) == 1
    thvh = torch.where((torch.abs(thvh[1]) < const.eps1) & first, ov(1), thvh)

    return ThermoDiag(
        thv0h=thv0h, thvh=thvh, dthvdz=dthvdz, ql0=ql0,
        presf=presf, presh=presh, exnf=exnf, exnh=exnh,
        rhobf=torch.ones(nz, dtype=dt, device=dev),
        thl0av=thl0av, u0av=u0av, v0av=v0av, qt0av=qt0av,
    )


def _floor_gradient(d):
    """Zero at the lowest level, floored at +/- eps1 (calthv :226-231)."""
    d = torch.cat([torch.zeros_like(d[..., :1]), d[..., 1:]], dim=-1)
    return torch.where(torch.abs(d) < const.eps1,
                       torch.sign(d) * const.eps1
                       + (d == 0).to(d.dtype) * const.eps1, d)


def _dthvdz_dry(thl, grid: Grid):
    """calthv dry branch (modthermodynamics.f90:202-231): centred gradient,
    zero at the lowest level, floored at +/- eps1."""
    dzh = grid.t("dzh", thl.device)
    thl_e = torch.cat([thl[..., :1], thl, thl[..., -1:]], dim=-1)
    denom = (dzh[1:] + dzh[:-1])[None, None, :]
    return _floor_gradient((thl_e[..., 2:] - thl_e[..., :-2]) / denom)


def _dthvdz_moist(c, ql0, grid: Grid, exnf):
    """calthv moist branch (modthermodynamics.f90:153-200)."""
    dev = c.thl.device
    dzh = grid.t("dzh", dev)
    ext = lambda f: torch.cat([f[..., :1], f, f[..., -1:]], dim=-1)
    thl_e, qt_e = ext(c.thl), ext(c.qt)
    dth = thl_e[..., 2:] - thl_e[..., :-2]
    dq = qt_e[..., 2:] - qt_e[..., :-2]
    eps_I = 1.0 / const.ep - 1.0
    a_dry = 1.0 + eps_I * c.qt
    b_dry = eps_I * c.thl
    del_dry = a_dry * dth + b_dry * dq
    temp = c.thl * exnf[None, None, :] + (const.rlv / const.cp) * ql0
    qs = c.qt - ql0
    a_moist = ((1.0 - c.qt + qs / const.ep * (1.0 + const.rlv
                / (const.rv * temp)))
               / (1.0 + const.rlv ** 2 * qs
                  / (const.cp * const.rv * temp ** 2)))
    b_moist = a_moist * const.rlv / const.cp - temp
    c_liquid = a_dry * const.rlv / const.cp - c.thl / const.ep
    del_sat = a_moist * dth + b_moist * dq
    zf = grid.t("zf", dev)
    zf_e = torch.cat([zf[:1], zf, zf.new_tensor([grid.zf_top])])
    chi = 2.0 * const.chi_half * (zf_e[1:-1] - zf_e[:-2])[None, None, :] / (
        dzh[:-1] + dzh[1:])[None, None, :]
    diff = del_dry - del_sat
    chi_sat = c_liquid * ql0 / torch.where(
        torch.abs(diff) < 1e-30, torch.full_like(diff, 1e-30), diff)
    dthv = torch.where((ql0 > 0) & (chi < chi_sat), del_sat, del_dry)
    return _floor_gradient(dthv / (dzh[1:] + dzh[:-1])[None, None, :])
