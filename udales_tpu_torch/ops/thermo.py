"""Thermodynamics diagnostics, dry path (port of ``udales_tpu.ops.thermo``).

Re-derivations of src/modthermodynamics.f90: the hydrostatic base profiles
(diagfld :241-350 / fromztop :364-424), half-level interpolation
(calc_halflev :508-538) and the dry d(theta_v)/dz of calthv (:202-231).
The moist saturation adjustment is not ported yet and raises.

Slab averages follow avexy_ibm (modmpi.f90:621-662): all-solid slabs give
the sentinel -999.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import Config, const
from ..grid import Grid


def avexy_masked(f, mask=None, sentinel=-999.0):
    """Mask-weighted slab (x, y) average per level.  `mask` is a 0/1 fluid
    indicator broadcastable to `f`; None means all fluid."""
    if mask is None:
        return f.sum(dim=(0, 1)) / (f.shape[0] * f.shape[1])
    cnt = mask.sum(dim=(0, 1))
    s = (f * mask).sum(dim=(0, 1))
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1), sentinel)


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

    # the reference iterates twice (diagfld:291-318); on the dry path both
    # passes see the same inputs, so one suffices
    presf, presh, thvf = one_pass(th0av_e)
    exnf = (presf / const.pref0) ** rdocp
    exnh = (presh / const.pref0) ** rdocp
    return presf, presh, exnf, exnh, thvf


def thermodynamics(c, cfg: Config, grid: Grid) -> ThermoDiag:
    """Thermodynamics pass (modthermodynamics.f90:57-122), dry path, on an
    all-fluid domain (the IBM masks come with the urban slice).  `c` is a
    Fields (current substep)."""
    if cfg.physics.lmoist:
        raise NotImplementedError(
            "moist thermodynamics is not ported to udales_tpu_torch yet")
    nx, ny, nz = grid.shape
    dev, dt = c.thl.device, c.thl.dtype

    thls = cfg.bc.thls if cfg.bc.thls > 0 else 288.0
    qts = cfg.bc.qts if cfg.bc.qts > 0 else 0.0
    thvs = thls * (1.0 + (const.rv / const.rd - 1.0) * qts)
    ps = cfg.physics.ps

    u0av = avexy_masked(c.u)
    v0av = avexy_masked(c.v)
    thl0av = avexy_masked(c.thl)
    qt0av = avexy_masked(c.qt)

    # extended (ke+kh) profiles: zero-gradient top ghost
    ext = lambda p: torch.cat([p, p[-1:]])
    thl0av_e, qt0av_e = ext(thl0av), ext(qt0av)

    ql0 = torch.zeros((nx, ny, nz), dtype=dt, device=dev)
    ql0av = torch.zeros(nz + 1, dtype=dt, device=dev)
    th0av_e = thl0av_e
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

    thv0h = halflev(c.thl, thls)
    dthvdz = _dthvdz_dry(c.thl, grid)

    # thvh slab average + lowest-level overrides (modthermodynamics:77-93)
    thvh = avexy_masked(thv0h)
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


def _dthvdz_dry(thl, grid: Grid):
    """calthv dry branch (modthermodynamics.f90:202-231): centred gradient,
    zero at the lowest level, floored at +/- eps1."""
    dzh = grid.t("dzh", thl.device)
    thl_e = torch.cat([thl[..., :1], thl, thl[..., -1:]], dim=-1)
    denom = (dzh[1:] + dzh[:-1])[None, None, :]
    d = (thl_e[..., 2:] - thl_e[..., :-2]) / denom
    d = torch.cat([torch.zeros_like(d[..., :1]), d[..., 1:]], dim=-1)
    return torch.where(torch.abs(d) < const.eps1,
                       torch.sign(d) * const.eps1
                       + (d == 0).to(d.dtype) * const.eps1, d)
