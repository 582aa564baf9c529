"""Lund-1998 / Kong-2000 rescale-recycle turbulent inlet generator (port of
``udales_tpu.ops.inletgen``).

The reference's `modinlet.f90` (`inletgen:202` with temperature,
`inletgennotemp:946` without): running j-averaged means at the recycle
plane, friction-velocity and thickness based inner/outer rescaling
(Ludwig-Tillmann utau ratio, gamma/lambda), inner (z+ = utau z / nu) and
outer (z/delta) interpolation with the reference's extrapolation rules,
tanh weight-function blending (modinlet.f90:681-688, alpha=4, b=0.2),
Heaviside damping of the fluctuations above the boundary layer
(initinlet:99-150), and the mass-flux rescale (modinlet.f90:756-766).

Everything is a pure function of an :class:`InletGen` dataclass carried in
``State.ig``: the reference's module arrays (Urec/Uinl/Utav/u0inletbc...,
modinletdata.f90) become state tensors; the z-coordinate bookkeeping
(loclow/locup searches, modinlet.f90:445-516) becomes vectorized
``searchsorted`` interpolation.  No value is read back to the host: the
level lookup of `blthicknesst` gathers with 1-element index tensors.

On a rank's block of an x/y split (``Grid.block``) the generated planes
``u0``..``t0`` are the block's y rows and ``Utav`` its x rows; the planes at
the recycle indices come from the ranks that hold them (``openbc.x_planes``),
every y mean is the domain's (one sum over the y column), and the
displacement thickness is the domain's (one sum over the x row), so that
every rank steps the same profiles.  `InletGenParams` stays whole.

The legacy `iinletgen=2` store/replay path (modinlet.f90:860-944 plus
writeinletfile/readinletfile) replays an ``inletdata.<exp>.npz`` of
recorded planes through the time-interpolating ``openbc.Inlet``
(``run.load_case``)."""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config, const
from ..grid import Grid
from .openbc import sv_planes, tile_profile, x_planes, y_means


@dataclass(frozen=True)
class InletGen:
    """Rescale-recycle state (modinletdata.f90 module arrays)."""
    Urec: torch.Tensor    # (nz,)   running j-avg u at the recycle plane
    Wrec: torch.Tensor    # (nz+1,) running j-avg w at irecy-1
    Trec: torch.Tensor    # (nz,)   running j-avg thl at irecy-1
    Uinl: torch.Tensor    # (nz,)   running j-avg u of the generated inlet
    Tinl: torch.Tensor    # (nz,)
    Utav: torch.Tensor    # (nx, nz) running j-avg u (displacement thickn.)
    utaui: torch.Tensor   # scalar: friction velocity at the inlet
    ttaui: torch.Tensor   # scalar: friction temperature at the inlet
    displ: torch.Tensor   # (nx,) displacement thickness
    ddispdx: torch.Tensor  # scalar: d(delta*)/dx (top-BC transpiration rate)
    u0: torch.Tensor      # (ny, nz)   generated inlet planes
    v0: torch.Tensor      # (ny, nz)
    w0: torch.Tensor      # (ny, nz+1)
    t0: torch.Tensor      # (ny, nz)


INLETGEN_NAMES = ("Urec", "Wrec", "Trec", "Uinl", "Tinl", "Utav", "utaui",
                  "ttaui", "displ", "ddispdx", "u0", "v0", "w0", "t0")


class InletGenParams:
    """Static parameters: target thicknesses, Heaviside and weight profiles,
    plane indices (initinlet, modinlet.f90:38-200)."""

    def __init__(self, cfg: Config, grid: Grid):
        """`grid` is the whole domain's (``Model.domain_grid``)."""
        zf = np.asarray(grid.zf, np.float64)
        zh = np.asarray(grid.zh, np.float64)
        xf = np.asarray(grid.xf, np.float64)
        d = cfg.driver
        self.irecy = max(int(d.iplane), 1)          # u sampled here,
        self.irecym = self.irecy - 1                # v/w/thl at irecy-1
        self.di = d.di if d.di > 0 else 0.5 * float(zh[-1])
        self.dti = d.dti if d.dti > 0 else self.di
        self.inletav = cfg.physics.inletav if cfg.physics.inletav > 0 \
            else 20.0
        self.lfixinlet = d.lfixinlet
        self.lfixutauin = d.lfixutauin
        self.lwallfunc = d.lwallfunc
        self.luvolflowr = cfg.physics.luvolflowr
        self.Uinf = cfg.bc.Uinf
        self.thls = cfg.bc.thls if cfg.bc.thls > 0 else 288.0
        self.thl_top = cfg.bc.thl_top if cfg.bc.thl_top > 0 else self.thls
        self.ltempeq = cfg.physics.ltempeq

        def heaviside(z, dlt):
            # smoothed step down across [1.2 d - eps, 1.2 d + eps]
            # (initinlet:99-118, eps = d/4)
            eps = 0.25 * dlt
            pfi = z - 1.2 * dlt - eps
            h = 0.5 * (1.0 - pfi / eps - np.sin(np.pi * pfi / eps) / np.pi)
            return np.where(pfi < -eps, 1.0, np.where(pfi > eps, 0.0, h))

        self.heavif = heaviside(zf, self.di)
        self.heavih = heaviside(zh, self.di)
        self.heavit = heaviside(zf, self.dti)
        self.xf = xf
        self.xfm = float(xf.mean())
        self.xf2m = float((xf ** 2).mean())
        self._cache: dict = {}

    def t(self, name: str, dtype, device) -> torch.Tensor:
        """Profile `name` as a cached (1, n) tensor."""
        key = (name, dtype, torch.device(device))
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(
                getattr(self, name), dtype=dtype, device=device)[None, :]
        return self._cache[key]


# -- thickness functions (modinlet.f90:1464-1811) ---------------------------

def momentumthicknessexp(u, dzf):
    """momentumthicknessexp (modinlet.f90:1464-1484)."""
    r = u / u[-1]
    return torch.sum((r - r * r) * dzf)


def enthalpythickness(t, u, dzf, thls):
    """enthalpythickness (modinlet.f90:1527-1565) with the reference's
    exact-zero regularizations."""
    thlsd = torch.where(t[-1] == thls, torch.full_like(t[-1], thls - 1e-6),
                        torch.full_like(t[-1], thls))
    eth = (u / u[-1]) * ((t - t[-1]) / (thlsd - t[-1])) * dzf
    s = torch.sum(eth)
    return torch.where(s == 0.0, 1e-6, s)


def blthicknesst(u, zf, zh0, crit):
    """blthicknesst (modinlet.f90:1691-1720): height where u first exceeds
    crit * u(top), linearly interpolated."""
    nz = u.shape[0]
    ucrit = crit * u[-1]
    above = u > ucrit
    # first True (0 if none); the lookups below gather with 1-element index
    # tensors so that the level never travels to the host
    k = torch.argmax(above.to(torch.int32)).reshape(1)
    km = torch.clamp(k - 1, min=0)
    at = lambda a, i: a.index_select(0, i)[0]
    interp = at(zf, km) + (at(zf, k) - at(zf, km)) \
        / (at(u, k) - at(u, km) + 1e-300) * (ucrit - at(u, km))
    first = zh0 + (zf[0] - zh0) / (u[0] + 1e-300) * ucrit
    out = torch.where(k[0] == 0, first, interp)
    return torch.where(torch.any(above), out, zf[nz - 1])


def wallawinlet(utan, dx, visc):
    """Werner-Wengle wall law -> tau (modinlet.f90:1815-1854)."""
    aaa, bbb = 8.3, 0.1428571429
    dxi = 1.0 / dx
    c1 = 0.5 * (1.0 - bbb) * aaa ** ((1.0 + bbb) / (1.0 - bbb))
    c2 = (1.0 + bbb) / aaa
    c3 = aaa ** (2.0 / (1.0 - bbb))
    c4 = 2.0 / (1.0 + bbb)
    ua = torch.abs(utan)
    utankr = 0.5 * visc * dxi * c3
    tausub = 2.0 * visc * ua * dxi
    taupow = (c1 * (visc * dxi) ** (1.0 + bbb)
              + (c2 * (visc * dxi) ** bbb) * ua) ** c4
    tau = torch.where(utankr - ua >= 0, tausub, taupow)
    return torch.sign(utan) * tau


# -- inner/outer interpolation (modinlet.f90:445-649) -----------------------

def _interp_profile(src_z, src_v, tgt_z, bottom0, top_v):
    """Reference interpolation with its extrapolation rules: below the
    first source point, linear from `bottom0` at z=0; above the last,
    constant `top_v`."""
    n = src_z.shape[0]
    idx = torch.searchsorted(src_z.contiguous(), tgt_z.contiguous())
    lo = torch.clamp(idx - 1, 0, n - 1)
    hi = torch.clamp(idx, 0, n - 1)
    den = src_z[hi] - src_z[lo]
    frac = (tgt_z - src_z[lo]) / torch.where(den == 0, 1.0, den)
    val = src_v[lo] + frac * (src_v[hi] - src_v[lo])
    val = torch.where(idx == 0,
                      bottom0 + (src_v[0] - bottom0) / src_z[0] * tgt_z, val)
    return torch.where(idx >= n, top_v, val)


def _interp_plane(src_z, src_v, tgt_z, bottom_scale, top_v):
    """Same lookup for fluctuation planes (ny, nz*): below the first source
    level the fluctuation scales linearly to 0 at z=0; above the last it is
    `top_v` (0 inner, 0 outer)."""
    n = src_z.shape[0]
    idx = torch.searchsorted(src_z.contiguous(), tgt_z.contiguous())
    lo = torch.clamp(idx - 1, 0, n - 1)
    hi = torch.clamp(idx, 0, n - 1)
    den = src_z[hi] - src_z[lo]
    frac = ((tgt_z - src_z[lo]) / torch.where(den == 0, 1.0, den))[None, :]
    val = src_v[:, lo] + frac * (src_v[:, hi] - src_v[:, lo])
    val = torch.where((idx == 0)[None, :],
                      src_v[:, :1] / src_z[0] * tgt_z[None, :], val)
    return torch.where((idx >= n)[None, :], top_v, val)


def init_inletgen(cfg: Config, grid: Grid, f, params: InletGenParams) \
        -> InletGen:
    """Initial inlet-generator state from the initial fields
    (modstartup.f90:1351-1443)."""
    kw = dict(dtype=f.u.dtype, device=f.u.device)
    ir, irm = params.irecy, params.irecym
    Uinl = f.u[0].mean(dim=0)
    Tinl = f.thl[0].mean(dim=0)
    numol = const.numol
    dzf0 = float(grid.dzf[0])
    utaui = torch.sqrt(torch.abs(wallawinlet(Uinl[0], dzf0, numol)))
    q0 = numol * const.prandtlmoli * 2.0 * (Tinl[0] - params.thls) / dzf0
    ttaui = q0 / torch.clamp(utaui, min=1e-10)
    ny = f.u.shape[1]
    nz = grid.ktot
    return InletGen(
        Urec=f.u[ir].mean(dim=0), Wrec=f.w[irm].mean(dim=0),
        Trec=f.thl[irm].mean(dim=0), Uinl=Uinl, Tinl=Tinl,
        Utav=f.u.mean(dim=1), utaui=utaui, ttaui=ttaui,
        displ=torch.zeros(grid.itot, **kw), ddispdx=torch.zeros((), **kw),
        u0=tile_profile(Uinl, ny).clone(), v0=torch.zeros((ny, nz), **kw),
        w0=torch.zeros((ny, nz + 1), **kw), t0=tile_profile(Tinl, ny).clone())


def inletgen_update(ig: InletGen, c, cfg: Config, grid: Grid,
                    dt, rk3step: int, params: InletGenParams) -> InletGen:
    """One substep of the generator (inletgen, modinlet.f90:202-944).

    `c` holds the current substep fields; `rk3step` is 1, 2 or 3.  The
    arithmetic runs in the field dtype, the float64 grid metrics cast
    down."""
    p = params
    fdt, dev = c.u.dtype, c.u.device
    metric = lambda name: grid.t(name, dev).to(fdt)
    zf, zh, dzf = metric("zf"), metric("zh"), metric("dzf")
    numol = const.numol
    rk3coef = dt / (4.0 - rk3step)
    # effective time advanced by this substep (modinlet.f90:265-273)
    deltat = (rk3coef if rk3step == 1 else
              rk3coef - dt / 3.0 if rk3step == 2 else rk3coef - dt / 2.0)
    avi = deltat / p.inletav
    ir, irm = p.irecy, p.irecym

    # running means at the recycle plane (modinlet.f90:283-313)
    upl, vpl, wpl, tpl = x_planes(grid, [(c.u, ir), (c.v, irm), (c.w, irm),
                                         (c.thl, irm)])
    urav, wrav, trav, utav = y_means(grid, [upl, wpl, tpl,
                                            c.u.transpose(0, 1)])
    Urec = urav * avi + (1.0 - avi) * ig.Urec
    Wrec = wrav * avi + (1.0 - avi) * ig.Wrec
    Trec = trav * avi + (1.0 - avi) * ig.Trec
    Utav = utav * avi + (1.0 - avi) * ig.Utav

    # fluctuations at the recycle plane (modinlet.f90:346-361)
    uprec = upl - Urec[None, :]
    vprec = vpl
    wprec = wpl - Wrec[None, :]
    tprec = tpl - Trec[None, :]

    # recycle-plane friction scales (modinlet.f90:364-377)
    if p.lwallfunc:
        utaur2 = wallawinlet(Urec[0], dzf[0], numol)
    else:
        utaur2 = 2.0 * numol * Urec[0] / dzf[0]
    utaur = torch.sqrt(torch.abs(utaur2))
    q0 = numol * const.prandtlmoli * 2.0 * (Trec[0] - p.thls) / dzf[0]
    ttaur = q0 / torch.clamp(utaur, min=1e-10)
    ttaur = torch.where(ttaur == 0.0, 1e-7, ttaur)

    # thicknesses (modinlet.f90:380-416)
    dr = blthicknesst(Urec, zf, zh[0], 0.99)
    dtr = blthicknesst(Trec - p.thls, zf, zh[0], 0.99)
    thetai = momentumthicknessexp(ig.Uinl, dzf)
    thetar = momentumthicknessexp(Urec, dzf)
    thetati = enthalpythickness(ig.Tinl, ig.Uinl, dzf, p.thls)
    thetatr = enthalpythickness(Trec, Urec, dzf, p.thls)
    thetati = torch.where(thetati == 0.0, 1e-7, thetati)

    # Ludwig-Tillmann-like utau ratio (modinlet.f90:418-434)
    utaui = ig.utaui if p.lfixutauin else \
        utaur * torch.abs(thetar / thetai) ** 0.125
    ttaui = ttaur * torch.abs(thetatr / thetati) ** 0.125
    gamm = utaui / torch.clamp(utaur, min=1e-10)
    lamb = ttaui / ttaur

    # inner / outer coordinates (modinlet.f90:436-443)
    zirf = utaur * zf / numol
    zirh = utaur * zh / numol
    ziif = utaui * zf / numol
    ziih = utaui * zh / numol
    zorf = zf / dr
    zorh = zh / dr
    zoif = zf / p.di
    zoih = zh / p.di
    zotr = zf / dtr
    zoti = zf / p.dti

    def grounded(w):
        # a slice, not w[0]: writing a Python number into a 0-d view of a
        # device tensor waits for the host
        w = w.clone()
        w[:1] = 0.0
        return w

    # inner interpolation + rescale (modinlet.f90:516-583, 652-658)
    Uinli = gamm * _interp_profile(zirf, Urec, ziif, 0.0, Urec[-1])
    Tinli = lamb * _interp_profile(zirf, Trec, ziif, p.thls, Trec[-1]) \
        + (1.0 - lamb) * p.thls
    Winli = grounded(_interp_profile(zirh, Wrec, ziih, 0.0, Wrec[-1]))
    upinli = gamm * _interp_plane(zirf, uprec, ziif, 0.0, 0.0)
    vpinli = gamm * _interp_plane(zirf, vprec, ziif, 0.0, 0.0)
    tpinli = lamb * _interp_plane(zirf, tprec, ziif, 0.0, 0.0)
    wpinli = gamm * _interp_plane(zirh, wprec, ziih, 0.0, 0.0)

    # outer interpolation + rescale (modinlet.f90:585-649, 659-668)
    Uinlo = gamm * _interp_profile(zorf, Urec, zoif, 0.0, p.Uinf) \
        + (1.0 - gamm) * p.Uinf
    Tinlo = lamb * _interp_profile(zotr, Trec, zoti, p.thls, p.thl_top) \
        + (1.0 - lamb) * p.thl_top
    Winlo = grounded(_interp_profile(zorh, Wrec, zoih, 0.0, Wrec[-1]))
    upinlo = gamm * _interp_plane(zorf, uprec, zoif, 0.0, 0.0)
    vpinlo = gamm * _interp_plane(zorf, vprec, zoif, 0.0, 0.0)
    tpinlo = lamb * _interp_plane(zotr, tprec, zoti, 0.0, 0.0)
    wpinlo = gamm * _interp_plane(zorh, wprec, zoih, 0.0, 0.0)

    # tanh weight function, alpha=4 b=0.2 (modinlet.f90:681-702)
    alpha, beta = 4.0, 0.2
    wfn = lambda zo: torch.clamp(0.5 * (
        1.0 + torch.tanh(alpha * (zo - beta) / ((1.0 - 2.0 * beta) * zo
                                                + beta)) / math.tanh(alpha)),
        max=1.0)
    wff, wfh, wft = wfn(zoif), wfn(zoih), wfn(zoti)

    # blended inlet planes with Heaviside-damped fluctuations
    # (modinlet.f90:706-725)
    hf = p.t("heavif", fdt, dev)
    hh = p.t("heavih", fdt, dev)
    ht = p.t("heavit", fdt, dev)
    u0 = (Uinli[None, :] + upinli * hf) * (1.0 - wff[None, :]) \
        + (Uinlo[None, :] + upinlo * hf) * wff[None, :]
    v0 = vpinli * hf * (1.0 - wff[None, :]) + vpinlo * hf * wff[None, :]
    t0 = (Tinli[None, :] + tpinli * ht) * (1.0 - wft[None, :]) \
        + (Tinlo[None, :] + tpinlo * ht) * wft[None, :]
    w0 = (Winli[None, :] + wpinli * hh) * (1.0 - wfh[None, :]) \
        + (Winlo[None, :] + wpinlo * hh) * wfh[None, :]
    w0[:, 0] = 0.0
    w0[:, -1] = 0.0

    # mass-flux rescale (modinlet.f90:740-766, luvolflowr)
    urav_new, tav = y_means(grid, [u0, t0])
    zsize = zh[-1] - zh[0]
    totalu = torch.sum(urav_new * dzf) / zsize
    if p.luvolflowr:
        totaluinl = torch.sum(ig.Uinl * dzf) / zsize
        scalef = totaluinl / torch.where(totalu == 0, 1.0, totalu)
        u0 = u0 * scalef
        urav_new = urav_new * scalef

    # running j+time-averaged inlet profiles (modinlet.f90:790-800)
    Uinl = ig.Uinl if p.lfixinlet else \
        urav_new * avi + (1.0 - avi) * ig.Uinl
    Tinl = tav * avi + (1.0 - avi) * ig.Tinl

    # displacement thickness + its x-slope (dispthicknessexp,
    # modinlet.f90:1569-1601): drives the top-BC transpiration
    dth = (1.0 - Utav / Utav[:, -1:]) * dzf[None, :]
    displ = torch.sum(dth, dim=1)
    mesh = grid.mesh
    if mesh is not None:
        # the domain's displ: this block's x rows, zeros elsewhere, summed
        # over the x row
        nx = p.xf.shape[0]
        displ = mesh.axis_sum([torch.cat([
            displ.new_zeros(grid.i0), displ,
            displ.new_zeros(nx - grid.i0 - grid.itot)])], "x")[0]
    dispm = displ.mean()
    xfdispm = (p.t("xf", fdt, dev)[0] * displ).mean()
    ddispdx = (xfdispm - p.xfm * dispm) / (p.xf2m - p.xfm ** 2)

    if not p.ltempeq:
        # inletgennotemp (modinlet.f90:946-1462): temperature untouched
        Trec, Tinl, t0 = ig.Trec, ig.Tinl, ig.t0
        ttaui = ig.ttaui
    return InletGen(Urec=Urec, Wrec=Wrec, Trec=Trec, Uinl=Uinl, Tinl=Tinl,
                    Utav=Utav, utaui=utaui, ttaui=ttaui, displ=displ,
                    ddispdx=ddispdx, u0=u0, v0=v0, w0=w0, t0=t0)


def inletgen_planes(ig: InletGen, inlet, ny: int, nz: int):
    """Planes dict for the x-inlet BC machinery (xmi_driver analogue):
    generated u/v/w/thl plus profile qt/e12/sv from the `Inlet` profiles."""
    zero = lambda: torch.zeros((ny, nz), dtype=ig.u0.dtype,
                               device=ig.u0.device)
    return dict(u=ig.u0, v=ig.v0, w=ig.w0, thl=ig.t0,
                qt=(tile_profile(inlet.qtprof, ny) if inlet is not None
                    else zero()),
                e12=(tile_profile(inlet.e12prof, ny) if inlet is not None
                     else zero()),
                sv=sv_planes(inlet.svprof if inlet is not None else None,
                              ny, nz, ig.u0))
