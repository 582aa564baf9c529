"""Time/space-averaged statistics (port of ``udales_tpu.io.stats``;
src/modstatsdump.f90).

Every family samples between steps when the simulated time crosses its
`tsample` cadence and writes its time means every `tstatsdump`.  The
accumulators are tensors on the fields' device and every reduction runs
there; a write makes one host copy of the accumulators.  The caller hands
each family the host value `t` of ``state.timee``, read once a step, so a
sample adds no host wait of its own.  The variable tables are the
reference's, letter for letter, so udbase-style post-processing reads the
files unchanged.

Each family that serves an event is a span of the run's trace named
`family` (``tdump``, ...), with the children ``sample`` and ``write``;
``NCWriter.append`` adds the bytes it is handed to ``write``.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .. import trace
from ..config import const
from ..ops import fused_vreman as fv, subgrid as sgs
from ..ops.thermo import avexy_masked, slab_mean, thermodynamics
from .ncwriter import NCWriter


def _host(a):
    return a.detach().cpu().numpy()


def _clean(a):
    """avexy_masked's -999 sentinel of an all-solid slab -> 0."""
    return torch.where(a < -900.0, 0.0, a)


def _avy(f, mk):
    """Mask-weighted y average, (nx, nz[+1]); `mk` None is all fluid."""
    if mk is None:
        return f.sum(dim=1) / f.shape[1]
    return (f * mk).sum(dim=1) / torch.clamp(mk.sum(dim=1), min=1.0)


def _mask_or_none(masks, name):
    return getattr(masks, name) if masks is not None else None


# ---------------------------------------------------------------------------
# Shared per-sample diagnostics (modstatsdump.f90:789-890): velocities and
# scalars interpolated to the flux positions (uw/vw/uv corners, w-levels,
# cell centres) plus the SGS flux fields built from the closure's ekm/ekh.
# ---------------------------------------------------------------------------

def _to_w_levels(f, grid):
    """Cell-centre -> w-level dzf-weighted interpolation
    (modstatsdump.f90:864 thlk): fk(k) = 0.5 dzhi(k) (f(k) dzf(k-1)
    + f(k-1) dzf(k)); boundary faces take the adjacent cell value."""
    dzf = grid.t("dzf", f.device)
    dzhi = grid.t("dzhi", f.device)
    interior = 0.5 * dzhi[1:-1] * (f[..., 1:] * dzf[:-1]
                                   + f[..., :-1] * dzf[1:])
    return torch.cat([f[..., :1], interior, f[..., -1:]], dim=-1)


def compute_diag(state, grid, cfg, model=None):
    """Corner/face interpolants + SGS fluxes for the statistics families.

    Returns a dict of 3-D fields: uik/wik (uw corner, w-levels), vjk/wjk
    (vw corner), uij/vij (uv corner, c-levels), uc/vc/wc (centres), thlk/
    qtk/svk (w-levels), and usgs/vsgs/wsgs/thlsgs/qtsgs/svsgs
    (modstatsdump.f90:835-890 formulas; ekm/ekh from the live closure, whose
    velocity ghosts take the open-boundary planes of an open case)."""
    from ..run import _velocity_ghosts
    c = state.c
    nz = grid.ktot
    dev = c.u.device
    dzf = grid.t("dzf", dev)
    dzfi = grid.t("dzfi", dev)
    dzhi = grid.t("dzhi", dev)
    dzhiq = grid.t("dzhiq", dev)
    dzh2i = grid.t("dzh2i", dev)
    rollx = lambda f: torch.roll(f, 1, dims=0)
    rolly = lambda f: torch.roll(f, 1, dims=1)

    d = {}
    d["uik"] = _to_w_levels(c.u, grid)
    d["vjk"] = _to_w_levels(c.v, grid)
    d["wik"] = 0.5 * (c.w + rollx(c.w))
    d["wjk"] = 0.5 * (c.w + rolly(c.w))
    d["uij"] = 0.5 * (c.u + rolly(c.u))
    d["vij"] = 0.5 * (c.v + rollx(c.v))
    d["uc"] = 0.5 * (torch.roll(c.u, -1, dims=0) + c.u)
    d["vc"] = 0.5 * (torch.roll(c.v, -1, dims=1) + c.v)
    d["wc"] = 0.5 * (c.w[..., 1:] + c.w[..., :-1])
    d["thlk"] = _to_w_levels(c.thl, grid)
    d["qtk"] = _to_w_levels(c.qt, grid)
    d["svk"] = (_to_w_levels(c.sv, grid) if c.sv.shape[0]
                else c.w.new_zeros((0,) + c.w.shape))

    if model is not None:
        th = thermodynamics(c, cfg, grid,
                            model.ibm.masks if model.ibm else None)
        # open-boundary cases build their ghosts from the inlet planes
        # (driver window, generator, recycling or the Inlet's own series)
        openx = openy = None
        if model.inlet is not None:
            openx = {"inlet": model._inlet_planes(state, c, state.ig),
                     "bx": c.bx}
        if model.inlet_y is not None:
            openy = {"inlet": model.inlet_y.planes(state.timee, grid.itot,
                                                   grid.ktot),
                     "by": c.by}
        g = _velocity_ghosts(c, cfg, grid, openx, openy)
        thvs = cfg.bc.thls if cfg.bc.thls > 0 else 288.0
        ekm, ekh, _ = fv.closure(g, grid, cfg, e12=c.e12,
                                 dthvdz=th.dthvdz, thl=c.thl, thvs=thvs)
    else:
        ekm = torch.zeros_like(c.u)
        ekh = torch.zeros_like(c.u)

    zface = torch.zeros_like(c.w[..., :1])

    def at_w(interior):          # pad faces 0 and nz with zeros
        return torch.cat([zface, interior, zface], dim=-1)

    # usgs (uw corner, modstatsdump.f90:835-838): emom (du/dz + dw/dx)
    emom_uw = (dzf[:-1] * 0.5 * (ekm[..., 1:] + rollx(ekm)[..., 1:])
               + dzf[1:] * 0.5 * (ekm[..., :-1] + rollx(ekm)[..., :-1])
               ) * dzhiq[1:-1]
    dudz = (c.u[..., 1:] - c.u[..., :-1]) * dzhi[1:-1]
    dwdx = (c.w - rollx(c.w))[..., 1:nz] * grid.dxi
    d["usgs"] = at_w(emom_uw * (dudz + dwdx))
    # vsgs (vw corner, :840-845)
    emom_vw = (dzf[:-1] * 0.5 * (ekm[..., 1:] + rolly(ekm)[..., 1:])
               + dzf[1:] * 0.5 * (ekm[..., :-1] + rolly(ekm)[..., :-1])
               ) * dzhiq[1:-1]
    dvdz = (c.v[..., 1:] - c.v[..., :-1]) * dzhi[1:-1]
    dwdy = (c.w - rolly(c.w))[..., 1:nz] * grid.dyi
    d["vsgs"] = at_w(emom_vw * (dvdz + dwdy))
    # wsgs at w-levels (:852-856)
    gradw = (c.w[..., 1:] - c.w[..., :-1]) * dzfi      # per cell
    d["wsgs"] = at_w((ekm[..., 1:] * gradw[..., 1:]
                      - ekm[..., :-1] * gradw[..., :-1])
                     * 2.0 * dzhi[1:-1])
    # scalar SGS fluxes at w-levels (:869-889); the scalar stack at once
    ekh_w = 0.5 * (dzf[:-1] * ekh[..., 1:] + dzf[1:] * ekh[..., :-1])

    def sgs_scalar(f):
        return torch.cat([
            torch.zeros_like(f[..., :1]),
            ekh_w * (f[..., 1:] - f[..., :-1]) * dzh2i[1:-1],
            torch.zeros_like(f[..., :1])], dim=-1)
    d["thlsgs"] = sgs_scalar(c.thl)
    d["qtsgs"] = sgs_scalar(c.qt)
    d["svsgs"] = (sgs_scalar(c.sv) if c.sv.shape[0]
                  else c.w.new_zeros((0,) + c.w.shape))
    return d


def corner_masks(masks, w):
    """Approximate IIuw/IIvw corner masks from the staggered fluid masks
    (the reference precomputes exact IIuw; here corner fluidity requires
    both adjacent u/v cells fluid), shaped like the w field `w`.  Without
    masks every point is fluid: (None, None, None)."""
    if masks is None:
        return None, None, None
    mk_w = lambda m: torch.cat(
        [torch.zeros_like(m[..., :1]), m[..., 1:] * m[..., :-1],
         m[..., -1:]], dim=-1)
    return mk_w(masks.u), mk_w(masks.v), masks


_N_SV_STATS = 3   # the reference writes sca1..sca3 in y/yt families


@dataclass(frozen=True)
class XYTAccum:
    n: Any
    u: Any; v: Any; w: Any; thl: Any; qt: Any; p: Any
    uu: Any; vv: Any; ww: Any; thl2: Any; qt2: Any
    uw: Any; wthl: Any; wqt: Any
    vw: Any; uv: Any
    uik: Any; wik: Any; vjk: Any; wjk: Any; uij: Any; vij: Any
    ucm: Any; vcm: Any
    usgs: Any; vsgs: Any; thlsgs: Any


_XYT_W = ("w", "ww", "uw", "wthl", "wqt", "vw", "uik", "wik", "vjk", "wjk",
          "usgs", "vsgs", "thlsgs")


def zero_accum(nz, dtype, device="cpu") -> XYTAccum:
    """Zero `XYTAccum`: (nz,) profiles, (nz + 1,) at the w levels."""
    z = lambda n: torch.zeros(n, dtype=dtype, device=device)
    return XYTAccum(n=z(()), **{
        f.name: z(nz + 1 if f.name in _XYT_W else nz)
        for f in fields(XYTAccum) if f.name != "n"})


def sample(acc: XYTAccum, state, masks=None, diag=None) -> XYTAccum:
    """Accumulate one sample of masked slab averages (modstatsdump.f90
    xytdump sampling; flux positions per compute_diag)."""
    c = state.c
    IIu, IIv, IIc, IIw = (_mask_or_none(masks, k) for k in "uvcw")
    IIuw, IIvw, _ = corner_masks(masks, c.w)
    A = lambda f, m: _clean(avexy_masked(f, m))
    d = diag
    return XYTAccum(
        n=acc.n + 1,
        u=acc.u + A(c.u, IIu), v=acc.v + A(c.v, IIv),
        w=acc.w + A(c.w, IIw),
        thl=acc.thl + A(c.thl, IIc), qt=acc.qt + A(c.qt, IIc),
        p=acc.p + A(state.pres, IIc),
        uu=acc.uu + A(d["uc"] ** 2, IIc), vv=acc.vv + A(d["vc"] ** 2, IIc),
        ww=acc.ww + A(c.w ** 2, IIw),
        thl2=acc.thl2 + A(c.thl ** 2, IIc),
        qt2=acc.qt2 + A(c.qt ** 2, IIc),
        uw=acc.uw + A(d["uik"] * d["wik"], IIuw),
        wthl=acc.wthl + A(d["thlk"] * c.w, IIw),
        wqt=acc.wqt + A(d["qtk"] * c.w, IIw),
        vw=acc.vw + A(d["vjk"] * d["wjk"], IIvw),
        uv=acc.uv + A(d["uij"] * d["vij"], IIc),
        uik=acc.uik + A(d["uik"], IIuw), wik=acc.wik + A(d["wik"], IIuw),
        vjk=acc.vjk + A(d["vjk"], IIvw), wjk=acc.wjk + A(d["wjk"], IIvw),
        uij=acc.uij + A(d["uij"], IIc), vij=acc.vij + A(d["vij"], IIc),
        ucm=acc.ucm + A(d["uc"], IIc), vcm=acc.vcm + A(d["vc"], IIc),
        usgs=acc.usgs + A(d["usgs"], IIuw),
        vsgs=acc.vsgs + A(d["vsgs"], IIvw),
        thlsgs=acc.thlsgs + A(d["thlsgs"], IIw))


def _at_w(f):
    """Cell values -> w levels along the last axis: the two boundary faces
    take the adjacent cell, the interior the mean of the two cells."""
    return torch.cat([f[..., :1], 0.5 * (f[..., 1:] + f[..., :-1]),
                      f[..., -1:]], dim=-1)


def _np_at_w(f):
    return np.concatenate([f[..., :1], 0.5 * (f[..., 1:] + f[..., :-1]),
                           f[..., -1:]], axis=-1)


class _Sampled:
    """Cadence of the families that accumulate every `tsample` and write
    their means every `tstatsdump`: `acc` is a dict of device tensors (or an
    `XYTAccum`), `_acc(acc, state, masks)` one sample, `write(t)` the
    means."""

    def _cadence(self, cfg):
        self.tnext_sample = cfg.output.tsample
        self.tnext_write = cfg.output.tstatsdump

    def due(self, t: float) -> bool:
        """Whether the simulated time `t` has reached the sample cadence."""
        return t >= self.tnext_sample

    def maybe_sample(self, state, t: float, masks=None):
        """Sample when the simulated time `t` (the host copy of
        ``state.timee``) has reached the cadence, and write the means when
        it has reached the write cadence."""
        if not self.due(t):
            return
        self.tnext_sample += self.cfg.output.tsample
        with trace.span(self.family):
            with trace.span("sample"):
                self.acc = self._acc(self.acc, state, masks)
            if t >= self.tnext_write:
                self.tnext_write += self.cfg.output.tstatsdump
                with trace.span("write"):
                    self.write(t)

    def _host_acc(self):
        return {k: _host(v) for k, v in self.acc.items()}

    def close(self):
        self.writer.close()


class TKEDump(_Sampled):
    """Resolved TKE budget profiles (modstatsdump ltkedump /
    modstatistics.tkestats): shear production, buoyancy, turbulent
    transport, pressure transport, SGS dissipation, and the TKE itself,
    written to tkedump.<exp>.nc every tstatsdump."""

    family = "tkedump"

    # descriptive names plus the reference's ncstattke aliases
    # (modstatsdump.f90:396-404: p_b t_p adv t_t t_sgs p_t t_v d_sgs) so
    # udbase-style post-processing finds the expected variables
    _VARS = [
        ("tke", ("zt",), "m^2/s^2"),
        ("shear", ("zt",), "m^2/s^3"),
        ("buoy", ("zt",), "m^2/s^3"),
        ("ttrans", ("zt",), "m^2/s^3"),
        ("ptrans", ("zt",), "m^2/s^3"),
        ("sgsdiss", ("zt",), "m^2/s^3"),
        ("resid", ("zt",), "m^2/s^3"),
        ("p_b", ("zt",), "m^2/s^3"),     # buoyancy production (== buoy)
        ("t_p", ("zt",), "m^2/s^3"),     # pressure transport (== ptrans)
        ("adv", ("zt",), "m^2/s^3"),     # advection by the mean wind
        ("t_t", ("zt",), "m^2/s^3"),     # turbulent transport (== ttrans)
        ("t_sgs", ("zt",), "m^2/s^3"),   # SGS transport
        ("p_t", ("zt",), "m^2/s^3"),     # shear production (== shear)
        ("t_v", ("zt",), "m^2/s^3"),     # resolved viscous dissipation
        ("d_sgs", ("zt",), "m^2/s^3"),   # SGS dissipation
    ]

    def __init__(self, cfg, grid, outdir: str | Path = ".", model=None,
                 device="cpu"):
        self.cfg = cfg
        self.grid = grid
        self.model = model
        self.device = torch.device(device)
        exp = f"{cfg.run.iexpnr:03d}"
        self.writer = NCWriter(Path(outdir) / f"tkedump.{exp}.nc", grid)
        for name, dims, units in self._VARS:
            self.writer.define(name, dims, units)
        self._zero()
        self._cadence(cfg)

    def _zero(self):
        nz = self.grid.ktot
        kw = dict(dtype=self.grid.torch_dtype, device=self.device)
        z = lambda n=nz: torch.zeros(n, **kw)
        self.acc = dict(n=z(()), u=z(), v=z(), w=z(nz + 1),
                        uu=z(), vv=z(), ww=z(nz + 1), uw=z(nz + 1),
                        wthv=z(nz + 1), thvw=z(nz + 1), we=z(nz + 1),
                        wp=z(nz + 1), eps=z(), eps_mol=z(),
                        fsgs=z(nz + 1))

    def _acc(self, acc, state, masks=None):
        from ..run import _velocity_ghosts
        c = state.c
        nz = self.grid.ktot
        av = slab_mean
        u_at_w = _at_w(c.u)
        v_at_w = _at_w(c.v)
        thv_at_w = _at_w(c.thl)
        e_at_w = 0.5 * (u_at_w ** 2 + v_at_w ** 2 + c.w ** 2)
        p_at_w = _at_w(state.pres)
        # SGS dissipation estimate: ekm * 2 S_ij S_ij from the closure
        g = _velocity_ghosts(c, self.model.cfg, self.grid)
        s2 = sgs._strain2(g, self.grid)
        ekm, ekh, _ = fv.closure(g, self.grid, self.model.cfg, e12=c.e12,
                                 dthvdz=None, thl=c.thl, thvs=288.0)
        eps = av(ekm * 2.0 * s2)
        eps_mol = av(const.numol * 2.0 * s2)
        # SGS flux of resolved KE through w faces: ekm|_w * d(e)/dz
        # (profile reduction of the reference's tsgsmz terms,
        # modstatsdump.f90 tkestatsdump)
        e_c = 0.5 * (c.u ** 2 + c.v ** 2
                     + (0.5 * (c.w[..., 1:] + c.w[..., :-1])) ** 2)
        dzhi = self.grid.t("dzhi", c.u.device)
        dedz = (e_c[..., 1:] - e_c[..., :-1]) * dzhi[1:nz]
        ekm_w = 0.5 * (ekm[..., 1:] + ekm[..., :-1])
        zpl = e_c.new_zeros(e_c.shape[:2] + (1,))
        fsgs = av(torch.cat([zpl, ekm_w * dedz, zpl], dim=2))
        return dict(
            n=acc["n"] + 1,
            u=acc["u"] + av(c.u), v=acc["v"] + av(c.v),
            w=acc["w"] + av(c.w),
            uu=acc["uu"] + av(c.u ** 2), vv=acc["vv"] + av(c.v ** 2),
            ww=acc["ww"] + av(c.w ** 2),
            uw=acc["uw"] + av(u_at_w * c.w),
            wthv=acc["wthv"] + av(thv_at_w * c.w),
            thvw=acc["thvw"] + av(thv_at_w),
            we=acc["we"] + av(e_at_w * c.w),
            wp=acc["wp"] + av(p_at_w * c.w),
            eps=acc["eps"] + eps, eps_mol=acc["eps_mol"] + eps_mol,
            fsgs=acc["fsgs"] + fsgs)

    def write(self, t):
        a = self._host_acc()
        n = max(float(a["n"]), 1.0)
        g = self.grid
        nz = g.ktot
        m = lambda k: a[k] / n
        u, v, w = m("u"), m("v"), m("w")
        u_w = np.concatenate([u[:1], 0.5 * (u[1:] + u[:-1]), u[-1:]])
        upwp = m("uw") - u_w * w
        dudz = np.zeros(nz + 1)
        dudz[1:nz] = (u[1:] - u[:-1]) / g.dzh[1:nz]
        shear_w = -upwp * dudz
        shear = 0.5 * (shear_w[1:] + shear_w[:-1])
        thv_mean_w = m("thvw")
        wpthvp = m("wthv") - w * thv_mean_w
        buoy_w = const.grav / np.maximum(thv_mean_w, 1.0) * wpthvp
        buoy = 0.5 * (buoy_w[1:] + buoy_w[:-1])
        we = m("we")
        ttrans = -(we[1:] - we[:-1]) / g.dzf
        wp_ = m("wp")
        ptrans = -(wp_[1:] - wp_[:-1]) / g.dzf
        up2 = m("uu") - u ** 2
        vp2 = m("vv") - v ** 2
        wp2 = m("ww") - w ** 2
        tke = 0.5 * (up2 + vp2 + 0.5 * (wp2[1:] + wp2[:-1]))
        sgsdiss = -m("eps")
        resid = shear + buoy + ttrans + ptrans + sgsdiss
        # reference-name terms (modstatsdump.f90 tkestatsdump):
        # adv = <u_j> d(tke)/dx_j; in the slab-profile reduction only the
        # vertical term survives (x/y slab gradients vanish)
        dtkedz = np.zeros(nz + 1)
        dtkedz[1:nz] = (tke[1:] - tke[:-1]) / g.dzh[1:nz]
        adv = 0.5 * (w[1:] * dtkedz[1:] + w[:-1] * dtkedz[:-1])
        fsgs = m("fsgs")
        t_sgs = (fsgs[1:] - fsgs[:-1]) / g.dzf
        t_v = -m("eps_mol")                  # resolved viscous dissipation
        d_sgs = sgsdiss - t_v                # SGS-only part of -eps_total
        self.writer.append(t, {
            "tke": tke, "shear": shear, "buoy": buoy, "ttrans": ttrans,
            "ptrans": ptrans, "sgsdiss": sgsdiss, "resid": resid,
            "p_b": buoy, "t_p": ptrans, "adv": adv, "t_t": ttrans,
            "t_sgs": t_sgs, "p_t": shear, "t_v": t_v, "d_sgs": d_sgs})
        self._zero()


class TDump(_Sampled):
    """3-D time-averaged fields + second moments (modstatsdump ltdump,
    ncinfo table at modstatsdump.f90:289-324): means ut/vt/wt/thlt/qtt/pt
    + sca<n>t, turbulent fluxes upwpt/vpwpt/upvpt/wpthlpt/wpsca<n>pt,
    variances thlpthlpt/upuptc/vpvptc/wpwptc/tketc/sca<n>psca<n>pt, and
    SGS scalar fluxes sv<n>sgs; written to tdump.<exp>.nc every
    tstatsdump."""

    family = "tdump"

    def __init__(self, cfg, grid, outdir: str | Path = ".", nsv: int = 0,
                 model=None, device="cpu"):
        self.cfg = cfg
        self.grid = grid
        self.nsv = nsv
        self.model = model
        self.device = torch.device(device)
        exp = f"{cfg.run.iexpnr:03d}"
        self.writer = NCWriter(Path(outdir) / f"tdump.{exp}.nc", grid)
        for name, dims in (("ut", ("zt", "yt", "xm")),
                           ("vt", ("zt", "ym", "xt")),
                           ("wt", ("zm", "yt", "xt")),
                           ("thlt", ("zt", "yt", "xt")),
                           ("qtt", ("zt", "yt", "xt")),
                           ("pt", ("zt", "yt", "xt")),
                           ("upwpt", ("zm", "yt", "xm")),
                           ("vpwpt", ("zm", "ym", "xt")),
                           ("upvpt", ("zt", "ym", "xm")),
                           ("wpthlpt", ("zm", "yt", "xt")),
                           ("thlpthlpt", ("zt", "yt", "xt")),
                           ("upuptc", ("zt", "yt", "xt")),
                           ("vpvptc", ("zt", "yt", "xt")),
                           ("wpwptc", ("zt", "yt", "xt")),
                           ("tketc", ("zt", "yt", "xt"))):
            self.writer.define(name, dims)
        # the reference defines the FULL fixed table (nstatt=32,
        # modstatsdump.f90:40) regardless of nsv — scalar slots beyond nsv
        # and the chemistry PSS defect are written as zeros
        for n in range(4):
            self.writer.define(f"sca{n+1}t", ("zt", "yt", "xt"))
            self.writer.define(f"wpsca{n+1}pt", ("zm", "yt", "xt"))
            self.writer.define(f"sca{n+1}psca{n+1}pt", ("zt", "yt", "xt"))
            self.writer.define(f"sv{n+1}sgs", ("zm", "yt", "xt"))
        self.writer.define("PSS", ("zt", "yt", "xt"))
        self._zero()
        self._cadence(cfg)

    def _zero(self):
        nx, ny, nz = self.grid.shape
        kw = dict(dtype=self.grid.torch_dtype, device=self.device)
        z = lambda *s: torch.zeros(s, **kw)
        c3, w3 = (nx, ny, nz), (nx, ny, nz + 1)
        self.acc = dict(n=z(), **{k: z(*c3) for k in (
            "u", "v", "thl", "qt", "p", "thl2", "uc", "vc", "wc", "uc2",
            "vc2", "wc2", "uv", "uij", "vij")}, **{k: z(*w3) for k in (
                "w", "uw", "vw", "uik", "wik", "vjk", "wjk", "wthl")},
            sv=z(self.nsv, *c3), sv2=z(self.nsv, *c3),
            wsv=z(self.nsv, *w3), svsgs=z(self.nsv, *w3))

    def _acc(self, acc, state, masks=None):
        d = compute_diag(state, self.grid, self.cfg, self.model)
        c = state.c
        return dict(
            n=acc["n"] + 1, u=acc["u"] + c.u, v=acc["v"] + c.v,
            w=acc["w"] + c.w, thl=acc["thl"] + c.thl, qt=acc["qt"] + c.qt,
            p=acc["p"] + state.pres,
            thl2=acc["thl2"] + c.thl ** 2,
            uc=acc["uc"] + d["uc"], vc=acc["vc"] + d["vc"],
            wc=acc["wc"] + d["wc"],
            uc2=acc["uc2"] + d["uc"] ** 2, vc2=acc["vc2"] + d["vc"] ** 2,
            wc2=acc["wc2"] + d["wc"] ** 2,
            uw=acc["uw"] + d["uik"] * d["wik"],
            vw=acc["vw"] + d["vjk"] * d["wjk"],
            uv=acc["uv"] + d["uij"] * d["vij"],
            uik=acc["uik"] + d["uik"], wik=acc["wik"] + d["wik"],
            vjk=acc["vjk"] + d["vjk"], wjk=acc["wjk"] + d["wjk"],
            uij=acc["uij"] + d["uij"], vij=acc["vij"] + d["vij"],
            wthl=acc["wthl"] + d["thlk"] * c.w,
            sv=acc["sv"] + c.sv, sv2=acc["sv2"] + c.sv ** 2,
            wsv=acc["wsv"] + d["svk"] * c.w[None],
            svsgs=acc["svsgs"] + d["svsgs"])

    def write(self, t):
        a = self._host_acc()
        n = max(float(a["n"]), 1.0)
        nz = self.grid.ktot
        m = lambda k: a[k] / n
        u, w, thl = m("u"), m("w"), m("thl")
        thl_at_w = _np_at_w(thl)
        up2 = m("uc2") - m("uc") ** 2
        vp2 = m("vc2") - m("vc") ** 2
        wp2 = m("wc2") - m("wc") ** 2
        data = {
            "ut": u, "vt": m("v"), "wt": w[..., :nz], "thlt": thl,
            "qtt": m("qt"), "pt": m("p"),
            "upwpt": (m("uw") - m("uik") * m("wik"))[..., :nz],
            "vpwpt": (m("vw") - m("vjk") * m("wjk"))[..., :nz],
            "upvpt": m("uv") - m("uij") * m("vij"),
            "wpthlpt": (m("wthl") - thl_at_w * w)[..., :nz],
            "thlpthlpt": m("thl2") - thl ** 2,
            "upuptc": up2, "vpvptc": vp2, "wpwptc": wp2,
            "tketc": 0.5 * (up2 + vp2 + wp2),
        }
        sv, sv2, wsv, svsgs = m("sv"), m("sv2"), m("wsv"), m("svsgs")
        zero = np.zeros_like(u)
        for i in range(4):
            if i < self.nsv:
                data[f"sca{i+1}t"] = sv[i]
                data[f"wpsca{i+1}pt"] = (wsv[i] - _np_at_w(sv[i]) * w)[..., :nz]
                data[f"sca{i+1}psca{i+1}pt"] = sv2[i] - sv[i] ** 2
                data[f"sv{i+1}sgs"] = svsgs[i][..., :nz]
            else:
                data[f"sca{i+1}t"] = zero
                data[f"wpsca{i+1}pt"] = zero
                data[f"sca{i+1}psca{i+1}pt"] = zero
                data[f"sv{i+1}sgs"] = zero
        data["PSS"] = zero   # chemistry PSS defect (lchem + nsv>2 only)
        self.writer.append(t, data)
        self._zero()


class MinTDump(_Sampled):
    """Minimal 3-D time-averaged prognostics (modstatsdump lmintdump,
    modstatsdump.f90:341-363,1670-1684): writes mintdump.<exp>.nc with
    time means of u, v, w, thl, qt, p every tstatsdump."""

    family = "mintdump"

    def __init__(self, cfg, grid, outdir: str | Path = ".", device="cpu"):
        self.cfg = cfg
        self.grid = grid
        self.device = torch.device(device)
        exp = f"{cfg.run.iexpnr:03d}"
        self.writer = NCWriter(Path(outdir) / f"mintdump.{exp}.nc", grid)
        for name, dims in (("ut", ("zt", "yt", "xm")),
                           ("vt", ("zt", "ym", "xt")),
                           ("wt", ("zm", "yt", "xt")),
                           ("thlt", ("zt", "yt", "xt")),
                           ("qtt", ("zt", "yt", "xt")),
                           ("pt", ("zt", "yt", "xt"))):
            self.writer.define(name, dims)
        self._zero()
        self._cadence(cfg)

    def _acc(self, acc, state, masks=None):
        c = state.c
        return dict(n=acc["n"] + 1, u=acc["u"] + c.u, v=acc["v"] + c.v,
                    w=acc["w"] + c.w, thl=acc["thl"] + c.thl,
                    qt=acc["qt"] + c.qt, p=acc["p"] + state.pres)

    def _zero(self):
        nx, ny, nz = self.grid.shape
        kw = dict(dtype=self.grid.torch_dtype, device=self.device)
        z = lambda *s: torch.zeros(s, **kw)
        self.acc = dict(n=z(), u=z(nx, ny, nz),
                        v=z(nx, ny, nz), w=z(nx, ny, nz + 1),
                        thl=z(nx, ny, nz), qt=z(nx, ny, nz),
                        p=z(nx, ny, nz))

    def write(self, t):
        a = self._host_acc()
        n = max(float(a["n"]), 1.0)
        nz = self.grid.ktot
        self.writer.append(t, {
            "ut": a["u"] / n, "vt": a["v"] / n, "wt": a["w"][..., :nz] / n,
            "thlt": a["thl"] / n, "qtt": a["qt"] / n, "pt": a["p"] / n})
        self._zero()


class TreeDump(_Sampled):
    """Time-averaged vegetation source terms (modstatsdump ltreedump,
    modstatsdump.f90:364-390,1237-1290): writes treedump.<exp>.nc with
    means of the canopy drag/energy-balance/deposition tendencies."""

    family = "treedump"

    VARS = ("tr_u", "tr_v", "tr_w", "tr_thl", "tr_qt", "tr_qtR", "tr_qtA",
            "tr_sv1", "tr_sv2", "tr_omega")

    def __init__(self, cfg, grid, vegetation, outdir: str | Path = ".",
                 device="cpu"):
        self.cfg = cfg
        self.grid = grid
        self.veg = vegetation
        self.device = torch.device(device)
        exp = f"{cfg.run.iexpnr:03d}"
        self.writer = NCWriter(Path(outdir) / f"treedump.{exp}.nc", grid)
        for name in self.VARS:
            zdim = "zm" if name == "tr_w" else "zt"
            self.writer.define(name, (zdim, "yt", "xt"))
        self._zero()
        self._cadence(cfg)

    def _acc(self, acc, state, masks=None):
        d = self.veg.diagnostics(state.c)
        out = {k: acc[k] + d[k] for k in self.VARS}
        out["n"] = acc["n"] + 1
        return out

    def _zero(self):
        kw = dict(dtype=self.grid.torch_dtype, device=self.device)
        self.acc = {k: torch.zeros(self.grid.shape, **kw) for k in self.VARS}
        self.acc["n"] = torch.zeros((), **kw)

    def write(self, t):
        a = self._host_acc()
        n = max(float(a["n"]), 1.0)
        self.writer.append(t, {k: a[k] / n for k in self.VARS})
        self._zero()


class SliceDump:
    """Instantaneous k/i/j slices every tsample (modstatsdump l*slicedump):
    kslicedump.<exp>.nc etc."""

    family = "slices"

    def __init__(self, cfg, grid, outdir: str | Path = ".", nsv: int = 0):
        self.cfg = cfg
        self.grid = grid
        self.writers = {}
        exp = f"{cfg.run.iexpnr:03d}"
        o = cfg.output
        # variable names follow modstatsdump.f90:424-484 ncinfo tables so
        # udbase reads the files unchanged
        if o.lkslicedump:
            w = NCWriter(Path(outdir) / f"kslicedump.{exp}.nc", grid)
            for v in ("u_kslice", "v_kslice", "w_kslice", "thl_kslice",
                      "qt_kslice"):
                w.define(v, ("yt", "xt"))
            self.writers["k"] = w
        if o.lislicedump:
            w = NCWriter(Path(outdir) / f"islicedump.{exp}.nc", grid)
            for v in ("u_islice", "v_islice", "w_islice", "thl_islice",
                      "qt_islice"):
                w.define(v, ("zt", "yt"))
            self.writers["i"] = w
        if o.ljslicedump:
            w = NCWriter(Path(outdir) / f"jslicedump.{exp}.nc", grid)
            for v in ("u_jslice", "v_jslice", "w_jslice", "thl_jslice",
                      "qt_jslice"):
                w.define(v, ("zt", "xt"))
            self.writers["j"] = w
        self.tnext = cfg.output.tsample

    def due(self, t: float) -> bool:
        """Whether a slice is written at the simulated time `t`."""
        return t >= self.tnext and bool(self.writers)

    def maybe_dump(self, state, t: float):
        if not self.due(t):
            return
        self.tnext += self.cfg.output.tsample
        c = state.c
        o = self.cfg.output
        nz = self.grid.ktot
        # one host copy of the five slices of each direction
        cuts = {}
        with trace.span(self.family):
            with trace.span("sample"):
                if "k" in self.writers:
                    k = min(o.kslice - 1, nz - 1)
                    cuts["k"] = [c.u[:, :, k], c.v[:, :, k], c.w[:, :, k],
                                 c.thl[:, :, k], c.qt[:, :, k]]
                if "i" in self.writers:
                    i = min(o.islice - 1, self.grid.itot - 1)
                    cuts["i"] = [c.u[i], c.v[i], c.w[i, :, :nz], c.thl[i],
                                 c.qt[i]]
                if "j" in self.writers:
                    j = min(o.jslice - 1, self.grid.jtot - 1)
                    cuts["j"] = [c.u[:, j], c.v[:, j], c.w[:, j, :nz],
                                 c.thl[:, j], c.qt[:, j]]
                cuts = {d: _host(torch.stack(f)) for d, f in cuts.items()}
            with trace.span("write"):
                for d, s in cuts.items():
                    self.writers[d].append(t, {
                        f"{v}_{d}slice": a.T for v, a in zip(
                            ("u", "v", "w", "thl", "qt"), s)})

    def close(self):
        for w in self.writers.values():
            w.close()


class YTDump(_Sampled):
    """y- and time-averaged x-z statistics (modstatsdump lytdump, ncinfo
    table at modstatsdump.f90:164-202): means, turbulent + kinematic +
    SGS fluxes, and variances of u/w/thl/qt/sca<n> on the x-z plane."""

    family = "ytdump"

    def __init__(self, cfg, grid, outdir: str | Path = ".", masks=None,
                 nsv: int = 0, model=None, device="cpu"):
        self.cfg = cfg
        self.grid = grid
        self.model = model
        self.device = torch.device(device)
        self.nsv = min(nsv, _N_SV_STATS)
        exp = f"{cfg.run.iexpnr:03d}"
        self.writer = NCWriter(Path(outdir) / f"ytdump.{exp}.nc", grid)
        names = ["uyt", "vyt", "wyt", "thlyt", "qtyt",
                 "upwpyt", "wpthlpyt", "wpqtpyt",
                 "uwyt", "wthlyt", "wqtyt",
                 "upupyt", "wpwpyt", "thlpthlpyt", "qtpqtpyt",
                 "usgsyt", "wsgsyt", "thlsgsyt", "qtsgsyt"]
        # full fixed table (nstatyt=34, modstatsdump.f90:39): sca1..3
        # slots always defined, zeros beyond nsv
        for n in range(_N_SV_STATS):
            names += [f"sca{n+1}yt", f"wpsca{n+1}tpyt", f"wsca{n+1}yt",
                      f"sca{n+1}tpsca{n+1}pyt", f"sca{n+1}sgsyt"]
        self._names = names
        for v in names:
            self.writer.define(v, ("zt", "xt"))
        self._zero()
        self._cadence(cfg)

    def _acc(self, acc, state, masks=None):
        c = state.c
        nz = c.u.shape[2]
        mu, mc, mv, mw = (_mask_or_none(masks, k) for k in "ucvw")
        muw, _, _ = corner_masks(masks, c.w)
        d = compute_diag(state, self.grid, self.cfg, self.model)
        cw = lambda f: None if f is None else f[..., :nz]
        avy = _avy
        out = dict(
            n=acc["n"] + 1,
            u=acc["u"] + avy(c.u, mu), v=acc["v"] + avy(c.v, mv),
            w=acc["w"] + avy(cw(c.w), cw(mw)),
            thl=acc["thl"] + avy(c.thl, mc),
            qt=acc["qt"] + avy(c.qt, mc),
            uw=acc["uw"] + avy(cw(d["uik"] * d["wik"]), cw(muw)),
            wthl=acc["wthl"] + avy(cw(d["thlk"] * c.w), cw(mw)),
            wqt=acc["wqt"] + avy(cw(d["qtk"] * c.w), cw(mw)),
            uik=acc["uik"] + avy(cw(d["uik"]), cw(muw)),
            wik=acc["wik"] + avy(cw(d["wik"]), cw(muw)),
            thlk=acc["thlk"] + avy(cw(d["thlk"]), cw(mw)),
            qtk=acc["qtk"] + avy(cw(d["qtk"]), cw(mw)),
            wk=acc["wk"] + avy(cw(c.w), cw(mw)),
            uu=acc["uu"] + avy(c.u ** 2, mu),
            ww=acc["ww"] + avy(cw(c.w) ** 2, cw(mw)),
            thl2=acc["thl2"] + avy(c.thl ** 2, mc),
            qt2=acc["qt2"] + avy(c.qt ** 2, mc),
            usgs=acc["usgs"] + avy(cw(d["usgs"]), cw(muw)),
            wsgs=acc["wsgs"] + avy(cw(d["wsgs"]), cw(mw)),
            thlsgs=acc["thlsgs"] + avy(cw(d["thlsgs"]), cw(mw)),
            qtsgs=acc["qtsgs"] + avy(cw(d["qtsgs"]), cw(mw)),
        )
        for m_ in range(self.nsv):
            out[f"sv{m_}"] = acc[f"sv{m_}"] + avy(c.sv[m_], mc)
            out[f"sv2_{m_}"] = acc[f"sv2_{m_}"] + avy(c.sv[m_] ** 2, mc)
            out[f"wsv{m_}"] = acc[f"wsv{m_}"] + avy(
                cw(d["svk"][m_] * c.w), cw(mw))
            out[f"svk{m_}"] = acc[f"svk{m_}"] + avy(cw(d["svk"][m_]), cw(mw))
            out[f"svsgs{m_}"] = acc[f"svsgs{m_}"] + avy(
                cw(d["svsgs"][m_]), cw(mw))
        return out

    def _zero(self):
        nx, _, nz = self.grid.shape
        kw = dict(dtype=self.grid.torch_dtype, device=self.device)
        z = lambda: torch.zeros((nx, nz), **kw)
        keys = ["u", "v", "w", "thl", "qt", "uw", "wthl", "wqt", "uik",
                "wik", "thlk", "qtk", "wk", "uu", "ww", "thl2", "qt2",
                "usgs", "wsgs", "thlsgs", "qtsgs"]
        for m_ in range(self.nsv):
            keys += [f"sv{m_}", f"sv2_{m_}", f"wsv{m_}", f"svk{m_}",
                     f"svsgs{m_}"]
        self.acc = {k: z() for k in keys}
        self.acc["n"] = torch.zeros((), **kw)

    def write(self, t):
        a = self._host_acc()
        n = max(float(a["n"]), 1.0)
        m = lambda k: a[k] / n
        data = {
            "uyt": m("u"), "vyt": m("v"), "wyt": m("w"),
            "thlyt": m("thl"), "qtyt": m("qt"),
            "upwpyt": m("uw") - m("uik") * m("wik"),
            "wpthlpyt": m("wthl") - m("thlk") * m("wk"),
            "wpqtpyt": m("wqt") - m("qtk") * m("wk"),
            "uwyt": m("uw"), "wthlyt": m("wthl"), "wqtyt": m("wqt"),
            "upupyt": m("uu") - m("u") ** 2,
            "wpwpyt": m("ww") - m("w") ** 2,
            "thlpthlpyt": m("thl2") - m("thl") ** 2,
            "qtpqtpyt": m("qt2") - m("qt") ** 2,
            "usgsyt": m("usgs"), "wsgsyt": m("wsgs"),
            "thlsgsyt": m("thlsgs"), "qtsgsyt": m("qtsgs"),
        }
        zero = np.zeros_like(data["uyt"])
        for i in range(_N_SV_STATS):
            if i < self.nsv:
                data[f"sca{i+1}yt"] = m(f"sv{i}")
                data[f"wpsca{i+1}tpyt"] = (m(f"wsv{i}")
                                           - m(f"svk{i}") * m("wk"))
                data[f"wsca{i+1}yt"] = m(f"wsv{i}")
                data[f"sca{i+1}tpsca{i+1}pyt"] = (m(f"sv2_{i}")
                                                  - m(f"sv{i}") ** 2)
                data[f"sca{i+1}sgsyt"] = m(f"svsgs{i}")
            else:
                for v in (f"sca{i+1}yt", f"wpsca{i+1}tpyt",
                          f"wsca{i+1}yt", f"sca{i+1}tpsca{i+1}pyt",
                          f"sca{i+1}sgsyt"):
                    data[v] = zero
        self.writer.append(t, data)
        self._zero()


class XYDump:
    """Instantaneous slab-average profiles every tsample (modstatsdump
    lxydump, ncinfo table at modstatsdump.f90:218-233): means, turbulent
    fluxes (primes vs the instantaneous slab mean), SGS fluxes, kinematic
    fluxes."""

    family = "xydump"

    _VARS = ["uxy", "vxy", "wxy", "thlxy", "qtxy", "pxy",
             "upwpxy", "wpthlpxy", "vpwpxy",
             "usgsxy", "thlsgsxy", "vsgsxy",
             "uwxyik", "wthlxy", "vwxy"]

    def __init__(self, cfg, grid, outdir: str | Path = ".", model=None):
        self.cfg = cfg
        self.grid = grid
        self.model = model
        exp = f"{cfg.run.iexpnr:03d}"
        self.writer = NCWriter(Path(outdir) / f"xydump.{exp}.nc", grid)
        for v in self._VARS:
            d = "zm" if v in ("wxy", "upwpxy", "wpthlpxy", "vpwpxy",
                              "usgsxy", "thlsgsxy", "vsgsxy", "uwxyik",
                              "wthlxy", "vwxy") else "zt"
            self.writer.define(v, (d,))
        self.tnext = cfg.output.tsample

    def profiles(self, state, masks=None):
        """The instantaneous profiles of `_VARS` as device tensors."""
        c = state.c
        IIu, IIv, IIc, IIw = (_mask_or_none(masks, k) for k in "uvcw")
        IIuw, IIvw, _ = corner_masks(masks, c.w)
        A = lambda f, mk: _clean(avexy_masked(f, mk))
        d = compute_diag(state, self.grid, self.cfg, self.model)
        uw = A(d["uik"] * d["wik"], IIuw)
        vw = A(d["vjk"] * d["wjk"], IIvw)
        wthl = A(d["thlk"] * c.w, IIw)
        return {
            "uxy": A(c.u, IIu), "vxy": A(c.v, IIv),
            "wxy": A(c.w, IIw), "thlxy": A(c.thl, IIc),
            "qtxy": A(c.qt, IIc), "pxy": A(state.pres, IIc),
            "upwpxy": uw - A(d["uik"], IIuw) * A(d["wik"], IIuw),
            "wpthlpxy": wthl - A(d["thlk"], IIw) * A(c.w, IIw),
            "vpwpxy": vw - A(d["vjk"], IIvw) * A(d["wjk"], IIvw),
            "usgsxy": A(d["usgs"], IIuw),
            "thlsgsxy": A(d["thlsgs"], IIw),
            "vsgsxy": A(d["vsgs"], IIvw),
            "uwxyik": uw, "wthlxy": wthl, "vwxy": vw,
        }

    def due(self, t: float) -> bool:
        """Whether the simulated time `t` has reached the cadence."""
        return t >= self.tnext

    def maybe_dump(self, state, t: float, masks=None):
        if not self.due(t):
            return
        self.tnext += self.cfg.output.tsample
        nz = self.grid.ktot
        with trace.span(self.family):
            with trace.span("sample"):
                out = self.profiles(state, masks)
                # one host copy: every profile cut to its first nz levels
                host = _host(torch.stack([v[:nz] for v in out.values()]))
            with trace.span("write"):
                self.writer.append(t, dict(zip(out, host)))

    def close(self):
        self.writer.close()


class YDump:
    """Instantaneous y-averaged x-z fields every tsample (modstatsdump
    lydump, ncinfo table at modstatsdump.f90:134-148): means + turbulent/
    SGS/advective fluxes + sca<n>y."""

    family = "ydump"

    def __init__(self, cfg, grid, outdir: str | Path = ".", nsv: int = 0,
                 model=None):
        self.cfg = cfg
        self.grid = grid
        self.model = model
        self.nsv = min(nsv, _N_SV_STATS)
        exp = f"{cfg.run.iexpnr:03d}"
        self.writer = NCWriter(Path(outdir) / f"ydump.{exp}.nc", grid)
        names = ["uy", "vy", "wy", "thly", "qty",
                 "upwpy", "wpthlpy", "usgsy", "thlsgsy",
                 "uwyik", "wthlyk"]
        names += [f"sca{n+1}y" for n in range(_N_SV_STATS)]
        for v in names:
            self.writer.define(v, ("zt", "xt"))
        self.tnext = cfg.output.tsample

    def fields(self, state, masks=None):
        """The instantaneous y averages as (nx, nz) device tensors."""
        c = state.c
        nz = c.u.shape[2]
        IIu, IIv, IIc, IIw = (_mask_or_none(masks, k) for k in "uvcw")
        IIuw, _, _ = corner_masks(masks, c.w)
        avy = _avy
        d = compute_diag(state, self.grid, self.cfg, self.model)
        cw = lambda f: None if f is None else f[..., :nz]
        uw = avy(cw(d["uik"] * d["wik"]), cw(IIuw))
        wthl = avy(cw(d["thlk"] * c.w), cw(IIw))
        out = {
            "uy": avy(c.u, IIu), "vy": avy(c.v, IIv),
            "wy": avy(cw(c.w), cw(IIw)),
            "thly": avy(c.thl, IIc), "qty": avy(c.qt, IIc),
            "upwpy": uw - avy(cw(d["uik"]), cw(IIuw))
            * avy(cw(d["wik"]), cw(IIuw)),
            "wpthlpy": wthl - avy(cw(d["thlk"]), cw(IIw))
            * avy(cw(c.w), cw(IIw)),
            "usgsy": avy(cw(d["usgs"]), cw(IIuw)),
            "thlsgsy": avy(cw(d["thlsgs"]), cw(IIw)),
            "uwyik": uw, "wthlyk": wthl,
        }
        for m_ in range(_N_SV_STATS):
            out[f"sca{m_+1}y"] = (avy(c.sv[m_], IIc) if m_ < self.nsv
                                  else torch.zeros_like(out["uy"]))
        return out

    def due(self, t: float) -> bool:
        """Whether the simulated time `t` has reached the cadence."""
        return t >= self.tnext

    def maybe_dump(self, state, t: float, masks=None):
        if not self.due(t):
            return
        self.tnext += self.cfg.output.tsample
        with trace.span(self.family):
            with trace.span("sample"):
                out = self.fields(state, masks)
                host = _host(torch.stack(list(out.values())))
            with trace.span("write"):
                self.writer.append(t, dict(zip(out, host)))

    def close(self):
        self.writer.close()


class XYTDump(_Sampled):
    """xytdump writer: time-mean profiles + derived turbulent moments.

    Variable set matches modstatsdump.f90:248-271 exactly (23 names:
    u/v/w/thl/qt/p means, turbulent fluxes upwp/wpthlp/vpwp/upvp, kinematic
    fluxes uw/wthl/uv/vw/ww, SGS fluxes usgs/thlsgs/vsgs, variances
    thlpthlp/upup/vpvp/wpwp + tke) plus wpqtpxyt/qtpqtptxy (moisture
    moments, reference yt-family names adapted)."""

    family = "xytdump"

    _VARS = [
        ("uxyt", ("zt",), "m/s"), ("vxyt", ("zt",), "m/s"),
        ("wxyt", ("zm",), "m/s"), ("thlxyt", ("zt",), "K"),
        ("qtxyt", ("zt",), "kg/kg"), ("pxyt", ("zt",), "m^2/s^2"),
        ("upwpxyt", ("zm",), "m^2/s^2"), ("wpthlpxyt", ("zm",), "K m/s"),
        ("vpwpxyt", ("zm",), "m^2/s^2"), ("upvpxyt", ("zt",), "m^2/s^2"),
        ("wpqtpxyt", ("zm",), "kg/kg m/s"),
        ("uwxyt", ("zm",), "m^2/s^2"), ("wthlxyt", ("zm",), "K m/s"),
        ("uvxyt", ("zt",), "m^2/s^2"), ("vwxyt", ("zm",), "m^2/s^2"),
        ("wwxyt", ("zm",), "m^2/s^2"),
        ("usgsxyt", ("zm",), "m^2/s^2"), ("thlsgsxyt", ("zm",), "K m/s"),
        ("vsgsxyt", ("zm",), "m^2/s^2"),
        ("thlpthlptxy", ("zt",), "K^2"), ("qtpqtptxy", ("zt",), "kg^2/kg^2"),
        ("upuptxyc", ("zt",), "m^2/s^2"), ("vpvptxyc", ("zt",), "m^2/s^2"),
        ("wpwptxyc", ("zt",), "m^2/s^2"), ("tketxyc", ("zt",), "m^2/s^2"),
    ]

    def __init__(self, cfg, grid, outdir: str | Path = ".", model=None,
                 device="cpu"):
        self.cfg = cfg
        self.grid = grid
        self.model = model
        self.device = torch.device(device)
        exp = f"{cfg.run.iexpnr:03d}"
        # zm here has nz entries; w-level profiles are written on faces 0..nz-1
        self.writer = NCWriter(Path(outdir) / f"xytdump.{exp}.nc", grid)
        for name, dims, units in self._VARS:
            self.writer.define(name, dims, units)
        self.acc = zero_accum(grid.ktot, grid.torch_dtype, self.device)
        self._cadence(cfg)

    def _acc(self, acc, state, masks=None):
        diag = compute_diag(state, self.grid, self.cfg, self.model)
        return sample(acc, state, masks, diag)

    def _host_acc(self):
        return {f.name: _host(getattr(self.acc, f.name))
                for f in fields(XYTAccum)}

    def write(self, t):
        a = self._host_acc()
        n = max(float(a["n"]), 1.0)
        nz = self.grid.ktot
        m = lambda k: a[k] / n
        u, v, w = m("u"), m("v"), m("w")
        thl, qt, p = m("thl"), m("qt"), m("p")
        uu, vv, ww = m("uu"), m("vv"), m("ww")
        thl2, qt2 = m("thl2"), m("qt2")
        uw, wthl, wqt = m("uw"), m("wthl"), m("wqt")
        vw, uv = m("vw"), m("uv")
        thl_at_w = _np_at_w(thl)
        qt_at_w = _np_at_w(qt)
        upwp = uw - m("uik") * m("wik")
        vpwp = vw - m("vjk") * m("wjk")
        upvp = uv - m("uij") * m("vij")
        wpthlp = wthl - thl_at_w * w
        wpqtp = wqt - qt_at_w * w
        up2 = uu - m("ucm") ** 2
        vp2 = vv - m("vcm") ** 2
        wp2c = ww - w ** 2
        wp2c = 0.5 * (wp2c[1:] + wp2c[:-1])
        data = {
            "uxyt": u, "vxyt": v, "wxyt": w[:nz], "thlxyt": thl,
            "qtxyt": qt, "pxyt": p,
            "upwpxyt": upwp[:nz], "wpthlpxyt": wpthlp[:nz],
            "vpwpxyt": vpwp[:nz], "upvpxyt": upvp,
            "wpqtpxyt": wpqtp[:nz],
            "uwxyt": uw[:nz], "wthlxyt": wthl[:nz],
            "uvxyt": uv, "vwxyt": vw[:nz], "wwxyt": ww[:nz],
            "usgsxyt": m("usgs")[:nz], "thlsgsxyt": m("thlsgs")[:nz],
            "vsgsxyt": m("vsgs")[:nz],
            "thlpthlptxy": thl2 - thl ** 2, "qtpqtptxy": qt2 - qt ** 2,
            "upuptxyc": up2, "vpvptxyc": vp2, "wpwptxyc": wp2c,
            "tketxyc": 0.5 * (up2 + vp2 + wp2c),
        }
        self.writer.append(t, data)
        self.acc = zero_accum(nz, self.grid.torch_dtype, self.device)
