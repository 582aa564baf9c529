"""Subgrid-scale closure and diffusion (port of ``udales_tpu.ops.subgrid``).

Re-derivations of src/modsubgrid.f90:
  - Vreman (2004) closure (:269-360) with the optional stable-stratification
    buoyancy correction (:332-354)
  - Smagorinsky (:208-264) and the DNS constant-viscosity branch
  - one-equation TKE (:363-400) and its source terms (`sources`, :415-538)
  - diffusion stencils diffu (:672), diffv (:778), diffw (:890), diffc
    (:540), diffe (:627)

``diff_u/v/w`` are the plain version of the hand-written CUDA kernel in
``ops/fused_diff.py`` and the path it takes for CPU tensors;
``vreman_closure`` is that of ``ops/fused_vreman.py``, whose ``closure``
is the callers' way to this module's ``closure`` on the card.  ``diff_c``
takes a stack of scalars with a leading axis as one tensor.  udales_tpu's
``GradPack`` (shared strain primitives) is a TPU layout the port does not
carry: every function here is the unpacked form.
"""
from __future__ import annotations

import math
from functools import partial

import torch

from ..config import SGS_DNS, SGS_ONEEQN, SGS_SMAGORINSKY, SGS_VREMAN, \
    Config, const
from ..grid import Grid
from .stencil import kvec, sh, shw


def _smag_constants(cf: float):
    """cm and ceps of the one-equation/Smagorinsky family
    (modsubgrid.f90:62-79; ``udales_tpu.ops.subgrid.sgs_const``)."""
    alpha_kolm = 1.5
    cm = cf / (2.0 * math.pi) * (1.5 * alpha_kolm) ** (-1.5)
    ceps = 2.0 * math.pi / cf * (1.5 * alpha_kolm) ** (-1.5)
    return cm, ceps


CH1 = 1.0   # modsubgriddata.f90 ch1


def _oneeqn_constants(sg):
    """cm, ch2, ce1, ce2 of the one-equation model (modsubgrid.f90:62-79;
    ``udales_tpu.ops.subgrid.sgs_const.derived``)."""
    cm, ceps = _smag_constants(sg.cf)
    ch2 = sg.prandtl - CH1
    ce1 = (sg.cn ** 2) * (cm / sg.rigc - CH1 * cm)
    return cm, ch2, ce1, ceps - ce1


def _gradients(g, grid: Grid):
    """Velocity-gradient tensor a_ij = du_j/dx_i at cell centres
    (modsubgrid.f90:281-305)."""
    nx, ny, nz = grid.shape
    dev = g.u.device
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    Sw = partial(shw, nx=nx, ny=ny, nz=nz, h=1)
    u, v, w = g.u, g.v, g.w
    dxi, dyi = grid.dxi, grid.dyi
    dxiq, dyiq = grid.dxiq, grid.dyiq
    dzf = grid.t("dzf_g", dev)
    dzhi = grid.t("dzhi", dev)
    dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
    dzhi_k = kvec(dzhi, 0, nz); dzhi_kp = kvec(dzhi, 1, nz)
    dzfi_k = kvec(grid.t("dzfi", dev), 0, nz)
    dzfiq_k = kvec(grid.t("dzfiq", dev), 0, nz)

    a11 = (S(u, 1, 0, 0) - S(u, 0, 0, 0)) * dxi
    a12 = (S(v, 1, 1, 0) + S(v, 1, 0, 0) - S(v, -1, 1, 0) - S(v, -1, 0, 0)) * dxiq
    a13 = (Sw(w, 1, 0, 1) + Sw(w, 1, 0, 0) - Sw(w, -1, 0, 1) - Sw(w, -1, 0, 0)) * dxiq
    a21 = (S(u, 1, 1, 0) + S(u, 0, 1, 0) - S(u, 1, -1, 0) - S(u, 0, -1, 0)) * dyiq
    a22 = (S(v, 0, 1, 0) - S(v, 0, 0, 0)) * dyi
    a23 = (Sw(w, 0, 1, 1) + Sw(w, 0, 1, 0) - Sw(w, 0, -1, 1) - Sw(w, 0, -1, 0)) * dyiq
    a31 = (((S(u, 1, 0, 1) + S(u, 0, 0, 1)) * dzf_k
            + (S(u, 1, 0, 0) + S(u, 0, 0, 0)) * dzf_kp) * dzhi_kp
           - ((S(u, 1, 0, 0) + S(u, 0, 0, 0)) * dzf_km
              + (S(u, 1, 0, -1) + S(u, 0, 0, -1)) * dzf_k) * dzhi_k) * dzfiq_k
    a32 = (((S(v, 0, 1, 1) + S(v, 0, 0, 1)) * dzf_k
            + (S(v, 0, 1, 0) + S(v, 0, 0, 0)) * dzf_kp) * dzhi_kp
           - ((S(v, 0, 1, 0) + S(v, 0, 0, 0)) * dzf_km
              + (S(v, 0, 1, -1) + S(v, 0, 0, -1)) * dzf_k) * dzhi_k) * dzfiq_k
    a33 = (Sw(w, 0, 0, 1) - Sw(w, 0, 0, 0)) * dzfi_k
    return a11, a12, a13, a21, a22, a23, a31, a32, a33


def buoycorr(cfg: Config) -> bool:
    """Whether the Vreman closure applies the stable-stratification
    correction (modsubgrid.f90:332)."""
    return cfg.physics.lbuoyancy and cfg.subgrid.lbuoycorr


def vreman_closure(g, grid: Grid, cfg: Config, dthvdz=None, thl=None):
    """Vreman (2004) eddy viscosity (modsubgrid.f90:269-360)."""
    nz = grid.ktot
    a11, a12, a13, a21, a22, a23, a31, a32, a33 = _gradients(g, grid)
    aa = (a11 * a11 + a21 * a21 + a31 * a31 + a12 * a12 + a22 * a22
          + a32 * a32 + a13 * a13 + a23 * a23 + a33 * a33)
    dx2, dy2 = grid.dx2, grid.dy2
    dzf2_k = kvec(grid.t("dzf2", g.u.device), 0, nz)
    b11 = dx2 * a11 * a11 + dy2 * a21 * a21 + dzf2_k * a31 * a31
    b22 = dx2 * a12 * a12 + dy2 * a22 * a22 + dzf2_k * a32 * a32
    b12 = dx2 * a11 * a12 + dy2 * a21 * a22 + dzf2_k * a31 * a32
    b33 = dx2 * a13 * a13 + dy2 * a23 * a23 + dzf2_k * a33 * a33
    b13 = dx2 * a11 * a13 + dy2 * a21 * a23 + dzf2_k * a31 * a33
    b23 = dx2 * a12 * a13 + dy2 * a22 * a23 + dzf2_k * a32 * a33
    bb = (b11 * b22 - b12 * b12 + b11 * b33 - b13 * b13
          + b22 * b33 - b23 * b23)
    ekm = torch.where(bb < 1e-8, 0.0, cfg.subgrid.c_vreman * torch.sqrt(
        bb / torch.clamp(aa, min=1e-30)))

    if buoycorr(cfg):
        # stable-stratification correction (modsubgrid.f90:332-354)
        nx, ny, _ = grid.shape
        S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
        u, v = g.u, g.v
        dzh = grid.t("dzh", u.device)
        denom = kvec(dzh, 1, nz) + kvec(dzh, 0, nz)
        du0dz = 0.5 * ((S(u, 0, 0, 1) + S(u, 1, 0, 1))
                       - (S(u, 0, 0, -1) + S(u, 1, 0, -1))) / denom
        dv0dz = 0.5 * ((S(v, 0, 0, 1) + S(v, 0, 1, 1))
                       - (S(v, 0, 0, -1) + S(v, 0, 1, -1))) / denom
        Rig = (const.grav / thl) * dthvdz / (du0dz ** 2 + dv0dz ** 2 + 1e-10)
        Rigc = cfg.subgrid.rigc
        ekm = ekm * torch.sqrt(1.0 - torch.clamp(Rig, 0.0, Rigc) / Rigc)

    prandtli = 1.0 / cfg.subgrid.prandtl
    ekh = ekm * prandtli + const.numol * const.prandtlmoli
    ekm = ekm + const.numol
    return ekm, ekh


def _strain2(g, grid: Grid):
    """Squared strain rate with cross terms (modsubgrid.f90:235-255)."""
    nx, ny, nz = grid.shape
    dev = g.u.device
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    Sw = partial(shw, nx=nx, ny=ny, nz=nz, h=1)
    u, v, w = g.u, g.v, g.w
    dxi, dyi = grid.dxi, grid.dyi
    dzfi_k = kvec(grid.t("dzfi", dev), 0, nz)
    dzhi = grid.t("dzhi", dev)
    dzhi_k = kvec(dzhi, 0, nz); dzhi_kp = kvec(dzhi, 1, nz)

    s2 = (((S(u, 1, 0, 0) - S(u, 0, 0, 0)) * dxi) ** 2
          + ((S(v, 0, 1, 0) - S(v, 0, 0, 0)) * dyi) ** 2
          + ((Sw(w, 0, 0, 1) - Sw(w, 0, 0, 0)) * dzfi_k) ** 2)
    s2 = s2 + 0.125 * (
        ((Sw(w, 0, 0, 1) - Sw(w, -1, 0, 1)) * dxi
         + (S(u, 0, 0, 1) - S(u, 0, 0, 0)) * dzhi_kp) ** 2
        + ((Sw(w, 0, 0, 0) - Sw(w, -1, 0, 0)) * dxi
           + (S(u, 0, 0, 0) - S(u, 0, 0, -1)) * dzhi_k) ** 2
        + ((Sw(w, 1, 0, 0) - Sw(w, 0, 0, 0)) * dxi
           + (S(u, 1, 0, 0) - S(u, 1, 0, -1)) * dzhi_k) ** 2
        + ((Sw(w, 1, 0, 1) - Sw(w, 0, 0, 1)) * dxi
           + (S(u, 1, 0, 1) - S(u, 1, 0, 0)) * dzhi_kp) ** 2)
    s2 = s2 + 0.125 * (
        ((S(u, 0, 1, 0) - S(u, 0, 0, 0)) * dyi
         + (S(v, 0, 1, 0) - S(v, -1, 1, 0)) * dxi) ** 2
        + ((S(u, 0, 0, 0) - S(u, 0, -1, 0)) * dyi
           + (S(v, 0, 0, 0) - S(v, -1, 0, 0)) * dxi) ** 2
        + ((S(u, 1, 0, 0) - S(u, 1, -1, 0)) * dyi
           + (S(v, 1, 0, 0) - S(v, 0, 0, 0)) * dxi) ** 2
        + ((S(u, 1, 1, 0) - S(u, 1, 0, 0)) * dyi
           + (S(v, 1, 1, 0) - S(v, 0, 1, 0)) * dxi) ** 2)
    s2 = s2 + 0.125 * (
        ((S(v, 0, 0, 1) - S(v, 0, 0, 0)) * dzhi_kp
         + (Sw(w, 0, 0, 1) - Sw(w, 0, -1, 1)) * dyi) ** 2
        + ((S(v, 0, 0, 0) - S(v, 0, 0, -1)) * dzhi_k
           + (Sw(w, 0, 0, 0) - Sw(w, 0, -1, 0)) * dyi) ** 2
        + ((S(v, 0, 1, 0) - S(v, 0, 1, -1)) * dzhi_k
           + (Sw(w, 0, 1, 0) - Sw(w, 0, 0, 0)) * dyi) ** 2
        + ((S(v, 0, 1, 1) - S(v, 0, 1, 0)) * dzhi_kp
           + (Sw(w, 0, 1, 1) - Sw(w, 0, 0, 1)) * dyi) ** 2)
    return s2


def smagorinsky_closure(g, grid: Grid, cfg: Config):
    """(modsubgrid.f90:208-264). csz = (cm^3/ceps)^(1/4) unless cs given."""
    nz = grid.ktot
    sg = cfg.subgrid
    cm, ceps = _smag_constants(sg.cf)
    csz = (cm ** 3 / ceps) ** 0.25 if sg.cs == -1.0 else sg.cs
    mlen = csz * kvec(grid.t("delta", g.u.device), 0, nz)
    ekm = (mlen ** 2) * torch.sqrt(2.0 * _strain2(g, grid))
    prandtli = 1.0 / sg.prandtl
    ekh = ekm * prandtli + const.numol * const.prandtlmoli
    ekm = ekm + const.numol
    return ekm, ekh


def oneeqn_closure(g, grid: Grid, cfg: Config, e12, dthvdz, thvs):
    """One-equation TKE closure (modsubgrid.f90:363-400): ekm, ekh and the
    length scale zlt (the filter width, limited by the stratification where
    it is stable)."""
    nz = grid.ktot
    sg = cfg.subgrid
    cm, ch2, _, _ = _oneeqn_constants(sg)
    delta_k = kvec(grid.t("delta", e12.device), 0, nz).expand(e12.shape)
    stable = dthvdz > 0
    zlt_stable = torch.minimum(
        delta_k,
        sg.cn * e12 / torch.sqrt(const.grav / thvs * torch.abs(dthvdz)
                                 + 1e-30))
    zlt = torch.where(stable, zlt_stable, delta_k)
    ekm_t = cm * zlt * e12
    ekh_t = torch.where(stable, (CH1 + ch2 * zlt / delta_k) * ekm_t,
                        (CH1 + ch2) * ekm_t)
    return (ekm_t + const.numol, ekh_t + const.numol * const.prandtlmoli,
            zlt)


def closure(g, grid: Grid, cfg: Config, e12=None, dthvdz=None, thl=None,
            thvs=None):
    """Dispatch (modsubgrid.f90:159-412).  Returns interior ekm, ekh and
    zlt (None but for the one-equation model, which defines it)."""
    model = cfg.subgrid.model
    if model == SGS_VREMAN:
        ekm, ekh = vreman_closure(g, grid, cfg, dthvdz, thl)
        return ekm, ekh, None
    if model == SGS_SMAGORINSKY:
        ekm, ekh = smagorinsky_closure(g, grid, cfg)
        return ekm, ekh, None
    if model == SGS_ONEEQN:
        return oneeqn_closure(g, grid, cfg, e12, dthvdz, thvs)
    assert model == SGS_DNS, model
    kw = dict(dtype=g.u.dtype, device=g.u.device)
    ekm = torch.full(grid.shape, const.numol, **kw)
    ekh = torch.full(grid.shape, const.numol * const.prandtlmoli, **kw)
    return ekm, ekh, None


def tke_sources(g, grid: Grid, cfg: Config, e12, ekm, ekh, dthvdz, zlt,
                thvs):
    """Shear, buoyancy and dissipation sources of the e12 equation
    (modsubgrid.f90:415-538), zero at the lowest level (the reference loops
    k = kb+1..ke; the wall functions own the lowest)."""
    nz = grid.ktot
    _, _, ce1, ce2 = _oneeqn_constants(cfg.subgrid)
    tdef2 = 2.0 * _strain2(g, grid)
    numolh = const.numol * const.prandtlmoli
    e12s = torch.clamp(e12, min=1e-30)
    sbshr = (ekm - const.numol) * tdef2 / (2.0 * e12s)
    sbbuo = -(ekh - numolh) * const.grav / thvs * dthvdz / (2.0 * e12s)
    delta_k = kvec(grid.t("delta", e12.device), 0, nz).expand(e12.shape)
    sbdiss = -2.0 * (ce1 + ce2 * zlt / delta_k) * e12 ** 2 / (2.0 * zlt)
    src = sbshr + sbbuo + sbdiss
    mask = (torch.arange(nz, device=e12.device) >= 1).to(src.dtype)
    return src * mask


# ---------------------------------------------------------------------------
# Diffusion stencils
# ---------------------------------------------------------------------------

def diff_u(g, grid: Grid, M=None):
    """d/dxj(2 Km S1j) at u-points (modsubgrid.f90:672-775, LES branch).

    `M` (optional): ghosted IBM fluid mask at u-points.  The u-normal
    gradient of each lateral/vertical flux is multiplied by the opposite
    point's mask, which folds the reference's diffu_corr (modibm.f90:
    990-1030) into the sweep."""
    nx, ny, nz = grid.shape
    dev = g.u.device
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    Sw = partial(shw, nx=nx, ny=ny, nz=nz, h=1)
    u, v, w, ekm = g.u, g.v, g.w, g.ekm
    dxi, dyi = grid.dxi, grid.dyi
    dzf = grid.t("dzf_g", dev)
    dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
    dzhiq = grid.t("dzhiq", dev); dzhi = grid.t("dzhi", dev)
    dzhiq_k = kvec(dzhiq, 0, nz); dzhiq_kp = kvec(dzhiq, 1, nz)
    dzhi_k = kvec(dzhi, 0, nz); dzhi_kp = kvec(dzhi, 1, nz)
    dzfi_k = kvec(grid.t("dzfi", dev), 0, nz)

    ekm_c = S(ekm, 0, 0, 0); ekm_im = S(ekm, -1, 0, 0)
    emom = (dzf_km * (ekm_c + ekm_im)
            + dzf_k * (S(ekm, 0, 0, -1) + S(ekm, -1, 0, -1))) * dzhiq_k
    emop = (dzf_kp * (ekm_c + ekm_im)
            + dzf_k * (S(ekm, 0, 0, 1) + S(ekm, -1, 0, 1))) * dzhiq_kp
    empo = 0.25 * (ekm_c + S(ekm, 0, 1, 0) + S(ekm, -1, 0, 0) + S(ekm, -1, 1, 0))
    emmo = 0.25 * (ekm_c + S(ekm, 0, -1, 0) + S(ekm, -1, -1, 0) + S(ekm, -1, 0, 0))

    one = 1.0
    mjp = S(M, 0, 1, 0) if M is not None else one
    mjm = S(M, 0, -1, 0) if M is not None else one
    mkp = S(M, 0, 0, 1) if M is not None else one
    mkm = S(M, 0, 0, -1) if M is not None else one
    t_x = (ekm_c * (S(u, 1, 0, 0) - S(u, 0, 0, 0))
           - ekm_im * (S(u, 0, 0, 0) - S(u, -1, 0, 0))) * 2.0 * grid.dx2i
    t_y = (empo * ((S(u, 0, 1, 0) - S(u, 0, 0, 0)) * dyi * mjp
                   + (S(v, 0, 1, 0) - S(v, -1, 1, 0)) * dxi)
           - emmo * ((S(u, 0, 0, 0) - S(u, 0, -1, 0)) * dyi * mjm
                     + (S(v, 0, 0, 0) - S(v, -1, 0, 0)) * dxi)) * dyi
    t_z = (emop * ((S(u, 0, 0, 1) - S(u, 0, 0, 0)) * dzhi_kp * mkp
                   + (Sw(w, 0, 0, 1) - Sw(w, -1, 0, 1)) * dxi)
           - emom * ((S(u, 0, 0, 0) - S(u, 0, 0, -1)) * dzhi_k * mkm
                     + (Sw(w, 0, 0, 0) - Sw(w, -1, 0, 0)) * dxi)) * dzfi_k
    return t_x + t_y + t_z


def diff_v(g, grid: Grid, M=None):
    """(modsubgrid.f90:778-886).  `M`: ghosted v-point fluid mask (folds
    diffv_corr, modibm.f90:1033-1075), see diff_u."""
    nx, ny, nz = grid.shape
    dev = g.u.device
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    Sw = partial(shw, nx=nx, ny=ny, nz=nz, h=1)
    u, v, w, ekm = g.u, g.v, g.w, g.ekm
    dxi, dyi = grid.dxi, grid.dyi
    dzf = grid.t("dzf_g", dev)
    dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
    dzhiq = grid.t("dzhiq", dev); dzhi = grid.t("dzhi", dev)
    dzhiq_k = kvec(dzhiq, 0, nz); dzhiq_kp = kvec(dzhiq, 1, nz)
    dzhi_k = kvec(dzhi, 0, nz); dzhi_kp = kvec(dzhi, 1, nz)
    dzfi_k = kvec(grid.t("dzfi", dev), 0, nz)

    ekm_c = S(ekm, 0, 0, 0); ekm_jm = S(ekm, 0, -1, 0)
    eomm = (dzf_km * (ekm_c + ekm_jm)
            + dzf_k * (S(ekm, 0, 0, -1) + S(ekm, 0, -1, -1))) * dzhiq_k
    eomp = (dzf_kp * (ekm_c + ekm_jm)
            + dzf_k * (S(ekm, 0, 0, 1) + S(ekm, 0, -1, 1))) * dzhiq_kp
    emmo = 0.25 * (ekm_c + ekm_jm + S(ekm, -1, -1, 0) + S(ekm, -1, 0, 0))
    epmo = 0.25 * (ekm_c + ekm_jm + S(ekm, 1, -1, 0) + S(ekm, 1, 0, 0))

    one = 1.0
    mip = S(M, 1, 0, 0) if M is not None else one
    mim = S(M, -1, 0, 0) if M is not None else one
    mkp = S(M, 0, 0, 1) if M is not None else one
    mkm = S(M, 0, 0, -1) if M is not None else one
    t_x = (epmo * ((S(v, 1, 0, 0) - S(v, 0, 0, 0)) * dxi * mip
                   + (S(u, 1, 0, 0) - S(u, 1, -1, 0)) * dyi)
           - emmo * ((S(v, 0, 0, 0) - S(v, -1, 0, 0)) * dxi * mim
                     + (S(u, 0, 0, 0) - S(u, 0, -1, 0)) * dyi)) * dxi
    t_y = (ekm_c * (S(v, 0, 1, 0) - S(v, 0, 0, 0))
           - ekm_jm * (S(v, 0, 0, 0) - S(v, 0, -1, 0))) * 2.0 * grid.dy2i
    t_z = (eomp * ((S(v, 0, 0, 1) - S(v, 0, 0, 0)) * dzhi_kp * mkp
                   + (Sw(w, 0, 0, 1) - Sw(w, 0, -1, 1)) * dyi)
           - eomm * ((S(v, 0, 0, 0) - S(v, 0, 0, -1)) * dzhi_k * mkm
                     + (Sw(w, 0, 0, 0) - Sw(w, 0, -1, 0)) * dyi)) * dzfi_k
    return t_x + t_y + t_z


def diff_w(g, grid: Grid, M=None):
    """(modsubgrid.f90:890-997).  Face-shaped result; faces 0 and nz are
    zero.  `M`: x/y-ghosted w-face fluid mask (folds diffw_corr,
    modibm.f90:1078-1117), see diff_u."""
    nx, ny, nz = grid.shape
    dev = g.u.device
    u, v, w, ekm = g.u, g.v, g.w, g.ekm
    h = 1
    nf = nz - 1
    wf = lambda di, dj, dk: w[h + di: h + di + nx, h + dj: h + dj + ny,
                              1 + dk: 1 + dk + nf]
    C = lambda A, di, dj, dk: A[h + di: h + di + nx, h + dj: h + dj + ny,
                                1 + dk: 1 + dk + nf]
    dxi, dyi = grid.dxi, grid.dyi
    dzf = grid.t("dzf_g", dev)
    dzf_km = kvec(dzf, 1, nf)   # dzf[kf-1]
    dzf_k = kvec(dzf, 2, nf)    # dzf[kf]
    dzhiq_k = kvec(grid.t("dzhiq", dev), 1, nf)
    dzhi_k = kvec(grid.t("dzhi", dev), 1, nf)
    dzfi = grid.t("dzfi_g", dev)
    dzfi_k = kvec(dzfi, 2, nf)   # 1/dzf[kf]
    dzfi_km = kvec(dzfi, 1, nf)  # 1/dzf[kf-1]

    # cells: (di, dj, dk) with dk=1 the cell above the face, dk=0 below
    emom = (dzf_km * (C(ekm, 0, 0, 1) + C(ekm, -1, 0, 1))
            + dzf_k * (C(ekm, 0, 0, 0) + C(ekm, -1, 0, 0))) * dzhiq_k
    eomm = (dzf_km * (C(ekm, 0, 0, 1) + C(ekm, 0, -1, 1))
            + dzf_k * (C(ekm, 0, 0, 0) + C(ekm, 0, -1, 0))) * dzhiq_k
    eopm = (dzf_km * (C(ekm, 0, 0, 1) + C(ekm, 0, 1, 1))
            + dzf_k * (C(ekm, 0, 0, 0) + C(ekm, 0, 1, 0))) * dzhiq_k
    epom = (dzf_km * (C(ekm, 0, 0, 1) + C(ekm, 1, 0, 1))
            + dzf_k * (C(ekm, 0, 0, 0) + C(ekm, 1, 0, 0))) * dzhiq_k

    one = 1.0
    if M is not None:
        Mf = lambda di, dj: M[h + di: h + di + nx, h + dj: h + dj + ny,
                              1: 1 + nf]
        mip, mim, mjp, mjm = Mf(1, 0), Mf(-1, 0), Mf(0, 1), Mf(0, -1)
    else:
        mip = mim = mjp = mjm = one
    wc = wf(0, 0, 0)
    t_x = (epom * ((wf(1, 0, 0) - wc) * dxi * mip
                   + (C(u, 1, 0, 1) - C(u, 1, 0, 0)) * dzhi_k)
           - emom * ((wc - wf(-1, 0, 0)) * dxi * mim
                     + (C(u, 0, 0, 1) - C(u, 0, 0, 0)) * dzhi_k)) * dxi
    t_y = (eopm * ((wf(0, 1, 0) - wc) * dyi * mjp
                   + (C(v, 0, 1, 1) - C(v, 0, 1, 0)) * dzhi_k)
           - eomm * ((wc - wf(0, -1, 0)) * dyi * mjm
                     + (C(v, 0, 0, 1) - C(v, 0, 0, 0)) * dzhi_k)) * dyi
    t_z = (C(ekm, 0, 0, 1) * (wf(0, 0, 1) - wc) * dzfi_k
           - C(ekm, 0, 0, 0) * (wc - wf(0, 0, -1)) * dzfi_km) * 2.0 * dzhi_k
    tend = t_x + t_y + t_z
    zeros = torch.zeros((nx, ny, 1), dtype=tend.dtype, device=dev)
    return torch.cat([zeros, tend, zeros], dim=2)


def diff_c(gc, gekh, grid: Grid, M=None):
    """Scalar diffusion (modsubgrid.f90:540-623, LES branch).  `gc` ghosted
    h=1/hk=1, with any leading axes (a stack of scalars).  `M`: ghosted c-point fluid mask (folds diffc_corr,
    modibm.f90:1120-1164): each flux is masked by the opposite cell's flag."""
    nx, ny, nz = grid.shape
    dev = gc.device
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    dzf = grid.t("dzf_g", dev)
    dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
    dzh2i = grid.t("dzh2i", dev)
    dzh2i_k = kvec(dzh2i, 0, nz); dzh2i_kp = kvec(dzh2i, 1, nz)
    dzfi_k = kvec(grid.t("dzfi", dev), 0, nz)
    c = S(gc, 0, 0, 0)
    e = S(gekh, 0, 0, 0)
    one = 1.0
    m = (lambda di, dj, dk: S(M, di, dj, dk)) if M is not None \
        else (lambda di, dj, dk: one)
    return 0.5 * (
        ((S(gekh, 1, 0, 0) + e) * (S(gc, 1, 0, 0) - c) * m(1, 0, 0)
         - (e + S(gekh, -1, 0, 0)) * (c - S(gc, -1, 0, 0)) * m(-1, 0, 0))
        * grid.dx2i
        + ((S(gekh, 0, 1, 0) + e) * (S(gc, 0, 1, 0) - c) * m(0, 1, 0)
           - (e + S(gekh, 0, -1, 0)) * (c - S(gc, 0, -1, 0)) * m(0, -1, 0))
        * grid.dy2i
        + ((dzf_kp * e + dzf_k * S(gekh, 0, 0, 1)) * (S(gc, 0, 0, 1) - c)
           * dzh2i_kp * m(0, 0, 1)
           - (dzf_km * e + dzf_k * S(gekh, 0, 0, -1))
           * (c - S(gc, 0, 0, -1)) * dzh2i_k * m(0, 0, -1)) * dzfi_k)


def diff_e(g, grid: Grid):
    """TKE diffusion with the doubled coefficient (modsubgrid.f90:627-667)
    of the ghosted e12 with the ghosted ekm."""
    nx, ny, nz = grid.shape
    dev = g.e12.device
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    gekm, ge = g.ekm, g.e12
    dzf = grid.t("dzf_g", dev)
    dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
    dzh2i = grid.t("dzh2i", dev)
    dzh2i_k = kvec(dzh2i, 0, nz); dzh2i_kp = kvec(dzh2i, 1, nz)
    dzfi_k = kvec(grid.t("dzfi", dev), 0, nz)
    c = S(ge, 0, 0, 0)
    e = S(gekm, 0, 0, 0)
    return 1.0 * (
        ((S(gekm, 1, 0, 0) + e) * (S(ge, 1, 0, 0) - c)
         - (e + S(gekm, -1, 0, 0)) * (c - S(ge, -1, 0, 0))) * grid.dx2i
        + ((S(gekm, 0, 1, 0) + e) * (S(ge, 0, 1, 0) - c)
           - (e + S(gekm, 0, -1, 0)) * (c - S(ge, 0, -1, 0))) * grid.dy2i
        + ((dzf_kp * e + dzf_k * S(gekm, 0, 0, 1)) * (S(ge, 0, 0, 1) - c)
           * dzh2i_kp
           - (dzf_km * e + dzf_k * S(gekm, 0, 0, -1)) * (c - S(ge, 0, 0, -1))
           * dzh2i_k) * dzfi_k)
