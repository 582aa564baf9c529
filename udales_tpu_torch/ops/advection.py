"""Advection schemes (port of ``udales_tpu.ops.advection``).

Vectorized re-derivations of the reference stencils:
  - advecu_2nd / advecv_2nd / advecw_2nd: src/modadvection.f90:158-314
    (the embedded -grad(pres0) term is applied in the step assembly)
  - advecc_2nd: src/modadvection.f90:103-155
  - advecc_kappa (flux-limited) and advecc_upw: src/modadvection.f90:316-503

All functions take ghosted tensors (see ops/stencil.py) and return the
interior tendency contribution.
"""
from __future__ import annotations

from functools import partial

import torch

from ..grid import Grid
from .stencil import kvec, sh, shw


def adv_u(g, grid: Grid):
    """d(uu)/dx + d(vu)/dy + d(wu)/dz at u-points (modadvection.f90:158-211)."""
    nx, ny, nz = grid.shape
    dev = g.u.device
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    Sw = partial(shw, nx=nx, ny=ny, nz=nz, h=1)
    u, v, w = g.u, g.v, g.w
    uc = S(u, 0, 0, 0)
    dzf = grid.t("dzf_g", dev); dzhi = grid.t("dzhi", dev)
    dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
    dzhi_k = kvec(dzhi, 0, nz); dzhi_kp = kvec(dzhi, 1, nz)
    dzfi5 = kvec(grid.t("dzfi5", dev), 0, nz)

    horiz = (
        ((uc + S(u, 1, 0, 0)) * (uc + S(u, 1, 0, 0))
         - (uc + S(u, -1, 0, 0)) * (uc + S(u, -1, 0, 0))) * grid.dxiq
        + ((uc + S(u, 0, 1, 0)) * (S(v, 0, 1, 0) + S(v, -1, 1, 0))
           - (uc + S(u, 0, -1, 0)) * (S(v, 0, 0, 0) + S(v, -1, 0, 0))) * grid.dyiq
    )
    vert = (
        (S(u, 0, 0, 1) * dzf_k + uc * dzf_kp) * dzhi_kp
        * (Sw(w, 0, 0, 1) + Sw(w, -1, 0, 1))
        - (uc * dzf_km + S(u, 0, 0, -1) * dzf_k) * dzhi_k
        * (Sw(w, 0, 0, 0) + Sw(w, -1, 0, 0))
    ) * 0.5 * dzfi5
    return -(horiz + vert)


def adv_v(g, grid: Grid):
    """(modadvection.f90:215-268)."""
    nx, ny, nz = grid.shape
    dev = g.u.device
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    Sw = partial(shw, nx=nx, ny=ny, nz=nz, h=1)
    u, v, w = g.u, g.v, g.w
    vc = S(v, 0, 0, 0)
    dzf = grid.t("dzf_g", dev); dzhi = grid.t("dzhi", dev)
    dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
    dzhi_k = kvec(dzhi, 0, nz); dzhi_kp = kvec(dzhi, 1, nz)
    dzfi5 = kvec(grid.t("dzfi5", dev), 0, nz)

    horiz = (
        ((S(u, 1, 0, 0) + S(u, 1, -1, 0)) * (vc + S(v, 1, 0, 0))
         - (S(u, 0, 0, 0) + S(u, 0, -1, 0)) * (vc + S(v, -1, 0, 0))) * grid.dxiq
        + ((S(v, 0, 1, 0) + vc) * (vc + S(v, 0, 1, 0))
           - (S(v, 0, -1, 0) + vc) * (vc + S(v, 0, -1, 0))) * grid.dyiq
    )
    vert = (
        (Sw(w, 0, 0, 1) + Sw(w, 0, -1, 1))
        * (S(v, 0, 0, 1) * dzf_k + vc * dzf_kp) * dzhi_kp
        - (Sw(w, 0, 0, 0) + Sw(w, 0, -1, 0))
        * (S(v, 0, 0, -1) * dzf_k + vc * dzf_km) * dzhi_k
    ) * 0.5 * dzfi5
    return -(horiz + vert)


def adv_w(g, grid: Grid):
    """(modadvection.f90:273-314). Face-shaped (nx, ny, nz+1) tendency with
    zeros at the bottom/top faces (not advanced by the reference)."""
    nx, ny, nz = grid.shape
    dev = g.u.device
    w = g.w
    h = 1
    nf = nz - 1   # interior faces kf = 1..nz-1
    wf = lambda di, dj, dk: w[h + di: h + di + nx, h + dj: h + dj + ny,
                              1 + dk: 1 + dk + nf]
    ucj = lambda di, dj, dk: g.u[h + di: h + di + nx, h + dj: h + dj + ny,
                                 1 + dk: 1 + dk + nf]
    vcj = lambda di, dj, dk: g.v[h + di: h + di + nx, h + dj: h + dj + ny,
                                 1 + dk: 1 + dk + nf]
    dzf = grid.t("dzf_g", dev)
    dzf_km = kvec(dzf, 1, nf)      # dzf[kf-1]
    dzf_k = kvec(dzf, 2, nf)       # dzf[kf]
    dzhi_k = kvec(grid.t("dzhi", dev), 1, nf)
    dzhiq_k = kvec(grid.t("dzhiq", dev), 1, nf)

    wc = wf(0, 0, 0)
    term_x = (
        (wf(1, 0, 0) + wc) * (dzf_km * ucj(1, 0, 1) + dzf_k * ucj(1, 0, 0))
        - (wc + wf(-1, 0, 0)) * (dzf_km * ucj(0, 0, 1) + dzf_k * ucj(0, 0, 0))
    ) * grid.dxiq * dzhi_k
    term_y = (
        (wf(0, 1, 0) + wc) * (dzf_km * vcj(0, 1, 1) + dzf_k * vcj(0, 1, 0))
        - (wc + wf(0, -1, 0)) * (dzf_km * vcj(0, 0, 1) + dzf_k * vcj(0, 0, 0))
    ) * grid.dyiq * dzhi_k
    term_z = (
        (wc + wf(0, 0, 1)) * (wc + wf(0, 0, 1))
        - (wc + wf(0, 0, -1)) * (wc + wf(0, 0, -1))
    ) * dzhiq_k
    tend = -(term_x + term_y + term_z)
    zeros = torch.zeros((nx, ny, 1), dtype=tend.dtype, device=dev)
    return torch.cat([zeros, tend, zeros], dim=2)


def adv_c2(gc, g, grid: Grid):
    """Cell-centred 2nd-order central advection (modadvection.f90:103-155).
    `gc` is the ghosted scalar (h=1, 1 k-ghost); `g` supplies u, v, w."""
    nx, ny, nz = grid.shape
    dev = gc.device
    S = partial(sh, nx=nx, ny=ny, nz=nz, h=1, hk=1)
    Sw = partial(shw, nx=nx, ny=ny, nz=nz, h=1)
    u, v, w = g.u, g.v, g.w
    c = S(gc, 0, 0, 0)
    dzf = grid.t("dzf_g", dev); dzhi = grid.t("dzhi", dev)
    dzf_k = kvec(dzf, 1, nz); dzf_kp = kvec(dzf, 2, nz); dzf_km = kvec(dzf, 0, nz)
    dzhi_k = kvec(dzhi, 0, nz); dzhi_kp = kvec(dzhi, 1, nz)
    dzfi5 = kvec(grid.t("dzfi5", dev), 0, nz)
    horiz = (
        (S(u, 1, 0, 0) * (S(gc, 1, 0, 0) + c)
         - S(u, 0, 0, 0) * (S(gc, -1, 0, 0) + c)) * grid.dxi5
        + (S(v, 0, 1, 0) * (S(gc, 0, 1, 0) + c)
           - S(v, 0, 0, 0) * (S(gc, 0, -1, 0) + c)) * grid.dyi5
    )
    vert = (
        Sw(w, 0, 0, 1) * (S(gc, 0, 0, 1) * dzf_k + c * dzf_kp) * dzhi_kp
        - Sw(w, 0, 0, 0) * (S(gc, 0, 0, -1) * dzf_k + c * dzf_km) * dzhi_k
    ) * dzfi5
    return -(horiz + vert)


def adv_mom(g, gp, grid: Grid, thl: bool = False):
    """The advection leaf of a substep: ``adv_u``, ``adv_v``, ``adv_w`` with
    the pressure-gradient terms the reference embeds in advecu/v/w_2nd, and
    ``adv_c2`` of ``g.thl`` when `thl`.  `gp` is the pressure padded by one
    cell in x and y (``run._pad_pres``).  Returns (du, dv, dw, dthl), dthl
    None without `thl`.  The plain version of ``csrc/fused_adv_mom.cu``
    (``ops/fused_adv.py``), which computes the same in the same order."""
    nz = grid.ktot
    du = adv_u(g, grid) - (gp[1:-1, 1:-1, :] - gp[:-2, 1:-1, :]) * grid.dxi
    dv = adv_v(g, grid) - (gp[1:-1, 1:-1, :] - gp[1:-1, :-2, :]) * grid.dyi
    dw = adv_w(g, grid)
    p = gp[1:-1, 1:-1, :]
    dzhi = grid.t("dzhi", gp.device)
    dw[..., 1:nz] -= (p[:, :, 1:] - p[:, :, :-1]) * dzhi[1:nz][None, None, :]
    dthl = adv_c2(g.thl, g, grid) if thl else None
    return du, dv, dw, dthl


def _rlim(d1, d2, eps1=1.0e-10):
    """Kappa-scheme flux limiter (modadvection.f90:410-421)."""
    ri = (d2 + eps1) / (d1 + eps1)
    phir = torch.clamp(torch.minimum(
        2.0 * ri, torch.clamp(1.0 / 3.0 + 2.0 / 3.0 * ri, max=2.0)), min=0.0)
    return 0.5 * phir * d1


def adv_kappa(gc, g, grid: Grid):
    """Flux-limited kappa scheme for scalars (modadvection.f90:316-407).

    `gc` has halo 2 in x/y and 2 k-ghosts (``ghost_scalar_kappa`` layout):
    gc[..., 2+i, 2+j, 2+k] == c[..., i, j, k]; leading axes are a stack of
    scalars (``ghost_sv``), advected in one pass.  Velocities from `g`
    (halo 1)."""
    nx, ny, nz = grid.shape
    dev = gc.device
    h, hk = 2, 2

    def limited_flux(C, vel, metric_m=None, metric_0=None, metric_p=None,
                     width=None):
        """Upwind value plus the limited correction, times the face
        velocity.  C(d) is the cell slab d cells upwind-right of the face."""
        d1p = C(0) - C(-1)
        d2p = C(1) - C(0)
        d1m = C(1) - C(2)
        d2m = C(0) - C(1)
        if metric_0 is not None:
            d1p, d2p = d1p * metric_m, d2p * metric_0
            d1m, d2m = d1m * metric_p, d2m * metric_0
        pos = vel > 0
        cf = torch.where(pos, C(0), C(1))
        lim = _rlim(torch.where(pos, d1p, d1m), torch.where(pos, d2p, d2m))
        return (cf + (lim if width is None else width * lim)) * vel

    # --- x faces: i = 0..nx (face i between cells i-1 and i) ---------------
    Cx = lambda di: gc[..., h + di - 1: h + di + nx, h: h + ny, hk: hk + nz]
    ux = g.u[1: 2 + nx, 1: 1 + ny, 1: 1 + nz]  # u at faces 0..nx
    Fx = limited_flux(Cx, ux, grid.dxi, grid.dxi, grid.dxi, grid.dx)
    tend = (Fx[..., :-1, :, :] - Fx[..., 1:, :, :]) * grid.dxi

    # --- y faces ----------------------------------------------------------
    Cy = lambda dj: gc[..., h: h + nx, h + dj - 1: h + dj + ny, hk: hk + nz]
    vy = g.v[1: 1 + nx, 1: 2 + ny, 1: 1 + nz]
    Fy = limited_flux(Cy, vy)
    tend = tend + (Fy[..., :-1, :] - Fy[..., 1:, :]) * grid.dyi

    # --- z faces (stretched; modadvection.f90:383-404) --------------------
    # faces kf = 1..nz (bottom face kb flux not formed; w=0 there).
    nf = nz
    Cz = lambda dk: gc[..., h: h + nx, h: h + ny, hk + dk: hk + dk + nf]
    wz = g.w[1: 1 + nx, 1: 1 + ny, 1: 1 + nz]  # faces 1..nz
    dzhci = grid.t("dzhci_g", dev)   # face metric, index map: face kf -> kf+1
    dzfc = grid.t("dzfc_g", dev)     # cell metric, index map: cell k -> k+2
    fhm = kvec(dzhci, 1, nf)     # dzhci(k-1) at face kf -> index kf
    fh0 = kvec(dzhci, 2, nf)     # dzhci(k)
    fhp = kvec(dzhci, 3, nf)     # dzhci(k+1)
    fc = kvec(dzfc, 3, nf)       # dzfc(k): cell above face kf (cell kf)
    Fz = limited_flux(Cz, wz, fhm, fh0, fhp, fc)   # faces 1..nz
    Fz = torch.cat([torch.zeros_like(Fz[..., :1]), Fz], dim=-1)  # face 0
    dzfci_k = kvec(grid.t("dzfci_g", dev), 2, nz)
    return tend + (Fz[..., :-1] - Fz[..., 1:]) * dzfci_k


def adv_upw(gc, g, grid: Grid):
    """First-order upwind for scalars (modadvection.f90:423-503); `gc` in
    the kappa layout (halo 2, 2 k-ghosts)."""
    nx, ny, nz = grid.shape
    h, hk = 2, 2
    Cx = lambda di: gc[h + di - 1: h + di + nx, h: h + ny, hk: hk + nz]
    ux = g.u[1: 2 + nx, 1: 1 + ny, 1: 1 + nz]
    Fx = torch.where(ux > 0, Cx(0), Cx(1)) * ux
    tend = (Fx[:-1] - Fx[1:]) * grid.dxi
    Cy = lambda dj: gc[h: h + nx, h + dj - 1: h + dj + ny, hk: hk + nz]
    vy = g.v[1: 1 + nx, 1: 2 + ny, 1: 1 + nz]
    Fy = torch.where(vy > 0, Cy(0), Cy(1)) * vy
    tend = tend + (Fy[:, :-1] - Fy[:, 1:]) * grid.dyi
    Cz = lambda dk: gc[h: h + nx, h: h + ny, hk + dk: hk + dk + nz]
    wz = g.w[1: 1 + nx, 1: 1 + ny, 1: 1 + nz]
    Fz = torch.where(wz > 0, Cz(0), Cz(1)) * wz
    Fz = torch.cat([torch.zeros_like(Fz[..., :1]), Fz], dim=2)
    return tend + (Fz[..., :-1] - Fz[..., 1:]) \
        * kvec(grid.t("dzfci_g", gc.device), 2, nz)
