"""Second-order central advection (port of ``udales_tpu.ops.advection``).

Vectorized re-derivations of the reference stencils:
  - advecu_2nd / advecv_2nd / advecw_2nd: src/modadvection.f90:158-314
    (the embedded -grad(pres0) term is applied in the step assembly)
  - advecc_2nd: src/modadvection.f90:103-155
The kappa and upwind scalar schemes are not ported yet.

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
