"""The frozen reference held to oracles that do not come from the program:
analytic tendencies and their order of convergence, a loop-by-loop NumPy
Vreman written from the formula (modsubgrid.f90:269-330), and the
discrete Laplacian the pressure solve has to invert, on the benchmark's
own grids (periodic, and open in x).  A fault the reference shares with
the program, because it is a copy of it, shows here in these layers.
The IBM wall functions, the open-boundary planes and the assembly of the
step have no such oracle yet."""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lesbench import cases
from lesbench.reference import check
from lesbench.reference.les.config import (Config, DomainConfig,
                                           SubgridConfig, SGS_VREMAN, const)
from lesbench.reference.les.grid import Grid
from lesbench.reference.les.ops import advection as adv
from lesbench.reference.les.ops import subgrid as sg
from lesbench.tests.lesbench_small import small_config

TP = 2 * np.pi


def _grid(n):
    return Grid.uniform(n, n, n, 1.0, 1.0, 1.0, dtype=np.float64)


def _on(fn, x, y, z):
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    return torch.as_tensor(fn(X, Y, Z))


def _ghosted(fn, grid, sx, sy, z):
    """`fn` on a field with one periodic ghost on each side in x and y,
    staggered by `sx`, `sy` cells (0 on the face, 0.5 at the centre),
    and at the heights `z` (analytic continuation below and above)."""
    n = grid.itot
    x = (np.arange(-1, n + 1) % n + sx) * grid.dx
    y = (np.arange(-1, n + 1) % n + sy) * grid.dy
    return _on(fn, x, y, z)


def _fields(grid):
    """An analytic velocity on the staggered grid: u, v at the centres'
    heights with a ghost below and above, w on the n + 1 faces."""
    n, dz = grid.ktot, grid.dzf[0]
    zc = (np.arange(-1, n + 1) + 0.5) * dz
    zw = np.arange(n + 1) * dz
    ufn = lambda x, y, z: np.sin(TP * x) * np.cos(TP * y) \
        * (1 + 0.5 * np.cos(np.pi * z))
    vfn = lambda x, y, z: np.cos(TP * x) * np.sin(TP * y) \
        * (1 + 0.5 * np.sin(np.pi * z))
    wfn = lambda x, y, z: np.sin(TP * x) * np.sin(TP * y) * np.sin(np.pi * z)
    g = SimpleNamespace(u=_ghosted(ufn, grid, 0.0, 0.5, zc),
                        v=_ghosted(vfn, grid, 0.5, 0.0, zc),
                        w=_ghosted(wfn, grid, 0.5, 0.5, zw))
    return g, (ufn, vfn, wfn)


def _d(f, axis, h=1e-6):
    """The derivative of an analytic field along `axis`."""
    def d(x, y, z):
        e = [0.0, 0.0, 0.0]
        e[axis] = h
        return (f(x + e[0], y + e[1], z + e[2])
                - f(x - e[0], y - e[1], z - e[2])) / (2 * h)
    return d


def _orders(errs):
    return [math.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)]


@pytest.mark.parametrize("comp", ["u", "v", "w"])
def test_advection_is_second_order(comp):
    """cd2 momentum advection against the analytic flux divergence
    -d(u_j u_i)/dx_j at the component's own points: the error falls
    fourfold each time the cells halve."""
    errs = []
    for n in (16, 32, 64):
        grid = _grid(n)
        g, (ufn, vfn, wfn) = _fields(grid)
        f = dict(u=ufn, v=vfn, w=wfn)[comp]
        flux = [lambda x, y, z, a=a: a(x, y, z) * f(x, y, z)
                for a in (ufn, vfn, wfn)]
        xs = np.arange(n) * grid.dx + (0.0 if comp == "u" else 0.5 * grid.dx)
        ys = np.arange(n) * grid.dy + (0.0 if comp == "v" else 0.5 * grid.dy)
        if comp == "w":
            zs = np.arange(1, n) * grid.dzf[0]      # the inner faces
        else:
            zs = (np.arange(n) + 0.5) * grid.dzf[0]
        want = -sum(_on(_d(fl, a), xs, ys, zs) for a, fl in enumerate(flux))
        got = getattr(adv, f"adv_{comp}")(g, grid)
        if comp == "w":
            got = got[:, :, 1:-1]
        errs.append(float((got - want).abs().max()))
    orders = _orders(errs)
    assert min(orders) > 1.75 and orders[-1] > 1.9, (errs, orders)


def _vreman_loop(g, grid, c):
    """Vreman's eddy viscosity cell by cell, written from the formula on
    the ghosted arrays (cell (i, j, k) at [i + 1, j + 1, k + 1] of u and
    v, faces k and k + 1 of w)."""
    nx, ny, nz = grid.itot, grid.jtot, grid.ktot
    u, v, w = (np.asarray(t) for t in (g.u, g.v, g.w))
    dxi, dyi, dxiq, dyiq = grid.dxi, grid.dyi, grid.dxiq, grid.dyiq
    dzf, dzhi, dzfi = grid.dzf_g, grid.dzhi, grid.dzfi
    dzfiq, dzf2 = grid.dzfiq, grid.dzf2
    ekm = np.zeros((nx, ny, nz))
    for i in range(nx):
        a = i + 1
        for j in range(ny):
            b = j + 1
            for k in range(nz):
                c_ = k + 1
                g11 = (u[a + 1, b, c_] - u[a, b, c_]) * dxi
                g12 = (v[a + 1, b + 1, c_] + v[a + 1, b, c_]
                       - v[a - 1, b + 1, c_] - v[a - 1, b, c_]) * dxiq
                g13 = (w[a + 1, b, k + 1] + w[a + 1, b, k]
                       - w[a - 1, b, k + 1] - w[a - 1, b, k]) * dxiq
                g21 = (u[a + 1, b + 1, c_] + u[a, b + 1, c_]
                       - u[a + 1, b - 1, c_] - u[a, b - 1, c_]) * dyiq
                g22 = (v[a, b + 1, c_] - v[a, b, c_]) * dyi
                g23 = (w[a, b + 1, k + 1] + w[a, b + 1, k]
                       - w[a, b - 1, k + 1] - w[a, b - 1, k]) * dyiq
                g31 = (((u[a + 1, b, c_ + 1] + u[a, b, c_ + 1]) * dzf[c_]
                        + (u[a + 1, b, c_] + u[a, b, c_]) * dzf[c_ + 1])
                       * dzhi[k + 1]
                       - ((u[a + 1, b, c_] + u[a, b, c_]) * dzf[c_ - 1]
                          + (u[a + 1, b, c_ - 1] + u[a, b, c_ - 1])
                          * dzf[c_]) * dzhi[k]) * dzfiq[k]
                g32 = (((v[a, b + 1, c_ + 1] + v[a, b, c_ + 1]) * dzf[c_]
                        + (v[a, b + 1, c_] + v[a, b, c_]) * dzf[c_ + 1])
                       * dzhi[k + 1]
                       - ((v[a, b + 1, c_] + v[a, b, c_]) * dzf[c_ - 1]
                          + (v[a, b + 1, c_ - 1] + v[a, b, c_ - 1])
                          * dzf[c_]) * dzhi[k]) * dzfiq[k]
                g33 = (w[a, b, k + 1] - w[a, b, k]) * dzfi[k]
                A = np.array([[g11, g12, g13], [g21, g22, g23],
                              [g31, g32, g33]])
                D = np.diag([grid.dx2, grid.dy2, dzf2[k]])
                B = A.T @ D @ A        # beta_ij = sum_m d_m^2 a_mi a_mj
                bb = (B[0, 0] * B[1, 1] - B[0, 1] ** 2
                      + B[0, 0] * B[2, 2] - B[0, 2] ** 2
                      + B[1, 1] * B[2, 2] - B[1, 2] ** 2)
                aa = float((A * A).sum())
                ekm[i, j, k] = 0.0 if bb < 1e-8 else c * math.sqrt(
                    bb / max(aa, 1e-30))
    return ekm


def test_vreman_is_the_formula():
    """On random ghosted fields of a stretched 6 x 5 x 7 grid."""
    zf = np.cumsum(np.linspace(0.2, 0.4, 7)) - 0.1
    grid = Grid(6, 5, 7, 1.5, 1.05, zf, dtype=np.float64)
    cfg = Config(domain=DomainConfig(itot=6, jtot=5, ktot=7, xlen=1.5,
                                     ylen=1.05),
                 dtype="float64", subgrid=SubgridConfig(model=SGS_VREMAN))
    rng = np.random.default_rng(7)
    r = lambda *s: torch.as_tensor(rng.standard_normal(s))
    g = SimpleNamespace(u=r(8, 7, 9), v=r(8, 7, 9), w=r(8, 7, 8))
    ekm, ekh = sg.vreman_closure(g, grid, cfg)
    want = _vreman_loop(g, grid, cfg.subgrid.c_vreman)
    np.testing.assert_allclose(ekm.numpy() - const.numol, want, rtol=1e-11,
                               atol=1e-15)
    np.testing.assert_allclose(
        ekh.numpy(), want / cfg.subgrid.prandtl
        + const.numol * const.prandtlmoli, rtol=1e-11, atol=1e-15)


def test_diffusion_is_the_laplacian():
    """With a constant eddy viscosity nu and a divergence-free velocity,
    the momentum diffusion is nu times the Laplacian of u, to second
    order."""
    nu = 0.01
    ufn = lambda x, y, z: np.sin(TP * x) * np.cos(TP * y)
    vfn = lambda x, y, z: -np.cos(TP * x) * np.sin(TP * y)
    wfn = lambda x, y, z: 0 * x
    errs = []
    for n in (16, 32, 64):
        grid = _grid(n)
        zc = (np.arange(-1, n + 1) + 0.5) * grid.dzf[0]
        zw = np.arange(n + 1) * grid.dzf[0]
        g = SimpleNamespace(
            u=_ghosted(ufn, grid, 0.0, 0.5, zc),
            v=_ghosted(vfn, grid, 0.5, 0.0, zc),
            w=_ghosted(wfn, grid, 0.5, 0.5, zw),
            ekm=torch.full((n + 2, n + 2, n + 2), nu, dtype=torch.float64))
        got = sg.diff_u(g, grid)
        xs = np.arange(n) * grid.dx
        ys = (np.arange(n) + 0.5) * grid.dy
        want = nu * _on(lambda x, y, z: -2 * TP ** 2 * ufn(x, y, z), xs, ys,
                        zc[1:-1])
        errs.append(float((got - want).abs().max()))
    assert min(_orders(errs)) > 1.9, errs


def _laplacian(p, grid, open_x):
    """The discrete Laplacian the projection inverts, written out: second
    differences in x (periodic, or zero gradient at an open x's ends) and
    y (periodic), and in z the face fluxes (p[k] - p[k-1]) / dzh[k] with
    none through the floor and the lid."""
    p = p.double().numpy()
    nz = p.shape[2]
    if open_x:
        px = np.concatenate([p[:1], p, p[-1:]], axis=0)
    else:
        px = np.concatenate([p[-1:], p, p[:1]], axis=0)
    lap = (px[2:] - 2 * p + px[:-2]) * grid.dxi ** 2
    py = np.concatenate([p[:, -1:], p, p[:, :1]], axis=1)
    lap += (py[:, 2:] - 2 * p + py[:, :-2]) * grid.dyi ** 2
    flux = np.zeros(p.shape[:2] + (nz + 1,))
    flux[..., 1:nz] = (p[..., 1:] - p[..., :-1]) * grid.dzhi[1:nz]
    lap += (flux[..., 1:] - flux[..., :-1]) * grid.dzfi
    return lap


@pytest.mark.parametrize("config", ["urban_cubes", "urban_cubes_driven"])
def test_pressure_solve_inverts_the_laplacian(tmp_path, config):
    """The pressure solve of each configuration's case at 16^3 (the
    periodic FFT route; the open-x DCT and tridiagonal route) returns a p
    whose Laplacian is the right-hand side in every horizontal mode but
    the mean one.  The mean mode of a problem with no fixed pressure
    anywhere can hold only a right-hand side whose weighted sum is zero:
    the periodic route takes the weighted mean off at every level, the
    open-x route leaves the column's whole defect at the top level (where
    the divergence check leaves the top level out)."""
    cfg = small_config(config, 16)
    model = check.build(cfg, cases.case_dir(cfg, tmp_path), "float64", "cpu")
    open_x = model.inlet is not None
    assert open_x == (config == "urban_cubes_driven")
    rng = np.random.default_rng(3)
    rhs = rng.standard_normal(model.grid.shape)
    p = model.pois.solve(torch.as_tensor(rhs))
    miss = _laplacian(p, model.grid, open_x) - rhs
    tol = 1e-9 * np.abs(rhs).max()
    level = miss.mean(axis=(0, 1))
    np.testing.assert_allclose(miss - level, 0.0, atol=tol)
    dz = model.grid.dzf
    defect = float((rhs.mean(axis=(0, 1)) * dz).sum())
    if open_x:
        want = np.zeros_like(level)
        want[-1] = -defect / dz[-1]
    else:
        want = np.full_like(level, -defect / dz.sum())
    np.testing.assert_allclose(level, want, atol=tol)
