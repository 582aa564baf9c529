"""The port's Poisson solver against udales_tpu and against the discrete
Laplacian it must invert (CPU, float64).

The port transforms x/y with torch.fft where the reference applies dense
DFT matrices, so agreement is to rounding of those transforms: 1e-10
relative.  The diagonal (uniform z) path pins the mean mode to zero in both
packages, so p is compared directly; the tridiagonal path pins it through
the Dirichlet top row in both, so it is compared directly too.  The open
(Neumann), BCzp=2 and POISS_FFT3D paths are compared after removing the
mean, and by their gradients.
"""
import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from udales_tpu.config import (BC_PROFILE, BCTOPM_PRESSURE, POISS_FFT3D,
                               BCConfig, Config, DomainConfig, DynamicsConfig)
from udales_tpu.grid import Grid as JGrid
from udales_tpu.ops.poisson import PoissonSolver as JSolver

from udales_tpu_torch.grid import Grid as TGrid
from udales_tpu_torch.ops.poisson import PoissonSolver as TSolver

NX, NY, NZ = 16, 12, 10
CFG = Config(domain=DomainConfig(itot=NX, jtot=NY, ktot=NZ, xlen=16.0,
                                 ylen=12.0), dtype="float64")
ZF = {"uniform": (np.arange(NZ) + 0.5) * 0.8,
      "stretched": np.cumsum(1.08 ** np.arange(NZ))
      - 0.5 * 1.08 ** np.arange(NZ)}


def grids(kind):
    args = (NX, NY, NZ, 16.0, 12.0, ZF[kind])
    return JGrid(*args, dtype=np.float64), TGrid(*args, dtype=np.float64)


def laplacian(grid, p):
    """Staggered Laplacian: periodic x/y, Neumann z (zero flux at the floor
    and the top), as in tests/test_core.py."""
    lap = ((np.roll(p, -1, 0) - 2 * p + np.roll(p, 1, 0)) * grid.dx2i
           + (np.roll(p, -1, 1) - 2 * p + np.roll(p, 1, 1)) * grid.dy2i)
    flux = (p[:, :, 1:] - p[:, :, :-1]) * grid.dzhi[1:-1][None, None, :]
    zero = np.zeros_like(p[:, :, :1])
    flux = np.concatenate([zero, flux, zero], axis=2)
    return lap + (flux[:, :, 1:] - flux[:, :, :-1]) * grid.dzfi[None, None, :]


@pytest.mark.parametrize("kind", ["uniform", "stretched"])
def test_solve_matches_reference(kind):
    jgrid, tgrid = grids(kind)
    jpois, tpois = JSolver(jgrid, CFG), TSolver(tgrid, CFG, device="cpu")
    assert tpois.diag_z == jpois.diag_z == (kind == "uniform")
    rhs = np.random.default_rng(4).standard_normal((NX, NY, NZ))
    rhs -= rhs.mean()
    ref = np.asarray(jpois.solve(jnp.asarray(rhs)))
    got = tpois.solve(torch.tensor(rhs)).numpy()
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["uniform", "stretched"])
def test_solve_inverts_laplacian(kind):
    _, tgrid = grids(kind)
    p = np.random.default_rng(6).standard_normal((NX, NY, NZ))
    p -= p.mean()
    ps = TSolver(tgrid, CFG, device="cpu").solve(
        torch.tensor(laplacian(tgrid, p))).numpy()
    ps -= ps.mean()
    assert np.abs(ps - p).max() < 1e-8


PATHS = {
    "open_x": dict(bc=BCConfig(BCxm=BC_PROFILE)),
    "open_y": dict(bc=BCConfig(BCym=BC_PROFILE)),
    "open_xy": dict(bc=BCConfig(BCxm=BC_PROFILE, BCym=BC_PROFILE)),
    "bczp2": dict(bc=BCConfig(BCzp=2)),
    "bczp2_open_x": dict(bc=BCConfig(BCxm=BC_PROFILE, BCzp=2)),
    "fft3d": dict(dynamics=DynamicsConfig(ipoiss=POISS_FFT3D)),
    "pressure_top": dict(bc=BCConfig(BCtopm=BCTOPM_PRESSURE)),
}
# the fully diagonal z routes assume an equidistant z grid
UNIFORM_ONLY = {"bczp2", "bczp2_open_x", "fft3d"}


def grad(p, grid):
    """Interior differences of p along the three axes, one flat vector."""
    return np.concatenate([
        ((p[1:] - p[:-1]) * grid.dxi).ravel(),
        ((p[:, 1:] - p[:, :-1]) * grid.dyi).ravel(),
        ((p[:, :, 1:] - p[:, :, :-1]) * grid.dzhi[1:-1]).ravel()])


@pytest.mark.parametrize("kind", ["uniform", "stretched"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_every_path_matches_reference(path, kind):
    """Open x, open y, both, BCzp=2, POISS_FFT3D and the tridiagonal route a
    pressure top BC forces: p (mean removed) and grad p to 1e-10."""
    jgrid, tgrid = grids(kind)
    cfg = dataclasses.replace(CFG, **PATHS[path])
    if kind == "stretched" and path in UNIFORM_ONLY:
        with pytest.raises(ValueError):
            JSolver(jgrid, cfg)
        with pytest.raises(ValueError):
            TSolver(tgrid, cfg, device="cpu")
        return
    jpois, tpois = JSolver(jgrid, cfg), TSolver(tgrid, cfg, device="cpu")
    assert (tpois.diag_z, tpois.bczp2, tpois.fft3d) == (
        jpois.diag_z, jpois.bczp2, jpois.fft3d)
    rhs = np.random.default_rng(8).standard_normal((NX, NY, NZ))
    rhs -= rhs.mean()
    ref = np.asarray(jpois.solve(jnp.asarray(rhs)))
    got = tpois.solve(torch.tensor(rhs)).numpy()
    assert got.dtype == np.float64 and got.shape == ref.shape
    d = (got - got.mean()) - (ref - ref.mean())
    assert np.abs(d).max() <= 1e-10 * np.abs(ref - ref.mean()).max()
    gref = grad(ref, tgrid)
    assert np.abs(grad(got, tgrid) - gref).max() <= 1e-10 * np.abs(gref).max()


def test_gradients_agree_across_paths():
    """The z routes differ in the constant of p only (zeroed mean against
    the Dirichlet top pin): on one rhs the diagonal, BCzp=2 and tridiagonal
    routes give one gradient."""
    _, tgrid = grids("uniform")
    rhs = np.random.default_rng(9).standard_normal((NX, NY, NZ))
    rhs -= rhs.mean()
    ps = [TSolver(tgrid, dataclasses.replace(CFG, **kw), device="cpu")
          .solve(torch.tensor(rhs)).numpy()
          for kw in ({}, PATHS["bczp2"], PATHS["pressure_top"])]
    g0 = grad(ps[0], tgrid)
    for p in ps[1:]:
        assert np.abs(grad(p, tgrid) - g0).max() <= 1e-9 * np.abs(g0).max()
