"""The port's Poisson solver against udales_tpu and against the discrete
Laplacian it must invert (CPU, float64).

The port transforms x/y with torch.fft where the reference applies dense
DFT matrices, so agreement is to rounding of those transforms: 1e-10
relative.  The diagonal (uniform z) path pins the mean mode to zero in both
packages, so p is compared directly; the tridiagonal path pins it through
the Dirichlet top row in both, so it is compared directly too.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from udales_tpu.config import (BC_PROFILE, POISS_FFT3D, BCConfig, Config,
                               DomainConfig, DynamicsConfig)
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
    jpois, tpois = JSolver(jgrid, CFG), TSolver(tgrid, CFG)
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
    ps = TSolver(tgrid, CFG).solve(torch.tensor(laplacian(tgrid, p))).numpy()
    ps -= ps.mean()
    assert np.abs(ps - p).max() < 1e-8


def test_unported_paths_raise():
    _, tgrid = grids("uniform")
    for cfg in (dataclasses.replace(CFG, bc=BCConfig(BCxm=BC_PROFILE)),
                dataclasses.replace(CFG, bc=BCConfig(BCzp=2)),
                dataclasses.replace(CFG, dynamics=DynamicsConfig(
                    ipoiss=POISS_FFT3D))):
        with pytest.raises(NotImplementedError):
            TSolver(tgrid, cfg)
