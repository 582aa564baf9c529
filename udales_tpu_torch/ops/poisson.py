"""FFT-based pressure-Poisson solver, periodic x/y (port of
``udales_tpu.ops.poisson``; src/modpois.f90 POISS_FFT2D, :419-712).

  rhs(x,y,z) --rfft(x)--> --fft(y)--> z solve per mode --> inverse path

The x/y transforms are ``torch.fft`` (cuFFT on the card).  Two z solves:

  - ``diag_z`` (uniform z, Boussinesq, BCzp=1, no pressure top): the z
    direction is diagonalized by a DCT-II, applied as a dense matrix product
    with the reference's ``_dctII_matrix`` and its exact inverse, and the
    modal divide uses the same eigenvalues ``inv_lam3`` with the mean mode
    pinned to zero (poisson.py:289-322, 444-453);
  - otherwise the per-mode tridiagonal Thomas solve, with the reference's
    coefficients and its Dirichlet-across-the-top pin of the singular (0,0)
    mode (modpois.f90:148-220), as a loop over k on (mx, my) tensors.

Open (Neumann) lateral boundaries, POISS_FFT3D and BCzp=2 are not ported
yet and raise.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import BCTOPM_PRESSURE, BC_PERIODIC, POISS_FFT3D, Config
from ..grid import Grid


def _dctII_matrix(n):
    """FFTW REDFT10: X_k = 2 sum_m x_m cos(pi k (2m+1) / (2n))."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    return 2.0 * np.cos(np.pi * k * (2 * m + 1) / (2 * n))


class PoissonSolver:
    """Precomputed spectral solver (reference initpois, modpois.f90:66-226).
    Solver constants live on `device` in the grid dtype."""

    def __init__(self, grid: Grid, cfg: Config, device="cpu"):
        # The z transform is a float32 matmul on the card: keep it in full
        # float32 (TF32 keeps ~3 decimal digits, which shows up directly as
        # post-projection divergence).  Both switches are process-wide.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.grid = grid
        self.cfg = cfg
        self.device = torch.device(device)
        nx, ny, nz = grid.shape
        self.per_x = cfg.bc.BCxm == BC_PERIODIC
        self.per_y = cfg.bc.BCym == BC_PERIODIC
        if not (self.per_x and self.per_y):
            raise NotImplementedError(
                "Neumann (open) lateral Poisson directions are not ported yet")
        if cfg.dynamics.ipoiss == POISS_FFT3D:
            raise NotImplementedError("POISS_FFT3D is not ported yet")
        if cfg.bc.BCzp == 2:
            raise NotImplementedError("BCzp=2 is not ported yet")

        dxi, dyi = grid.dxi, grid.dyi
        # eigenvalues (modpois.f90:100-146); rfft(x) x fft(y) indexing
        mx = np.arange(nx // 2 + 1)
        xrt = -4.0 * dxi * dxi * np.sin(np.pi * mx / nx) ** 2
        my = np.arange(ny)
        yrt = -4.0 * dyi * dyi * np.sin(np.pi * my / ny) ** 2
        lam = xrt[:, None] + yrt[None, :]                   # (mx, my)

        dzf = grid.dzf
        self.diag_z = (np.allclose(dzf, dzf[0], rtol=1e-12)
                       and cfg.bc.BCtopm != BCTOPM_PRESSURE)
        tdt = grid.torch_dtype
        kw = dict(dtype=tdt, device=self.device)
        if self.diag_z:
            dzi = 1.0 / dzf[0]
            kz = np.arange(nz)
            zrt = -4.0 * dzi * dzi * np.sin(np.pi * kz / (2 * nz)) ** 2
            lam3 = lam[:, :, None] + zrt[None, None, :]
            inv = np.where(np.abs(lam3) > 1e-300, 1.0 / np.where(
                np.abs(lam3) > 1e-300, lam3, 1.0), 0.0)
            inv[0, 0, 0] = 0.0   # pin the global mean mode
            self.inv_lam3 = torch.as_tensor(inv.astype(grid.dtype), **kw)
            C = _dctII_matrix(nz)
            # x @ M.T applies M along the last (z) axis
            self.CzT = torch.as_tensor(C.T.astype(grid.dtype), **kw)
            self.iCzT = torch.as_tensor(np.linalg.inv(C).T.astype(grid.dtype),
                                        **kw)
            return

        # tridiagonal coefficients (modpois.f90:153-177), Boussinesq density
        dzh = grid.dzh
        a = 1.0 / (dzf * dzh[:nz])
        c = 1.0 / (dzf * dzh[1:])
        b = -(a + c)
        b_top_N = b[-1] + c[-1]
        b_top_D = b[-1] - c[-1]
        b[0] = b[0] + a[0]       # Neumann bottom
        b[-1] = b_top_N          # Neumann top
        a[0] = 0.0
        c[-1] = 0.0
        D = b[None, None, :] + lam[:, :, None]
        # pin the singular (0,0) mode via Dirichlet across the top cell
        # (modpois.f90:208-220)
        D[..., -1] = np.where(np.isclose(lam, 0.0), b_top_D, D[..., -1])
        # Thomas factors: w_k = 1/(D_k - a_k cp_{k-1}), cp_k = c_k w_k
        w = np.empty_like(D)
        cp = np.empty_like(D)
        w[..., 0] = 1.0 / D[..., 0]
        cp[..., 0] = c[0] * w[..., 0]
        for k in range(1, nz):
            w[..., k] = 1.0 / (D[..., k] - a[k] * cp[..., k - 1])
            cp[..., k] = c[k] * w[..., k]
        self.w = torch.as_tensor(w.astype(grid.dtype), **kw)
        self.cp = torch.as_tensor(cp.astype(grid.dtype), **kw)
        self.Af = torch.as_tensor((-(a[None, None, :] * w)).astype(grid.dtype),
                                  **kw)

    def _tridiag(self, rhs):
        """Per-mode Thomas solve along z of a complex (mx, my, nz) tensor:
        forward y_k = Af_k y_{k-1} + w_k rhs_k, backward
        x_k = y_k - cp_k x_{k+1}."""
        nz = rhs.shape[-1]
        B = rhs * self.w
        ys = [B[..., 0]]
        for k in range(1, nz):
            ys.append(self.Af[..., k] * ys[-1] + B[..., k])
        xs = [ys[-1]]
        for k in range(nz - 2, -1, -1):
            xs.append(-self.cp[..., k] * xs[-1] + ys[k])
        return torch.stack(xs[::-1], dim=-1)

    def solve(self, rhs):
        """rhs (nx, ny, nz) -> pressure correction p (nx, ny, nz)."""
        nx = rhs.shape[0]
        if self.diag_z:
            G = torch.matmul(rhs, self.CzT)
            S = torch.fft.fft(torch.fft.rfft(G, dim=0), dim=1)
            X = torch.fft.ifft(S * self.inv_lam3, dim=1)
            Gp = torch.fft.irfft(X, n=nx, dim=0)
            return torch.matmul(Gp, self.iCzT)
        S = torch.fft.fft(torch.fft.rfft(rhs, dim=0), dim=1)
        X = torch.fft.ifft(self._tridiag(S), dim=1)
        return torch.fft.irfft(X, n=nx, dim=0)
