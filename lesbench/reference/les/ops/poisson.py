"""FFT-based pressure-Poisson solver (port of ``udales_tpu.ops.poisson``;
src/modpois.f90 POISS_FFT2D :419-712, POISS_FFT3D :808-882).

  rhs(x,y,z) --x transform--> --y transform--> z solve per mode --> back

A periodic direction is transformed with ``torch.fft`` (cuFFT on the card),
an open (Neumann) one with a DCT-II applied as a dense matrix product with
the reference's ``_dctII_matrix`` and its exact inverse (the REDFT branches
of modpois.f90).  The z direction takes one of four routes:

  - ``diag_z`` (periodic x/y, uniform z, BCzp=1, no pressure top): a DCT-II
    in z and a modal divide by ``inv_lam3`` with the mean mode pinned to
    zero (udales_tpu poisson.py:289-322, 444-453);
  - ``bczp2`` (BCzp=2, uniform z): the same cosine transform with the
    reference's zero-mode rule (modpois.f90:179-193, 556-591);
  - ``fft3d`` (POISS_FFT3D, periodic x/y, uniform z): a plain FFT in z with
    periodic eigenvalues, zero mode -> 0;
  - otherwise the per-mode tridiagonal Thomas solve, with the reference's
    coefficients and its Dirichlet-across-the-top pin of the singular (0,0)
    mode (modpois.f90:148-220), as a loop over k on (mx, my) tensors.

The routes differ in the additive constant of p (zeroed mean against the
Dirichlet pin); the projection takes only its gradient.  Density is
Boussinesq (rhobf = rhobh = 1).

Under an x/y process split (`mesh`, ``parallel.mesh``) the right-hand side
arrives as this rank's z-pencil (x/px, y/py, z) and the 2DECOMP transposes
are written out (modpois.f90:459-548), with the single device's transforms
in its order: the z transform (cosine or nothing) on z-pencils; with x
periodic and y open the DCT in y on the first y-pencil (x/px, y, z/py);
the x transform (rfft, or the DCT of an open x) on x-pencils (x, y/px,
z/py); the y transform (FFT, or the DCT of a y open together with x) on
y-pencils, where the ``diag_z`` and ``bczp2`` divides happen; the
``fft3d`` FFT in z and its divide, or the Thomas solve, on z-pencils; the
inverse retraces the pencils.  The rfft's nx/2 + 1 modes are padded with
zeros to a multiple of px for the transposes that split them, and the pad
is dropped before the inverse rfft; the nx modes of a DCT need no pad.
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

    def __init__(self, grid: Grid, cfg: Config, device="cuda", mesh=None):
        # The DCTs are float32 matmuls on the card: keep them in full
        # float32 (TF32 keeps ~3 decimal digits, which shows up directly as
        # post-projection divergence).  Both switches are process-wide.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.grid = grid
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        nx, ny, nz = grid.global_shape
        self.per_x = cfg.bc.BCxm == BC_PERIODIC
        self.per_y = cfg.bc.BCym == BC_PERIODIC
        kw = dict(dtype=grid.torch_dtype, device=self.device)

        def const(a):
            return torch.as_tensor(np.asarray(a).astype(grid.dtype), **kw)

        def dct_pair(n):
            C = _dctII_matrix(n)
            return const(C), const(np.linalg.inv(C))

        dxi, dyi = grid.dxi, grid.dyi
        # eigenvalues (modpois.f90:100-146): rfft(x) x fft(y) indexing for
        # periodic directions, DCT-II indexing for open ones
        if self.per_x:
            xrt = -4.0 * dxi * dxi * np.sin(
                np.pi * np.arange(nx // 2 + 1) / nx) ** 2
        else:
            xrt = -4.0 * dxi * dxi * np.sin(
                np.pi * np.arange(nx) / (2 * nx)) ** 2
            self.Cx, self.iCx = dct_pair(nx)
        if self.per_y:
            yrt = -4.0 * dyi * dyi * np.sin(np.pi * np.arange(ny) / ny) ** 2
        else:
            yrt = -4.0 * dyi * dyi * np.sin(
                np.pi * np.arange(ny) / (2 * ny)) ** 2
            self.Cy, self.iCy = dct_pair(ny)
        lam = xrt[:, None] + yrt[None, :]                   # (mx, my)

        dzf = grid.dzf
        uniform_z = bool(np.allclose(dzf, dzf[0], rtol=1e-12))
        self.fft3d = cfg.dynamics.ipoiss == POISS_FFT3D
        self.bczp2 = (not self.fft3d) and cfg.bc.BCzp == 2
        self.diag_z = (not self.fft3d and self.per_x and self.per_y
                       and uniform_z and cfg.bc.BCtopm != BCTOPM_PRESSURE
                       and cfg.bc.BCzp == 1)
        if self.fft3d and not (self.per_x and self.per_y):
            raise ValueError("POISS_FFT3D requires periodic x and y")
        if self.fft3d and not uniform_z:
            raise ValueError("POISS_FFT3D assumes an equidistant z grid")
        if self.bczp2 and not uniform_z:
            raise ValueError("BCzp=2 assumes an equidistant z grid "
                             "(modpois.f90:184)")
        if self.fft3d or self.bczp2 or self.diag_z:
            # fully diagonal: modal divide by xrt + yrt + zrt, zero modes -> 0
            dzi = 1.0 / dzf[0]
            kz = np.arange(nz)
            zrt = -4.0 * dzi * dzi * np.sin(
                np.pi * kz / (nz if self.fft3d else 2 * nz)) ** 2
            lam3 = lam[:, :, None] + zrt[None, None, :]
            ok = np.abs(lam3) > 1e-300
            inv = np.where(ok, 1.0 / np.where(ok, lam3, 1.0), 0.0)
            if not self.bczp2:
                inv[0, 0, 0] = 0.0   # pin the global mean mode
            # the divide's pencil under a split: z for the FFT in z
            self.inv_lam3 = const(self._modes(inv, "z" if self.fft3d
                                              else "y"))
            if not self.fft3d:
                # x @ M.T applies M along the last (z) axis
                C = _dctII_matrix(nz)
                self.CzT = const(C.T)
                self.iCzT = const(np.linalg.inv(C).T)
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
        self.w = const(self._modes(w, "z"))
        self.cp = const(self._modes(cp, "z"))
        self.Af = const(self._modes(-(a[None, None, :] * w), "z"))

    def _modes(self, table, pencil: str):
        """A (mx, my, mz) table of the whole domain, or under a split the
        part of it on this rank's y-pencil (mx/px, all y, z/py) or z-pencil
        (mx/px, y/py, all z), the x modes edge-padded to a multiple of px
        (the padded modes carry zeros; their entries only stay finite)."""
        m = self.mesh
        if m is None:
            return table
        table = self._pad_modes(table, np)
        mx, my, mz = table.shape
        cut = lambda n, parts, c: slice(c * (n // parts),
                                        (c + 1) * (n // parts))
        if pencil == "y":
            return table[cut(mx, m.px, m.cx), :, cut(mz, m.py, m.cy)]
        return table[cut(mx, m.px, m.cx), cut(my, m.py, m.cy), :]

    def _pad_modes(self, a, xp=torch):
        """`a` with its leading (x-mode) axis padded to a multiple of px by
        copies of its last mode (NumPy tables) or by zeros (spectra)."""
        extra = -a.shape[0] % self.mesh.px
        if extra == 0:
            return a
        if xp is np:
            return np.concatenate([a, np.repeat(a[-1:], extra, axis=0)])
        return torch.cat([a, a.new_zeros((extra, *a.shape[1:]))])

    def _tridiag(self, rhs):
        """Per-mode Thomas solve along z of a real or complex (mx, my, nz)
        tensor: forward y_k = Af_k y_{k-1} + w_k rhs_k, backward
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
        """rhs (nx, ny, nz) -> pressure correction p (nx, ny, nz).  The real
        transforms (DCTs) go first and the FFTs of the periodic directions
        after them, as in the reference's ``_solve_neumann``; the transforms
        of different axes commute."""
        if self.mesh is not None:
            return self._solve_split(rhs)
        nx, ny, nz = rhs.shape
        zcos = self.diag_z or self.bczp2
        F = torch.matmul(rhs, self.CzT) if zcos else rhs
        if not self.per_x:
            F = torch.einsum("ki,ijz->kjz", self.Cx, F)
        if not self.per_y:
            F = torch.einsum("kj,ijz->ikz", self.Cy, F)
        if self.per_x:
            F = torch.fft.rfft(F, dim=0)
        if self.per_y:
            F = torch.fft.fft(F, dim=1)
        if self.fft3d:
            X = torch.fft.ifft(torch.fft.fft(F, dim=2) * self.inv_lam3,
                               dim=2)
        elif zcos:
            X = F * self.inv_lam3
        else:
            X = self._tridiag(F)
        if self.per_y:
            X = torch.fft.ifft(X, dim=1)
            if not self.per_x:
                X = X.real
        if self.per_x:
            X = torch.fft.irfft(X, n=nx, dim=0)
        if not self.per_y:
            X = torch.einsum("jk,ikz->ijz", self.iCy, X)
        if not self.per_x:
            X = torch.einsum("ik,kjz->ijz", self.iCx, X)
        return torch.matmul(X, self.iCzT) if zcos else X

    def _solve_split(self, rhs):
        """`solve` of this rank's z-pencil under the x/y split."""
        m = self.mesh
        nx = self.grid.global_shape[0]
        zcos = self.diag_z or self.bczp2
        y_first = self.per_x and not self.per_y   # Cy before the rfft in x
        F = torch.matmul(rhs, self.CzT) if zcos else rhs
        F = m.to_ypencil(F)
        if y_first:
            F = torch.einsum("kj,ijz->ikz", self.Cy, F)
        F = m.to_xpencil(F)
        F = (self._pad_modes(torch.fft.rfft(F, dim=0)) if self.per_x
             else torch.einsum("ki,ijz->kjz", self.Cx, F))
        F = m.from_xpencil(F)
        if self.per_y:
            F = torch.fft.fft(F, dim=1)
        elif not y_first:
            F = torch.einsum("kj,ijz->ikz", self.Cy, F)
        if zcos:
            X = F * self.inv_lam3
        elif self.fft3d:
            X = m.to_ypencil(torch.fft.ifft(torch.fft.fft(
                m.from_ypencil(F), dim=2) * self.inv_lam3, dim=2))
        else:
            X = m.to_ypencil(self._tridiag(m.from_ypencil(F)))
        if self.per_y:
            X = torch.fft.ifft(X, dim=1)
            if not self.per_x:
                X = X.real
        elif not y_first:
            X = torch.einsum("jk,ikz->ijz", self.iCy, X)
        X = m.to_xpencil(X)
        X = (torch.fft.irfft(X[: nx // 2 + 1], n=nx, dim=0) if self.per_x
             else torch.einsum("ik,kjz->ijz", self.iCx, X))
        X = m.from_xpencil(X)
        if y_first:
            X = torch.einsum("jk,ikz->ijz", self.iCy, X)
        X = m.from_ypencil(X)
        return torch.matmul(X, self.iCzT) if zcos else X
