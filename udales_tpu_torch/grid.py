"""Staggered-grid geometry and metric arrays (port of ``udales_tpu.grid``).

The metrics are the reference's NumPy float64 arrays, computed exactly as in
``udales_tpu/grid.py`` (modglobal.f90:536-838).  ``t(name, device)`` replaces
``Grid.j``: it returns a cached tensor of the metric in the solver dtype, so
a float32 solve never meets a float64 metric (which would promote the whole
field to float64).

Index conventions (0-based):
  - cell centres:  xf[i] = (i + 1/2) dx,  yf[j] = (j + 1/2) dy,  zf[k]
  - faces:         xh[i] = i dx (u lives here), yh[j] = j dy (v), zh[k] (w)
  - dzf[k] = zh[k+1] - zh[k],  k = 0..ktot-1
  - dzh[k] = zf[k] - zf[k-1] with dzh[0] = 2 zf[0],  k = 0..ktot
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


class Grid:
    """Grid-metric container: NumPy on the host, cached tensors on demand."""

    def __init__(self, itot: int, jtot: int, ktot: int,
                 xlen: float, ylen: float, zf: np.ndarray,
                 dtype=np.float32):
        assert zf.shape == (ktot,)
        self.itot, self.jtot, self.ktot = itot, jtot, ktot
        self.xlen, self.ylen = float(xlen), float(ylen)
        self.dtype = np.dtype(dtype)
        self.torch_dtype = TORCH_DTYPES[self.dtype]
        f = lambda a: np.asarray(a, dtype=np.float64)

        self.dx = xlen / itot
        self.dy = ylen / jtot

        # --- z metrics (modglobal.f90:747-762) ---
        zf = f(zf).copy()
        zh = np.zeros(ktot + 1)
        for k in range(ktot):
            zh[k + 1] = zh[k] + 2.0 * (zf[k] - zh[k])
        self.zh = zh
        self.zsize = zh[-1]
        dzf = zh[1:] - zh[:-1]
        self.dzf = dzf
        # index 0 is kb-1, 1..ktot is interior, ktot+1 is ke+1
        self.dzf_g = np.concatenate([[dzf[0]], dzf, [dzf[-1]]])
        zf_g = np.concatenate([zf, [zf[-1] + 2.0 * (zh[-1] - zf[-1])]])
        self.zf = zf
        self.zf_top = zf_g[-1]
        dzh = np.empty(ktot + 1)
        dzh[0] = 2.0 * zf[0]
        dzh[1:] = zf_g[1:] - zf_g[:-1]
        self.dzh = dzh

        # delta = (dx*dy*dzf)^(1/3) per level (modglobal.f90:793-797)
        self.delta = (self.dx * self.dy * dzf) ** (1.0 / 3.0)

        # --- x/y coordinates (uniform; modglobal.f90:771-779) ---
        self.xh = np.arange(itot + 1) * self.dx
        self.xf = self.xh[:-1] + 0.5 * self.dx
        self.yh = np.arange(jtot + 1) * self.dy
        self.yf = self.yh[:-1] + 0.5 * self.dy

        # scalar inverse metrics (Python floats: they never promote a tensor)
        self.dxi = 1.0 / self.dx
        self.dyi = 1.0 / self.dy
        self.dx2i = self.dxi ** 2
        self.dy2i = self.dyi ** 2
        self.dxiq = 0.25 * self.dxi
        self.dyiq = 0.25 * self.dyi
        self.dxi5 = 0.5 * self.dxi
        self.dyi5 = 0.5 * self.dyi
        self.dx2 = self.dx ** 2
        self.dy2 = self.dy ** 2

        # vertical inverse metrics
        self.dzfi = 1.0 / dzf
        self.dzfi_g = 1.0 / self.dzf_g
        self.dzf2 = dzf ** 2
        self.dzfi5 = 0.5 * self.dzfi
        self.dzfiq = 0.25 * self.dzfi
        self.dzhi = 1.0 / dzh
        self.dzhiq = 0.25 * self.dzhi
        self.dzh2i = self.dzhi ** 2

        self._tensor_cache: dict = {}

    # -- constructors -----------------------------------------------------
    @classmethod
    def uniform(cls, itot, jtot, ktot, xlen, ylen, zsize, dtype=np.float32):
        dz = zsize / ktot
        zf = (np.arange(ktot) + 0.5) * dz
        return cls(itot, jtot, ktot, xlen, ylen, zf, dtype)

    @classmethod
    def from_prof_inp(cls, path: str | Path, itot, jtot, ktot, xlen, ylen,
                      dtype=np.float32):
        """z levels from a reference prof.inp file (col 0 = zf)."""
        data = np.loadtxt(path, skiprows=2)
        return cls(itot, jtot, ktot, xlen, ylen, data[:ktot, 0], dtype)

    # -- tensor views -----------------------------------------------------
    def t(self, name: str, device) -> torch.Tensor:
        """Metric `name` as a cached solver-dtype tensor on `device`."""
        device = torch.device(device)
        key = (name, device)
        if key not in self._tensor_cache:
            self._tensor_cache[key] = torch.as_tensor(
                np.asarray(getattr(self, name), dtype=self.dtype),
                device=device)
        return self._tensor_cache[key]

    @property
    def shape(self):
        return (self.itot, self.jtot, self.ktot)

    def __repr__(self):
        return (f"Grid({self.itot}x{self.jtot}x{self.ktot}, "
                f"L=({self.xlen},{self.ylen},{self.zsize:.3g}))")
