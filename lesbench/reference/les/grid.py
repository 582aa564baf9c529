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

``block(mesh)`` gives one rank's share of the grid under an x/y process split
(``parallel.mesh``): its ``itot``/``jtot`` and x/y coordinates are the
block's, ``global_shape``, ``xlen`` and ``ylen`` the domain's; ``cut``
takes the block's part of a whole-domain array; ``edge_xlo``,
``edge_xhi``, ``edge_ylo`` and ``edge_yhi`` say whether the block holds the
domain's first or last x or y cells (all four on a whole-domain grid).
"""
from __future__ import annotations

import copy
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

        # --- extended (khc=2) metrics for the kappa scheme -----------------
        # (modglobal.f90:842-866, edge-replicated ghosts)
        # dzfc_g[k+2] == dzf[k]; dzhci_g[kf+1] == 1/dzh[kf] (kf = face index)
        self.dzfc_g = np.concatenate([[dzf[0], dzf[0]], dzf,
                                      [dzf[-1], dzf[-1]]])
        self.dzfci_g = 1.0 / self.dzfc_g
        self.dzhci_g = np.concatenate([[1.0 / dzh[0]], 1.0 / dzh,
                                       [1.0 / dzh[-1]]])

        self._tensor_cache: dict = {}
        # a whole-domain grid; `block` sets these for one rank's block
        self.mesh = None
        self.i0 = self.j0 = 0
        self.global_shape = (itot, jtot, ktot)
        self.edge_xlo = self.edge_xhi = self.edge_ylo = self.edge_yhi = True

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

    def block(self, mesh) -> "Grid":
        """This rank's (itot/px, jtot/py, ktot) block on `mesh`
        (``parallel.mesh.Mesh``), whose first cell is (i0, j0) of the
        domain.  The blocks and the Poisson pencils (x/px, y, z/py) and
        (x, y/px, z/py) must divide the grid; ValueError names the condition
        that fails."""
        if self.mesh is not None:
            raise ValueError("block: this grid is already a block")
        px, py = mesh.px, mesh.py
        checks = {"itot % px == 0": self.itot % px,
                  "jtot % py == 0": self.jtot % py,
                  "jtot % px == 0": self.jtot % px,
                  "ktot % px == 0": self.ktot % px,
                  "ktot % py == 0": self.ktot % py}
        bad = [k for k, v in checks.items() if v]
        if bad:
            raise ValueError(f"grid {self.shape} does not split over a "
                             f"{px} x {py} mesh: " + ", ".join(
                                 f"{k} fails" for k in bad))
        g = copy.copy(self)
        g._tensor_cache = {}
        g.mesh = mesh
        g.itot, g.jtot = self.itot // px, self.jtot // py
        g.i0, g.j0 = mesh.cx * g.itot, mesh.cy * g.jtot
        g.edge_xlo, g.edge_xhi = mesh.cx == 0, mesh.cx == px - 1
        g.edge_ylo, g.edge_yhi = mesh.cy == 0, mesh.cy == py - 1
        g.xh = self.xh[g.i0: g.i0 + g.itot + 1]
        g.xf = self.xf[g.i0: g.i0 + g.itot]
        g.yh = self.yh[g.j0: g.j0 + g.jtot + 1]
        g.yf = self.yf[g.j0: g.j0 + g.jtot]
        return g

    def cut(self, a, ring: int = 0):
        """This block's part of the whole-domain array `a` (NumPy or a
        tensor) whose x and y axes are -3 and -2, with `ring` more planes on
        each side when `a` is ghosted by `ring`; `a` itself on a
        whole-domain grid.  A view: clone it for a contiguous copy."""
        if self.mesh is None:
            return a
        return a[..., self.i0: self.i0 + self.itot + 2 * ring,
                 self.j0: self.j0 + self.jtot + 2 * ring, :]

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
