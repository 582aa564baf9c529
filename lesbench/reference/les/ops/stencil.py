"""Shifted-slice helpers for stencils on ghosted tensors (port of
``udales_tpu.ops.stencil``).

A ghosted cell-centred tensor ``G`` with halo ``h`` in x/y and one ghost
cell in k satisfies ``G[h+i, h+j, 1+k] == f[i, j, k]``.  The w (z-face)
tensor carries no k ghosts: ``Gw[h+i, h+j, k] == w[i, j, k]``, k in [0, nz].
The views index the last three axes, so a stack of scalars with a leading
axis (``Fields.sv``) goes through a stencil as one tensor.
"""
from __future__ import annotations


def sh(G, di: int, dj: int, dk: int, nx: int, ny: int, nz: int, h: int = 1,
       hk: int = 1):
    """Interior view of ghosted cell tensor shifted by (di, dj, dk)."""
    return G[..., h + di: h + di + nx, h + dj: h + dj + ny,
             hk + dk: hk + dk + nz]


def shw(Gw, di: int, dj: int, dk: int, nx: int, ny: int, nz: int, h: int = 1):
    """(nx, ny, nz) view of the ghosted face tensor starting at face dk."""
    return Gw[..., h + di: h + di + nx, h + dj: h + dj + ny, dk: dk + nz]


def kvec(a, lo: int, n: int):
    """1-D vertical metric slice broadcast over (nx, ny, n): a[lo:lo+n]."""
    return a[lo: lo + n][None, None, :]
