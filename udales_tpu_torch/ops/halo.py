"""Halo construction by padding (port of ``udales_tpu.ops.halo``).

Halos are values: fields are padded with periodic copies or explicit ghost
planes, which on one device replaces the reference's MPI halo exchange
(modboundary.f90:67-109).
"""
from __future__ import annotations

import torch


def _wrap(f, dim: int, h: int):
    return torch.cat([f.narrow(dim, f.shape[dim] - h, h), f,
                      f.narrow(dim, 0, h)], dim=dim)


def pad_periodic_xy(f, h: int = 1):
    """Periodic wrap pad of width h in axes 0 (x) and 1 (y)."""
    return _wrap(_wrap(f, 0, h), 1, h)


def pad_axis(f, axis: int, lo, hi):
    """Attach explicit ghost planes `lo`/`hi` (tensors broadcastable to the
    boundary slice shape, or None to skip) along `axis`."""
    plane = f.shape[:axis] + (1,) + f.shape[axis + 1:]
    parts = []
    if lo is not None:
        parts.append(lo.expand(plane).to(f.dtype))
    parts.append(f)
    if hi is not None:
        parts.append(hi.expand(plane).to(f.dtype))
    return torch.cat(parts, dim=axis)


def take_k(f, k: int):
    """f[..., k] keeping the trailing axis, for ghost construction."""
    k = k % f.shape[-1]
    return f[..., k:k + 1]
