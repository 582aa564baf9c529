"""Prognostic state (port of ``udales_tpu.state``, closed-domain slice).

  - ``Fields``: one set of prognostic fields at a single time level
      u   (nx, ny, nz)    x-velocity at x-faces
      v   (nx, ny, nz)    y-velocity at y-faces
      w   (nx, ny, nz+1)  z-velocity at z-faces (w[...,0]=bottom, w[...,nz]=top)
      thl, qt, e12 (nx, ny, nz)
      sv  (nsv, nx, ny, nz) passive scalars
  - ``State``: the RK3 carry: start-of-step fields ``m``, current substep
      fields ``c``, accumulated pressure ``pres``, timestep ``dt`` and
      elapsed time ``timee`` (both 0-d tensors on the field device).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .grid import Grid


@dataclass(frozen=True)
class Fields:
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    thl: torch.Tensor
    qt: torch.Tensor
    e12: torch.Tensor
    sv: torch.Tensor  # (nsv, nx, ny, nz); nsv may be 0


@dataclass(frozen=True)
class State:
    m: Fields
    c: Fields
    pres: torch.Tensor
    dt: torch.Tensor
    timee: torch.Tensor

    def replace(self, **kw) -> "State":
        return replace(self, **kw)


def zero_fields(grid: Grid, nsv: int = 0, device="cpu") -> Fields:
    nx, ny, nz = grid.shape
    kw = dict(dtype=grid.torch_dtype, device=device)
    z3 = lambda: torch.zeros((nx, ny, nz), **kw)
    return Fields(u=z3(), v=z3(), w=torch.zeros((nx, ny, nz + 1), **kw),
                  thl=z3(), qt=z3(), e12=z3(),
                  sv=torch.zeros((nsv, nx, ny, nz), **kw))


def profile_fields(grid: Grid, uprof, vprof, thlprof, qtprof, e12prof,
                   svprof=None, device="cpu") -> Fields:
    """Cold-start initialization from vertical profiles
    (modstartup.f90:1155-1184)."""
    nx, ny, nz = grid.shape
    kw = dict(dtype=grid.torch_dtype, device=device)
    tile = lambda p: torch.as_tensor(p, **kw)[None, None, :].expand(
        nx, ny, nz).clone()
    nsv = 0 if svprof is None else svprof.shape[0]
    sv = (torch.zeros((0, nx, ny, nz), **kw) if nsv == 0 else
          torch.as_tensor(svprof, **kw)[:, None, None, :].expand(
              nsv, nx, ny, nz).clone())
    return Fields(u=tile(uprof), v=tile(vprof),
                  w=torch.zeros((nx, ny, nz + 1), **kw),
                  thl=tile(thlprof), qt=tile(qtprof), e12=tile(e12prof),
                  sv=sv)


def randomize(fields: Fields, generator: torch.Generator, amplitude: float,
              krand: int) -> Fields:
    """Add zero-mean uniform perturbations to u, v, w in levels [0, krand)
    (modstartup.f90:1212-1224, randomize_field:2367).

    Each level's perturbation is de-meaned, as the reference subtracts the
    slab mean of the random numbers.  The draws come from `generator`, which
    must live on the fields' device; they differ from ``jax.random``'s."""
    def perturb(f):
        r = torch.rand(f.shape, generator=generator, dtype=f.dtype,
                       device=f.device) * 2.0 - 1.0
        r = r - r.mean(dim=(0, 1), keepdim=True)
        mask = (torch.arange(f.shape[2], device=f.device) < krand)
        return f + amplitude * r * mask.to(f.dtype)
    return replace(fields, u=perturb(fields.u), v=perturb(fields.v),
                   w=perturb(fields.w))


def initial_state(grid: Grid, fields: Fields, dt0: float = 1.0) -> State:
    nx, ny, nz = grid.shape
    kw = dict(dtype=grid.torch_dtype, device=fields.u.device)
    return State(m=fields, c=fields,
                 pres=torch.zeros((nx, ny, nz), **kw),
                 dt=torch.tensor(dt0, **kw),
                 timee=torch.tensor(0.0, **kw))
