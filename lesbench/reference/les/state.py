"""Prognostic state (port of ``udales_tpu.state``).

  - ``Fields``: one set of prognostic fields at a single time level
      u   (nx, ny, nz)    x-velocity at x-faces
      v   (nx, ny, nz)    y-velocity at y-faces
      w   (nx, ny, nz+1)  z-velocity at z-faces (w[...,0]=bottom, w[...,nz]=top)
      thl, qt, e12 (nx, ny, nz)
      sv  (nsv, nx, ny, nz) passive scalars
      bx, by  outlet planes of open-x / open-y runs (``ops.openbc``)
  - ``State``: the RK3 carry: start-of-step fields ``m``, current substep
      fields ``c``, accumulated pressure ``pres``, timestep ``dt`` and
      elapsed time ``timee`` (both 0-d tensors on the field device), the
      facet state ``fac`` of energy-balance runs (``ibm.eb.FacetState``),
      the ``FacStats`` accumulators of lwritefac runs, the free-stream
      controller ``ctl``, the rescale-recycle generator ``ig``, the
      rolling driver window ``drv`` and the wall-stress diagnostics
      ``taud`` that the tx/ty/tz/hf field dumps write.

``State.map`` and ``Fields.map`` apply a function to every tensor leaf (the
counterparts of udales_tpu's ``jax.tree.map``; ``map_state`` also hands
the function the leaf's path); ``copy_into`` writes one
State's leaves into another's, in place, as the compiled step
(``graph.CompiledStep``) keeps its static State.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Any

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
    bx: Any = None  # XPlanes outlet state for open-x runs (ops/openbc.py)
    by: Any = None  # YPlanes outlet state for open-y runs (ops/openbc.py)

    def map(self, fn) -> "Fields":
        """`fn` applied to every tensor leaf, the outlet planes included."""
        return map_state(lambda _, t: fn(t), self)


@dataclass(frozen=True)
class State:
    m: Fields
    c: Fields
    pres: torch.Tensor
    dt: torch.Tensor
    timee: torch.Tensor
    fac: Any = None       # ibm.eb.FacetState for energy-balance runs
    facstats: Any = None  # FacStats accumulators for lwritefac runs
    ctl: Any = None       # Ctl: ifixuinf=2 free-stream controller state
    ig: Any = None        # InletGen rescale-recycle state (ops/inletgen.py)
    drv: Any = None       # DriverWindow: rolling precursor-replay chunk
                          # (lchunkread streaming, io/driverstream.py)
    taud: Any = None      # wall-stress diagnostics {x, y, z, hf} of the
                          # last third substep (Model.need_taudiag)

    def replace(self, **kw) -> "State":
        return replace(self, **kw)

    def map(self, fn) -> "State":
        """`fn` applied to every tensor leaf, through ``fac``,
        ``facstats``, ``ctl``, ``ig``, ``drv``, ``taud`` and the outlet
        planes ``bx``/``by``; None stays None."""
        return map_state(lambda _, t: fn(t), self)


def map_state(fn, obj, path=()):
    """fn(path, tensor) over every tensor leaf of a State or any of its
    parts (dataclasses and dicts nest; None stays None), rebuilt with the
    results."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return fn(path, obj)
    if dataclasses.is_dataclass(obj):
        return replace(obj, **{
            f.name: map_state(fn, getattr(obj, f.name), path + (f.name,))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: map_state(fn, v, path + (k,)) for k, v in obj.items()}
    raise TypeError(f"State leaf {'.'.join(map(str, path))}: "
                    f"{type(obj).__name__} is not a tensor")


def _leaf_pairs(dst, src, path="state"):
    """(path, dst leaf, src leaf) over two trees of one structure; raises
    ValueError where the structure, a shape, a dtype or a device
    differs."""
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor):
            raise ValueError(f"copy_into: {path} is a tensor in the "
                             f"destination and {type(src).__name__} in the "
                             f"source")
        if (src.shape, src.dtype, src.device) != (dst.shape, dst.dtype,
                                                  dst.device):
            raise ValueError(
                f"copy_into: {path} is {tuple(src.shape)} {src.dtype} on "
                f"{src.device} in the source, {tuple(dst.shape)} "
                f"{dst.dtype} on {dst.device} in the destination")
        yield path, dst, src
    elif dataclasses.is_dataclass(dst) and not isinstance(dst, type):
        if type(src) is not type(dst):
            raise ValueError(f"copy_into: {path} is {type(dst).__name__} in "
                             f"the destination and {type(src).__name__} in "
                             f"the source")
        for f in dataclasses.fields(dst):
            yield from _leaf_pairs(getattr(dst, f.name),
                                   getattr(src, f.name), f"{path}.{f.name}")
    elif isinstance(dst, dict):
        if not isinstance(src, dict) or src.keys() != dst.keys():
            raise ValueError(f"copy_into: {path} has keys "
                             f"{sorted(dst)} in the destination and "
                             f"{sorted(src) if isinstance(src, dict) else src}"
                             f" in the source")
        for k in dst:
            yield from _leaf_pairs(dst[k], src[k], f"{path}.{k}")
    elif dst is None or src is None:
        if dst is not src:
            raise ValueError(f"copy_into: {path} is "
                             f"{'None' if dst is None else 'set'} in the "
                             f"destination and "
                             f"{'None' if src is None else 'set'} in the "
                             f"source")
    elif dst != src:
        raise ValueError(f"copy_into: {path} is {dst!r} in the destination "
                         f"and {src!r} in the source")


def same_structure(a, b) -> bool:
    """Whether `copy_into(a, b)` would take `b`: the same tree, shapes,
    dtypes and devices."""
    try:
        for _ in _leaf_pairs(a, b):
            pass
    except ValueError:
        return False
    return True


def copy_into(dst, src) -> None:
    """Write every tensor leaf of `src` into the same leaf of `dst`, in
    place (``Tensor.copy_``); `dst` and `src` are States, Fields or any of
    their parts.  Raises ValueError, before it writes anything, where the
    two differ in structure (a part None in one and set in the other, other
    dict keys or dataclass types), shape, dtype or device.  A source leaf
    that is its own destination is skipped; one that shares memory with
    another destination leaf is cloned first, so the result does not
    depend on the order of the copies."""
    pairs = list(_leaf_pairs(dst, src))
    held = {d.untyped_storage().data_ptr() for _, d, _ in pairs}
    copies = [(d, s.clone() if s.untyped_storage().data_ptr() in held
               else s) for _, d, s in pairs if s is not d]
    for d, s in copies:
        d.copy_(s)


FACSTAT_FIELDS = ("tau_x", "tau_y", "tau_z", "pres", "pres2", "htc", "cth")


@dataclass(frozen=True)
class FacStats:
    """lwritefac facet-diagnostic accumulators (modibm.f90:114-127,
    1246-1280): dt-weighted running sums of facet-area-averaged wall stress,
    pressure and heat-transfer coefficients, each (nfcts,)."""
    tau_x: torch.Tensor
    tau_y: torch.Tensor
    tau_z: torch.Tensor
    pres: torch.Tensor
    pres2: torch.Tensor
    htc: torch.Tensor
    cth: torch.Tensor
    tlast: torch.Tensor   # scalar: time of the last fac write


@dataclass(frozen=True)
class Ctl:
    """Free-stream controller state (ifixuinf=2, modforces.fixuinf2 +
    modtstep.f90:194-200): running-average free stream, its rate dgdt and
    the accumulated dpdx offset, each a 0-d tensor."""
    freestreamav: torch.Tensor
    dgdt: torch.Tensor
    dpdx_shift: torch.Tensor


def zero_facstats(nfcts: int, dtype, device="cpu") -> FacStats:
    z = lambda: torch.zeros(nfcts, dtype=dtype, device=device)
    return FacStats(**{k: z() for k in FACSTAT_FIELDS},
                    tlast=torch.zeros((), dtype=dtype, device=device))


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


def initial_state(grid: Grid, fields: Fields, dt0: float = 1.0,
                  fac=None) -> State:
    nx, ny, nz = grid.shape
    kw = dict(dtype=grid.torch_dtype, device=fields.u.device)
    return State(m=fields, c=fields,
                 pres=torch.zeros((nx, ny, nz), **kw),
                 dt=torch.tensor(dt0, **kw),
                 timee=torch.tensor(0.0, **kw), fac=fac)
