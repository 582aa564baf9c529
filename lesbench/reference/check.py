"""The reference's side of ``correct``: rebuild a case from its inputs with
the frozen copy in ``les/``, advance the program's State from before the
window's last call by as many steps as that call took, and measure how far
the program's State after the call lies from the reference's.

The program's States come in as trees (`to_tree`): nested tuples of class
name and fields, tensors on the host.  `to_tree` walks any dataclass, so
the harness can hand over the program's State without this module knowing
the program's classes, and `from_tree` rebuilds the same structure from
the frozen copy's classes.  Nothing here imports the measured package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .les.ops.openbc import DriverWindow, XPlanes, YPlanes
from .les.run import Model, load_case
from .les.state import Ctl, FacStats, Fields, State

# the classes a State of the benchmark's cases holds (the facet energy
# balance's and the inlet generator's are None there)
CLASSES = {c.__name__: c for c in (State, Fields, Ctl, FacStats, XPlanes,
                                   YPlanes, DriverWindow)}

# the leaves compared, as paths into a State tree; an open x adds the
# outlet planes
FIELDS = ("c.u", "c.v", "c.w", "c.thl", "pres")
OUTLET = ("c.bx.u", "c.bx.v", "c.bx.w", "c.bx.thl")


def to_tree(obj, device="cpu"):
    """`obj` (a State or any part of it) as a tree of
    ``("cls", class name, {field: tree})``, ``("dict", {key: tree})``,
    tensors copied to `device`, and plain values."""
    if dataclasses.is_dataclass(obj):
        return ("cls", type(obj).__name__,
                {f.name: to_tree(getattr(obj, f.name), device)
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return ("dict", {k: to_tree(v, device) for k, v in obj.items()})
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(device, copy=True)
    return obj


def from_tree(tree, dtype=None, device="cpu"):
    """The frozen copy's objects from a `to_tree` tree, floating tensors
    cast to `dtype` (None: as they are) on `device`."""
    if isinstance(tree, tuple) and tree and tree[0] == "cls":
        _, name, fields = tree
        return CLASSES[name](**{k: from_tree(v, dtype, device)
                                for k, v in fields.items()})
    if isinstance(tree, tuple) and tree and tree[0] == "dict":
        return {k: from_tree(v, dtype, device) for k, v in tree[1].items()}
    if isinstance(tree, torch.Tensor):
        if dtype is not None and tree.is_floating_point():
            return tree.to(device=device, dtype=dtype)
        return tree.to(device)
    return tree


def leaf(tree, path: str):
    """The leaf of a tree at a dotted path (None where a part is None)."""
    for key in path.split("."):
        if tree is None:
            return None
        tree = tree[2][key] if tree[0] == "cls" else tree[1][key]
    return tree


def leaves(tree):
    """Every tensor leaf of a tree, as (dotted path, tensor)."""
    if isinstance(tree, tuple) and tree and tree[0] in ("cls", "dict"):
        items = tree[2] if tree[0] == "cls" else tree[1]
        for k, v in items.items():
            for path, t in leaves(v):
                yield (f"{k}.{path}" if path else k), t
    elif isinstance(tree, torch.Tensor):
        yield "", tree


def build(cfg: dict, case_dir, dtype: str, device) -> Model:
    """The reference Model of a configuration's staged case directory,
    through the frozen ``load_case`` (grid, IBM, Poisson factors and inlet
    rebuilt from the case's files)."""
    return load_case(case_dir, "900", dtype, device=device)


def _bf16_fields(state: State) -> State:
    """`state` with the prognostic fields of ``c`` and ``m`` and the
    pressure rounded to bfloat16 (and held in the model's dtype)."""
    r = lambda t: t.to(torch.bfloat16).to(t.dtype)
    fields = lambda f: dataclasses.replace(f, **{
        k: r(getattr(f, k)) for k in ("u", "v", "w", "thl", "qt", "e12")})
    return state.replace(c=fields(state.c), m=fields(state.m),
                         pres=r(state.pres))


def fingerprint(obj, path="") -> dict:
    """{leaf path: (sum, sum of squares)} in float64 of every floating
    tensor of a State (any dataclass tree), computed where it lives."""
    out = {}
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(fingerprint(getattr(obj, f.name), f"{path}.{f.name}"))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            out.update(fingerprint(v, f"{path}.{k}"))
    elif isinstance(obj, torch.Tensor) and obj.is_floating_point():
        t = obj.detach().double()
        out[path] = (float(t.sum()), float((t * t).sum()))
    return out


def start_gap(prog: dict, ref: dict) -> float:
    """The largest relative difference between two fingerprints (inf where
    their leaves differ): 0 when the program started from the seed as
    the reference does."""
    if prog.keys() != ref.keys():
        return float("inf")
    return max(abs(a - b) / max(abs(b), 1e-300)
               for k in ref for a, b in zip(prog[k], ref[k]))


def advance(model: Model, tree, steps: int, tf32: bool = False,
            bf16: bool = False):
    """The tree of `model`'s State after `steps` eager steps from the
    State `tree`, computed in the model's dtype on its device.  A driver
    window in `tree` is dropped: the reference reads its own from the case
    files.  The controls: `tf32` lets the card's matrix products round
    their inputs to TF32 (otherwise they stay in full precision); `bf16`
    holds the prognostic fields and the pressure in bfloat16 between
    steps."""
    dtype = model.grid.torch_dtype
    state = from_tree(tree, dtype, model.device)
    if state.drv is not None:
        state = state.replace(drv=None)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            if not bf16:
                state = model.run(state, steps)
            for _ in range(steps if bf16 else 0):
                state = _bf16_fields(model.run(state, 1))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    out = to_tree(state)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return out


def _field_gaps(out: dict, name: str, a, b) -> None:
    """`out[name + "_gap"]`: the largest absolute difference of the field
    `a` from `b` over `b`'s range (max - min); `out[name + "_rms"]`: the
    root-mean-square difference over `b`'s standard deviation, steadier
    from seed to seed than the widest gap.  Where one side is missing or
    the shapes differ, the gap reads inf and no rms is given."""
    if a is None or b is None or a.shape != b.shape:
        out[name + "_gap"] = float("inf")
        return
    a, b = a.double(), b.double()
    scale = float(b.max() - b.min())
    diff = float((a - b).abs().max())
    out[name + "_gap"] = diff / scale if scale > 0 else diff
    sd = float(b.std())
    rms = float((a - b).pow(2).mean().sqrt())
    out[name + "_rms"] = rms / sd if sd > 0 else rms


def gaps(prog, ref) -> dict:
    """How far the program's State tree `prog` lies from the reference's
    `ref`: for each compared field the largest absolute difference over
    the reference's range (max - min) of that field (`_field_gaps`), and
    for dt the relative difference.  A field that one side lacks, or
    whose shapes differ, reads inf.  Where the reference's State carries
    scalars, scalar n (from 1) is compared over its own range as
    ``sv<n>_gap`` and ``sv<n>_rms``."""
    out = {}
    paths = FIELDS + (OUTLET if leaf(ref, "c.bx") is not None else ())
    for path in paths:
        _field_gaps(out, path.replace("c.", "").replace(".", "_"),
                    leaf(prog, path), leaf(ref, path))
    sv_ref, sv_prog = leaf(ref, "c.sv"), leaf(prog, "c.sv")
    for n in range(sv_ref.shape[0] if sv_ref is not None else 0):
        have = sv_prog is not None and sv_prog.shape == sv_ref.shape
        _field_gaps(out, f"sv{n + 1}", sv_prog[n] if have else None,
                    sv_ref[n])
    a, b = float(leaf(prog, "dt")), float(leaf(ref, "dt"))
    out["dt_gap"] = abs(a - b) / abs(b) if b != 0 else abs(a - b)
    return out


def divergence(tree, grid) -> float:
    """max|div u| (1/s) of a State tree's velocity, in float64 on the
    reference's `grid`: periodic directions wrap, an open x takes its
    outlet face from the outlet planes ``c.bx.u`` and then leaves out the
    top level, where the inflow/outflow defect of the mean pressure mode
    sits."""
    u, v, w = (leaf(tree, f"c.{f}").double() for f in "uvw")
    bx = leaf(tree, "c.bx.u")
    gu = torch.cat([u, u[:1] if bx is None else bx.double()[None]], dim=0)
    gv = torch.cat([v, v[:, :1]], dim=1)
    dzfi = torch.as_tensor(np.asarray(grid.dzfi, np.float64))
    div = ((gu[1:] - gu[:-1]) * float(grid.dxi)
           + (gv[:, 1:] - gv[:, :-1]) * float(grid.dyi)
           + (w[:, :, 1:] - w[:, :, :-1]) * dzfi[None, None, :]).abs()
    return float((div if bx is None else div[:, :, :-1]).max())


def nonfinite(tree) -> list:
    """Paths of the floating leaves of a tree that hold a NaN or inf."""
    return [p for p, t in leaves(tree)
            if t.is_floating_point() and not bool(torch.isfinite(t).all())]
