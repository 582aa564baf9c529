"""Move a State and a Model's static profiles in and out of plain NumPy.

The port never imports JAX, so the bridge to the reference package is NumPy:
a caller turns a ``udales_tpu`` State into nested dicts of arrays (for
example with ``np.asarray`` on each leaf) and hands them here.
"""
from __future__ import annotations

import numpy as np
import torch

from .ibm.eb import FACET_STATE_NAMES, FacetState
from .ops.inletgen import INLETGEN_NAMES, InletGen
from .ops.openbc import DriverWindow, Inlet, XPlanes, YPlanes
from .physics import HeatPumps, Purifier, Purifiers, ScalarSources, Vegetation
from .state import FACSTAT_FIELDS, Ctl, FacStats, Fields, State

# the tensor leaves of a Fields; bx / by are nested outlet planes
FIELD_NAMES = ("u", "v", "w", "thl", "qt", "e12", "sv")
PLANE_NAMES = FIELD_NAMES                    # XPlanes, YPlanes
DRIVER_WINDOW_NAMES = ("t", "u", "v", "w", "thl", "qt", "sv")
CTL_NAMES = ("freestreamav", "dgdt", "dpdx_shift")
INLET_NAMES = ("uprof", "vprof", "thlprof", "qtprof", "e12prof", "svprof",
               "t", "u", "v", "w", "thl", "qt", "sv")
# the arrays of a udales_tpu Vegetation (physics.Vegetation)
VEGETATION_NAMES = ("lad", "dcoef_u", "dcoef_v", "dcoef_w", "ud", "lsize",
                    "rs", "sveg")
# the Model's static vertical profiles (run.Model.__init__)
PROFILE_NAMES = ("dpdxl", "dpdyl", "ug", "vg", "thlpcar", "whls", "dqtdtls")


FACSTAT_NAMES = FACSTAT_FIELDS + ("tlast",)


def _leaves_from_numpy(cls, names, d, device):
    return cls(**{k: torch.tensor(np.asarray(d[k]), device=device)
                  for k in names})


def _leaves_to_numpy(obj, names) -> dict:
    return {k: getattr(obj, k).detach().cpu().numpy() for k in names}


def facet_state_from_numpy(d: dict, device="cpu") -> FacetState:
    """{T, Tdash, hfi, efi, wsoil, hurel, qsat, f, tnextEB, tEB_last} of
    NumPy arrays (the leaves of a ``udales_tpu`` FacetState; its derived
    ``dense`` surface stacks are not state and are ignored) -> FacetState
    on `device`."""
    return _leaves_from_numpy(FacetState, FACET_STATE_NAMES, d, device)


def facet_state_to_numpy(fac: FacetState) -> dict:
    """Inverse of `facet_state_from_numpy` (host copies)."""
    return _leaves_to_numpy(fac, FACET_STATE_NAMES)


# optional State entries: name -> (dataclass, leaf names)
_STATE_PARTS = {"facstats": (FacStats, FACSTAT_NAMES),
                "ctl": (Ctl, CTL_NAMES), "ig": (InletGen, INLETGEN_NAMES),
                "drv": (DriverWindow, DRIVER_WINDOW_NAMES)}
_FIELD_PARTS = {"bx": XPlanes, "by": YPlanes}


def state_from_numpy(d: dict, device="cpu") -> State:
    """{"m": {u, v, w, thl, qt, e12, sv[, bx, by]}, "c": {...}, "pres",
    "dt", "timee"} of NumPy arrays -> State of tensors on `device`.  The
    optional entries are dicts of arrays too: "bx" / "by" (the outlet planes
    of a Fields, leaves as `PLANE_NAMES`), "fac" (see
    `facet_state_from_numpy`), "facstats", "ctl", "ig" and "drv" (the leaves
    of ``FacStats``, ``Ctl``, ``InletGen`` and ``DriverWindow``) and "taud"
    (the wall-stress diagnostics {x, y, z, hf})."""
    def fields(fd):
        planes = {k: _leaves_from_numpy(cls, PLANE_NAMES, fd[k], device)
                  for k, cls in _FIELD_PARTS.items()
                  if fd.get(k) is not None}
        return Fields(**{k: t(fd[k]) for k in FIELD_NAMES}, **planes)
    t = lambda a: torch.tensor(np.asarray(a), device=device)
    parts = {k: _leaves_from_numpy(cls, names, d[k], device)
             for k, (cls, names) in _STATE_PARTS.items()
             if d.get(k) is not None}
    if d.get("fac") is not None:
        parts["fac"] = facet_state_from_numpy(d["fac"], device)
    if d.get("taud") is not None:
        parts["taud"] = {k: t(v) for k, v in d["taud"].items()}
    return State(m=fields(d["m"]), c=fields(d["c"]), pres=t(d["pres"]),
                 dt=t(d["dt"]), timee=t(d["timee"]), **parts)


def state_to_numpy(state: State) -> dict:
    """Inverse of `state_from_numpy` (host copies)."""
    n = lambda x: x.detach().cpu().numpy()

    def fields(f):
        out = {k: n(getattr(f, k)) for k in FIELD_NAMES}
        for k in _FIELD_PARTS:
            if getattr(f, k) is not None:
                out[k] = _leaves_to_numpy(getattr(f, k), PLANE_NAMES)
        return out
    out = {"m": fields(state.m), "c": fields(state.c),
           "pres": n(state.pres), "dt": n(state.dt),
           "timee": n(state.timee)}
    if state.fac is not None:
        out["fac"] = facet_state_to_numpy(state.fac)
    if state.taud is not None:
        out["taud"] = {k: n(v) for k, v in state.taud.items()}
    for k, (_, names) in _STATE_PARTS.items():
        if getattr(state, k) is not None:
            out[k] = _leaves_to_numpy(getattr(state, k), names)
    return out


def inlet_from_numpy(d: dict, dtype=torch.float64, device="cpu") -> Inlet:
    """{"mode", "irecy" and whichever of `INLET_NAMES` are set} (the fields
    of a ``udales_tpu`` Inlet as NumPy arrays; absent or None stay None) ->
    ``ops.openbc.Inlet`` of `dtype` tensors on `device`."""
    arrays = {k: torch.tensor(np.asarray(d[k]), dtype=dtype, device=device)
              for k in INLET_NAMES if d.get(k) is not None}
    return Inlet(mode=int(d["mode"]), irecy=int(d.get("irecy", 0)), **arrays)


def load_profiles(model, arrays: dict) -> None:
    """Copy the static profiles (`PROFILE_NAMES`) from NumPy arrays into
    `model`, in its dtype and on its device."""
    for name in PROFILE_NAMES:
        setattr(model, name, torch.tensor(
            np.asarray(arrays[name]), dtype=model.grid.torch_dtype,
            device=model.device))


def ibm_static_to_numpy(ibm) -> dict:
    """The static geometry of an ``ibm.IBM`` as NumPy: the dense masks
    {u, v, w, c}, the ghosted pmasks {u, v, w, c}, every grid's sections as
    read {ijk, area, dist, fac, active, rec} and the facet arrays."""
    n = lambda x: x.detach().cpu().numpy()
    return {
        "masks": {k: n(getattr(ibm.masks, k)) for k in "uvwc"},
        "pmasks": {k: n(getattr(ibm, f"pmask_{k}")) for k in "uvwc"},
        "sec": {k: {f: np.asarray(getattr(s, f))
                    for f in ("ijk", "area", "dist", "fac", "active", "rec")}
                for k, s in ibm.sec.items()},
        "facnorm": ibm.facnorm, "facz0": ibm.facz0, "facz0h": ibm.facz0h,
        "facT": ibm.facT, "faca": ibm.faca, "faclGR": ibm.faclGR,
    }


def physics_from_numpy(model, d: dict) -> None:
    """Attach the long-tail physics of a ``udales_tpu`` Model, carried over
    as NumPy, to the port's `model` (in its dtype, on its device):

      - "scalsources": the (nsv, nx, ny, nz) field of its ScalarSources;
      - "vegetation": {`VEGETATION_NAMES`} of its Vegetation (the drag
        coefficients at the faces; "sveg" may be None);
      - "purifiers": the boxes of its Purifiers, rows (il, iu, jl, ju, kl,
        ku, ipu) with 0-based bounds;
      - "heatpumps": the (n, 3) 0-based points of its HeatPumps.

    Absent or None entries leave the model's attribute as it is."""
    cfg, grid, dev = model.cfg, model.grid, model.device
    if d.get("scalsources") is not None:
        model.scalsources = ScalarSources(torch.as_tensor(
            np.asarray(d["scalsources"], np.float64).astype(grid.dtype),
            device=dev))
    if d.get("vegetation") is not None:
        v = d["vegetation"]
        model.vegetation = Vegetation.from_faces(
            cfg, grid, *(v[k] for k in VEGETATION_NAMES[:-1]),
            sveg=v.get("sveg"), device=dev)
    if d.get("purifiers") is not None:
        model.purifiers = Purifiers(cfg, grid, [
            Purifier(*(int(x) for x in r)) for r in d["purifiers"]])
    if d.get("heatpumps") is not None:
        model.heatpumps = HeatPumps(cfg, grid, np.asarray(d["heatpumps"]),
                                    device=dev)
