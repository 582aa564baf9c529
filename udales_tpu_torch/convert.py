"""Move a State and a Model's static profiles in and out of plain NumPy.

The port never imports JAX, so the bridge to the reference package is NumPy:
a caller turns a ``udales_tpu`` State into nested dicts of arrays (for
example with ``np.asarray`` on each leaf) and hands them here.
"""
from __future__ import annotations

from dataclasses import fields as dc_fields

import numpy as np
import torch

from .ibm.eb import FACET_STATE_NAMES, FacetState
from .state import FACSTAT_FIELDS, FacStats, Fields, State

FIELD_NAMES = tuple(f.name for f in dc_fields(Fields))
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


def state_from_numpy(d: dict, device="cpu") -> State:
    """{"m": {u, v, w, thl, qt, e12, sv}, "c": {...}, "pres", "dt", "timee"}
    of NumPy arrays, with the optional "fac" (see `facet_state_from_numpy`)
    and "facstats" ({tau_x, ..., cth, tlast}) -> State of tensors on
    `device`."""
    def fields(fd):
        return Fields(**{k: t(fd[k]) for k in FIELD_NAMES})
    t = lambda a: torch.tensor(np.asarray(a), device=device)
    fac = facstats = None
    if d.get("fac") is not None:
        fac = facet_state_from_numpy(d["fac"], device)
    if d.get("facstats") is not None:
        facstats = _leaves_from_numpy(FacStats, FACSTAT_NAMES, d["facstats"],
                                      device)
    return State(m=fields(d["m"]), c=fields(d["c"]), pres=t(d["pres"]),
                 dt=t(d["dt"]), timee=t(d["timee"]), fac=fac,
                 facstats=facstats)


def state_to_numpy(state: State) -> dict:
    """Inverse of `state_from_numpy` (host copies)."""
    n = lambda x: x.detach().cpu().numpy()
    fields = lambda f: {k: n(getattr(f, k)) for k in FIELD_NAMES}
    out = {"m": fields(state.m), "c": fields(state.c),
           "pres": n(state.pres), "dt": n(state.dt),
           "timee": n(state.timee)}
    if state.fac is not None:
        out["fac"] = facet_state_to_numpy(state.fac)
    if state.facstats is not None:
        out["facstats"] = _leaves_to_numpy(state.facstats, FACSTAT_NAMES)
    return out


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
