"""Move a State and a Model's static profiles in and out of plain NumPy.

The port never imports JAX, so the bridge to the reference package is NumPy:
a caller turns a ``udales_tpu`` State into nested dicts of arrays (for
example with ``np.asarray`` on each leaf) and hands them here.
"""
from __future__ import annotations

from dataclasses import fields as dc_fields

import numpy as np
import torch

from .state import Fields, State

FIELD_NAMES = tuple(f.name for f in dc_fields(Fields))
# the Model's static vertical profiles (run.Model.__init__)
PROFILE_NAMES = ("dpdxl", "dpdyl", "ug", "vg", "thlpcar", "whls", "dqtdtls")


def state_from_numpy(d: dict, device="cpu") -> State:
    """{"m": {u, v, w, thl, qt, e12, sv}, "c": {...}, "pres", "dt", "timee"}
    of NumPy arrays -> State of tensors on `device`."""
    def fields(fd):
        return Fields(**{k: t(fd[k]) for k in FIELD_NAMES})
    t = lambda a: torch.tensor(np.asarray(a), device=device)
    return State(m=fields(d["m"]), c=fields(d["c"]), pres=t(d["pres"]),
                 dt=t(d["dt"]), timee=t(d["timee"]))


def state_to_numpy(state: State) -> dict:
    """Inverse of `state_from_numpy` (host copies)."""
    n = lambda x: x.detach().cpu().numpy()
    fields = lambda f: {k: n(getattr(f, k)) for k in FIELD_NAMES}
    return {"m": fields(state.m), "c": fields(state.c),
            "pres": n(state.pres), "dt": n(state.dt),
            "timee": n(state.timee)}


def load_profiles(model, arrays: dict) -> None:
    """Copy the static profiles (`PROFILE_NAMES`) from NumPy arrays into
    `model`, in its dtype and on its device."""
    for name in PROFILE_NAMES:
        setattr(model, name, torch.tensor(
            np.asarray(arrays[name]), dtype=model.grid.torch_dtype,
            device=model.device))
