"""Entry points for the flat neutral ABL slice (mirrors ``__graft_entry__``).

    _build(itot, jtot, ktot, dtype, ladaptive, device) -> Model
    _init_state(model, seed, amp)                      -> State
    entry()                                            -> (step, (state,))

The case: periodic x/y, rough floor (wall function), Vreman closure, cd2
advection, a uniform grid of 1 m cells and a -1e-4 large-scale pressure
gradient driving u.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import BCConfig, Config, DomainConfig, RunConfig, WallsConfig
from .grid import Grid
from .run import Model
from .state import initial_state, profile_fields, randomize


def _build(itot, jtot, ktot, dtype="float32", ladaptive=True, device="cpu"):
    cfg = Config(
        domain=DomainConfig(itot=itot, jtot=jtot, ktot=ktot,
                            xlen=float(itot), ylen=float(jtot)),
        run=RunConfig(ladaptive=ladaptive, dtmax=0.5),
        walls=WallsConfig(lbottom=True),
        bc=BCConfig(z0=0.03, z0h=0.003, thls=288.0),
        dtype=dtype,
    )
    np_dt = np.float32 if dtype == "float32" else np.float64
    grid = Grid.uniform(itot, jtot, ktot, float(itot), float(jtot),
                        float(ktot), dtype=np_dt)
    model = Model(cfg, grid, device=device)
    model.dpdxl = torch.full((ktot,), -1e-4, dtype=grid.torch_dtype,
                             device=model.device)
    return model


def _init_state(model, seed=43, amp=0.05):
    """Profile start (u=1, thl=288) with zero-mean noise of amplitude `amp`
    in the lower half, drawn from a torch.Generator seeded with `seed`."""
    nz = model.grid.ktot
    f = profile_fields(model.grid, np.full(nz, 1.0), np.zeros(nz),
                       np.full(nz, 288.0), np.zeros(nz), np.full(nz, 5e-5),
                       device=model.device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    f = randomize(f, gen, amp, nz // 2)
    return initial_state(model.grid, f, dt0=0.1)


def entry(device="cpu"):
    """Single-device forward step on the flagship configuration."""
    model = _build(64, 64, 64, device=device)
    return model.step, (_init_state(model),)
