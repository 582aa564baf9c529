"""Entry points for the flat neutral ABL slice (mirrors ``__graft_entry__``).

    _build(itot, jtot, ktot, dtype, ladaptive, device, mesh) -> Model
    _init_state(model, seed, amp)                      -> State
    entry()                                            -> (step, (state,))
    dryrun_multichip(n)    -> one step of the flat case split over n ranks

The case: periodic x/y, rough floor (wall function), Vreman closure, cd2
advection, a uniform grid of 1 m cells and a -1e-4 large-scale pressure
gradient driving u.  `device` defaults to the card; a caller that wants
the CPU says ``device="cpu"``, and without a card the default raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import BCConfig, Config, DomainConfig, RunConfig, WallsConfig
from .grid import Grid
from .run import Model
from .state import initial_state, profile_fields, randomize


def _build(itot, jtot, ktot, dtype="float32", ladaptive=True, device="cuda",
           mesh=None):
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
    model = Model(cfg, grid, device=device, mesh=mesh)
    model.dpdxl = torch.full((ktot,), -1e-4, dtype=grid.torch_dtype,
                             device=model.device)
    return model


def _init_state(model, seed=43, amp=0.05):
    """Profile start (u=1, thl=288) with zero-mean noise of amplitude `amp`
    in the lower half, drawn from a torch.Generator seeded with `seed`; the
    whole domain's also for a split Model (``parallel.mesh.shard_state``
    cuts this rank's block)."""
    nz = model.grid.ktot
    f = profile_fields(model.domain_grid, np.full(nz, 1.0), np.zeros(nz),
                       np.full(nz, 288.0), np.zeros(nz), np.full(nz, 5e-5),
                       device=model.device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    f = randomize(f, gen, amp, nz // 2)
    return initial_state(model.domain_grid, f, dt0=0.1)


def entry(device="cuda"):
    """Single-device forward step on the flagship configuration."""
    model = _build(64, 64, 64, device=device)
    return model.step, (_init_state(model),)


def dryrun_multichip(n_devices: int, device="cuda", host_staged=False):
    """The flat part of udales_tpu's dry run (``__graft_entry__.py:50-82``):
    `n_devices` ranks on a near-square px x py mesh (px <= py), a grid of
    8 px py cells a side, one adaptive step of the flat case.  Every rank of
    the group calls it (under torchrun, or after
    ``parallel.multihost.init_distributed``).  Returns (mesh, the gathered
    State after the step)."""
    from .parallel.mesh import gather_state, make_mesh, shard_state
    from .parallel.multihost import init_distributed
    _, world = init_distributed(device=device)
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a group of "
                         f"{world} processes")
    px = int(np.floor(np.sqrt(n_devices)))
    while n_devices % px != 0:
        px -= 1
    py = n_devices // px
    n = 8 * px * py
    mesh = make_mesh(px, py, host_staged=host_staged)
    model = _build(n, n, n, device=device, mesh=mesh)
    out = gather_state(model.step(shard_state(_init_state(model), mesh)),
                       mesh)
    if not bool(torch.isfinite(out.c.u).all()):
        raise RuntimeError("dryrun_multichip: non-finite u after the step")
    if mesh.rank == 0:
        print(f"dryrun_multichip OK: mesh {px}x{py}, grid {n}x{n}x{n}, "
              f"dt={float(out.dt):.4f}", flush=True)
    return mesh, out
