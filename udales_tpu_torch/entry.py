"""Entry points for the flat neutral ABL slice (mirrors ``__graft_entry__``).

    _build(itot, jtot, ktot, dtype, ladaptive, device, mesh) -> Model
    _init_state(model, seed, amp)                      -> State
    entry()                                            -> (step, (state,))
    dryrun_multichip(n)    -> one step of the flat case and of a building
                              case, and two of a driven case, each split
                              over n ranks

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
    """The three paths of udales_tpu's dry run (``__graft_entry__.py:50-
    218``): `n_devices` ranks on a near-square px x py mesh (px <= py); one
    adaptive step of the flat case on a grid of 8 px py cells a side, then
    one step of a building case generated by the port's preprocessor (one
    box, ``ltempeq``, ``lbuoyancy``, facet wall functions; a grid of 8
    max(px, py) cells a side) through ``run.load_case(..., mesh=)``, then
    two steps of a driven case on that grid (a ``BCxm = 3`` driver inlet
    and a convective outlet, replayed from synthesized precursor planes
    through an ``lchunkread`` window of 8 records, refilled between the
    steps).  Every rank of the group calls it (under torchrun, or after
    ``parallel.multihost.init_distributed``) and stages the cases in
    temporary directories of its own.  Returns (mesh, the gathered flat
    State, the gathered building State, the gathered driven State), each
    after its steps; a non-finite u or thl raises."""
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

    # the building case: masks, facet sections, wall functions under the
    # same mesh (udales_tpu's second path)
    import tempfile
    from pathlib import Path
    from .prep.prep import PrepConfig, make_box_stl, prepare_case
    from .run import load_case
    nib = 8 * max(px, py)
    with tempfile.TemporaryDirectory(prefix="udales_dryrun_") as td:
        tmp = Path(td)
        make_box_stl(tmp / "geom.stl", nib // 4, nib // 2, nib // 4,
                     nib // 2, nib // 4, float(nib), float(nib))
        counts = prepare_case(tmp / "geom.stl", tmp, PrepConfig(
            itot=nib, jtot=nib, ktot=nib, xlen=float(nib), ylen=float(nib),
            zsize=float(nib), expnr="902", u0=1.0, dpdx=1e-4,
            with_radiation=False))
        (tmp / "namoptions.902").write_text(_BOX_NAMELIST.format(
            n=nib, walls="\n".join(
                [f"nfcts = {counts['nfcts']}"]
                + [f"{k}_{w} = {counts[f'{k}_{w}']}" for k in (
                    "nsolpts", "nbndpts", "nfctsecs") for w in "uvwc"])))
        ibm_model = load_case(tmp, "902", "float32", device=device,
                              mesh=mesh)
        iout = gather_state(ibm_model.step(ibm_model.cold_start(seed=1)),
                            mesh)
    if not all(bool(torch.isfinite(f).all()) for f in (iout.c.u,
                                                        iout.c.thl)):
        raise RuntimeError("dryrun_multichip: non-finite u or thl after "
                           "the building step")
    if mesh.rank == 0:
        print(f"dryrun_multichip OK (IBM): mesh {px}x{py}, grid {nib}^3, "
              f"nfcts={counts['nfcts']}, dt={float(iout.dt):.4f}",
              flush=True)

    # the driven case: precursor planes replayed through the rolling window
    # (State.drv split along y) into a driver inlet and a convective outlet
    from .io.driverfiles import write_driver_files
    with tempfile.TemporaryDirectory(prefix="udales_dryrun_drv_") as td:
        tmp = Path(td)
        rng = np.random.default_rng(5)
        nt = 24
        base = 1.0 + 0.1 * np.sin(np.arange(nib) / 3.0)
        mk = lambda a: a + 0.01 * rng.standard_normal((nt, nib, nib))
        planes = dict(u=mk(base[None, :, None]), v=mk(0.0),
                      w=np.concatenate([np.zeros((nt, nib, 1)), mk(0.0)],
                                       axis=2),
                      thl=mk(288.0))
        write_driver_files(tmp, "903", np.arange(nt) * 0.05, planes, nib,
                           nib)
        zc = np.arange(nib) + 0.5
        prof = np.column_stack([zc, np.full(nib, 288.0), np.zeros(nib),
                                np.full(nib, 1.0), np.zeros(nib),
                                np.full(nib, 5e-5)])
        np.savetxt(tmp / "prof.inp.903", prof, fmt="%14.6e",
                   header="profiles\nz thl qt u v tke")
        np.savetxt(tmp / "lscale.inp.903",
                   np.column_stack([zc] + [np.zeros(nib)] * 9),
                   fmt="%14.6e", header="lscale\n"
                   "z uq vq pqx pqy wfls dqtdxls dqtdyls dqtdtls dthl")
        (tmp / "namoptions.903").write_text(
            _DRIVEN_NAMELIST.format(n=nib))
        dmodel = load_case(tmp, "903", "float32", device=device, mesh=mesh)
        dst = dmodel.cold_start(seed=2)
        for _ in range(2):
            dst = dmodel.driver_stream.ensure(dst)
            dst = dmodel.step(dst)
        dout = gather_state(dst, mesh)
    if not all(bool(torch.isfinite(f).all()) for f in (dout.c.u,
                                                        dout.c.thl)):
        raise RuntimeError("dryrun_multichip: non-finite u or thl after "
                           "the driven steps")
    if mesh.rank == 0:
        print(f"dryrun_multichip OK (driven stream): mesh {px}x{py}, grid "
              f"{nib}^3, chunk=8, dt={float(dout.dt):.4f}", flush=True)
    return mesh, out, iout, dout


# the building case of `dryrun_multichip` (udales_tpu's, __graft_entry__.py)
_BOX_NAMELIST = """
&RUN
iexpnr = 902
ladaptive = .true.
dtmax = 0.1
/
&DOMAIN
itot = {n}
jtot = {n}
ktot = {n}
xlen = {n}.
ylen = {n}.
/
&PHYSICS
ltempeq = .true.
lbuoyancy = .true.
/
&WALLS
{walls}
iwalltemp = 2
/
&BC
thls = 290.
z0 = 0.05
z0h = 0.00035
/
"""


# the driven case of `dryrun_multichip` (udales_tpu's, __graft_entry__.py)
_DRIVEN_NAMELIST = """
&RUN
iexpnr = 903
ladaptive = .true.
dtmax = 0.05
runtime = 1.0
/
&DOMAIN
itot = {n}
jtot = {n}
ktot = {n}
xlen = {n}.
ylen = {n}.
/
&BC
BCxm = 3
/
&DRIVER
idriver = 2
driverjobnr = 903
tdriverstart = 0.
lchunkread = .true.
chunkread_size = 8
/
"""
