"""One rank of a split run of udales_tpu_torch, for tests/test_torch_split.py,
tests/test_torch_split_urban.py, tests/test_torch_split_{open,recycle,
driven}.py, tests/test_torch_multihost.py and the card cases of
tests/test_torch_step.py.  It imports torch and udales_tpu_torch, never JAX
or udales_tpu.

    python tests/torch_split_worker.py JOB RANK

JOB is a pickle the test writes:

  - "world", "address": the group's size and "host:port"; address None
    takes the group from torchrun's environment (MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE), as ``init_distributed()`` does with no arguments,
    and "bare" leaves that environment unset (one process on a free port);
  - "backend", "device", "host_staged", "timeout";
  - "mesh": (px, py), or None for ``global_mesh()``;
  - "cases": [{"name", "cfg" (a udales_tpu_torch Config), "zf", "dpdxl",
    "state" (numpy, as ``convert.state_to_numpy``), "steps"}], each taken
    from the whole-domain State by ``shard_state_global`` and run for
    "steps" steps on the mesh (a streamed driver window refilled before
    each step); with "graph" the same steps also run as replays of the
    compiled step (``Model.run(..., graph=True)``) on a second Model of
    the case, and with "rebuild" a further "steps" steps of both from the
    final State without its facet state (a State of another structure,
    which builds the compiled step again); a case with "case_dir",
    "expnr" and "dtype" in place of "cfg", "zf" and "dpdxl" is built by
    ``run.load_case(..., mesh=)``; a
    case with "sim" (an output directory) and "runtime" in place of "steps"
    runs ``sim.Simulation`` for that long instead, and with "restart" (a
    directory) rank 0 then writes the gathered State's Fortran restart
    files there (``io.restart.write_state_fortran``), which every rank
    then reads back into the mesh and steps "continue" steps further; it
    returns every array its writers were handed, in float64
    (`recording_writers`); a case with "warm" ((directory, start file) of
    the reference's Fortran restart files) in place of "state" starts from
    them by ``io.restart.warmstart_state(..., model=)``;
  - "sections": [{"name", "case_dir", "expnr", "fields" (whole-domain u,
    v, w, thl as numpy)}]: the IBM of each case on this rank's block, and
    per grid the rows of the domain's sections it holds, their interpolated
    u, v, w and air temperature from the ghosted blocks of "fields", and
    how many of them are reconstruction sections and how many reach into
    the block's ghost ring;
  - "checks": also hold the halo exchange (h = 1, 2) against ``pad_wrap``,
    ``gather_state(shard_state(.))`` against the identity (and the blocks
    against ``state_shardings``), and the split slab means against the
    whole domain's;
  - "dryrun": run ``entry.dryrun_multichip(world)`` instead;
  - "out": the directory where rank r writes rank<r>.pkl: the mesh
    coordinates, and per case this rank's block and the gathered State
    after the steps, the kernel's launches, the collectives and bytes, and
    with "graph" the same of the compiled run (`compiled_run`); a
    Simulation also reports its ``step_kind``.
"""
import dataclasses
import os
from contextlib import contextmanager
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from udales_tpu_torch import entry  # noqa: E402
from udales_tpu_torch.convert import (state_from_numpy,  # noqa: E402
                                      state_to_numpy)
from udales_tpu_torch.grid import Grid  # noqa: E402
from udales_tpu_torch.ops.fused_diff import fused_diff_mom  # noqa: E402
from udales_tpu_torch.ops.halo import pad_wrap  # noqa: E402
from udales_tpu_torch.ops.thermo import avexy_masked, slab_mean  # noqa
from udales_tpu_torch.parallel.mesh import (gather_state,  # noqa: E402
                                            make_mesh, shard_state,
                                            state_shardings)
from udales_tpu_torch.parallel.multihost import (  # noqa: E402
    free_port, global_mesh, init_distributed, shard_state_global)
from udales_tpu_torch.ops.boundary import ghost_thl  # noqa: E402
from udales_tpu_torch.io.restart import (warmstart_state,  # noqa: E402
                                         write_state_fortran)
from udales_tpu_torch.run import Model, _velocity_ghosts, load_case  # noqa
from udales_tpu_torch.sim import Simulation  # noqa: E402
from udales_tpu_torch.state import Fields  # noqa: E402


def start(job, out):
    """Start the job's ranks as processes of this script (torchrun's
    environment when job["address"] is None); `finish` collects them."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    job = {**job, "out": str(out)}
    path = out / "job.pkl"
    path.write_bytes(pickle.dumps(job))
    port = free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    base["OMP_NUM_THREADS"] = "1"
    procs = []
    for r in range(job["world"]):
        env = dict(base)
        if job["address"] is None and not job.get("bare"):
            env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       RANK=str(r), WORLD_SIZE=str(job["world"]))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(path), str(r)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return out, procs


def finish(started, timeout=120):
    """The ranks' results, rank by rank.  A rank that fails or outlives
    `timeout` seconds fails the caller with the output of every rank."""
    out, procs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} failed:\n" + "\n".join(
            f"--- rank {r}:\n{log[-3000:]}" for r, log in enumerate(logs)))
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes())
            for r in range(len(procs))]


def launch(job, out, timeout=120):
    """`start` then `finish`."""
    return finish(start(job, out), timeout)


def build(case, device, mesh):
    if "case_dir" in case:
        return load_case(case["case_dir"], case["expnr"], case["dtype"],
                         device=device, mesh=mesh)
    cfg = case["cfg"]
    d = cfg.domain
    grid = Grid(d.itot, d.jtot, d.ktot, d.xlen, d.ylen, case["zf"],
                dtype=np.dtype(cfg.dtype))
    model = Model(cfg, grid, device=device, mesh=mesh)
    model.dpdxl = torch.as_tensor(case["dpdxl"], dtype=grid.torch_dtype,
                                  device=model.device)
    return model


def halo_errors(mesh, device):
    """max|mesh.wrap_xy(block) - pad_wrap(pad_wrap(whole))[block]| for h =
    1, 2 over a cell field, a face field and a stacked field."""
    gen = torch.Generator().manual_seed(5)
    errs = {1: 0.0, 2: 0.0}
    for shape in ((16, 12, 8), (16, 12, 9), (2, 16, 12, 8)):
        whole = torch.rand(shape, generator=gen, dtype=torch.float64)
        whole = whole.to(device)
        bx, by = shape[-3] // mesh.px, shape[-2] // mesh.py
        i0, j0 = mesh.cx * bx, mesh.cy * by
        block = whole[..., i0:i0 + bx, j0:j0 + by, :].contiguous()
        for h in (1, 2):
            got = mesh.wrap_xy(block, h)
            want = pad_wrap(pad_wrap(whole, -3, h), -2, h)[
                ..., i0:i0 + bx + 2 * h, j0:j0 + by + 2 * h, :]
            errs[h] = max(errs[h], float((got - want).abs().max()))
    return errs


def identity_error(case, mesh, device):
    """max|gather_state(shard_state(st)) - st| over every leaf, and the
    blocks of shard_state against the slices of state_shardings."""
    st = state_from_numpy(case["state"], device=device)
    blocks = shard_state(st, mesh)
    back = state_to_numpy(gather_state(blocks, mesh))
    cut = state_shardings(st, mesh)
    ref = case["state"]
    errs = [float(np.abs(back[p][k] - ref[p][k]).max()) if ref[p][k].size
            else 0.0 for p in ("m", "c") for k in ref[p]]
    errs += [float(np.abs(back[k] - ref[k]).max())
             for k in ("pres", "dt", "timee")]
    for k in ("u", "w", "sv"):
        want = getattr(st.c, k)[getattr(cut.c, k)]
        errs.append(0.0 if torch.equal(getattr(blocks.c, k), want) else 1.0)
    return max(errs)


def reduction_errors(mesh, device):
    """max|split slab mean - whole slab mean| of ``avexy_masked`` (with and
    without a fluid mask) and ``slab_mean`` on a seeded field."""
    gen = torch.Generator().manual_seed(6)
    whole = torch.rand((16, 12, 8), generator=gen, dtype=torch.float64)
    mask = (torch.rand((16, 12, 8), generator=gen) > 0.3).double()
    bx, by = 16 // mesh.px, 12 // mesh.py
    cut = lambda a: a[mesh.cx * bx:(mesh.cx + 1) * bx,
                      mesh.cy * by:(mesh.cy + 1) * by].to(device)
    pairs = [(avexy_masked(cut(whole), mesh=mesh), avexy_masked(whole)),
             (avexy_masked(cut(whole), cut(mask), mesh=mesh),
              avexy_masked(whole, mask)),
             (slab_mean(cut(whole), mesh=mesh), slab_mean(whole))]
    return max(float((a.cpu() - b).abs().max()) for a, b in pairs)


def section_report(job, mesh, device):
    """The block IBM's sections of one case and their interpolated values
    (see the module docstring)."""
    model = load_case(job["case_dir"], job["expnr"], "float64", device=device,
                      mesh=mesh)
    ibm, grid, cfg = model.ibm, model.grid, model.cfg
    t = lambda a: grid.cut(torch.as_tensor(a, device=device)).contiguous()
    f = {k: t(v) for k, v in job["fields"].items()}
    fields = Fields(u=f["u"], v=f["v"], w=f["w"], thl=f["thl"],
                    qt=torch.zeros_like(f["thl"]),
                    e12=torch.zeros_like(f["thl"]),
                    sv=f["thl"].new_zeros((0, *f["thl"].shape)))
    g = dataclasses.replace(_velocity_ghosts(fields, cfg, grid), thl=ghost_thl(
        fields.thl, torch.ones_like(fields.thl), cfg, grid, mesh=mesh))
    out = {}
    for which, s in ibm.lists.items():
        rows = ibm.rows[which]
        sec = ibm.sec[which]
        rec = sec.rec[sec.active][rows]
        r = dict(rows=rows, n_rec=int(rec.sum()), n_cross=0, values=None)
        if s is not None:
            r["values"] = [v.cpu().numpy() for v in ibm._interp(s, g)]
            cross = np.zeros(len(rows), bool)
            for name in ("u", "v", "w", "t"):
                G = getattr(g, "thl" if name == "t" else name)
                i, j, _ = np.unravel_index(
                    getattr(s, f"idx_{name}").cpu().numpy(), G.shape)
                ring = ((i == 0) | (i == G.shape[0] - 1) | (j == 0)
                        | (j == G.shape[1] - 1))
                cross |= (ring & (getattr(s, f"wgt_{name}").cpu().numpy()
                                  != 0)).any(axis=1)
            r["n_cross"] = int(cross.sum())
        out[which] = r
    return out


@contextmanager
def recording_writers():
    """Within the block every ``NCWriter.append`` also keeps the arrays it
    is handed in float64 (before the file's float32 cast), in the dict
    {file name: [(time, {variable: array})]} the block receives."""
    from udales_tpu_torch.io import netcdf
    records, append = {}, netcdf.NCWriter.append

    def recording(self, time, data):
        records.setdefault(Path(self.path).name, []).append(
            (time, {k: np.array(v, np.float64) for k, v in data.items()}))
        return append(self, time, data)
    netcdf.NCWriter.append = recording
    try:
        yield records
    finally:
        netcdf.NCWriter.append = append


def compiled_run(case, device, mesh, st, eager):
    """The case's steps from the block State `st` as replays of the
    compiled step of a second Model of the case (whose driver stream
    starts anew): the gathered State, the launches, collectives and bytes,
    the compiled step's kind, builds and replays; with case["rebuild"]
    also the gathered States of "steps" more steps from the `eager` run's
    final State without its facet state, compiled (a build on every rank)
    and eagerly."""
    model = build(case, device, mesh)
    fused_diff_mom.launch_count = 0
    fused_diff_mom.masked_launch_count = 0
    mesh.reset_counts()
    out = model.run(st, case["steps"], graph=True)
    step = model.step_jit()
    res = dict(launches=fused_diff_mom.launch_count,
               masked=fused_diff_mom.masked_launch_count,
               collectives=mesh.collectives, bytes=mesh.bytes,
               kind=step.kind, builds=step.builds, replays=step.replays,
               gathered=state_to_numpy(gather_state(out, mesh)))
    if case.get("rebuild"):
        bare = eager.replace(fac=None)
        res["rebuilt"] = state_to_numpy(gather_state(
            model.run(bare, case["steps"], graph=True), mesh))
        res["rebuilds"] = step.builds
        res["bare_eager"] = state_to_numpy(gather_state(
            model.run(bare, case["steps"]), mesh))
    return res


def run_simulation(case, model, st, mesh):
    """`Simulation.run` of the split Model from the block State `st` for
    case["runtime"] s into case["sim"]; the restart files of "restart"."""
    with recording_writers() as records:
        sim = Simulation(model, case["sim"])
        whole = gather_state(sim.run(st, runtime=case["runtime"]), mesh)
    out = dict(gathered=state_to_numpy(whole), gathers=sim.gathers,
               gather_seconds=sim.gather_seconds, ntrun=sim.ntrun,
               records=records, step_kind=sim.step_kind)
    if case.get("restart"):
        if mesh.rank == 0:
            Path(case["restart"]).mkdir(parents=True, exist_ok=True)
            write_state_fortran(case["restart"], whole, case["expnr"],
                                model.cfg, ntrun=sim.ntrun)
        dist.barrier()
        st = warmstart_state(
            case["restart"], f"initd{sim.ntrun:08d}_xxx_xxx.{case['expnr']}",
            case["expnr"], model.cfg, model.grid, device=model.device,
            model=model)
        out["continued"] = state_to_numpy(gather_state(
            model.run(st, case["continue"]), mesh))
    return out


def main(job_path, rank):
    job = pickle.loads(Path(job_path).read_bytes())
    device = torch.device(job["device"])
    torch.set_num_threads(1)
    addr = job["address"]
    init_distributed(addr, job["world"] if addr else None,
                     rank if addr else None, backend=job["backend"],
                     device=device, timeout=job.get("timeout", 60.0))
    rank = dist.get_rank()
    res = {}
    if job.get("dryrun"):
        mesh, out, iout, dout = entry.dryrun_multichip(
            job["world"], device=device, host_staged=job["host_staged"])
        res["dryrun"] = state_to_numpy(out)
        res["dryrun_ibm"] = state_to_numpy(iout)
        res["dryrun_driven"] = state_to_numpy(dout)
    else:
        mesh = (make_mesh(*job["mesh"], host_staged=job["host_staged"])
                if job["mesh"] else global_mesh(host_staged=job["host_staged"]))
        res["cases"] = {}
        for case in job["cases"]:
            model = build(case, device, mesh)
            if "warm" in case:
                st = warmstart_state(*case["warm"], case["expnr"], model.cfg,
                                     model.grid, model=model)
            else:
                st = shard_state_global(state_from_numpy(case["state"]),
                                        mesh, device=device)
            fused_diff_mom.launch_count = 0
            fused_diff_mom.masked_launch_count = 0
            mesh.reset_counts()
            if "sim" in case:
                res["cases"][case["name"]] = run_simulation(case, model, st,
                                                            mesh)
                continue
            out = model.run(st, case["steps"])
            res["cases"][case["name"]] = r = dict(
                block=state_to_numpy(out), launches=fused_diff_mom.launch_count,
                masked=fused_diff_mom.masked_launch_count,
                collectives=mesh.collectives, bytes=mesh.bytes,
                gathered=state_to_numpy(gather_state(out, mesh)))
            if case.get("graph"):
                r["graph"] = compiled_run(case, device, mesh, st, out)
        res["sections"] = {s["name"]: section_report(s, mesh, device)
                           for s in job.get("sections", [])}
        if job.get("checks"):
            res["halo"] = halo_errors(mesh, device)
            res["identity"] = identity_error(job["cases"][0], mesh, device)
            res["reductions"] = reduction_errors(mesh, device)
    res["mesh"] = (mesh.px, mesh.py, mesh.cx, mesh.cy)
    Path(job["out"], f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    dist.destroy_process_group()
    print(f"SPLIT_WORKER_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
