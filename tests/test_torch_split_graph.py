"""The compiled step of a Model split over a mesh (``graph.CompiledStep`` on
``parallel.mesh``: ``Model.step_jit``, ``Model.run(..., graph=True)`` and
``sim.Simulation`` on a split Model) against the eager split run and
against udales_tpu's ``Model.run`` (``lax.scan``) on its 2 x 2 mesh (CPU,
float64, gloo).

One spawn of 2 x 2 ranks of tests/torch_split_worker.py (which imports only
torch and the port) runs, each loaded by ``run.load_case(..., mesh=)`` from
udales_tpu's cold start, NSTEPS steps eagerly and as replays of the compiled
step (on the CPU its body runs eagerly) on a second Model of the case:

  - "flat": a flat 16^3 case with an adaptive dt; "urban":
    ``cases.stage_urban(16)``; "driven": ``cases.stage_urban_driven(16)``
    with records 0.05 s apart read 4 at a time (the window refilled
    between replays); "recycle": the flat case with the rescale-recycle
    generator, its recycle plane on the last x rank; "eb": the single-cube
    case with the facet energy balance, then NSTEPS more steps from a
    State without its facet state, which builds the compiled step again on
    every rank;
  - "sim": ``Simulation.run`` of the driven case with field dumps,
    xytdump, tkedump and the monitor, on the compiled step.

The compiled run equals the eager one bit for bit in every gathered leaf,
with the same collectives and bytes a step; flat and urban agree with
udales_tpu's ``lax.scan`` on the conftest's 2 x 2 virtual mesh to 1e-8
(tests/test_torch_split.py's bound for several steps); every array the
split Simulation hands a writer is within 1e-9 of the single process's.

The cases marked ``cuda`` hold the captured run of a 1 x 1 NCCL mesh
against its eager run, and the refusal of a host-staged mesh on the card;
they skip without one, and import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_split_graph.py
"""
import gc

import numpy as np
import pytest
import torch

from udales_tpu_torch import cases, entry
from udales_tpu_torch.convert import state_from_numpy, state_to_numpy

from test_torch_graph import flat_start, leaves
from torch_split_worker import finish, free_port, start

NSTEPS = 4
JAX_TOL = 1e-8       # tests/test_torch_split.py, several steps on 2 x 2
SIM_TOL = 1e-9       # tests/test_torch_split_driven.py's Simulation bound
FLAT = "&RUN\nladaptive = .true.\ndtmax = 0.1\n/\n"
CASES = ("flat", "urban", "driven", "recycle", "eb")


def close(got, ref, tol, what):
    """max|got - ref| <= tol * max(1, max|ref|) in every leaf of `ref`."""
    got, ref = leaves(got), leaves(ref)
    assert got.keys() == ref.keys(), what
    for k, b in ref.items():
        err = float(np.abs(got[k] - b).max(initial=0.0))
        assert err <= tol * max(1.0, float(np.abs(b).max(initial=0.0))), \
            f"{what}: {k} err {err:.3e}"


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Stage the cases, start the 2 x 2 ranks, and compute udales_tpu's
    sharded runs and the single-process Simulation while they run."""
    pytest.importorskip("jax")
    from udales_tpu.parallel.mesh import make_mesh as jmake_mesh
    from udales_tpu.parallel.mesh import shard_state as jshard_state
    from udales_tpu.run import load_case as jload_case
    from udales_tpu_torch.run import load_case
    from udales_tpu_torch.sim import Simulation
    from test_sharding_hard import _stage_cube_case
    from test_torch_openbc import jtree
    from test_torch_split_driven import SIM_OUT, SIM_TIME
    from test_torch_split_open import GEN, flat_case
    from test_torch_split_urban import EB
    from torch_split_worker import recording_writers
    root = tmp_path_factory.mktemp("split_graph")
    (root / "eb").mkdir()
    specs = {
        "flat": (flat_case(root, "flat", FLAT), "007"),
        "urban": (cases.stage_urban(16, root), "900"),
        "driven": (cases.stage_urban_driven(16, root, nt=40, chunk=4,
                                            dtdriver=0.05), "900"),
        "recycle": (flat_case(root, "recycle", GEN.format(12)), "007"),
        "eb": (_stage_cube_case(root / "eb", extra=EB), "901"),
    }
    sim_case = cases.with_namelist(specs["driven"][0], root / "sim",
                                   OUTPUT=SIM_OUT)
    jstarts = {n: jload_case(d, x, dtype="float64").cold_start(seed=1)
               for n, (d, x) in specs.items()}
    starts = {n: jtree(s.replace(ibmp=None)) for n, s in jstarts.items()}
    jobs = [dict(name=n, case_dir=str(d), expnr=x, dtype="float64",
                 state=starts[n], steps=NSTEPS, graph=True,
                 rebuild=n == "eb") for n, (d, x) in specs.items()]
    jobs.append(dict(name="sim", case_dir=str(sim_case), expnr="900",
                     dtype="float64", state=starts["driven"],
                     sim=str(root / "sim_split"), runtime=SIM_TIME))
    ranks = start(dict(world=4, address=f"localhost:{free_port()}",
                       backend="gloo", device="cpu", host_staged=False,
                       timeout=60.0, mesh=(2, 2), cases=jobs),
                  root / "m2x2")
    scans = {}
    for name in ("flat", "urban"):
        d, x = specs[name]
        model = jload_case(d, x, dtype="float64")
        mesh = jmake_mesh(2, 2)
        model.mesh = mesh
        model.pois.mesh = mesh
        out = model.run(jshard_state(jstarts[name], mesh), NSTEPS)
        scans[name] = jtree(out.replace(ibmp=None))
    model = load_case(sim_case, "900", "float64", device="cpu")
    with recording_writers() as records:
        sim = Simulation(model, root / "sim_one")
        final = sim.run(state_from_numpy(starts["driven"]),
                        runtime=SIM_TIME)
    single = dict(final=state_to_numpy(final), records=dict(records),
                  ntrun=sim.ntrun, step_kind=sim.step_kind)
    return dict(runs=finish(ranks, timeout=240), jax=scans, sim=single)


@pytest.mark.parametrize("name", CASES)
def test_compiled_split_run_equals_eager_split_run(split, name):
    """On every rank: NSTEPS replays of the compiled step (one build, the
    eager body on the CPU) give the eager split run's gathered State bit
    for bit, with the same collectives, bytes and kernel launches."""
    for rank, res in enumerate(split["runs"]):
        eager = res["cases"][name]
        comp = eager["graph"]
        assert (comp["kind"], comp["builds"], comp["replays"]) == (
            "eager body", 1, NSTEPS - 1)
        assert comp["collectives"] == eager["collectives"] > 0, rank
        assert comp["bytes"] == eager["bytes"] > 0, rank
        assert (comp["launches"], comp["masked"]) == (eager["launches"],
                                                      eager["masked"])
        got, want = leaves(comp["gathered"]), leaves(eager["gathered"])
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert np.array_equal(got[k], v), (name, rank, k)
    # what each path carries through the compiled step's static State
    part = {"driven": "drv.u", "recycle": "ig.Utav", "eb": "fac.T",
            "urban": "c.thl", "flat": "pres"}[name]
    got = leaves(split["runs"][0]["cases"][name]["graph"]["gathered"])
    assert part in got
    if name == "driven":
        assert float(got["drv.t"][0]) > 0.0      # refilled between replays


def test_state_of_another_structure_builds_again_on_every_rank(split):
    """The eb case's State without its facet state (as the Fortran restart
    files give it) is a State of another structure on every rank, since
    every rank holds the same leaves: each rank builds the compiled step a
    second time at the same call, and the replays equal the eager steps
    from that State bit for bit."""
    for rank, res in enumerate(split["runs"]):
        comp = res["cases"]["eb"]["graph"]
        assert comp["rebuilds"] == 2, rank
        got, want = leaves(comp["rebuilt"]), leaves(comp["bare_eager"])
        assert "fac.T" not in got and got.keys() == want.keys()
        for k, v in want.items():
            assert np.array_equal(got[k], v), (rank, k)
    ref = leaves(split["runs"][0]["cases"]["eb"]["gathered"])
    assert float(ref["fac.tEB_last"]) > 0         # the balance fired


@pytest.mark.parametrize("name", ["flat", "urban"])
def test_compiled_split_run_matches_jax_scan_on_2x2(split, name):
    """The compiled split run of the flat and the urban case against
    udales_tpu's ``Model.run`` (its ``lax.scan``) on a 2 x 2 mesh of the
    conftest's virtual devices, every leaf to 1e-8."""
    for rank, res in enumerate(split["runs"]):
        close(res["cases"][name]["graph"]["gathered"], split["jax"][name],
              JAX_TOL, f"{name} rank {rank} vs jax lax.scan on 2 x 2")


def test_split_simulation_steps_compiled_and_matches_one_process(split):
    """Simulation of the driven case on 2 x 2 steps with ``step_jit()``
    (``compiled (eager body)`` on the CPU), as the single process does;
    every array it hands a writer is within 1e-9 of the single process's
    (second moments relative to the product of the means they are formed
    from, as tests/test_torch_split_driven.py holds them), after the same
    steps, and the final State too."""
    from test_torch_split_driven import record_scale
    one = split["sim"]
    assert one["step_kind"] == "compiled (eager body)"
    for rank, res in enumerate(split["runs"]):
        sim = res["cases"]["sim"]
        assert sim["step_kind"] == "compiled (eager body)", rank
        assert sim["ntrun"] == one["ntrun"] >= 3
        close(sim["gathered"], one["final"], SIM_TOL, f"sim rank {rank}")
    got = split["runs"][0]["cases"]["sim"]["records"]
    assert sorted(got) == sorted(one["records"]) and got
    for name, recs in one["records"].items():
        assert len(got[name]) == len(recs) >= 1, name
        for (tg, dg), (tr, dr) in zip(got[name], recs):
            assert tg == pytest.approx(tr, rel=1e-12), name
            for k, r in dr.items():
                err = np.abs(dg[k] - r).max(initial=0.0)
                assert err <= SIM_TOL * record_scale(k, dr), (name, k, err)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def one_rank_group(backend, tmp_path):
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    return dist


@pytest.mark.cuda
def test_captured_nccl_1x1_run_matches_eager(cuda, tmp_path):
    """5 replays of the captured step of flat 32^3 float64 on a 1 x 1 NCCL
    mesh against 5 eager steps on the same mesh: every leaf within 1e-12
    of its largest value, the same collectives and bytes, 15 kernel
    launches counted across the replays."""
    from udales_tpu_torch.ops.fused_diff import fused_diff_mom
    from udales_tpu_torch.parallel.mesh import make_mesh
    from udales_tpu_torch.parallel.multihost import shard_state_global
    dist = one_rank_group("nccl", tmp_path)
    try:
        mesh = make_mesh(1, 1)
        got, counts = {}, {}
        for graph in (False, True):
            model = entry._build(32, 32, 32, "float64", mesh=mesh)
            st = shard_state_global(flat_start(model), mesh, device=cuda)
            fused_diff_mom.launch_count = 0
            mesh.reset_counts()
            got[graph] = state_to_numpy(model.run(st, 5, graph=graph))
            counts[graph] = (mesh.collectives, mesh.bytes,
                             fused_diff_mom.launch_count)
        step = model.step_jit()
        assert step.kind == "cuda graph" and step.graph is not None
        assert step.collectives_per_replay[0] > 0
        assert counts[True] == counts[False] and counts[True][2] == 15
        close(got[True], got[False], 1e-12, "captured vs eager, 1 x 1 NCCL")
    finally:
        # the graph holds NCCL's communicators: free it (the Model and its
        # compiled step refer to each other) before the group goes
        model = step = None
        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()


@pytest.mark.cuda
def test_host_staged_mesh_refuses_on_card(cuda, tmp_path):
    """A 1 x 1 gloo mesh that stages through the host, on the card:
    ``step_jit()`` raises NotImplementedError naming the host staging,
    and ``Model.run(..., graph=True)`` does not fall back to the eager
    step."""
    from udales_tpu_torch.parallel.mesh import make_mesh
    dist = one_rank_group("gloo", tmp_path)
    try:
        model = entry._build(8, 8, 8, "float64",
                             mesh=make_mesh(1, 1, host_staged=True))
        with pytest.raises(NotImplementedError, match="host-staged"):
            model.step_jit()
        with pytest.raises(NotImplementedError, match="host-staged"):
            model.run(entry._init_state(model), 1, graph=True)
    finally:
        dist.destroy_process_group()
