"""The x/y process split of the port's urban paths (``parallel/mesh.py``
reached from ``ibm/ibm.py``, ``ibm/eb.py``, the scalar stack and
``physics.py``) against the port on one process and against udales_tpu's
mesh-sharded step (CPU, float64, gloo).

Mirrors tests/test_sharding_hard.py, the reference's processor-boundary
oracle for the hard cases.  Cases, loaded on every rank by
``run.load_case(..., mesh=)``:

  - the 16^3 single-cube case of ``_stage_cube_case`` there, whose
    building spans cells 6-10 and so crosses the block edges of every mesh
    here: 2 steps on (2,1), (1,2), (2,2) and (4,2); u, v, w, thl, e12 and
    pres against the port's single process and against udales_tpu's
    ``make_mesh(2, 2)`` + ``shard_state`` step, to 1e-9;
  - its ``lEB`` variant (sparse view factors, dtEB = 0.2 s, so the balance
    fires; with ``lperiodicEBcorr`` and the ``lwritefac`` statistics, so
    every facet sum and total of the wall functions is reduced), 3 steps
    on (2,2) and (4,2): ``fac.T`` to 1e-9 and ``fac.hfi`` to 1e-8 against
    the single process, as ``TestEBSharding`` holds udales_tpu's, the
    statistics to 1e-8, and ``fac`` the same on every rank;
  - ``cases.stage_urban_dispersion(16, purifiers=True, heatpumps=True)``
    (a purifier box across the block edge at x = 8, whose intake plane at
    x = 6 lies two cells outside the next rank's block) and its
    ``sgs="oneeqn"`` variant: 5 steps on (2,2), every State leaf to 1e-8
    against the single process;
  - the sections of the cube case and of a rough copy of the urban 16^3
    array (z0 = 0.2 m, so that most sections sample the flow at
    reconstruction points; buildings at the domain's edges, so that
    stencils hold periodic ghost indices and reconstruction corners
    wrapped modulo n) on (2,2) and (4,2): every section is held by exactly
    one rank, and its interpolated u, v, w and air temperature, gathered
    from the rank's ghosted blocks, equal the whole domain's exactly.

The ranks of one mesh are one spawn of tests/torch_split_worker.py, which
imports only torch and the port; JAX runs in this process.
"""
import shutil

import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

import dataclasses

import jax
import numpy as np
import torch

from udales_tpu.parallel.mesh import make_mesh as jmake_mesh
from udales_tpu.parallel.mesh import shard_state as jshard_state
from udales_tpu.run import load_case as jload_case

from udales_tpu_torch import cases
from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
from udales_tpu_torch.ops.boundary import ghost_thl
from udales_tpu_torch.run import _velocity_ghosts, load_case
from udales_tpu_torch.state import Fields

from test_sharding_hard import _stage_cube_case
from test_torch_openbc import jtree, leaves
from torch_split_worker import finish, free_port, start

MESHES = [(2, 1), (1, 2), (2, 2), (4, 2)]
EB = """
&ENERGYBALANCE
lEB = .true.
lvfsparse = .true.
dtEB = 0.2
skyLW = 350.
nfaclyrs = 3
lperiodicEBcorr = .true.
/
&WALLS
lwritefac = .true.
/
"""


def rough_copy(case, dest, expnr):
    """`case` with z0 = 0.2 m on its rough facet types."""
    shutil.copytree(case, dest)
    ft = dest / f"factypes.inp.{expnr}"
    lines = ft.read_text().splitlines()
    rows = [r.split() for r in lines[3:] if r.strip()]
    for r in rows:
        if float(r[2]) > 0:
            r[2] = "0.2"
    ft.write_text("\n".join(lines[:3] + [" ".join(r) for r in rows]) + "\n")
    return dest


def section_fields(seed):
    """Whole-domain u, v, w, thl of the 16^3 cases, from a seed."""
    rng = np.random.default_rng(seed)
    return dict(u=1.0 + rng.standard_normal((16, 16, 16)),
                v=rng.standard_normal((16, 16, 16)),
                w=rng.standard_normal((16, 16, 17)),
                thl=290.0 + rng.standard_normal((16, 16, 16)))


def whole_sections(case, expnr, fields):
    """The single-process IBM's interpolated values of every section, and
    the number of reconstruction sections with a corner stored wrapped
    (more than one cell from the boundary point)."""
    model = load_case(case, expnr, "float64", device="cpu")
    f = {k: torch.as_tensor(v) for k, v in fields.items()}
    z = torch.zeros_like(f["thl"])
    fl = Fields(u=f["u"], v=f["v"], w=f["w"], thl=f["thl"], qt=z, e12=z,
                sv=z.new_zeros((0, 16, 16, 16)))
    g = dataclasses.replace(
        _velocity_ghosts(fl, model.cfg, model.grid),
        thl=ghost_thl(fl.thl, torch.ones_like(z), model.cfg, model.grid))
    wrapped = 0
    for sec in model.ibm.sec.values():
        if sec.interp is not None:
            rec = sec.rec & sec.active
            d = sec.interp["c"][0][rec][..., :2] - sec.ijk[rec][:, None, :2]
            wrapped += int((np.abs(d) > 1).any(axis=(1, 2)).sum())
    return {k: [v.numpy() for v in model.ibm._interp(s, g)]
            for k, s in model.ibm.lists.items() if s is not None}, wrapped


def jax_sharded(case, jst, steps):
    """udales_tpu's steps of the case sharded over a 2 x 2 mesh of the
    conftest's virtual devices (tests/test_sharding_hard.py `_run_pair`)."""
    model = jload_case(case, "901", dtype="float64")
    mesh = jmake_mesh(2, 2)
    model.mesh = mesh
    model.pois.mesh = mesh
    st = jshard_state(jst, mesh)
    step = jax.jit(model.step)
    for _ in range(steps):
        st = step(st)
    return jtree(st.replace(ibmp=None))


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Stage the cases, start the ranks of every mesh, and compute the
    references while they run.  Returns dict(runs = {mesh: [rank
    results]}, single = {case: State}, jax = the sharded cube State,
    sections = {case: whole-domain values}, fields)."""
    root = tmp_path_factory.mktemp("urban_split")
    cube = _stage_cube_case(_mkdir(root / "cube"))
    cube_eb = _stage_cube_case(_mkdir(root / "cube_eb"), extra=EB)
    rough = rough_copy(cases.stage_urban(16, root), root / "rough", "900")
    section_cases = (("cube", cube, "901"), ("rough", rough, "900"))
    disp = cases.stage_urban_dispersion(16, root, purifiers=True,
                                        heatpumps=True)
    oneeqn = cases.stage_urban_dispersion(16, root, sgs="oneeqn")
    jcube = jload_case(cube, "901", dtype="float64")
    jst = jcube.cold_start(seed=1)
    jeb = jload_case(cube_eb, "901", dtype="float64")
    specs = {
        "cube": (cube, "901", 2, jtree(jst.replace(ibmp=None))),
        "cube_eb": (cube_eb, "901", 3,
                    jtree(jeb.cold_start(seed=1).replace(ibmp=None))),
    }
    for name, case in (("disp", disp), ("oneeqn", oneeqn)):
        model = load_case(case, "900", "float64", device="cpu")
        specs[name] = (case, "900", 5,
                       state_to_numpy(model.cold_start(seed=43)))
    fields = section_fields(3)
    started = {}
    for mesh in MESHES:
        names = {(2, 2): ["cube", "cube_eb", "disp", "oneeqn"],
                 (4, 2): ["cube", "cube_eb"]}.get(mesh, ["cube"])
        job = dict(world=mesh[0] * mesh[1],
                   address=f"localhost:{free_port()}", backend="gloo",
                   device="cpu", host_staged=False, timeout=60.0, mesh=mesh,
                   cases=[dict(name=n, case_dir=str(specs[n][0]),
                               expnr=specs[n][1], dtype="float64",
                               state=specs[n][3], steps=specs[n][2])
                          for n in names])
        if mesh in ((2, 2), (4, 2)):
            job["sections"] = [dict(name=n, case_dir=str(c), expnr=x,
                                    fields=fields)
                               for n, c, x in section_cases]
        started[mesh] = start(job, root / f"m{mesh[0]}x{mesh[1]}")
    single = {}
    for name, (case, expnr, steps, st) in specs.items():
        model = load_case(case, expnr, "float64", device="cpu")
        single[name] = state_to_numpy(model.run(state_from_numpy(st),
                                                steps))
    return dict(
        single=single, jax=jax_sharded(cube, jst, 2),
        sections={n: whole_sections(c, x, fields)
                  for n, c, x in section_cases},
        runs={m: finish(h, timeout=240) for m, h in started.items()})


def _mkdir(path):
    path.mkdir(parents=True)
    return path


def assert_close(got, ref, names, tol, what):
    """max|got - ref| <= tol * max(1, max|ref|) for each leaf name."""
    got, ref = dict(leaves(got)), dict(leaves(ref))
    for name in names:
        a, b = got[name], ref[name]
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        scale = max(1.0, float(np.abs(b).max(initial=0.0)))
        err = float(np.abs(a - b).max(initial=0.0))
        assert err <= tol * scale, f"{what}: {name} err {err:.3e}"


CUBE_LEAVES = [f"{p}.{k}" for p in ("c", "m")
               for k in ("u", "v", "w", "thl", "e12")] + ["pres"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_cube_matches_single_process_and_jax_mesh(split, mesh):
    """2 steps of the cube case: the gathered State of every rank against
    the port's single process and udales_tpu's 2 x 2 sharded step; the
    masked kernel's path on every rank (3 launches a step on the card; the
    CPU runs its plain version)."""
    for rank, res in enumerate(split["runs"][mesh]):
        got = res["cases"]["cube"]["gathered"]
        assert_close(got, split["single"]["cube"], CUBE_LEAVES + ["dt"],
                     1e-9, f"{mesh} rank {rank} vs port")
        assert_close(got, split["jax"], CUBE_LEAVES, 1e-9,
                     f"{mesh} rank {rank} vs jax mesh")
    assert_close(split["single"]["cube"], split["jax"], CUBE_LEAVES, 1e-9,
                 "port vs jax mesh")


@pytest.mark.parametrize("mesh", [(2, 2), (4, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_cube_eb_facet_state(split, mesh):
    """3 steps of the lEB variant: fac.T to 1e-9 and fac.hfi to 1e-8 of the
    single process, the fields to 1e-9, the lwritefac statistics to 1e-8,
    the balance fired, and every rank holds the same facet state, bit for
    bit."""
    ref = split["single"]["cube_eb"]
    assert float(ref["fac"]["tEB_last"]) > 0
    stats = [f"facstats.{k}" for k in ("tau_x", "tau_y", "tau_z", "pres",
                                       "pres2", "htc", "cth")]
    assert all(np.abs(dict(leaves(ref))[k]).max() > 0 for k in stats)
    results = split["runs"][mesh]
    for rank, res in enumerate(results):
        got = res["cases"]["cube_eb"]["gathered"]
        assert_close(got, ref, CUBE_LEAVES + ["fac.T"], 1e-9,
                     f"{mesh} rank {rank}")
        assert_close(got, ref, ["fac.hfi", "fac.efi", "fac.Tdash"] + stats,
                     1e-8, f"{mesh} rank {rank}")
        block, first = (r["cases"]["cube_eb"]["block"]["fac"]
                        for r in (res, results[0]))
        for k, v in block.items():
            np.testing.assert_array_equal(v, first[k], err_msg=k)


@pytest.mark.parametrize("name", ["disp", "oneeqn"])
def test_dispersion_every_leaf_on_2x2(split, name):
    """5 steps of the dispersion case with purifiers and heat pumps, and of
    its one-equation variant, on 2 x 2: every leaf of the gathered State
    against the single process, to 1e-8."""
    ref = split["single"][name]
    res = split["runs"][(2, 2)]
    names = [k for k, _ in leaves(ref)]
    assert {"c.sv", "m.sv", "c.e12", "pres", "dt"} <= set(names)
    for rank, r in enumerate(res):
        assert_close(r["cases"][name]["gathered"], ref, names, 1e-8,
                     f"{name} rank {rank}")


@pytest.mark.parametrize("mesh", [(2, 2), (4, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_block_sections_partition_and_interpolate_exactly(split, mesh):
    """Every section of the cube case and of the rough urban case is held
    by exactly one rank, and its interpolated u, v, w and air temperature
    from the rank's ghosted blocks equal the whole domain's exactly.  The
    cases hold sections whose stencils reach into a block's ghost ring
    (1,403 on 2 x 2 and 2,378 on 4 x 2, summed over both cases and the
    four grids) and reconstruction sections (3,438, all in the rough case,
    154 of them with a corner stored wrapped modulo n)."""
    ranks = split["runs"][mesh]
    cross = rec = 0
    wrapped = sum(w for _, w in split["sections"].values())
    assert wrapped > 0
    for name, (whole, _) in split["sections"].items():
        for which, values in whole.items():
            n = len(values[0])
            seen = np.zeros(n, int)
            for r in ranks:
                rep = r["sections"][name][which]
                rows = rep["rows"]
                seen[rows] += 1
                cross += rep["n_cross"]
                rec += rep["n_rec"]
                if len(rows):
                    for got, want in zip(rep["values"], values):
                        np.testing.assert_array_equal(got, want[rows])
            assert (seen == 1).all(), (name, which)
    print(f"{mesh}: {cross} sections reach into a ghost ring, {rec} "
          f"reconstruction sections, {wrapped} with wrapped corners")
    assert cross > 0 and rec > 0
