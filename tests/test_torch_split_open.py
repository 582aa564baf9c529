"""The x/y process split of the port's open boundaries (``ops/boundary.py``'s
``split_pad``, the open projection of ``run.py``, ``ops/openbc.py`` and the
DCT routes of ``ops/poisson.py``) against the port on one process and
against udales_tpu on one device and on its 2 x 2 mesh (CPU, float64,
gloo).  The same for the inlet generator is in
tests/test_torch_split_recycle.py, and for the driver window, the ``BCzp =
2`` and ``POISS_FFT3D`` routes, ``sim.Simulation`` and the restart of a
split run in tests/test_torch_split_driven.py; both share this file's
helpers, and each file stays under a minute.

Mirrors tests/test_sharding_hard.py's open cases.  Cases at 16^3, each
loaded on every rank by ``run.load_case(..., mesh=)`` from udales_tpu's
cold start, 2 steps on 2 x 2:

  - "ox": the single-cube case of ``_stage_cube_case`` there behind an
    open-x profile inlet with a convective outlet; also against
    udales_tpu's ``make_mesh(2, 2)`` + ``shard_state`` step
    (``TestOpenBCSharding``);
  - "oy", "oxy": a flat case open in y, and open in x and y (the corners
    of both planes, the DCT x DCT solve).

Every State leaf to 1e-9 of its largest value.  The ranks of one mesh are
one spawn of tests/torch_split_worker.py (imports only torch and the
port); JAX runs in this process while they run.
"""
import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

import jax
import numpy as np

from udales_tpu.parallel.mesh import make_mesh as jmake_mesh
from udales_tpu.parallel.mesh import shard_state as jshard_state
from udales_tpu.run import load_case as jload_case

from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
from udales_tpu_torch.run import load_case

from test_sharding_hard import _stage_cube_case
from test_torch_inletgen import write_flat_case
from test_torch_openbc import jtree, leaves
from torch_split_worker import finish, free_port, start

OPEN_X = "BCxm = 2\nBCxT = 2\nBCxq = 2\nBCxs = 2\n"
OPEN_Y = "BCym = 2\nBCyT = 2\nBCyq = 2\nBCys = 2\n"
GEN = ("&BC\nthls = 288.\nthl_top = 290.\nUinf = 2.\n" + OPEN_X + "/\n"
       "&DRIVER\niinletgen = 1\niplane = {}\n/\n&INLET\ndi = 8.\n/\n")
# the 2 x 2 cases against udales_tpu on one device, and on its 2 x 2 mesh
JAX_ONE = ("ox", "oy", "oxy")
JAX_MESH = ("ox",)


def flat_case(root, name, extra):
    """The 16^3 flat case of tests/test_torch_inletgen.py with `extra`
    namelist groups."""
    return write_flat_case(root / name, "007", 16, 16, 16, extra)


def stage(root):
    """name -> (case directory, experiment, steps)."""
    return {
        "ox": (_stage_cube_case(_mkdir(root / "ox"), bc_extra=OPEN_X), "901",
               2),
        "oy": (flat_case(root, "oy", "&BC\n" + OPEN_Y + "/\n"), "007", 2),
        "oxy": (flat_case(root, "oxy", "&BC\n" + OPEN_X + OPEN_Y + "/\n"),
                "007", 2),
    }


def _mkdir(path):
    path.mkdir(parents=True)
    return path


def jax_run(case, expnr, jst, steps, mesh=False):
    """udales_tpu's steps from `jst`, on one device or on a 2 x 2 mesh of
    the conftest's virtual devices (refilling a streamed window)."""
    model = jload_case(case, expnr, dtype="float64")
    if mesh:
        m = jmake_mesh(2, 2)
        model.mesh = m
        model.pois.mesh = m
        jst = jshard_state(jst, m)
    step = jax.jit(model.step)
    for _ in range(steps):
        if model.driver_stream is not None:
            jst = model.driver_stream.ensure(jst)
        jst = step(jst)
    return jtree(jst.replace(ibmp=None))


def run_split(root, specs, mesh_cases, jax_one, jax_mesh=(), extra=None,
              after=None):
    """Start the ranks of every mesh of `mesh_cases` ({mesh: case names}
    of `specs`, the `stage` dict) from udales_tpu's cold starts, with the
    jobs `extra(start_np)` appended on 2 x 2; compute udales_tpu's runs of
    `jax_one` (one device) and `jax_mesh` (2 x 2), the single process's of
    every case, and `after(start_np)` while they run.  Returns dict(runs =
    {mesh: [rank results]}, single = {case: State}, jax = {case or (case,
    "mesh"): State}, start = {case: State}, after)."""
    starts = {name: jload_case(d, x, dtype="float64").cold_start(seed=1)
              for name, (d, x, _) in specs.items()}
    start_np = {n: jtree(s.replace(ibmp=None)) for n, s in starts.items()}
    started = {}
    for mesh, names in mesh_cases.items():
        jobs = [dict(name=n, case_dir=str(specs[n][0]), expnr=specs[n][1],
                     dtype="float64", state=start_np[n], steps=specs[n][2])
                for n in names]
        if mesh == (2, 2) and extra is not None:
            jobs += extra(start_np)
        job = dict(world=mesh[0] * mesh[1],
                   address=f"localhost:{free_port()}", backend="gloo",
                   device="cpu", host_staged=False, timeout=60.0, mesh=mesh,
                   cases=jobs)
        started[mesh] = start(job, root / f"m{mesh[0]}x{mesh[1]}")
    refs = {}
    for name in jax_one:
        d, x, steps = specs[name]
        refs[name] = jax_run(d, x, starts[name], steps)
    for name in jax_mesh:
        d, x, steps = specs[name]
        refs[(name, "mesh")] = jax_run(d, x, starts[name], steps, mesh=True)
    single = {}
    for name, (d, x, steps) in specs.items():
        model = load_case(d, x, "float64", device="cpu")
        single[name] = state_to_numpy(model.run(
            state_from_numpy(start_np[name]), steps))
    more = after(start_np) if after is not None else None
    return dict(runs={m: finish(h, timeout=240) for m, h in started.items()},
                single=single, jax=refs, start=start_np, after=more)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("open_split")
    return run_split(root, stage(root), {(2, 2): JAX_ONE}, JAX_ONE,
                     JAX_MESH)


def assert_close(got, ref, tol, what, names=None):
    """max|got - ref| <= tol * max(1, max|ref|) for every leaf of `got` (or
    `names`), each present in `ref` with the same shape."""
    got, ref = dict(leaves(got)), dict(leaves(ref))
    for name in names or got:
        a, b = got[name], ref[name]
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        scale = max(1.0, float(np.abs(b).max(initial=0.0)))
        err = float(np.abs(a - b).max(initial=0.0))
        assert err <= tol * scale, f"{what}: {name} err {err:.3e}"


OPEN_LEAVES = {"ox": {"c.bx.u", "m.bx.thl"}, "oy": {"c.by.v", "m.by.w"},
               "oxy": {"c.bx.u", "c.by.v"}, "gen12": {"ig.u0", "ig.Utav",
                                                      "ig.displ", "c.bx.w"},
               "drv": {"c.bx.u", "drv.u", "drv.t"}, "bczp2": {"pres"},
               "fft3d": {"pres"}}


def check_against_references(split, name):
    """Every leaf of the gathered State on every rank of 2 x 2 against the
    port's single process and udales_tpu on one device (and on its 2 x 2
    mesh where it ran), to 1e-9."""
    ref = split["single"][name]
    assert OPEN_LEAVES[name] <= set(dict(leaves(ref)))
    for rank, res in enumerate(split["runs"][(2, 2)]):
        got = res["cases"][name]["gathered"]
        assert_close(got, ref, 1e-9, f"{name} rank {rank} vs port")
        assert_close(got, split["jax"][name], 1e-9,
                     f"{name} rank {rank} vs jax")
        if (name, "mesh") in split["jax"]:
            assert_close(got, split["jax"][(name, "mesh")], 1e-9,
                         f"{name} rank {rank} vs jax mesh")
    assert_close(ref, split["jax"][name], 1e-9, f"{name}: port vs jax")


@pytest.mark.parametrize("name", JAX_ONE)
def test_open_case_on_2x2_matches_single_process_and_jax(split, name):
    """The open-x profile inlet behind the cube, open y and both open on
    2 x 2: the single process, udales_tpu on one device and, for the open-x
    profile, udales_tpu's 2 x 2 mesh, to 1e-9."""
    check_against_references(split, name)


def assert_blocks(ranks, name, parts):
    """Each rank's own leaves of case `name` are its slices of the gathered
    State: `parts` maps a leaf to the axes its leading dimensions split
    ("xy", "x", "y", "wy": y behind a record axis; "": whole)."""
    for res in ranks:
        px, py, cx, cy = res["mesh"]
        whole = dict(leaves(res["cases"][name]["gathered"]))
        block = dict(leaves(res["cases"][name]["block"]))
        for leaf, axes in parts.items():
            w = whole[leaf]
            if axes == "wy":
                n = w.shape[1] // py
                want = w[:, cy * n:(cy + 1) * n]
            elif axes == "xy":
                a, b = w.shape[0] // px, w.shape[1] // py
                want = w[cx * a:(cx + 1) * a, cy * b:(cy + 1) * b]
            elif axes:
                n, c = (w.shape[0] // px, cx) if axes == "x" else \
                    (w.shape[0] // py, cy)
                want = w[c * n:(c + 1) * n]
            else:
                want = w
            np.testing.assert_array_equal(block[leaf], want,
                                          err_msg=f"{name} {leaf}")


def test_open_leaves_are_the_blocks_of_the_gathered_state(split):
    """Each rank's own leaves are its slices of the gathered State: the
    outlet planes of x along y and of y along x, the same on every rank of
    the other axis."""
    ranks = split["runs"][(2, 2)]
    assert_blocks(ranks, "oxy", {"c.bx.u": "y", "m.by.w": "x", "c.u": "xy",
                                 "c.by.thl": "x"})
    assert_blocks(ranks, "ox", {"c.bx.w": "y", "m.bx.thl": "y"})
