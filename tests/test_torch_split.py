"""The x/y process split of the port's flat step (``parallel/mesh.py``,
``parallel/multihost.py``) against the port on one process and against
udales_tpu's mesh-sharded step (CPU, float64, gloo).

Mirrors tests/test_sharding.py, the reference's processor-boundary oracle
(1x1 == 2x1 == 1x2 == 2x2 to 1e-9): on tests/test_core.make_cfg's 16 x 12 x 8
case one step on meshes (2,1), (1,2), (2,2) and (4,2) agrees with the port's
single-process step and with udales_tpu's ``make_mesh`` + ``shard_state``
step on the conftest's 8 virtual devices to 1e-9, and 5 steps on (2,2) to
1e-8.  On (2,2) also: a stretched z grid (the Thomas route of the Poisson
solve), an adaptive moist case with a pressure top and a fixed volume
flow (the MAX all-reduce of dt, the slab means of ``masscorr`` and of the
top pressure gradient), a moist case with the Newton-Raphson saturation
(``lqlnr``: a MAX all-reduce an iteration) from a start with saturated
cells, the flat case with shifted periodic BCs (``ds > 0``: the domain's
outlet half, the y neighbour from the mesh) and a warm bubble advected by
the kappa scheme (``iadv_thl``: a halo of 2), each against the
port and udales_tpu on one device.  The ranks are processes of
tests/torch_split_worker.py, which imports only torch and the port; JAX
runs in this process.  The urban paths under the split are in
tests/test_torch_split_urban.py, the open boundaries in
tests/test_torch_split_open.py.
"""
import dataclasses
from types import SimpleNamespace

import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

import jax
import numpy as np
import torch

import udales_tpu.config as jconfig
from udales_tpu.grid import Grid as JGrid
from udales_tpu.parallel.mesh import _leaf_spec as jleaf_spec
from udales_tpu.parallel.mesh import make_mesh as jmake_mesh
from udales_tpu.parallel.mesh import shard_state as jshard_state
from udales_tpu.run import Model as JModel

import udales_tpu_torch.config as tconfig
from udales_tpu_torch.convert import (FIELD_NAMES, state_from_numpy,
                                      state_to_numpy)
from udales_tpu_torch.grid import Grid as TGrid
from udales_tpu_torch.parallel.mesh import _leaf_spec, map_state
from udales_tpu_torch.run import Model as TModel

from test_core import init_state
from test_torch_eb import stage_cube_case, synthetic_pair
from test_torch_openbc import jtree
from torch_split_worker import finish, free_port, start

MESHES = [(2, 1), (1, 2), (2, 2), (4, 2)]
ZF_STRETCHED = np.cumsum(1.1 ** np.arange(8)) - 0.5 * 1.1 ** np.arange(8)


def make_cfg(cm, name):
    """tests/test_core.make_cfg in the config module `cm` (udales_tpu's or
    the port's copy), for case `name`."""
    dom = cm.DomainConfig(itot=16, jtot=12, ktot=8, xlen=16.0, ylen=12.0)
    cfg = cm.Config(domain=dom, dtype="float64",
                    run=cm.RunConfig(ladaptive=False, dtmax=0.02,
                                     lrandomize=False),
                    walls=cm.WallsConfig(lbottom=True),
                    bc=cm.BCConfig(z0=0.01, z0h=0.001, thls=288.0))
    if name == "physics":
        cfg = dataclasses.replace(
            cfg, run=cm.RunConfig(ladaptive=True, dtmax=2.0,
                                  lrandomize=False),
            bc=dataclasses.replace(cfg.bc, BCtopm=cm.BCTOPM_PRESSURE),
            physics=cm.PhysicsConfig(ltempeq=True, lbuoyancy=True,
                                     lmoist=True, luvolflowr=True,
                                     uflowrate=1.0))
    if name == "lqlnr":
        # the moist case of tests/test_torch_moist.py on this grid
        cfg = dataclasses.replace(
            cfg, physics=cm.PhysicsConfig(ltempeq=True, lmoist=True,
                                          lbuoyancy=True),
            dynamics=dataclasses.replace(cfg.dynamics, lqlnr=True),
            bc=dataclasses.replace(cfg.bc, thls=290.0, qts=0.012,
                                   wqsurf=2e-5))
    if name == "ds":
        cfg = dataclasses.replace(cfg, physics=dataclasses.replace(
            cfg.physics, ds=1.0))
    if name == "kappa":
        cfg = dataclasses.replace(
            cfg, physics=cm.PhysicsConfig(ltempeq=True, lbuoyancy=True),
            dynamics=dataclasses.replace(cfg.dynamics,
                                         iadv_thl=cm.IADV_KAPPA))
    return cfg


def zf_of(name):
    return ZF_STRETCHED if name == "stretched" else np.arange(8) + 0.5


def jax_model(name):
    cfg = make_cfg(jconfig, name)
    return JModel(cfg, JGrid(16, 12, 8, 16.0, 12.0, zf_of(name),
                             dtype=np.float64))


def to_numpy(st):
    fields = lambda f: {k: np.asarray(getattr(f, k)) for k in FIELD_NAMES}
    return {"m": fields(st.m), "c": fields(st.c), "pres": np.asarray(st.pres),
            "dt": np.asarray(st.dt), "timee": np.asarray(st.timee)}


def port_single(case):
    cfg = make_cfg(tconfig, case["base"])
    grid = TGrid(16, 12, 8, 16.0, 12.0, zf_of(case["base"]),
                 dtype=np.float64)
    model = TModel(cfg, grid, device="cpu")
    return state_to_numpy(model.run(state_from_numpy(case["start"]),
                                    case["steps"]))


def job_case(name, case):
    return dict(name=name, cfg=make_cfg(tconfig, case["base"]),
                zf=zf_of(case["base"]), dpdxl=np.zeros(8),
                state=case["start"], steps=case["steps"])


def jax_run(case, mesh_shape=None):
    """udales_tpu's run of the case, on one device or sharded over a
    (px, py) mesh of the conftest's virtual devices."""
    jm = jax_model(case["base"])
    st = case["jstate"]
    if mesh_shape is not None:
        mesh = jmake_mesh(*mesh_shape)
        jm.mesh = mesh
        jm.pois.mesh = mesh
        st = jshard_state(st, mesh)
    step = jax.jit(jm.step)      # compiled once, called steps times
    for _ in range(case["steps"]):
        st = step(st)
    return to_numpy(st)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The split runs and their references.  The ranks of every mesh (the
    one-step flat case on each, and on (2,2) also 5 flat steps, the
    stretched and the physics case) and of the dry run start first; the
    references are computed while they run.  Returns dict(cases, runs =
    {mesh: [rank results]}, dryrun, jax = {(case, mesh or None): State})."""
    cases = {}
    for name, steps in (("flat", 1), ("flat5", 5), ("stretched", 1),
                        ("physics", 2), ("lqlnr", 2), ("ds", 2),
                        ("kappa", 2)):
        base = "flat" if name == "flat5" else name
        st = init_state(jax_model(base))
        if name == "kappa":
            # a warm bubble, so that the limiter of the kappa scheme acts
            k = np.arange(8)[None, None, :]
            thl = 288.0 + 2.0 * np.exp(-((k - 2) / 1.5) ** 2) \
                * np.random.default_rng(9).uniform(0, 1, st.c.thl.shape)
            f = dataclasses.replace(st.c, thl=jax.numpy.asarray(thl))
            st = st.replace(c=f, m=f)
        if name == "lqlnr":
            # a saturated layer aloft: the iteration runs where ql > 0
            k = np.arange(8)[None, None, :]
            qt = (0.010 + 0.006 * np.exp(-((k - 5) / 2.0) ** 2)
                  + 5e-4 * np.random.default_rng(8).standard_normal(
                      st.c.qt.shape))
            f = dataclasses.replace(st.c, qt=jax.numpy.asarray(qt))
            st = st.replace(c=f, m=f)
        cases[name] = dict(base=base, steps=steps, jstate=st,
                           start=to_numpy(st))
    started = {}
    for mesh in MESHES:
        names = (["flat", "flat5", "stretched", "physics", "lqlnr", "ds",
                  "kappa"] if mesh == (2, 2) else ["flat"])
        job = dict(world=mesh[0] * mesh[1], address=f"localhost:{free_port()}",
                   backend="gloo", device="cpu", host_staged=False,
                   timeout=60.0, mesh=mesh, checks=True,
                   cases=[job_case(n, cases[n]) for n in names])
        started[mesh] = start(job, tmp_path_factory.mktemp(
            f"split{mesh[0]}x{mesh[1]}"))
    dry = start(dict(world=4, address=None, backend="gloo", device="cpu",
                     host_staged=False, timeout=60.0, dryrun=True),
                tmp_path_factory.mktemp("dryrun"))
    refs = {(n, None): jax_run(cases[n]) for n in ("flat", "stretched",
                                                  "physics", "lqlnr", "ds",
                                                  "kappa")}
    refs.update({("flat", m): jax_run(cases["flat"], m) for m in MESHES})
    refs[("flat5", (2, 2))] = jax_run(cases["flat5"], (2, 2))
    return dict(cases=cases, jax=refs, dryrun=finish(dry),
                runs={m: finish(h) for m, h in started.items()})


def assert_states_close(got, ref, tol, what):
    for part in ("m", "c"):
        for k in ("u", "v", "w", "thl", "qt", "e12"):
            a, b = got[part][k], ref[part][k]
            scale = max(1.0, float(np.abs(b).max()))
            err = float(np.abs(a - b).max())
            assert err <= tol * scale, f"{what}: {part}.{k} err {err:.3e}"
    for k in ("pres", "dt", "timee"):
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= tol * max(1.0, float(np.abs(ref[k]).max())), \
            f"{what}: {k} err {err:.3e}"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_one_step_matches_single_process_and_jax_mesh(split, mesh):
    single = port_single(split["cases"]["flat"])
    for rank, res in enumerate(split["runs"][mesh]):
        got = res["cases"]["flat"]["gathered"]
        assert_states_close(got, single, 1e-9, f"{mesh} rank {rank} vs port")
        assert_states_close(got, split["jax"][("flat", mesh)], 1e-9,
                            f"{mesh} rank {rank} vs jax")
    assert_states_close(single, split["jax"][("flat", None)], 1e-9,
                        "port vs jax, one device")


def test_five_steps_on_2x2(split):
    got = split["runs"][(2, 2)][0]["cases"]["flat5"]["gathered"]
    assert_states_close(got, port_single(split["cases"]["flat5"]), 1e-8,
                        "5 steps vs port")
    assert_states_close(got, split["jax"][("flat5", (2, 2))], 1e-8,
                        "5 steps vs jax mesh")


@pytest.mark.parametrize("name", ["stretched", "physics"])
def test_thomas_route_and_reductions_on_2x2(split, name):
    """The stretched grid and the pressure top take the tridiagonal route;
    the physics case steps an adaptive dt and the masscorr/top slab
    means."""
    got = split["runs"][(2, 2)][0]["cases"][name]["gathered"]
    assert_states_close(got, port_single(split["cases"][name]), 1e-9,
                        f"{name} vs port")
    assert_states_close(got, split["jax"][(name, None)], 1e-9,
                        f"{name} vs jax")
    model = TModel(make_cfg(tconfig, name), TGrid(
        16, 12, 8, 16.0, 12.0, zf_of(name), dtype=np.float64), device="cpu")
    assert not model.pois.diag_z
    if name == "physics":
        assert float(got["dt"]) < 2.0   # the adaptive limit acted


@pytest.mark.parametrize("name", ["lqlnr", "ds", "kappa"])
def test_lqlnr_shifted_pbcs_and_kappa_thl_on_2x2(split, name):
    """The Newton-Raphson saturation (its convergence test all-reduced an
    iteration), the shifted periodic BCs (the outlet half of the domain,
    the y neighbour from the mesh) and kappa advection of thl (its halo of
    2 from the mesh) on 2 x 2: the port on one process and udales_tpu on
    one device, to 1e-9."""
    got = split["runs"][(2, 2)][0]["cases"][name]["gathered"]
    assert_states_close(got, port_single(split["cases"][name]), 1e-9,
                        f"{name} vs port")
    assert_states_close(got, split["jax"][(name, None)], 1e-9,
                        f"{name} vs jax")
    if name == "lqlnr":
        jm = jax_model("lqlnr")
        from udales_tpu.ops.thermo import thermodynamics
        th = thermodynamics(split["cases"][name]["jstate"].c, jm.cfg,
                            jm.grid)
        assert float(np.asarray(th.ql0).max()) > 0   # saturated cells


def test_each_rank_holds_its_block(split):
    """Every rank's own blocks are its slices of the gathered State."""
    for mesh, results in split["runs"].items():
        for res in results:
            px, py, cx, cy = res["mesh"]
            assert (px, py) == mesh
            got = res["cases"]["flat"]
            for k in ("u", "w", "thl"):
                whole = got["gathered"]["c"][k]
                bx, by = whole.shape[0] // px, whole.shape[1] // py
                np.testing.assert_array_equal(
                    got["block"]["c"][k],
                    whole[cx * bx:(cx + 1) * bx, cy * by:(cy + 1) * by])


@pytest.mark.parametrize("h", [1, 2])
def test_halo_exchange_equals_pad_wrap(split, h):
    for mesh, results in split["runs"].items():
        for res in results:
            assert res["halo"][h] == 0.0, (mesh, res["mesh"], res["halo"])


def test_shard_then_gather_is_identity(split):
    """gather_state(shard_state(st)) == st, and each block is the slice
    state_shardings names."""
    assert all(res["identity"] == 0.0 for results in split["runs"].values()
               for res in results)


def test_split_slab_means_equal_the_domain_means(split):
    """avexy_masked (with and without a mask) and slab_mean of this rank's
    block under the mesh: the whole domain's, to rounding."""
    for mesh, results in split["runs"].items():
        for res in results:
            assert res["reductions"] <= 1e-15, (mesh, res["reductions"])


def test_dryrun_multichip(split):
    """entry.dryrun_multichip(4) under torchrun's environment: a 2 x 2 mesh,
    32^3 float32, one adaptive step, against the same step on one process;
    then the generated building case (16^3 float32, one step) and the
    driven case (16^3 float32, two steps through the driver window): finite
    u and thl, the same on every rank."""
    from udales_tpu_torch import entry
    res = split["dryrun"]
    model = entry._build(32, 32, 32, device="cpu")
    ref = state_to_numpy(model.step(entry._init_state(model)))
    for r in res:
        assert r["mesh"][:2] == (2, 2)
        got = r["dryrun"]
        assert np.isfinite(got["c"]["u"]).all()
        for k in ("u", "v", "w"):
            err = np.abs(got["c"][k] - ref["c"][k]).max()
            assert err <= 1e-5 * np.abs(ref["c"][k]).max(), (k, err)
        assert abs(float(got["dt"]) - float(ref["dt"])) <= 1e-6
        ibm = r["dryrun_ibm"]
        assert ibm["c"]["u"].shape == (16, 16, 16)
        assert np.isfinite(ibm["c"]["u"]).all()
        assert np.isfinite(ibm["c"]["thl"]).all()
        np.testing.assert_array_equal(ibm["c"]["u"],
                                      res[0]["dryrun_ibm"]["c"]["u"])
        drv = r["dryrun_driven"]
        assert drv["c"]["u"].shape == (16, 16, 16)
        assert drv["c"]["bx"]["u"].shape == (16, 16)
        assert drv["drv"]["u"].shape == (8, 16, 16)
        assert np.isfinite(drv["c"]["u"]).all()
        np.testing.assert_array_equal(drv["c"]["u"],
                                      res[0]["dryrun_driven"]["c"]["u"])


def test_leaf_spec_agrees_with_jax():
    """Every leaf of the flat State, of a State with two passive scalars, a
    facet state and its statistics, the outlet planes of both open
    directions, a driver window and an inlet generator, and the Model's
    profiles, split as in udales_tpu's table."""
    import udales_tpu.state as jstate
    from udales_tpu.ops import openbc as jopen
    from udales_tpu.ops.inletgen import InletGen as JInletGen
    jm = jax_model("flat")
    jst = init_state(jm)
    jeb, _ = synthetic_pair("sparse")
    z = jax.numpy.zeros
    sv = z((2, 16, 12, 8))
    planes = lambda cls, n: cls(u=z((n, 8)), v=z((n, 8)), w=z((n, 9)),
                                thl=z((n, 8)), qt=z((n, 8)), e12=z((n, 8)),
                                sv=z((2, n, 8)))
    open_fields = lambda f: dataclasses.replace(
        f, sv=sv, bx=planes(jopen.XPlanes, 12), by=planes(jopen.YPlanes, 16))
    W = 4
    drv = jopen.DriverWindow(t=z(W), u=z((W, 12, 8)), v=z((W, 12, 8)),
                             w=z((W, 12, 9)), thl=z((W, 12, 8)),
                             qt=z((W, 12, 8)), sv=z((W, 2, 12, 8)))
    ig = JInletGen(Urec=z(8), Wrec=z(9), Trec=z(8), Uinl=z(8), Tinl=z(8),
                   Utav=z((16, 8)), utaui=z(()), ttaui=z(()), displ=z(16),
                   ddispdx=z(()), u0=z((12, 8)), v0=z((12, 8)),
                   w0=z((12, 9)), t0=z((12, 8)))
    jst = jst.replace(
        c=open_fields(jst.c), m=open_fields(jst.m),
        fac=jeb.initial_state(),
        facstats=jstate.zero_facstats(jeb.nfcts, np.float64),
        drv=drv, ig=ig)
    want = {}

    def record(path, leaf):
        names = tuple(str(getattr(p, "name", getattr(p, "key", p)))
                      for p in path)
        want[names] = tuple(jleaf_spec(path, leaf))
    jax.tree_util.tree_map_with_path(record, jst)
    got = {}
    map_state(lambda path, leaf: got.__setitem__(path,
                                                 _leaf_spec(path, leaf)),
              state_from_numpy(jtree(jst)))
    assert {"fac", "facstats", "drv", "ig"} <= {k[0] for k in got}
    assert got[("c", "sv")] == (None, "x", "y", None)
    assert got[("c", "bx", "w")] == ("y", None)
    assert got[("m", "by", "sv")] == (None, "x", None)
    assert got[("drv", "sv")] == (None, None, "y", None)
    assert got[("ig", "Utav")] == ("x", None)
    assert got and got == want
    prof = torch.zeros(8)
    assert _leaf_spec(("dpdxl",), prof) == tuple(jleaf_spec((), prof))


def fake_mesh(px=2, py=2):
    return SimpleNamespace(px=px, py=py, cx=0, cy=0, rank=0, backend="gloo",
                           axis_names=("x", "y"), shape=(px, py),
                           capturable=True)


# the configurations the split refused; every one is lifted (LIFTED): the
# urban and long-tail features, the open boundaries, the inlet generator,
# the driver and the BCzp = 2 and POISS_FFT3D routes of the Poisson solve
REFUSED = {
    "an IBM": dict(run=dict(libm=True), walls=dict(nfcts=4)),
    "lEB": dict(eb=dict(lEB=True)),
    "BCxm": dict(bc=dict(BCxm=2)),
    "BCym": dict(bc=dict(BCym=2)),
    "iinletgen": dict(driver=dict(iinletgen=1)),
    "idriver": dict(driver=dict(idriver=2)),
    "nsv > 0": dict(scalars=dict(nsv=1)),
    "lscasrc": dict(scalars=dict(lscasrc=True)),
    "iadv_thl": dict(dynamics=dict(iadv_thl=7)),
    "ds > 0": dict(physics=dict(ds=1.0)),
    "lqlnr": dict(dynamics=dict(lqlnr=True)),
    "ltrees": dict(trees=dict(ltrees=True)),
    "lchem": dict(chem=dict(lchem=True)),
    "lpurif": dict(purifs=dict(lpurif=True)),
    "lheatpump": dict(heatpump=dict(lheatpump=True)),
    "POISS_FFT3D": dict(dynamics=dict(ipoiss=tconfig.POISS_FFT3D)),
    "BCzp=2": dict(bc=dict(BCzp=2)),
}
LIFTED = ("an IBM", "lEB", "nsv > 0", "lscasrc", "iadv_thl", "ds > 0",
          "lqlnr", "ltrees", "lchem", "lpurif", "lheatpump", "BCxm", "BCym",
          "iinletgen", "idriver", "POISS_FFT3D", "BCzp=2")


@pytest.fixture(scope="module")
def cube(tmp_path_factory):
    """The 16^3 single-cube case, staged by the port's prep."""
    return stage_cube_case(tmp_path_factory.mktemp("cube"))


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_configurations_name_themselves(name, cube):
    """Each configuration the split refused: those still refused raise
    naming themselves under a mesh and build without one; the lifted ones
    build under a mesh (an IBM as ``load_case(..., mesh=)`` builds it: the
    cube case, the IBM of one 8 x 8 block), and `_split_unsupported` names
    none of them."""
    cfg = make_cfg(tconfig, "flat")
    cfg = dataclasses.replace(cfg, **{
        group: dataclasses.replace(getattr(cfg, group), **kw)
        for group, kw in REFUSED[name].items()})
    grid = TGrid.uniform(16, 12, 8, 16.0, 12.0, 8.0, dtype=np.float64)
    if name == "an IBM":
        from udales_tpu_torch.run import load_case
        model = load_case(cube, "901", "float64", device="cpu",
                          mesh=fake_mesh())
        assert model.ibm.grid.shape == (8, 8, 16)
        assert model.ibm.masks.c.shape == (8, 8, 16)
        assert model.ibm.pmask_c.shape == (10, 10, 18)
        with pytest.raises(ValueError, match="one mesh"):
            TModel(model.cfg, model.domain_grid, model.ibm, device="cpu")
        return
    if name in LIFTED:
        from udales_tpu_torch.run import _split_unsupported
        assert _split_unsupported(cfg) == []
        model = TModel(cfg, grid, device="cpu", mesh=fake_mesh())
        assert model.grid.shape == (8, 6, 8)
        return
    with pytest.raises(NotImplementedError, match=name):
        TModel(cfg, grid, device="cpu", mesh=fake_mesh())
    TModel(cfg, grid, device="cpu")


@pytest.mark.parametrize("leaf", ["fac.T", "c.bx.u", "drv.u", "ig.u0",
                                  "c.sv", "facstats.pres"])
def test_refused_state_leaves_name_themselves(leaf):
    """The leaves the split once refused take udales_tpu's specs: the
    facet state and its statistics whole on every rank, the scalar stack
    split along its x and y axes, the outlet planes (ny, nz) along y, the
    driver window (W, ny, nz) along y and the generator's planes (ny, nz)
    along y."""
    from udales_tpu.parallel.mesh import _leaf_spec as jspec
    path = tuple(leaf.split("."))
    shape = {"fac.T": (7, 4), "facstats.pres": (7,), "c.bx.u": (12, 8),
             "drv.u": (4, 12, 8), "ig.u0": (12, 8)}.get(leaf, (2, 16, 12, 8))
    accepted = {"fac.T": (), "facstats.pres": (),
                "c.sv": (None, "x", "y", None), "c.bx.u": ("y", None),
                "drv.u": (None, "y", None), "ig.u0": ("y", None)}
    assert _leaf_spec(path, torch.zeros(shape)) == accepted[leaf]
    jpath = [SimpleNamespace(name=p) for p in path]
    assert tuple(jspec(jpath, np.zeros(shape))) == accepted[leaf]


@pytest.mark.parametrize("mesh,cond", [((3, 1), "itot % px"),
                                       ((1, 5), "jtot % py"),
                                       ((16, 1), "ktot % px"),
                                       ((8, 2), "jtot % px")])
def test_grid_block_names_the_failed_condition(mesh, cond):
    grid = TGrid.uniform(16, 12, 8, 16.0, 12.0, 8.0, dtype=np.float64)
    with pytest.raises(ValueError, match=cond):
        grid.block(fake_mesh(*mesh))


def test_block_grid_and_runmode_1003_print_the_mesh(capsys, tmp_path):
    from udales_tpu_torch.sim import Simulation, execute_runmode_actions
    cfg = make_cfg(tconfig, "flat")
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run,
                                                           runmode=1003))
    grid = TGrid.uniform(16, 12, 8, 16.0, 12.0, 8.0, dtype=np.float64)
    mesh = fake_mesh(2, 2)
    mesh.cx, mesh.cy = 1, 0
    model = TModel(cfg, grid, device="cpu", mesh=mesh)
    g = model.grid
    assert g.shape == (8, 6, 8) and g.global_shape == (16, 12, 8)
    assert (g.i0, g.j0) == (8, 0) and g.xf[0] == grid.xf[8]
    assert model.domain_grid is grid
    assert execute_runmode_actions(model, ".") == 0
    out = capsys.readouterr().out
    assert "mesh {'x': 2, 'y': 2}" in out and "grid 8x6x8" in out
    # a Simulation of the split Model builds: its writers would read the
    # whole domain (rank 0 of the mesh)
    sim = Simulation(model, tmp_path)
    assert sim.root and sim.view.grid is grid and sim.gathers == 0
