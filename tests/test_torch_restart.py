"""Restart files of the port against udales_tpu (CPU, float64).

- A native checkpoint (``initd<ntrun>.<exp>.h5``) written by either
  package's ``Simulation._write_restart`` loads in the other: every State
  leaf, the facet state (``fac`` group) and the statistics accumulators
  (``stats`` group, through ``resume_stats``) exactly.
- The reference's Fortran restart files: the port writes them byte for
  byte as the reference does, and both readers return the same arrays.
- A run continued from a restart (N steps, a checkpoint, ``main`` with
  ``lwarmstart`` for N more) equals the uninterrupted 2N steps in every
  State leaf, and the xytdump write after the restart equals the
  uninterrupted run's.
"""
import dataclasses
import filecmp

import numpy as np
import pytest
import torch

from udales_tpu_torch import cases
from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
from udales_tpu_torch.io import restart as trestart
from udales_tpu_torch.run import load_case
from udales_tpu_torch.sim import Simulation, main

from test_torch_io import assert_files_match

N = 16


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        elif v is not None:
            yield f"{prefix}{k}", np.asarray(v)


def assert_states_equal(got, ref, rtol=0.0, skip=()):
    """Every leaf of two State trees (numpy dicts) of the port's layout:
    max|got - ref| <= rtol x max|ref|, the leaves of `ref` that are not in
    `skip` all present in `got`."""
    got, ref = dict(leaves(got)), dict(leaves(ref))
    for name, r in ref.items():
        if name.split(".")[0] in skip:
            continue
        g = got[name]
        assert g.shape == r.shape, (name, g.shape, r.shape)
        err = float(np.abs(g - r).max(initial=0.0))
        assert err <= rtol * float(np.abs(r).max(initial=0.0)), (name, err)


@pytest.fixture(scope="module")
def eb_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("restart")
    return cases.with_namelist(
        cases.stage_urban_eb(N, root, dtEB=0.5), root / "eb",
        OUTPUT=dict(lxytdump=True, ltdump=True, ltkedump=True,
                    lmintdump=True, lytdump=True),
        WALLS=dict(lwritefac=True))


def _stats_numpy(sim):
    return {fam: dict(Simulation._acc_items(w.acc))
            for fam, w in sim._stats_writers().items()}


@pytest.mark.parametrize("direction", ["port-to-reference",
                                       "reference-to-port"])
def test_checkpoint_loads_in_the_other_package(eb_case, tmp_path, direction):
    """A checkpoint with a live facet state, random accumulators in five
    statistics families and their cadences: written by one package, read
    by the other (load_checkpoint with the model, resume_stats), equal to
    the last bit; lwritefac's accumulators restart at zero."""
    from udales_tpu.io.restart import load_checkpoint as jload_checkpoint
    from udales_tpu.run import load_case as jload_case
    from udales_tpu.sim import Simulation as JSimulation
    from test_torch_openbc import jtree
    import jax.numpy as jnp
    jmodel = jload_case(eb_case, "900", dtype="float64")
    tmodel = load_case(eb_case, "900", dtype="float64", device="cpu")
    rng = np.random.default_rng(3)
    jst = jmodel.cold_start(seed=43)
    jst = jst.replace(
        pres=jnp.asarray(rng.standard_normal(jst.pres.shape)),
        timee=jnp.asarray(12.5), dt=jnp.asarray(0.25),
        fac=dataclasses.replace(
            jst.fac, T=jst.fac.T + rng.uniform(-2, 2, jst.fac.T.shape),
            hfi=jnp.asarray(rng.standard_normal(jst.fac.hfi.shape))))
    tst = state_from_numpy(jtree(jst))
    sims = {"ref": JSimulation(jmodel, tmp_path / "ref"),
            "got": Simulation(tmodel, tmp_path / "got")}
    assert sorted(sims["ref"]._stats_writers()) \
        == sorted(sims["got"]._stats_writers()) and \
        len(sims["got"]._stats_writers()) == 5
    # the same random accumulators and cadences in both
    for fam, tw in sims["got"]._stats_writers().items():
        jw = sims["ref"]._stats_writers()[fam]
        vals = {k: rng.standard_normal(tuple(v.shape))
                for k, v in Simulation._acc_items(tw.acc)}
        if isinstance(tw.acc, dict):
            tw.acc = {k: torch.as_tensor(v) for k, v in vals.items()}
            jw.acc = {k: jnp.asarray(v) for k, v in vals.items()}
        else:
            tw.acc = type(tw.acc)(**{k: torch.as_tensor(v)
                                     for k, v in vals.items()})
            jw.acc = type(jw.acc)(**{k: jnp.asarray(v)
                                     for k, v in vals.items()})
        for w in (tw, jw):
            w.tnext_sample, w.tnext_write = 13.0, 20.0
    want = _stats_numpy(sims["got"])
    sims["ref"]._write_restart(jst)
    sims["got"]._write_restart(tst)
    name = "initd00000000.900.h5"
    src = tmp_path / ("got" if direction == "port-to-reference" else "ref")
    if direction == "port-to-reference":
        st = jload_checkpoint(src / name, jmodel.grid, model=jmodel)
        got_tree, fresh = jtree(st), JSimulation(jmodel, tmp_path / "fresh")
    else:
        st = trestart.load_checkpoint(src / name, tmodel.grid, model=tmodel)
        got_tree = state_to_numpy(st)
        fresh = Simulation(tmodel, tmp_path / "fresh")
    assert_states_equal(got_tree, state_to_numpy(tst), skip=("facstats",))
    assert float(np.abs(got_tree["fac"]["T"]).max()) > 0
    assert not np.asarray(got_tree["facstats"]["tau_x"]).any()
    fresh.resume_stats(src / name)
    for fam, w in fresh._stats_writers().items():
        for k, v in Simulation._acc_items(w.acc):
            assert np.array_equal(np.asarray(v), want[fam][k]), (fam, k)
        assert (w.tnext_sample, w.tnext_write) == (13.0, 20.0)


@pytest.mark.parametrize("nproc", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_fortran_restart_roundtrips(tmp_path, nproc):
    """The reference's per-rank initd/inits files: the port's writer gives
    the reference writer's bytes, each package reads the other's files back
    exactly, and ``write_state_fortran`` -> ``warmstart_state``
    returns the State's fields, pressure, time and step."""
    from udales_tpu.io import restart as jrestart
    from udales_tpu_torch.config import (Config, DomainConfig, RunConfig,
                                         ScalarsConfig)
    from udales_tpu_torch.grid import Grid
    nx, ny, nz = 8, 6, 5
    rng = np.random.default_rng(nproc[0])
    fields = {k: rng.standard_normal((nx, ny, nz + (k == "w")))
              for k in ("u", "v", "w", "pres", "thl", "e12", "qt")}
    sv = rng.standard_normal((2, nx, ny, nz))
    args = (fields, 3.25, 0.125, "901", nx, ny, nz, *nproc)
    for d, mod in (("ref", jrestart), ("got", trestart)):
        (tmp_path / d).mkdir()
        mod.write_fortran_restart(tmp_path / d, *args, ntrun=7, sv=sv)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert len(names) == 2 * nproc[0] * nproc[1]
    assert names == sorted(p.name for p in (tmp_path / "got").iterdir())
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "ref", tmp_path / "got",
                                           names, shallow=False)
    assert not mismatch and not errors
    read = (tmp_path / "ref", "initd00000007_xxx_xxx.901", "901", nx, ny, nz,
            *nproc, 2)
    out, out_sv, timee, dt = trestart.read_fortran_restart(*read)
    jout, jsv, jtimee, jdt = jrestart.read_fortran_restart(*read)
    assert (timee, dt) == (jtimee, jdt) == (3.25, 0.125)
    assert np.array_equal(out_sv, jsv) and np.array_equal(out_sv[..., :nz], sv)
    for k, v in fields.items():
        assert np.array_equal(out[k], jout[k])
        assert np.array_equal(out[k][..., :v.shape[2]], v), k
    # a State through the files and back
    cfg = Config(domain=DomainConfig(itot=nx, jtot=ny, ktot=nz,
                                     xlen=float(nx), ylen=float(ny)),
                 run=RunConfig(nprocx=nproc[0], nprocy=nproc[1]),
                 scalars=ScalarsConfig(nsv=2), dtype="float64")
    grid = Grid.uniform(nx, ny, nz, float(nx), float(ny), float(nz),
                        dtype=np.float64)
    t = lambda a: torch.as_tensor(a)
    f = dict(u=t(fields["u"]), v=t(fields["v"]), w=t(fields["w"]),
             thl=t(fields["thl"]), qt=t(fields["qt"]), e12=t(fields["e12"]),
             sv=t(sv))
    from udales_tpu_torch.state import Fields, State
    st = State(m=Fields(**f), c=Fields(**f), pres=t(fields["pres"]),
               dt=torch.tensor(0.125, dtype=torch.float64),
               timee=torch.tensor(3.25, dtype=torch.float64))
    trestart.write_state_fortran(tmp_path, st, "901", cfg, ntrun=9)
    back = trestart.warmstart_state(tmp_path, "initd00000009_xxx_xxx.901",
                                    "901", cfg, grid, device="cpu")
    assert_states_equal(state_to_numpy(back), state_to_numpy(st))


@pytest.mark.parametrize("fmt", ["h5", "fortran"])
def test_open_boundary_state_roundtrips(tmp_path, fmt):
    """A State of an open case through a native checkpoint (outlet planes
    of x and y, the inlet generator's state) or through the Fortran files
    on 2 x 2 ranks (the outlet planes in the halo past the domain's last
    cells, ``write_state_fortran`` -> ``warmstart_state(model=)``): every
    leaf back exactly."""
    from types import SimpleNamespace
    from udales_tpu_torch.config import (Config, DomainConfig, RunConfig,
                                         ScalarsConfig)
    from udales_tpu_torch.grid import Grid
    from udales_tpu_torch.ops.inletgen import INLETGEN_NAMES, InletGen
    from udales_tpu_torch.ops.openbc import XPlanes, YPlanes
    from udales_tpu_torch.state import Fields, State
    nx, ny, nz, nsv = 8, 6, 5, 2
    rng = np.random.default_rng(11)
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape))
    planes = lambda cls, n: cls(u=t(n, nz), v=t(n, nz), w=t(n, nz + 1),
                                thl=t(n, nz), qt=t(n, nz), e12=t(n, nz),
                                sv=t(nsv, n, nz))
    f = Fields(u=t(nx, ny, nz), v=t(nx, ny, nz), w=t(nx, ny, nz + 1),
               thl=t(nx, ny, nz), qt=t(nx, ny, nz), e12=t(nx, ny, nz),
               sv=t(nsv, nx, ny, nz), bx=planes(XPlanes, ny),
               by=planes(YPlanes, nx))
    shapes = dict(Wrec=(nz + 1,), Utav=(nx, nz), displ=(nx,), u0=(ny, nz),
                  v0=(ny, nz), w0=(ny, nz + 1), t0=(ny, nz), utaui=(),
                  ttaui=(), ddispdx=())
    ig = InletGen(**{k: t(*shapes.get(k, (nz,))) for k in INLETGEN_NAMES})
    st = State(m=f, c=f, pres=t(nx, ny, nz),
               dt=torch.tensor(0.125, dtype=torch.float64),
               timee=torch.tensor(3.25, dtype=torch.float64),
               ig=ig if fmt == "h5" else None)
    cfg = Config(domain=DomainConfig(itot=nx, jtot=ny, ktot=nz,
                                     xlen=float(nx), ylen=float(ny)),
                 run=RunConfig(nprocx=2, nprocy=2),
                 scalars=ScalarsConfig(nsv=nsv), dtype="float64")
    grid = Grid.uniform(nx, ny, nz, float(nx), float(ny), float(nz),
                        dtype=np.float64)
    model = SimpleNamespace(cfg=cfg, device="cpu", eb=None, ibm=None,
                            mesh=None, inlet=object(), inlet_y=object())
    if fmt == "h5":
        trestart.save_checkpoint(tmp_path / "ck.h5", st, 9)
        back = trestart.load_checkpoint(tmp_path / "ck.h5", grid,
                                        model=model)
    else:
        trestart.write_state_fortran(tmp_path, st, "901", cfg, ntrun=9)
        back = trestart.warmstart_state(tmp_path,
                                        "initd00000009_xxx_xxx.901", "901",
                                        cfg, grid, model=model)
    got, want = state_to_numpy(back), state_to_numpy(st)
    assert {"bx", "by"} <= set(got["c"]) and got["c"]["bx"] is not None
    # the Fortran files hold no generator state: a warm start builds it
    # only for a model with a generator, which this one has not
    assert ("ig" in got) == (fmt == "h5" or getattr(model, "igparams", None)
                             is not None)
    assert_states_equal(got, want)


@pytest.mark.parametrize("fmt", ["h5", "fortran"])
def test_restart_lands_on_the_models_device(tmp_path, fmt):
    """Read with a `model` and no `device`, a restart State lands on the
    model's device (here the meta device, which no default would pick);
    with neither, on the card."""
    from types import SimpleNamespace
    from udales_tpu_torch.config import Config, DomainConfig, RunConfig
    from udales_tpu_torch.grid import Grid
    from udales_tpu_torch.state import Fields, State
    nx, ny, nz = 4, 4, 3
    rng = np.random.default_rng(5)
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape))
    f = Fields(u=t(nx, ny, nz), v=t(nx, ny, nz), w=t(nx, ny, nz + 1),
               thl=t(nx, ny, nz), qt=t(nx, ny, nz), e12=t(nx, ny, nz),
               sv=t(0, nx, ny, nz))
    st = State(m=f, c=f, pres=t(nx, ny, nz),
               dt=torch.tensor(0.125, dtype=torch.float64),
               timee=torch.tensor(3.25, dtype=torch.float64))
    cfg = Config(domain=DomainConfig(itot=nx, jtot=ny, ktot=nz,
                                     xlen=float(nx), ylen=float(ny)),
                 run=RunConfig(nprocx=1, nprocy=1), dtype="float64")
    grid = Grid.uniform(nx, ny, nz, float(nx), float(ny), float(nz),
                        dtype=np.float64)
    model = SimpleNamespace(cfg=cfg, device="meta", eb=None, ibm=None,
                            mesh=None, inlet=None, inlet_y=None)
    if fmt == "h5":
        trestart.save_checkpoint(tmp_path / "ck.h5", st, 9)
        back = trestart.load_checkpoint(tmp_path / "ck.h5", grid,
                                        model=model)
    else:
        trestart.write_state_fortran(tmp_path, st, "901", cfg, ntrun=9)
        back = trestart.warmstart_state(tmp_path,
                                        "initd00000009_xxx_xxx.901", "901",
                                        cfg, grid, model=model)
    assert {x.device.type for x in (back.c.u, back.m.w, back.pres, back.dt,
                                    back.timee)} == {"meta"}
    assert trestart._device(None, None) == "cuda"
    assert trestart._device("cpu", model) == "cpu"


def test_checkpoint_without_h5py(monkeypatch, eb_case, tmp_path):
    """With h5py hidden, as on the card's machine: a native checkpoint with
    the facet state is written and read back, ``Simulation._write_restart``
    and ``resume_stats`` carry the statistics accumulators, and the driver
    series of ``DriverRecorder.save`` loads through ``load_driver_inlet``
    equal to its ``?driver_*`` files."""
    from udales_tpu_torch.io.driverfiles import read_driver_files
    from udales_tpu_torch.ops.openbc import load_driver_inlet
    from udales_tpu_torch.sim import DriverRecorder
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with pytest.raises(ImportError):
        import h5py  # noqa: F401
    model = load_case(eb_case, "900", dtype="float64", device="cpu")
    st = model.step(model.cold_start(seed=43))
    trestart.save_checkpoint(tmp_path / "x.h5", st, 4)
    back = trestart.load_checkpoint(tmp_path / "x.h5", model.grid,
                                    model=model)
    assert_states_equal(state_to_numpy(back), state_to_numpy(st),
                        skip=("facstats",))
    assert back.fac is not None
    rng = np.random.default_rng(7)
    sim = Simulation(model, tmp_path / "sim")
    for w in sim._stats_writers().values():
        vals = {k: torch.as_tensor(rng.standard_normal(tuple(v.shape)))
                for k, v in Simulation._acc_items(w.acc)}
        w.acc = vals if isinstance(w.acc, dict) else type(w.acc)(**vals)
        w.tnext_sample, w.tnext_write = 13.0, 20.0
    want = _stats_numpy(sim)
    sim._write_restart(st)
    fresh = Simulation(model, tmp_path / "fresh")
    fresh.resume_stats(tmp_path / "sim" / "initd00000000.900.h5")
    assert len(want) == 5
    for fam, w in fresh._stats_writers().items():
        for k, v in Simulation._acc_items(w.acc):
            assert np.array_equal(np.asarray(v), np.asarray(want[fam][k]))
        assert (w.tnext_sample, w.tnext_write) == (13.0, 20.0)
    rec = DriverRecorder(model.cfg, model.grid, tmp_path / "drv")
    (tmp_path / "drv").mkdir()
    for t in (0.0, 0.1, 0.2):
        rec.maybe_record(st, t)
    assert rec.save() == tmp_path / "drv" / "tdriver_000.900"
    inlet = load_driver_inlet(tmp_path / "drv" / "driverdata.900.h5",
                              torch.float64, device="cpu")
    files = read_driver_files(tmp_path / "drv", 900, model.grid.jtot,
                              model.grid.ktot)
    assert np.array_equal(inlet.t.numpy(), [0.0, 0.1, 0.2])
    for k in ("t", "u", "v", "w", "thl"):
        got = getattr(inlet, k).numpy()
        np.testing.assert_array_equal(got, files[k], err_msg=k)


def _step_times(model, state, n):
    times = []
    for _ in range(n):
        state = model.step(state)
        times.append(float(state.timee))
    return times


@pytest.mark.parametrize("fmt", ["h5", "h5-without-h5py", "fortran"])
def test_continued_run_equals_uninterrupted_run(monkeypatch, tmp_path, fmt):
    """3 steps, a restart, 3 more through ``main`` with ``lwarmstart``,
    against 6 steps in one run, every State leaf equal (the facet state
    with the native checkpoint, on the urban-EB case; the Fortran files
    carry no facet state, so that run takes the plain urban case).  The
    runs stop halfway between two step times.  With the native checkpoint
    the xytdump accumulator rides along, so the one xytdump write, at step
    6, is the same in both.  "h5-without-h5py" hides h5py, as on the
    card's machine."""
    if fmt == "h5-without-h5py":
        monkeypatch.setitem(__import__("sys").modules, "h5py", None)
        fmt = "h5"
    root = tmp_path / "case"
    base = (cases.stage_urban_eb(N, root, dtEB=0.5) if fmt == "h5"
            else cases.stage_urban(N, root))
    probe = load_case(base, "900", dtype="float64", device="cpu")
    st0 = probe.cold_start(seed=43)
    t = _step_times(probe, st0, 6)
    half = lambda k: 0.5 * (t[k - 1] + t[k])      # between steps k and k+1
    out = dict(lxytdump=True, tsample=1e-6, tstatsdump=half(5))
    case = cases.with_namelist(base, tmp_path / "run", OUTPUT=out,
                               RUN=dict(trestart=half(2)))
    model = load_case(case, "900", dtype="float64", device="cpu")
    full = Simulation(model, tmp_path / "full").run(st0, runtime=half(5))
    leg = Simulation(model, tmp_path / "leg1")
    first = leg.run(st0, runtime=half(2))
    assert leg.ntrun == 3 and float(first.timee) == t[2]
    if fmt == "h5":
        start = "initd00000003.900.h5"
        assert (tmp_path / "leg1" / start).exists()
        ck = tmp_path / "leg1" / start
    else:
        start = "initd00000003_xxx_xxx.900"
        trestart.write_state_fortran(tmp_path / "leg1", first, "900",
                                     model.cfg, ntrun=3)
        ck = tmp_path / "leg1" / "initd00000003_000_000.900"
    resumed = cases.with_namelist(case, tmp_path / "resumed",
                                  RUN=dict(lwarmstart=True, startfile=start))
    (resumed / ck.name).write_bytes(ck.read_bytes())
    second = main([str(resumed), "--device", "cpu", "--dtype", "float64",
                   "--runtime", repr(half(5) - t[2]),
                   "--outdir", str(tmp_path / "leg2")])
    assert float(second.timee) == t[5] == float(full.timee)
    skip = ("facstats",) if fmt == "h5" else ("facstats", "fac")
    assert_states_equal(state_to_numpy(second), state_to_numpy(full),
                        skip=skip)
    mon = np.loadtxt(tmp_path / "leg2" / "monitor.900.txt")
    assert np.allclose(mon[:, 0], t[3:], rtol=1e-6, atol=0)   # %14.6e
    if fmt == "h5":
        assert_files_match(tmp_path / "leg2" / "xytdump.900.nc",
                           tmp_path / "full" / "xytdump.900.nc", rtol=0.0)
