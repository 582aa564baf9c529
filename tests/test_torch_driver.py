"""Driver record and replay of the PyTorch port against udales_tpu (CPU,
float64): the reference-format ``?driver_*`` files, the rolling
``DriverStream`` window, the ``DriverRecorder``, the ``load_case`` branches
of a ``BCxm = 3`` case, and the staged driven cases.

Files written by one package are read by the other and must come back
exactly; windows and interpolated planes are compared bit for bit; whole
steps from one State agree to 1e-8 relative after 5 steps in every leaf.
"""
import dataclasses

import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import torch

import udales_tpu.config as jconfig
from udales_tpu.io import driverfiles as jfiles
from udales_tpu.io.driverstream import DriverStream as JStream
from udales_tpu.ops import openbc as jopen
from udales_tpu.run import load_case as jload
from udales_tpu.sim import DriverRecorder as JRecorder

import udales_tpu_torch.config as tconfig
from udales_tpu_torch import cases
from udales_tpu_torch.convert import inlet_from_numpy, state_from_numpy
from udales_tpu_torch.io import driverfiles as tfiles
from udales_tpu_torch.io.driverstream import DriverStream as TStream
from udales_tpu_torch.ops import openbc as topen
from udales_tpu_torch.run import load_case as tload
from udales_tpu_torch.sim import DriverRecorder as TRecorder

from test_torch_openbc import (NX, NY, NZ, build_pair,
                               compare_states, jtree, jtree_t,
                               open_divergence, run_both, t)

D = jconfig.BC_DRIVER
DRIVER_X = dict(BCxm=D, BCxT=D, BCxq=D, BCxs=D)


def series(nt, ny=NY, nz=NZ, dt=0.03, seed=7, nsv=0):
    """A precursor series: times `dt` apart and planes around a sheared
    mean, the w planes with their nz + 1 faces (floor and top at rest)."""
    rng = np.random.default_rng(seed)
    times = dt * np.arange(nt)
    z = np.arange(nz) + 0.5
    planes = dict(
        u=1.0 + 0.05 * z + 0.05 * rng.standard_normal((nt, ny, nz)),
        v=0.1 + 0.05 * rng.standard_normal((nt, ny, nz)),
        w=0.02 * rng.standard_normal((nt, ny, nz + 1)),
        thl=288.0 + 0.05 * z + 0.1 * rng.standard_normal((nt, ny, nz)),
        qt=1e-3 + 1e-4 * rng.standard_normal((nt, ny, nz)))
    planes["w"][:, :, 0] = planes["w"][:, :, -1] = 0.0
    if nsv:
        planes["sv"] = rng.random((nt, nsv, ny, nz))
    return times, planes


# --- the reference-format files ----------------------------------------------

@pytest.mark.parametrize("nprocy", [1, 2])
def test_driver_files_cross_packages(tmp_path, nprocy):
    """Both writers emit the same bytes; each package reads the other's
    files back to the planes that were written, whole and by window."""
    times, planes = series(9, nsv=2)
    kw = dict(nprocy=nprocy, tdriverstart=0.0)
    jfiles.write_driver_files(tmp_path / "j", "777", times, planes, NY, NZ,
                              **kw)
    tfiles.write_driver_files(tmp_path / "t", "777", times, planes, NY, NZ,
                              **kw)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == 1 + 6 * nprocy
    for name in names:
        assert (tmp_path / "j" / name).read_bytes() \
            == (tmp_path / "t" / name).read_bytes(), name
    rd = dict(nsv=2, ltempeq=True, lmoist=True)
    for reader, src in ((jfiles.read_driver_files, "t"),
                        (tfiles.read_driver_files, "j")):
        full = reader(tmp_path / src, 777, NY, NZ, **rd)
        np.testing.assert_array_equal(full["t"], times)
        for k, v in planes.items():
            np.testing.assert_array_equal(full[k], v, err_msg=k)
        win = reader(tmp_path / src, 777, NY, NZ, start=3, driverstore=4,
                     **rd)
        for k in full:
            np.testing.assert_array_equal(win[k], full[k][3:7], err_msg=k)


# --- the rolling window ------------------------------------------------------

@pytest.fixture(scope="module")
def series_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("drvstream")
    times, planes = series(60, dt=0.25)
    tfiles.write_driver_files(out, "777", times, planes, NY, NZ, nprocy=2)
    return out, times, planes


@dataclasses.dataclass
class FakeState:
    timee: float
    drv: object = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def test_stream_windows_match_reference(series_dir):
    """Sweeping time through the series with an 8-record window: both
    packages pick the same window starts, hold the same records and refill
    equally often; the interpolated planes equal the full-series Inlet's
    bit for bit."""
    out, times, _ = series_dir
    js = JStream(out, 777, NY, NZ, jnp.float64, chunk=8)
    ts = TStream(out, 777, NY, NZ, torch.float64, chunk=8, device="cpu")
    assert (ts.nt, ts.chunk) == (js.nt, js.chunk) == (60, 8)
    d = tfiles.read_driver_files(out, 777, NY, NZ)
    inlet = inlet_from_numpy({"mode": tconfig.BC_DRIVER, **d})
    jst, tst = FakeState(0.0), FakeState(0.0)
    jrefills, last = 0, None
    for time in np.linspace(times[0], times[-1] + 1.0, 41):
        jst = js.ensure(FakeState(float(time), jst.drv))
        tst = ts.ensure(FakeState(float(time), tst.drv))
        if jst.drv is not last:
            jrefills, last = jrefills + 1, jst.drv
        assert ts.n0 == js.n0
        assert tst.drv.u.shape == (8, NY, NZ)
        for k, v in jtree_t(tst.drv).items():
            np.testing.assert_array_equal(v, np.asarray(getattr(jst.drv, k)),
                                          err_msg=k)
        got = topen.driver_window_planes(tst.drv, t(time))
        want = inlet.planes(t(time), NY, NZ)
        ref = jopen.driver_window_planes(jst.drv, jnp.float64(time))
        for k in ("u", "v", "w", "thl"):
            assert torch.equal(got[k], want[k]), k
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-14, err_msg=k)
    assert ts.refills == jrefills >= 6


def test_stream_clamps_past_series_end(series_dir):
    out, times, planes = series_dir
    ts = TStream(out, 777, NY, NZ, torch.float64, chunk=8, device="cpu")
    late = float(times[-1]) + 100.0
    st = ts.ensure(FakeState(late))
    got = topen.driver_window_planes(st.drv, t(late))
    np.testing.assert_allclose(got["u"].numpy(), planes["u"][-1], atol=1e-12)
    # a chunk larger than the series, or smaller than 4, is clamped
    assert TStream(out, 777, NY, NZ, torch.float64, chunk=500,
                   device="cpu").chunk == 60
    assert TStream(out, 777, NY, NZ, torch.float64, chunk=1,
                   driverstore=20, device="cpu").chunk == 4


def test_stream_gives_a_fresh_state_the_window_of_its_time(series_dir):
    """A stream that served a late window, handed a State without a window
    (a second cold start, a warm start): the window of that State's own
    time, whose planes are the full series' (it once kept its last window
    and clamped the interpolation to that window's first record)."""
    out, times, _ = series_dir
    ts = TStream(out, 777, NY, NZ, torch.float64, chunk=8, device="cpu")
    ts.ensure(FakeState(float(times[-10])))
    d = tfiles.read_driver_files(out, 777, NY, NZ)
    inlet = inlet_from_numpy({"mode": tconfig.BC_DRIVER, **d})
    early = float(times[3]) + 0.1
    st = ts.ensure(FakeState(early))
    got = topen.driver_window_planes(st.drv, t(early))
    want = inlet.planes(t(early), NY, NZ)
    for k in ("u", "v", "w", "thl"):
        assert torch.equal(got[k], want[k]), k


# --- whole steps with a driver inlet ---------------------------------------

def driven_pair(**physics):
    return build_pair(inlet_x=jconfig.BC_PROFILE, bc=DRIVER_X,
                      physics=dict(ltempeq=True, **physics))


def test_five_steps_from_a_recorded_series_match_reference():
    """The whole series on the device (Inlet in driver mode)."""
    jmodel, tmodel = driven_pair()
    times, planes = series(8)
    jmodel.inlet = jopen.Inlet(mode=D, t=jnp.asarray(times), **{
        k: jnp.asarray(v) for k, v in planes.items()})
    tmodel.inlet = inlet_from_numpy({"mode": D, "t": times, **planes})
    jst = jmodel.cold_start(seed=3, dt0=0.02)
    jst, tst = run_both(jmodel, tmodel, jst)
    want = tmodel.inlet.planes(tst.timee, NY, NZ)["u"]
    assert torch.equal(tst.c.u[0], want)          # the inlet follows
    div = open_divergence(tmodel, tst.c)
    assert np.abs(div[:, :, :-1]).max() < 1e-8


def test_five_streamed_steps_with_a_refill_match_reference(tmp_path):
    """lchunkread: a 4-record window over records 0.03 s apart at
    dt = 0.02 s is refilled inside the 5 steps, in both packages."""
    jmodel, tmodel = driven_pair()
    times, planes = series(12)
    tfiles.write_driver_files(tmp_path, "777", times, planes, NY, NZ)
    jmodel.inlet, tmodel.inlet = jopen.Inlet(mode=D), topen.Inlet(mode=D)
    jmodel.driver_stream = JStream(tmp_path, 777, NY, NZ, jnp.float64,
                                   chunk=4)
    tmodel.driver_stream = TStream(tmp_path, 777, NY, NZ, torch.float64,
                                   chunk=4, device="cpu")
    jst = jmodel.cold_start(seed=3, dt0=0.02)
    jst, tst = run_both(jmodel, tmodel, jst)
    assert tmodel.driver_stream.refills >= 2
    assert tmodel.driver_stream.n0 == jmodel.driver_stream.n0 > 0
    assert "drv.u" in compare_states(tst, jst)
    # Model.run refills by itself
    tmodel.driver_stream.n0, before = None, tmodel.driver_stream.refills
    st = tmodel.run(state_from_numpy(jtree(jmodel.cold_start(
        seed=3, dt0=0.02))), 5)
    assert tmodel.driver_stream.refills - before >= 2
    assert torch.equal(st.c.u, tst.c.u)


# --- load_case on a BCxm = 3 case -------------------------------------------

from test_torch_inletgen import write_flat_case  # noqa: E402

DRIVEN_NAMELIST = ("&BC\nBCxm = 3\nBCxT = 3\nBCxq = 3\nBCxs = 3\n"
                   "thls = 288.\n/\n&DRIVER\nidriver = 2\ndriverjobnr = 5\n"
                   "{driver}/\n")


def driven_case(path, driver=""):
    case = write_flat_case(path, "006", NX, NY, NZ,
                           DRIVEN_NAMELIST.format(driver=driver))
    times, planes = series(12)
    return case, times, planes


def test_load_case_without_driver_files_raises(tmp_path):
    case, _, _ = driven_case(tmp_path / "none")
    with pytest.raises(FileNotFoundError, match="idriver=1, experiment 005"):
        tload(case, "006", dtype="float64", device="cpu")


@pytest.mark.parametrize("source", ["fortran", "h5", "stream"])
def test_load_case_driver_branches_match_reference(tmp_path, source):
    """The three sources of a driver inlet through both load_case's: the
    whole of the Fortran files, the h5 series (which wins over them), and
    the lchunkread window; then 5 steps from one State."""
    driver = ("lchunkread = .true.\nchunkread_size = 4\ndriverstore = 10\n"
              if source == "stream" else "")
    case, times, planes = driven_case(tmp_path / source, driver)
    if source == "h5":
        import h5py
        with h5py.File(case / "driverdata.005.h5", "w") as f:
            f.create_dataset("t", data=times)
            for k, v in planes.items():
                f.create_dataset(k, data=v)
        # files that must lose against the h5 series
        tfiles.write_driver_files(case, "005", times,
                                  {k: 0 * v for k, v in planes.items()},
                                  NY, NZ)
    else:
        tfiles.write_driver_files(case, "005", times, planes, NY, NZ)
    jmodel = jload(case, "006", dtype="float64")
    tmodel = tload(case, "006", dtype="float64", device="cpu")
    assert tmodel.inlet.mode == D
    if source == "stream":
        assert tmodel.inlet.u is None
        assert (tmodel.driver_stream.nt, tmodel.driver_stream.chunk) \
            == (jmodel.driver_stream.nt, jmodel.driver_stream.chunk) == (10, 4)
    else:
        assert tmodel.driver_stream is None
        for k in ("t", "u", "v", "w", "thl"):
            np.testing.assert_array_equal(getattr(tmodel.inlet, k).numpy(),
                                          np.asarray(getattr(jmodel.inlet, k)),
                                          err_msg=k)
        np.testing.assert_array_equal(tmodel.inlet.u.numpy(), planes["u"])
    jst = jmodel.cold_start(seed=3, dt0=0.02)
    jst, tst = run_both(jmodel, tmodel, jst)
    assert tst.c.bx is not None
    assert (tst.drv is not None) == (source == "stream")


# --- the recorder ------------------------------------------------------------

def test_recorder_writes_what_the_reference_writes(tmp_path):
    """Both recorders on the same trajectory: the same ``?driver_*`` files
    byte for byte, the h5 series equal, and the recorded u plane is the
    face `iplane` of the State that was handed in."""
    kw = dict(driver=dict(idriver=1, tdriverstart=0.03, dtdriver=0.04,
                          iplane=NX), physics=dict(ltempeq=True))
    jmodel, tmodel = build_pair(**kw)
    jrec = JRecorder(jmodel.cfg, jmodel.grid, tmp_path / "j")
    trec = TRecorder(tmodel.cfg, tmodel.grid, tmp_path / "t")
    (tmp_path / "j").mkdir()
    jst = jmodel.cold_start(seed=3, dt0=0.02)
    jstep = jax.jit(jmodel.step)
    firsts = []
    for _ in range(8):
        jst = jstep(jst)
        tst = state_from_numpy(jtree(jst))
        jrec.maybe_record(jst)
        n = len(trec.times)
        trec.maybe_record(tst)
        if len(trec.times) > n:
            firsts.append(tst.c.u[NX % NX].numpy().copy())
    assert trec.times == jrec.times and 3 <= len(trec.times) < 8
    assert trec.times[0] >= 0.03
    np.testing.assert_array_equal(trec.frames[0]["u"], firsts[0])
    jrec.save()
    assert trec.save() == tmp_path / "t" / "tdriver_000.000"
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert "driverdata.000.h5" in names and "udriver_000.000" in names
    import h5py
    for name in names:
        a, b = tmp_path / "j" / name, tmp_path / "t" / name
        if name.endswith(".h5"):
            with h5py.File(a) as fa, h5py.File(b) as fb:
                assert sorted(fa) == sorted(fb)
                for k in fa:
                    np.testing.assert_array_equal(fa[k][()], fb[k][()])
        else:
            assert a.read_bytes() == b.read_bytes(), name
    assert TRecorder(tmodel.cfg, tmodel.grid, tmp_path / "e").save() is None


def test_precursor_record_then_replay(tmp_path):
    """stage_precursor: 12 periodic steps of experiment 901 with the
    recorder, then experiment 902 replays the written files: its inlet face
    is the interpolated recorded plane, the fields stay finite and the
    interior divergence-free."""
    case = cases.stage_precursor(12, tmp_path, dtdriver=0.2)
    assert cases.stage_precursor(12, tmp_path, dtdriver=0.2) == case
    pre = tload(case, cases.PRECURSOR_EXPNR, dtype="float64", device="cpu")
    assert pre.inlet is None and pre.cfg.driver.idriver == 1
    rec = TRecorder(pre.cfg, pre.grid, case)
    st = pre.cold_start(seed=4)
    for _ in range(12):
        st = pre.step(st)
        rec.maybe_record(st)
    assert len(rec.times) >= 4
    rec.save()
    h5 = case / f"driverdata.{cases.PRECURSOR_EXPNR}.h5"
    if h5.exists():
        h5.unlink()           # replay the reference-format files
    model = tload(case, cases.REPLAY_EXPNR, dtype="float64", device="cpu")
    assert model.inlet.mode == D and model.inlet.u.shape[0] == len(rec.times)
    np.testing.assert_array_equal(model.inlet.u[1].numpy(),
                                  rec.frames[1]["u"])
    st = model.cold_start(seed=5).replace(
        timee=torch.tensor(rec.times[0], dtype=torch.float64))
    st = model.run(st, 4)
    want = model.inlet.planes(st.timee, 12, 12)["u"]
    assert torch.equal(st.c.u[0], want)
    assert float((want - torch.as_tensor(rec.frames[0]["u"])).abs().max()) > 0
    for name in ("u", "v", "w", "thl"):
        assert bool(torch.isfinite(getattr(st.c, name)).all()), name
    assert np.abs(open_divergence(model, st.c)[:, :, :-1]).max() < 1e-8


# --- the staged driven urban case -------------------------------------------

N = 32


@pytest.fixture(scope="module")
def driven_urban(tmp_path_factory):
    return cases.stage_urban_driven(N, tmp_path_factory.mktemp("drv"),
                                    nt=24, chunk=8)


def test_stage_urban_driven_files(driven_urban):
    """The staged directory: the urban files plus its precursor planes as the
    reference writes them, its &DRIVER namelist, a start profile equal to the
    planes' mean; the inlet and outlet columns are fluid."""
    case = driven_urban
    assert case.name == f"urban{N}drv_nt24_chunk8_dt1"
    assert cases.stage_urban_driven(N, case.parent, nt=24, chunk=8) == case
    cfg = tconfig.load_namoptions(case / "namoptions.900", dtype="float64")
    assert (cfg.bc.BCxm, cfg.bc.BCxT, cfg.bc.BCxq, cfg.bc.BCxs) == (D,) * 4
    dr = cfg.driver
    assert (dr.idriver, dr.driverjobnr, dr.lchunkread, dr.chunkread_size,
            dr.driverstore) == (2, 900, True, 8, 24)
    assert cfg.run.libm and cfg.subgrid.lvreman and cfg.walls.iwalltemp == 2
    for pref in "uvwh":
        assert (case / f"{pref}driver_000.900").stat().st_size \
            == 24 * (N + 2) * (N + 2) * 8
    d = tfiles.read_driver_files(case, 900, N, N)
    times, planes = cases.driver_planes(N, 24)
    np.testing.assert_array_equal(d["t"], np.arange(24.0))
    for k in ("u", "v", "thl"):
        np.testing.assert_array_equal(d[k], planes[k])
    np.testing.assert_array_equal(d["w"][:, :, :N], planes["w"])
    assert np.all(d["w"][:, :, 0] == 0.0) and np.all(d["thl"] == 290.0)
    z = np.arange(N) + 0.5
    np.testing.assert_allclose(d["u"].mean(axis=(0, 1)),
                               0.4 / 0.41 * np.log(z / 0.05), atol=0.02)
    prof = np.loadtxt(case / "prof.inp.900", skiprows=2)
    np.testing.assert_allclose(prof[:, 3], d["u"].mean(axis=(0, 1)),
                               atol=1e-4)
    model = tload(case, "900", dtype="float64", device="cpu")
    assert bool(model.ibm.masks.u[0].all()) and bool(model.ibm.masks.u[-1].all())
    assert model.driver_stream is not None and model.inlet.mode == D


def test_five_driven_urban_steps_match_reference(driven_urban):
    """stage_urban_driven(32) loaded by both packages from one directory:
    5 adaptive steps from udales_tpu's cold start agree to 1e-8 in the
    fields, the outlet planes, the rolling window and the pressure."""
    jmodel = jload(driven_urban, "900", dtype="float64")
    tmodel = tload(driven_urban, "900", dtype="float64", device="cpu")
    jst = jmodel.cold_start(seed=43)
    # State.ibmp holds udales_tpu's static IBM tables, not state
    tst = state_from_numpy(jtree(jst.replace(ibmp=None)))
    jstep = jax.jit(jmodel.step)
    for _ in range(5):
        jst = jmodel.driver_stream.ensure(jst)
        tst = tmodel.driver_stream.ensure(tst)
        jst = jstep(jst)
        tst = tmodel.step(tst)
    names = compare_states(tst, jst.replace(ibmp=None))
    assert {"c.bx.u", "m.bx.w", "drv.u", "pres", "c.thl"} <= set(names)
    want = topen.driver_window_planes(tst.drv, tst.timee)["u"]
    assert torch.equal(tst.c.u[0], want)
    assert float(tst.dt) < 0.5


def test_port_alone_runs_the_driven_urban_case(driven_urban):
    """load_case, cold_start, run on the port alone: finite fields, the
    interior divergence-free, masked diffusion through the plain path."""
    model = tload(driven_urban, "900", dtype="float64", device="cpu")
    st = model.run(model.cold_start(seed=1), 3)
    for name in ("u", "v", "w", "thl"):
        assert bool(torch.isfinite(getattr(st.c, name)).all()), name
    div = open_divergence(model, st.c)
    assert np.abs(div[:, :, :-1]).max() < 1e-8
    assert model.driver_stream.refills == 1
