"""Passive scalars of the PyTorch port against udales_tpu (CPU, float64).

Function by function (the kappa ghosts of the scalar stack, periodic and
open; kappa advection and ``diff_c`` of the stack against the reference's
per-scalar ``vmap``) the same numpy-seeded inputs go through both packages
and agree to 1e-12 * max(1, max|ref|).  Whole steps start from one State,
made by udales_tpu's ``cold_start`` and carried over as numpy, and agree to
1e-8 relative after 5 steps in every State leaf:

  (i)   a flat case with two scalars and point sources;
  (v)   the driven urban case with one scalar through the driver inlet, and
        a precursor with one scalar recorded and replayed.

The other whole-step cases are in test_torch_dispersion.py (ii, the staged
dispersion case), test_torch_physics.py (iii, purifiers and heat pumps; vi,
moist with trees and sveg) and test_torch_oneeqn.py (iv, the one-equation
closure).
"""
import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import torch

import udales_tpu.config as jconfig
from udales_tpu.grid import Grid as JGrid
from udales_tpu.ops import (advection as jadv, boundary as jbnd,
                            openbc as jopen, subgrid as jsgs)
from udales_tpu.physics import ScalarSources as JSources
from udales_tpu.run import Model as JModel, load_case as jload
from udales_tpu.state import Fields as JFields

from udales_tpu_torch import cases
from udales_tpu_torch.convert import state_from_numpy
from udales_tpu_torch.grid import Grid as TGrid
from udales_tpu_torch.io import driverfiles as tfiles
from udales_tpu_torch.ops import (advection as tadv, boundary as tbnd,
                                  openbc as topen, subgrid as tsgs)
from udales_tpu_torch.physics import ScalarSources as TSources
from udales_tpu_torch.run import Model as TModel, load_case as tload
from udales_tpu_torch.sim import DriverRecorder as TRecorder
from udales_tpu_torch.state import Fields as TFields

from test_torch_openbc import (NX, NY, NZ, assert_close, both_inlets,
                               build_pair, compare_states, jtree,
                               open_divergence, run_both, t)

NSV = 2


def grids(stretched=True):
    zf = (np.cumsum(1.1 ** np.arange(NZ)) - 0.5 * 1.1 ** np.arange(NZ)
          if stretched else np.arange(NZ) + 0.5)
    return (JGrid(NX, NY, NZ, float(NX), float(NY), zf, dtype=np.float64),
            TGrid(NX, NY, NZ, float(NX), float(NY), zf, dtype=np.float64))


def both_fields(seed, nsv=NSV):
    """The same random Fields with `nsv` scalars and outlet planes that
    carry them, for both packages."""
    rng = np.random.default_rng(seed)
    cell = lambda: rng.standard_normal((NX, NY, NZ))
    a = dict(u=1.0 + 0.2 * cell(), v=0.2 * cell(),
             w=0.1 * rng.standard_normal((NX, NY, NZ + 1)),
             thl=288.0 + cell(), qt=1e-3 * (1.0 + 0.1 * cell()),
             e12=1e-2 * (1.0 + np.abs(cell())),
             sv=rng.uniform(0.0, 2.0, (nsv, NX, NY, NZ)))
    a["w"][..., 0] = a["w"][..., -1] = 0.0
    pl = lambda n: dict(
        u=1.0 + 0.1 * rng.standard_normal((n, NZ)),
        v=0.1 * rng.standard_normal((n, NZ)),
        w=0.1 * rng.standard_normal((n, NZ + 1)),
        thl=288.0 + rng.standard_normal((n, NZ)),
        qt=1e-3 + 1e-4 * rng.standard_normal((n, NZ)),
        e12=1e-3 + 1e-4 * rng.random((n, NZ)),
        sv=rng.uniform(0.0, 2.0, (nsv, n, NZ)))
    bx, by = pl(NY), pl(NX)
    jf = JFields(**{k: jnp.asarray(v) for k, v in a.items()})
    tf = TFields(**{k: t(v) for k, v in a.items()})
    jf = dataclasses.replace(
        jf, bx=jopen.XPlanes(**{k: jnp.asarray(v) for k, v in bx.items()}),
        by=jopen.YPlanes(**{k: jnp.asarray(v) for k, v in by.items()}))
    tf = dataclasses.replace(
        tf, bx=topen.XPlanes(**{k: t(v) for k, v in bx.items()}),
        by=topen.YPlanes(**{k: t(v) for k, v in by.items()}))
    return jf, tf


def scalar_contexts(direction, jf, tf, seed=3):
    """Open contexts whose inlet planes carry `NSV` scalar planes."""
    rng = np.random.default_rng(seed)
    ji, ti = both_inlets("profile")
    jctx, tctx = {}, {}
    for key, plane, n in (("openx", "bx", NY), ("openy", "by", NX)):
        if key[-1] not in direction:
            continue
        sv = rng.uniform(0.0, 2.0, (NSV, n, NZ))
        jin = {**ji.planes(jnp.asarray(0.0), n, NZ), "sv": jnp.asarray(sv)}
        tin = {**ti.planes(t(0.0), n, NZ), "sv": t(sv)}
        jctx[key] = {"inlet": jin, plane: getattr(jf, plane)}
        tctx[key] = {"inlet": tin, plane: getattr(tf, plane)}
    return jctx, tctx


# --- the scalar stack, function by function ---------------------------------

@pytest.mark.parametrize("direction", ["periodic", "x", "y", "xy"])
@pytest.mark.parametrize("bcs", [jconfig.BC_PROFILE, jconfig.BC_DRIVER],
                         ids=["profile", "driver"])
def test_make_ghosts_with_scalars_match_reference(direction, bcs):
    """make_ghosts on two scalars: the kappa-layout stack equals the
    reference's per-scalar ghosts (and the port's own ghost_scalar_kappa of
    each scalar), periodic and with open x, y or both."""
    b = dict(BCxs=bcs, BCxm=jconfig.BC_PROFILE)
    if "y" in direction:
        b.update(BCym=jconfig.BC_PROFILE)
    cfg = jconfig.Config(dtype="float64", bc=jconfig.BCConfig(**b))
    jg, tg = grids()
    jf, tf = both_fields(8)
    jctx, tctx = scalar_contexts(direction, jf, tf)
    rng = np.random.default_rng(9)
    ekm, ekh = (rng.uniform(0.5, 1.5, (NX, NY, NZ)) for _ in range(2))
    jgh = jbnd.make_ghosts(jf, jnp.asarray(ekm), jnp.asarray(ekh), cfg, jg,
                           **jctx)
    tgh = tbnd.make_ghosts(tf, t(ekm), t(ekh), cfg, tg, **tctx)
    assert tgh.sv.shape == (NSV, NX + 4, NY + 4, NZ + 4)
    assert_close(tgh.sv, jgh.sv, "sv")
    for n in range(NSV):
        assert torch.equal(tgh.sv[n], tbnd.ghost_scalar_kappa(
            tf.sv[n], cfg, sv_index=n, **tctx))
    for name in ("u", "v", "w", "thl", "ekm", "ekh"):
        assert_close(getattr(tgh, name), getattr(jgh, name), name)


def test_scalar_stack_tendencies_match_reference():
    """Kappa advection and masked diff_c of the whole stack in one call
    against the reference's vmap over the scalars (udales_tpu run.py:249,
    277-279), on a stretched grid."""
    cfg = jconfig.Config(dtype="float64")
    jg, tg = grids()
    jf, tf = both_fields(11)
    rng = np.random.default_rng(12)
    ekh = rng.uniform(0.5, 1.5, (NX, NY, NZ))
    jgh = jbnd.make_ghosts(jf, jnp.asarray(ekh), jnp.asarray(ekh), cfg, jg)
    tgh = tbnd.make_ghosts(tf, t(ekh), t(ekh), cfg, tg)
    M = (rng.uniform(size=(NX + 2, NY + 2, NZ + 2)) > 0.3).astype(float)
    ref_adv = jax.vmap(lambda gc: jadv.adv_kappa(gc, jgh, jg))(jgh.sv)
    assert_close(tadv.adv_kappa(tgh.sv, tgh, tg), ref_adv, "adv_kappa")
    gsv1 = jax.vmap(lambda s: s[1:-1, 1:-1, 1:-1])(jgh.sv)
    ref_diff = jax.vmap(lambda gc: jsgs.diff_c(gc, jgh.ekh, jg,
                                               M=jnp.asarray(M)))(gsv1)
    got = tsgs.diff_c(tgh.sv[:, 1:-1, 1:-1, 1:-1], tgh.ekh, tg, M=t(M))
    assert float(np.abs(np.asarray(ref_diff)).max()) > 1e-3
    assert_close(got, ref_diff, "diff_c")


# --- whole steps -------------------------------------------------------------

def flat_pair(nsv=0, **cfg_groups):
    """build_pair's flat case with `nsv` scalars (their start profiles in
    CaseInputs.scalar) and further config groups replaced."""
    jmodel, tmodel = build_pair(physics=dict(ltempeq=True))
    cfg_groups.setdefault("scalars", jconfig.ScalarsConfig(nsv=nsv))
    cfg = dataclasses.replace(jmodel.cfg, **cfg_groups)
    z = np.arange(NZ) + 0.5
    inputs = dataclasses.replace(jmodel.inputs, scalar=np.stack(
        [1.0 + 0.1 * n * z for n in range(nsv)]) if nsv else None)
    jm = JModel(cfg, jmodel.grid, inputs)
    tm = TModel(cfg, tmodel.grid, device="cpu")
    tm.inputs = inputs
    for k in ("dpdxl", "dpdyl", "ug", "vg", "thlpcar", "whls", "dqtdtls"):
        setattr(tm, k, getattr(tmodel, k))
    return jm, tm


def test_flat_scalars_with_point_sources_match_reference():
    """(i) two scalars released from point sources (one per scalar, one
    spanning the periodic x edge): 5 steps, every leaf to 1e-8."""
    jm, tm = flat_pair(nsv=2, scalars=jconfig.ScalarsConfig(
        nsv=2, lscasrc=True, nscasrc=1))
    pts = [np.array([[3.0, 4.0, 2.0, 5.0, 0.9]]),
           np.array([[0.5, 6.0, 3.0, 2.0, 1.1]])]
    jm.scalsources = JSources.build(jm.cfg, jm.grid, points=pts)
    tm.scalsources = TSources.build(tm.cfg, tm.grid, points=pts)
    jst = jm.cold_start(seed=3, dt0=0.02)
    sv0 = np.asarray(jst.c.sv).copy()
    jst, tst = run_both(jm, tm, jst)
    assert "c.sv" in compare_states(tst, jst)
    assert float(np.abs(tst.c.sv.numpy() - sv0).max()) > 1e-3


# --- scalars on the open boundaries ------------------------------------------

def test_profile_inlet_with_scalars_matches_reference():
    """(v) an open x boundary with a profile inlet that carries two scalar
    profiles (``Inlet.svprof``, the scalar planes of the outlet ``XPlanes``
    and of ``convect_planes``): 5 steps, every leaf to 1e-8 (the open-y
    scalar ghosts are held above)."""
    P = jconfig.BC_PROFILE
    jm, tm = flat_pair(nsv=2, bc=dataclasses.replace(
        build_pair()[0].cfg.bc, BCxm=P, BCxT=P, BCxq=P, BCxs=P))
    prof, sv = jm.inputs.prof, jm.inputs.scalar
    mk = lambda mod, a: mod.Inlet(
        mode=P, uprof=a(prof["u"]), vprof=a(prof["v"]), thlprof=a(prof["thl"]),
        qtprof=a(prof["qt"]), e12prof=a(np.maximum(prof["e12"], 5e-5)),
        svprof=a(sv))
    jm.inlet, tm.inlet = mk(jopen, jnp.asarray), mk(topen, t)
    jst, tst = run_both(jm, tm, jm.cold_start(seed=3, dt0=0.02))
    assert "c.bx.sv" in compare_states(tst, jst)
    assert float(tst.c.bx.sv.abs().max()) > 0


def add_scalar(case, expnr, nsv=1):
    """Switch `nsv` scalars on in a staged case: &SCALARS and a scalar.inp
    with a profile that grows with height."""
    nam = case / f"namoptions.{expnr}"
    nam.write_text(nam.read_text() + f"&SCALARS\nnsv = {nsv}\n/\n")
    z = np.loadtxt(case / f"prof.inp.{expnr}", skiprows=2)[:, 0]
    with open(case / f"scalar.inp.{expnr}", "w") as f:
        f.write("# scalar\n# z sv1\n")
        for zk in z:
            f.write(f"{zk:14.6f} " + " ".join(
                f"{0.5 + 0.05 * zk * (n + 1):12.6f}" for n in range(nsv))
                + "\n")


def test_driven_urban_with_a_scalar_matches_reference(tmp_path):
    """(v) the driven urban case (16^3, a rolling window of 8 of 24 records)
    with one scalar whose inflow planes come through the driver files: 5
    steps of both packages, every leaf (outlet planes and window included)
    to 1e-8; the inlet face carries the interpolated driver plane."""
    src = cases.stage_urban_driven(16, tmp_path / "stage", nt=24, chunk=8,
                                   dtdriver=0.05)
    case = tmp_path / "sv1"
    shutil.copytree(src, case)
    add_scalar(case, "900")
    times, planes = cases.driver_planes(16, 24, 0.05)
    planes["sv"] = np.random.default_rng(5).uniform(0.0, 3.0, (24, 1, 16, 16))
    tfiles.write_driver_files(case, "900", times, planes, 16, 16)
    jm = jload(case, "900", dtype="float64")
    tm = tload(case, "900", dtype="float64", device="cpu")
    assert tm.driver_stream.nsv == 1
    jst = jm.cold_start(seed=43)
    tst = state_from_numpy(jtree(jst.replace(ibmp=None)))
    jstep = jax.jit(jm.step)
    for _ in range(5):
        jst = jm.driver_stream.ensure(jst)
        tst = tm.driver_stream.ensure(tst)
        jst, tst = jstep(jst), tm.step(tst)
    names = compare_states(tst, jst.replace(ibmp=None))
    assert {"c.sv", "c.bx.sv", "m.bx.sv", "drv.sv"} <= set(names)
    want = topen.driver_window_planes(tst.drv, tst.timee)
    assert torch.equal(tst.c.u[0], want["u"])
    assert float(want["sv"].abs().max()) > 0


def test_recorded_replay_with_a_scalar_matches_reference(tmp_path):
    """(v) a flat precursor with one scalar, recorded by the port's
    DriverRecorder (the sv planes included) and replayed by both packages
    through load_case: 5 steps, every leaf to 1e-8; the replay's interior
    stays divergence-free."""
    case = cases.stage_precursor(12, tmp_path, dtdriver=0.1)
    for expnr in (cases.PRECURSOR_EXPNR, cases.REPLAY_EXPNR):
        add_scalar(case, expnr)
    pre = tload(case, cases.PRECURSOR_EXPNR, dtype="float64", device="cpu")
    rec = TRecorder(pre.cfg, pre.grid, case)
    st = pre.cold_start(seed=4)
    assert st.c.sv.shape[0] == 1
    for _ in range(10):
        st = pre.step(st)
        rec.maybe_record(st)
    assert len(rec.times) >= 4 and rec.frames[0]["sv"] is not None
    rec.save()
    h5 = case / f"driverdata.{cases.PRECURSOR_EXPNR}.h5"
    if h5.exists():
        h5.unlink()           # replay the reference-format files
    jm = jload(case, cases.REPLAY_EXPNR, dtype="float64")
    tm = tload(case, cases.REPLAY_EXPNR, dtype="float64", device="cpu")
    assert tm.inlet.sv.shape == (len(rec.times), 1, 12, 12)
    jst = jm.cold_start(seed=5)
    jst = jst.replace(timee=jnp.asarray(rec.times[0]))
    jst, tst = run_both(jm, tm, jst)
    assert "c.bx.sv" in compare_states(tst, jst)
    assert np.abs(open_divergence(tm, tst.c)[:, :, :-1]).max() < 1e-8
