"""Moist thermodynamics and the qt path of the PyTorch port against
udales_tpu (CPU, float64): the saturation adjustment (all-or-nothing and
Newton-Raphson), the moist branches of ``thermodynamics`` and whole steps
with ``lmoist`` (qt advected, diffused, fed by the floor flux and
integrated), plus the pressure top BC of the projection.

Inputs are made with numpy from a seed and fed through both packages.
Tolerances: 1e-12 * max(1, max|ref|) for the functions (same arithmetic
order), 1e-8 for 5 steps (torch.fft against dense DFT matrices).
"""
import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from udales_tpu import state as jstate
from udales_tpu.config import (BCTOPM_PRESSURE, BCConfig, Config,
                               DomainConfig, DynamicsConfig, PhysicsConfig,
                               RunConfig, WallsConfig)
from udales_tpu.grid import Grid as JGrid
from udales_tpu.ops import thermo as jthermo
from udales_tpu.run import Model as JModel

from udales_tpu_torch import state as tstate
from udales_tpu_torch.convert import (FIELD_NAMES, state_from_numpy,
                                      state_to_numpy)
from udales_tpu_torch.grid import Grid as TGrid
from udales_tpu_torch.ops import thermo as tthermo
from udales_tpu_torch.run import Model as TModel

RTOL = 1e-12
STEP_RTOL = 1e-8
NX, NY, NZ = 12, 10, 16
ZF = {"uniform": (np.arange(NZ) + 0.5) * 60.0,
      "stretched": np.cumsum(40.0 * 1.06 ** np.arange(NZ))
      - 20.0 * 1.06 ** np.arange(NZ)}


def assert_close(got, ref, rtol=RTOL, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = rtol * max(1.0, float(np.abs(ref).max(initial=0.0)))
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= tol, f"{what}: max abs err {err:.3e} > {tol:.3e}"


def config(lqlnr=False, **bc):
    return Config(
        domain=DomainConfig(itot=NX, jtot=NY, ktot=NZ, xlen=240.0,
                            ylen=200.0),
        run=RunConfig(ladaptive=True, dtmax=2.0),
        walls=WallsConfig(lbottom=True),
        physics=PhysicsConfig(ltempeq=True, lmoist=True, lbuoyancy=True),
        dynamics=DynamicsConfig(lqlnr=lqlnr),
        bc=BCConfig(z0=0.03, z0h=0.003, thls=290.0, qts=0.012,
                    wqsurf=2e-5, **bc),
        dtype="float64")


def grids(kind):
    args = (NX, NY, NZ, 240.0, 200.0, ZF[kind])
    return JGrid(*args, dtype=np.float64), TGrid(*args, dtype=np.float64)


def moist_fields(seed):
    """A moist boundary layer: qt above saturation in a layer aloft, so
    both branches of the adjustment and of calthv are taken."""
    rng = np.random.default_rng(seed)
    c3 = (NX, NY, NZ)
    k = np.arange(NZ)[None, None, :]
    w = 0.2 * rng.standard_normal((NX, NY, NZ + 1))
    w[..., 0] = w[..., NZ] = 0.0
    qt = 0.010 + 0.006 * np.exp(-((k - 10) / 3.0) ** 2) \
        + 5e-4 * rng.standard_normal(c3)
    return dict(u=2.0 + 0.3 * rng.standard_normal(c3),
                v=0.3 * rng.standard_normal(c3), w=w,
                thl=289.0 + 0.004 * 60.0 * k + 0.2 * rng.standard_normal(c3),
                qt=qt, e12=np.full(c3, 1e-3), sv=np.zeros((0,) + c3))


def both_fields(arr):
    return (jstate.Fields(**{k: jnp.asarray(a) for k, a in arr.items()}),
            tstate.Fields(**{k: torch.tensor(a) for k, a in arr.items()}))


@pytest.mark.parametrize("lqlnr", [False, True],
                         ids=["all-or-nothing", "newton-raphson"])
def test_ql_sat_adjust_matches_reference(lqlnr):
    rng = np.random.default_rng(1)
    shape = (6, 5, NZ)
    pres = np.linspace(1.0e5, 8.8e4, NZ)[None, None, :]
    exner = (pres / 1.0e5) ** (287.04 / 1004.0)
    thl = 288.0 + rng.uniform(-3, 6, shape)
    qt = rng.uniform(0.004, 0.02, shape)
    ref = jthermo.ql_sat_adjust(jnp.asarray(thl), jnp.asarray(qt),
                                jnp.asarray(pres), jnp.asarray(exner), lqlnr)
    got = tthermo.ql_sat_adjust(torch.tensor(thl), torch.tensor(qt),
                                torch.tensor(pres), torch.tensor(exner),
                                lqlnr)
    ref = np.asarray(ref)
    assert 0.2 < (ref > 0).mean() < 0.8      # both outcomes occur
    assert_close(got, ref)


def test_newton_raphson_freezes_once_converged():
    """The fixed-length loop with its device-side flag stops where the
    reference's while-loop does: more allowed iterations change nothing, and
    one iteration is not enough."""
    rng = np.random.default_rng(2)
    tl = torch.tensor(285.0 + rng.uniform(0, 10, (4, 4, 4)))
    qt = torch.tensor(rng.uniform(0.004, 0.02, (4, 4, 4)))
    pres = torch.full((4, 4, 4), 9.5e4, dtype=torch.float64)
    full = tthermo._ql_newton_raphson(tl, qt, pres)
    assert torch.equal(full, tthermo._ql_newton_raphson(tl, qt, pres,
                                                        maxit=80))
    assert not torch.equal(full, tthermo._ql_newton_raphson(tl, qt, pres,
                                                            maxit=1))


@pytest.mark.parametrize("kind", ["uniform", "stretched"])
@pytest.mark.parametrize("lqlnr", [False, True],
                         ids=["all-or-nothing", "newton-raphson"])
def test_moist_thermodynamics_matches_reference(kind, lqlnr):
    jgrid, tgrid = grids(kind)
    cfg = config(lqlnr)
    jf, tf = both_fields(moist_fields(3))
    jth = jthermo.thermodynamics(jf, cfg, jgrid)
    tth = tthermo.thermodynamics(tf, cfg, tgrid)
    assert float(jnp.max(jth.ql0)) > 1e-4
    for f in dataclasses.fields(tthermo.ThermoDiag):
        assert_close(getattr(tth, f.name), getattr(jth, f.name),
                     what=f.name)
    # the moist branch of calthv is taken somewhere, and differs from dry
    dry = tthermo._dthvdz_dry(tf.thl, tgrid)
    assert not torch.allclose(dry, tth.dthvdz)
    assert_close(tthermo._dthvdz_moist(tf, tth.ql0, tgrid, tth.exnf[:NZ]),
                 jthermo._dthvdz_moist(jf, jth.ql0, jgrid, jth.exnf[:NZ]))


def jax_state_to_numpy(st):
    fields = lambda f: {k: np.asarray(getattr(f, k)) for k in FIELD_NAMES}
    return {"m": fields(st.m), "c": fields(st.c), "pres": np.asarray(st.pres),
            "dt": np.asarray(st.dt), "timee": np.asarray(st.timee)}


STEP_CASES = {
    "moist": dict(cfg=config()),
    "moist-newton-raphson": dict(cfg=config(lqlnr=True)),
    "moist-stretched": dict(cfg=config(), kind="stretched"),
    "pressure-top": dict(cfg=config(BCtopm=BCTOPM_PRESSURE)),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_five_moist_steps_match_reference(case):
    """5 steps with lmoist: qt is advected, diffused, fed by the floor flux
    wqsurf and integrated; one case with the pressure top BC."""
    cfg = STEP_CASES[case]["cfg"]
    jgrid, tgrid = grids(STEP_CASES[case].get("kind", "uniform"))
    jmodel, tmodel = JModel(cfg, jgrid), TModel(cfg, tgrid, device="cpu")
    dpdx = np.full(NZ, -2e-4)
    jmodel.dpdxl = jnp.asarray(dpdx)
    tmodel.dpdxl = torch.tensor(dpdx)
    arr = moist_fields(4)
    start = {"m": arr, "c": arr, "pres": np.zeros((NX, NY, NZ)),
             "dt": np.asarray(0.5), "timee": np.asarray(0.0)}
    jf, _ = both_fields(arr)
    jst = jstate.initial_state(jgrid, jf, dt0=0.5)
    tst = state_from_numpy(start)
    jstep = jax.jit(jmodel.step)
    for _ in range(5):
        jst = jstep(jst)
        tst = tmodel.step(tst)
    ref, got = jax_state_to_numpy(jst), state_to_numpy(tst)
    for name in ("u", "v", "w", "thl", "qt"):
        assert_close(got["c"][name], ref["c"][name], STEP_RTOL, name)
        assert_close(got["m"][name], ref["m"][name], STEP_RTOL, name)
    assert_close(got["pres"], ref["pres"], STEP_RTOL, "pres")
    assert abs(float(got["dt"]) - float(ref["dt"])) \
        <= STEP_RTOL * float(ref["dt"])
    assert np.abs(ref["c"]["qt"] - arr["qt"]).max() > 1e-6   # qt moved
    if case == "pressure-top":
        assert np.abs(ref["c"]["w"][..., NZ]).max() > 0      # open lid
    else:
        assert np.abs(got["c"]["w"][..., NZ]).max() == 0
