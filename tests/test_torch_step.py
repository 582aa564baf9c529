"""The flat-ABL slice end to end: the port's Model.step against udales_tpu
(CPU, float64), plus the Model's own contracts.

Both packages start from the reference's initial State (jax.random noise),
carried into the port as numpy through udales_tpu_torch.convert.  The port
solves Poisson with torch.fft where the reference uses dense DFT matrices,
so trajectories drift apart at rounding level: the stated tolerance is
1e-8 relative to max|ref| after 10 steps.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from udales_tpu.config import (BC_PROFILE, BCConfig, PhysicsConfig,
                               ScalarsConfig)

from udales_tpu_torch import entry
from udales_tpu_torch.convert import (FIELD_NAMES, PROFILE_NAMES,
                                      load_profiles, state_from_numpy,
                                      state_to_numpy)
from udales_tpu_torch.run import Model

RTOL = 1e-8


def jax_state_to_numpy(st):
    fields = lambda f: {k: np.asarray(getattr(f, k)) for k in FIELD_NAMES}
    return {"m": fields(st.m), "c": fields(st.c), "pres": np.asarray(st.pres),
            "dt": np.asarray(st.dt), "timee": np.asarray(st.timee)}


def rel_err(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def both_models():
    jmodel = ref_entry._build(16, 16, 16, "float64")
    tmodel = entry._build(16, 16, 16, "float64")
    load_profiles(tmodel, {k: np.asarray(getattr(jmodel, k))
                           for k in PROFILE_NAMES})
    return jmodel, tmodel


def test_ten_steps_match_reference(both_models):
    jmodel, tmodel = both_models
    jst = ref_entry._init_state(jmodel)
    tst = state_from_numpy(jax_state_to_numpy(jst))
    jstep = jax.jit(jmodel.step)
    for _ in range(10):
        jst = jstep(jst)
        tst = tmodel.step(tst)
    ref, got = jax_state_to_numpy(jst), state_to_numpy(tst)
    for name in ("u", "v", "w", "thl"):
        assert rel_err(got["c"][name], ref["c"][name]) <= RTOL, name
    assert rel_err(got["pres"], ref["pres"]) <= RTOL
    assert abs(float(got["dt"]) - float(ref["dt"])) <= RTOL * float(ref["dt"])
    assert abs(float(got["timee"]) - float(ref["timee"])) \
        <= RTOL * float(ref["timee"])


def test_step_keeps_time_on_device_and_divergence_free(both_models):
    _, tmodel = both_models
    st = tmodel.run(entry._init_state(tmodel, seed=1), 2)
    assert st.dt.dim() == 0 and st.timee.dim() == 0
    assert st.dt.dtype == torch.float64 and float(st.dt) > 0
    c, grid = st.c, tmodel.grid
    div = ((torch.roll(c.u, -1, 0) - c.u) * grid.dxi
           + (torch.roll(c.v, -1, 1) - c.v) * grid.dyi
           + (c.w[..., 1:] - c.w[..., :-1]) * grid.t("dzfi", "cpu"))
    assert float(div.abs().max()) < 1e-10


def test_new_dt_matches_reference(both_models):
    """Adaptive dt (CFL and diffusion limits) and the fixed-dt branch."""
    from udales_tpu.ops import subgrid as jsgs
    from udales_tpu.run import _velocity_ghosts as jvel
    from udales_tpu_torch.ops import subgrid as tsgs
    from udales_tpu_torch.run import _velocity_ghosts as tvel
    jmodel, tmodel = both_models
    jst = ref_entry._init_state(jmodel)
    # a violent start so the CFL limit, not dtmax, sets dt
    jst = jst.replace(m=jst.m.map(lambda a: a * 40.0))
    tst = state_from_numpy(jax_state_to_numpy(jst))
    cfg = jmodel.cfg
    jek = jsgs.closure(jvel(jst.m, cfg, jmodel.grid), jmodel.grid, cfg)
    tek = tsgs.closure(tvel(tst.m, cfg, tmodel.grid), tmodel.grid, cfg)
    ref = float(jmodel.new_dt(jst, jek[0], jek[1]))
    got = float(tmodel.new_dt(tst, tek[0], tek[1]))
    assert ref < cfg.run.dtmax and abs(got - ref) <= 1e-12 * ref
    fixed = entry._build(8, 8, 8, "float64", ladaptive=False)
    assert float(fixed.new_dt(entry._init_state(fixed))) == 0.5


def test_state_roundtrip_and_entry():
    model = entry._build(8, 6, 4, "float32")
    st = entry._init_state(model, seed=5)
    back = state_from_numpy(state_to_numpy(st))
    for name in FIELD_NAMES:
        assert torch.equal(getattr(back.c, name), getattr(st.c, name))
    assert back.dt.dtype == torch.float32
    step, (state,) = entry.entry()
    assert state.c.u.shape == (64, 64, 64) and callable(step)


@pytest.mark.parametrize("cfg_change", [
    dict(bc=BCConfig(BCxm=BC_PROFILE)),
    dict(physics=PhysicsConfig(lmoist=True)),
    dict(physics=PhysicsConfig(igrw_damp=1)),
    dict(physics=PhysicsConfig(ifixuinf=1)),
    dict(scalars=ScalarsConfig(nsv=1)),
], ids=["open-x", "moist", "sponge", "fixuinf", "scalars"])
def test_unported_configurations_raise(cfg_change):
    base = entry._build(8, 8, 8, "float64")
    with pytest.raises(NotImplementedError, match="not ported"):
        Model(dataclasses.replace(base.cfg, **cfg_change), base.grid)


def test_run_is_repeated_step():
    model = entry._build(8, 8, 8, "float64", ladaptive=False)
    st0 = entry._init_state(model, seed=2)
    a = model.run(st0, 2)
    b = model.step(model.step(st0))
    assert torch.equal(a.c.u, b.c.u) and torch.equal(a.pres, b.pres)
    assert float(a.timee) == pytest.approx(1.0)
