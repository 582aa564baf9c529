"""The flat-ABL slice end to end: the port's Model.step against udales_tpu
(CPU, float64), plus the Model's own contracts.

Both packages start from the reference's initial State (jax.random noise),
carried into the port as numpy through udales_tpu_torch.convert.  The port
solves Poisson with torch.fft where the reference uses dense DFT matrices,
so trajectories drift apart at rounding level: the stated tolerance is
1e-8 relative to max|ref| after 10 steps.

The tests marked ``cuda`` hold one step on the card against the same step
on the CPU (16^3 float64, 1e-9): the driven urban case, the rescale-recycle
inlet and the three variants of the dispersion case; one step of two
ranks that share the card on a 2 x 1 mesh (gloo, host-staged) against the
single-process step on the card, one step of the urban 16^3 case on
four such ranks (2 x 2) against the same, and three steps of the driven
urban 16^3 case (its window refilled) on them.  They skip without a
card.  JAX and the JAX package are imported only inside the tests that need
them, so the file runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_step.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from udales_tpu_torch import entry
from udales_tpu_torch.config import (SGS_ONEEQN, ChemistryConfig,
                                     OutputConfig, PhysicsConfig,
                                     ScalarsConfig, SubgridConfig)
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
    import __graft_entry__ as ref_entry
    jmodel = ref_entry._build(16, 16, 16, "float64")
    tmodel = entry._build(16, 16, 16, "float64", device="cpu")
    load_profiles(tmodel, {k: np.asarray(getattr(jmodel, k))
                           for k in PROFILE_NAMES})
    return jmodel, tmodel


def test_ten_steps_match_reference(both_models):
    import jax
    import __graft_entry__ as ref_entry
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
    import __graft_entry__ as ref_entry
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
    fixed = entry._build(8, 8, 8, "float64", ladaptive=False,
                         device="cpu")
    assert float(fixed.new_dt(entry._init_state(fixed))) == 0.5


def test_state_roundtrip_and_entry():
    model = entry._build(8, 6, 4, "float32", device="cpu")
    st = entry._init_state(model, seed=5)
    back = state_from_numpy(state_to_numpy(st))
    for name in FIELD_NAMES:
        assert torch.equal(getattr(back.c, name), getattr(st.c, name))
    assert back.dt.dtype == torch.float32
    step, (state,) = entry.entry(device="cpu")
    assert state.c.u.shape == (64, 64, 64) and callable(step)


@pytest.mark.parametrize("cfg_change,name", [
    (dict(output=OutputConfig(lfielddump=True,
                              fieldvars="u0,tx,ty,tz,hf")),
     "wall-stress field dumps"),
], ids=["wall-stress-dumps"])
def test_unported_configurations_raise(both_models, cfg_change, name):
    """The wall-stress field dumps, which used to raise, now build: on the
    flat case (no IBM) State.taud after one step holds the floor's wall
    stress and heat flux, as udales_tpu's does (1e-12)."""
    import jax
    import __graft_entry__ as ref_entry
    from udales_tpu.run import Model as JModel
    jbase, tbase = both_models
    jmodel = JModel(dataclasses.replace(jbase.cfg, **cfg_change),
                    jbase.grid)
    for k in PROFILE_NAMES:
        setattr(jmodel, k, getattr(jbase, k))
    tmodel = Model(dataclasses.replace(tbase.cfg, **cfg_change), tbase.grid,
                   device="cpu")
    load_profiles(tmodel, {k: np.asarray(getattr(jbase, k))
                           for k in PROFILE_NAMES})
    assert tmodel.need_taudiag and jmodel.need_taudiag, name
    jst = ref_entry._init_state(jmodel)
    tst = state_from_numpy(jax_state_to_numpy(jst))
    tst = tmodel.step(tst.replace(taud={
        k: torch.zeros_like(tst.c.w if k == "z" else tst.c.u)
        for k in ("x", "y", "z", "hf")}))
    jst = jax.jit(jmodel.step)(jst.replace(taud={
        k: np.zeros_like(jst.c.w if k == "z" else jst.c.u)
        for k in ("x", "y", "z", "hf")}))
    for k in ("x", "y", "z", "hf"):
        ref = np.asarray(jst.taud[k])
        got = tst.taud[k].numpy()
        assert np.abs(got - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max())
    assert np.abs(got).max() == 0.0      # no wall heat flux on this case
    assert np.abs(tst.taud["x"].numpy()).max() > 0


@pytest.mark.parametrize("cfg_change,nsv", [
    (dict(scalars=ScalarsConfig(nsv=1)), 1),
    (dict(subgrid=SubgridConfig(loneeqn=True, model=SGS_ONEEQN)), 0),
    (dict(scalars=ScalarsConfig(nsv=3),
          chem=ChemistryConfig(lchem=True, k1=4.7e-4, JNO2=8.9e-3)), 3),
], ids=["scalars", "one-equation", "chemistry"])
def test_long_tail_configurations_match_reference(cfg_change, nsv):
    """Configurations that used to raise when the Model was built now run:
    the flat 16^3 case with passive scalars, with the one-equation closure
    and with the NOx-O3 chemistry on three scalars; 5 steps from the
    reference's State, u, v, w, e12, sv and pres to 1e-8."""
    import jax
    import jax.numpy as jnp
    import __graft_entry__ as ref_entry
    from udales_tpu.run import Model as JModel
    jbase = ref_entry._build(16, 16, 16, "float64")
    cfg = dataclasses.replace(jbase.cfg, **cfg_change)
    jmodel = JModel(cfg, jbase.grid)
    jmodel.dpdxl = jbase.dpdxl
    tbase = entry._build(16, 16, 16, "float64", device="cpu")
    tmodel = Model(cfg, tbase.grid, device="cpu")
    tmodel.dpdxl = tbase.dpdxl
    jst = ref_entry._init_state(jmodel)
    rng = np.random.default_rng(3)
    sv = jnp.asarray(rng.uniform(0.5, 2.0, (nsv, 16, 16, 16)))
    e12 = jst.m.e12 + 0.01 * jnp.asarray(rng.uniform(size=(16, 16, 16)))
    f = dataclasses.replace(jst.m, sv=sv, e12=e12)
    jst = jst.replace(m=f, c=f)
    tst = state_from_numpy(jax_state_to_numpy(jst))
    jstep = jax.jit(jmodel.step)
    for _ in range(5):
        jst, tst = jstep(jst), tmodel.step(tst)
    ref, got = jax_state_to_numpy(jst), state_to_numpy(tst)
    for name in ("u", "v", "w", "e12") + (("sv",) if nsv else ()):
        assert rel_err(got["c"][name], ref["c"][name]) <= RTOL, name
    assert rel_err(got["pres"], ref["pres"]) <= RTOL
    if nsv:
        assert float(np.abs(got["c"]["sv"] - np.asarray(sv)).max()) > 1e-6


@pytest.mark.parametrize("physics", [
    dict(igrw_damp=1), dict(ifixuinf=1), dict(ifixuinf=2, inletav=1.0),
    dict(ds=1.0),
], ids=["sponge", "fixuinf1", "fixuinf2", "shifted-pbc"])
def test_formerly_unported_configurations_match_reference(physics):
    """Branches that used to raise now run: the flat 16^3 case with each,
    5 steps from the reference's State, to 1e-8 (the wider set is in
    test_torch_openbc.py)."""
    import jax
    import __graft_entry__ as ref_entry
    from udales_tpu.run import Model as JModel
    jbase = ref_entry._build(16, 16, 16, "float64")
    cfg = dataclasses.replace(jbase.cfg, physics=PhysicsConfig(**physics),
                              bc=dataclasses.replace(jbase.cfg.bc, Uinf=1.2))
    jmodel = JModel(cfg, jbase.grid)
    jmodel.dpdxl = jbase.dpdxl
    tbase = entry._build(16, 16, 16, "float64", device="cpu")
    tmodel = Model(cfg, tbase.grid, device="cpu")
    tmodel.dpdxl = tbase.dpdxl
    jst = ref_entry._init_state(jmodel)
    if physics.get("ifixuinf") == 2:
        jst = jst.replace(ctl=jmodel.cold_start().ctl)
    d = jax_state_to_numpy(jst)
    if jst.ctl is not None:
        d["ctl"] = {k: np.asarray(getattr(jst.ctl, k))
                    for k in ("freestreamav", "dgdt", "dpdx_shift")}
    tst = state_from_numpy(d)
    jstep = jax.jit(jmodel.step)
    for _ in range(5):
        jst, tst = jstep(jst), tmodel.step(tst)
    ref, got = jax_state_to_numpy(jst), state_to_numpy(tst)
    for name in ("u", "v", "w"):
        assert rel_err(got["c"][name], ref["c"][name]) <= RTOL, name
    assert rel_err(got["pres"], ref["pres"]) <= RTOL
    if jst.ctl is not None:
        assert rel_err(got["ctl"]["dpdx_shift"],
                       np.asarray(jst.ctl.dpdx_shift)) <= RTOL


def test_run_is_repeated_step():
    model = entry._build(8, 8, 8, "float64", ladaptive=False, device="cpu")
    st0 = entry._init_state(model, seed=2)
    a = model.run(st0, 2)
    b = model.step(model.step(st0))
    assert torch.equal(a.c.u, b.c.u) and torch.equal(a.pres, b.pres)
    assert float(a.timee) == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["_build", "entry", "Model", "load_case"])
def test_entry_points_default_to_the_card(name):
    import inspect
    from udales_tpu_torch import run
    fn = {"_build": entry._build, "entry": entry.entry,
          "Model": Model.__init__, "load_case": run.load_case}[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_raises_without_a_card():
    """With no card the default raises what torch raises for a CUDA tensor;
    nothing continues on the CPU unasked.  With one, the model is on it."""
    if torch.cuda.is_available():
        assert entry._build(8, 8, 8).device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        entry._build(8, 8, 8)
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        entry.entry()


# --- on the card: one step against the same step on the CPU -------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def card_against_cpu(build, tol=1e-9):
    """`build(device)` -> (model, start State) on that device; one step of
    each (the rolling window refilled first where the model streams one),
    every State leaf of the card's within `tol` x max|cpu|.  Returns the
    names compared."""
    states = {}
    start = None
    for dev in ("cpu", "cuda"):
        model, st = build(dev)
        if start is None:
            start = state_to_numpy(st)
        st = state_from_numpy(start, device=dev)
        if model.driver_stream is not None:
            st = model.driver_stream.ensure(st)
        states[dev] = state_to_numpy(model.step(st))

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v
    ref = dict(leaves(states["cpu"]))
    for name, got in leaves(states["cuda"]):
        scale = float(np.abs(ref[name]).max(initial=0.0))
        err = float(np.abs(got - ref[name]).max(initial=0.0))
        assert err <= tol * max(scale, 1e-300), (name, err, scale)
    return sorted(ref)


def staged_builder(stage):
    from udales_tpu_torch.run import load_case

    def build(dev):
        model = load_case(stage(), "900", dtype="float64", device=dev)
        return model, model.cold_start(seed=43)
    return build


@pytest.mark.cuda
def test_driven_urban_step_on_card_matches_cpu(cuda, tmp_path):
    from udales_tpu_torch import cases
    names = card_against_cpu(staged_builder(
        lambda: cases.stage_urban_driven(16, tmp_path, nt=24, chunk=8,
                                         dtdriver=0.05)))
    assert {"c.bx.u", "drv.u", "pres"} <= set(names)


@pytest.mark.cuda
def test_recycle_step_on_card_matches_cpu(cuda):
    """The flat open-x case with the rescale-recycle inlet generator
    (iinletgen = 1, BCxm = 2) at 16^3."""
    from udales_tpu_torch.config import (BC_PROFILE, BCConfig, Config,
                                         DomainConfig, DriverConfig,
                                         RunConfig, const)
    from udales_tpu_torch.grid import Grid
    from udales_tpu_torch.ops.inletgen import InletGenParams, init_inletgen
    from udales_tpu_torch.ops.openbc import BC_RECYCLE, Inlet, init_xplanes
    from udales_tpu_torch.state import (initial_state, profile_fields,
                                        randomize)
    n = 16
    cfg = Config(
        domain=DomainConfig(itot=n, jtot=n, ktot=n, xlen=float(n),
                            ylen=float(n)),
        run=RunConfig(ladaptive=False, dtmax=0.02, lrandomize=False),
        physics=PhysicsConfig(ltempeq=True, inletav=5.0),
        bc=BCConfig(BCxm=BC_PROFILE, BCxT=BC_PROFILE, Uinf=2.0, thls=288.0,
                    thl_top=290.0, z0=0.03, z0h=0.003),
        driver=DriverConfig(iinletgen=1, iplane=n - 4, di=n / 2, dti=n / 2),
        dtype="float64")

    def build(dev):
        grid = Grid.uniform(n, n, n, float(n), float(n), float(n),
                            dtype=np.float64)
        model = Model(cfg, grid, device=dev)
        zf = grid.zf
        uprof = 2.0 * np.minimum(zf / (0.8 * zf[-1]), 1.0) ** 0.25
        thlprof = 288.0 + 2.0 * zf / zf[-1]
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
        model.inlet = Inlet(
            mode=BC_RECYCLE, uprof=t(uprof), vprof=t(np.zeros(n)),
            thlprof=t(thlprof), qtprof=t(np.zeros(n)),
            e12prof=t(np.full(n, const.e12min)),
            svprof=t(np.zeros((0, n))), irecy=n - 4)
        model.igparams = InletGenParams(cfg, grid)
        f = profile_fields(grid, uprof, np.zeros(n), thlprof, np.zeros(n),
                           np.full(n, const.e12min), device=dev)
        f = randomize(f, torch.Generator(device=dev).manual_seed(5), 0.05, n)
        f = dataclasses.replace(f, bx=init_xplanes(f, grid))
        st = initial_state(grid, f, dt0=0.02)
        return model, st.replace(ig=init_inletgen(cfg, grid, f,
                                                  model.igparams))
    assert {"ig.u0", "c.bx.u"} <= set(card_against_cpu(build))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [
    dict(), dict(purifiers=True, heatpumps=True), dict(sgs="oneeqn")],
    ids=["dispersion", "purifiers-heatpumps", "oneeqn"])
def test_dispersion_step_on_card_matches_cpu(cuda, tmp_path, variant):
    from udales_tpu_torch import cases
    names = card_against_cpu(staged_builder(
        lambda: cases.stage_urban_dispersion(16, tmp_path, **variant)))
    assert {"c.sv", "m.sv", "c.e12"} <= set(names)


@pytest.mark.cuda
def test_split_step_on_shared_card_matches_one_process(cuda, tmp_path):
    """Two ranks that share the card (gloo, host-staged exchanges) on a
    2 x 1 mesh: one adaptive flat step at 16^3 float64, gathered, against
    the single-process step on the card (every leaf to 1e-9); the kernel
    launches 3 times on each rank."""
    from torch_split_worker import free_port, launch
    model = entry._build(16, 16, 16, "float64", device="cuda")
    start = state_to_numpy(entry._init_state(model, seed=7))
    ref = state_to_numpy(model.step(state_from_numpy(start, device="cuda")))
    case = dict(name="flat", cfg=model.cfg, zf=model.grid.zf,
                dpdxl=np.full(16, -1e-4), state=start, steps=1)
    res = launch(dict(world=2, address=f"localhost:{free_port()}",
                      backend="gloo", device="cuda", host_staged=True,
                      timeout=60.0, mesh=(2, 1), cases=[case]), tmp_path)
    for r in res:
        out = r["cases"]["flat"]
        assert out["launches"] == 3
        got = out["gathered"]
        for part in ("m", "c"):
            for k in ("u", "v", "w", "thl", "e12"):
                scale = np.abs(ref[part][k]).max()
                err = np.abs(got[part][k] - ref[part][k]).max()
                assert err <= 1e-9 * scale, (part, k, err)
        for k in ("pres", "dt", "timee"):
            assert np.abs(got[k] - ref[k]).max() <= \
                1e-9 * np.abs(ref[k]).max(), k


@pytest.mark.cuda
def test_urban_split_on_shared_card_matches_one_process(cuda, tmp_path):
    """Four ranks that share the card (gloo, host-staged exchanges) on a
    2 x 2 mesh, each loading the urban 16^3 case with
    ``load_case(..., mesh=)``: one step, gathered, against the
    single-process step on the card (every leaf to 1e-9); the masked kernel
    launches 3 times on each rank."""
    from udales_tpu_torch import cases
    from udales_tpu_torch.run import load_case
    from torch_split_worker import free_port, launch
    case = cases.stage_urban(16, tmp_path)
    model = load_case(case, "900", dtype="float64", device="cuda")
    start = state_to_numpy(model.cold_start(seed=43))
    ref = state_to_numpy(model.step(state_from_numpy(start, device="cuda")))
    job = dict(name="urban", case_dir=str(case), expnr="900",
               dtype="float64", state=start, steps=1)
    res = launch(dict(world=4, address=f"localhost:{free_port()}",
                      backend="gloo", device="cuda", host_staged=True,
                      timeout=60.0, mesh=(2, 2), cases=[job]),
                 tmp_path / "ranks", timeout=300)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v
    want = dict(leaves(ref))
    for r in res:
        out = r["cases"]["urban"]
        assert out["masked"] == 3 and out["launches"] == 0
        for name, got in leaves(out["gathered"]):
            scale = float(np.abs(want[name]).max(initial=0.0))
            err = float(np.abs(got - want[name]).max(initial=0.0))
            assert err <= 1e-9 * max(scale, 1e-300), (name, err, scale)


@pytest.mark.cuda
def test_driven_split_on_shared_card_matches_one_process(cuda, tmp_path):
    """Four ranks that share the card on a 2 x 2 mesh, each loading the
    driven urban 16^3 case (records 0.05 s apart, 4 a window, so that the
    window is refilled) with ``load_case(..., mesh=)``: 3 steps, gathered,
    against the single-process steps on the card (every leaf, the outlet
    planes and the window included, to 1e-9); the masked kernel launches 3
    times a step on each rank."""
    from udales_tpu_torch import cases
    from udales_tpu_torch.run import load_case
    from torch_split_worker import free_port, launch
    case = cases.stage_urban_driven(16, tmp_path, nt=40, chunk=4,
                                    dtdriver=0.05)
    model = load_case(case, "900", dtype="float64", device="cuda")
    start = state_to_numpy(model.cold_start(seed=43))
    ref = state_to_numpy(model.run(state_from_numpy(start, device="cuda"),
                                   3))
    job = dict(name="driven", case_dir=str(case), expnr="900",
               dtype="float64", state=start, steps=3)
    res = launch(dict(world=4, address=f"localhost:{free_port()}",
                      backend="gloo", device="cuda", host_staged=True,
                      timeout=60.0, mesh=(2, 2), cases=[job]),
                 tmp_path / "ranks", timeout=300)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            elif v is not None:
                yield f"{prefix}{k}", v
    want = dict(leaves(ref))
    assert {"c.bx.u", "drv.u"} <= set(want)
    for r in res:
        out = r["cases"]["driven"]
        assert out["masked"] == 9 and out["launches"] == 0
        for name, got in leaves(out["gathered"]):
            scale = float(np.abs(want[name]).max(initial=0.0))
            err = float(np.abs(got - want[name]).max(initial=0.0))
            assert err <= 1e-9 * max(scale, 1e-300), (name, err, scale)
