"""The rescale-recycle inlet generator of the PyTorch port
(``ops/inletgen.py``) against udales_tpu (CPU, float64).

Each function on the same numpy-seeded inputs to 1e-12 * max(1, max|ref|);
whole steps with the generator active (with and without ``ltempeq``) from
one State to 1e-8 relative after 5 steps, the generator state ``State.ig``
included; the ``iinletgen = 2`` replay branch of ``load_case`` on an
``inletdata.<exp>.npz`` the test writes.
"""
import dataclasses

import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

import udales_tpu.config as jconfig
from udales_tpu.ops import inletgen as jig, openbc as jopen

import udales_tpu_torch.config as tconfig
from udales_tpu_torch.ops import inletgen as tig, openbc as topen

from test_torch_openbc import (assert_close, both_fields, build_pair,
                               compare_states, jtree, jtree_t, run_both, t)

NZ = 8


def boundary_layer(nz=NZ, seed=0):
    """A boundary-layer-like u and thl profile with a little noise."""
    rng = np.random.default_rng(seed)
    zf = np.arange(nz) + 0.5
    u = 2.0 * np.minimum(zf / (0.7 * zf[-1]), 1.0) ** 0.25 \
        + 0.01 * rng.random(nz)
    thl = 288.0 + 2.0 * zf / zf[-1] + 0.01 * rng.random(nz)
    return zf, u, thl


def fn_thickness():
    zf, u, thl = boundary_layer()
    dzf = np.ones(NZ)
    J, T = jnp.asarray, t
    flat = np.full(NZ, 288.0)
    return [
        ("momentumthicknessexp", tig.momentumthicknessexp(T(u), T(dzf)),
         jig.momentumthicknessexp(J(u), J(dzf))),
        ("enthalpythickness", tig.enthalpythickness(T(thl), T(u), T(dzf), 288.0),
         jig.enthalpythickness(J(thl), J(u), J(dzf), 288.0)),
        # the exact-zero regularizations: t(top) == thls, and a zero sum
        ("enthalpythickness flat",
         tig.enthalpythickness(T(flat), T(u), T(dzf), 288.0),
         jig.enthalpythickness(J(flat), J(u), J(dzf), 288.0)),
    ]


def fn_blthickness():
    zf, u, _ = boundary_layer()
    J, T = jnp.asarray, t
    cases = {"interior": u, "first level": np.linspace(1.0, 1.001, NZ),
             "never": np.linspace(1.0, 0.5, NZ)}
    out = []
    for label, prof in cases.items():
        for zh0 in (0.0, T(0.0)):
            jz = 0.0 if isinstance(zh0, float) else jnp.asarray(0.0)
            out.append((f"blthicknesst {label}",
                        tig.blthicknesst(T(prof), T(zf), zh0, 0.99),
                        jig.blthicknesst(J(prof), J(zf), jz, 0.99)))
    return out


def fn_wallaw():
    utan = np.array([1e-6, -1e-6, 0.5, -2.0, 5.0, 0.0])
    out = [("wallawinlet", tig.wallawinlet(t(utan), 0.1, 1.5e-5),
            jig.wallawinlet(jnp.asarray(utan), 0.1, 1.5e-5)),
           ("wallawinlet tensor dx",
            tig.wallawinlet(t(utan), t(0.25), 1.5e-5),
            jig.wallawinlet(jnp.asarray(utan), jnp.asarray(0.25), 1.5e-5))]
    # viscous limit: tau = 2 nu u / dz (tests/test_inletgen.py)
    tau = float(tig.wallawinlet(t(1e-6), 0.1, 1.5e-5))
    assert tau == pytest.approx(2 * 1.5e-5 * 1e-6 / 0.1, rel=1e-12)
    return out


def fn_interp():
    rng = np.random.default_rng(1)
    src_z = np.cumsum(0.5 + rng.random(NZ))
    src_v = rng.standard_normal(NZ)
    plane = rng.standard_normal((5, NZ))
    # below the first source point, inside, on a source point, above
    tgt = np.array([0.1, src_z[0] * 0.9, 2.0, src_z[3], 4.4, src_z[-1] + 1.0,
                    src_z[-1] + 5.0, 3.3])
    J, T = jnp.asarray, t
    return [
        ("_interp_profile",
         tig._interp_profile(T(src_z), T(src_v), T(tgt), 0.3, T(7.0)),
         jig._interp_profile(J(src_z), J(src_v), J(tgt), 0.3, J(7.0))),
        ("_interp_profile float top",
         tig._interp_profile(T(src_z), T(src_v), T(tgt), 0.0, -1.0),
         jig._interp_profile(J(src_z), J(src_v), J(tgt), 0.0, -1.0)),
        ("_interp_plane",
         tig._interp_plane(T(src_z), T(plane), T(tgt), 0.0, 0.0),
         jig._interp_plane(J(src_z), J(plane), J(tgt), 0.0, 0.0)),
    ]


def generator_pair(ltempeq=True, **driver):
    """Both packages' models of the configuration of
    tests/test_inletgen.py at 12 x 10 x 8, float64, generator on."""
    nx = 12
    jmodel, tmodel = build_pair(
        nx=nx, inlet_x=jopen.BC_RECYCLE,
        physics=dict(ltempeq=ltempeq, inletav=5.0),
        bc=dict(Uinf=2.0, thl_top=290.0),
        driver=dict(iinletgen=1, iplane=nx - 4, di=NZ / 2, dti=NZ / 2,
                    **driver))
    jmodel.igparams = jig.InletGenParams(jmodel.cfg, jmodel.grid)
    tmodel.igparams = tig.InletGenParams(tmodel.cfg, tmodel.grid)
    return jmodel, tmodel


def fn_params():
    jmodel, tmodel = generator_pair()
    jp, tp = jmodel.igparams, tmodel.igparams
    scalars = ("irecy", "irecym", "di", "dti", "inletav", "xfm", "xf2m",
               "thls", "thl_top", "Uinf")
    assert [getattr(tp, k) for k in scalars] \
        == [getattr(jp, k) for k in scalars]
    return [(k, getattr(tp, k), getattr(jp, k))
            for k in ("heavif", "heavih", "heavit")]


def fn_init_and_update(ltempeq=True, **driver):
    jmodel, tmodel = generator_pair(ltempeq, **driver)
    jf, tf = both_fields(2, planes=False)
    zf, u, thl = boundary_layer()
    shape = lambda p: p[None, None, :]
    jf = dataclasses.replace(jf, u=jf.u * 0.02 + shape(jnp.asarray(u)),
                             thl=jf.thl * 0.0 + shape(jnp.asarray(thl)))
    tf = dataclasses.replace(tf, u=tf.u * 0.02 + shape(t(u)),
                             thl=tf.thl * 0.0 + shape(t(thl)))
    j0 = jig.init_inletgen(jmodel.cfg, jmodel.grid, jf, jmodel.igparams)
    t0 = tig.init_inletgen(tmodel.cfg, tmodel.grid, tf, tmodel.igparams)
    out = [(f"init.{k}", v, jtree(j0)[k]) for k, v in jtree_t(t0).items()]
    jg, tg = j0, t0
    for rk3step in (1, 2, 3):
        jg = jig.inletgen_update(jg, jf, jmodel.cfg, jmodel.grid,
                                 jnp.asarray(0.02), rk3step, jmodel.igparams)
        tg = tig.inletgen_update(tg, tf, tmodel.cfg, tmodel.grid, t(0.02),
                                 rk3step, tmodel.igparams)
        out += [(f"update{rk3step}.{k}", v, jtree(jg)[k])
                for k, v in jtree_t(tg).items()]
    assert float(tg.w0[:, 0].abs().max()) == 0.0
    assert float(tg.w0[:, -1].abs().max()) == 0.0
    assert 0.0 < float(tg.utaui) < 1.0
    if not ltempeq:
        assert torch.equal(tg.t0, t0.t0)
    jpl = jig.inletgen_planes(jg, jmodel.inlet, 10, NZ)
    tpl = tig.inletgen_planes(tg, tmodel.inlet, 10, NZ)
    assert jpl.keys() == tpl.keys()
    out += [(f"planes.{k}", tpl[k], jpl[k]) for k in jpl]
    return out


INLETGEN_FUNCTIONS = {
    "thickness": fn_thickness,
    "blthicknesst": fn_blthickness,
    "wallawinlet": fn_wallaw,
    "interp": fn_interp,
    "InletGenParams": fn_params,
    "init update planes": fn_init_and_update,
    "update notemp": lambda: fn_init_and_update(ltempeq=False),
    "update fixed inlet, no wall function": lambda: fn_init_and_update(
        lfixinlet=True, lfixutauin=True, lwallfunc=False),
}


@pytest.mark.parametrize("name", sorted(INLETGEN_FUNCTIONS))
def test_inletgen_function_matches_reference(name):
    pairs = INLETGEN_FUNCTIONS[name]()
    assert pairs
    for label, got, ref in pairs:
        assert_close(got, ref, what=f"{name}/{label}")


@pytest.mark.parametrize("ltempeq", [True, False], ids=["temp", "notemp"])
def test_five_generator_steps_match_reference(ltempeq):
    """5 steps with the generator feeding the inlet, from udales_tpu's cold
    start: fields, outlet planes, pressure and every leaf of State.ig."""
    jmodel, tmodel = generator_pair(ltempeq)
    jst = jmodel.cold_start(seed=5, dt0=0.02)
    assert jst.ig is not None
    jst, tst = run_both(jmodel, tmodel, jst)
    names = compare_states(tst, jst)
    assert {"ig.Urec", "ig.u0", "ig.ddispdx", "c.bx.u"} <= set(names)
    # the inlet face is the generated plane
    assert torch.equal(tst.c.u[0], tst.ig.u0)
    assert bool(torch.isfinite(tst.ig.u0).all())


def test_generator_with_volume_flow_matches_reference():
    """luvolflowr: the mass-flux rescale of the generated plane, and the
    fixed outflow velocity."""
    nx = 12
    jmodel, tmodel = build_pair(
        nx=nx, inlet_x=jopen.BC_RECYCLE,
        physics=dict(ltempeq=True, inletav=5.0, luvolflowr=True,
                     uflowrate=1.2),
        bc=dict(Uinf=2.0, thl_top=290.0),
        driver=dict(iinletgen=1, iplane=nx - 4, di=NZ / 2, dti=NZ / 2))
    jmodel.igparams = jig.InletGenParams(jmodel.cfg, jmodel.grid)
    tmodel.igparams = tig.InletGenParams(tmodel.cfg, tmodel.grid)
    run_both(jmodel, tmodel, jmodel.cold_start(seed=6, dt0=0.02), nsteps=3)


def test_cold_start_builds_the_generator_state():
    _, tmodel = generator_pair()
    st = tmodel.cold_start(seed=1)
    assert st.ig is not None and st.c.bx is not None
    assert st.ig.u0.shape == (10, NZ) and st.ig.w0.shape == (10, NZ + 1)
    assert torch.allclose(st.ig.Uinl, st.c.u[0].mean(dim=0))
    st = tmodel.step(st)
    assert bool(torch.isfinite(st.c.u).all())


def write_flat_case(case, expnr, nx, ny, nz, extra):
    """A minimal flat case directory: namelist, prof.inp, lscale.inp."""
    case.mkdir(parents=True, exist_ok=True)
    z = np.arange(nz) + 0.5
    (case / f"namoptions.{expnr}").write_text(
        f"&RUN\niexpnr = {expnr}\nladaptive = .false.\ndtmax = 0.02\n/\n"
        f"&DOMAIN\nitot = {nx}\njtot = {ny}\nktot = {nz}\nxlen = {nx}.\n"
        f"ylen = {ny}.\n/\n&WALLS\nlbottom = .true.\n/\n"
        f"&PHYSICS\nltempeq = .true.\n/\n" + extra)
    rows = "\n".join(f"{zk:.4f} {288 + 0.05 * zk:.4f} 0.001 "
                     f"{1 + 0.05 * zk:.4f} 0.1 0.00005" for zk in z)
    (case / f"prof.inp.{expnr}").write_text("# prof\n# z thl qt u v tke\n"
                                           + rows + "\n")
    (case / f"lscale.inp.{expnr}").write_text(
        "# lscale\n# z ug vg pgx pgy wfls dqtdx dqtdy dqtdt dthlrad\n"
        + "\n".join(f"{zk:.4f} 0 0 0.0001 0 0 0 0 0 0" for zk in z) + "\n")
    return case


def test_load_case_builds_the_generator(tmp_path):
    """iinletgen = 1 through both load_case's: the same Inlet profiles and
    generator parameters, and 3 steps from one State agree."""
    from udales_tpu.run import load_case as jload
    from udales_tpu_torch.run import load_case as tload
    case = write_flat_case(
        tmp_path / "gen", "007", 12, 10, NZ,
        "&BC\nthls = 288.\nthl_top = 290.\nUinf = 2.\n/\n"
        "&DRIVER\niinletgen = 1\niplane = 8\n/\n&INLET\ndi = 4.\n/\n")
    jmodel = jload(case, "007", dtype="float64")
    tmodel = tload(case, "007", dtype="float64", device="cpu")
    assert tmodel.igparams is not None and tmodel.inlet.mode == topen.BC_RECYCLE
    assert tmodel.inlet.irecy == jmodel.inlet.irecy == 8
    assert tmodel.igparams.di == jmodel.igparams.di
    assert_close(tmodel.inlet.uprof, jmodel.inlet.uprof, "uprof")
    run_both(jmodel, tmodel, jmodel.cold_start(seed=4, dt0=0.02), nsteps=3)


def test_load_case_replays_recorded_generator_planes(tmp_path):
    """iinletgen = 2: load_case reads inletdata.<driverjobnr>.npz into a
    time-interpolating driver Inlet (BCxm stays as it is: a BCxm = 3 case
    takes its driver-file branch first); without the file it says what to
    do."""
    from udales_tpu.run import load_case as jload
    from udales_tpu_torch.run import load_case as tload
    ny = 10
    case = write_flat_case(
        tmp_path / "replay", "008", 12, ny, NZ,
        "&BC\nthls = 288.\n/\n"
        "&DRIVER\niinletgen = 2\ndriverjobnr = 7\n/\n")
    with pytest.raises(FileNotFoundError, match="iinletgen=1"):
        tload(case, "008", dtype="float64", device="cpu")
    rng = np.random.default_rng(8)
    nt = 5
    np.savez(case / "inletdata.007.npz", t=0.02 * np.arange(nt),
             u=1.0 + 0.05 * rng.standard_normal((nt, ny, NZ)),
             v=0.05 * rng.standard_normal((nt, ny, NZ)),
             w=0.02 * rng.standard_normal((nt, ny, NZ + 1)),
             thl=288.0 + 0.1 * rng.standard_normal((nt, ny, NZ)))
    jmodel = jload(case, "008", dtype="float64")
    tmodel = tload(case, "008", dtype="float64", device="cpu")
    assert tmodel.inlet.mode == tconfig.BC_DRIVER and tmodel.igparams is None
    for k in ("t", "u", "v", "w", "thl", "qt", "sv", "e12prof"):
        assert_close(getattr(tmodel.inlet, k), getattr(jmodel.inlet, k), k)
    jst, tst = run_both(jmodel, tmodel, jmodel.cold_start(seed=4, dt0=0.02),
                        nsteps=3)
    want = tmodel.inlet.planes(tst.timee, ny, NZ)["u"]
    assert torch.equal(tst.c.u[0], want)
