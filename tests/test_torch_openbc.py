"""Open boundaries and the remaining forces / advection branches of the
PyTorch port against udales_tpu (CPU, float64).

Function by function (``ops/openbc.py``, the open ghost builders of
``ops/boundary.py``, ``adv_kappa`` / ``adv_upw``, the five ``forces``
functions) the same numpy-seeded inputs go through both packages and agree
to 1e-12 * max(1, max|ref|).  Whole steps start from one State, made by
udales_tpu's ``cold_start`` and carried over as numpy, and agree to 1e-8
relative after 5 steps in every field, outlet plane, controller leaf and the
pressure.  The physical oracles of tests/test_openbc.py (inlet enforced,
interior divergence, outflux against influx) run on the port alone.

The helpers here (`jtree`, `build_pair`, `run_both`, `compare_states`) are
shared with test_torch_inletgen.py and test_torch_driver.py.
"""
import dataclasses
from types import SimpleNamespace

import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import torch

import udales_tpu.config as jconfig
from udales_tpu.grid import Grid as JGrid
from udales_tpu.io.inputs import CaseInputs as JCaseInputs
from udales_tpu.ops import (advection as jadv, boundary as jbnd,
                            forces as jforces, openbc as jopen)
from udales_tpu.run import Model as JModel
from udales_tpu.state import Fields as JFields

import udales_tpu_torch.config as tconfig
from udales_tpu_torch.convert import (PROFILE_NAMES, inlet_from_numpy,
                                      load_profiles, state_from_numpy,
                                      state_to_numpy)
from udales_tpu_torch.grid import Grid as TGrid
from udales_tpu_torch.io.inputs import CaseInputs as TCaseInputs
from udales_tpu_torch.ops import (advection as tadv, boundary as tbnd,
                                  forces as tforces, openbc as topen)
from udales_tpu_torch.run import Model as TModel
from udales_tpu_torch.state import Fields as TFields

RTOL = 1e-12
STEP_RTOL = 1e-8
NX, NY, NZ = 12, 10, 8


# --- shared helpers ----------------------------------------------------------

def jtree(obj):
    """A udales_tpu pytree (dataclasses, dicts, arrays, None) as nested
    dicts of numpy arrays, the form ``convert.state_from_numpy`` takes."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return {f.name: jtree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: jtree(v) for k, v in obj.items()}
    return np.asarray(obj)


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        elif v is not None:
            yield f"{prefix}{k}", v


def compare_states(tst, jst, rtol=STEP_RTOL):
    """Every leaf the port's State holds against the same leaf of the
    udales_tpu State: max|got - ref| <= rtol * max|ref| (a leaf that is
    zero in the reference must be zero)."""
    ref = dict(leaves(jtree(jst)))
    got = dict(leaves(state_to_numpy(tst)))
    assert got, "empty state"
    for name, g in got.items():
        r = ref[name]
        assert g.shape == r.shape, (name, g.shape, r.shape)
        scale = float(np.abs(r).max(initial=0.0))
        err = float(np.abs(g - r).max(initial=0.0))
        assert err <= rtol * scale, \
            f"{name}: max abs err {err:.3e} > {rtol:g} x {scale:.3e}"
    return sorted(got)


def assert_close(got, ref, what="", rtol=RTOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = rtol * max(1.0, float(np.abs(ref).max(initial=0.0)))
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= tol, f"{what}: max abs err {err:.3e} > {tol:.3e}"


def t(a):
    return torch.tensor(np.asarray(a))


def make_cfg(mod, nx=NX, ny=NY, nz=NZ, run=None, physics=None, bc=None,
             **groups):
    """The same Config from either package's config module (`mod`)."""
    run = {**dict(ladaptive=False, dtmax=0.02, lrandomize=True, randu=0.02,
                  krand=nz), **(run or {})}
    bc = {**dict(z0=0.01, z0h=0.001, thls=288.0), **(bc or {})}
    extra = {k: getattr(mod, {"driver": "DriverConfig",
                              "dynamics": "DynamicsConfig",
                              "domain": "DomainConfig"}[k])(**v)
             for k, v in groups.items() if k != "domain"}
    return mod.Config(
        domain=mod.DomainConfig(itot=nx, jtot=ny, ktot=nz, xlen=float(nx),
                                ylen=float(ny), **groups.get("domain", {})),
        run=mod.RunConfig(**run),
        physics=mod.PhysicsConfig(**(physics or {})),
        walls=mod.WallsConfig(lbottom=True), bc=mod.BCConfig(**bc),
        dtype="float64", **extra)


def case_inputs(cls, nz, wfls=0.0, dqtdt=0.0):
    """prof.inp / lscale.inp contents as either package's CaseInputs: a
    sheared u, a weak v, a stable thl, some moisture."""
    z = np.arange(nz) + 0.5
    prof = dict(zf=z, thl=288.0 + 0.05 * z, qt=1e-3 + 1e-5 * z,
                u=1.0 + 0.05 * z, v=0.1 + 0.0 * z, e12=np.full(nz, 5e-5))
    zero = np.zeros(nz)
    lscale = dict(z=z, ug=np.full(nz, 1.2), vg=np.full(nz, 0.1),
                  pgx=np.full(nz, 1e-4), pgy=zero, wfls=wfls * z / nz,
                  dqtdx=zero, dqtdy=zero, dqtdt=np.full(nz, dqtdt),
                  thlpcar=zero)
    return cls(prof=prof, lscale=lscale, scalar=None)


def profile_inlet(mod_open, mode, prof, asarray, irecy=0):
    nz = len(prof["u"])
    a = asarray
    return mod_open.Inlet(
        mode=mode, uprof=a(prof["u"]), vprof=a(prof["v"]),
        thlprof=a(prof["thl"]), qtprof=a(prof["qt"]),
        e12prof=a(np.maximum(prof["e12"], 5e-5)),
        svprof=a(np.zeros((0, nz))), irecy=irecy)


def build_pair(nx=NX, ny=NY, nz=NZ, inlet_x=None, inlet_y=None, wfls=0.0,
               dqtdt=0.0, **cfg_kw):
    """(udales_tpu Model, port Model) of one configuration with the same
    case inputs; `inlet_x` / `inlet_y` is None or an inlet mode
    (BC_PROFILE, BC_RECYCLE) built from the inputs' profiles."""
    jcfg, tcfg = make_cfg(jconfig, nx, ny, nz, **cfg_kw), \
        make_cfg(tconfig, nx, ny, nz, **cfg_kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    size = (nx, ny, nz, float(nx), float(ny), float(nz))
    jin = case_inputs(JCaseInputs, nz, wfls, dqtdt)
    jmodel = JModel(jcfg, JGrid.uniform(*size, dtype=np.float64), jin)
    tmodel = TModel(tcfg, TGrid.uniform(*size, dtype=np.float64),
                    device="cpu")
    tmodel.inputs = case_inputs(TCaseInputs, nz, wfls, dqtdt)
    tmodel.has_lstend = jmodel.has_lstend
    load_profiles(tmodel, {k: np.asarray(getattr(jmodel, k))
                           for k in PROFILE_NAMES})
    for attr, mode in (("inlet", inlet_x), ("inlet_y", inlet_y)):
        if mode is not None:
            setattr(jmodel, attr, profile_inlet(jopen, mode, jin.prof,
                                                jnp.asarray, irecy=nx - 4))
            setattr(tmodel, attr, profile_inlet(topen, mode, jin.prof, t,
                                                irecy=nx - 4))
    return jmodel, tmodel


def run_both(jmodel, tmodel, jst, nsteps=5, rtol=STEP_RTOL):
    """`nsteps` steps of both packages from the udales_tpu State `jst`
    (refilling the rolling window where the models stream one); compares
    every leaf and returns both final States."""
    tst = state_from_numpy(jtree(jst))
    jstep = jax.jit(jmodel.step)
    for _ in range(nsteps):
        if jmodel.driver_stream is not None:
            jst = jmodel.driver_stream.ensure(jst)
            tst = tmodel.driver_stream.ensure(tst)
        jst = jstep(jst)
        tst = tmodel.step(tst)
    compare_states(tst, jst, rtol)
    return jst, tst


def open_divergence(model, c):
    """div u of the port's Fields with the open outlet faces from bx / by
    and periodic wrap elsewhere."""
    grid = model.grid
    uf = torch.cat([c.u, (c.bx.u if c.bx is not None else c.u[0])[None]], 0)
    vf = torch.cat([c.v, (c.by.v if c.by is not None
                          else c.v[:, 0])[:, None]], 1)
    return ((uf[1:] - uf[:-1]) * grid.dxi + (vf[:, 1:] - vf[:, :-1])
            * grid.dyi + (c.w[:, :, 1:] - c.w[:, :, :-1])
            * grid.t("dzfi", "cpu")).numpy()


# --- (a) ops/openbc.py, function by function -------------------------------

def both_fields(seed, nx=NX, ny=NY, nz=NZ, planes=True):
    """The same random Fields (with outlet planes) for both packages."""
    rng = np.random.default_rng(seed)
    cell = lambda: rng.standard_normal((nx, ny, nz))
    a = dict(u=1.0 + 0.1 * cell(), v=0.1 * cell(),
             w=0.1 * rng.standard_normal((nx, ny, nz + 1)),
             thl=288.0 + cell(), qt=1e-3 * (1.0 + 0.1 * cell()),
             e12=1e-3 * (2.0 + np.abs(cell())), sv=np.zeros((0, nx, ny, nz)))
    jf = JFields(**{k: jnp.asarray(v) for k, v in a.items()})
    tf = TFields(**{k: t(v) for k, v in a.items()})
    if planes:
        pl = lambda n: dict(
            u=1.0 + 0.1 * rng.standard_normal((n, nz)),
            v=0.1 * rng.standard_normal((n, nz)),
            w=0.1 * rng.standard_normal((n, nz + 1)),
            thl=288.0 + rng.standard_normal((n, nz)),
            qt=1e-3 + 1e-4 * rng.standard_normal((n, nz)),
            e12=1e-3 + 1e-4 * rng.random((n, nz)),
            sv=np.zeros((0, n, nz)))
        bx, by = pl(ny), pl(nx)
        jf = dataclasses.replace(
            jf, bx=jopen.XPlanes(**{k: jnp.asarray(v) for k, v in bx.items()}),
            by=jopen.YPlanes(**{k: jnp.asarray(v) for k, v in by.items()}))
        tf = dataclasses.replace(
            tf, bx=topen.XPlanes(**{k: t(v) for k, v in bx.items()}),
            by=topen.YPlanes(**{k: t(v) for k, v in by.items()}))
    return jf, tf


def driver_series(seed, nt=6, ny=NY, nz=NZ):
    rng = np.random.default_rng(seed)
    tt = np.cumsum(0.03 + 0.01 * rng.random(nt))
    return dict(t=tt, u=1.0 + 0.1 * rng.standard_normal((nt, ny, nz)),
                v=0.1 * rng.standard_normal((nt, ny, nz)),
                w=0.05 * rng.standard_normal((nt, ny, nz + 1)),
                thl=288.0 + rng.standard_normal((nt, ny, nz)),
                qt=1e-3 + 1e-4 * rng.standard_normal((nt, ny, nz)))


def both_inlets(mode, seed=3):
    prof = case_inputs(JCaseInputs, NZ).prof
    if mode == "profile":
        return (profile_inlet(jopen, jconfig.BC_PROFILE, prof, jnp.asarray),
                profile_inlet(topen, tconfig.BC_PROFILE, prof, t))
    d = driver_series(seed)
    return (jopen.Inlet(mode=jconfig.BC_DRIVER,
                        **{k: jnp.asarray(v) for k, v in d.items()}),
            inlet_from_numpy({"mode": tconfig.BC_DRIVER, **d}))


def planes_pairs(got, ref, label):
    assert got.keys() == ref.keys()
    return [(f"{label}.{k}", got[k], ref[k]) for k in ref
            if ref[k] is not None or got[k] is not None]


def fn_inlet_profile():
    ji, ti = both_inlets("profile")
    return planes_pairs(ti.planes(t(0.3), NY, NZ),
                        ji.planes(jnp.asarray(0.3), NY, NZ), "profile")


def fn_inlet_driver():
    """Inside a record interval, on a record, before the first and after the
    last record (clamped)."""
    ji, ti = both_inlets("driver")
    out = []
    for time in (0.07, float(ji.t[2]), 0.0, 9.0):
        out += planes_pairs(ti.planes(t(time), NY, NZ),
                            ji.planes(jnp.asarray(time), NY, NZ), f"t={time}")
    got = ti.planes(t(9.0), NY, NZ)["u"]
    assert torch.equal(got, ti.u[-1])
    neutral = dataclasses.replace(ti, thl=None, qt=None)
    assert float(neutral.planes(t(0.07), NY, NZ)["thl"].abs().max()) == 0.0
    return out


def fn_driver_window():
    d = driver_series(4)
    d["sv"] = np.zeros((len(d["t"]), 0, NY, NZ))
    jw = jopen.DriverWindow(**{k: jnp.asarray(v) for k, v in d.items()})
    tw = topen.DriverWindow(**{k: t(v) for k, v in d.items()})
    out = []
    for time in (0.05, 0.11, 5.0):
        out += planes_pairs(topen.driver_window_planes(tw, t(time)),
                            jopen.driver_window_planes(jw, jnp.asarray(time)),
                            f"t={time}")
    return out


def fn_recycle():
    jf, tf = both_fields(5)
    prof = case_inputs(JCaseInputs, NZ).prof
    ji = profile_inlet(jopen, jopen.BC_RECYCLE, prof, jnp.asarray, irecy=NX + 3)
    ti = profile_inlet(topen, topen.BC_RECYCLE, prof, t, irecy=NX + 3)
    return planes_pairs(topen.recycle_planes(ti, tf, NY, NZ),
                        jopen.recycle_planes(ji, jf, NY, NZ), "recycle")


def fn_outflow_velocity():
    rng = np.random.default_rng(6)
    av = 1.0 + 0.1 * rng.standard_normal(NZ)
    out = []
    for fixed in (False, True):
        kw = dict(physics=dict(luvolflowr=fixed, lvvolflowr=fixed,
                               uflowrate=1.3, vflowrate=0.4))
        jcfg, tcfg = make_cfg(jconfig, **kw), make_cfg(tconfig, **kw)
        size = (NX, NY, NZ, float(NX), float(NY), float(NZ))
        jg, tg = JGrid.uniform(*size, dtype=np.float64), \
            TGrid.uniform(*size, dtype=np.float64)
        out += [(f"uouttot fixed={fixed}", topen.uouttot_value(tcfg, t(av), tg),
                 jopen.uouttot_value(jcfg, jnp.asarray(av), jg)),
                (f"vouttot fixed={fixed}", topen.vouttot_value(tcfg, t(av), tg),
                 jopen.vouttot_value(jcfg, jnp.asarray(av), jg))]
    return out


def fn_planes_init_and_convect():
    jf, tf = both_fields(7)
    size = (NX, NY, NZ, float(NX), float(NY), float(NZ))
    jg, tg = JGrid.uniform(*size, dtype=np.float64), \
        TGrid.uniform(*size, dtype=np.float64)
    out = planes_pairs(jtree_t(topen.init_xplanes(tf, tg)),
                       jtree(jopen.init_xplanes(jf, jg)), "init_x")
    out += planes_pairs(jtree_t(topen.init_yplanes(tf, tg)),
                        jtree(jopen.init_yplanes(jf, jg)), "init_y")
    out += planes_pairs(
        jtree_t(topen.convect_planes(tf.bx, tf, tg, t(0.01), t(1.2), None)),
        jtree(jopen.convect_planes(jf.bx, jf, jg, jnp.asarray(0.01),
                                   jnp.asarray(1.2), None)), "convect_x")
    out += planes_pairs(
        jtree_t(topen.convect_planes_y(tf.by, tf, tg, t(0.01), t(0.3), None)),
        jtree(jopen.convect_planes_y(jf.by, jf, jg, jnp.asarray(0.01),
                                     jnp.asarray(0.3), None)), "convect_y")
    out.append(("pad_x_open", topen.pad_x_open(tf.u, tf.bx.u, tf.bx.v, 2),
                jopen.pad_x_open(jf.u, jf.bx.u, jf.bx.v, 2)))
    return out


def jtree_t(obj):
    """A port dataclass of tensors as a dict of numpy arrays."""
    return {f.name: getattr(obj, f.name).numpy()
            for f in dataclasses.fields(obj)}


OPENBC_FUNCTIONS = {
    "Inlet.planes profile": fn_inlet_profile,
    "Inlet.planes driver": fn_inlet_driver,
    "driver_window_planes": fn_driver_window,
    "recycle_planes": fn_recycle,
    "uouttot vouttot": fn_outflow_velocity,
    "init and convect planes": fn_planes_init_and_convect,
}


@pytest.mark.parametrize("name", sorted(OPENBC_FUNCTIONS))
def test_openbc_function_matches_reference(name):
    pairs = OPENBC_FUNCTIONS[name]()
    assert pairs
    for label, got, ref in pairs:
        assert_close(got, ref, what=f"{name}/{label}")


# --- (b) the open ghost builders ------------------------------------------

def contexts(direction, jf, tf, bcmode):
    """(openx, openy) context dicts of both packages for `direction` in
    "x", "y", "xy"; the inlet is a profile (BC_PROFILE) or driver planes."""
    ji, ti = both_inlets("profile" if bcmode == jconfig.BC_PROFILE
                         else "driver")
    jctx, tctx = {}, {}
    if "x" in direction:
        jctx["openx"] = {"inlet": ji.planes(jnp.asarray(0.07), NY, NZ),
                         "bx": jf.bx}
        tctx["openx"] = {"inlet": ti.planes(t(0.07), NY, NZ), "bx": tf.bx}
    if "y" in direction:
        jp, tp = both_inlets("profile")
        jctx["openy"] = {"inlet": jp.planes(jnp.asarray(0.0), NX, NZ),
                         "by": jf.by}
        tctx["openy"] = {"inlet": tp.planes(t(0.0), NX, NZ), "by": tf.by}
    return jctx, tctx


@pytest.mark.parametrize("bcmode", [jconfig.BC_PROFILE, jconfig.BC_DRIVER],
                         ids=["profile", "driver"])
@pytest.mark.parametrize("direction", ["x", "y", "xy"])
def test_open_ghosts_match_reference(direction, bcmode):
    """Every ghost builder with the open contexts (h = 1), the kappa ghosts
    (h = 2) and make_ghosts as a whole, under a no-slip top with a flux."""
    b = dict(BCxm=bcmode, BCxT=bcmode, BCxq=bcmode, BCxs=bcmode,
             BCtopm=jconfig.BCTOPM_NOSLIP, Uinf=1.0, wttop=0.01)
    if "y" in direction:
        b.update(BCym=jconfig.BC_PROFILE, BCyT=jconfig.BC_PROFILE)
    jcfg, tcfg = make_cfg(jconfig, bc=b), make_cfg(tconfig, bc=b)
    size = (NX, NY, NZ, float(NX), float(NY), float(NZ))
    jg, tg = JGrid.uniform(*size, dtype=np.float64), \
        TGrid.uniform(*size, dtype=np.float64)
    jf, tf = both_fields(8)
    jctx, tctx = contexts(direction, jf, tf, bcmode)
    rng = np.random.default_rng(9)
    ekm = rng.uniform(0.5, 1.5, (NX, NY, NZ))
    ekh = rng.uniform(0.5, 1.5, (NX, NY, NZ))
    jgh = jbnd.make_ghosts(jf, jnp.asarray(ekm), jnp.asarray(ekh), jcfg, jg,
                           **jctx)
    tgh = tbnd.make_ghosts(tf, t(ekm), t(ekh), tcfg, tg, **tctx)
    for name in ("u", "v", "w", "thl", "qt", "e12", "ekm", "ekh"):
        assert_close(getattr(tgh, name), getattr(jgh, name), name)
    assert tgh.u.shape == (NX + 2, NY + 2, NZ + 2)
    # the kappa ghosts read the sv slot of the contexts
    def with_sv(ctx, stack):
        out = {}
        for key, v in ctx.items():
            pk = "bx" if key == "openx" else "by"
            out[key] = {
                "inlet": {**v["inlet"], "sv": stack([v["inlet"]["thl"]])},
                pk: dataclasses.replace(v[pk], sv=stack([v[pk].thl]))}
        return out
    jk = jbnd.ghost_scalar_kappa(jf.thl, jcfg, **with_sv(jctx, jnp.stack))
    tk = tbnd.ghost_scalar_kappa(tf.thl, tcfg, **with_sv(tctx, torch.stack))
    assert tk.shape == (NX + 4, NY + 4, NZ + 4)
    assert_close(tk, jk, "ghost_scalar_kappa")


def test_open_xy_ghost_corners():
    """The x planes attach first, the y planes fill the corners (the
    reference's xm-then-ym ordering; tests/test_openxy.py)."""
    nx = ny = 4
    full = lambda shape, v: torch.full(shape, v, dtype=torch.float64)
    g = tbnd._assemble_xy(torch.zeros((nx, ny, 3), dtype=torch.float64), 1,
                          full((ny, 3), 1.0), full((ny, 3), 2.0),
                          full((nx, 3), 3.0), full((nx, 3), 4.0))
    assert g.shape == (nx + 2, ny + 2, 3)
    assert float(g[0, 2, 0]) == 1.0 and float(g[-1, 2, 0]) == 2.0
    assert float(g[2, 0, 0]) == 3.0 and float(g[2, -1, 0]) == 4.0
    assert float(g[0, 0, 0]) == 3.0 and float(g[-1, -1, 0]) == 4.0


# --- (c) kappa / upwind advection -------------------------------------------

@pytest.mark.parametrize("scheme", ["adv_kappa", "adv_upw"])
@pytest.mark.parametrize("stretched", [False, True],
                         ids=["uniform", "stretched"])
def test_scalar_advection_matches_reference(scheme, stretched):
    zf = (np.cumsum(1.1 ** np.arange(NZ)) - 0.5 * 1.1 ** np.arange(NZ)
          if stretched else np.arange(NZ) + 0.5)
    jg = JGrid(NX, NY, NZ, float(NX), float(NY), zf, dtype=np.float64)
    tg = TGrid(NX, NY, NZ, float(NX), float(NY), zf, dtype=np.float64)
    jcfg, tcfg = make_cfg(jconfig), make_cfg(tconfig)
    jf, tf = both_fields(10, planes=False)
    jgc = jbnd.ghost_scalar_kappa(jf.thl, jcfg)
    tgc = tbnd.ghost_scalar_kappa(tf.thl, tcfg)
    assert_close(tgc, jgc, "ghosts")
    jg_, tg_ = (SimpleNamespace(u=gu(f.u, cfg), v=gv(f.v, cfg),
                                w=gw(f.w, cfg))
                for f, cfg, gu, gv, gw in (
                    (jf, jcfg, jbnd.ghost_u, jbnd.ghost_v, jbnd.ghost_w),
                    (tf, tcfg, tbnd.ghost_u, tbnd.ghost_v, tbnd.ghost_w)))
    got = getattr(tadv, scheme)(tgc, tg_, tg)
    ref = getattr(jadv, scheme)(jgc, jg_, jg)
    assert float(np.abs(np.asarray(ref)).max()) > 1e-3
    assert_close(got, ref, scheme)


# --- (d) ops/forces.py ------------------------------------------------------

def forces_env(**physics):
    kw = dict(physics=physics)
    jcfg, tcfg = make_cfg(jconfig, **kw), make_cfg(tconfig, **kw)
    size = (NX, NY, NZ, float(NX), float(NY), float(NZ))
    jg, tg = JGrid.uniform(*size, dtype=np.float64), \
        TGrid.uniform(*size, dtype=np.float64)
    jf, tf = both_fields(11, planes=False)
    rng = np.random.default_rng(12)
    av = {k: rng.standard_normal(NZ) for k in ("u", "v", "thl", "qt")}
    return jcfg, tcfg, jg, tg, jf, tf, av, rng


def fn_grwdamp(igrw, lcoriol=False, ksp=-1):
    jcfg, tcfg, jg, tg, jf, tf, av, rng = forces_env(igrw_damp=igrw,
                                                     lcoriol=lcoriol)
    if ksp > 0:
        dom = lambda cfg, mod: dataclasses.replace(
            cfg, domain=dataclasses.replace(cfg.domain, ksp=ksp))
        jcfg, tcfg = dom(jcfg, jconfig), dom(tcfg, tconfig)
    ug, vg = rng.standard_normal(NZ), rng.standard_normal(NZ)
    got = tforces.grwdamp(tf, tg, tcfg, *(t(av[k]) for k in av), t(ug), t(vg))
    ref = jforces.grwdamp(jf, jg, jcfg, *(jnp.asarray(av[k]) for k in av),
                          jnp.asarray(ug), jnp.asarray(vg))
    assert float(np.abs(np.asarray(ref[0])).max()) > 0 or igrw == 0
    return [(f"grwdamp[{i}]", g, r) for i, (g, r) in enumerate(zip(got, ref))]


def fn_nudge_top():
    jcfg, tcfg, jg, tg, jf, tf, av, rng = forces_env(lnudge=True, nnudge=3,
                                                     tnudge=45.0)
    tgt = [rng.standard_normal(NZ) for _ in range(4)]
    got = tforces.nudge_top(tf, tg, tcfg, *map(t, tgt), u0av=t(av["u"]),
                            v0av=t(av["v"]), thl0av=t(av["thl"]),
                            qt0av=t(av["qt"]))
    ref = jforces.nudge_top(jf, jg, jcfg, *map(jnp.asarray, tgt),
                            u0av=jnp.asarray(av["u"]),
                            v0av=jnp.asarray(av["v"]),
                            thl0av=jnp.asarray(av["thl"]),
                            qt0av=jnp.asarray(av["qt"]))
    assert float(np.abs(np.asarray(ref[0])[..., :3]).max()) == 0.0
    return [(f"nudge[{i}]", g, r) for i, (g, r) in enumerate(zip(got, ref))]


def fn_lstend(lmomsubs):
    jcfg, tcfg, jg, tg, jf, tf, av, rng = forces_env(lmomsubs=lmomsubs)
    whls = rng.standard_normal(NZ + 1) * 0.01      # both signs
    dq = rng.standard_normal(NZ) * 1e-6
    got = tforces.lstend(tf, tg, tcfg, t(whls), *(t(av[k]) for k in av),
                         torch.zeros((0, NZ), dtype=torch.float64), t(dq))
    ref = jforces.lstend(jf, jg, jcfg, jnp.asarray(whls),
                         *(jnp.asarray(av[k]) for k in av),
                         jnp.zeros((0, NZ)), jnp.asarray(dq))
    return [(f"lstend[{i}]", g, r) for i, (g, r) in enumerate(zip(got, ref))]


def fn_fixuinf1():
    out = []
    for lvinf in (False, True):
        jcfg, tcfg, jg, tg, jf, tf, av, _ = forces_env(ifixuinf=1,
                                                       lvinf=lvinf)
        got = tforces.fixuinf1(tf, tg, tcfg, t(0.02), t(av["u"]), t(av["v"]))
        ref = jforces.fixuinf1(jf, jg, jcfg, jnp.asarray(0.02),
                               jnp.asarray(av["u"]), jnp.asarray(av["v"]))
        out += [(f"fixuinf1 lvinf={lvinf} [{i}]", torch.as_tensor(g),
                 np.asarray(r)) for i, (g, r) in enumerate(zip(got, ref))]
    return out


def fn_shifted_pbcs():
    jcfg, tcfg, jg, tg, jf, tf, av, _ = forces_env(ds=2.0)
    got = tforces.shifted_pbcs(tf, tg, tcfg, t(0.01), t(av["u"]), 2.0)
    ref = jforces.shifted_pbcs(jf, jg, jcfg, jnp.asarray(0.01),
                               jnp.asarray(av["u"]), 2.0)
    assert float(np.abs(np.asarray(ref[0])).max()) > 0
    return [(f"shifted[{i}]", g, r) for i, (g, r) in enumerate(zip(got, ref))]


FORCES_FUNCTIONS = {
    "grwdamp off": lambda: fn_grwdamp(0),
    "grwdamp 1": lambda: fn_grwdamp(1),
    "grwdamp 1 coriolis ksp": lambda: fn_grwdamp(1, lcoriol=True, ksp=4),
    "grwdamp 2": lambda: fn_grwdamp(2),
    "nudge_top": fn_nudge_top,
    "lstend": lambda: fn_lstend(False),
    "lstend lmomsubs": lambda: fn_lstend(True),
    "fixuinf1": fn_fixuinf1,
    "shifted_pbcs": fn_shifted_pbcs,
}


@pytest.mark.parametrize("name", sorted(FORCES_FUNCTIONS))
def test_forces_function_matches_reference(name):
    pairs = FORCES_FUNCTIONS[name]()
    assert pairs
    for label, got, ref in pairs:
        assert_close(got, ref, what=f"{name}/{label}")


# --- (e) whole steps ---------------------------------------------------------

P, R = jconfig.BC_PROFILE, jopen.BC_RECYCLE
OPEN_X = dict(BCxm=P, BCxT=P, BCxq=P, BCxs=P)
OPEN_Y = dict(BCym=P, BCyT=P, BCyq=P, BCys=P)
WARM = dict(ltempeq=True, lbuoyancy=True)

STEP_CASES = {
    # the channel of tests/test_openbc.py: profile inlet, convective outlet
    "profile-x": dict(inlet_x=P, bc=OPEN_X, physics=dict(ltempeq=True)),
    "profile-x-moist": dict(inlet_x=P, bc=OPEN_X,
                            physics=dict(lmoist=True, **WARM)),
    "profile-y": dict(inlet_y=P, bc=OPEN_Y, physics=dict(ltempeq=True)),
    "profile-xy-adaptive": dict(inlet_x=P, inlet_y=P,
                                bc={**OPEN_X, **OPEN_Y},
                                physics=dict(ltempeq=True),
                                run=dict(ladaptive=True, dtmax=0.1)),
    "recycle": dict(inlet_x=R, bc=OPEN_X, physics=dict(ltempeq=True)),
    "open-x-volflow": dict(inlet_x=P, bc=OPEN_X,
                           physics=dict(luvolflowr=True, uflowrate=1.2,
                                        lvvolflowr=True, vflowrate=0.1)),
    "sponge": dict(physics=dict(igrw_damp=1, **WARM)),
    "sponge-geostrophic": dict(physics=dict(igrw_damp=2, lcoriol=True,
                                            **WARM)),
    "nudge-static": dict(physics=dict(lnudge=True, nnudge=3, tnudge=30.0,
                                      lmoist=True, **WARM)),
    "nudge-timedep": dict(physics=dict(lnudge=True, nnudge=2, tnudge=30.0,
                                       ltimedepnudge=True, **WARM),
                          timedep=True),
    "lstend": dict(wfls=-0.02, dqtdt=1e-7,
                   physics=dict(lmoist=True, lmomsubs=True, **WARM)),
    "fixuinf1": dict(physics=dict(ifixuinf=1), bc=dict(Uinf=1.5)),
    "fixuinf2": dict(physics=dict(ifixuinf=2, inletav=0.5, tscale=2.0),
                     bc=dict(Uinf=1.5)),
    "fixuinf2-lvinf": dict(physics=dict(ifixuinf=2, inletav=0.5, lvinf=True),
                           bc=dict(Vinf=0.2)),
    "shifted-pbc": dict(physics=dict(ds=2.0)),
    "kappa-thl": dict(physics=WARM,
                      dynamics=dict(iadv_thl=jconfig.IADV_KAPPA)),
    "kappa-thl-open-x": dict(inlet_x=P, bc=OPEN_X, physics=WARM,
                             dynamics=dict(iadv_thl=jconfig.IADV_KAPPA)),
    "kappa-thl-open-y": dict(inlet_y=P, bc=OPEN_Y, physics=WARM,
                             dynamics=dict(iadv_thl=jconfig.IADV_KAPPA)),
}


def nudge_series(cls, asarray, nz):
    """A two-record timedepnudge series as either package's Timedep."""
    td = cls()
    z = np.arange(nz) + 0.5
    rec = lambda s: np.stack([288.0 + s * 0.1 * z, 1e-3 + 0.0 * z,
                              1.0 + s * 0.1 * z, 0.1 * s + 0.0 * z])
    td.nudge_t = asarray(np.array([0.0, 0.08]))
    td.nudge = asarray(np.stack([rec(1.0), rec(2.0)]))
    return td


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_five_steps_match_reference(name):
    """5 steps from udales_tpu's cold start, every State leaf to 1e-8."""
    kw = dict(STEP_CASES[name])
    timedep = kw.pop("timedep", False)
    jmodel, tmodel = build_pair(**kw)
    if timedep:
        from udales_tpu.timedep import Timedep as JTimedep
        from udales_tpu_torch.timedep import Timedep as TTimedep
        jmodel.timedep = nudge_series(JTimedep, jnp.asarray, NZ)
        tmodel.timedep = nudge_series(
            lambda: TTimedep(torch.float64, "cpu"), t, NZ)
    jst = jmodel.cold_start(seed=3, dt0=0.02)
    jst, tst = run_both(jmodel, tmodel, jst)
    names = compare_states(tst, jst)
    if kw.get("inlet_x") is not None:
        assert "c.bx.u" in names and "m.bx.thl" in names
    if kw.get("inlet_y") is not None:
        assert "c.by.v" in names
    if name.startswith("fixuinf2"):
        assert "ctl.dpdx_shift" in names
        assert float(tst.ctl.dpdx_shift) != 0.0


def test_cold_start_builds_the_open_state():
    """The port's own cold start: outlet planes from the last interior
    column, a zero controller, and nothing of either on a closed case."""
    _, tmodel = build_pair(inlet_x=P, inlet_y=P, bc={**OPEN_X, **OPEN_Y},
                           physics=dict(ifixuinf=2))
    st = tmodel.cold_start(seed=1)
    assert torch.equal(st.c.bx.u, st.c.u[-1])
    assert torch.equal(st.c.by.w, st.c.w[:, -1])
    assert float(st.ctl.freestreamav) == tmodel.cfg.bc.Uinf
    assert float(st.ctl.dgdt) == 0.0
    _, closed = build_pair()
    st = closed.cold_start(seed=1)
    assert st.c.bx is None and st.c.by is None and st.ctl is None \
        and st.ig is None and st.drv is None


# --- (f) the physical oracles of tests/test_openbc.py on the port -----------

def channel(direction):
    """The uniform-inflow channel of tests/test_openbc.py on the port."""
    bc = dict(OPEN_X if direction == "x" else OPEN_Y)
    nx, ny = (16, 12) if direction == "x" else (12, 16)
    cfg = make_cfg(tconfig, nx, ny, 8, bc=bc,
                   run=dict(), physics=dict(luvolflowr=False))
    grid = TGrid.uniform(nx, ny, 8, float(nx), float(ny), 8.0,
                         dtype=np.float64)
    model = TModel(cfg, grid, device="cpu")
    one, zero = np.full(8, 1.0), np.zeros(8)
    along, across = (one, zero) if direction == "x" else (zero, one)
    prof = dict(u=along, v=across, thl=np.full(8, 288.0), qt=zero,
                e12=np.full(8, 5e-5))
    setattr(model, "inlet" if direction == "x" else "inlet_y",
            profile_inlet(topen, tconfig.BC_PROFILE, prof, t))
    model.inputs = TCaseInputs(prof=prof, lscale=None, scalar=None)
    return model


@pytest.mark.parametrize("direction", ["x", "y"])
def test_inlet_enforced_and_interior_divergence_free(direction):
    model = channel(direction)
    st = model.step(model.cold_start(seed=2, dt0=0.02))
    inlet = st.c.u[0] if direction == "x" else st.c.v[:, 0]
    np.testing.assert_allclose(inlet.numpy(), 1.0, atol=1e-12)
    div = open_divergence(model, st.c)
    # the inflow/outflow compatibility defect is absorbed in the top level
    # of the mean pressure mode; the interior must be clean
    assert np.abs(div[:, :, :-1]).max() < 1e-8
    assert np.abs(div[:, :, -1]).max() < 1e-2


@pytest.mark.parametrize("direction", ["x", "y"])
def test_outflux_follows_influx(direction):
    model = channel(direction)
    model.cfg = dataclasses.replace(model.cfg, run=dataclasses.replace(
        model.cfg.run, lrandomize=False))
    st = model.run(model.cold_start(dt0=0.02), 10)
    c = st.c
    influx = float((c.u[0] if direction == "x" else c.v[:, 0]).mean())
    outflux = float((c.bx.u if direction == "x" else c.by.v).mean())
    assert abs(influx - 1.0) < 1e-12
    assert abs(outflux - influx) < 0.05, (influx, outflux)
    assert bool(torch.isfinite(c.u).all())


def test_open_xy_divergence_free():
    """Both directions open (the DCT x DCT Poisson solve): interior
    divergence-free, both inlet faces pinned (tests/test_openxy.py)."""
    _, model = build_pair(12, 12, 12, inlet_x=P, inlet_y=P,
                          bc={**OPEN_X, **OPEN_Y},
                          run=dict(ladaptive=True, dtmax=0.1))
    st = model.run(model.cold_start(seed=3, dt0=0.02), 4)
    prof = model.inputs.prof
    np.testing.assert_allclose(st.c.u[0].numpy(),
                               np.broadcast_to(prof["u"], (12, 12)),
                               atol=1e-10)
    np.testing.assert_allclose(st.c.v[:, 0].numpy(), 0.1, atol=1e-10)
    div = open_divergence(model, st.c)
    assert np.abs(div[:, :, :-1]).max() < 1e-10
    assert np.abs(div[:, :, -1]).max() < 1e-2
