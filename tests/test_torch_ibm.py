"""The urban IBM slice of the PyTorch port against udales_tpu (CPU, float64).

The case is ``bench.py``'s urban building array (4x4 cubes, lambda_p = 0.25,
heated facets, iwalltemp = 2, Vreman, buoyancy, fixed volume flow) at 32^3,
staged once per module by ``udales_tpu_torch.cases.stage_urban`` in a
process where JAX cannot be imported.  Inputs are made with numpy from a
seed and fed through both packages.  Tolerances, relative to max|ref|:

  - masks, pmasks and section arrays: exact;
  - module outputs (wall functions, ibmnorm, corrections, thermodynamics,
    masscorr, masked diffusion): 1e-12.  The port sums the sections of one
    boundary point in another order than the TPU package's merged slots;
  - 5 full steps: 1e-8.  The port solves Poisson with torch.fft where the
    reference uses dense DFT matrices, so trajectories drift at rounding
    level.

The tests marked ``cuda`` hold the masked kernel and a CUDA run of the case
against the plain CPU path; they skip without a card.  JAX is imported only
inside the tests that need it, so those run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_ibm.py
"""
import dataclasses
import filecmp
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from udales_tpu_torch import cases
from udales_tpu_torch.convert import (FACET_STATE_NAMES, FIELD_NAMES,
                                      ibm_static_to_numpy, state_from_numpy,
                                      state_to_numpy)
from udales_tpu_torch.ibm.ibm import IBM
from udales_tpu_torch.ops import forces as tforces, thermo as tthermo
from udales_tpu_torch.ops.boundary import Ghosts
from udales_tpu_torch.ops.fused_diff import FusedDiffMom, fused_diff_mom
from udales_tpu_torch.run import Model, load_case
from udales_tpu_torch.state import Fields

REPO = Path(__file__).resolve().parents[1]
N = 32
RTOL = 1e-12
STEP_RTOL = 1e-8


def rel_err(got, ref):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max(initial=0.0)
                 / max(1.0, float(np.abs(ref).max(initial=0.0))))


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """The urban 32^3 case, staged by the port in a subprocess that blocks
    JAX and the JAX package (a None entry in sys.modules makes any import
    of that name fail); the same subprocess loads the case on the CPU and
    takes one step, then does the same with the energy-balance case of
    ``cases.stage_urban_eb`` and with the precursor-driven case of
    ``cases.stage_urban_driven`` (16^3, through ``Model.run``, which fills
    the rolling window)."""
    root = tmp_path_factory.mktemp("urban")
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['udales_tpu'] = None; "
            "import torch; "
            "from udales_tpu_torch import cases; "
            "from udales_tpu_torch.run import load_case; "
            f"case = cases.stage_urban({N}, sys.argv[1]); "
            "model = load_case(case, '900', dtype='float64', device='cpu'); "
            "st = model.step(model.cold_start(seed=43)); "
            "assert bool(torch.isfinite(st.c.u).all()) and float(st.dt) > 0; "
            f"eb = load_case(cases.stage_urban_eb({N}, sys.argv[1]), '900', "
            "dtype='float64', device='cpu'); "
            "st = eb.step(eb.cold_start(seed=43)); "
            "assert eb.eb is not None and float(st.fac.hfi.abs().max()) > 0; "
            "assert bool(torch.isfinite(st.c.thl).all()); "
            "drv = load_case(cases.stage_urban_driven(16, sys.argv[1], nt=8, "
            "chunk=4), '900', dtype='float64', device='cpu'); "
            "st = drv.run(drv.cold_start(seed=43), 1); "
            "assert drv.driver_stream.refills == 1 and st.drv is not None; "
            "assert bool(torch.isfinite(st.c.u).all()) and float(st.dt) > 0; "
            "assert bool((st.c.bx.u != 0).any()); "
            "assert not any(m.split('.')[0] in ('jax', 'udales_tpu') "
            "for m in sys.modules if sys.modules[m] is not None)")
    res = subprocess.run([sys.executable, "-c", code, str(root / "port")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return root / "port" / f"urban{N}v2"


@pytest.fixture(scope="module")
def models(staged):
    """(udales_tpu model, port model) of the staged case, float64, CPU."""
    from udales_tpu.run import load_case as jload_case
    return (jload_case(staged, "900", dtype="float64"),
            load_case(staged, "900", dtype="float64", device="cpu"))


def numpy_fields(seed, nx=N, ny=N, nz=N):
    """A flow state around the case's profiles, made with numpy; w is zero
    on the impermeable floor and top faces, as in every solver state."""
    rng = np.random.default_rng(seed)
    c3 = (nx, ny, nz)
    w = 0.2 * rng.standard_normal((nx, ny, nz + 1))
    w[..., 0] = w[..., nz] = 0.0
    return dict(u=1.5 + 0.4 * rng.standard_normal(c3),
                v=0.3 * rng.standard_normal(c3), w=w,
                thl=290.0 + 2.0 * rng.standard_normal(c3),
                qt=np.zeros(c3), e12=np.full(c3, 1e-4),
                sv=np.zeros((0,) + c3))


def both_fields(arr):
    from udales_tpu import state as jstate
    import jax.numpy as jnp
    return (jstate.Fields(**{k: jnp.asarray(a) for k, a in arr.items()}),
            Fields(**{k: torch.tensor(a) for k, a in arr.items()}))


def both_ghosts(jmodel, jf, seed):
    """The reference's ghosts of `jf` and the same arrays as port Ghosts, so
    a case isolates the module downstream of them."""
    import jax.numpy as jnp
    from udales_tpu.ops import boundary as jbnd
    rng = np.random.default_rng(seed)
    c3 = jf.u.shape
    ekm = 1e-3 + 0.05 * rng.uniform(size=c3)
    ekh = 1e-3 + 0.05 * rng.uniform(size=c3)
    jg = jbnd.make_ghosts(jf, jnp.asarray(ekm), jnp.asarray(ekh),
                          jmodel.cfg, jmodel.grid)
    tg = Ghosts(**{f.name: (None if getattr(jg, f.name) is None
                            else torch.tensor(np.asarray(getattr(jg, f.name))))
                   for f in dataclasses.fields(Ghosts)})
    return jg, tg


def jax_state_to_numpy(st):
    fields = lambda f: {k: np.asarray(getattr(f, k)) for k in FIELD_NAMES}
    return {"m": fields(st.m), "c": fields(st.c), "pres": np.asarray(st.pres),
            "dt": np.asarray(st.dt), "timee": np.asarray(st.timee)}


# --- (a) staging without JAX ------------------------------------------------

def test_staging_is_jax_free_and_matches_bench(staged, tmp_path, monkeypatch):
    """cases.stage_urban, run where neither JAX nor udales_tpu can be
    imported (the `staged` fixture, which there also loads the case and
    steps it on the CPU), writes the same bytes as bench._stage_urban (which
    runs the JAX package's prep)."""
    import bench
    monkeypatch.setattr(bench, "CACHE", tmp_path)
    ref = bench._stage_urban(N)
    names = sorted(p.name for p in ref.iterdir())
    assert names == sorted(p.name for p in staged.iterdir())
    assert len(names) >= 20
    match, mismatch, errors = filecmp.cmpfiles(ref, staged, names,
                                               shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


# --- (b) static geometry ------------------------------------------------------

def test_static_geometry_matches_reference(models):
    """Masks, pmasks, facet arrays and every grid's sections (ijk, area,
    distance, facet id, active flag) equal udales_tpu's IBM.load exactly."""
    jmodel, tmodel = models
    jibm = jmodel.ibm
    got = ibm_static_to_numpy(tmodel.ibm)
    for k in "uvwc":
        assert np.array_equal(got["masks"][k], np.asarray(getattr(jibm.masks,
                                                                  k))), k
        assert np.array_equal(got["pmasks"][k],
                              np.asarray(getattr(jibm, f"pmask_{k}"))), k
        for f in ("ijk", "area", "dist", "fac", "active", "rec"):
            assert np.array_equal(got["sec"][k][f],
                                  getattr(jibm.sec[k], f)), (k, f)
        assert not jibm.sec[k].rec.any()   # no reconstruction sections
    for f in ("facnorm", "facz0", "facz0h", "faca"):
        assert np.array_equal(got[f], getattr(jibm, f)), f
    assert np.array_equal(got["facT"], np.asarray(jibm.facT))
    assert tmodel.ibm.nfcts == jibm.nfcts == tmodel.cfg.walls.nfcts > 0
    assert all(tmodel.ibm.lists[k] is not None for k in "uvwc")


# --- (c) wall functions -----------------------------------------------------

def assert_wallfun_matches(jmodel, cfg, jibm, tibm, seed):
    """wallfun of both packages on one random state, zero tendencies in
    (the reference jitted: op by op it takes several times longer)."""
    import jax
    import jax.numpy as jnp
    jf, _ = both_fields(numpy_fields(seed=seed))
    jg, tg = both_ghosts(jmodel, jf, seed=seed + 1)
    z3 = np.zeros((N, N, N))
    zw = np.zeros((N, N, N + 1))
    ref = jax.jit(lambda g, c: jibm.wallfun(
        g, c, jmodel.grid, cfg, jnp.asarray(z3), jnp.asarray(z3),
        jnp.asarray(zw), jnp.asarray(z3), jnp.asarray(z3), c.sv)[:4])(jg, jf)
    got = tibm.wallfun(tg, torch.tensor(z3), torch.tensor(z3),
                       torch.tensor(zw), torch.tensor(z3))
    for name, a, b in zip(("du", "dv", "dw", "dthl"), got, ref):
        assert float(np.abs(np.asarray(b)).max()) > 0, name
        assert rel_err(a, b) <= RTOL, name


@pytest.mark.parametrize("iwallmom,iwalltemp", [(2, 2), (3, 1)],
                         ids=["stability-heated", "neutral-fixedflux"])
def test_wallfun_matches_dense_reference(models, staged, iwallmom, iwalltemp):
    """Facet stresses and heat fluxes from one random state equal the
    reference's dense K-slot path (1e-12: the area merge reorders sums)."""
    from udales_tpu.ibm.ibm import IBM as JIBM
    jmodel, tmodel = models
    walls = dataclasses.replace(jmodel.cfg.walls, iwallmom=iwallmom,
                                iwalltemp=iwalltemp)
    bc = dataclasses.replace(jmodel.cfg.bc, bctfxm=0.01, bctfxp=-0.02,
                             bctfyp=0.03, bctfz=0.05)
    cfg = dataclasses.replace(jmodel.cfg, walls=walls, bc=bc)
    assert_wallfun_matches(jmodel, cfg, JIBM.load(staged, "900", cfg,
                                                  jmodel.grid),
                           IBM.load(staged, "900", cfg, tmodel.grid), seed=3)


# --- (d) ibmnorm, solid fill, cd2 corrections -----------------------------

@pytest.mark.parametrize("conservative", [False, True],
                         ids=["liberal", "conservative"])
def test_ibmnorm_fills_and_corrects_qt(models, staged, conservative):
    """With lmoist, ibmnorm fills the solid qt cells (enclosed ones with 0)
    and adds the cd2 correction to the qt tendency, as udales_tpu's
    (ibm.py:1574-1579)."""
    import jax.numpy as jnp
    jmodel, tmodel = models
    cfg = dataclasses.replace(tmodel.cfg, physics=dataclasses.replace(
        tmodel.cfg.physics, lmoist=True, lconservativeibm=conservative))
    tibm = IBM.load(staged, "900", cfg, tmodel.grid)
    arr_c, arr_m = numpy_fields(seed=15), numpy_fields(seed=16)
    rng = np.random.default_rng(17)
    for arr in (arr_c, arr_m):
        arr["qt"] = 0.008 + 0.002 * rng.standard_normal((N, N, N))
    jc, tc = both_fields(arr_c)
    jm, tm = both_fields(arr_m)
    tend = [rng.standard_normal(s) for s in ((N, N, N), (N, N, N),
                                             (N, N, N + 1), (N, N, N),
                                             (N, N, N))]
    ref = jmodel.ibm.ibmnorm(jc, jm, jmodel.grid, cfg,
                             *[jnp.asarray(a) for a in tend], jc.sv, 0.1,
                             jnp.asarray(291.5))
    got = tibm.ibmnorm(tc, tm, *[torch.tensor(a) for a in tend[:4]],
                       torch.tensor(291.5), torch.tensor(tend[4]))
    for a, b in list(zip(got[:5], ref[:5])) + [
            (got[6].qt, ref[6].qt), (got[6].thl, ref[6].thl)]:
        assert rel_err(a, b) <= RTOL
    assert not torch.equal(got[4], torch.tensor(tend[4]))
    assert not torch.equal(got[6].qt, tm.qt)


@pytest.mark.parametrize("part", ["ibmnorm", "solid_fill", "liberal",
                                  "conservative"])
def test_ibmnorm_parts_match_reference(models, part):
    import jax.numpy as jnp
    jmodel, tmodel = models
    jibm, tibm = jmodel.ibm, tmodel.ibm
    arr_c, arr_m = numpy_fields(seed=5), numpy_fields(seed=6)
    jc, tc = both_fields(arr_c)
    jm, tm = both_fields(arr_m)
    rng = np.random.default_rng(7)
    tend = [rng.standard_normal(s) for s in ((N, N, N), (N, N, N),
                                             (N, N, N + 1), (N, N, N))]
    if part == "ibmnorm":
        ref = jibm.ibmnorm(jc, jm, jmodel.grid, jmodel.cfg,
                           *[jnp.asarray(a) for a in tend],
                           jnp.zeros((N, N, N)), jc.sv, 0.1,
                           jnp.asarray(291.5))
        got = tibm.ibmnorm(tc, tm, *[torch.tensor(a) for a in tend],
                           torch.tensor(291.5))
        assert got[4] is None and got[5] is None  # dry, no scalars
        pairs = list(zip(got[:4], ref[:4])) + [
            (getattr(got[6], k), getattr(ref[6], k)) for k in
            ("u", "v", "w", "thl")]
    elif part == "solid_fill":
        ref = jibm._solid_fill_full(jm.thl, jnp.asarray(tend[3]), 291.5)
        got = tibm.solid_fill(tm.thl, torch.tensor(tend[3]),
                              torch.tensor(291.5))
        pairs = list(zip(got, ref))
    elif part == "liberal":
        pairs = [(tibm.advecc2nd_corr_liberal(tc.thl, tc),
                  jibm._advecc2nd_corr_liberal(jc.thl, jc, jmodel.grid))]
    else:
        pairs = [(tibm.advecc2nd_corr_conservative(tc.thl, tc),
                  jibm._advecc2nd_corr_conservative(jc.thl, jc,
                                                    jmodel.grid))]
    for a, b in pairs:
        assert float(np.abs(np.asarray(b)).max()) > 0
        assert rel_err(a, b) <= RTOL


# --- (e) masked thermodynamics and volume-flow correction -----------------

def test_masked_thermodynamics_and_masscorr(models):
    from udales_tpu.ops import forces as jforces, thermo as jthermo
    import jax.numpy as jnp
    jmodel, tmodel = models
    jf, tf = both_fields(numpy_fields(seed=8))
    jth = jthermo.thermodynamics(jf, jmodel.cfg, jmodel.grid,
                                 jmodel.ibm.masks)
    tth = tthermo.thermodynamics(tf, tmodel.cfg, tmodel.grid,
                                 tmodel.ibm.masks)
    for f in dataclasses.fields(tthermo.ThermoDiag):
        assert rel_err(getattr(tth, f.name), getattr(jth, f.name)) <= RTOL, \
            f.name
    # an all-solid-free but masked slab average differs from the plain one
    assert not np.allclose(np.asarray(jth.u0av),
                           np.asarray(jnp.mean(jf.u, axis=(0, 1))))
    up = 0.01 * np.random.default_rng(9).standard_normal((N, N, N))
    rk3 = 0.05
    for comp, tfn, jfn in (("u", tforces.masscorr_uvol, jforces.masscorr_uvol),
                           ("v", tforces.masscorr_vvol,
                            jforces.masscorr_vvol)):
        got = tfn(torch.tensor(up), getattr(tf, comp), tmodel.grid,
                  tmodel.cfg, torch.tensor(rk3, dtype=torch.float64),
                  getattr(tmodel.ibm.masks, comp))
        ref = jfn(jnp.asarray(up), getattr(jf, comp), jmodel.grid,
                  jmodel.cfg, jnp.asarray(rk3), getattr(jmodel.ibm.masks,
                                                        comp))
        assert rel_err(got, ref) <= RTOL, comp


# --- (f) the slice end to end ------------------------------------------------

def test_five_urban_steps_match_reference(models):
    """5 adaptive RK3 steps of the urban case from the reference's own
    cold start (jax.random noise, carried over as numpy) agree to 1e-8."""
    import jax
    jmodel, tmodel = models
    jst = jmodel.cold_start(seed=43)
    tst = state_from_numpy(jax_state_to_numpy(jst))
    jrun = jax.jit(lambda s: jmodel.run(s, 5))
    jst = jrun(jst)
    tst = tmodel.run(tst, 5)
    ref, got = jax_state_to_numpy(jst), state_to_numpy(tst)
    for name in ("u", "v", "w", "thl"):
        assert rel_err(got["c"][name], ref["c"][name]) <= STEP_RTOL, name
        assert rel_err(got["m"][name], ref["m"][name]) <= STEP_RTOL, name
    assert rel_err(got["pres"], ref["pres"]) <= STEP_RTOL
    assert abs(float(got["dt"]) - float(ref["dt"])) \
        <= STEP_RTOL * float(ref["dt"])


def test_cold_start_and_run_on_the_port_alone(models):
    """The port's own cold start (torch.Generator noise) runs: finite
    fields, dt > 0, divergence-free velocity, the CPU path launches no
    kernel."""
    _, tmodel = models
    before = (fused_diff_mom.launch_count, fused_diff_mom.masked_launch_count)
    st = tmodel.run(tmodel.cold_start(seed=1), 2)
    assert (fused_diff_mom.launch_count,
            fused_diff_mom.masked_launch_count) == before
    assert st.dt.dim() == 0 and float(st.dt) > 0
    for name in FIELD_NAMES[:4]:
        assert bool(torch.isfinite(getattr(st.c, name)).all()), name
    c, grid = st.c, tmodel.grid
    div = ((torch.roll(c.u, -1, 0) - c.u) * grid.dxi
           + (torch.roll(c.v, -1, 1) - c.v) * grid.dyi
           + (c.w[..., 1:] - c.w[..., :-1]) * grid.t("dzfi", "cpu"))
    assert float(div.abs().max()) < 1e-10
    # built without case inputs, the start is the reference's fallback
    # profile: at rest, thl = 288 K, noise only in u, v, w
    bare = Model(tmodel.cfg, grid, tmodel.ibm,
                 device="cpu").cold_start(seed=2)
    assert torch.equal(bare.c.thl, torch.full_like(bare.c.thl, 288.0))
    assert 0 < float(bare.c.u.abs().max()) <= 2 * tmodel.cfg.run.randu


# --- (g) masked diffusion ---------------------------------------------------

def test_masked_fused_diff_matches_reference(models):
    """The plain masked path of fused_diff_mom (the CPU side of the masked
    kernel) equals udales_tpu's fused_diff_mom(pmasks=...)."""
    from udales_tpu.ops.pallas_stencil import fused_diff_mom as jfdm
    jmodel, tmodel = models
    jf, _ = both_fields(numpy_fields(seed=10))
    jg, tg = both_ghosts(jmodel, jf, seed=11)
    jibm, tibm = jmodel.ibm, tmodel.ibm
    ref = jfdm(jg, jmodel.grid, pmasks=dict(u=jibm.pmask_u, v=jibm.pmask_v,
                                            w=jibm.pmask_w))
    got = fused_diff_mom(tg, tmodel.grid, pmasks=dict(
        u=tibm.pmask_u, v=tibm.pmask_v, w=tibm.pmask_w))
    for a, b in zip(got, ref):
        assert rel_err(a, b) <= RTOL
    plain = fused_diff_mom(tg, tmodel.grid)
    assert not torch.equal(plain[0], got[0])


# --- what the slice does not take ----------------------------------------

def test_nudged_urban_steps_match_reference(models):
    """Nudging of the slab means (masked averages) on the urban case, which
    used to raise: 3 steps from one State agree to 1e-8."""
    import jax
    from udales_tpu.run import Model as JModel
    jmodel, tmodel = models
    nudged = lambda cfg: dataclasses.replace(cfg, physics=dataclasses.replace(
        cfg.physics, lnudge=True, nnudge=4, tnudge=20.0))
    jm = JModel(nudged(jmodel.cfg), jmodel.grid, jmodel.inputs, jmodel.ibm)
    tm = Model(nudged(tmodel.cfg), tmodel.grid, tmodel.ibm, device="cpu")
    tm.inputs = tmodel.inputs
    for k in ("dpdxl", "dpdyl", "ug", "vg", "thlpcar", "whls", "dqtdtls"):
        setattr(tm, k, getattr(tmodel, k))
    jst = jm.cold_start(seed=43)
    tst = state_from_numpy(jax_state_to_numpy(jst))
    jst = jax.jit(lambda s: jm.run(s, 3))(jst)
    tst = tm.run(tst, 3)
    ref, got = jax_state_to_numpy(jst), state_to_numpy(tst)
    for name in ("u", "v", "w", "thl"):
        assert rel_err(got["c"][name], ref["c"][name]) <= STEP_RTOL, name
    plain = state_to_numpy(tmodel.run(state_from_numpy(
        jax_state_to_numpy(jm.cold_start(seed=43))), 3))
    assert not np.array_equal(plain["c"]["u"], got["c"]["u"])


def test_urban_scalars_match_reference(models):
    """Two passive scalars on the urban case, which used to raise (kappa
    advection, masked diffusion, ibmnorm's solid fill of the stack, a line
    source along a canyon): 3 steps from one State agree to 1e-8; the
    scalars stay zero-gradient into the solids and finite."""
    import jax
    from udales_tpu.physics import ScalarSources as JSources
    from udales_tpu.run import Model as JModel
    from udales_tpu_torch.physics import ScalarSources
    jmodel, tmodel = models
    scal = dataclasses.replace(jmodel.cfg.scalars, nsv=2, lscasrcl=True,
                               nscasrcl=1)
    cfg = dataclasses.replace(jmodel.cfg, scalars=scal)
    z = np.asarray(jmodel.grid.zf)
    inputs = dataclasses.replace(jmodel.inputs, scalar=np.stack(
        [np.zeros(N), 1.0 + 0.02 * z]))
    jm = JModel(cfg, jmodel.grid, inputs, jmodel.ibm)
    tm = Model(cfg, tmodel.grid, tmodel.ibm, device="cpu")
    tm.inputs = inputs
    for k in ("dpdxl", "dpdyl", "ug", "vg", "thlpcar", "whls", "dqtdtls"):
        setattr(tm, k, getattr(tmodel, k))
    lines = [np.array([[N / 4, 0.0, 1.0, N / 4, float(N), 1.0, 2.0, 1.0]])] * 2
    jm.scalsources = JSources.build(cfg, jm.grid, lines=lines)
    tm.scalsources = ScalarSources.build(cfg, tm.grid, lines=lines)
    jst = jm.cold_start(seed=43)
    tst = state_from_numpy(jax_state_to_numpy(jst))
    assert tst.c.sv.shape == (2, N, N, N)
    jst = jax.jit(lambda s: jm.run(s, 3))(jst)
    tst = tm.run(tst, 3)
    ref, got = jax_state_to_numpy(jst), state_to_numpy(tst)
    for part in ("m", "c"):
        for name in ("u", "v", "w", "thl", "sv"):
            assert rel_err(got[part][name], ref[part][name]) <= STEP_RTOL, \
                (part, name)
    assert float(np.abs(got["c"]["sv"][0]).max()) > 1e-3
    assert np.isfinite(got["c"]["sv"]).all()


def test_wallfun_without_facet_state_forms_no_facet_sums(models):
    """With no facet state, no lwritefac and no periodicEBcorr, wallfun
    forms no per-facet sum and no domain total (their launches are the
    repair of a 590 -> 604 growth a call); the tendencies are unchanged."""
    from torch.utils._python_dispatch import TorchDispatchMode
    jmodel, tmodel = models
    ibm = tmodel.ibm
    jf, tf = both_fields(numpy_fields(seed=41))
    _, tg = both_ghosts(jmodel, jf, seed=42)
    z = lambda *s: torch.zeros(s, dtype=torch.float64)
    args = (tg, z(N, N, N), z(N, N, N), z(N, N, N + 1), z(N, N, N))

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            shape = tuple(out.shape) if torch.is_tensor(out) else None
            self.calls.append((str(func), shape))
            return out
    with Ops() as plain:
        out = ibm.wallfun(*args)
    with Ops() as summed:
        ref = ibm.wallfun(*args, need_fac=True)
    per_facet = lambda calls: [c for c in calls if c[1] == (ibm.nfcts,)]
    sums = lambda calls: [c for c in calls
                          if "aten.sum" in c[0] and c[1] == ()]
    assert not per_facet(plain.calls) and not sums(plain.calls)
    assert per_facet(summed.calls) and sums(summed.calls)
    assert out[5] is None and out[7] is None and out[8] is None
    for a, b in zip(out[:4], ref[:4]):
        assert torch.equal(a, b)
    assert len(plain.calls) < len(summed.calls)


def eb_files_match_reference(staged, tmp_path):
    """The energy-balance file output (lwriteEBfiles), which the port used
    to refuse: the staged urban-EB case with it switched on builds in both
    packages, and one facT / facEB record of one converted facet state
    written by each package's Simulation holds the same variables, equal
    as float32."""
    from udales_tpu.run import load_case as jload_case
    from udales_tpu.sim import Simulation as JSimulation
    from udales_tpu_torch.sim import Simulation
    from test_torch_io import read_nc
    from test_torch_openbc import jtree
    case = cases.with_namelist(staged.parent / f"urban{N}eb",
                               tmp_path / "ebfiles",
                               ENERGYBALANCE=dict(lwriteEBfiles=True))
    jmodel = jload_case(case, "900", dtype="float64")
    tmodel = load_case(case, "900", dtype="float64", device="cpu")
    assert tmodel.cfg.eb.lwriteEBfiles and tmodel.eb is not None
    jst = jmodel.cold_start(seed=43)
    jst = jst.replace(fac=dataclasses.replace(
        jst.fac, T=jst.fac.T + 3.0 * np.sin(np.arange(jst.fac.T.size))
        .reshape(jst.fac.T.shape)))
    tst = state_from_numpy(jtree(jst))
    for name, sim, st in (("ref", JSimulation(jmodel, tmp_path / "ref"), jst),
                          ("got", Simulation(tmodel, tmp_path / "got"), tst)):
        sim._write_fac(st, 2.0)
        for w in sim.facwriter:
            w.close()
    for stem in ("facT", "facEB"):
        got = read_nc(tmp_path / "got" / f"{stem}.900.nc")
        ref = read_nc(tmp_path / "ref" / f"{stem}.900.nc")
        assert sorted(got) == sorted(ref) and len(ref) >= 4
        for k in ref:
            assert np.array_equal(got[k], ref[k]), (stem, k)
    assert got["LWin"].shape == (1, tmodel.eb.nfcts)


@pytest.mark.parametrize("change", [
    dict(eb=dict(lEB=True, lwriteEBfiles=True)), dict(ibm=None)],
    ids=["lwriteEBfiles", "ibm-missing"])
def test_unported_urban_configurations_raise(models, staged, tmp_path,
                                            change):
    """An IBM case built without its IBM raises by name.  lwriteEBfiles,
    which used to raise too, now runs and matches the reference
    (`eb_files_match_reference`)."""
    if "eb" in change:
        eb_files_match_reference(staged, tmp_path)
        return
    _, tmodel = models
    cfg, ibm = tmodel.cfg, tmodel.ibm
    for group, kw in change.items():
        if group == "ibm":
            ibm = None
        else:
            cfg = dataclasses.replace(cfg, **{group: dataclasses.replace(
                getattr(cfg, group), **kw)})
    with pytest.raises(NotImplementedError, match="not ported"):
        Model(cfg, tmodel.grid, ibm, device="cpu")


@pytest.fixture(scope="module")
def rough_case(staged, tmp_path_factory):
    """The urban case with z0 = 0.2 m on its rough facets: most sections
    then lie in the roughness layer (log(dist/z0) <= 1) and sample the flow
    at reconstruction points."""
    case = tmp_path_factory.mktemp("rough") / f"urban{N}v2"
    shutil.copytree(staged, case)
    ft = case / "factypes.inp.900"
    lines = ft.read_text().splitlines()
    rows = [r.split() for r in lines[3:] if r.strip()]
    for r in rows:
        if float(r[2]) > 0:
            r[2] = "0.2"
    ft.write_text("\n".join(lines[:3] + [" ".join(r) for r in rows]) + "\n")
    return case


def test_reconstruction_sections_match_reference(models, rough_case):
    """Reconstruction points (distances, rec flags, active flags) equal the
    reference's, and the wall functions, which mix rec sections (its sparse
    trilinear path) with the others (its dense path), agree to 1e-12."""
    from udales_tpu.ibm.ibm import IBM as JIBM
    jmodel, tmodel = models
    jibm = JIBM.load(rough_case, "900", jmodel.cfg, jmodel.grid)
    tibm = IBM.load(rough_case, "900", tmodel.cfg, tmodel.grid)
    got = ibm_static_to_numpy(tibm)["sec"]
    for k in "uvwc":
        for f in ("ijk", "area", "dist", "fac", "active", "rec"):
            assert np.array_equal(got[k][f], getattr(jibm.sec[k], f)), (k, f)
    assert all(jibm.sec[k].rec.any() for k in "uvwc")
    assert any((jibm.sec[k].active & ~jibm.sec[k].rec).any() for k in "uvw")
    assert_wallfun_matches(jmodel, jmodel.cfg, jibm, tibm, seed=14)


def test_lnorec_skips_reconstruction_sections(models, rough_case):
    from udales_tpu.ibm.ibm import IBM as JIBM
    jmodel, tmodel = models
    cfg = dataclasses.replace(tmodel.cfg, walls=dataclasses.replace(
        tmodel.cfg.walls, lnorec=True))
    jibm = JIBM.load(rough_case, "900", cfg, jmodel.grid)
    tibm = IBM.load(rough_case, "900", cfg, tmodel.grid)
    for k in "uvwc":
        assert not tibm.sec[k].rec.any()
        assert np.array_equal(tibm.sec[k].active, jibm.sec[k].active), k
    assert tibm.lists["c"] is None   # every c section was a rec section


def test_out_of_bounds_points_raise(staged, tmp_path, models):
    """A solid point outside the grid raises instead of wrapping."""
    _, tmodel = models
    case = tmp_path / "bad"
    shutil.copytree(staged, case)
    with open(case / "solid_c.txt", "a") as f:
        f.write(f"{N + 1} 1 1\n")
    with pytest.raises(ValueError, match="outside"):
        IBM.load(case, "900", tmodel.cfg, tmodel.grid)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def staged_here(tmp_path_factory):
    """The urban case staged in this process (the card's machine has no
    JAX to block)."""
    return cases.stage_urban(N, tmp_path_factory.mktemp("urban_card"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12),
                                        ("float32", 1e-5)],
                         ids=["f64", "f32"])
def test_masked_kernel_matches_plain_at_urban_masks(cuda, staged_here, dtype,
                                                   rtol):
    """The masked kernel == plain diff_u/v/w(M=pmask) on the same card
    tensors, at the case's own masks (float32: FMA contraction, 1e-5)."""
    model = load_case(staged_here, "900", dtype=dtype, device=cuda)
    rng = np.random.default_rng(12)
    tdt = model.grid.torch_dtype
    cell = (N + 2, N + 2, N + 2)
    t = lambda a: torch.tensor(a, dtype=tdt, device=cuda)
    g = types.SimpleNamespace(u=t(rng.standard_normal(cell)),
                              v=t(rng.standard_normal(cell)),
                              w=t(rng.standard_normal((N + 2, N + 2, N + 1))),
                              ekm=t(rng.uniform(0.5, 1.5, cell)))
    ibm = model.ibm
    pm = dict(u=ibm.pmask_u, v=ibm.pmask_v, w=ibm.pmask_w)
    kern = FusedDiffMom()
    got = kern(g, model.grid, pmasks=pm)
    torch.cuda.synchronize()
    assert (kern.launch_count, kern.masked_launch_count) == (0, 1)
    from udales_tpu_torch.ops import subgrid as sgs
    ref = (sgs.diff_u(g, model.grid, M=pm["u"]),
           sgs.diff_v(g, model.grid, M=pm["v"]),
           sgs.diff_w(g, model.grid, M=pm["w"]))
    scale = max(float(r.abs().max()) for r in ref)
    assert max(float((a - b).abs().max()) for a, b in zip(got, ref)) \
        <= rtol * scale


@pytest.mark.cuda
def test_urban_steps_on_card_match_cpu(cuda, staged_here):
    """5 urban steps at 32^3 float64: CUDA (masked kernel) == CPU (plain)
    to 1e-9 relative; 3 masked launches per step, no unmasked one."""
    out = {}
    for dev in ("cpu", cuda):
        model = load_case(staged_here, "900", dtype="float64", device=dev)
        before = (fused_diff_mom.launch_count,
                  fused_diff_mom.masked_launch_count)
        st = state_from_numpy(numpy_state_for(model), device=dev)
        st = model.run(st, 5)
        if dev == cuda:
            torch.cuda.synchronize()
            assert fused_diff_mom.launch_count == before[0]
            assert fused_diff_mom.masked_launch_count == before[1] + 15
        out[str(dev)] = state_to_numpy(st)
    ref, got = out["cpu"], out[str(cuda)]
    for name in ("u", "v", "w", "thl"):
        assert rel_err(got["c"][name], ref["c"][name]) <= 1e-9, name
    assert rel_err(got["pres"], ref["pres"]) <= 1e-9


@pytest.mark.cuda
def test_urban_eb_steps_on_card_match_cpu(cuda, tmp_path):
    """5 urban-EB steps at 32^3 float64, the balance firing: CUDA == CPU to
    1e-9 relative in the fields and the facet temperatures."""
    case = cases.stage_urban_eb(32, tmp_path, dtEB=0.5)
    out, start = {}, None
    for dev in ("cpu", cuda):
        model = load_case(case, "900", dtype="float64", device=dev)
        if start is None:
            start = state_to_numpy(model.cold_start(seed=43))
        out[str(dev)] = state_to_numpy(
            model.run(state_from_numpy(start, device=dev), 5))
    ref, got = out["cpu"], out[str(cuda)]
    assert float(ref["fac"]["tEB_last"]) > 0
    for name in ("u", "v", "w", "thl"):
        assert rel_err(got["c"][name], ref["c"][name]) <= 1e-9, name
    for k in FACET_STATE_NAMES:
        assert rel_err(got["fac"][k], ref["fac"][k]) <= 1e-9, k


@pytest.mark.cuda
def test_step_with_the_balance_makes_no_host_sync(cuda, tmp_path):
    """Model.step with the energy balance (and lwritefac) on: any host
    synchronisation raises under set_sync_debug_mode("error")."""
    case = cases.stage_urban_eb(32, tmp_path, dtEB=0.5)
    base = load_case(case, "900", dtype="float32", device=cuda)
    cfg = dataclasses.replace(base.cfg, walls=dataclasses.replace(
        base.cfg.walls, lwritefac=True))
    model = Model(cfg, base.grid, base.ibm, device=cuda)
    model.eb, model.inputs = base.eb, base.inputs
    st = model.step(model.cold_start(seed=43))      # warm-up: builds, plans
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            st = model.step(st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(st.fac.tEB_last) > 0 and float(st.facstats.htc.max()) > 0


def numpy_state_for(model):
    """A start State as numpy: the case profiles plus seeded noise."""
    nx, ny, nz = model.grid.shape
    f = numpy_fields(seed=13, nx=nx, ny=ny, nz=nz)
    return {"m": f, "c": f, "pres": np.zeros((nx, ny, nz)),
            "dt": np.asarray(0.1), "timee": np.asarray(0.0)}
