"""The facet energy-balance slice of the PyTorch port against udales_tpu
(CPU, float64): ``FacetEB``, ``Timedep``, ``periodic_eb_corr``, the wall
functions with a live facet state, and whole steps with the balance firing.

Two cases, both staged by the port's own prep:

  - the 16^3 single-cube case of tests/test_sharding_hard.py (``lEB``,
    ``lvfsparse``, ``dtEB = 0.2``), with variants: moist green roofs,
    ``lperiodicEBcorr``, ``lwritefac``, time-dependent radiation;
  - ``cases.stage_urban_eb(32)``, the urban cube array with the balance.

Inputs are made with numpy from a seed and fed through both packages.
Tolerances, relative to max|ref|: 1e-10 for ``FacetEB`` and the wall
functions (the batched solve and the per-facet sums run in another order),
1e-12 for the interpolators and ``periodic_eb_corr``, 1e-8 for 5 steps.
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

from udales_tpu.config import Config, EnergyBalanceConfig
from udales_tpu.ibm.eb import FacetEB as JFacetEB, qsat_fn as jqsat_fn
from udales_tpu.ops import forces as jforces
from udales_tpu.run import load_case as jload_case
from udales_tpu.timedep import Timedep as JTimedep

from udales_tpu_torch import cases
from udales_tpu_torch.config import load_namoptions
from udales_tpu_torch.convert import (FACET_STATE_NAMES, FACSTAT_NAMES,
                                      FIELD_NAMES, facet_state_from_numpy,
                                      facet_state_to_numpy, state_from_numpy,
                                      state_to_numpy)
from udales_tpu_torch.grid import Grid
from udales_tpu_torch.ibm.eb import FacetEB, qsat_fn
from udales_tpu_torch.ops import forces as tforces
from udales_tpu_torch.ops.boundary import make_ghosts
from udales_tpu_torch.prep.prep import (PrepConfig, make_box_stl,
                                        prepare_case)
from udales_tpu_torch.run import Model, load_case
from udales_tpu_torch.state import FACSTAT_FIELDS
from udales_tpu_torch.timedep import Timedep

RTOL = 1e-10
STEP_RTOL = 1e-8


def rel_err(got, ref):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max(initial=0.0)
                 / max(1e-30, float(np.abs(ref).max(initial=0.0))))


def jax_leaves(obj, names):
    return {k: np.asarray(getattr(obj, k)) for k in names}


def jax_state_to_numpy(st):
    d = {"m": jax_leaves(st.m, FIELD_NAMES), "c": jax_leaves(st.c, FIELD_NAMES),
         "pres": np.asarray(st.pres), "dt": np.asarray(st.dt),
         "timee": np.asarray(st.timee)}
    if st.fac is not None:
        d["fac"] = jax_leaves(st.fac, FACET_STATE_NAMES)
    if st.facstats is not None:
        d["facstats"] = jax_leaves(st.facstats, FACSTAT_NAMES)
    return d


# --- FacetEB on synthetic facets ---------------------------------------------

def synthetic_pair(kind, nfcts=12, dtEB=2.0, seed=0):
    """The synthetic facets of tests/test_eb.py with random properties, two
    green roofs and one bounding wall (not solved); `kind` picks the dense
    view-factor matrix or its sparse triplets."""
    rng = np.random.default_rng(seed)
    eb = dict(lEB=True, dtEB=dtEB, skyLW=330.0, bldT=295.0, flrT=290.0,
              wsoil=280.0)
    facets = np.ones(nfcts, np.int64)
    facets[3] = -1          # floor: inner temperature flrT
    facets[5] = -101        # bounding wall: identity system
    faca = rng.uniform(0.5, 2.0, nfcts)
    facem = rng.uniform(0.8, 0.95, nfcts)
    facd = rng.uniform(0.05, 0.3, (nfcts, 3))
    facd[5] = 0.0
    faccp = rng.uniform(1e6, 3e6, (nfcts, 3))
    faclam = rng.uniform(0.5, 1.5, (nfcts, 4))
    faclam[5] = 0.0
    faclGR = np.zeros(nfcts, bool)
    faclGR[[1, 7]] = True
    vf = rng.uniform(0.0, 1.0, (nfcts, nfcts)) * (rng.uniform(
        size=(nfcts, nfcts)) < 0.4)
    vf /= 2.0 * np.maximum(vf.sum(axis=1, keepdims=True), 1e-9)
    svf = 1.0 - vf.sum(axis=1)
    netsw = rng.uniform(0.0, 400.0, nfcts)
    Tfac = rng.uniform(288.0, 300.0, nfcts)
    i, j = np.nonzero(vf)
    dense, sparse = (vf, None) if kind == "dense" else (None,
                                                        (i, j, vf[i, j]))
    jcfg = Config(eb=EnergyBalanceConfig(**eb))
    from udales_tpu_torch.config import (Config as TConfig,
                                         EnergyBalanceConfig as TEB)
    tcfg = TConfig(eb=TEB(**eb))
    facnorm = np.tile([0.0, 0.0, 1.0], (nfcts, 1))
    return (JFacetEB(jcfg, facets, facnorm, faca, facem, facd, faccp, faclam,
                     faclGR, dense, sparse, svf, netsw, Tfac,
                     dtype=np.float64),
            FacetEB(tcfg, facets, faca, facem, facd, faccp, faclam, faclGR,
                    dense, sparse, svf, netsw, Tfac, dtype=torch.float64))


def loaded_state(jeb, seed):
    """A facet state mid-run: random layer temperatures, accumulated fluxes
    and soil moisture, for both packages."""
    rng = np.random.default_rng(seed)
    n = jeb.nfcts
    js = jeb.initial_state()
    js = dataclasses.replace(
        js, T=js.T + jnp.asarray(rng.uniform(-3, 3, js.T.shape)),
        hfi=jnp.asarray(rng.uniform(-0.02, 0.02, n)),
        efi=jnp.asarray(rng.uniform(-1e-5, 0.0, n)),
        wsoil=js.wsoil * jnp.asarray(rng.uniform(0.8, 1.0, n)),
        tEB_last=jnp.asarray(0.4))
    return js, facet_state_from_numpy(jax_leaves(js, FACET_STATE_NAMES))


def assert_facet_states_match(got, ref, rtol=RTOL):
    for k in FACET_STATE_NAMES:
        assert rel_err(getattr(got, k), getattr(ref, k)) <= rtol, k


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_facet_eb_matches_reference(kind):
    """initial_state, calclw and update of both packages on one state."""
    jeb, teb = synthetic_pair(kind)
    assert_facet_states_match(teb.initial_state(), jeb.initial_state(), 1e-14)
    js, ts = loaded_state(jeb, seed=1)
    assert rel_err(teb.calclw(ts.T), jeb.calclw(js.T)) <= RTOL
    assert rel_err(teb.calclw(ts.T, torch.tensor(410.0)),
                   jeb.calclw(js.T, jnp.asarray(410.0))) <= RTOL
    timee = 2.37
    jn = jeb.update(js, jnp.asarray(timee))
    tn = teb.update(ts, torch.tensor(timee, dtype=torch.float64))
    assert_facet_states_match(tn, jn)
    # the solve moved the modelled facets and left the bounding wall alone
    dT = (tn.T - ts.T).abs().max(dim=1).values
    assert float(dT[5]) == 0.0 and float(dT.min()) == 0.0 < float(dT[0])
    assert float(tn.hfi.abs().max()) == 0.0 and float(tn.tEB_last) == timee
    # time-interpolated radiation overrides
    nsw = np.random.default_rng(2).uniform(0, 300, jeb.nfcts)
    assert_facet_states_match(
        teb.update(ts, torch.tensor(timee, dtype=torch.float64),
                   skyLW=torch.tensor(390.0), netsw=torch.tensor(nsw)),
        jeb.update(js, jnp.asarray(timee), skyLW=jnp.asarray(390.0),
                   netsw=jnp.asarray(nsw)))
    assert rel_err(qsat_fn(ts.T[:, 0]), jqsat_fn(js.T[:, 0])) <= 1e-14


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_maybe_update_gates_on_the_device(kind):
    """Too early: every leaf unchanged bit for bit.  Late: the update, with
    tnextEB = NINT(timee + dtEB) (tests/test_eb.py:71-78)."""
    jeb, teb = synthetic_pair(kind, dtEB=2.0)
    assert float(teb.initial_state().tnextEB) == 2.0
    js, ts = loaded_state(jeb, seed=3)
    early = teb.maybe_update(ts, torch.tensor(1.0, dtype=torch.float64))
    for k in FACET_STATE_NAMES:
        assert torch.equal(getattr(early, k), getattr(ts, k)), k
    late = teb.maybe_update(ts, torch.tensor(2.013, dtype=torch.float64))
    assert float(late.tnextEB) == 4.0
    assert_facet_states_match(late, jeb.maybe_update(js, jnp.asarray(2.013)))
    assert not torch.equal(late.T, ts.T)


def test_facet_state_roundtrip():
    _, teb = synthetic_pair("dense")
    fs = teb.initial_state()
    back = facet_state_from_numpy(facet_state_to_numpy(fs))
    for k in FACET_STATE_NAMES:
        assert torch.equal(getattr(back, k), getattr(fs, k)), k


# --- Timedep -----------------------------------------------------------------

def test_timedep_series_match_reference(tmp_path):
    """The four series from files written here, at times before, inside,
    at a knot of and past the tables."""
    rng = np.random.default_rng(5)
    nz, nf, times = 6, 7, np.array([0.0, 10.0, 25.0, 60.0])
    rows = lambda a: "\n".join(" ".join(f"{v:.9g}" for v in r) for r in a)
    (tmp_path / "timedepsurf.inp.001").write_text(
        "# surf\n# t bctfxm bctfxp bctfym bctfyp bctfz\n" + rows(
            np.column_stack([times, rng.uniform(-0.1, 0.1, (4, 5))])) + "\n")
    blocks = ["# timedepnudge"]
    for tt in times:
        blocks.append(f"# time {tt}")
        blocks.append(rows(np.column_stack(
            [np.arange(nz) + 0.5, rng.uniform(0, 300, (nz, 4))])))
    (tmp_path / "timedepnudge.inp.001").write_text("\n".join(blocks) + "\n")
    (tmp_path / "timedeplw.inp.001").write_text(
        "# t skyLW\n" + rows(np.column_stack(
            [times, rng.uniform(300, 400, 4)])) + "\n")
    (tmp_path / "timedepsw.inp.001").write_text(
        "# t netsw per facet\n" + rows(np.column_stack(
            [times, rng.uniform(0, 500, (4, nf))])) + "\n")
    from udales_tpu.config import PhysicsConfig as JPhysics
    from udales_tpu_torch.config import (Config as TConfig,
                                         PhysicsConfig as TPhysics)
    on = dict(ltimedepsurf=True, ltimedepnudge=True, ltimedeplw=True,
              ltimedepsw=True)
    jtd = JTimedep.load(tmp_path, "001", Config(physics=JPhysics(**on)), nz,
                        dtype=np.float64)
    ttd = Timedep.load(tmp_path, "001", TConfig(physics=TPhysics(**on)), nz,
                       dtype=torch.float64)
    for timee in (-1.0, 0.0, 3.7, 10.0, 17.5, 59.99, 60.0, 1e4):
        tj, tt = jnp.asarray(timee), torch.tensor(timee, dtype=torch.float64)
        for a, b in zip(ttd.surf_fluxes(tt), jtd.surf_fluxes(tj)):
            assert rel_err(a, b) <= 1e-12
        got, ref = ttd.nudge_profiles(tt), jtd.nudge_profiles(tj)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].shape == (nz,) and rel_err(got[k], ref[k]) <= 1e-12
        assert rel_err(ttd.sky_lw(tt), jtd.sky_lw(tj)) <= 1e-12
        assert rel_err(ttd.net_sw(tt), jtd.net_sw(tj)) <= 1e-12
    # switches off, or no files: no series
    assert Timedep.load(tmp_path, "001", TConfig(), nz) is None
    only = Timedep.load(tmp_path, "001", TConfig(physics=TPhysics(
        ltimedeplw=True)), nz)
    assert only.surf_fluxes(torch.tensor(1.0)) is None
    assert only.net_sw(torch.tensor(1.0)) is None
    assert only.sky_lw(torch.tensor(1.0)) is not None


# --- periodic_eb_corr --------------------------------------------------------

@pytest.mark.parametrize("fraction,sinkbase", [(1.0, 0), (0.6, 3)])
def test_periodic_eb_corr_matches_reference(fraction, sinkbase):
    from udales_tpu.grid import Grid as JGrid
    from udales_tpu_torch.config import (Config as TConfig,
                                         EnergyBalanceConfig as TEB)
    zf = np.cumsum(1.05 ** np.arange(10)) - 0.5 * 1.05 ** np.arange(10)
    args = (8, 6, 10, 16.0, 12.0, zf)
    kw = dict(lEB=True, lperiodicEBcorr=True, fraction=fraction,
              sinkbase=sinkbase)
    ref = jforces.periodic_eb_corr(
        JGrid(*args, dtype=np.float64), Config(eb=EnergyBalanceConfig(**kw)),
        jnp.asarray(3.7), jnp.asarray(-0.02), jnp.float64)
    got = tforces.periodic_eb_corr(
        Grid(*args, dtype=np.float64), TConfig(eb=TEB(**kw)),
        torch.tensor(3.7, dtype=torch.float64),
        torch.tensor(-0.02, dtype=torch.float64))
    for a, b in zip(got, ref):
        assert float(np.abs(np.asarray(b)).max()) > 0
        assert rel_err(a, b) <= 1e-12


# --- the staged cases -----------------------------------------------------

NAM = """&RUN
iexpnr = 901
ladaptive = .true.
dtmax = 0.5
libm = .true.
/
&DOMAIN
itot = 16
jtot = 16
ktot = 16
xlen = 16.
ylen = 16.
/
&PHYSICS
ltempeq = .true.
lbuoyancy = .true.
{physics}
/
&WALLS
{walls}
iwalltemp = 2
/
&BC
thls = 290.
z0 = 0.05
z0h = 0.00035
wqsurf = 0.
/
&ENERGYBALANCE
lEB = .true.
lvfsparse = .true.
dtEB = 0.2
skyLW = 350.
nfaclyrs = 3
bldT = 293.
flrT = 289.
{eb}
/
"""

# one more wall type than the default table: a green roof (lGR = 1)
GREEN_ROOF = ("11 1 0.05 0.00035 0.25 0.95 0.1 0.2 0.2 "
              "2.0e6 2.0e6 2.0e6 0.9 0.9 0.9 5e-7 5e-7 5e-7 5e-7")

VARIANTS = {
    "base": {},
    "green-roof": dict(physics="lmoist = .true.",
                       walls="iwallmoist = 2", eb="wsoil = 280.",
                       green=True, qt0=0.006),
    "periodic-corr": dict(eb="lperiodicEBcorr = .true.\nfraction = 0.8\n"
                             "sinkbase = 6"),
    "lwritefac": dict(walls="lwritefac = .true."),
    "timedep-radiation": dict(physics="ltimedeplw = .true.\n"
                                      "ltimedepsw = .true.", timedep=True),
}


def stage_cube_case(tmp, physics="", walls="", eb="", green=False, qt0=0.0,
                    timedep=False):
    """The single-cube EB case of tests/test_sharding_hard.py, staged by
    the port's prep, with the variant's namelist lines and files.  The
    facets start 5 K above the air: htc = flux / (|utan| dT) is defined as
    0 where dT is exactly 0, which a start at one temperature would hit."""
    stl = tmp / "geom.stl"
    make_box_stl(stl, 6, 10, 6, 10, 4, 16.0, 16.0)
    counts = prepare_case(stl, tmp, PrepConfig(
        itot=16, jtot=16, ktot=16, xlen=16.0, ylen=16.0, zsize=16.0,
        expnr="901", u0=1.0, dpdx=1e-4, qt0=qt0, facT0=293.0,
        with_radiation=True, vf_subdiv=1))
    nf = counts["nfcts"]
    if green:
        # the roof facets (upward normal, above the floor type) become
        # green roofs: an authored factypes row and facet types
        with open(tmp / "factypes.inp.901", "a") as f:
            f.write(GREEN_ROOF + "\n")
        p = tmp / "facets.inp.901"
        lines = p.read_text().splitlines()
        rows = [ln.split() for ln in lines[1:]]
        n_roof = 0
        for r in rows:
            if int(float(r[0])) == 1 and float(r[3]) > 0.99:
                r[0] = "11"
                n_roof += 1
        assert n_roof > 0
        p.write_text("\n".join([lines[0]] + [" ".join(r) for r in rows])
                     + "\n")
    if timedep:
        rng = np.random.default_rng(11)
        times = np.array([0.0, 0.6, 1.4, 5.0])
        rows = lambda a: "\n".join(" ".join(f"{v:.9g}" for v in r) for r in a)
        (tmp / "timedeplw.inp.901").write_text("# t skyLW\n" + rows(
            np.column_stack([times, rng.uniform(300, 420, 4)])) + "\n")
        (tmp / "timedepsw.inp.901").write_text("# t netsw\n" + rows(
            np.column_stack([times, rng.uniform(0, 500, (4, nf))])) + "\n")
    wl = "\n".join(
        [f"nfcts = {nf}"]
        + [f"nsolpts_{w} = {counts[f'nsolpts_{w}']}" for w in "uvwc"]
        + [f"nbndpts_{w} = {counts[f'nbndpts_{w}']}" for w in "uvwc"]
        + [f"nfctsecs_{w} = {counts[f'nfctsecs_{w}']}" for w in "uvwc"]
        + [walls])
    (tmp / "namoptions.901").write_text(
        NAM.format(physics=physics, walls=wl, eb=eb))
    return tmp


@pytest.fixture(scope="module")
def cube_models(tmp_path_factory):
    """variant -> (udales_tpu model, port model), float64, CPU, lazily."""
    built = {}

    def get(variant):
        if variant not in built:
            case = stage_cube_case(tmp_path_factory.mktemp(
                variant.replace("-", "_")), **VARIANTS[variant])
            # the reference keeps at most UDALES_IBM_KCAP sections of a cell
            # in its dense slots and leaves the rest out of the lwritefac
            # htc / cth / pres sums; with room for all, its sums are whole
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("UDALES_IBM_KCAP", "8")
                jmodel = jload_case(case, "901", dtype="float64")
            assert not any(dn is not None and dn.get("_tail") is not None
                           for dn in jmodel.ibm.dense.values())
            built[variant] = (jmodel, load_case(case, "901", dtype="float64",
                                                device="cpu"), case)
        return built[variant]
    return get


def run_both(jmodel, tmodel, nsteps=5):
    """`nsteps` steps of both packages from the reference's cold start;
    returns the two final states as numpy and the number of EB fires."""
    jst = jmodel.cold_start(seed=43)
    tst = state_from_numpy(jax_state_to_numpy(jst))
    jstep = jax.jit(jmodel.step)
    fires, last = 0, 0.0
    for _ in range(nsteps):
        jst = jstep(jst)
        tst = tmodel.step(tst)
        if float(tst.fac.tEB_last) != last:
            fires, last = fires + 1, float(tst.fac.tEB_last)
    return jax_state_to_numpy(jst), state_to_numpy(tst), fires


def assert_states_match(got, ref, names=("u", "v", "w", "thl"),
                        rtol=STEP_RTOL):
    for name in names:
        for lvl in ("c", "m"):
            scale = max(1.0, float(np.abs(ref[lvl][name]).max()))
            err = float(np.abs(got[lvl][name] - ref[lvl][name]).max())
            assert err <= rtol * scale, (lvl, name, err)
    assert np.abs(got["pres"] - ref["pres"]).max() \
        <= rtol * max(1.0, np.abs(ref["pres"]).max())
    assert abs(float(got["dt"]) - float(ref["dt"])) \
        <= rtol * float(ref["dt"])
    for k in FACET_STATE_NAMES:
        assert rel_err(got["fac"][k], ref["fac"][k]) <= rtol, k


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_five_cube_steps_match_reference(cube_models, variant):
    """5 steps of the 16^3 cube case and its variants, the balance firing
    at least twice: every field and every leaf of the facet state."""
    jmodel, tmodel, _ = cube_models(variant)
    assert tmodel.eb is not None and tmodel.eb.nfcts == tmodel.ibm.nfcts
    assert (tmodel.timedep is not None) == (variant == "timedep-radiation")
    ref, got, fires = run_both(jmodel, tmodel)
    assert fires >= 2
    names = ("u", "v", "w", "thl") + (("qt",) if variant == "green-roof"
                                      else ())
    assert_states_match(got, ref, names)
    assert float(np.abs(ref["fac"]["T"] - np.asarray(
        jmodel.eb.T0)).max()) > 1e-4        # the facets really moved
    if variant == "green-roof":
        assert np.abs(ref["c"]["qt"] - 0.006).max() > 1e-8
        assert np.abs(ref["fac"]["wsoil"] - 280.0 * np.asarray(
            jmodel.eb.faclGR)).max() > 0    # the soil dried
    if variant == "lwritefac":
        # the reference indexes pres with its z-major slab index (a wrong
        # cell), so pres/pres2 are held against numpy below, not against it
        for k in ("tau_x", "tau_y", "tau_z", "htc", "cth", "tlast"):
            assert rel_err(got["facstats"][k], ref["facstats"][k]) \
                <= STEP_RTOL, k
            assert k == "tlast" or np.abs(ref["facstats"][k]).max() > 0, k
        assert np.abs(got["facstats"]["pres"]).max() > 0


def numpy_fields(shape, seed, qt=0.0):
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    w = 0.2 * rng.standard_normal((nx, ny, nz + 1))
    w[..., 0] = w[..., nz] = 0.0
    return dict(u=1.0 + 0.4 * rng.standard_normal(shape),
                v=0.3 * rng.standard_normal(shape), w=w,
                thl=290.0 + 2.0 * rng.standard_normal(shape),
                qt=qt * (1.0 + 0.2 * rng.uniform(-1, 1, shape)),
                e12=np.full(shape, 1e-4), sv=np.zeros((0,) + shape))


@pytest.mark.parametrize("variant", ["lwritefac", "green-roof"])
def test_wallfun_with_facet_state_matches_reference(cube_models, variant):
    """wallfun of both packages on one random flow and one mid-run facet
    state: tendencies, fachf, facef, hf_tot, ef_tot and the facstats."""
    from udales_tpu import state as jstate
    from udales_tpu.ops import boundary as jbnd
    from udales_tpu_torch.state import Fields
    jmodel, tmodel, _ = cube_models(variant)
    shape = tmodel.grid.shape
    arr = numpy_fields(shape, seed=21,
                       qt=0.006 if variant == "green-roof" else 0.0)
    jf = jstate.Fields(**{k: jnp.asarray(a) for k, a in arr.items()})
    tf = Fields(**{k: torch.tensor(a) for k, a in arr.items()})
    rng = np.random.default_rng(22)
    ekm, ekh = (1e-3 + 0.05 * rng.uniform(size=shape) for _ in range(2))
    pres = rng.standard_normal(shape)
    jg = jbnd.make_ghosts(jf, jnp.asarray(ekm), jnp.asarray(ekh), jmodel.cfg,
                          jmodel.grid)
    tg = make_ghosts(tf, torch.tensor(ekm), torch.tensor(ekh), tmodel.cfg,
                     tmodel.grid)
    # a facet state away from its start: warmer, with soil moisture spread
    js = jmodel.eb.initial_state()
    nf = jmodel.eb.nfcts
    T = np.asarray(js.T) + rng.uniform(-4, 6, (nf, 1))
    f = np.asarray(js.f) * rng.uniform(0.5, 1.5, (nf, 5))
    js = dataclasses.replace(
        js, T=jnp.asarray(T), qsat=jqsat_fn(jnp.asarray(T[:, 0])),
        hurel=jnp.asarray(rng.uniform(0.3, 0.9, nf)), f=jnp.asarray(f))
    js = dataclasses.replace(js, dense=jmodel.ibm.rebuild_dense_surf(
        js.T[:, 0], js.qsat, js.hurel, js.f))
    ts = facet_state_from_numpy(jax_leaves(js, FACET_STATE_NAMES))
    z = lambda s: np.zeros(s)
    zw = shape[:2] + (shape[2] + 1,)
    # the reference builds its facet-statistics tables only under lwritefac
    stats = tmodel.cfg.walls.lwritefac
    ref = jax.jit(lambda g, c, fac, p: jmodel.ibm.wallfun(
        g, c, jmodel.grid, jmodel.cfg, jnp.asarray(z(shape)),
        jnp.asarray(z(shape)), jnp.asarray(z(zw)), jnp.asarray(z(shape)),
        jnp.asarray(z(shape)), c.sv, fac, None, need_fac=True,
        need_facstats=stats, pres=p))(jg, jf, js, jnp.asarray(pres))
    got = tmodel.ibm.wallfun(
        tg, torch.tensor(z(shape)), torch.tensor(z(shape)),
        torch.tensor(z(zw)), torch.tensor(z(shape)), torch.tensor(z(shape)),
        ts, None, need_fac=True, need_facstats=True, pres=torch.tensor(pres))
    rdu, rdv, rdw, rdthl, rdqt, _, rfachf, rfacef, rhf, ref_tot, rstats = ref
    gdu, gdv, gdw, gdthl, gdqt, gfachf, gfacef, ghf, gef, gstats = got
    pairs = dict(du=(gdu, rdu), dv=(gdv, rdv), dw=(gdw, rdw),
                 dthl=(gdthl, rdthl), fachf=(gfachf, rfachf),
                 hf_tot=(ghf, rhf))
    if variant == "green-roof":
        pairs.update(dqt=(gdqt, rdqt), facef=(gfacef, rfacef),
                     ef_tot=(gef, ref_tot))
    else:
        assert float(gfacef.abs().max()) == 0.0 == float(gef)
    for name, (a, b) in pairs.items():
        assert float(np.abs(np.asarray(b)).max()) > 0, name
        assert rel_err(a, b) <= RTOL, name
    assert abs(float(gfachf.sum()) - float(ghf)) <= 1e-12 * abs(float(ghf))
    for k in ("tau_x", "tau_y", "tau_z", "htc", "cth") if stats else ():
        assert float(np.abs(np.asarray(rstats[k])).max()) > 0, k
        assert rel_err(gstats[k], rstats[k]) <= RTOL, k
    # fac_pres, fac_pres2 (modibm.f90:1475-1476): the area-weighted mean of
    # pres0 over each facet's c-sections, from the section files themselves
    sec = tmodel.ibm.sec["c"]
    act = sec.active
    pc = pres[tuple(sec.ijk[act].T)]
    for key, vals in (("pres", pc), ("pres2", pc * pc)):
        want = np.bincount(sec.fac[act], weights=vals * sec.area[act],
                           minlength=nf) / tmodel.ibm.faca
        assert np.abs(want).max() > 0
        assert rel_err(gstats[key], want) <= 1e-12, key
    assert set(gstats) == set(FACSTAT_FIELDS)
    # the live facet temperature is what the sections read: the static
    # Tfacinit gives other fluxes
    cold = tmodel.ibm.wallfun(tg, *[torch.tensor(z(s)) for s in
                                    (shape, shape, zw, shape, shape)])
    assert not torch.allclose(cold[3], gdthl)
    assert cold[5] is None and cold[9] is None


def test_wallfun_fixed_fluxes_match_reference(cube_models):
    """iwalltemp = 1 with time-interpolated fluxes `bctf` (and without) and
    iwallmoist = 1 (fixed moisture flux, green-roof facets only)."""
    from udales_tpu import state as jstate
    from udales_tpu.ibm.ibm import IBM as JIBM
    from udales_tpu.ops import boundary as jbnd
    from udales_tpu_torch.ibm.ibm import IBM
    from udales_tpu_torch.state import Fields
    jmodel, tmodel, case = cube_models("green-roof")
    rep = lambda cfg, group, **kw: dataclasses.replace(cfg, **{
        group: dataclasses.replace(getattr(cfg, group), **kw)})
    cfg = rep(tmodel.cfg, "walls", iwalltemp=1, iwallmoist=1)
    cfg = rep(cfg, "bc", bctfxm=0.01, bctfxp=-0.02, bctfym=0.04,
              bctfyp=0.03, bctfz=0.05, bcqfxm=1e-5, bcqfxp=2e-5,
              bcqfym=3e-5, bcqfyp=4e-5, bcqfz=-6e-5)
    jibm = JIBM.load(case, "901", cfg, jmodel.grid)
    tibm = IBM.load(case, "901", cfg, tmodel.grid)
    assert tibm.faclGR.any() and np.array_equal(tibm.faclGR,
                                                jibm.faclGR_dev)
    shape = tmodel.grid.shape
    arr = numpy_fields(shape, seed=31, qt=0.006)
    jf = jstate.Fields(**{k: jnp.asarray(a) for k, a in arr.items()})
    tf = Fields(**{k: torch.tensor(a) for k, a in arr.items()})
    ek = np.full(shape, 0.01)
    jg = jbnd.make_ghosts(jf, jnp.asarray(ek), jnp.asarray(ek), cfg,
                          jmodel.grid)
    tg = make_ghosts(tf, torch.tensor(ek), torch.tensor(ek), cfg, tmodel.grid)
    zw = shape[:2] + (shape[2] + 1,)
    zeros = [np.zeros(s) for s in (shape, shape, zw, shape, shape)]
    bvals = (0.011, -0.022, 0.033, 0.044, 0.055)
    for bctf in (None, bvals):
        jb = None if bctf is None else tuple(jnp.asarray(v) for v in bctf)
        tb = None if bctf is None else tuple(
            torch.tensor(v, dtype=torch.float64) for v in bctf)
        ref = jibm.wallfun(jg, jf, jmodel.grid, cfg,
                           *[jnp.asarray(a) for a in zeros], jf.sv, None, jb,
                           need_fac=True)
        got = tibm.wallfun(tg, *[torch.tensor(a) for a in zeros], None, tb,
                           need_fac=True)
        for name, a, b in (("dthl", got[3], ref[3]), ("dqt", got[4], ref[4]),
                           ("fachf", got[5], ref[6]),
                           ("facef", got[6], ref[7]),
                           ("hf_tot", got[7], ref[8]),
                           ("ef_tot", got[8], ref[9])):
            assert float(np.abs(np.asarray(b)).max()) > 0, name
            assert rel_err(a, b) <= RTOL, name
    # only the green roofs exchange moisture
    assert set(np.flatnonzero(got[6].numpy())) \
        <= set(np.flatnonzero(tibm.faclGR))


# --- FacetEB.load: sparse and dense view factors -------------------------------

def test_load_reads_sparse_and_dense_view_factors(cube_models, tmp_path):
    """The staged case's sparse triplets, and the same matrix as the dense
    netCDF-3 vf.nc.inp the reference tree ships (stored transposed), written
    here with scipy: equal view-factor products in both packages."""
    from scipy.io import netcdf_file
    jmodel, tmodel, case = cube_models("base")
    for k in ("facem", "facd", "faclam", "svf", "netsw", "T0", "BM0", "CM",
              "DM", "EM", "inAM"):
        assert rel_err(getattr(tmodel.eb, k), getattr(jmodel.eb, k)) <= 1e-14
    dense_case = tmp_path / "dense"
    shutil.copytree(case, dense_case)
    i, j, v = (a.numpy() for a in tmodel.eb.vf_sparse)
    nf = tmodel.eb.nfcts
    vf = np.zeros((nf, nf))
    vf[i, j] = v
    assert not np.allclose(vf, vf.T)
    with netcdf_file(str(dense_case / "vf.nc.inp.901"), "w") as f:
        f.createDimension("rows", nf)
        f.createDimension("columns", nf)
        var = f.createVariable("view factor", "f8", ("rows", "columns"))
        var[:] = vf.T
    nam = dense_case / "namoptions.901"
    nam.write_text(nam.read_text().replace("lvfsparse = .true.",
                                           "lvfsparse = .false."))
    jdense = jload_case(dense_case, "901", dtype="float64")
    tdense = load_case(dense_case, "901", dtype="float64", device="cpu")
    assert tdense.eb.vf_sparse is None
    assert np.array_equal(tdense.eb.vf.numpy(), vf)
    assert np.array_equal(np.asarray(jdense.eb.vf), vf)
    T = torch.tensor(np.random.default_rng(3).uniform(280, 310, (nf, 4)))
    assert rel_err(tdense.eb.calclw(T), tmodel.eb.calclw(T)) <= 1e-13
    assert rel_err(tdense.eb.calclw(T),
                   jdense.eb.calclw(jnp.asarray(T.numpy()))) <= RTOL


# --- the urban array with the balance ----------------------------------------

@pytest.fixture(scope="module")
def urban_eb(tmp_path_factory):
    """cases.stage_urban_eb(32), and the same with dtEB = 0.5, which lets
    the balance fire three times in 5 steps."""
    root = tmp_path_factory.mktemp("urban_eb")
    case = cases.stage_urban_eb(32, root)
    fast = cases.stage_urban_eb(32, root, dtEB=0.5)
    assert fast.name == "urban32eb_dtEB0.5"
    assert load_namoptions(fast / "namoptions.900").eb.dtEB == 0.5
    return case, fast


def test_stage_urban_eb_case(urban_eb):
    """The staged directory: the plain urban case's files, the radiation
    inputs, and a namelist that switches the balance on; load_case builds
    the Model with its FacetEB, on the plain case without."""
    case, _ = urban_eb
    assert case.name == "urban32eb"
    names = {p.name for p in case.iterdir()}
    assert {"svf.inp.900", "vfsparse.inp.900", "netsw.inp.900",
            "factypes.inp.900", "Tfacinit.inp.900"} <= names
    cfg = load_namoptions(case / "namoptions.900")
    assert cfg.eb.lEB and cfg.eb.lvfsparse and cfg.eb.nfaclyrs == 3
    assert cfg.eb.dtEB == 2.0 and cfg.eb.skyLW == 350.0
    model = load_case(case, "900", dtype="float64", device="cpu")
    assert model.eb is not None and model.timedep is None
    st = model.cold_start(seed=1)
    assert st.fac.T.shape == (model.ibm.nfcts, 4) and st.facstats is None
    assert float(st.fac.T.min()) > 250 and float(st.fac.T.max()) < 350
    plain = cases.stage_urban(32, case.parent)
    assert plain.name == "urban32v2"
    assert {p.name for p in plain.iterdir()} <= names
    assert load_case(plain, "900", dtype="float64", device="cpu").eb is None


def test_five_urban_eb_steps_match_reference(urban_eb):
    _, fast = urban_eb
    jmodel = jload_case(fast, "900", dtype="float64")
    tmodel = load_case(fast, "900", dtype="float64", device="cpu")
    ref, got, fires = run_both(jmodel, tmodel)
    assert fires >= 2
    assert_states_match(got, ref)
    assert float(np.abs(ref["fac"]["T"] - np.asarray(
        jmodel.eb.T0)).max()) > 1e-4


def test_model_builds_what_this_slice_ports(urban_eb):
    """Model no longer raises on lEB, lperiodicEBcorr, lwritefac, lmoist, a
    pressure top BC, BCzp = 2 or POISS_FFT3D; cold_start attaches the
    lwritefac accumulators."""
    from udales_tpu_torch.config import BCTOPM_PRESSURE, POISS_FFT3D
    case, _ = urban_eb
    base = load_case(case, "900", dtype="float64", device="cpu")
    rep = lambda group, **kw: dataclasses.replace(base.cfg, **{
        group: dataclasses.replace(getattr(base.cfg, group), **kw)})
    for cfg in (rep("eb", lperiodicEBcorr=True), rep("walls", lwritefac=True),
                rep("physics", lmoist=True),
                rep("bc", BCtopm=BCTOPM_PRESSURE), rep("bc", BCzp=2),
                rep("dynamics", ipoiss=POISS_FFT3D)):
        model = Model(cfg, base.grid, base.ibm, device="cpu")
        st = model.cold_start(seed=2)
        assert (st.facstats is not None) == cfg.walls.lwritefac
    model = Model(rep("bc", BCtopm=BCTOPM_PRESSURE), base.grid, base.ibm,
                  device="cpu")
    assert not model.pois.diag_z
