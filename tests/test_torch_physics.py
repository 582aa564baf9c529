"""The long-tail physics of the PyTorch port (``udales_tpu_torch.physics``)
against udales_tpu's (CPU, float64).

Function by function (``chem_update``, ``ScalarSources``, ``Purifiers``,
``HeatPumps``, ``Vegetation``) the same numpy-seeded inputs go through both
packages and agree to 1e-12 * max(1, max|ref|).  Whole steps start from one
State, made by udales_tpu's ``cold_start`` and carried over as numpy, and
agree to 1e-8 relative after 5 steps in every State leaf: the staged
dispersion case with purifiers and heat pumps, and a moist case with trees
and an absorbed-shortwave field.  The physical oracles of
tests/test_physics.py (NOx conservation, total emission, photolysis,
scrubbing) run on the port alone.
"""
import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import udales_tpu.config as jconfig
from udales_tpu import physics as jphys
from udales_tpu.grid import Grid as JGrid
from udales_tpu.run import load_case as jload
from udales_tpu.state import Fields as JFields

from udales_tpu_torch import cases, physics as tphys
from udales_tpu_torch.convert import (VEGETATION_NAMES, physics_from_numpy,
                                      state_from_numpy)
from udales_tpu_torch.grid import Grid as TGrid
from udales_tpu_torch.run import load_case as tload
from udales_tpu_torch.state import Fields as TFields

from test_torch_openbc import (assert_close, build_pair, compare_states,
                               jtree, run_both, t)

NX, NY, NZ = 12, 10, 8
CHEM = jconfig.ChemistryConfig(lchem=True, k1=4.7e-4, JNO2=8.9e-3)


def grids(stretched=False):
    zf = (np.cumsum(1.1 ** np.arange(NZ)) - 0.5 * 1.1 ** np.arange(NZ)
          if stretched else np.arange(NZ) + 0.5)
    return (JGrid(NX, NY, NZ, float(NX), float(NY), zf, dtype=np.float64),
            TGrid(NX, NY, NZ, float(NX), float(NY), zf, dtype=np.float64))


def cfg_with(**groups):
    """A Config with the given groups replaced (config dataclasses of the
    reference; the port reads the same attributes)."""
    return dataclasses.replace(jconfig.Config(dtype="float64"), **groups)


def both_fields(seed, nsv=3, thl=290.0, qt=0.0):
    """The same random Fields for both packages, scalars positive."""
    rng = np.random.default_rng(seed)
    cell = lambda: rng.standard_normal((NX, NY, NZ))
    a = dict(u=1.0 + 0.3 * cell(), v=0.3 * cell(),
             w=0.2 * rng.standard_normal((NX, NY, NZ + 1)),
             thl=thl + cell(), qt=qt * (1.0 + 0.1 * cell()),
             e12=1e-3 * (2.0 + np.abs(cell())),
             sv=rng.uniform(0.1, 2.0, (nsv, NX, NY, NZ)))
    a["w"][..., 0] = a["w"][..., -1] = 0.0
    return (JFields(**{k: jnp.asarray(v) for k, v in a.items()}),
            TFields(**{k: t(v) for k, v in a.items()}))


# --- chemistry ---------------------------------------------------------------

def test_chem_update_matches_reference():
    """Four scalars (the fourth passes through), a {0,1} fluid mask and dt
    as a 0-d tensor."""
    rng = np.random.default_rng(0)
    sv = rng.uniform(0.1, 2.0, (4, NX, NY, NZ))
    IIc = (rng.uniform(size=(NX, NY, NZ)) > 0.2).astype(float)
    cfg = cfg_with(chem=CHEM)
    ref = jphys.chem_update(jnp.asarray(sv), jnp.asarray(0.7), cfg,
                            jnp.asarray(IIc))
    got = tphys.chem_update(t(sv), t(0.7), cfg, t(IIc))
    assert_close(got, ref, "chem_update")
    assert float(np.abs(np.asarray(ref)[:3] - sv[:3]).max()) > 1e-6
    assert torch.equal(got[3], t(sv[3]))
    # the Python-number mask of a case without an IBM
    assert_close(tphys.chem_update(t(sv), 0.7, cfg, 1.0),
                 jphys.chem_update(jnp.asarray(sv), 0.7, cfg,
                                   jnp.ones((NX, NY, NZ))), "IIc = 1")


def test_chem_conserves_nox_and_photolyses():
    """The port's copy of tests/test_physics.py's oracles: the null cycle
    conserves NO + NO2 and NO2 + O3 (molar); NO2 alone photolyses to NO and
    O3."""
    cfg = cfg_with(chem=CHEM)
    sv = torch.tensor(np.random.default_rng(0).uniform(0.1, 2.0,
                                                       (3, 4, 4, 4)))
    out = tphys.chem_update(sv, 1.0, cfg, torch.ones((4, 4, 4),
                                                     dtype=torch.float64))
    molar = lambda s: (s[0] / tphys.M_NO, s[1] / tphys.M_NO2,
                       s[2] / tphys.M_O3)
    no0, no20, o30 = molar(sv)
    no1, no21, o31 = molar(out)
    np.testing.assert_allclose(no1 + no21, no0 + no20, rtol=1e-12)
    np.testing.assert_allclose(o31 + no21, o30 + no20, rtol=1e-12)
    sv = torch.zeros((3, 2, 2, 2), dtype=torch.float64)
    sv[1] = 1.0
    out = tphys.chem_update(sv, 1.0, cfg, 1.0)
    assert float(out[0].min()) > 0 and float(out[2].min()) > 0
    assert float(out[1].max()) < 1.0


def _cell_species(seed):
    """Float32 NO, NO2, O3 over the dispersion cell's range (NO up to the
    stack's strength 5, NO2 up to 0.5, O3 up to its background 80)."""
    gen = torch.Generator().manual_seed(seed)
    sv = torch.rand((3, 32, 24, 16), generator=gen, dtype=torch.float64)
    return (sv * torch.tensor([5.0, 0.5, 80.0], dtype=torch.float64)
            [:, None, None, None]).float()


@pytest.mark.parametrize("dt", [0.05, 0.5])
def test_chem_update_float32_within_ulps_of_float64(dt):
    """In float32 (dt up to the cell's dtmax 0.5 s) each species lands
    within 3 ulp of the float64 update of the same float32 fields, and O3,
    the largest, within 1 ulp: ``sv + M d`` rounds the sum once, where
    ``M (sv / M + d)`` reads ~2 ulp on O3 here."""
    cfg = cfg_with(chem=CHEM)
    sv = _cell_species(0)
    mask = (torch.rand(sv.shape[1:], generator=torch.Generator()
                       .manual_seed(1)) > 0.1).float()
    got = tphys.chem_update(sv, dt, cfg, mask).double()
    want = tphys.chem_update(sv.double(), dt, cfg, mask.double())
    ulp = torch.as_tensor(np.spacing(want.float().abs().numpy()),
                          dtype=torch.float64)
    err = ((got - want).abs() / ulp).amax(dim=(1, 2, 3))
    assert float(err.max()) <= 3.0, err
    assert float(err[2]) <= 1.0, err
    assert torch.equal(got[:, mask == 0], sv.double()[:, mask == 0])


@pytest.mark.parametrize("dt", [0.05, 0.5, 5.0])
def test_chem_update_float32_keeps_moles(dt):
    """In float32, NO + NO2 and NO2 + O3 (moles, summed in float64) keep
    their totals to float32 rounding: within 2^-23 of the total."""
    cfg = cfg_with(chem=CHEM)
    sv = _cell_species(2).double()
    out = tphys.chem_update(sv.float(), dt, cfg, 1.0).double()
    molar = lambda s: (s[0] / tphys.M_NO, s[1] / tphys.M_NO2,
                       s[2] / tphys.M_O3)
    before, after = molar(sv), molar(out)
    for a, b in ((0, 1), (1, 2)):
        total = before[a] + before[b]
        drift = ((after[a] + after[b] - total) / total).abs().max()
        assert float(drift) <= 2.0 ** -23, (a, b, float(drift))
    assert float((out - sv).abs().max()) > 0


# --- scalar sources ----------------------------------------------------------

POINTS = [np.array([[4.0, 3.0, 2.0, 2.5, 0.8], [9.5, 7.0, 4.5, 1.0, 1.2]]),
          np.array([[6.0, 5.0, 1.5, 0.3, 1.0]])]
LINES = [np.array([[2.0, 0.0, 1.0, 2.0, 10.0, 1.0, 1.0, 0.7],
                   [1.0, 1.0, 3.0, 10.0, 8.0, 5.0, 0.5, 1.1]]),
         np.array([[6.0, 2.0, 1.0, 6.0, 2.0, 6.0, 2.0, 0.9]])]


@pytest.mark.parametrize("kind", ["points", "lines", "both"])
def test_scalar_sources_build_matches_reference(kind):
    jg, tg = grids(stretched=True)
    cfg = cfg_with(scalars=jconfig.ScalarsConfig(nsv=2))
    kw = dict(points=POINTS if kind != "lines" else None,
              lines=LINES if kind != "points" else None)
    ref = jphys.ScalarSources.build(cfg, jg, **kw).field
    got = tphys.ScalarSources.build(cfg, tg, **kw).field
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    assert_close(got, ref, kind)


def test_scalar_source_total_emission():
    """The port's copy of tests/test_physics.py's oracle: the volume
    integral of a point source fully inside the domain is SS (2 pi
    sigma^2)^(3/2), within 5% on the grid."""
    _, tg = grids()
    cfg = cfg_with(scalars=jconfig.ScalarsConfig(nsv=1))
    src = tphys.ScalarSources.build(
        cfg, tg, points=[np.array([[6.0, 5.0, 4.0, 2.5, 0.8]])]).field
    vol = tg.dx * tg.dy * torch.tensor(tg.dzf)[None, None, :]
    total = float((src[0] * vol).sum())
    expect = 2.5 * (2 * np.pi * 0.8 ** 2) ** 1.5
    assert abs(total - expect) / expect < 0.05, (total, expect)


# --- purifiers ---------------------------------------------------------------

# one box per flow direction; ipu 2 and 5 take their intake at the last
# cell (min(iu + 1, itot - 1)) and at a wrapped index (il - 1 = -1)
BOXES = {1: (3, 5, 2, 4, 1, 3), 2: (9, 11, 4, 6, 2, 3),
         3: (0, 2, 5, 6, 2, 4), 4: (6, 8, 7, 9, 1, 2),
         5: (4, 6, 1, 3, 2, 4), 6: (7, 9, 3, 5, 5, 7)}


@pytest.mark.parametrize("ipu", sorted(BOXES))
def test_purifiers_apply_matches_reference(ipu):
    """Velocities set in m and c, tendencies zeroed, scalars scrubbed with
    the hard-coded efficiencies [epu, 0.7, 0.0, 0.65] over five scalars;
    a second box overlapping the first."""
    jg, tg = grids(stretched=True)
    cfg = cfg_with(purifs=jconfig.PurifsConfig(lpurif=True, npurif=2,
                                               Qpu=0.6, epu=0.9))
    jf, tf = both_fields(ipu, nsv=5)
    jc, tc = both_fields(ipu + 10, nsv=5)
    rng = np.random.default_rng(ipu + 20)
    d = [rng.standard_normal((NX, NY, NZ)), rng.standard_normal((NX, NY, NZ)),
         rng.standard_normal((NX, NY, NZ + 1)),
         rng.standard_normal((5, NX, NY, NZ))]
    il, iu, jl, ju, kl, ku = BOXES[ipu]
    boxes = [(il, iu, jl, ju, kl, ku, ipu),
             (il, iu, jl, ju, kl, kl, 1 + ipu % 6)]
    ref = jphys.Purifiers(cfg, jg, [jphys.Purifier(*b) for b in boxes]).apply(
        jf, jc, *[jnp.asarray(a) for a in d])
    inputs = [t(a) for a in d]
    got = tphys.Purifiers(cfg, tg, [tphys.Purifier(*b) for b in boxes]).apply(
        tf, tc, *inputs)
    for a, b in zip(inputs, d):
        assert torch.equal(a, t(b))          # arguments untouched
    for name, g, r in (("m", got[0], ref[0]), ("c", got[1], ref[1])):
        for k in ("u", "v", "w", "sv"):
            assert_close(getattr(g, k), getattr(r, k), f"{name}.{k}")
    for k, g, r in zip(("du", "dv", "dw", "dsv"), got[2:], ref[2:]):
        assert_close(g, r, k)
    p = tphys.Purifiers(cfg, tg, [tphys.Purifier(*boxes[0])])
    _, _, vel, faces, _, axis = p.geometry(p.purifs[0])
    box = getattr(got[1], "uvw"[axis])[faces[:2] + (slice(ku, ku + 1),)]
    assert float((box - vel).abs().max()) == 0.0 and vel != 0
    assert float(torch.abs(got[5][0] - inputs[3][0]).max()) > 0
    assert torch.equal(got[5][2], inputs[3][2])   # efficiency 0


def test_purifier_scrubs_and_holds_its_flow():
    """The port's copy of tests/test_physics.py's oracle: one step of a
    flat case with a purifier box: the box velocity is Qpu / Apu and the
    scalar inside is scrubbed below its start."""
    from udales_tpu_torch.state import initial_state, profile_fields
    jmodel, tmodel = build_pair()
    cfg = dataclasses.replace(
        tmodel.cfg, purifs=jconfig.PurifsConfig(lpurif=True, npurif=1,
                                                Qpu=0.3, epu=0.9),
        scalars=jconfig.ScalarsConfig(nsv=1))
    from udales_tpu_torch.run import Model
    model = Model(cfg, tmodel.grid, device="cpu")
    model.purifiers = tphys.Purifiers(cfg, model.grid,
                                      [tphys.Purifier(6, 7, 5, 6, 2, 3, 1)])
    f = profile_fields(model.grid, np.full(NZ, 1.0), np.zeros(NZ),
                       np.full(NZ, 288.0), np.zeros(NZ), np.full(NZ, 5e-5),
                       svprof=np.ones((1, NZ)))
    st = model.step(initial_state(model.grid, f, dt0=0.02))
    assert abs(float(st.c.u[6, 5, 2]) - 0.3 / (2 * 1.0 * 2 * 1.0)) < 1e-12
    assert float(st.c.sv[0, 6:8, 5:7, 2:4].mean()) < 1.0


# --- heat pumps --------------------------------------------------------------

@pytest.mark.parametrize("lfan", [True, False], ids=["fan", "no-fan"])
def test_heatpumps_apply_matches_reference(lfan):
    """Three points, two of them in one cell (their extraction sums), on a
    stretched grid, with and without the exhaust fan."""
    jg, tg = grids(stretched=True)
    cfg = cfg_with(heatpump=jconfig.HeatpumpConfig(
        lheatpump=True, lfan_hp=lfan, nhppoints=3, QH_dot_hp=3000.0,
        Q_dot_hp=1.5))
    ijk = np.array([[4, 4, 2], [8, 3, 5], [4, 4, 2]])
    jf, tf = both_fields(5)
    jc, tc = both_fields(6)
    rng = np.random.default_rng(7)
    dw = rng.standard_normal((NX, NY, NZ + 1))
    dthl = rng.standard_normal((NX, NY, NZ))
    ref = jphys.HeatPumps(cfg, jg, ijk).apply(jf, jc, jnp.asarray(dw),
                                              jnp.asarray(dthl))
    hp = tphys.HeatPumps(cfg, tg, ijk)
    got = hp.apply(tf, tc, t(dw), t(dthl))
    for name, g, r in (("m.w", got[0].w, ref[0].w), ("c.w", got[1].w,
                                                      ref[1].w),
                       ("dw", got[2], ref[2]), ("dthl", got[3], ref[3])):
        assert_close(g, r, name)
    one = float(dthl[8, 3, 5] - got[3][8, 3, 5])
    two = float(dthl[4, 4, 2] - got[3][4, 4, 2])
    assert one > 0 and abs(two / one * tg.dzfi[5] / tg.dzfi[2] - 2) < 1e-12
    assert torch.equal(got[0].w, tf.w) != lfan
    if lfan:
        assert float(got[1].w[8, 3, 6]) == hp.w_exhaust > 0


# --- vegetation --------------------------------------------------------------

def veg_arrays(seed):
    rng = np.random.default_rng(seed)
    lad = np.zeros((NX, NY, NZ))
    lad[3:7, 2:6, 0:4] = rng.uniform(0.5, 1.5, (4, 4, 4))
    lad[10:, 8:, 1:3] = 1.0                  # wraps across x = 0 faces
    dcoef = lad * rng.uniform(0.1, 0.3, lad.shape)
    ud = np.where(lad > 0, 0.01, 0.0)
    lsize = np.where(lad > 0, 0.05, 0.0)
    rs = np.where(lad > 0, rng.uniform(50, 150, lad.shape), 0.0)
    sveg = np.where(lad > 0, rng.uniform(10, 60, lad.shape), 0.0)
    return lad, dcoef, ud, lsize, rs, sveg


@pytest.mark.parametrize("moist", [False, True], ids=["dry", "moist-sveg"])
def test_vegetation_forcing_and_diagnostics_match_reference(moist):
    """Drag on the three face grids, scalar deposition and, moist with an
    sveg field, the canopy energy balance; then the treedump diagnostics."""
    jg, tg = grids(stretched=True)
    cfg = cfg_with(physics=jconfig.PhysicsConfig(ltempeq=True, lmoist=moist),
                   trees=jconfig.TreesConfig(ltrees=True))
    lad, dcoef, ud, lsize, rs, sveg = veg_arrays(3)
    sv_ = sveg if moist else None
    jveg = jphys.Vegetation(cfg, jg, lad, dcoef, ud, lsize, rs, sveg=sv_)
    tveg = tphys.Vegetation(cfg, tg, lad, dcoef, ud, lsize, rs, sveg=sv_)
    assert tveg.has_canopy == jveg.has_canopy is True
    for k in ("dcoef_u", "dcoef_v", "dcoef_w", "lsize", "rs"):
        assert_close(getattr(tveg, k), getattr(jveg, k), k)
    jf, tf = both_fields(4, nsv=2, thl=293.0, qt=0.008 if moist else 0.0)
    rng = np.random.default_rng(8)
    d = [rng.standard_normal((NX, NY, NZ)), rng.standard_normal((NX, NY, NZ)),
         rng.standard_normal((NX, NY, NZ + 1)),
         rng.standard_normal((NX, NY, NZ)), rng.standard_normal((NX, NY, NZ)),
         rng.standard_normal((2, NX, NY, NZ))]
    ref = jveg.forcing(jf, jg, cfg, *[jnp.asarray(a) for a in d])
    got = tveg.forcing(tf, tg, cfg, *[t(a) for a in d])
    for name, g, r, a in zip(("du", "dv", "dw", "dthl", "dqt", "dsv"), got,
                             ref, d):
        assert_close(g, r, name)
        changed = float(np.abs(np.asarray(r) - a).max()) > 1e-9
        assert changed == (name not in ("dthl", "dqt") or moist), name
    rd, gd = jveg.diagnostics(jf), tveg.diagnostics(tf)
    assert rd.keys() == gd.keys()
    for k in rd:
        assert_close(gd[k], rd[k], k)
    assert float(np.abs(np.asarray(rd["tr_omega"])).max()) > 0 or not moist
    assert float(np.abs(np.asarray(rd["tr_sv2"])).max()) > 0


# --- the staged dispersion case ----------------------------------------------

@pytest.fixture(scope="module")
def dispersion_pu_hp(tmp_path_factory):
    return cases.stage_urban_dispersion(16, tmp_path_factory.mktemp("disp"),
                                        purifiers=True, heatpumps=True)


def test_loaded_physics_match_reference(dispersion_pu_hp):
    """load_case of both packages on the staged case with purifiers and heat
    pumps: the same source field, vegetation arrays, boxes and points; the
    reference's objects carried over by ``convert.physics_from_numpy`` equal
    the port's own."""
    jm = jload(dispersion_pu_hp, "900", dtype="float64")
    tm = tload(dispersion_pu_hp, "900", dtype="float64", device="cpu")
    assert_close(tm.scalsources.field, jm.scalsources.field, "sources")
    assert float(tm.scalsources.field[2].abs().max()) == 0.0
    assert float(tm.scalsources.field[1].sum()) == pytest.approx(
        0.1 * float(tm.scalsources.field[0].sum()), rel=1e-12)
    veg = {k: getattr(jm.vegetation, k) for k in VEGETATION_NAMES}
    for k, v in veg.items():
        if v is not None:
            assert_close(getattr(tm.vegetation, k), v, k)
    assert tm.vegetation.sveg is None and tm.vegetation.has_canopy
    assert [dataclasses.astuple(p) for p in tm.purifiers.purifs] \
        == [dataclasses.astuple(p) for p in jm.purifiers.purifs]
    assert {p.ipu for p in tm.purifiers.purifs} == {1, 3}
    np.testing.assert_array_equal(tm.heatpumps.ijk, jm.heatpumps.ijk)
    assert len(tm.heatpumps.ijk) == 8
    fresh = tload(dispersion_pu_hp, "900", dtype="float64", device="cpu")
    for k in ("scalsources", "vegetation", "purifiers", "heatpumps"):
        setattr(fresh, k, None)
    physics_from_numpy(fresh, dict(
        scalsources=np.asarray(jm.scalsources.field),
        vegetation={k: None if v is None else np.asarray(v)
                    for k, v in veg.items()},
        purifiers=[dataclasses.astuple(p) for p in jm.purifiers.purifs],
        heatpumps=np.asarray(jm.heatpumps.ijk)))
    assert torch.equal(fresh.scalsources.field, tm.scalsources.field)
    for k in VEGETATION_NAMES[:-1]:
        assert torch.equal(getattr(fresh.vegetation, k),
                           getattr(tm.vegetation, k)), k
    assert fresh.purifiers.purifs == tm.purifiers.purifs
    assert torch.equal(fresh.heatpumps.thl_src, tm.heatpumps.thl_src)


def test_dispersion_with_purifiers_and_heat_pumps_matches_reference(
        dispersion_pu_hp):
    """stage_urban_dispersion(16, purifiers=True, heatpumps=True) in both
    packages: 5 adaptive steps from udales_tpu's cold start, every State
    leaf to 1e-8; the purifier boxes hold Qpu / Apu and the exhaust faces
    are near the fan velocity."""
    jm = jload(dispersion_pu_hp, "900", dtype="float64")
    tm = tload(dispersion_pu_hp, "900", dtype="float64", device="cpu")
    jst = jm.cold_start(seed=43)
    tst = state_from_numpy(jtree(jst.replace(ibmp=None)))
    jstep = jax.jit(jm.step)
    for _ in range(5):
        jst, tst = jstep(jst), tm.step(tst)
    names = compare_states(tst, jst.replace(ibmp=None))
    assert {"c.sv", "m.sv", "c.u", "pres", "dt"} <= set(names)
    for p in tm.purifiers.purifs:
        _, _, vel, faces, _, axis = tm.purifiers.geometry(p)
        box = getattr(tst.c, "uvw"[axis])[faces]
        assert float((box - vel).abs().max()) <= 1e-12 * abs(vel)
    # the fan sets w above each pump before the projection, which then
    # moves it a little (as in the reference)
    i, j, k = tm.heatpumps.ijk.T
    wx = tm.heatpumps.w_exhaust
    assert float((tst.c.w[i, j, k + 1] - wx).abs().max()) < 0.02 * wx


def test_moist_trees_with_sveg_match_reference():
    """A moist flat case with trees that carry an absorbed-shortwave field
    (the canopy energy balance on) and two scalars deposited on the leaves:
    5 steps, every State leaf to 1e-8."""
    physics = dict(ltempeq=True, lmoist=True)
    jmodel, tmodel = build_pair(physics=physics)
    scal = jconfig.ScalarsConfig(nsv=2)
    trees = jconfig.TreesConfig(ltrees=True)
    from udales_tpu.run import Model as JModel
    from udales_tpu_torch.run import Model as TModel
    jcfg = dataclasses.replace(jmodel.cfg, scalars=scal, trees=trees)
    jm = JModel(jcfg, jmodel.grid, dataclasses.replace(
        jmodel.inputs, scalar=np.stack([np.full(NZ, 1.0),
                                        np.linspace(0.5, 2.0, NZ)])))
    tm = TModel(jcfg, tmodel.grid, device="cpu")
    tm.inputs = jm.inputs
    for k in ("dpdxl", "dpdyl", "ug", "vg", "thlpcar", "whls", "dqtdtls"):
        setattr(tm, k, getattr(tmodel, k))
    lad, dcoef, ud, lsize, rs, sveg = veg_arrays(5)
    jm.vegetation = jphys.Vegetation(jcfg, jm.grid, lad, dcoef, ud, lsize,
                                     rs, sveg=sveg)
    tm.vegetation = tphys.Vegetation(jcfg, tm.grid, lad, dcoef, ud, lsize,
                                     rs, sveg=sveg)
    jst = jm.cold_start(seed=3, dt0=0.02)
    jst = jst.replace(m=dataclasses.replace(jst.m, qt=jst.m.qt + 0.008),
                      c=dataclasses.replace(jst.c, qt=jst.c.qt + 0.008))
    jst, tst = run_both(jm, tm, jst)
    assert "c.sv" in compare_states(tst, jst)
    assert float(tst.c.sv[0, 3:7, 2:6, 0].mean()) < 1.0
