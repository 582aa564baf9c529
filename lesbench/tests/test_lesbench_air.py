"""The reference's air-quality physics (``reference/les/physics.py``): held
to oracles that come from neither code (conservation, equilibrium and the
explicit limit of the chemistry; support, linearity, symmetry and the
line integral of the sources; the drag and deposition of a uniform flow),
and, on a small street-canyon case staged from a test-local configuration
(``urban_cubes_dispersion.json`` cut to 32^3), against the program in
float64, with planted faults in the program that the comparison has to
see."""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lesbench import cases, harness
from lesbench.reference import check
from lesbench.reference.les import cases as frozen
from lesbench.reference.les import physics as air
from lesbench.reference.les.cases import with_namelist
from lesbench.reference.les.grid import Grid
from lesbench.tests.lesbench_small import dispersion_config

K1, JNO2 = 4.7e-4, 8.9e-3
MOLAR = torch.tensor([air.M_NO, air.M_NO2, air.M_O3], dtype=torch.float64)


def _species(seed=0, shape=(6, 5, 4)):
    """Positive NO, NO2, O3 (mass units) and a fourth scalar."""
    gen = torch.Generator().manual_seed(seed)
    sv = torch.rand((4,) + shape, generator=gen, dtype=torch.float64)
    return sv * torch.tensor([2.0, 1.0, 80.0, 5.0],
                             dtype=torch.float64)[:, None, None, None]


def _moles(sv):
    return sv[:3] / MOLAR[:, None, None, None]


# -- chemistry ----------------------------------------------------------------

@pytest.mark.parametrize("dt", [0.05, 1.0, 100.0])
def test_chemistry_conserves_nitrogen_and_odd_oxygen(dt):
    """NO + NO2 and NO2 + O3 keep their moles, at any step; a fourth
    scalar passes through."""
    sv = _species()
    out = air.chemistry(sv, dt, K1, JNO2)
    before, after = _moles(sv), _moles(out)
    for a, b in ((0, 1), (1, 2)):
        total = before[a] + before[b]
        assert float(((after[a] + after[b] - total) / total).abs().max()) \
            <= 1e-14
    assert torch.equal(out[3], sv[3])
    assert float((out - sv)[:3].abs().max()) > 0


def test_chemistry_leaves_the_photostationary_state():
    """JNO2 [NO2] = k1 [NO] [O3] in moles: nothing changes."""
    sv = _species(1)
    c = _moles(sv)
    sv[1] = K1 * c[0] * c[2] / JNO2 * air.M_NO2
    out = air.chemistry(sv, 10.0, K1, JNO2)
    assert float(((out - sv) / sv).abs().max()) <= 1e-14


def test_chemistry_tends_to_the_explicit_rate():
    """(chemistry(dt) - sv) / dt tends to the reactions' rate
    M (JNO2 [NO2] - k1 [NO] [O3]) as dt -> 0, to first order in dt."""
    sv = _species(2)
    c = _moles(sv)
    rate = JNO2 * c[1] - K1 * c[0] * c[2]
    want = torch.stack([air.M_NO * rate, -air.M_NO2 * rate,
                        air.M_O3 * rate])
    err = []
    for dt in (1.0, 0.1, 0.01):
        got = (air.chemistry(sv, dt, K1, JNO2)[:3] - sv[:3]) / dt
        err.append(float(((got - want) / want.abs().max()).abs().max()))
    assert err[2] < 1e-3
    assert 8.0 < err[0] / err[1] < 12.0 and 8.0 < err[1] / err[2] < 12.0


def test_chemistry_leaves_solid_cells():
    sv = _species(3)
    fluid = torch.ones(sv.shape[1:], dtype=torch.float64)
    fluid[0] = 0.0
    out = air.chemistry(sv, 1.0, K1, JNO2, fluid)
    assert torch.equal(out[:, 0], sv[:, 0])
    assert bool((out[:3, 1:] != sv[:3, 1:]).any())


# -- sources ------------------------------------------------------------------

def _grid(n=17):
    return Grid.uniform(n, n, n, float(n), float(n), float(n),
                        dtype=np.float64)


def _distance(grid, x, y, z):
    X, Y, Z = air._centres(grid, "cpu")
    return torch.sqrt((X - x) ** 2 + (Y - y) ** 2 + (Z - z) ** 2)


def test_point_source_support_linearity_and_symmetry():
    """A point source at a cell centre: zero beyond 3 sigma, positive
    within, linear in its strength, mirror-symmetric in x, y and z, and
    SS exp(-r^2 / 2 sigma^2) / volume at the centre's neighbours."""
    g, sig = _grid(), 1.7
    f1 = air.source_field(g, [[(8.5, 8.5, 8.5, 1.0, sig)]], None)[0]
    f3 = air.source_field(g, [[(8.5, 8.5, 8.5, 3.0, sig)]], None)[0]
    r = _distance(g, 8.5, 8.5, 8.5)
    assert bool((f1[r > 3 * sig] == 0).all())
    assert bool((f1[r <= 3 * sig] > 0).all())
    assert float((f3 - 3 * f1).abs().max()) <= 1e-15
    for dim in range(3):
        assert torch.equal(f1, torch.flip(f1, dims=(dim,)))
    assert float(f1[9, 8, 8]) == pytest.approx(math.exp(-1 / (2 * sig ** 2)),
                                               rel=1e-14)


def test_line_source_is_the_point_kernel_along_the_line():
    """A line along y through x = z = 8.5: the same in every cell along
    it, symmetric about it, zero beyond 3 sigma; at each distance the
    truncated point kernel summed along the line by a fine rule."""
    g, sig = _grid(), 1.3
    f = air.source_field(g, None, [[(8.5, 0.0, 8.5, 8.5, 17.0, 8.5, 2.0,
                                     sig)]])[0]
    assert float((f - f[:, :1, :]).abs().max()) == 0.0
    assert torch.equal(f, torch.flip(f, dims=(0,)))
    assert torch.equal(f, torch.flip(f, dims=(2,)))
    r = _distance(g, 8.5, 8.5, 8.5)[:, 8, :]
    assert bool((f[:, 8, :][r > 3 * sig] == 0).all())
    for i, k in ((8, 8), (9, 8), (9, 9), (10, 9), (11, 8)):
        r2 = float(r[i, k]) ** 2
        # the trapezoid rule over the chord of the 3 sigma ball
        reach = math.sqrt(9 * sig * sig - r2)
        s = torch.linspace(-reach, reach, 20001, dtype=torch.float64)
        quad = float(torch.trapezoid(torch.exp(-(r2 + s * s)
                                               / (2 * sig * sig)), s))
        assert float(f[i, 8, k]) == pytest.approx(2.0 * quad, rel=1e-8), \
            (i, k)


# -- canopy -------------------------------------------------------------------

def _uniform_flow(n, u0, v0, w0, nsv=2):
    kw = dict(dtype=torch.float64)
    return SimpleNamespace(u=torch.full((n, n, n), u0, **kw),
                           v=torch.full((n, n, n), v0, **kw),
                           w=torch.full((n, n, n + 1), w0, **kw),
                           sv=torch.rand((nsv, n, n, n), **kw) + 1.0)


def test_canopy_drag_and_deposition_in_a_uniform_flow():
    """A block of trees in a uniform flow U: at the faces inside the block
    the drag is -lad cd U |U| on each component, zero at faces outside
    it; the deposition is -lad ud sv in the trees, zero elsewhere."""
    n, lad, cd, ud = 10, 1.4, 0.25, 3e-3
    box = (slice(3, 7), slice(2, 8), slice(2, 6))
    lad_f, cd_f, ud_f = (np.zeros((n, n, n)) for _ in range(3))
    lad_f[box], cd_f[box], ud_f[box] = lad, cd, ud
    canopy = air.Canopy(lad_f, cd_f, ud_f)
    u0, v0, w0 = 1.2, -0.7, 0.3
    m = _uniform_flow(n, u0, v0, w0)
    speed = math.sqrt(u0 ** 2 + v0 ** 2 + w0 ** 2)
    zero = lambda t: torch.zeros_like(t)
    du, dv, dw, dsv = canopy.forcing(m, zero(m.u), zero(m.v), zero(m.w),
                                     zero(m.sv))
    want = lambda c: pytest.approx(-lad * cd * c * speed, rel=1e-14)
    # faces between two tree cells, and faces with no tree cell beside
    assert float(du[4:7, 2:8, 2:6].max()) == want(u0)
    assert float(du[4:7, 2:8, 2:6].min()) == want(u0)
    assert float(dv[3:7, 3:8, 2:6].min()) == want(v0)
    assert float(dv[3:7, 3:8, 2:6].max()) == want(v0)
    assert float(dw[3:7, 2:8, 3:6].min()) == want(w0)
    assert float(dw[3:7, 2:8, 3:6].max()) == want(w0)
    inside_u = torch.zeros_like(du, dtype=torch.bool)
    inside_u[3:8, 2:8, 2:6] = True
    inside_v = torch.zeros_like(dv, dtype=torch.bool)
    inside_v[3:7, 2:9, 2:6] = True
    inside_w = torch.zeros_like(dw, dtype=torch.bool)
    inside_w[3:7, 2:8, 2:7] = True
    assert float(du[~inside_u].abs().max()) == 0.0
    assert float(dv[~inside_v].abs().max()) == 0.0
    assert float(dw[~inside_w].abs().max()) == 0.0
    trees = torch.as_tensor(lad_f > 0)
    assert torch.equal(dsv[:, trees], -lad * ud * m.sv[:, trees])
    assert float(dsv[:, ~trees].abs().max()) == 0.0


# -- the small street-canyon case --------------------------------------------

@pytest.fixture(scope="module")
def small_case(tmp_path_factory):
    cfg = dispersion_config(32)
    return cfg, cases.case_dir(cfg, tmp_path_factory.mktemp("air"))


def _program(case):
    from udales_tpu_torch.run import load_case
    return load_case(case, "900", "float64", device="cpu")


def test_small_case_is_staged_and_checked(small_case):
    """The configuration stages through ``case_dir`` (which checks its
    namelist and geometry), its air-quality groups in the namelist, and
    its source rows and tree boxes written as it states them, a cell a
    row."""
    cfg, case = small_case
    cases.check_namelist(cfg, case / "namoptions.900")
    cases.check_geometry(cfg, case)
    text = (case / "namoptions.900").read_text()
    for group in ("&SCALARS", "&CHEMISTRY", "&TREES"):
        assert group in text
    air = cfg["air"]
    for kind, stem in (("lines", "scalarsourcel"), ("points",
                                                    "scalarsourcep")):
        for n, rows in enumerate(air[kind], 1):
            got = np.loadtxt(case / f"{stem}.inp.{n}.900", skiprows=2,
                             ndmin=2)
            assert got.tolist() == rows
    trees = np.loadtxt(case / "veg.inp.900", skiprows=1, dtype=int)
    want = sum((iu - il + 1) * (ju - jl + 1) * (ku - kl + 1)
               for il, iu, jl, ju, kl, ku, _ in air["trees"])
    assert len(trees) == want > 0
    assert [tuple(r) for r in trees] == frozen.tree_cells(air)
    assert np.loadtxt(case / "veg_params.inp.900", skiprows=1,
                      ndmin=2).tolist() == air["tree_params"]


def _move(kind, row, **at):
    """A change to the small configuration: row `row` of every scalar's
    `kind` rows, its values at the indices `at` (``i<index>``) set."""
    def change(cfg):
        for rows in cfg["air"][kind]:
            for key, value in at.items():
                rows[row][int(key[1:])] = value
    return change


def _set(group, key, value):
    def change(cfg):
        cfg["namelist"][group][key] = value
    return change


def _tree_box(box):
    def change(cfg):
        cfg["air"]["trees"][0] = box
    return change


@pytest.mark.parametrize("change,what", [
    # a line's 3 sigma (0.75 m) across x = 32 m, where nothing wraps
    (_move("lines", 1, i0=31.5, i3=31.5), "support leaves the domain"),
    # the stack's 3 sigma (1.5 m) above the 32 m top
    (_move("points", 0, i2=31.0), "support leaves the domain"),
    # the stack inside the first cube (x, y 4-12 m, 8 m high)
    (_move("points", 0, i2=5.0), "passes through a building"),
    # a line along y at x = 8 m runs through the first column of cubes
    (_move("lines", 0, i0=8.0, i3=8.0), "passes through a building"),
    (_tree_box([6, 7, 6, 7, 1, 2, 1]), "in a building"),
    (_tree_box([31, 33, 5, 12, 2, 3, 1]), "outside the domain"),
    (_tree_box([14, 14, 5, 12, 2, 3, 2]), "no tree_params row"),
    (_set("SCALARS", "nscasrcl", 3), "nscasrcl"),
    (_set("TREES", "ltrees", False), "ltrees"),
])
def test_a_layout_that_does_not_fit_is_refused(tmp_path, change, what):
    cfg = dispersion_config(32)
    change(cfg)
    with pytest.raises(ValueError, match=what):
        cases.case_dir(cfg, tmp_path)
    assert list(tmp_path.iterdir()) == []


def test_program_and_reference_build_the_same_sources_and_canopy(small_case):
    cfg, case = small_case
    prog = _program(case)
    ref = check.build(cfg, case, "float64", "cpu")
    src = prog.scalsources.field
    assert float(src.abs().max()) > 0
    assert float((src - ref.sources).abs().max()) <= 1e-14 * float(
        src.abs().max())
    veg, can = prog.vegetation, ref.canopy
    for a, b in ((veg.dcoef_u, can.face_x), (veg.dcoef_v, can.face_y),
                 (veg.dcoef_w, can.face_z), (veg.dep, can.deposition)):
        assert float(a.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-15 * float(a.abs().max())


# the widest gap of a sound run: both sides are float64 and evaluate the
# same equations, the reference's air physics and plain sweeps in another
# order, so they part by rounding alone, ~4e-13 of thl's range (the other
# fields ~1e-14) after the 10 steps here; 1e-11 leaves ~30x over that
SOUND = 1e-11
COMPARED = ("u", "v", "w", "thl", "pres", "sv1", "sv2", "sv3")


def _ten_steps(case, ref, fault=None, monkeypatch=None):
    """The program's State after 10 steps from its State after 2, with a
    `fault` planted in it, against the reference's from the same State."""
    from udales_tpu_torch import run as program_run
    from udales_tpu_torch.physics import ScalarSources
    prog = _program(case)
    state = prog.run(prog.cold_start(seed=5), 2)
    before = check.to_tree(state)
    veg = prog.vegetation
    if fault == "chemistry_off":
        monkeypatch.setattr(program_run, "chem_update",
                            lambda sv, dt, cfg, fluid: sv.clone())
    elif fault == "deposition_off":
        veg.dep = torch.zeros_like(veg.dep)
    elif fault == "drag_off":
        veg.dcoef_u, veg.dcoef_v, veg.dcoef_w = (
            torch.zeros_like(t) for t in (veg.dcoef_u, veg.dcoef_v,
                                          veg.dcoef_w))
    elif fault == "source_at_half":
        points, lines = ScalarSources.read(case, "900", prog.cfg)
        lines[0][0, 6] *= 0.5         # NO's first line
        prog.scalsources = ScalarSources.build(prog.cfg, prog.grid, points,
                                               lines)
    after = check.to_tree(prog.run(state, 10))
    return check.gaps(after, check.advance(ref, before, 10))


@pytest.fixture(scope="module")
def ref_model(small_case):
    cfg, case = small_case
    return check.build(cfg, case, "float64", "cpu")


def test_reference_follows_the_program_for_ten_steps(small_case, ref_model):
    gaps = _ten_steps(small_case[1], ref_model)
    assert [k for k in gaps if k.endswith("_gap")] == \
        [f"{f}_gap" for f in COMPARED] + ["dt_gap"]
    assert max(gaps[f"{f}_gap"] for f in COMPARED) <= SOUND, gaps


# each planted fault and the gaps it has to open, each at 1e4 x SOUND or
# more (the sound run reads under SOUND in every field)
FAULTS = {"chemistry_off": ("sv1", "sv2", "sv3"),
          "deposition_off": ("sv3",),
          "source_at_half": ("sv1",),
          "drag_off": ("u", "v", "w", "sv1")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_reads_far_above_a_sound_run(small_case, ref_model,
                                                  monkeypatch, fault):
    gaps = _ten_steps(small_case[1], ref_model, fault, monkeypatch)
    for f in FAULTS[fault]:
        assert gaps[f"{f}_gap"] >= 1e4 * SOUND, (f, gaps)


def test_harness_compares_the_scalars(small_case):
    """A run of the small dispersion case through the harness on the CPU
    (the program in the configuration's float32): the scalars are
    compared, the start is the seed's, and every gap lies far under the
    planted faults'."""
    cfg, case = small_case
    work = dict(entry="step", rate="step_points_per_s", steps_per_call=2,
                warm_steps=1, control="tf32", limits={})
    out = harness.run_cell(work, cfg, 2 ** 35 + 11, 0.3, False, "cpu",
                           0.0, cache=case.parent)
    gaps = out["gaps"]
    assert gaps["start_gap"] == 0 and gaps["nonfinite_leaves"] == 0
    assert max(gaps[f"{f}_gap"] for f in COMPARED) < 1e-4, gaps


@pytest.mark.parametrize("group,values,what", [
    ("PURIFS", dict(lpurif=True, npurif=1), "purifiers"),
    ("HEATPUMP", dict(lheatpump=True), "heat pumps"),
    ("SCALARS", dict(lscasrcr=True), "road-network"),
    ("PHYSICS", dict(lmoist=True), "energy balance"),
])
def test_reference_refuses_what_it_leaves_out(small_case, tmp_path, group,
                                              values, what):
    cfg, case = small_case
    other = with_namelist(case, tmp_path / "case", **{group: values})
    with pytest.raises(NotImplementedError, match=what):
        check.build(cfg, other, "float64", "cpu")
