"""The x/y process split of the port's driven open boundary, of the
``BCzp = 2`` and ``POISS_FFT3D`` routes of the Poisson solve, of
``sim.Simulation`` and of the restart of a split run, against the port on
one process and against udales_tpu on one device (CPU, float64, gloo).
The profile inlets and the inlet generator are in
tests/test_torch_split_open.py, whose helpers this file shares.

Cases at 16^3, on 2 x 2, each loaded on every rank by
``run.load_case(..., mesh=)`` from udales_tpu's cold start:

  - "drv": ``cases.stage_urban_driven(16)`` (a driver inlet replayed
    through the ``lchunkread`` window, split along y; a convective outlet;
    the building array) with records 0.05 s apart read 4 at a time, so that
    the window is refilled within its 4 steps;
  - "bczp2", "fft3d": the flat case with ``BCzp = 2`` and with
    ``POISS_FFT3D``, 2 steps;
  - "sim": ``Simulation.run`` of "drv" for 0.6 s with field dumps,
    xytdump, tkedump, the monitor and a native checkpoint, against the
    single-process ``Simulation``: every array handed to a NetCDF writer
    to 1e-9 of its largest value before the float32 cast (a second moment
    of the means it is formed from, `record_scale`; the files themselves
    to one float32 rounding), the checkpoint's datasets and the final
    State to 1e-9; then
    the Fortran restart files written from the gathered State, with the
    outlet planes in their halo, continued for 3 steps in one process
    against the uninterrupted run, to 1e-9;
  - "gensim", "treesim": the same of the flat case with the inlet
    generator (xytdump, tkedump, the recorded inlet planes) and of
    ``cases.stage_urban_dispersion(16)`` with its canopy (treedump), where
    the writers read the whole domain's generator and vegetation.
"""
import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

import numpy as np

from udales_tpu_torch import cases
from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
from udales_tpu_torch.io.restart import warmstart_state
from udales_tpu_torch.run import load_case
from udales_tpu_torch.sim import Simulation

from test_torch_io import assert_files_match
from test_torch_openbc import leaves
from test_torch_split_open import (GEN, assert_blocks, assert_close,
                                   check_against_references, flat_case,
                                   run_split)
from torch_split_worker import recording_writers

CASES = ("drv", "bczp2", "fft3d")
# the second moments <ab> - <a><b> of xytdump and the means (a, b) each is
# formed from: such a difference rounds as max|a| max|b| does, which can
# be far above its own size (thl'thl' of a thl near 300 K)
MOMENTS = {"upwpxyt": [("uxyt", "wxyt")], "wpthlpxyt": [("wxyt", "thlxyt")],
           "vpwpxyt": [("vxyt", "wxyt")], "upvpxyt": [("uxyt", "vxyt")],
           "wpqtpxyt": [("wxyt", "qtxyt")],
           "thlpthlptxy": [("thlxyt", "thlxyt")],
           "qtpqtptxy": [("qtxyt", "qtxyt")], "upuptxyc": [("uxyt", "uxyt")],
           "vpvptxyc": [("vxyt", "vxyt")], "wpwptxyc": [("wxyt", "wxyt")],
           "tketxyc": [("uxyt", "uxyt"), ("vxyt", "vxyt"), ("wxyt", "wxyt")]}
SIM_OUT = dict(lfielddump=True, fieldvars="u0,v0,w0,th,pr", tfielddump=0.3,
               lxytdump=True, ltkedump=True, tsample=0.1, tstatsdump=0.3,
               tcheck=0.3)
SIM_TIME, SIM_STEPS, MORE = 0.6, 5, 3
# the generator (dt 0.02 s) with the inlet-plane recorder, and the canopy
# of the dispersion case (dt near 0.5 s)
GEN_OUT = dict(lxytdump=True, ltkedump=True, tsample=0.02, tstatsdump=0.04,
               tcheck=0.04)
TREE_OUT = dict(ltreedump=True, lxytdump=True, tsample=0.5, tstatsdump=1.0,
                tcheck=1.0)
GEN_TIME, TREE_TIME = 0.08, 2.0


def record_scale(name, data):
    """What the array `name` of a writer's record `data` is held relative
    to: its largest value, or, for a second moment, the product of the
    largest values of the means it is formed from where that is larger."""
    peak = lambda k: float(np.abs(data[k]).max(initial=0.0))
    return max([peak(name)] + [peak(a) * peak(b)
                               for a, b in MOMENTS.get(name, ())])


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The ranks of 2 x 2 (the three cases and the Simulations), and, while
    they run, the references and the single-process Simulations."""
    root = tmp_path_factory.mktemp("driven_split")
    specs = {
        "drv": (cases.stage_urban_driven(16, root, nt=40, chunk=4,
                                         dtdriver=0.05), "900", 4),
        "bczp2": (flat_case(root, "bczp2", "&BC\nBCzp = 2\n/\n"), "007", 2),
        "fft3d": (flat_case(root, "fft3d", "&DYNAMICS\nipoiss = 2\n/\n"),
                  "007", 2),
    }
    sim_case = cases.with_namelist(specs["drv"][0], root / "sim",
                                   OUTPUT=SIM_OUT, RUN=dict(trestart=0.35))
    # the generator and the canopy: their own cold starts in this process
    sims = {
        "gensim": (cases.with_namelist(
            flat_case(root, "gen", GEN.format(12)), root / "gensim",
            OUTPUT=GEN_OUT, DRIVER=dict(lstoreplane=True)), "007",
            GEN_TIME),
        "treesim": (cases.with_namelist(
            cases.stage_urban_dispersion(16, root), root / "treesim",
            OUTPUT=TREE_OUT), "900", TREE_TIME)}
    sim_start = {name: state_to_numpy(load_case(
        d, x, "float64", device="cpu").cold_start(seed=43))
        for name, (d, x, _) in sims.items()}

    def sim_jobs(start):
        return [dict(
            name="sim", case_dir=str(sim_case), expnr="900", dtype="float64",
            state=start["drv"], sim=str(root / "sim_split"),
            runtime=SIM_TIME, restart=str(root / "restart"),
            **{"continue": MORE})] + [dict(
                name=name, case_dir=str(d), expnr=x, dtype="float64",
                state=sim_start[name], sim=str(root / f"{name}_split"),
                runtime=rt) for name, (d, x, rt) in sims.items()]

    def one_simulation(case, expnr, start, runtime, outdir):
        model = load_case(case, expnr, "float64", device="cpu")
        with recording_writers() as records:
            sim = Simulation(model, outdir)
            final = sim.run(state_from_numpy(start), runtime=runtime)
        return dict(final=state_to_numpy(final), records=dict(records),
                    ntrun=sim.ntrun)

    def single_simulations(start):
        out = {"sim": one_simulation(sim_case, "900", start["drv"],
                                     SIM_TIME, root / "sim_one")}
        for name, (d, x, rt) in sims.items():
            out[name] = one_simulation(d, x, sim_start[name], rt,
                                       root / f"{name}_one")
        # a fresh Model: the first one's stream holds its last window
        model = load_case(sim_case, "900", "float64", device="cpu")
        more = model.run(state_from_numpy(start["drv"]), SIM_STEPS + MORE)
        out["sim"]["more"] = state_to_numpy(more)
        return out
    out = run_split(root, specs, {(2, 2): CASES}, CASES, extra=sim_jobs,
                    after=single_simulations)
    return dict(out, root=root, sim_case=sim_case)


@pytest.mark.parametrize("name", CASES)
def test_driven_and_z_routes_on_2x2_match_single_process_and_jax(split,
                                                                  name):
    """The driven urban case, BCzp = 2 and POISS_FFT3D on 2 x 2: every
    leaf of the gathered State against the single process and udales_tpu
    on one device, to 1e-9."""
    check_against_references(split, name)


def test_driven_window_is_the_blocks_and_was_refilled(split):
    """Each rank's window is its y rows of the records (their times whole),
    its outlet planes its y rows; the window moved on within the run, and
    the inlet face is the interpolated driver plane."""
    from udales_tpu_torch.ops.openbc import driver_window_planes
    ranks = split["runs"][(2, 2)]
    assert_blocks(ranks, "drv", {"drv.u": "wy", "drv.w": "wy", "drv.t": "",
                                 "c.bx.thl": "y", "m.bx.u": "y",
                                 "c.u": "xy"})
    st = state_from_numpy(ranks[0]["cases"]["drv"]["gathered"])
    assert float(st.drv.t[0]) > 0.0          # not the first window
    want = driver_window_planes(st.drv, st.timee)["u"]
    assert float((st.c.u[0] - want).abs().max()) <= 1e-12


def check_simulation(split, name):
    """Simulation `name` on 2 x 2 against the single process: the same
    files; every array handed to a writer to 1e-9 of `record_scale` before
    the float32 cast, the files to one float32 rounding, a native
    checkpoint and the inlet planes' record to 1e-9, the monitor's lines;
    the final State to 1e-9 on every rank, after the same steps, with one
    gather a sampled step at most.  Returns the file names."""
    import h5py
    root, want = split["root"], split["after"][name]
    ranks = split["runs"][(2, 2)]
    names = sorted(p.name for p in (root / f"{name}_one").iterdir())
    assert names == sorted(p.name for p in (root / f"{name}_split").iterdir())
    got_rec = ranks[0]["cases"][name]["records"]
    assert sorted(got_rec) == sorted(want["records"])
    for n, recs in want["records"].items():
        got = got_rec[n]
        assert len(got) == len(recs) >= 1, n
        for (tg, dg), (tr, dr) in zip(got, recs):
            assert tg == pytest.approx(tr, rel=1e-12), n
            for k, r in dr.items():
                err = np.abs(dg[k] - r).max(initial=0.0)
                assert err <= 1e-9 * record_scale(k, dr), (n, k, err)
    for n in names:
        got, ref = root / f"{name}_split" / n, root / f"{name}_one" / n
        if n.endswith(".nc"):
            assert_files_match(got, ref, rtol=2.0 ** -23, atol=1e-12)
        elif n.endswith((".h5", ".npz")):
            if n.endswith(".h5"):
                with h5py.File(got) as fg, h5py.File(ref) as fr:
                    arrays = {}
                    fr.visititems(lambda k, v: arrays.__setitem__(
                        k, (fg[k][()], v[()]))
                        if isinstance(v, h5py.Dataset) else None)
            else:
                with np.load(got) as fg, np.load(ref) as fr:
                    arrays = {k: (fg[k], fr[k]) for k in fr.files}
            assert arrays, n
            for k, (g, r) in arrays.items():
                d = np.abs(np.asarray(g) - r).max(initial=0.0)
                assert d <= 1e-9 * max(1.0, np.abs(r).max(initial=0.0)), \
                    (n, k)
        else:
            g, r = np.loadtxt(got), np.loadtxt(ref)
            assert g.shape == r.shape and np.allclose(g, r, rtol=1e-9)
    for rank, res in enumerate(ranks):
        sim = res["cases"][name]
        assert sim["ntrun"] == want["ntrun"] >= 3
        assert 0 < sim["gathers"] <= sim["ntrun"]
        assert_close(sim["gathered"], want["final"], 1e-9,
                     f"Simulation {name} rank {rank}")
    return names


def test_simulation_on_2x2_writes_the_single_process_files(split):
    """Simulation.run of the driven case on 2 x 2 against the single
    process (`check_simulation`): field dumps, xytdump, tkedump, the
    monitor and a native checkpoint with the outlet planes."""
    names = check_simulation(split, "sim")
    assert {n.split(".")[0] for n in names} >= {
        "fielddump", "xytdump", "tkedump", "monitor"}
    import h5py
    ck = [n for n in names if n.endswith(".h5")]
    assert ck
    with h5py.File(split["root"] / "sim_one" / ck[0]) as f:
        assert "c/bx/u" in f
    assert len(split["after"]["sim"]["records"]) == 3
    assert split["after"]["sim"]["ntrun"] == SIM_STEPS


@pytest.mark.parametrize("name", ["gensim", "treesim"])
def test_simulation_of_generator_and_canopy_on_2x2(split, name):
    """Simulation.run on 2 x 2 against the single process
    (`check_simulation`) where the writers read the whole domain's inlet
    generator (xytdump and tkedump build the open-x ghosts from the
    gathered generator state; the recorded inlet planes) or its canopy
    (treedump's vegetation tendencies on the gathered fields)."""
    names = check_simulation(split, name)
    want = {"gensim": {"xytdump", "tkedump", "inletdata", "monitor"},
            "treesim": {"treedump", "xytdump", "monitor"}}[name]
    assert {n.split(".")[0] for n in names} >= want


def test_restart_of_the_split_run_continues_in_one_process(split):
    """The Fortran restart files of the split run's gathered State (outlet
    planes in the halo past the last x cell) continued for 3 steps in one
    process, and read back into the 2 x 2 mesh (each rank its blocks) and
    continued there: the uninterrupted single-process run, to 1e-9 (the
    driver window, which the stream reloads, aside)."""
    model = load_case(split["sim_case"], "900", "float64", device="cpu")
    st = warmstart_state(split["root"] / "restart",
                         f"initd{SIM_STEPS:08d}_xxx_xxx.900", "900",
                         model.cfg, model.grid, model=model)
    assert st.c.bx is not None
    got = state_to_numpy(model.run(st, MORE))
    names = [k for k, _ in leaves(got) if not k.startswith("drv")]
    assert_close(got, split["after"]["sim"]["more"], 1e-9, "continued",
                 names=names)
    for rank, res in enumerate(split["runs"][(2, 2)]):
        assert_close(res["cases"]["sim"]["continued"],
                     split["after"]["sim"]["more"],
                     1e-9, f"continued on 2 x 2, rank {rank}", names=names)
