"""The simulation driver of the port against udales_tpu (CPU, float64).

- ``Simulation.run`` of both packages on the staged 16^3 urban-EB case from
  one converted initial State, with every writer the case can have: every
  variable of every output file to 1e-6 relative (the files are float32),
  the checkpoints and the final State to 1e-8 in every leaf.
- ``python -m udales_tpu_torch`` on an 8^3 urban case in a subprocess where
  ``jax`` and ``udales_tpu`` cannot be imported.
- The in-solver test runmodes 1003, 1004 and 1005, as
  ``tests/test_runmodes.py`` runs them for the reference.
- On the card (``cuda`` marker; JAX is imported only inside the tests that
  need it): the same Simulation at 16^3 float64 on the card against the
  CPU, every array handed to a NetCDF writer to 1e-9 before its float32
  cast, and every leaf of its checkpoints (written and read by
  ``io/hdf5.py``: the card's machine has no h5py) to 1e-9:

      python -m pytest --noconftest -m cuda tests/test_torch_sim.py
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from udales_tpu_torch import cases
from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
from udales_tpu_torch.io import netcdf
from udales_tpu_torch.run import load_case
from udales_tpu_torch.sim import Simulation, execute_runmode_actions, main

from test_torch_io import assert_files_match

REPO = Path(__file__).resolve().parents[1]
N = 16
FIELDVARS = "u0,v0,w0,th,qt,pr,tx,ty,tz,hf,mu,mv,mw,mc"


def all_writers():
    """Namelist groups that switch on every writer of the urban-EB case:
    a sample every step, writes every 1 s, facet outputs, checkpoints."""
    out = dict(lfielddump=True, fieldvars=FIELDVARS, tfielddump=1.0,
               lxytdump=True, lxydump=True, lydump=True, ltdump=True,
               lytdump=True, ltkedump=True, lmintdump=True,
               lkslicedump=True, lislicedump=True, ljslicedump=True,
               kslice=3, islice=5, jslice=7, tsample=0.2, tstatsdump=1.0,
               tcheck=1.0)
    return dict(OUTPUT=out, WALLS=dict(lwritefac=True, dtfac=1.0),
                ENERGYBALANCE=dict(lwriteEBfiles=True),
                RUN=dict(trestart=1.0))


@pytest.fixture(scope="module")
def eb_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("sim")
    return cases.with_namelist(cases.stage_urban_eb(N, root, dtEB=0.5),
                               root / "all", **all_writers())


def test_simulation_matches_reference(eb_case, tmp_path, monkeypatch):
    """Both packages' Simulation.run for 2.5 s from one State: the same
    files, each NetCDF variable to 1e-6 of its largest value (and 1e-9
    absolute where it is rounding noise), each checkpoint dataset and the
    final State to 1e-8, the monitor's times and steps to its 7 digits.

    The facet pressure sums of lwritefac (``facstats.pres``/``pres2``, the
    ``pres`` and ``pres_flc`` of fac.<exp>.nc) are left out: udales_tpu
    reads `pres` at other cells than the sections' (ibm.py:738, ROADMAP
    Queue 3), the port at each section's own cell, as modibm.f90 does."""
    import h5py
    from udales_tpu.run import load_case as jload_case
    from udales_tpu.sim import Simulation as JSimulation
    from test_torch_openbc import jtree
    from test_torch_restart import assert_states_equal
    # the reference keeps at most UDALES_IBM_KCAP sections of a cell in its
    # dense slots and leaves the rest out of lwritefac's htc / cth / pres
    monkeypatch.setenv("UDALES_IBM_KCAP", "8")
    jmodel = jload_case(eb_case, "900", dtype="float64")
    tmodel = load_case(eb_case, "900", dtype="float64", device="cpu")
    jst = jmodel.cold_start(seed=43)
    tst = state_from_numpy(jtree(jst))
    jfinal = JSimulation(jmodel, tmp_path / "ref").run(jst, runtime=2.5)
    tfinal = Simulation(tmodel, tmp_path / "got").run(tst, runtime=2.5)
    got, ref = state_to_numpy(tfinal), jtree(jfinal)
    for k in ("pres", "pres2"):
        del got["facstats"][k], ref["facstats"][k]
    # every leaf the port holds (the reference's also holds its dense IBM
    # parameters and facet stacks), scaled by the port's
    assert_states_equal(ref, got, rtol=1e-8)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "got").iterdir())
    stems = {n.split(".")[0] for n in names}
    assert {"fielddump", "xytdump", "xydump", "ydump", "tdump", "ytdump",
            "tkedump", "mintdump", "kslicedump", "islicedump", "jslicedump",
            "fac", "facT", "facEB", "monitor"} <= stems
    assert sum(n.endswith(".h5") for n in names) >= 2
    for n in names:
        got, ref = tmp_path / "got" / n, tmp_path / "ref" / n
        if n.endswith(".nc"):
            g = assert_files_match(got, ref, rtol=1e-6, atol=1e-9,
                                   skip=("pres", "pres_flc")
                                   if n.startswith("fac.") else ())
            assert all(np.isfinite(v).all() for v in g.values()), n
        elif n.endswith(".h5"):
            with h5py.File(got) as fg, h5py.File(ref) as fr:
                want = {}
                fr.visititems(lambda k, v: want.__setitem__(k, v[()])
                              if isinstance(v, h5py.Dataset) else None)
                for k, r in want.items():
                    d = np.asarray(fg[k][()]) - r
                    assert np.abs(d).max(initial=0.0) <= 1e-8 * max(
                        1.0, np.abs(r).max(initial=0.0)), (n, k)
                assert dict(fg.attrs) == pytest.approx(dict(fr.attrs))
        else:
            g, r = np.loadtxt(got), np.loadtxt(ref)
            assert g.shape == r.shape and np.allclose(g, r, rtol=1e-6)


def test_cli_runs_without_jax(tmp_path):
    """``python -m udales_tpu_torch <8^3 case> --device cpu --dtype
    float64`` where neither jax nor udales_tpu can be imported: the run
    ends with code 0 and leaves the monitor, the field dump, the
    statistics and a checkpoint."""
    case = cases.with_namelist(
        cases.stage_urban(8, tmp_path / "stage"), tmp_path / "case",
        OUTPUT=dict(lfielddump=True, fieldvars="u0,w0,th,tx", tfielddump=0.5,
                    lxytdump=True, ltdump=True, tsample=0.25,
                    tstatsdump=0.5),
        RUN=dict(trestart=1.0))
    out = tmp_path / "out"
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['udales_tpu'] = None; "
            "sys.argv = ['udales_tpu_torch'] + sys.argv[1:]; "
            "runpy.run_module('udales_tpu_torch', run_name='__main__', "
            "alter_sys=True); "
            "assert not any(m.split('.')[0] in ('jax', 'udales_tpu') "
            "for m in sys.modules if sys.modules[m] is not None)")
    res = subprocess.run(
        [sys.executable, "-c", code, str(case), "--device", "cpu",
         "--dtype", "float64", "--runtime", "1.5", "--outdir", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "done: t=" in res.stdout
    names = {p.name for p in out.iterdir()}
    assert {"monitor.900.txt", "fielddump.900.nc", "xytdump.900.nc",
            "tdump.900.nc"} <= names
    assert any(n.startswith("initd") and n.endswith(".h5") for n in names)
    mon = np.loadtxt(out / "monitor.900.txt")
    assert mon[-1, 0] >= 1.5 and (mon[:, 1] > 0).all()


def test_cli_without_a_card_refuses(tmp_path):
    """The default device is the card; without one the CLI stops before it
    loads anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main([str(tmp_path)])


@pytest.fixture(scope="module")
def small_case(tmp_path_factory):
    return cases.stage_urban(8, tmp_path_factory.mktemp("runmode"))


@pytest.mark.parametrize("rm", [1003, 1004, 1005])
def test_runmode(small_case, tmp_path, rm):
    """The in-solver test runmodes return 0 on the staged case, directly
    and through the CLI (which exits with the code, before any run)."""
    m = load_case(small_case, "900", dtype="float64", device="cpu")
    m.cfg = dataclasses.replace(
        m.cfg, run=dataclasses.replace(m.cfg.run, runmode=rm))
    assert execute_runmode_actions(m, small_case) == 0
    case = cases.with_namelist(small_case, tmp_path / "rm",
                               RUN=dict(runmode=rm))
    with pytest.raises(SystemExit) as e:
        main([str(case), "--device", "cpu", "--dtype", "float64",
              "--outdir", str(tmp_path / "out")])
    assert e.value.code == 0
    assert not (tmp_path / "out").exists()


def test_normal_runmode_returns_none(small_case):
    m = load_case(small_case, "900", dtype="float64", device="cpu")
    assert execute_runmode_actions(m, small_case) is None


def test_runmode_1004_finds_a_bad_count(small_case, tmp_path):
    """A solid-point file whose length disagrees with &WALLS fails."""
    case = cases.with_namelist(small_case, tmp_path / "bad",
                               RUN=dict(runmode=1004))
    with open(case / "solid_u.txt", "a") as f:
        f.write("1 1 1\n")
    m = load_case(small_case, "900", dtype="float64", device="cpu")
    m.cfg = dataclasses.replace(
        m.cfg, run=dataclasses.replace(m.cfg.run, runmode=1004))
    assert execute_runmode_actions(m, case) == 1


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_simulation_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """Simulation with every writer (16^3 urban-EB, float64), on the card
    and on the CPU from one State: every array handed to a NetCDF writer
    agrees to 1e-9 of its largest value before the float32 cast, every
    leaf and attribute of the checkpoints (State, facet state, statistics
    accumulators) to 1e-9, and the masked kernel launched 3 times a
    step."""
    from udales_tpu_torch.io import hdf5
    from udales_tpu_torch.ops.fused_diff import fused_diff_mom
    root = tmp_path / "stage"
    case = cases.with_namelist(cases.stage_urban_eb(N, root, dtEB=0.5),
                               tmp_path / "all", **all_writers())
    records = {}
    append = netcdf.NCWriter.append

    def recording(self, time, data):
        records.setdefault(self.path, []).append(
            (time, {k: np.array(v, np.float64) for k, v in data.items()}))
        return append(self, time, data)
    monkeypatch.setattr(netcdf.NCWriter, "append", recording)
    start = None
    out = {}
    for dev in ("cpu", "cuda"):
        model = load_case(case, "900", dtype="float64", device=dev)
        if start is None:
            start = state_to_numpy(model.cold_start(seed=43))
        fused_diff_mom.masked_launch_count = 0
        sim = Simulation(model, tmp_path / dev)
        sim.run(state_from_numpy(start, device=dev), runtime=2.5)
        out[dev] = {Path(p).name: r for p, r in records.items()
                    if Path(p).parent.name == dev}
    assert fused_diff_mom.masked_launch_count == 3 * sim.ntrun
    assert sorted(out["cuda"]) == sorted(out["cpu"]) and len(out["cpu"]) >= 13
    for name, recs in out["cpu"].items():
        got = out["cuda"][name]
        assert len(got) == len(recs) >= 1, name
        for (tg, dg), (tr, dr) in zip(got, recs):
            assert tg == pytest.approx(tr, rel=1e-12), name
            for k, r in dr.items():
                err = np.abs(dg[k] - r).max(initial=0.0)
                assert err <= 1e-9 * max(1.0, np.abs(r).max(initial=0.0)), \
                    (name, k, err)

    def flat(tree, prefix=""):
        out = {f"{prefix}@{k}": np.asarray(v) for k, v in tree.attrs.items()}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {prefix + k: v})
        return out
    names = sorted(p.name for p in (tmp_path / "cpu").glob("initd*.h5"))
    assert len(names) >= 2 and names == sorted(
        p.name for p in (tmp_path / "cuda").glob("initd*.h5"))
    for name in names:
        got = flat(hdf5.read(tmp_path / "cuda" / name))
        ref = flat(hdf5.read(tmp_path / "cpu" / name))
        assert sorted(got) == sorted(ref) and "stats/xytdump/@tnext_write" \
            in ref, name
        for k, r in ref.items():
            err = np.abs(got[k] - r.astype(np.float64)).max(initial=0.0)
            assert err <= 1e-9 * max(1.0, np.abs(r).max(initial=0.0)), \
                (name, k, err)
