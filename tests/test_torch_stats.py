"""The statistics families of the port against udales_tpu (CPU, float64).

Each family of both packages is fed the same five States: five steps of the
reference, each carried into the port as numpy, of the urban-EB case (every
family but the tree dump), the dispersion case (the scalar slots and the
tree dump), the precursor-driven case and the rescale-recycle generator
(the open-boundary ghosts of ``compute_diag``), all at 16^3.  Every State
is sampled; the accumulators agree to 1e-12, and the written files hold
the same variables, equal as float32 (one rounding of the variable's
largest value, or both below 1e-12 where a variable is rounding noise).

This file holds the urban-EB and rescale-recycle cases;
``test_torch_stats_driven.py`` the dispersion and driven cases, with the
helpers of this file.
"""
import dataclasses

import numpy as np
import pytest
import torch

import udales_tpu_torch.io.stats as tstats
from udales_tpu_torch import cases
from udales_tpu_torch.convert import state_from_numpy
from udales_tpu_torch.run import load_case

from test_torch_io import assert_close, assert_files_match

N = 16
F4_RTOL = 2.0 ** -22


def _family(name):
    """name -> (build(stats module, cfg, model, outdir), method, takes
    masks, files)."""
    nsv = lambda c: c.scalars.nsv
    return {
        "xytdump": (lambda S, c, m, o: S.XYTDump(c, m.grid, o, model=m),
                    "maybe_sample", True, ["xytdump"]),
        "tdump": (lambda S, c, m, o: S.TDump(c, m.grid, o, nsv(c), model=m),
                  "maybe_sample", False, ["tdump"]),
        "tkedump": (lambda S, c, m, o: S.TKEDump(c, m.grid, o, m),
                    "maybe_sample", False, ["tkedump"]),
        "mintdump": (lambda S, c, m, o: S.MinTDump(c, m.grid, o),
                     "maybe_sample", False, ["mintdump"]),
        "treedump": (lambda S, c, m, o: S.TreeDump(c, m.grid, m.vegetation,
                                                   o),
                     "maybe_sample", False, ["treedump"]),
        "ytdump": (lambda S, c, m, o: S.YTDump(c, m.grid, o, nsv=nsv(c),
                                               model=m),
                   "maybe_sample", True, ["ytdump"]),
        "xydump": (lambda S, c, m, o: S.XYDump(c, m.grid, o, model=m),
                   "maybe_dump", True, ["xydump"]),
        "ydump": (lambda S, c, m, o: S.YDump(c, m.grid, o, nsv=nsv(c),
                                             model=m),
                  "maybe_dump", True, ["ydump"]),
        "slicedump": (lambda S, c, m, o: S.SliceDump(c, m.grid, o, nsv(c)),
                      "maybe_dump", False,
                      ["kslicedump", "islicedump", "jslicedump"]),
    }[name]


CASES = {
    "urban-eb": ["xytdump", "tdump", "tkedump", "mintdump", "ytdump",
                 "xydump", "ydump", "slicedump"],
    "dispersion": ["tdump", "ytdump", "ydump", "treedump"],
    "driven": ["xytdump", "tkedump"],
    "recycle": ["xytdump", "tkedump"],
}


def _pair(name, root):
    """(udales_tpu model, port model) of one of `CASES`."""
    from udales_tpu.run import load_case as jload_case
    if name == "recycle":
        import udales_tpu.config as jconfig
        from udales_tpu.ops import inletgen as jig, openbc as jopen
        from udales_tpu_torch.ops import inletgen as tig
        from test_torch_openbc import build_pair
        P = jconfig.BC_PROFILE
        jmodel, tmodel = build_pair(
            nx=N, ny=N, nz=N, inlet_x=jopen.BC_RECYCLE,
            physics=dict(ltempeq=True, inletav=5.0),
            bc=dict(BCxm=P, BCxT=P, Uinf=2.0, thl_top=290.0),
            driver=dict(iinletgen=1, iplane=N - 4, di=N / 2, dti=N / 2))
        jmodel.igparams = jig.InletGenParams(jmodel.cfg, jmodel.grid)
        tmodel.igparams = tig.InletGenParams(tmodel.cfg, tmodel.grid)
        return jmodel, tmodel
    case = {"urban-eb": lambda: cases.stage_urban_eb(N, root, dtEB=0.5),
            "dispersion": lambda: cases.stage_urban_dispersion(N, root),
            "driven": lambda: cases.stage_urban_driven(N, root, nt=8,
                                                       chunk=4)}[name]()
    return (jload_case(case, "900", dtype="float64"),
            load_case(case, "900", dtype="float64", device="cpu"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """case -> (udales_tpu model, port model, 5 reference States, the same
    as port States), built on first use."""
    import jax
    from test_torch_openbc import jtree
    built = {}

    def get(name):
        if name not in built:
            jmodel, tmodel = _pair(name, tmp_path_factory.mktemp(name))
            jst = jmodel.cold_start(seed=43, dt0=0.02)
            step = jax.jit(jmodel.step)
            jstates = []
            for _ in range(5):
                if jmodel.driver_stream is not None:
                    jst = jmodel.driver_stream.ensure(jst)
                jst = step(jst)
                jstates.append(jst)
            built[name] = (jmodel, tmodel, jstates,
                           [state_from_numpy(jtree(s)) for s in jstates])
        return built[name]
    return get


def _every_sample(cfg):
    """`cfg` with a sampling interval that samples every State and a write
    interval that never writes on its own."""
    return dataclasses.replace(cfg, output=dataclasses.replace(
        cfg.output, tsample=1e-9, tstatsdump=1e9, lkslicedump=True,
        lislicedump=True, ljslicedump=True, kslice=3, islice=5, jslice=7))


def _acc_numpy(acc):
    if dataclasses.is_dataclass(acc):
        acc = {f.name: getattr(acc, f.name) for f in dataclasses.fields(acc)}
    return {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in acc.items()}


HERE = ("recycle", "urban-eb")


def family_params(names):
    return [(c, f) for c in names for f in CASES[c]]


def compute_diag_matches(runs, case):
    """The interpolants and SGS fluxes of every sample, with the live
    closure (and, on the open cases, the inlet planes of the driver window
    or of the generator), to 1e-12."""
    from udales_tpu.io.stats import compute_diag as jdiag
    jmodel, tmodel, jstates, tstates = runs(case)
    for js, ts in zip(jstates, tstates):
        ref = jdiag(js, jmodel.grid, jmodel.cfg, jmodel)
        got = tstats.compute_diag(ts, tmodel.grid, tmodel.cfg, tmodel)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert_close(got[k], ref[k], k)
    assert float(got["usgs"].abs().max()) > 0


def family_matches(runs, tmp_path, case, family):
    """One family fed the five States in both packages: the accumulators
    to 1e-12 before the write, then every written variable equal as
    float32."""
    import udales_tpu.io.stats as jstats
    jmodel, tmodel, jstates, tstates = runs(case)
    build, method, takes_masks, files = _family(family)
    cfg = _every_sample(jmodel.cfg)
    jmasks = jmodel.ibm.masks if jmodel.ibm is not None else None
    tmasks = tmodel.ibm.masks if tmodel.ibm is not None else None
    for d in ("ref", "got"):
        (tmp_path / d).mkdir()
    jfam = build(jstats, cfg, jmodel, tmp_path / "ref")
    tfam = build(tstats, cfg, tmodel, tmp_path / "got")
    for js, ts in zip(jstates, tstates):
        getattr(jfam, method)(*((js, jmasks) if takes_masks else (js,)))
        getattr(tfam, method)(ts, float(ts.timee),
                              *((tmasks,) if takes_masks else ()))
    t = float(tstates[-1].timee)
    if hasattr(tfam, "acc"):
        ref, got = _acc_numpy(jfam.acc), _acc_numpy(tfam.acc)
        assert sorted(got) == sorted(ref)
        assert float(got["n"]) == 5.0
        for k in ref:
            assert_close(got[k], ref[k], f"{family}.acc.{k}")
        jfam.write(t)
        tfam.write(t)
    jfam.close()
    tfam.close()
    for stem in files:
        name = f"{stem}.{cfg.run.iexpnr:03d}.nc"
        got = assert_files_match(tmp_path / "got" / name,
                                 tmp_path / "ref" / name,
                                 F4_RTOL, atol=1e-12)
        nrec = 1 if hasattr(tfam, "acc") else 5
        assert got["time"].shape == (nrec,)
        assert all(np.isfinite(v).all() for v in got.values())


@pytest.mark.parametrize("case", HERE)
def test_compute_diag_matches_reference(runs, case):
    compute_diag_matches(runs, case)


@pytest.mark.parametrize("case,family", family_params(HERE))
def test_family_matches_reference(runs, tmp_path, case, family):
    family_matches(runs, tmp_path, case, family)
