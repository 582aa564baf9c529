"""The rescale-recycle inlet generator over a longer run: the PyTorch port
against udales_tpu (CPU, float64) at 16^3 for 200 steps on the open-x
Poisson path.  The inlet slab mean of u stands above the running inlet mean
Uinl, and the top level carries a divergence of order 0.1, in both
packages alike: the port follows the reference.  ``pytest -s`` prints the
numbers that ROADMAP.md records.
"""
import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

import numpy as np

import udales_tpu.config as jconfig
from udales_tpu.ops import inletgen as jig, openbc as jopen

from udales_tpu_torch.ops import inletgen as tig

from test_torch_openbc import build_pair, jtree


def test_recycle_mean_follows_reference_over_200_steps(capsys):
    """The rescale-recycle generator on the open-x Poisson path (BCxm = 2,
    as a generator case's namelist carries it) at 16^3 for 200 steps in
    both packages: the inlet slab mean of u against the running inlet mean
    Uinl, and max|div u| of the top level, agree between the packages; the
    numbers are printed (``pytest -s``) for the record."""
    import jax
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    n = 16
    P = jconfig.BC_PROFILE
    jmodel, tmodel = build_pair(
        nx=n, ny=n, nz=n, inlet_x=jopen.BC_RECYCLE,
        physics=dict(ltempeq=True, inletav=5.0),
        bc=dict(BCxm=P, BCxT=P, Uinf=2.0, thl_top=290.0),
        driver=dict(iinletgen=1, iplane=n - 4, di=n / 2, dti=n / 2))
    jmodel.igparams = jig.InletGenParams(jmodel.cfg, jmodel.grid)
    tmodel.igparams = tig.InletGenParams(tmodel.cfg, tmodel.grid)
    jst = jmodel.cold_start(seed=5, dt0=0.02)
    tst = state_from_numpy(jtree(jst))
    jstep = jax.jit(jmodel.step)
    rows = {}
    for step in range(1, 201):
        jst, tst = jstep(jst), tmodel.step(tst)
        if step in (1, 50, 100, 200):
            rows[step] = {}
            for name, st, c in (("udales_tpu", jst, jtree(jst)["c"]),
                                ("port", tst, state_to_numpy(tst)["c"])):
                u, v, w = (np.asarray(c[k]) for k in "uvw")
                div = ((np.concatenate([u, np.asarray(c["bx"]["u"])[None]])
                        [1:] - u[:]) + (np.roll(v, -1, 1) - v)
                       + (w[..., 1:] - w[..., :-1]))
                rows[step][name] = (float(u[0].mean()),
                                    float(np.asarray(jtree(st.ig)["Uinl"]
                                                     if name == "udales_tpu"
                                                     else st.ig.Uinl).mean()),
                                    float(np.abs(div[:, :, -1]).max()),
                                    float(np.abs(div[:, :, :-1]).max()))
    with capsys.disabled():
        print("\nstep  package     inlet mean u   mean Uinl   ratio - 1   "
              "top-level |div|  interior |div|")
        for step, by in rows.items():
            for name, (inl, uinl, top, interior) in by.items():
                print(f"{step:4d}  {name:10s}  {inl:.6f}  {uinl:.6f}  "
                      f"{inl / uinl - 1:+.4e}  {top:.3e}  {interior:.3e}")
    for step, by in rows.items():
        ref, got = by["udales_tpu"], by["port"]
        for a, b in zip(got, ref):
            assert abs(a - b) <= 1e-6 * max(abs(b), 1e-3), (step, got, ref)


def generator_pair(n=16):
    """The generator case of the 200-step test at n^3 float64 in both
    packages, and udales_tpu's cold start."""
    P = jconfig.BC_PROFILE
    jmodel, tmodel = build_pair(
        nx=n, ny=n, nz=n, inlet_x=jopen.BC_RECYCLE,
        physics=dict(ltempeq=True, inletav=5.0),
        bc=dict(BCxm=P, BCxT=P, Uinf=2.0, thl_top=290.0),
        driver=dict(iinletgen=1, iplane=n - 4, di=n / 2, dti=n / 2))
    jmodel.igparams = jig.InletGenParams(jmodel.cfg, jmodel.grid)
    tmodel.igparams = tig.InletGenParams(tmodel.cfg, tmodel.grid)
    return jmodel, tmodel, jmodel.cold_start(seed=5, dt0=0.02)


def test_fortran_warm_start_builds_the_generator(tmp_path):
    """The generator case at 16^3 float64: 2 steps, the reference's Fortran
    restart files, ``warmstart_state(model=)``, 1 more step.  The warm
    State carries the generator's state, ``init_inletgen`` of the warm
    fields (the files hold none of its running means), and the step after
    it is finite."""
    import torch
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    from udales_tpu_torch.io.restart import (warmstart_state,
                                             write_state_fortran)
    _, tmodel, jst = generator_pair()
    st = tmodel.run(state_from_numpy(jtree(jst)), 2)
    write_state_fortran(tmp_path, st, "007", tmodel.cfg, ntrun=2)
    back = warmstart_state(tmp_path, "initd00000002_xxx_xxx.007", "007",
                           tmodel.cfg, tmodel.grid, model=tmodel)
    assert back.ig is not None
    for f in (back.c, st.c):       # the warm fields are the saved ones
        want = tig.init_inletgen(tmodel.cfg, tmodel.domain_grid, f,
                                 tmodel.igparams)
        for name in tig.INLETGEN_NAMES:
            assert torch.equal(getattr(back.ig, name), getattr(want, name)), \
                name
    out = state_to_numpy(tmodel.step(back))
    for part in ("c", "ig"):
        for name, a in out[part].items():
            if isinstance(a, np.ndarray):
                assert np.isfinite(a).all(), (part, name)
    assert np.isfinite(out["c"]["bx"]["u"]).all()


def test_cli_warm_starts_a_generator_case(tmp_path):
    """``python -m udales_tpu_torch`` with ``lwarmstart`` and a Fortran
    ``startfile`` on the 16^3 generator case (iinletgen = 1, BCxm = 2)
    runs to its end with code 0."""
    import subprocess
    import sys
    from pathlib import Path
    from udales_tpu_torch.cases import with_namelist
    from udales_tpu_torch.io.restart import write_state_fortran
    from udales_tpu_torch.run import load_case
    from test_torch_inletgen import write_flat_case
    case = write_flat_case(
        tmp_path / "gen", "007", 16, 16, 16,
        "&BC\nthls = 288.\nthl_top = 290.\nUinf = 2.\nBCxm = 2\nBCxT = 2\n"
        "BCxq = 2\nBCxs = 2\n/\n&DRIVER\niinletgen = 1\niplane = 12\n/\n"
        "&INLET\ndi = 8.\n/\n")
    model = load_case(case, "007", "float64", device="cpu")
    st = model.run(model.cold_start(seed=1), 2)
    warm = with_namelist(case, tmp_path / "warm", RUN=dict(
        lwarmstart=True, startfile="initd00000002_xxx_xxx.007"))
    write_state_fortran(warm, st, "007", model.cfg, ntrun=2)
    res = subprocess.run(
        [sys.executable, "-m", "udales_tpu_torch", str(warm), "--device",
         "cpu", "--dtype", "float64", "--runtime", "0.06", "--outdir",
         str(tmp_path / "out")], cwd=Path(__file__).resolve().parents[1],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "warmstart from initd00000002_xxx_xxx.007" in res.stdout
    assert "done: t=" in res.stdout
