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
