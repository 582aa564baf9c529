"""The one-equation TKE closure of the PyTorch port against udales_tpu
(CPU, float64): ``oneeqn_closure`` (with its length scale zlt),
``tke_sources`` and ``diff_e`` on numpy-seeded inputs to 1e-12 * max(1,
max|ref|), and 5 whole steps from one State to 1e-8 relative in every State
leaf (case (iv) of the long-tail physics): the flat case with chemistry on
three scalars, and the dispersion array staged with ``sgs="oneeqn"``.
"""
import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

import dataclasses

import jax.numpy as jnp
import numpy as np

import udales_tpu.config as jconfig
from udales_tpu.ops import boundary as jbnd, subgrid as jsgs

import udales_tpu_torch.config as tconfig
from udales_tpu_torch import cases
from udales_tpu_torch.ops import boundary as tbnd, subgrid as tsgs

from test_torch_dispersion import disp_root, five_case_steps, staged_pair  # noqa: F401
from test_torch_openbc import NX, NY, NZ, assert_close, run_both, t
from test_torch_scalars import both_fields, flat_pair, grids


# --- function by function ---------------------------------------------------

def oneeqn_env(seed):
    cfg = jconfig.Config(dtype="float64",
                         subgrid=jconfig.SubgridConfig(loneeqn=True,
                                                       model=jconfig.SGS_ONEEQN))
    jg, tg = grids()
    jf, tf = both_fields(seed, nsv=0)
    rng = np.random.default_rng(seed + 1)
    # stable and unstable levels mixed
    dthvdz = rng.standard_normal((NX, NY, NZ)) * 0.01
    ekm, ekh = (rng.uniform(0.05, 0.5, (NX, NY, NZ)) for _ in range(2))
    jgh = jbnd.make_ghosts(jf, jnp.asarray(ekm), jnp.asarray(ekh), cfg, jg)
    tgh = tbnd.make_ghosts(tf, t(ekm), t(ekh), cfg, tg)
    return cfg, jg, tg, jf, tf, jgh, tgh, dthvdz, ekm, ekh


def test_oneeqn_closure_matches_reference():
    cfg, jg, tg, jf, tf, jgh, tgh, dthvdz, _, _ = oneeqn_env(21)
    ref = jsgs.closure(jgh, jg, cfg, e12=jf.e12, dthvdz=jnp.asarray(dthvdz),
                       thl=jf.thl, thvs=295.0)
    got = tsgs.closure(tgh, tg, cfg, e12=tf.e12, dthvdz=t(dthvdz),
                       thl=tf.thl, thvs=295.0)
    for name, g, r in zip(("ekm", "ekh", "zlt"), got, ref):
        assert_close(g, r, name)
    delta = tg.delta[None, None, :]
    zlt = got[2].numpy()
    assert (zlt < delta - 1e-12).any() and (zlt == delta).any()


def test_tke_sources_and_diff_e_match_reference():
    cfg, jg, tg, jf, tf, jgh, tgh, dthvdz, ekm, ekh = oneeqn_env(31)
    zlt = np.random.default_rng(32).uniform(0.2, 1.0, (NX, NY, NZ))
    ref = jsgs.tke_sources(jgh, jg, cfg, jf.e12, jnp.asarray(ekm),
                           jnp.asarray(ekh), jnp.asarray(dthvdz),
                           jnp.asarray(zlt), 295.0)
    got = tsgs.tke_sources(tgh, tg, cfg, tf.e12, t(ekm), t(ekh), t(dthvdz),
                           t(zlt), 295.0)
    assert_close(got, ref, "tke_sources")
    assert float(got[..., 0].abs().max()) == 0.0
    assert_close(tsgs.diff_e(tgh, tg), jsgs.diff_e(jgh, jg), "diff_e")


# --- whole steps -------------------------------------------------------------

@pytest.mark.parametrize("where", ["flat", "urban"])
def test_oneeqn_steps_match_reference(disp_root, where):
    """(iv) the one-equation closure: the flat case with chemistry on three
    scalars, and the dispersion array with ``sgs="oneeqn"``; 5 steps, every
    leaf to 1e-8; e12 moved and stays at or above e12min."""
    if where == "flat":
        jm, tm = flat_pair(nsv=3, subgrid=jconfig.SubgridConfig(
            loneeqn=True, model=jconfig.SGS_ONEEQN),
            chem=jconfig.ChemistryConfig(lchem=True, k1=4.7e-4,
                                         JNO2=8.9e-3))
        jst = jm.cold_start(seed=3, dt0=0.02)
        jst = jst.replace(m=dataclasses.replace(jst.m, e12=jst.m.e12 + 0.01),
                          c=dataclasses.replace(jst.c, e12=jst.c.e12 + 0.01))
        _, tst = run_both(jm, tm, jst)
    else:
        jm, tm = staged_pair(cases.stage_urban_dispersion(16, disp_root,
                                                          sgs="oneeqn"))
        assert tm.cfg.subgrid.model == tconfig.SGS_ONEEQN
        tst = five_case_steps(jm, tm)
    e12 = tst.c.e12
    assert float(e12.min()) >= tconfig.const.e12min
    assert float(e12.max()) > 2 * tconfig.const.e12min


