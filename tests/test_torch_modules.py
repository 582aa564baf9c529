"""Per-module parity of the PyTorch port against udales_tpu (CPU, float64).

Each case feeds the same numpy-seeded inputs through a udales_tpu function
and its udales_tpu_torch counterpart.  The port keeps the reference's
arithmetic order, so the tolerance is 1e-12 * max(1, max|ref|): a few ulps
of float64, far below any indexing or formula error.
"""
import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

import dataclasses
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from udales_tpu import state as jstate
from udales_tpu.config import (BCBOTM_WFNEUTRAL, BCBOT_WF, BCTOPM_NOSLIP,
                               BCTOP_VALUE, SGS_DNS, SGS_SMAGORINSKY,
                               BCConfig, Config, DomainConfig, PhysicsConfig,
                               SubgridConfig, WallsConfig)
from udales_tpu.grid import Grid as JGrid
from udales_tpu.ibm import bottom as jbottom, wallfn as jwallfn
from udales_tpu.ops import (advection as jadv, boundary as jbnd,
                            forces as jforces, halo as jhalo,
                            subgrid as jsgs, thermo as jthermo)

from udales_tpu_torch import state as tstate
from udales_tpu_torch.grid import Grid as TGrid
from udales_tpu_torch.ibm import bottom as tbottom, wallfn as twallfn
from udales_tpu_torch.ops import (advection as tadv, boundary as tbnd,
                                  forces as tforces, halo as thalo,
                                  subgrid as tsgs, thermo as tthermo)

RTOL = 1e-12
NX, NY, NZ = 12, 10, 8
REPO = Path(__file__).resolve().parents[1]


def assert_close(got, ref, rtol=RTOL, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = rtol * max(1.0, float(np.abs(ref).max(initial=0.0)))
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= tol, f"{what}: max abs err {err:.3e} > {tol:.3e}"


def t(a):
    return torch.tensor(np.asarray(a))


def _cfg(name):
    base = Config(domain=DomainConfig(itot=NX, jtot=NY, ktot=NZ,
                                      xlen=float(NX), ylen=float(NY)),
                  walls=WallsConfig(lbottom=True),
                  bc=BCConfig(z0=0.03, z0h=0.003, thls=288.0),
                  dtype="float64")
    if name == "flat":
        return base
    if name == "warm":   # buoyant, heated floor, no-slip top, Coriolis
        return dataclasses.replace(
            base,
            physics=PhysicsConfig(ltempeq=True, lbuoyancy=True, lcoriol=True,
                                  luvolflowr=True, lvvolflowr=True),
            subgrid=SubgridConfig(lbuoycorr=True),
            bc=dataclasses.replace(base.bc, BCbotT=BCBOT_WF,
                                   BCtopm=BCTOPM_NOSLIP, Uinf=1.0,
                                   wttop=0.01, thls=287.5))
    if name == "neutral":  # neutral floor law, geostrophic forcing, value top
        return dataclasses.replace(
            base,
            physics=PhysicsConfig(ltempeq=True, lprofforc=True),
            subgrid=SubgridConfig(model=SGS_SMAGORINSKY),
            bc=dataclasses.replace(base.bc, BCbotm=BCBOTM_WFNEUTRAL,
                                   BCtopT=BCTOP_VALUE, thl_top=290.0))
    raise KeyError(name)


@lru_cache(maxsize=None)
def env(name):
    """Both packages' grid, fields, ghosts and thermodynamics for config
    `name`, built from one numpy seed on a stretched z grid."""
    cfg = _cfg(name)
    zf = np.cumsum(1.07 ** np.arange(NZ)) - 0.5 * 1.07 ** np.arange(NZ)
    jg_ = JGrid(NX, NY, NZ, float(NX), float(NY), zf, dtype=np.float64)
    tg_ = TGrid(NX, NY, NZ, float(NX), float(NY), zf, dtype=np.float64)
    rng = np.random.default_rng(11)
    c3 = (NX, NY, NZ)
    arr = dict(u=1.0 + 0.3 * rng.standard_normal(c3),
               v=0.3 * rng.standard_normal(c3),
               w=0.2 * rng.standard_normal((NX, NY, NZ + 1)),
               thl=288.0 + 0.5 * rng.standard_normal(c3),
               qt=1e-3 * rng.uniform(size=c3),
               e12=5e-5 + 1e-3 * rng.uniform(size=c3),
               sv=np.zeros((0,) + c3))
    ekm = 1e-3 + 0.05 * rng.uniform(size=c3)
    ekh = 1e-3 + 0.05 * rng.uniform(size=c3)
    jf = jstate.Fields(**{k: jnp.asarray(a) for k, a in arr.items()})
    tf = tstate.Fields(**{k: t(a) for k, a in arr.items()})
    jgh = jbnd.make_ghosts(jf, jnp.asarray(ekm), jnp.asarray(ekh), cfg, jg_)
    # port functions downstream of the ghosts get the reference's ghosts,
    # so each case isolates one module
    tgh = tbnd.Ghosts(**{f.name: (None if getattr(jgh, f.name) is None
                                  else t(getattr(jgh, f.name)))
                         for f in dataclasses.fields(jbnd.Ghosts)})
    jth = jthermo.thermodynamics(jf, cfg, jg_)
    return dict(cfg=cfg, jgrid=jg_, tgrid=tg_, arr=arr, ekm=ekm, ekh=ekh,
                jf=jf, tf=tf, jgh=jgh, tgh=tgh, jth=jth, rng=rng)


# --- the cases: each returns [(label, port result, reference result)] -----

def case_ghosts(e):
    tgh = tbnd.make_ghosts(e["tf"], t(e["ekm"]), t(e["ekh"]), e["cfg"],
                           e["tgrid"])
    return [(k, getattr(tgh, k), getattr(e["jgh"], k))
            for k in ("u", "v", "w", "thl", "qt", "e12", "ekm", "ekh")]


def case_thermodynamics(e):
    tth = tthermo.thermodynamics(e["tf"], e["cfg"], e["tgrid"])
    return [(f.name, getattr(tth, f.name), getattr(e["jth"], f.name))
            for f in dataclasses.fields(tthermo.ThermoDiag)]


def case_avexy_masked(e):
    mask = (e["rng"].uniform(size=(NX, NY, NZ)) > 0.3).astype(float)
    mask[..., 2] = 0.0   # an all-solid level gives the -999 sentinel
    f = e["arr"]["u"]
    return [("masked", tthermo.avexy_masked(t(f), t(mask)),
             jthermo.avexy_masked(jnp.asarray(f), jnp.asarray(mask))),
            ("all fluid", tthermo.avexy_masked(t(f)),
             jthermo.avexy_masked(jnp.asarray(f), jnp.ones_like(f)))]


def case_closure(e):
    th = e["jth"]
    thvs = e["cfg"].bc.thls
    tk = tsgs.closure(e["tgh"], e["tgrid"], e["cfg"], e12=e["tf"].e12,
                      dthvdz=t(th.dthvdz), thl=e["tf"].thl, thvs=thvs)
    jk = jsgs.closure(e["jgh"], e["jgrid"], e["cfg"], e12=e["jf"].e12,
                      dthvdz=th.dthvdz, thl=e["jf"].thl, thvs=thvs)
    return [("ekm", tk[0], jk[0]), ("ekh", tk[1], jk[1])]


def case_closure_dns(e):
    cfg = dataclasses.replace(e["cfg"], subgrid=SubgridConfig(model=SGS_DNS))
    tk = tsgs.closure(e["tgh"], e["tgrid"], cfg)
    jk = jsgs.closure(e["jgh"], e["jgrid"], cfg)
    return [("ekm", tk[0], jk[0]), ("ekh", tk[1], jk[1])]


def case_advection(e):
    tg, jg = e["tgh"], e["jgh"]
    return [("adv_u", tadv.adv_u(tg, e["tgrid"]), jadv.adv_u(jg, e["jgrid"])),
            ("adv_v", tadv.adv_v(tg, e["tgrid"]), jadv.adv_v(jg, e["jgrid"])),
            ("adv_w", tadv.adv_w(tg, e["tgrid"]), jadv.adv_w(jg, e["jgrid"])),
            ("adv_c2", tadv.adv_c2(tg.thl, tg, e["tgrid"]),
             jadv.adv_c2(jg.thl, jg, e["jgrid"]))]


def case_diff_c(e):
    tg, jg = e["tgh"], e["jgh"]
    M = (e["rng"].uniform(size=tg.thl.shape) > 0.2).astype(float)
    return [("plain", tsgs.diff_c(tg.thl, tg.ekh, e["tgrid"]),
             jsgs.diff_c(jg.thl, jg.ekh, e["jgrid"])),
            ("masked", tsgs.diff_c(tg.thl, tg.ekh, e["tgrid"], M=t(M)),
             jsgs.diff_c(jg.thl, jg.ekh, e["jgrid"], M=jnp.asarray(M)))]


def case_diff_masked(e):
    tg, jg = e["tgh"], e["jgh"]
    out = []
    for name, shape in (("u", tg.u.shape), ("v", tg.v.shape),
                        ("w", tg.w.shape)):
        M = (e["rng"].uniform(size=shape) > 0.2).astype(float)
        tfn, jfn = getattr(tsgs, f"diff_{name}"), getattr(jsgs, f"diff_{name}")
        out.append((f"diff_{name}", tfn(tg, e["tgrid"], M=t(M)),
                    jfn(jg, e["jgrid"], M=jnp.asarray(M))))
    return out


def case_bottom(e):
    tb = tbottom.bottom_tendencies(e["tgh"], e["cfg"], e["tgrid"])
    jb = jbottom.bottom_tendencies(e["jgh"], e["cfg"], e["jgrid"])
    return [(k, a, b) for k, a, b in zip(("du", "dv", "dthl", "dqt"), tb, jb)]


def case_forces(e):
    th = e["jth"]
    dpdx = e["rng"].standard_normal(NZ) * 1e-4
    dpdy = e["rng"].standard_normal(NZ) * 1e-4
    tfo = tforces.forces(e["tgh"], e["tgrid"], e["cfg"], t(dpdx), t(dpdy),
                         t(th.thv0h), t(th.thvh))
    jfo = jforces.forces(e["jgh"], e["jgrid"], e["cfg"], jnp.asarray(dpdx),
                         jnp.asarray(dpdy), th.thv0h, th.thvh)
    return [(k, a, b) for k, a, b in zip(("du", "dv", "dw"), tfo, jfo)]


def case_coriolis(e):
    ug = 1.0 + 0.1 * e["rng"].standard_normal(NZ)
    vg = 0.1 * e["rng"].standard_normal(NZ)
    tc = tforces.coriolis(e["tgh"], e["tgrid"], e["cfg"], t(ug), t(vg))
    jc = jforces.coriolis(e["jgh"], e["jgrid"], e["cfg"], jnp.asarray(ug),
                          jnp.asarray(vg))
    return [(k, a, b) for k, a, b in zip(("du", "dv", "dw"), tc, jc)]


def case_masscorr(e):
    up = e["arr"]["u"] * 0.01
    vp = e["arr"]["v"] * 0.01
    ones = np.ones((NX, NY, NZ))
    rk3coef = 0.05
    trk = torch.tensor(rk3coef, dtype=torch.float64)
    return [("u", tforces.masscorr_uvol(t(up), e["tf"].u, e["tgrid"],
                                        e["cfg"], trk),
             jforces.masscorr_uvol(jnp.asarray(up), e["jf"].u, e["jgrid"],
                                   e["cfg"], jnp.asarray(rk3coef),
                                   jnp.asarray(ones))),
            ("v", tforces.masscorr_vvol(t(vp), e["tf"].v, e["tgrid"],
                                        e["cfg"], trk),
             jforces.masscorr_vvol(jnp.asarray(vp), e["jf"].v, e["jgrid"],
                                   e["cfg"], jnp.asarray(rk3coef),
                                   jnp.asarray(ones)))]


def case_wallfn(e):
    rng = e["rng"]
    Ribl = np.concatenate([rng.uniform(-2.0, -1e-6, 50),
                           rng.uniform(1e-6, 0.5, 50)])
    uInt = rng.uniform(1e-4, 4.0, 100)
    dT = rng.standard_normal(100)
    logdz, logzh, sqdz = np.log(0.5 / 0.03), np.log(10.0), np.sqrt(0.5 / 0.03)
    tf_, th_ = twallfn.unoh(logdz, logzh, sqdz, t(uInt), t(dT), t(Ribl), 0.71)
    jf_, jh_ = jwallfn.unoh(logdz, logzh, sqdz, jnp.asarray(uInt),
                            jnp.asarray(dT), jnp.asarray(Ribl), 0.71)
    return [("unom", twallfn.unom(logdz, logzh, sqdz, t(Ribl), 0.71),
             jwallfn.unom(logdz, logzh, sqdz, jnp.asarray(Ribl), 0.71)),
            ("unoh flux", tf_, jf_), ("unoh cth", th_, jh_),
            ("ctm_neutral", np.asarray(twallfn.ctm_neutral(logdz)),
             jwallfn.ctm_neutral(logdz))]


def case_halo(e):
    f = e["arr"]["u"]
    lo, hi = f[..., :1] * 2.0, f[..., -1:] - 1.0
    return [("pad_periodic_xy h=1", thalo.pad_periodic_xy(t(f), 1),
             jhalo.pad_periodic_xy(jnp.asarray(f), 1)),
            ("pad_periodic_xy h=2", thalo.pad_periodic_xy(t(f), 2),
             jhalo.pad_periodic_xy(jnp.asarray(f), 2)),
            ("pad_axis", thalo.pad_axis(t(f), 2, t(lo), t(hi)),
             jhalo.pad_axis(jnp.asarray(f), 2, jnp.asarray(lo),
                            jnp.asarray(hi))),
            ("take_k", thalo.take_k(t(f), -1),
             jhalo.take_k(jnp.asarray(f), -1))]


CASES = {
    "ghosts": case_ghosts,
    "thermodynamics": case_thermodynamics,
    "avexy_masked": case_avexy_masked,
    "closure": case_closure,
    "closure_dns": case_closure_dns,
    "advection": case_advection,
    "diff_c": case_diff_c,
    "diff_uvw_masked": case_diff_masked,
    "bottom": case_bottom,
    "forces": case_forces,
    "coriolis": case_coriolis,
    "masscorr": case_masscorr,
    "wallfn": case_wallfn,
    "halo": case_halo,
}
# every case on every config it exercises differently
PARAMS = [(c, k) for c in ("flat", "warm", "neutral") for k in CASES
          if c == "flat" or k not in ("avexy_masked", "closure_dns",
                                      "wallfn", "halo", "diff_uvw_masked")]


@pytest.mark.parametrize("config,case", PARAMS)
def test_module_matches_reference(config, case):
    pairs = CASES[case](env(config))
    assert pairs
    for label, got, ref in pairs:
        assert_close(got, ref, what=f"{config}/{case}/{label}")


def test_make_ghosts_with_scalars_matches_reference():
    """make_ghosts with passive scalars, which used to raise, builds the
    kappa-layout stack of the reference (periodic here; the open contexts
    are in test_torch_scalars.py), and the kappa ghosts of one field match
    too."""
    e = env("flat")
    nx, ny, nz = e["tf"].u.shape
    sv = e["rng"].uniform(0.0, 2.0, (2, nx, ny, nz))
    jf = dataclasses.replace(e["jf"], sv=jnp.asarray(sv))
    tf = dataclasses.replace(e["tf"], sv=t(sv))
    ek = np.full((nx, ny, nz), 0.7)
    ref = jbnd.make_ghosts(jf, jnp.asarray(ek), jnp.asarray(ek), e["cfg"],
                           e["jgrid"])
    got = tbnd.make_ghosts(tf, t(ek), t(ek), e["cfg"], e["tgrid"])
    assert got.sv.shape == (2, nx + 4, ny + 4, nz + 4)
    assert_close(got.sv, ref.sv, what="make_ghosts sv")
    assert_close(tbnd.ghost_scalar_kappa(e["tf"].thl, e["cfg"]),
                 jbnd.ghost_scalar_kappa(e["jf"].thl, e["cfg"]),
                 what="ghost_scalar_kappa")


def test_randomize_statistics():
    """The port draws from a torch.Generator (not jax.random's stream), so
    only its statistics are checked: zero slab mean, bounded amplitude,
    levels >= krand untouched, reproducible from the seed."""
    grid = TGrid.uniform(16, 12, 10, 16.0, 12.0, 10.0, dtype=np.float64)
    nz, amp, krand = 10, 0.05, 4
    f0 = tstate.profile_fields(grid, np.full(nz, 1.0), np.zeros(nz),
                               np.full(nz, 288.0), np.zeros(nz),
                               np.full(nz, 5e-5))
    draw = lambda seed: tstate.randomize(
        f0, torch.Generator().manual_seed(seed), amp, krand)
    f1, f2, f3 = draw(3), draw(3), draw(4)
    for name in ("u", "v", "w"):
        d = (getattr(f1, name) - getattr(f0, name)).numpy()
        assert np.abs(d.mean(axis=(0, 1))).max() < 1e-15
        assert np.abs(d).max() <= 2.0 * amp
        assert np.abs(d[..., :krand]).max() > 0.5 * amp
        assert np.all(d[..., krand:] == 0.0)
        assert torch.equal(getattr(f1, name), getattr(f2, name))
        assert not torch.equal(getattr(f1, name), getattr(f3, name))
    assert torch.equal(f1.thl, f0.thl)


def test_port_imports_no_jax():
    """The package, its step, entry point, case staging and IBM import no
    JAX at all (staging itself is checked in test_torch_ibm.py)."""
    code = ("import sys; import udales_tpu_torch, udales_tpu_torch.run, "
            "udales_tpu_torch.entry, udales_tpu_torch.convert, "
            "udales_tpu_torch.ops.fused_diff, udales_tpu_torch.cases, "
            "udales_tpu_torch.ibm.ibm; "
            "assert 'jax' not in sys.modules, sorted("
            "m for m in sys.modules if m.startswith('jax'))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
