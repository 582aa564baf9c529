"""validate_abl_torch.py, the port's long-horizon neutral-ABL check, on the
CPU: its stress profile and chunk records against validate_abl.py's
arithmetic on udales_tpu (float64, 16^3), its analysis on records with
known answers, chaining through the Fortran restart files, and its
imports.  JAX is imported only inside the tests that compare with it, so
that the file also runs where JAX is absent (``--noconftest``).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import validate_abl_torch as vat
from udales_tpu_torch.grid import Grid

ROOT = Path(__file__).resolve().parents[1]
N = 16


def jtree(obj):
    """A udales_tpu pytree as nested dicts of numpy arrays (the form
    ``convert.state_from_numpy`` takes)."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return {f.name: jtree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: jtree(v) for k, v in obj.items()}
    return np.asarray(obj)


def jax_case(n):
    """validate_abl.py's case on udales_tpu in float64, on the CPU, as
    tests/conftest.py sets JAX up (the file may run without it)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from __graft_entry__ import _build
    model = _build(n, n, n, "float64")
    model.dpdxl = jnp.full(n, -vat.DPDX, jnp.float64)
    return model


def jax_stress_profile(model, s):
    """validate_abl.py:57-83 line for line, from udales_tpu's own
    functions."""
    import jax.numpy as jnp
    from udales_tpu.ops import subgrid as sgs
    from udales_tpu.ops.thermo import thermodynamics
    from udales_tpu.run import _velocity_ghosts
    grid = model.grid
    dzh = float(grid.dzf[0])
    dxi = float(grid.dxi)
    u, w = s.c.u, s.c.w
    ubar = jnp.mean(u, axis=(0, 1))
    up = u - ubar[None, None, :]
    uph = 0.5 * (up[:, :, 1:] + up[:, :, :-1])
    wi = w[:, :, 1:-1]
    w_u = 0.5 * (wi + jnp.roll(wi, 1, axis=0))
    res = jnp.mean(uph * w_u, axis=(0, 1))
    g = _velocity_ghosts(s.c, model.cfg, model.grid)
    th = thermodynamics(s.c, model.cfg, model.grid, None)
    ekm, _, _ = sgs.closure(g, model.grid, model.cfg, e12=s.c.e12,
                            dthvdz=th.dthvdz, thl=s.c.thl, thvs=288.0)
    ekm_u = 0.5 * (ekm + jnp.roll(ekm, 1, axis=0))
    emom = 0.5 * (ekm_u[:, :, 1:] + ekm_u[:, :, :-1])
    dudz = (u[:, :, 1:] - u[:, :, :-1]) / dzh
    dwdx = (wi - jnp.roll(wi, 1, axis=0)) * dxi
    tau_sgs = -jnp.mean(emom * (dudz + dwdx), axis=(0, 1))
    return res + tau_sgs


def jax_run_chunk(model, step, profile, s, chunk):
    """validate_abl.py:85-101's chunk with udales_tpu's `step` (jitted)
    in a Python loop in place of the scan, and its record as run_chunk's."""
    import jax.numpy as jnp
    acc = jnp.zeros(model.grid.ktot - 1, jnp.float64)
    for _ in range(chunk):
        s = step(s)
        acc = acc + profile(s)
    c = s.c
    uprof = jnp.mean(c.u, axis=(0, 1))
    ke = 0.5 * jnp.mean(c.u ** 2 + c.v ** 2
                        + 0.5 * (c.w[..., 1:] + c.w[..., :-1]) ** 2)
    up = c.u - uprof
    vp = c.v - jnp.mean(c.v, axis=(0, 1))
    tke = 0.5 * jnp.mean(up ** 2 + vp ** 2)
    return s, dict(prof=np.asarray(uprof), tau=np.asarray(acc / chunk),
                   ke=float(ke), tke=float(tke),
                   umax=float(jnp.abs(c.u).max()), time=float(s.timee),
                   dt=float(s.dt))


def converted_start(steps):
    """udales_tpu's start State of the case after `steps` jitted steps, and
    the same State converted for the port; with the udales_tpu model and
    the port's (CPU, float64)."""
    import jax
    from __graft_entry__ import _init_state
    from udales_tpu_torch.convert import state_from_numpy
    jmodel = jax_case(N)
    jst = _init_state(jmodel, amp=0.1)
    step = jax.jit(jmodel.step)
    for _ in range(steps):
        jst = step(jst)
    tmodel = vat.build_case(N, "cpu", "float64")
    return jmodel, step, jst, tmodel, state_from_numpy(jtree(jst))


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-300)


def test_stress_profile_matches_reference():
    """(a) stress_profile against validate_abl.py's, rebuilt from
    udales_tpu, on one converted State at 16^3 float64: 1e-12 of the
    profile's largest value.  The reference runs op by op: under jax.jit
    XLA sums the slab means in another order, 1.5e-12 apart."""
    jmodel, _, jst, tmodel, tst = converted_start(steps=5)
    ref = np.asarray(jax_stress_profile(jmodel, jst))
    got = vat.stress_profile(tmodel, tst).numpy()
    assert got.shape == (N - 1,) and np.abs(ref).max() > 0
    assert rel_err(got, ref) <= 1e-12, rel_err(got, ref)


def test_chunk_records_match_reference():
    """(b) two chunks of 10 steps from one converted State through both
    packages, the same dpdxl: every record within 1e-10 of its largest
    value.  The reference's profile runs op by op, as in (a)."""
    jmodel, step, jst, tmodel, tst = converted_start(steps=0)
    profile = lambda s: jax_stress_profile(jmodel, s)
    for chunk in range(2):
        jst, ref = jax_run_chunk(jmodel, step, profile, jst, 10)
        tst, got = vat.run_chunk(tmodel, tst, 10)
        assert set(got) == set(ref)
        for k in ref:
            assert rel_err(got[k], ref[k]) <= 1e-10, (chunk, k, got[k],
                                                     ref[k])


def synthetic_records(nchunks=8, tau_scale=1.0, accel=0.0, kappa=vat.KAPPA,
                      tke_wave=0.0):
    """Chunk records with known answers on the 16^3 grid: the log profile
    u*/kappa ln(z/z0) plus `accel` t, the stress that balances it times
    `tau_scale`, a resolved TKE of 0.01 (1 +- tke_wave, alternating).
    The acceleration is zero at the last quarter's mean time, so that its
    mean profile is the log law."""
    grid = Grid.uniform(N, N, N, float(N), float(N), float(N),
                        dtype=np.float64)
    ustar, zsize = vat.friction_velocity(grid)
    z0 = 0.03
    times = 100.0 * np.arange(1, nchunks + 1)
    zh = np.asarray(grid.zh)[1:-1]
    uz = ustar / kappa * np.log(np.asarray(grid.zf) / z0)
    # int_zh^H accel dz' = accel (H - zh) on the uniform grid
    tau = tau_scale * (ustar ** 2 * (1 - zh / zsize) - accel * (zsize - zh))
    tmid = times[-(nchunks // 4):].mean()
    rec = dict(prof=[uz + accel * (t - tmid) for t in times],
               tau=[-tau] * nchunks,
               tke=list(0.01 * (1 + tke_wave * (-1.0) ** np.arange(nchunks))),
               time=list(times))
    return rec, grid, ustar, z0


@pytest.mark.parametrize("accel", [0.0, 2e-6], ids=["steady", "storage"])
def test_analyse_known_answers(accel):
    """(c) a stress exactly on the budget (with and without the storage
    term of a uniform acceleration) and an exact log profile: budget error
    ~0, kappa_eff = 0.41, no log-law deviation, a steady TKE; the checks
    pass."""
    rec, grid, ustar, z0 = synthetic_records(accel=accel)
    res = vat.analyse(rec, grid, ustar, z0)
    assert res["budget_err"] <= 1e-12
    assert abs(res["bulk_dudt"] - accel) <= 1e-12
    assert abs(res["kappa_eff"] - 0.41) <= 1e-12
    assert res["loglaw_err"] <= 1e-12
    assert res["tke_rms"] == 0.0 and res["tke_drift"] == 0.0
    vat.check(res)


@pytest.mark.parametrize("kw,msg", [
    (dict(tau_scale=1.1), "momentum budget violated"),
    (dict(kappa=0.25), "log-law envelope exceeded"),
    (dict(tke_wave=0.4), "resolved TKE not statistically stationary"),
], ids=["stress-10%-off", "log-law", "stationarity"])
def test_analyse_trips_each_bound(kw, msg):
    """(c) a stress 10% off the budget, a profile of kappa 0.25 (40% above
    the log law) and a TKE swinging by 40% each trip their check."""
    rec, grid, ustar, z0 = synthetic_records(**kw)
    res = vat.analyse(rec, grid, ustar, z0)
    with pytest.raises(AssertionError, match=msg):
        vat.check(res)


def test_analyse_needs_two_chunks_in_the_last_quarter():
    rec, grid, ustar, z0 = synthetic_records(nchunks=7)
    with pytest.raises(ValueError, match="8 chunks"):
        vat.analyse(rec, grid, ustar, z0)


def test_chained_run_equals_uninterrupted_run(tmp_path):
    """(d) 4 chunks of 5 steps in one command against 2, --save, then
    --resume for 2 more: the records and every State leaf within 1e-13
    (the float32 State crosses the float64 Fortran files exactly)."""
    from udales_tpu_torch.convert import state_to_numpy
    base = [str(N), "200", "5", "--device", "cpu"]
    whole = vat.run(vat.parse(base + ["--stop-after", "4"]))
    first = vat.run(vat.parse(base + ["--stop-after", "2", "--save",
                                      str(tmp_path)]))
    assert first["chunks"] == 2 and len(first["records"]["tke"]) == 2
    second = vat.run(vat.parse(base + ["--resume", str(tmp_path),
                                       "--stop-after", "2"]))
    assert second["chunks"] == 2 and second["steps"] == 10
    for k in ("prof", "tau") + vat.SCALARS:
        assert rel_err(second["records"][k], whole["records"][k]) <= 1e-13, k
    got, ref = (state_to_numpy(r["state"]) for r in (second, whole))
    for part in ("m", "c"):
        for k in ("u", "v", "w", "thl", "qt", "e12"):
            assert rel_err(got[part][k], ref[part][k]) <= 1e-13, (part, k)
    for k in ("pres", "dt", "timee"):
        assert rel_err(got[k], ref[k]) <= 1e-13, k


def test_resume_refuses_another_grid(tmp_path):
    vat.run(vat.parse([str(N), "8", "3", "--device", "cpu", "--stop-after",
                       "1", "--save", str(tmp_path)]))
    with pytest.raises(ValueError, match="CHUNK"):
        vat.run(vat.parse([str(N), "8", "5", "--device", "cpu",
                           "--resume", str(tmp_path)]))
    with pytest.raises(SystemExit):
        vat.parse([str(N), "7", "5", "--device", "cpu"])


def test_without_a_card_the_script_raises():
    """The card is the default; without one the script raises rather than
    run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vat.run(vat.parse([str(N), "8", "5"]))


def test_import_loads_no_jax():
    """(e) importing the script loads no jax, jaxlib, udales_tpu or
    __graft_entry__ module."""
    code = ("import sys, validate_abl_torch\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'udales_tpu', '__graft_entry__')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
