"""Long-horizon neutral-ABL validation of udales_tpu_torch on one CUDA card.

The port's counterpart of validate_abl.py, with its case, its checks and
its bounds: O(10^4-10^5) RK3 steps of the pressure-driven neutral ABL
(periodic x/y, log-law wall functions at the floor, Vreman SGS; the flat
main path ``entry._build`` -> ``Model.step_jit``, the step as one CUDA
graph that holds the unmasked ``fused_diff_mom`` kernel 3 times), then

  1. no NaN and bounded velocities over the whole run (every chunk);
  2. statistical stationarity: the rms of the resolved TKE over the last
     quarter of the run is under 30% of its mean;
  3. the exact integral momentum budget: the slab-averaged total (resolved
     + subgrid) stress tau(z) = u*^2 (1 - z/H) - int_z^H dt<u> dz', with
     the storage term fitted from the chunk profiles over the last
     quarter, within 6% of u*^2 at every interior level;
  4. the last quarter's mean u within 30% of the rough-wall log law
     u*/kappa ln(z/z0) in the log layer, with kappa_eff in 0.28-0.55
     (the wall-modeled LES log-layer mismatch; validate_abl.py says why).

Usage:

    python3 validate_abl_torch.py [N] [CHUNKS] [CHUNK] [--save DIR]
        [--resume DIR] [--stop-after K] [--device cpu]

N^3 float32 cells, CHUNKS chunks of CHUNK steps (64, 200, 500).  The
stress profile is summed on the device every step; each chunk ends in one
copy to the host.  A run longer than one command is chained through the
reference's Fortran restart files: ``--save DIR`` writes the State after
the command's last chunk (``io.restart.write_state_fortran``) and the
chunk records so far (``records.npz``); ``--resume DIR`` reads both back
(``io.restart.warmstart_state``) and goes on; ``--stop-after K`` ends the
command after K chunks.  The analysis and its checks run once the records
reach CHUNKS.  The card is the default device; ``--device cpu`` runs on
the CPU, and without a card the script raises.

The start noise is a torch.Generator's, not jax.random's: the statistics
are comparable with validate_abl.py's, the trajectory is not.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from udales_tpu_torch import entry
from udales_tpu_torch.io.restart import warmstart_state, write_state_fortran
from udales_tpu_torch.ops import fused_vreman as fv
from udales_tpu_torch.ops.fused_diff import fused_diff_mom
from udales_tpu_torch.ops.thermo import thermodynamics
from udales_tpu_torch.run import _velocity_ghosts

DPDX = 2.5e-4        # u* = sqrt(dpdx * zsize)
KAPPA = 0.41
RECORDS = "records.npz"
# the per-chunk records, in the order of one chunk's host copy after the
# two profiles
SCALARS = ("ke", "tke", "umax", "time", "dt")
# validate_abl.py's bounds
TKE_RMS_MAX = 0.30
BUDGET_MAX = 0.06
LOGLAW_MAX = 0.30
KAPPA_EFF_RANGE = (0.28, 0.55)


def build_case(n, device="cuda", dtype="float32"):
    """The N^3 neutral ABL of validate_abl.py: ``entry._build`` with the
    large-scale pressure gradient -DPDX on every level."""
    model = entry._build(n, n, n, dtype, device=device)
    model.dpdxl = torch.full((n,), -DPDX, dtype=model.grid.torch_dtype,
                             device=model.device)
    return model


def friction_velocity(grid):
    """(u*, zsize) of the pressure-driven channel: u*^2 = dpdx * zsize."""
    zsize = float(grid.zh[-1])
    return float(np.sqrt(DPDX * zsize)), zsize


def stress_profile(model, state):
    """Slab-averaged total x-z stress at the interior w-levels zh_1..nz-1
    (validate_abl.py:57-83): resolved <u'w'> in the scheme's cd2 flux form
    minus subgrid ekm (du/dz + dw/dx), ekm with its molecular part
    (``fused_vreman.closure``).  Uniform grid."""
    grid, cfg, c = model.grid, model.cfg, state.c
    u, w = c.u, c.w
    up = u - u.mean(dim=(0, 1))
    uph = 0.5 * (up[:, :, 1:] + up[:, :, :-1])          # at zh interior
    wi = w[:, :, 1:-1]
    # w interpolated to the u x-stagger (u[i] sits at the west face of
    # cell i; periodic x by roll)
    w_u = 0.5 * (wi + torch.roll(wi, 1, dims=0))
    res = (uph * w_u).mean(dim=(0, 1))
    g = _velocity_ghosts(c, cfg, grid)
    th = thermodynamics(c, cfg, grid, None)
    ekm, _, _ = fv.closure(g, grid, cfg, e12=c.e12, dthvdz=th.dthvdz,
                           thl=c.thl, thvs=288.0)
    # the scheme's emom: x-z corner interpolation of ekm to the (u
    # x-position, w-level) point (subgrid.diff_u, uniform grid)
    ekm_u = 0.5 * (ekm + torch.roll(ekm, 1, dims=0))
    emom = 0.5 * (ekm_u[:, :, 1:] + ekm_u[:, :, :-1])
    dudz = (u[:, :, 1:] - u[:, :, :-1]) / float(grid.dzf[0])
    dwdx = (wi - torch.roll(wi, 1, dims=0)) * float(grid.dxi)
    tau_sgs = -(emom * (dudz + dwdx)).mean(dim=(0, 1))
    return res + tau_sgs


def run_chunk(model, state, chunk):
    """`chunk` steps of the compiled step (``Model.step_jit``: one CUDA
    graph replayed a step on the card) with the stress profile summed on
    the device in the field dtype between replays, and no host wait until
    the chunk's one copy.  Returns the State (the compiled step's own,
    valid until its next call) and the chunk's record: the final mean u
    profile ("prof"), the chunk-mean stress profile ("tau"), and KE,
    resolved TKE, max|u|, timee and dt at the chunk's end (`SCALARS`), as
    float64 NumPy values."""
    nz = model.grid.ktot
    c = state.c
    acc = torch.zeros(nz - 1, dtype=c.u.dtype, device=c.u.device)
    step = model.step_jit()
    for _ in range(chunk):
        state = step(state)
        acc += stress_profile(model, state)
    c = state.c
    uprof = c.u.mean(dim=(0, 1))
    # validate_abl.py:94-95 as it is written (w's part is 0.5 (w_k +
    # w_k+1)^2, twice the square of the cell-centre mean)
    ke = 0.5 * (c.u ** 2 + c.v ** 2
                + 0.5 * (c.w[..., 1:] + c.w[..., :-1]) ** 2).mean()
    up = c.u - uprof
    vp = c.v - c.v.mean(dim=(0, 1))
    tke = 0.5 * (up ** 2 + vp ** 2).mean()
    scalars = torch.stack([ke, tke, c.u.abs().max(),
                           state.timee.to(c.u.dtype), state.dt.to(c.u.dtype)])
    host = torch.cat([uprof, acc / chunk, scalars]).cpu().double().numpy()
    rec = dict(prof=host[:nz], tau=host[nz:2 * nz - 1])
    rec.update(zip(SCALARS, host[2 * nz - 1:]))
    return state, rec


def analyse(records, grid, ustar, z0):
    """Every number validate_abl.py:119-181 prints, from the chunk records
    ({name: array with the chunk first}) on the host: the resolved TKE's
    drift and rms over the last quarter, the stress profile against the
    budget with the storage term from the least-squares trend, and the
    log-law deviation with kappa_eff.  Needs 8 chunks or more (two in the
    last quarter's trend)."""
    profs = np.asarray(records["prof"], np.float64)
    taus = np.asarray(records["tau"], np.float64)
    tkes = np.asarray(records["tke"], np.float64)
    times = np.asarray(records["time"], np.float64)
    q = len(tkes) // 4
    if q < 2:
        raise ValueError(f"analyse needs 8 chunks or more, got {len(tkes)}")
    zsize = float(grid.zh[-1])

    # stationarity of resolved TKE over the last quarter
    tq = tkes[-q:]
    out = dict(chunks=len(tkes), q=q, tke_mean=float(tq.mean()),
               tke_drift=float(abs(tq[-1] - tq[0]) / tq.mean()),
               tke_rms=float(tq.std() / tq.mean()))

    # exact integral momentum budget:
    #   tau(zh) = u*^2 (1 - zh/H) - int_zh^H dt<u> dz'
    # with dt<u>(z) from a least-squares linear fit of the last quarter's
    # chunk mean profiles
    zh = np.asarray(grid.zh, np.float64)[1:-1]
    tau_mean = -np.mean(taus[-q:], axis=0)          # sign: stress on wall
    tw = times[-q:]
    dudt = np.polyfit(tw - tw[0], profs[-q:], 1)[0]  # per-level trend
    dzf = np.asarray(grid.dzf, np.float64)
    # int_zh_k^H dt<u> dz' over full cells k..nz-1 (zh_k is a cell face)
    storage = np.cumsum((dudt * dzf)[::-1])[::-1][1:]
    tau_want = ustar ** 2 * (1.0 - zh / zsize) - storage
    tau_err = (tau_mean - tau_want) / ustar ** 2
    kworst = int(np.argmax(np.abs(tau_err)))
    out.update(zh=zh, tau_mean=tau_mean, tau_want=tau_want, tau_err=tau_err,
               bulk_dudt=float(np.sum(dudt * dzf) / zsize),
               budget_err=float(np.abs(tau_err).max()),
               budget_zh=float(zh[kworst]))

    # log-law recovery on the last quarter's mean profile
    ubar = np.mean(profs[-q:], axis=0)
    zc = np.asarray(grid.zf, np.float64)
    sel = (zc > 2.5 * float(grid.dzf[0])) & (zc < 0.4 * zsize)
    ulog = ustar / KAPPA * np.log(zc[sel] / z0)
    rel = (ubar[sel] - ulog) / ulog
    # effective von Karman constant from a least-squares fit in the layer
    slope = np.polyfit(np.log(zc[sel] / z0), ubar[sel], 1)[0]
    out.update(z_log=zc[sel], u_log=ubar[sel], loglaw=ulog, loglaw_rel=rel,
               loglaw_err=float(np.abs(rel).max()),
               kappa_eff=float(ustar / slope))
    return out


def report(res, chunk):
    """validate_abl.py's summary lines of `analyse`'s result."""
    q = res["q"]
    print(f"TKE last quarter: mean={res['tke_mean']:.5f} "
          f"drift={res['tke_drift'] * 100:.1f}% "
          f"rms={res['tke_rms'] * 100:.1f}%")
    print(f"\ntotal-stress profile vs u*^2(1-z/H) - storage over last "
          f"quarter ({q * chunk} steps; bulk dt<u> = "
          f"{res['bulk_dudt']:.2e} m/s^2):")
    zh = res["zh"]
    for k in range(0, len(zh), max(1, (len(zh) + 1) // 16)):
        print(f"  zh={zh[k]:6.1f}  tau={res['tau_mean'][k]:+.3e}  "
              f"budget={res['tau_want'][k]:+.3e}  "
              f"err={res['tau_err'][k] * 100:+5.1f}% u*^2")
    print(f"max |tau - budget| = {res['budget_err'] * 100:.1f}% of u*^2 "
          f"(at zh={res['budget_zh']:.1f})")
    print(f"\nlog-layer ({len(res['z_log'])} levels): max |u-ulog|/ulog = "
          f"{res['loglaw_err'] * 100:.1f}%  kappa_eff = "
          f"{res['kappa_eff']:.3f} (overshoot = the wall-modeled-LES "
          f"log-layer mismatch; the reference closure has no wall damping "
          f"either)")
    for z, u, ul in zip(res["z_log"], res["u_log"], res["loglaw"]):
        print(f"  z={z:5.1f}  u={u:7.4f}  loglaw={ul:7.4f}  "
              f"{(u / ul - 1) * 100:+5.1f}%")


def check(res):
    """validate_abl.py's asserts on `analyse`'s result, bounds unchanged;
    raises AssertionError with its message."""
    lo, hi = KAPPA_EFF_RANGE
    for ok, msg in (
            (res["tke_rms"] < TKE_RMS_MAX,
             "resolved TKE not statistically stationary"),
            (res["budget_err"] < BUDGET_MAX, "momentum budget violated"),
            (res["loglaw_err"] < LOGLAW_MAX, "log-law envelope exceeded"),
            (lo < res["kappa_eff"] < hi, f"kappa_eff {res['kappa_eff']}")):
        if not ok:
            raise AssertionError(msg)


def save(path, model, state, records, chunk):
    """The State's Fortran restart files and the records in `path`."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    ntrun = len(records["tke"]) * chunk
    expnr = f"{model.cfg.run.iexpnr:03d}"
    write_state_fortran(path, state, expnr, model.cfg, ntrun=ntrun)
    np.savez(path / RECORDS, n=model.grid.itot, chunk=chunk,
             startfile=f"initd{ntrun:08d}_xxx_xxx.{expnr}",
             **{k: np.asarray(v) for k, v in records.items()})


def resume(path, model, chunk):
    """(State, records) saved by `save` in `path`, on the model's device."""
    path = Path(path)
    with np.load(path / RECORDS) as z:
        meta = {k: z[k] for k in z.files}
    n = model.grid.itot
    if int(meta["n"]) != n or int(meta["chunk"]) != chunk:
        raise ValueError(f"{path} holds N={int(meta['n'])} CHUNK="
                         f"{int(meta['chunk'])}, not N={n} CHUNK={chunk}")
    records = {k: list(meta[k]) for k in ("prof", "tau", "wall") + SCALARS}
    state = warmstart_state(path, str(meta["startfile"]),
                            f"{model.cfg.run.iexpnr:03d}", model.cfg,
                            model.grid, model=model)
    return state, records


def parse(argv=None):
    p = argparse.ArgumentParser(
        description="Long-horizon neutral-ABL validation of "
                    "udales_tpu_torch (validate_abl.py's checks).")
    p.add_argument("n", nargs="?", type=int, default=64)
    p.add_argument("chunks", nargs="?", type=int, default=200)
    p.add_argument("chunk", nargs="?", type=int, default=500)
    p.add_argument("--save", help="write the State and records here")
    p.add_argument("--resume", help="continue from a --save directory")
    p.add_argument("--stop-after", type=int, default=None,
                   help="end this command after K chunks")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.chunks < 8:
        p.error("CHUNKS must be 8 or more: the analysis fits a trend over "
                "the last quarter")
    return args


def run(args):
    """The chunks of one command.  Returns dict(model, state, records
    ({name: list, chunk first}), chunks and steps of this command, its
    wall seconds, fused_diff_mom's launches in it, ustar, z0)."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("validate_abl_torch: no CUDA device; the "
                           "validation runs on the card (--device cpu "
                           "runs it on the CPU)")
    model = build_case(args.n, args.device)
    ustar, _ = friction_velocity(model.grid)
    if args.resume:
        state, records = resume(args.resume, model, args.chunk)
    else:
        state = entry._init_state(model, amp=0.1)
        records = {k: [] for k in ("prof", "tau", "wall") + SCALARS}
    done = len(records["tke"])
    todo = max(args.chunks - done, 0)
    if args.stop_after is not None:
        todo = min(todo, args.stop_after)
    fused_diff_mom.launch_count = fused_diff_mom.masked_launch_count = 0
    t0 = time.perf_counter()
    for i in range(done, done + todo):
        t1 = time.perf_counter()
        state, rec = run_chunk(model, state, args.chunk)
        rec["wall"] = time.perf_counter() - t1   # the copy waited for it
        for k, v in rec.items():
            records[k].append(v)
        if not all(np.isfinite(v).all() for v in rec.values()):
            raise AssertionError(f"NaN at chunk {i}")
        if not rec["umax"] < 50 * ustar / 0.4:
            raise AssertionError(f"runaway at chunk {i}")
        if i % 5 == 0 or i == done + todo - 1:
            print(f"chunk {i:3d}: t={rec['time']:9.1f}s dt={rec['dt']:.3f} "
                  f"KE={rec['ke']:.5f} TKE={rec['tke']:.5f} "
                  f"umax={rec['umax']:.3f}", flush=True)
    wall = time.perf_counter() - t0
    steps = todo * args.chunk
    launches = (fused_diff_mom.launch_count, fused_diff_mom.masked_launch_count)
    if model.device.type == "cuda" and launches != (3 * steps, 0):
        raise RuntimeError(f"fused_diff_mom launches (unmasked, masked) = "
                           f"{launches} in {steps} steps, expected "
                           f"({3 * steps}, 0)")
    if args.save:
        save(args.save, model, state, records, args.chunk)
    return dict(model=model, state=state, records=records, chunks=todo,
                steps=steps, wall=wall, launches=launches[0], ustar=ustar,
                z0=model.cfg.bc.z0)


def card_line(device):
    """nvidia-smi's name and power limit of the card, or the CPU."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    args = parse(argv)
    out = run(args)
    model, records, steps = out["model"], out["records"], out["steps"]
    n, total = args.n, len(records["tke"])
    ms = 1e3 * out["wall"] / max(steps, 1)
    print(f"\nthis command: {out['chunks']} chunks, {steps} steps, "
          f"{out['wall']:.1f} s wall, {ms:.3f} ms/step "
          f"({n ** 3 / ms / 1e3:.1f} M pts/s), fused_diff_mom launches "
          f"{out['launches']}; on {card_line(model.device)}", flush=True)
    if total < args.chunks:
        print(f"{total} of {args.chunks} chunks recorded"
              + (f"; continue with --resume {args.save}" if args.save
                 else ""))
        return out
    wall = float(np.sum(records["wall"]))
    nsteps = total * args.chunk
    print(f"\n{nsteps} steps, {wall:.0f}s wall "
          f"({n ** 3 * nsteps / wall / 1e6:.0f} M pts/s sustained)")
    res = analyse(records, model.grid, out["ustar"], out["z0"])
    report(res, args.chunk)
    check(res)
    print("\nVALIDATION PASSED")
    return out


if __name__ == "__main__":
    main()
