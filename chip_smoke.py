"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives ``udales_tpu_torch`` (never JAX) through its main path, one adaptive
RK3 timestep of the flat neutral ABL, and checks the hand-written CUDA
diffusion kernel on the way.  Phases, one line each; any failure raises and
the script exits non-zero without a result line:

  1. require a CUDA device (no CPU fallback)
  2. card name and power limit (nvidia-smi), torch / CUDA versions
  3. build the kernel from the repository sources (nvcc, sm_90a)
  4. kernel against its plain PyTorch version on the card
  5. step parity: 32^3 float64, 5 steps on CUDA (kernel) against CPU (plain)
  6. main path: 128^3 float32, warm-up then 50 timed steps
  7. the same at 256^3 float32, 20 timed steps
  8. kernel time against the plain sweeps at 128^3 float32
The line before the last is a JSON object describing the kernels; the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch


def phase(n, msg):
    print(f"[phase {n}] {msg}", flush=True)


def random_ghosts(grid, dtype, device, seed):
    """Ghosted u, v, w, ekm as the kernel takes them, from a numpy seed."""
    nx, ny, nz = grid.shape
    rng = np.random.default_rng(seed)
    cell = (nx + 2, ny + 2, nz + 2)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return SimpleNamespace(
        u=t(rng.standard_normal(cell)), v=t(rng.standard_normal(cell)),
        w=t(rng.standard_normal((nx + 2, ny + 2, nz + 1))),
        ekm=t(rng.uniform(0.5, 1.5, cell)))


def plain_diff(g, grid):
    from udales_tpu_torch.ops import subgrid as sgs
    return sgs.diff_u(g, grid), sgs.diff_v(g, grid), sgs.diff_w(g, grid)


def max_rel_err(got, ref):
    """max|got - ref| and max|ref| over the three outputs."""
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    scale = max(float(b.abs().max()) for b in ref)
    return err, scale


def cuda_ms(fn, n):
    """Mean device milliseconds of `fn` over `n` calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def numpy_state(grid, seed):
    """Flat-ABL start (u=1, thl=288, zero-mean noise in the lower half) made
    with numpy, as a dict for convert.state_from_numpy."""
    nx, ny, nz = grid.shape
    rng = np.random.default_rng(seed)
    dt = grid.dtype

    def noisy(base, shape):
        r = rng.uniform(-1.0, 1.0, shape)
        r -= r.mean(axis=(0, 1), keepdims=True)
        r[..., nz // 2:] = 0.0
        return (base + 0.05 * r).astype(dt)
    f = dict(u=noisy(1.0, (nx, ny, nz)), v=noisy(0.0, (nx, ny, nz)),
             w=noisy(0.0, (nx, ny, nz + 1)),
             thl=np.full((nx, ny, nz), 288.0, dt),
             qt=np.zeros((nx, ny, nz), dt),
             e12=np.full((nx, ny, nz), 5e-5, dt),
             sv=np.zeros((0, nx, ny, nz), dt))
    return {"m": f, "c": f, "pres": np.zeros((nx, ny, nz), dt),
            "dt": np.asarray(0.1, dt), "timee": np.asarray(0.0, dt)}


def max_divergence(model, c):
    """max|div u| of the projected velocity (verify-skill oracle 1)."""
    grid = model.grid
    gu = torch.cat([c.u, c.u[:1]], dim=0)
    gv = torch.cat([c.v, c.v[:, :1]], dim=1)
    dzfi = grid.t("dzfi", c.u.device)
    div = ((gu[1:] - gu[:-1]) * grid.dxi + (gv[:, 1:] - gv[:, :-1]) * grid.dyi
           + (c.w[:, :, 1:] - c.w[:, :, :-1]) * dzfi[None, None, :])
    return float(div.abs().max())


def run_main_path(n, warm, steps, smi, fused):
    """Phase 6/7 body: build the flat case at n^3 float32 on the card, warm
    up, then time `steps` steps between CUDA events.  Returns the numbers."""
    from udales_tpu_torch import entry
    model = entry._build(n, n, n, "float32", device="cuda")
    state = entry._init_state(model, seed=43)
    state = model.run(state, warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused.launch_count = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state = model.run(state, steps)
    end.record()
    torch.cuda.synchronize()
    launches = fused.launch_count
    ms = start.elapsed_time(end) / steps
    if launches != 3 * steps:
        raise RuntimeError(f"{n}^3: kernel launched {launches} times in "
                           f"{steps} steps, expected {3 * steps}")
    c = state.c
    for name in ("u", "v", "w", "thl", "e12"):
        if not bool(torch.isfinite(getattr(c, name)).all()):
            raise RuntimeError(f"{n}^3: non-finite {name}")
    dt = float(state.dt)
    if not dt > 0:
        raise RuntimeError(f"{n}^3: dt = {dt}")
    div = max_divergence(model, c)
    out = dict(n=n, steps=steps, ms_per_step=ms,
               points_per_s=n ** 3 / (ms * 1e-3), launches=launches, dt=dt,
               max_div=div, umax=float(c.u.abs().max()),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"  {n}^3 float32 on {smi}: {ms:.4f} ms/step, "
          f"{out['points_per_s']:.6g} grid-points/s, launches {launches} "
          f"(= 3 x {steps}), dt {dt:.6g}, max|div u| {div:.3e}, "
          f"max|u| {out['umax']:.4f}, peak {out['peak_mem_gib']:.3f} GiB",
          flush=True)
    return out


def main():
    # 1. a CUDA device, or nothing
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); the port has no CPU "
                         "fallback here")
    from udales_tpu_torch import entry
    from udales_tpu_torch.convert import state_from_numpy
    from udales_tpu_torch.grid import Grid
    from udales_tpu_torch.ops.fused_diff import SOURCE, fused_diff_mom
    phase(1, f"CUDA device: {torch.cuda.get_device_name(0)}, "
             f"count {torch.cuda.device_count()}")

    # 2. the card as nvidia-smi reports it
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    phase(2, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
             f"python {sys.version.split()[0]}; nvidia-smi name, power.limit:")
    print(smi, flush=True)

    # 3. build from the repository sources
    t0 = time.perf_counter()
    fused_diff_mom.load()
    phase(3, f"built {SOURCE.name} for sm_90a in "
             f"{time.perf_counter() - t0:.2f} s")
    for line in fused_diff_mom.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)

    # 4. kernel against its plain version on the card
    zf = np.cumsum(1.04 ** np.arange(37)) - 0.5 * 1.04 ** np.arange(37)
    cases = [("stretched (24, 20, 37) float64",
              Grid(24, 20, 37, 24.0, 20.0, zf, dtype=np.float64),
              torch.float64, 1e-12),
             ("uniform (128, 128, 128) float32",
              Grid.uniform(128, 128, 128, 128.0, 128.0, 128.0,
                           dtype=np.float32), torch.float32, 1e-5)]
    for label, grid, dtype, rtol in cases:
        g = random_ghosts(grid, dtype, "cuda", seed=1)
        got = fused_diff_mom(g, grid)
        torch.cuda.synchronize()
        err, scale = max_rel_err(got, plain_diff(g, grid))
        tol = rtol * scale
        phase(4, f"kernel vs plain, {label}: max abs err {err:.3e}, "
                 f"tolerance {tol:.3e} ({rtol:g} x max|ref| {scale:.4g})")
        if not err <= tol:
            raise RuntimeError(f"kernel disagrees with plain on {label}")
    kernel_err = err   # the 128^3 float32 case: the main path's shape

    # 5. CUDA (kernel) against CPU (plain) over 5 steps
    states = {}
    for dev in ("cpu", "cuda"):
        model = entry._build(32, 32, 32, "float64", device=dev)
        st = state_from_numpy(numpy_state(model.grid, seed=7), device=dev)
        states[dev] = model.run(st, 5)
    ref, got = states["cpu"], states["cuda"]
    worst = 0.0
    for name, a, b in (("u", ref.c.u, got.c.u), ("v", ref.c.v, got.c.v),
                       ("w", ref.c.w, got.c.w), ("pres", ref.pres, got.pres),
                       ("dt", ref.dt, got.dt)):
        rel = float((b.cpu() - a).abs().max() / a.abs().max().clamp(min=1e-30))
        worst = max(worst, rel)
    phase(5, f"32^3 float64, 5 steps, CUDA vs CPU: max rel err {worst:.3e} "
             f"over u, v, w, pres, dt (tolerance 1e-9)")
    if not worst <= 1e-9:
        raise RuntimeError("CUDA step disagrees with the CPU step")

    # 6./7. the main path
    main = run_main_path(128, warm=5, steps=50, smi=smi, fused=fused_diff_mom)
    div_bound = 1e-5
    phase(6, f"128^3 main path ok; max|div u| {main['max_div']:.3e} "
             f"<= {div_bound:g} (float32 bound)")
    if not main["max_div"] <= div_bound:
        raise RuntimeError("projection left a divergent velocity field")
    big = run_main_path(256, warm=3, steps=20, smi=smi, fused=fused_diff_mom)
    phase(7, f"256^3 main path ok; max|div u| {big['max_div']:.3e}")
    if not big["max_div"] <= div_bound:
        raise RuntimeError("projection left a divergent velocity field")

    # 8. kernel time against the plain sweeps, in turns
    grid = cases[1][1]
    g = random_ghosts(grid, torch.float32, "cuda", seed=2)
    for _ in range(3):
        fused_diff_mom(g, grid)
        plain_diff(g, grid)
    reps = 50
    p1 = cuda_ms(lambda: plain_diff(g, grid), reps)
    k1 = cuda_ms(lambda: fused_diff_mom(g, grid), reps)
    k2 = cuda_ms(lambda: fused_diff_mom(g, grid), reps)
    p2 = cuda_ms(lambda: plain_diff(g, grid), reps)
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    nbytes = 4 * (3 * 130 * 130 * 130 + 130 * 130 * 129
                  + 2 * 128 ** 3 + 128 * 128 * 129)
    phase(8, f"128^3 float32 on {smi}: kernel {kernel_ms:.4f} ms "
             f"({k1:.4f}, {k2:.4f}), plain diff_u/v/w {plain_ms:.4f} ms "
             f"({p1:.4f}, {p2:.4f}); kernel moves >= {nbytes / 1e6:.1f} MB "
             f"= {nbytes / (kernel_ms * 1e-3) / 1e12:.3f} TB/s")

    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")

    print(json.dumps({"kernels": [{
        "name": "fused_diff_mom", "route": "cuda",
        "source": "udales_tpu_torch/csrc/fused_diff_mom.cu",
        "replaces": "udales_tpu/ops/pallas_stencil.py:191",
        "launches": main["launches"], "max_abs_err": kernel_err,
        "ms": kernel_ms, "plain_ms": plain_ms}],
        "main_path": {k: main[k] for k in ("ms_per_step", "points_per_s")},
        "main_path_256": {k: big[k] for k in ("ms_per_step",
                                              "points_per_s")}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
