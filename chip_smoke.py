"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives ``udales_tpu_torch`` (never JAX) through its main paths, the
adaptive RK3 step of the flat neutral ABL, of the urban building-array case
(immersed boundary) and of the same array with the facet surface energy
balance, and checks both variants of the hand-written CUDA diffusion kernel
on the way.  Phases, one line each; any failure raises and
the script exits non-zero without a result line:

  1. require a CUDA device (no CPU fallback)
  2. card name and power limit (nvidia-smi), torch / CUDA versions
  3. build the kernels from the repository sources (nvcc, sm_90a)
  4. unmasked kernel against its plain PyTorch version on the card: a
     sweep of ragged shapes on a stretched grid (float32 and float64), then
     the main paths' shapes 128^3 and 256^3 in float32
  5. flat step parity: 32^3 float64, 5 steps on CUDA (kernel) against CPU
  6. flat main path: 128^3 float32, warm-up then 50 timed steps
  7. the same at 256^3 float32, 20 timed steps
  8. unmasked kernel time (eager calls, and the same in a CUDA graph)
     against the plain sweeps at 128^3 and 256^3 float32, beside its bound
     (least bytes over the card's memory rate)
  9. stage the urban case at 32^3 and 128^3 (udales_tpu_torch.cases, into
     .bench_cache/)
 10. masked kernel against the plain masked sweeps: the urban 128^3 masks
     in float32, and random {0,1} masks over the sweep of ragged shapes
 11. urban step parity: 32^3 float64, 5 steps on CUDA against CPU
 12. urban main path: 128^3 float32, warm-up then 30 timed steps
 13. masked kernel time against the plain masked sweeps at 128^3 float32,
     beside its bound
 14. stage the urban energy-balance case (cases.stage_urban_eb) at 32^3
     (dtEB = 0.5 s, so that 5 steps see the balance fire) and at 128^3
 15. urban-EB step parity: 32^3 float64, 5 steps on CUDA against CPU,
     fields and facet temperatures
 16. urban-EB main path: 128^3 float32 through load_case, cold_start and
     run, warm-up then 50 timed steps; the balance fired, the facet
     temperatures stayed physical; one more step under
     torch.cuda.set_sync_debug_mode("error"): no host synchronisation
 17. the Poisson solver's open-boundary (Neumann), BCzp = 2 and POISS_FFT3D
     paths at 128^3 float32: residual of the discrete Laplacian
The line before the last is a JSON object describing the kernels and the
main paths; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

CACHE = Path(__file__).resolve().parent / ".bench_cache"
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet; the kernels are byte-bound
# (nx, ny, nz) against the kernel's 8 x 32 (j, k) tile and its i-chunks: odd
# sizes, smaller than a tile in every direction, one more than a tile
# multiple, nz + 1 a tile multiple, exact multiples, a long i march
RAGGED_SHAPES = [(24, 20, 37), (5, 3, 2), (33, 17, 65), (9, 8, 63),
                 (32, 16, 64), (70, 9, 130), (1, 1, 1)]


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


def random_masks(grid, dtype, device, seed):
    """Random {0,1} pmask_u/v/w (70% fluid) in the ghosted cell layout."""
    nx, ny, nz = grid.shape
    rng = np.random.default_rng(seed)
    return {k: torch.tensor(rng.uniform(size=(nx + 2, ny + 2, nz + 2)) > 0.3,
                            dtype=dtype, device=device) for k in "uvw"}


def ragged_sweep(fused, masked, n):
    """Kernel against plain over RAGGED_SHAPES on a stretched grid, float64
    (1e-12) and float32 (1e-5); any miss raises."""
    from udales_tpu_torch.grid import Grid
    for shape in RAGGED_SHAPES:
        nz = shape[2]
        zf = np.cumsum(1.04 ** np.arange(nz)) - 0.5 * 1.04 ** np.arange(nz)
        for np_dt, dtype, rtol in ((np.float64, torch.float64, 1e-12),
                                   (np.float32, torch.float32, 1e-5)):
            grid = Grid(*shape, float(shape[0]), float(shape[1]), zf,
                        dtype=np_dt)
            pm = random_masks(grid, dtype, "cuda", seed=4) if masked else None
            check_kernel(fused, random_ghosts(grid, dtype, "cuda", seed=1),
                         grid, pm, rtol,
                         f"{'masked, ' if masked else ''}stretched {shape} "
                         f"{np_dt.__name__}", n)


def plain_diff(g, grid, pmasks=None):
    from udales_tpu_torch.ops import subgrid as sgs
    pm = pmasks or {}
    return (sgs.diff_u(g, grid, M=pm.get("u")),
            sgs.diff_v(g, grid, M=pm.get("v")),
            sgs.diff_w(g, grid, M=pm.get("w")))


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


def graph_ms(fn, n):
    """Mean device milliseconds of `fn` with `n` calls captured in one CUDA
    graph, where the host's launch rate cannot set the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    return cuda_ms(graph.replay, 3) / n


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


def run_main_path(model, state, warm, steps, smi, fused, label):
    """Phase 6/7/12/16 body: warm `model` up on the card, then time `steps`
    steps between CUDA events with both launch counts set to 0 just before
    and read just after.  The path's own kernel variant (masked when the
    model has an IBM) must launch 3 times a step and the other not at all.
    Returns the numbers and the final State."""
    n = model.grid.itot
    masked = model.ibm is not None
    state = model.run(state, warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused.launch_count = fused.masked_launch_count = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state = model.run(state, steps)
    end.record()
    torch.cuda.synchronize()
    counts = (fused.launch_count, fused.masked_launch_count)
    launches, other = counts[::-1] if masked else counts
    ms = start.elapsed_time(end) / steps
    variant = "masked" if masked else "unmasked"
    if launches != 3 * steps or other != 0:
        raise RuntimeError(f"{label}: kernel launches (unmasked, masked) = "
                           f"{counts} in {steps} steps, expected "
                           f"{3 * steps} of the {variant} variant only")
    c = state.c
    for name in ("u", "v", "w", "thl", "e12"):
        if not bool(torch.isfinite(getattr(c, name)).all()):
            raise RuntimeError(f"{label}: non-finite {name}")
    dt = float(state.dt)
    if not dt > 0:
        raise RuntimeError(f"{label}: dt = {dt}")
    div = max_divergence(model, c)
    out = dict(n=n, steps=steps, ms_per_step=ms,
               points_per_s=n ** 3 / (ms * 1e-3), launches=launches, dt=dt,
               max_div=div, umax=float(c.u.abs().max()),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"  {label} on {smi}: {ms:.4f} ms/step, "
          f"{out['points_per_s']:.6g} grid-points/s, "
          f"{variant} launches {launches} "
          f"(= 3 x {steps}), dt {dt:.6g}, max|div u| {div:.3e}, "
          f"max|u| {out['umax']:.4f}, peak {out['peak_mem_gib']:.3f} GiB",
          flush=True)
    return out, state


def flat_main_path(n, warm, steps, smi, fused):
    from udales_tpu_torch import entry
    model = entry._build(n, n, n, "float32")    # the default device: the card
    return run_main_path(model, entry._init_state(model, seed=43), warm,
                         steps, smi, fused, f"flat {n}^3 float32")[0]


def check_kernel(fused, g, grid, pmasks, rtol, label, n):
    """One kernel call against the plain sweeps on the same card tensors;
    raises beyond `rtol` x max|ref|.  Returns the max abs error."""
    got = fused(g, grid, pmasks=pmasks)
    torch.cuda.synchronize()
    err, scale = max_rel_err(got, plain_diff(g, grid, pmasks))
    tol = rtol * scale
    phase(n, f"kernel vs plain, {label}: max abs err {err:.3e}, "
             f"tolerance {tol:.3e} ({rtol:g} x max|ref| {scale:.4g})")
    if not err <= tol:
        raise RuntimeError(f"kernel disagrees with plain on {label}")
    return err


def time_kernel(fused, g, grid, pmasks, smi, label, n, reps=50):
    """Kernel and plain ms, in turns plain, kernel, kernel, plain, printed
    beside the bound.  `ms` is CUDA events over `reps` back-to-back eager
    calls of the wrapper, whose host work can hide the kernel; `graph_ms`
    is the same calls captured in one CUDA graph, the kernel's own device
    time.  Returns dict(ms, plain_ms, bound_ms, graph_ms)."""
    from udales_tpu_torch.ops.fused_diff import least_bytes
    kernel = lambda: fused(g, grid, pmasks=pmasks)
    plain = lambda: plain_diff(g, grid, pmasks)
    for _ in range(3):
        kernel()
        plain()
    p1 = cuda_ms(plain, reps)
    e1, k1 = cuda_ms(kernel, reps), graph_ms(kernel, reps)
    e2, k2 = cuda_ms(kernel, reps), graph_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    nbytes = least_bytes(grid.shape, g.u.element_size(), pmasks is not None)
    out = dict(ms=(e1 + e2) / 2, plain_ms=(p1 + p2) / 2,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               graph_ms=(k1 + k2) / 2)
    share = lambda ms: f"{100 * out['bound_ms'] / ms:.1f}%"
    phase(n, f"{label} on {smi}: kernel {out['ms']:.4f} ms issued eagerly "
             f"({e1:.4f}, {e2:.4f}), {out['graph_ms']:.4f} ms in a CUDA "
             f"graph ({k1:.4f}, {k2:.4f}); plain diff_u/v/w "
             f"{out['plain_ms']:.4f} ms ({p1:.4f}, {p2:.4f}); bound "
             f"{out['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 "
             f"TB/s), of which the kernel reaches {share(out['ms'])} eagerly "
             f"and {share(out['graph_ms'])} in a graph = "
             f"{nbytes / (out['graph_ms'] * 1e-3) / 1e12:.3f} TB/s")
    return out


def parity(states, names):
    """Worst max|got - ref| / max|ref| of CUDA against CPU over `names`
    (fields of State.c, pres, dt, or facT: the facet temperatures)."""
    def pick(st, name):
        if name == "facT":
            return st.fac.T
        return getattr(st if name in ("pres", "dt") else st.c, name)
    worst = 0.0
    for name in names:
        a, b = pick(states["cpu"], name), pick(states["cuda"], name)
        rel = float((b.cpu() - a).abs().max()
                    / a.abs().max().clamp(min=1e-30))
        worst = max(worst, rel)
    return worst


def laplacian(p, grid, open_x=False, open_y=False, periodic_z=False):
    """The discrete Laplacian the Poisson solver inverts, on the card:
    periodic or zero-gradient (open) ghosts in x and y; in z zero flux
    through the floor and the top, or periodic on a uniform grid."""
    def second(f, dim, is_open, inv2):
        lo = f.narrow(dim, 0, 1) if is_open else f.narrow(dim, -1, 1)
        hi = f.narrow(dim, -1, 1) if is_open else f.narrow(dim, 0, 1)
        g = torch.cat([lo, f, hi], dim=dim)
        n = f.shape[dim]
        return (g.narrow(dim, 2, n) - 2 * f + g.narrow(dim, 0, n)) * inv2
    lap = second(p, 0, open_x, grid.dx2i) + second(p, 1, open_y, grid.dy2i)
    if periodic_z:
        return lap + second(p, 2, False, float(grid.dzfi[0]) ** 2)
    dzhi = grid.t("dzhi", p.device)
    dzfi = grid.t("dzfi", p.device)
    flux = (p[:, :, 1:] - p[:, :, :-1]) * dzhi[1:-1][None, None, :]
    zero = torch.zeros_like(p[:, :, :1])
    flux = torch.cat([zero, flux, zero], dim=2)
    return lap + (flux[:, :, 1:] - flux[:, :, :-1]) * dzfi[None, None, :]


def poisson_paths(grid, n):
    """Phase 17: each remaining PoissonSolver path on the card, float32:
    |laplacian(solve(rhs)) - rhs| <= 1e-4 max|rhs| for a zero-mean rhs."""
    import dataclasses
    from udales_tpu_torch.config import (BC_PROFILE, POISS_FFT3D, BCConfig,
                                         Config, DomainConfig,
                                         DynamicsConfig)
    from udales_tpu_torch.ops.poisson import PoissonSolver
    nx, ny, nz = grid.shape
    base = Config(domain=DomainConfig(itot=nx, jtot=ny, ktot=nz,
                                      xlen=grid.xlen, ylen=grid.ylen),
                  dtype="float32")
    paths = {
        "open x": (dict(bc=BCConfig(BCxm=BC_PROFILE)), dict(open_x=True)),
        "open y": (dict(bc=BCConfig(BCym=BC_PROFILE)), dict(open_y=True)),
        "open x and y": (dict(bc=BCConfig(BCxm=BC_PROFILE, BCym=BC_PROFILE)),
                         dict(open_x=True, open_y=True)),
        "BCzp=2": (dict(bc=BCConfig(BCzp=2)), {}),
        "POISS_FFT3D": (dict(dynamics=DynamicsConfig(ipoiss=POISS_FFT3D)),
                        dict(periodic_z=True)),
    }
    rng = np.random.default_rng(17)
    rhs = rng.standard_normal(grid.shape)
    rhs = torch.tensor(rhs - rhs.mean(), dtype=torch.float32, device="cuda")
    scale = float(rhs.abs().max())
    out = {}
    for name, (change, lap_kw) in paths.items():
        pois = PoissonSolver(grid, dataclasses.replace(base, **change),
                             device="cuda")
        p = pois.solve(rhs)
        torch.cuda.synchronize()
        res = float((laplacian(p, grid, **lap_kw) - rhs).abs().max()) / scale
        ms = cuda_ms(lambda: pois.solve(rhs), 10)
        out[name] = dict(residual=res, ms=ms)
        phase(n, f"Poisson {name}, {grid.shape} float32: residual "
                 f"{res:.3e} of max|rhs| (tolerance 1e-4), solve {ms:.4f} ms")
        if not (bool(torch.isfinite(p).all()) and res <= 1e-4):
            raise RuntimeError(f"Poisson path {name} does not invert the "
                               f"Laplacian")
    return out


def main():
    # 1. a CUDA device, or nothing
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); the port has no CPU "
                         "fallback here")
    from udales_tpu_torch import entry
    from udales_tpu_torch.cases import stage_urban, stage_urban_eb
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    from udales_tpu_torch.grid import Grid
    from udales_tpu_torch.ops.fused_diff import SOURCE, fused_diff_mom
    from udales_tpu_torch.run import load_case
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
    print("  resident blocks per SM: " + ", ".join(
        f"{'masked' if m else 'unmasked'} {str(dt)[6:]} "
        f"{fused_diff_mom.blocks_per_sm(dt, m)}"
        for dt in (torch.float32, torch.float64) for m in (False, True)),
        flush=True)

    # 4. kernel against its plain version on the card
    ragged_sweep(fused_diff_mom, masked=False, n=4)
    g128 = Grid.uniform(128, 128, 128, 128.0, 128.0, 128.0, dtype=np.float32)
    g256 = Grid.uniform(256, 256, 256, 256.0, 256.0, 256.0, dtype=np.float32)
    # the main paths' shapes
    kernel_err = max(check_kernel(
        fused_diff_mom, random_ghosts(grid, torch.float32, "cuda", seed=1),
        grid, None, 1e-5, f"uniform {grid.shape} float32", 4)
        for grid in (g128, g256))

    # 5. CUDA (kernel) against CPU (plain) over 5 steps
    states = {}
    for dev in ("cpu", "cuda"):
        model = entry._build(32, 32, 32, "float64", device=dev)
        st = state_from_numpy(numpy_state(model.grid, seed=7), device=dev)
        states[dev] = model.run(st, 5)
    worst = parity(states, ("u", "v", "w", "pres", "dt"))
    phase(5, f"32^3 float64, 5 steps, CUDA vs CPU: max rel err {worst:.3e} "
             f"over u, v, w, pres, dt (tolerance 1e-9)")
    if not worst <= 1e-9:
        raise RuntimeError("CUDA step disagrees with the CPU step")

    # 6./7. the flat main path
    div_bound = 1e-5
    main = flat_main_path(128, warm=5, steps=50, smi=smi,
                          fused=fused_diff_mom)
    phase(6, f"128^3 main path ok; max|div u| {main['max_div']:.3e} "
             f"<= {div_bound:g} (float32 bound)")
    if not main["max_div"] <= div_bound:
        raise RuntimeError("projection left a divergent velocity field")
    big = flat_main_path(256, warm=3, steps=20, smi=smi, fused=fused_diff_mom)
    phase(7, f"256^3 main path ok; max|div u| {big['max_div']:.3e}")
    if not big["max_div"] <= div_bound:
        raise RuntimeError("projection left a divergent velocity field")

    # 8. kernel time against the plain sweeps, in turns
    t128 = time_kernel(fused_diff_mom,
                       random_ghosts(g128, torch.float32, "cuda", seed=2),
                       g128, None, smi, "128^3 float32", 8)
    t256 = time_kernel(fused_diff_mom,
                       random_ghosts(g256, torch.float32, "cuda", seed=2),
                       g256, None, smi, "256^3 float32", 8, reps=20)

    # 9. stage the urban case (host NumPy preprocessing, no JAX)
    t0 = time.perf_counter()
    urban = {n: stage_urban(n, CACHE) for n in (32, 128)}
    phase(9, f"staged urban 32^3 and 128^3 in {time.perf_counter() - t0:.2f}"
             f" s under {CACHE.name}/")

    # 10. masked kernel against the plain masked sweeps
    u128 = load_case(urban[128], "900", dtype="float32")   # on the card
    ibm = u128.ibm
    pm128 = dict(u=ibm.pmask_u, v=ibm.pmask_v, w=ibm.pmask_w)
    solid = {k: int((getattr(ibm.masks, k) < 0.5).sum()) for k in "uvwc"}
    phase(10, f"urban 128^3: {ibm.nfcts} facets, solid points {solid}, "
              f"active sections "
              f"{ {k: int(ibm.sec[k].active.sum()) for k in 'uvwc'} }")
    masked_err = check_kernel(
        fused_diff_mom, random_ghosts(u128.grid, torch.float32, "cuda",
                                      seed=3),
        u128.grid, pm128, 1e-5, "masked, urban 128^3 masks, float32", 10)
    ragged_sweep(fused_diff_mom, masked=True, n=10)

    # 11. urban CUDA (masked kernel) against CPU (plain) over 5 steps
    states = {}
    start = None
    for dev in ("cpu", "cuda"):
        model = load_case(urban[32], "900", dtype="float64", device=dev)
        if start is None:
            start = state_to_numpy(model.cold_start(seed=43))
        states[dev] = model.run(state_from_numpy(start, device=dev), 5)
    worst = parity(states, ("u", "v", "w", "thl", "pres", "dt"))
    phase(11, f"urban 32^3 float64, 5 steps, CUDA vs CPU: max rel err "
              f"{worst:.3e} over u, v, w, thl, pres, dt (tolerance 1e-9)")
    if not worst <= 1e-9:
        raise RuntimeError("urban CUDA step disagrees with the CPU step")

    # 12. the urban main path
    urb, _ = run_main_path(u128, u128.cold_start(seed=43), warm=5, steps=30,
                           smi=smi, fused=fused_diff_mom,
                           label="urban 128^3 float32")
    phase(12, f"urban 128^3 main path ok; max|div u| {urb['max_div']:.3e} "
              f"<= {div_bound:g} (float32 bound)")
    if not urb["max_div"] <= div_bound:
        raise RuntimeError("projection left a divergent velocity field")

    # 13. masked kernel time against the plain masked sweeps, in turns
    tm128 = time_kernel(fused_diff_mom,
                        random_ghosts(u128.grid, torch.float32, "cuda",
                                      seed=6),
                        u128.grid, pm128, smi,
                        "masked, urban 128^3 float32", 13)

    # 14. stage the urban energy-balance case
    t0 = time.perf_counter()
    eb32 = stage_urban_eb(32, CACHE, dtEB=0.5)
    eb128 = stage_urban_eb(128, CACHE)
    phase(14, f"staged urban-EB 32^3 (dtEB 0.5 s) and 128^3 (dtEB 2 s) in "
              f"{time.perf_counter() - t0:.2f} s under {CACHE.name}/")

    # 15. urban-EB CUDA against CPU over 5 steps, the balance firing
    states = {}
    start = None
    for dev in ("cpu", "cuda"):
        model = load_case(eb32, "900", dtype="float64", device=dev)
        if start is None:
            start = state_to_numpy(model.cold_start(seed=43))
        states[dev] = model.run(state_from_numpy(start, device=dev), 5)
    worst = parity(states, ("u", "v", "w", "thl", "pres", "dt", "facT"))
    fired = float(states["cuda"].fac.tEB_last)
    moved = float((states["cuda"].fac.T - model.eb.T0).abs().max())
    phase(15, f"urban-EB 32^3 float64, 5 steps, CUDA vs CPU: max rel err "
              f"{worst:.3e} over u, v, w, thl, pres, dt, fac.T (tolerance "
              f"1e-9); last balance at t = {fired:.4f} s, facet "
              f"temperatures moved by up to {moved:.3e} K")
    if not (worst <= 1e-9 and fired > 0 and moved > 0):
        raise RuntimeError("urban-EB CUDA step disagrees with the CPU step, "
                           "or the balance never fired")

    # 16. the urban-EB main path at full size
    ue128 = load_case(eb128, "900", dtype="float32")        # on the card
    if ue128.eb is None:
        raise RuntimeError("load_case built no FacetEB for the lEB case")
    ueb, st = run_main_path(ue128, ue128.cold_start(seed=43), warm=5,
                            steps=50, smi=smi, fused=fused_diff_mom,
                            label="urban-EB 128^3 float32")
    fac = st.fac
    ueb.update(tEB_last=float(fac.tEB_last), facT_min=float(fac.T.min()),
               facT_max=float(fac.T.max()),
               facT_moved=float((fac.T - ue128.eb.T0).abs().max()))
    phase(16, f"urban-EB 128^3 main path: {ue128.eb.nfcts} facets, last "
              f"balance at t = {ueb['tEB_last']:.3f} s, facet temperatures "
              f"{ueb['facT_min']:.3f} .. {ueb['facT_max']:.3f} K (moved by "
              f"up to {ueb['facT_moved']:.3e} K), max|div u| "
              f"{ueb['max_div']:.3e} <= {div_bound:g}")
    if not (ueb["tEB_last"] > 0 and ueb["facT_moved"] > 0
            and bool(torch.isfinite(fac.T).all())
            and 250.0 <= ueb["facT_min"] and ueb["facT_max"] <= 350.0):
        raise RuntimeError("the energy balance never fired or left "
                           "unphysical facet temperatures")
    if not ueb["max_div"] <= div_bound:
        raise RuntimeError("projection left a divergent velocity field")
    # a host synchronisation inside the step raises in this mode
    st = ue128.cold_start(seed=43)
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = ue128.step(st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    phase(16, "one urban-EB step under set_sync_debug_mode('error'): no "
              "host synchronisation")

    # 17. the remaining Poisson paths on the card
    pois = poisson_paths(g128, 17)

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "udales_tpu"))
    if foreign:
        raise RuntimeError(f"the port imported {foreign}")

    src = "udales_tpu_torch/csrc/fused_diff_mom.cu"
    rates = lambda d: {k: d[k] for k in ("ms_per_step", "points_per_s",
                                         "peak_mem_gib")}
    print(json.dumps({"kernels": [
        {"name": "fused_diff_mom", "route": "cuda", "source": src,
         "replaces": "udales_tpu/ops/pallas_stencil.py:191",
         "launches": main["launches"], "max_abs_err": kernel_err,
         **t128, "bound_by": "bytes", "library_ms": None,
         "launches_256": big["launches"],
         **{f"{k}_256": v for k, v in t256.items()}},
        {"name": "fused_diff_mom_masked", "route": "cuda", "source": src,
         "replaces": "udales_tpu/ops/pallas_stencil.py:191",
         "launches": urb["launches"], "max_abs_err": masked_err,
         **tm128, "bound_by": "bytes", "library_ms": None,
         "launches_urban_eb": ueb["launches"]}],
        "main_path": rates(main), "main_path_256": rates(big),
        "urban_128": rates(urb),
        "urban_eb_128": {**rates(ueb), **{k: ueb[k] for k in (
            "tEB_last", "facT_min", "facT_max", "facT_moved")}},
        "poisson_128": pois}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
