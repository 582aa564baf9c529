"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives ``udales_tpu_torch`` (never JAX) through its main paths, the
adaptive RK3 step of the flat neutral ABL, of the urban building-array case
(immersed boundary), of the same array with the facet surface energy
balance, of the same array driven through an open x boundary by precursor
planes, and of the same array as a street-canyon dispersion case (passive
scalars, chemistry, trees, purifiers, heat pumps, the one-equation
closure), and checks both variants of the hand-written CUDA
diffusion kernel on the way.  The x/y process split runs the flat path
(phases 36-39), the urban paths (phases 40-43) and the open boundaries
(phases 44-48) over meshes of ranks.  Then the run-time driver: ``python -m
udales_tpu_torch`` with every output, restart continuation, the output
families on the other cases, the driver's cost and the runmodes.  Last, the
path of the long-horizon check ``validate_abl_torch.py`` (phases 49-51),
and the compiled step, a CUDA graph replayed once a step, against the
eager one on every main path (phases 52-54), and the compiled step of a
Model split over a 1 x 1 NCCL mesh (phases 55-57).  ``Simulation``, the
CLI and the validation step with the compiled step (phases 31-34, 49-51,
57).
Phases, one line each; any failure raises and the script exits non-zero
without a result line:

  1. require a CUDA device (no CPU fallback)
  2. card name and power limit (nvidia-smi), torch / CUDA versions
  3. build the kernels from the repository sources (nvcc, sm_90a):
     fused_diff_mom.cu, fused_adv_mom.cu, fused_vreman.cu,
     fused_ibmnorm.cu and fused_scalars.cu, their register and spill
     reports and resident blocks per SM
  4. unmasked kernel against its plain PyTorch version on the card: a
     sweep of ragged shapes on a stretched grid (float32 and float64), then
     the main paths' shapes 128^3 and 256^3 in float32
  5. flat step parity: 32^3 float64, 5 steps on CUDA (kernel) against CPU
  6. flat main path: 128^3 float32, warm-up then 20 timed steps
  7. the same at 256^3 float32, 20 timed steps
  8. unmasked kernel time (eager calls, and the same in a CUDA graph)
     against the plain sweeps at 128^3 and 256^3 float32, beside its bound
     (least bytes over the card's memory rate)
  9. stage the urban case at 32^3 and 128^3 (udales_tpu_torch.cases, into
     .bench_cache/)
 10. masked kernel against the plain masked sweeps: the urban 128^3 masks
     in float32, and random {0,1} masks over the sweep of ragged shapes
 11. urban step parity: 32^3 float64, 5 steps on CUDA against CPU
 12. urban main path: 128^3 float32, warm-up then 20 timed steps
 13. masked kernel time against the plain masked sweeps at 128^3 float32,
     beside its bound
 14. stage the urban energy-balance case (cases.stage_urban_eb) at 32^3
     (dtEB = 0.5 s, so that 5 steps see the balance fire) and at 128^3
 15. urban-EB step parity: 32^3 float64, 5 steps on CUDA against CPU,
     fields and facet temperatures
 16. urban-EB main path: 128^3 float32 through load_case, cold_start and
     run, warm-up then 30 timed steps; the balance fired, the facet
     temperatures stayed physical; one more step under
     torch.cuda.set_sync_debug_mode("error"): no host synchronisation
 17. the Poisson solver's open-boundary (Neumann), BCzp = 2 and POISS_FFT3D
     paths at 128^3 float32: residual of the discrete Laplacian
 18. stage the precursor-driven urban case (cases.stage_urban_driven) at
     32^3 and at 128^3 (120 driver records 0.1 s apart, read 16 at a time)
 19. driven urban step parity: 32^3 float64, 5 steps on CUDA against CPU,
     fields, outlet planes and pressure
 20. driven urban main path: 128^3 float32 through load_case, cold_start and
     run (which refills the rolling window before each step), warm-up then
     50 timed steps; the inlet face equals the interpolated driver plane,
     the interior is divergence-free with the outlet face counted, the
     window was refilled
 21. one driven step and one rescale-recycle step under
     torch.cuda.set_sync_debug_mode("error") (the window refill stays
     outside the guarded region)
 22. flat open-x 128^3 float32 with the rescale-recycle inlet generator
     (iinletgen = 1), 20 steps
 23. precursor to driven at 64^3 float32: 30 periodic steps recorded by
     sim.DriverRecorder, saved as ?driver_* files and driverdata.<exp>.h5
     (the port's own HDF5 writer); the h5 series read back on the card by
     load_driver_inlet equals the files' series exactly; replayed by
     load_case (from the h5 series) for 10 steps
 24. both kernel variants against their plain versions on ghosts built by
     the open-boundary assembly (non-periodic planes, zero-gradient ekm)
 25. stage the street-canyon dispersion case (cases.stage_urban_dispersion:
     NO, NO2, O3 from canyon line sources and a rooftop stack, chemistry,
     trees) at 32^3 and 128^3, plain, with purifiers and heat pumps, and
     with the one-equation closure
 26. dispersion step parity: 32^3 float64, 5 steps on CUDA against CPU,
     every State leaf, for the three variants
 27. dispersion main path: 128^3 float32 through load_case, cold_start and
     run, 50 timed steps beside the urban path's time; finite scalars, the
     masked kernel 3 times a step, divergence-free; chem_update alone on
     the 128^3 scalars keeps the NO + NO2 molar sum
 28. the purifier and heat-pump variant at 128^3, 20 steps: the purifier
     boxes hold Qpu / Apu, the flow outside them is divergence-free
 29. the one-equation variant at 128^3, 20 steps: e12 finite and at or
     above e12min
 30. one step of each variant under torch.cuda.set_sync_debug_mode("error")
 31. the user's path: the urban-EB 128^3 case with every output family on,
     run by ``python -m udales_tpu_torch`` in a subprocess for 14 s of
     simulated time; the exit code, the monitor (one line a step), every
     file read back by scipy with the writers' variables and as many
     records as the cadences give, all finite, max|div u| after the last
     step, the masked kernel 3 times a step and the compiled step (the
     CLI's closing line); trestart 7 s leaves initd*.900.h5 checkpoints,
     the last read back (udales_tpu_torch.io.hdf5, no h5py) with the
     facet state and the accumulators of the five statistics families
 32. restart continuation: N steps, the reference's Fortran restart files,
     N more in a second process (this script's --resume mode, which runs
     the CLI's main and saves the final State), against 2N in one process;
     urban 32^3 float64 (every leaf to 1e-9) and 128^3 float32 (max|du|
     to 1e-4 of max|u|); then through the native .h5 checkpoint (the
     port's own reader and writer; the card's machine has no h5py): urban
     32^3 float64 and urban-EB 32^3 float64 with its facet state and the
     xytdump accumulators, which the Fortran files cannot carry (every
     leaf and the end time to 1e-9; for urban-EB also the checkpoints
     after step 2N of the second process and of an uninterrupted
     Simulation, statistics accumulators included, to 1e-9), 3 masked
     launches a step
 33. the dispersion case at 128^3 (tree dump, scalar field dumps and
     statistics) and the driven case at 32^3 (xytdump, tkedump) through
     Simulation: launches, files and records as in 31
 34. the driver's cost: Simulation.run with every writer (on the compiled
     step) against Model.run, eager and captured, on urban-EB 128^3 in
     turns, and one sample and one write of
     each family alone (host ms, launches and device ms); the native
     checkpoint of the urban-EB 128^3 float32 State: seconds, bytes and
     MB/s of save_checkpoint and of load_checkpoint onto the card (3
     each; read back exactly), and the seconds of one
     Simulation._write_restart with every family's accumulators
 35. runmodes 1003, 1004 and 1005 through the CLI
 36. the x/y split (parallel/mesh.py, parallel/multihost.py) on one rank
     with NCCL: mesh 1 x 1, 32^3 float64, 5 steps through the real NCCL
     collectives, every State leaf against Model.run without a mesh (1e-12)
 37. NCCL's answer to two ranks on the one card; then meshes 2 x 1, 1 x 2
     and 2 x 2 of ranks that share the card (spawned processes, gloo,
     exchanges staged through pinned host memory), 32^3 float64, 5 steps,
     the gathered State against the single-process card run (1e-9)
 38. flat 128^3 float32 on the 2 x 2 mesh, 10 steps: gathered max|div u|,
     3 kernel launches a step on each rank, one step under
     torch.cuda.set_sync_debug_mode("error"), ms/step per rank and the
     collectives a step (4 ranks on one card: not a speed of the split)
 39. the unmasked kernel at the 2 x 2 block shape 64 x 64 x 128 float32
     against its plain version, timed beside its bound
 40. the urban split on one rank with NCCL: mesh 1 x 1, urban 32^3 float64
     through load_case(..., mesh=), 5 steps, every State leaf against
     Model.run without a mesh (1e-12)
 41. urban, urban-EB (dtEB 0.5 s) and dispersion with purifiers and heat
     pumps at 32^3 float64 on the 2 x 2 mesh of ranks that share the card
     (gloo, host-staged), 5 steps: the gathered State against the
     single-process card run (1e-9), fac.T and every scalar included
 42. urban 128^3 float32 on 2 x 2, 10 steps: gathered max|div u|, 3 masked
     launches a step on each rank, one step under
     torch.cuda.set_sync_debug_mode("error"), ms/step per rank, collectives
     and bytes a step (4 ranks on one card: the host staging, not a speed
     of the split)
 43. the masked kernel at the block shape 64 x 64 x 128 float32 with the
     pmasks of a 2 x 2 block of the urban 128^3 case (IBM.load(...,
     mesh=)), against its plain version, timed eagerly and in a CUDA graph
     beside its bound
 44. the open split on one rank with NCCL: mesh 1 x 1, driven urban 32^3
     float64 (records 0.05 s apart, 4 a window) through load_case(...,
     mesh=), 5 steps, every State leaf (the outlet planes and the driver
     window included) against Model.run without a mesh (1e-12); then one
     step under torch.cuda.set_sync_debug_mode("error") with the refill
     outside it
 45. the open family at 32^3 float64 on the 2 x 2 mesh of ranks that share
     the card (gloo, host-staged), 5 steps each: driven urban (the window
     refilled), a box behind an open-x profile inlet, open y, both open,
     the rescale-recycle generator (iinletgen = 1, BCxm = 2), BCzp = 2 and
     POISS_FFT3D; the gathered State against the single-process card run
     (1e-9), bx, by, ig and drv included
 46. driven urban 128^3 float32 on 2 x 2 from t = 1.1 s, 10 steps: the
     gathered inlet face against the interpolated driver plane, interior
     and top max|div u| with the outlet face, the window refilled, 3 masked
     launches a step on each rank, one step under
     torch.cuda.set_sync_debug_mode("error") with the refill outside it,
     ms/step per rank, collectives and bytes a step, the staged share (4
     ranks on one card: not a speed of the split)
 47. the masked kernel on the cx == 0 block (64 x 64 x 128 float32) of
     driven urban 128^3 on 2 x 2: the block's pmasks and ghosts, the inlet
     planes on its open x edge, against its plain version, timed eagerly
     and in a CUDA graph beside its bound
 48. Simulation on a split Model: driven urban 32^3 float64 on 2 x 2 with
     field dumps, xytdump, tkedump and the monitor, against the
     single-process Simulation (every array handed to a writer and the
     final State, 1e-9); the Fortran restart of the gathered State (outlet
     planes in the halo) continued for 3 steps in one process against the
     uninterrupted run (1e-9); host ms a gather
 49. validate_abl_torch.py's path (the long-horizon neutral-ABL check) at
     32^3 float32, 4 chunks of 100 steps in this process: finite records,
     3 unmasked launches a step; its stress profile on the card against
     the same State's on the CPU in float64 (1e-5 of max|tau|); the
     unmasked kernel at its full-size shape 64^3 float32 against its plain
     version, timed as phase 8 does
 50. the check chained on the card: 2 chunks and --save in this process,
     then a second process with --resume for 2 more; its records and
     final State against phase 49's uninterrupted run (1e-6 of each
     leaf's largest value)
 51. the Fortran warm start of a generator case: the rescale-recycle case
     of phase 45 (iinletgen = 1, BCxm = 2) at 32^3 float64, 3 steps, the
     reference's restart files, warmstart_state(..., model=) (the
     generator's state built from the warm fields), 3 more steps, all
     finite; then the same case through python -m udales_tpu_torch with
     lwarmstart and the Fortran startfile; and continued through the
     native .h5 checkpoint (3 steps, 3 more in a second process, against
     6 in one: every leaf, the generator's state ig included, and the end
     time to 1e-9; 3 unmasked launches a step)
 52. the compiled step (Model.step_jit: one RK3 step captured as one CUDA
     graph) on flat 128^3 and 256^3, urban, urban-EB, driven urban and
     dispersion 128^3 float32: warm-up, the build (one eager step, then the
     capture; its seconds and the memory its pool and static State hold),
     then runs in turns eager, captured, captured, eager (ms/step, points/s,
     peak memory; launches = 3 x steps of the path's variant, counted
     across replays; every replay under
     torch.cuda.set_sync_debug_mode("error"), the window refill outside
     it); max|div u| of the captured run; captured against eager over 10
     steps from one State, every field within 1e-4 of its max
 53. 5 captured steps on the card against 5 eager steps on the CPU, 32^3
     float64, every State leaf (1e-9): flat, urban, urban-EB, driven and
     dispersion
 54. the captured rates side by side
 55. the compiled step of a split Model (Model.run(..., graph=True) on a
     1 x 1 NCCL mesh, which goes through every collective of the split;
     NCCL's version printed): flat, urban, urban-EB, driven and
     rescale-recycle 32^3 float64, 5 captured steps each, every State leaf
     against the eager split run and against Model.run on one process
     (1e-12), the same collectives and bytes as the eager split run
 56. urban and driven urban 128^3 float32 on the 1 x 1 NCCL mesh: warm-up,
     the build, runs in turns eager, captured, captured, eager of 20 steps
     (ms/step beside phase 52's one-process captured step, collectives and
     bytes a step in every run, masked launches = 3 x steps, every replay
     under torch.cuda.set_sync_debug_mode("error") with the window refill
     outside it), capture seconds, the pool and static State; captured
     against eager over 10 steps (1e-4 of each field's max), max|div u|
     under phase 12's bound (phase 20's on the driven path)
 57. Simulation of phase 48's driven urban 32^3 float64 case on the 1 x 1
     NCCL mesh, stepping compiled (a CUDA graph), against the
     single-process Simulation (every array handed to a writer and the
     final State, 1e-9); then the NCCL group is destroyed after its graphs
     are freed, and a 1 x 1 gloo mesh that stages through the host refuses
     the compiled step on the card (NotImplementedError, printed) and its
     Simulation steps eagerly
 60. (run after phase 8) the advection kernel (csrc/fused_adv_mom.cu)
     against its plain route advection.adv_mom on the card: the ragged
     shapes on a stretched grid and a 64 x 64 x 128 rank block, float64
     (1e-12) and float32 (1e-5), with and without thl, faces 0 and nz of
     dw exactly zero; then 128^3 and 256^3 float32 with thl, timed as phase
     8 times the diffusion kernel (eager, in a CUDA graph, the plain route,
     the bound).  Every main path's timed run (phases 6, 7, 12, 16, 20,
     22, 27-29, 52, 56, 58) also counts its launches: 3 a step
 61. (run after phase 60) the Vreman closure kernel (csrc/fused_vreman.cu)
     against its plain route subgrid.vreman_closure on the card: the
     ragged shapes on a stretched grid and a 64 x 64 x 128 rank block,
     float64 (1e-12) and float32 (1e-5), with and without the buoyancy
     correction; then 128^3, 256^3 and 512 x 512 x 128 float32 without
     it, timed as phase 60 times the advection kernel.  Every main path's
     timed run also counts its launches: 3 a step with closed boundaries,
     4 with an open one, none where the closure is not Vreman's
 62. (run after phase 61) the ibmnorm kernel (csrc/fused_ibmnorm.cu)
     against its plain route IBM.ibmnorm_uvw_thl on the card, bit for
     bit: the ragged shapes on a stretched grid and a 64 x 64 x 128 rank
     block, float64 and float32, with thl and the liberal correction,
     with thl alone and without thl, on random masks with an enclosed
     solid box; then 128^3, 256^3 and 512 x 512 x 128 float32 with thl
     and the correction, timed as phase 61 times the Vreman kernel.
     Every main path's timed run with an IBM also counts its launches: 3
     a step
 63. (run after phase 62) the scalar-stack kernel (csrc/fused_scalars.cu)
     against its plain route fused_scalars.plain_scalars on the card, bit
     for bit: the ragged shapes on a stretched grid and a 64 x 64 x 128
     rank block, float64 and float32, one and three scalars, with and
     without the c mask; then 128^3 and 512 x 512 x 128 float32 with three
     scalars and the mask, timed as phase 62 times the ibmnorm kernel.
     Every main path's timed run with scalars also counts its launches: 3
     a step
The line before the last is a JSON object describing the kernels and the
main paths; the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --cards

needs four cards and runs phase 58 alone: the compiled step of a Model
split over 2 x 2 NCCL ranks, one a card (urban and driven urban 32^3
float64 captured against the eager split and one card; urban and driven
urban 128^3 float32 captured and eager in turns beside one card's
captured step), ending with a JSON line of its numbers.
"""
from __future__ import annotations

import json
import math
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
    """(max|div u| of the projected velocity `c` on the model's grid, the
    same over the top level alone).  Periodic directions wrap; an open x
    takes its outlet face from the prognostic plane ``c.bx.u`` (open y from
    ``c.by.v``), and the inflow/outflow defect of the mean pressure mode
    then sits in the top level, which the first number leaves out."""
    grid = model.grid
    gu = torch.cat([c.u, c.u[:1] if c.bx is None else c.bx.u[None]], dim=0)
    gv = torch.cat([c.v, c.v[:, :1] if c.by is None else c.by.v[:, None]],
                   dim=1)
    dzfi = grid.t("dzfi", c.u.device)
    div = ((gu[1:] - gu[:-1]) * grid.dxi + (gv[:, 1:] - gv[:, :-1]) * grid.dyi
           + (c.w[:, :, 1:] - c.w[:, :, :-1]) * dzfi[None, None, :]).abs()
    top = float(div[:, :, -1].max())
    if c.bx is None and c.by is None:
        return float(div.max()), top
    return float(div[:, :, :-1].max()), top


def replay_launches(step):
    """The hand kernels' launches in one replay of the compiled `step`, by
    counter name (``fused_diff_mom.launches``, ...)."""
    return {k: n for k, n in step.per_replay.items()
            if k.endswith("launches")}


def captured_run(model, state, steps):
    """`steps` calls of the compiled step ``model.step_jit()``, each replay
    under torch.cuda.set_sync_debug_mode("error") (a host wait inside it
    raises) and the window refill of a driven case outside the guard, as
    ``Model.run(..., graph=True)`` steps.  Returns the compiled step's
    static State."""
    step = model.step_jit()
    stream = model.driver_stream
    for _ in range(steps):
        if stream is not None:
            state = stream.ensure(state)
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = step(state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return state


def vreman_calls(model):
    """Closure calls a step of `model` that take the Vreman kernel: the
    step entry's and those of substeps 2 and 3, and substep 1's too where
    an open boundary's inlet planes move with the time (``Model.step``);
    none where the closure is another model's."""
    from udales_tpu_torch.config import SGS_VREMAN
    if model.cfg.subgrid.model != SGS_VREMAN:
        return 0
    return 4 if model.inlet is not None or model.inlet_y is not None else 3


def timed_run(model, state, steps, graph, fused, label):
    """`steps` steps of `model` from `state` between CUDA events, eagerly
    (``Model.run``) or as replays of the captured step (`captured_run`),
    with the launch counts set to 0 just before and read just after: the
    diffusion kernel's own variant must launch 3 times a step, counted
    across replays, and the other not at all, and the advection kernel 3
    times a step, and the Vreman kernel as often as the step calls the
    closure (`vreman_calls`), the ibmnorm kernel 3 times a step with an
    IBM, and the scalar-stack kernel 3 times a step with scalars.  Returns
    (numbers, final State)."""
    from udales_tpu_torch.ops.fused_adv import fused_adv_mom
    from udales_tpu_torch.ops.fused_ibmnorm import fused_ibmnorm
    from udales_tpu_torch.ops.fused_scalars import fused_scalars
    from udales_tpu_torch.ops.fused_vreman import fused_vreman
    masked = model.ibm is not None
    scalars = state.c.sv.shape[0] > 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused.launch_count = fused.masked_launch_count = 0
    fused_adv_mom.launch_count = fused_vreman.launch_count = 0
    fused_ibmnorm.launch_count = fused_scalars.launch_count = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    state = (captured_run(model, state, steps) if graph
             else model.run(state, steps))
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / steps
    counts = (fused.launch_count, fused.masked_launch_count)
    launches, other = counts[::-1] if masked else counts
    if launches != 3 * steps or other != 0:
        raise RuntimeError(f"{label}: kernel launches (unmasked, masked) = "
                           f"{counts} in {steps} {'captured' if graph else 'eager'} steps, "
                           f"expected {3 * steps} of the "
                           f"{'masked' if masked else 'unmasked'} variant")
    if fused_adv_mom.launch_count != 3 * steps:
        raise RuntimeError(f"{label}: {fused_adv_mom.launch_count} "
                           f"advection kernel launches in {steps} steps, "
                           f"expected {3 * steps}")
    if fused_vreman.launch_count != vreman_calls(model) * steps:
        raise RuntimeError(f"{label}: {fused_vreman.launch_count} Vreman "
                           f"kernel launches in {steps} steps, expected "
                           f"{vreman_calls(model) * steps}")
    if fused_ibmnorm.launch_count != (3 * steps if masked else 0):
        raise RuntimeError(f"{label}: {fused_ibmnorm.launch_count} ibmnorm "
                           f"kernel launches in {steps} steps, expected "
                           f"{3 * steps if masked else 0}")
    if fused_scalars.launch_count != (3 * steps if scalars else 0):
        raise RuntimeError(f"{label}: {fused_scalars.launch_count} scalar-"
                           f"stack kernel launches in {steps} steps, "
                           f"expected {3 * steps if scalars else 0}")
    ms = start.elapsed_time(end) / steps
    n = model.grid.itot * model.grid.jtot * model.grid.ktot
    return dict(ms_per_step=ms, host_ms_per_step=host,
                points_per_s=n / (ms * 1e-3), launches=launches,
                adv_launches=fused_adv_mom.launch_count,
                vreman_launches=fused_vreman.launch_count,
                ibmnorm_launches=fused_ibmnorm.launch_count,
                scalars_launches=fused_scalars.launch_count,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                reserved_gib=torch.cuda.memory_reserved() / 2 ** 30), state


def captured_turns(model, steps, fused, label, before_run=None):
    """The body of phases 52, 56 and 58 for one path: 3 eager warm-up
    steps from the cold start, the build (one eager step, then the
    capture; the memory its pool and static State hold), runs in turns
    eager, captured, captured, eager of `steps` steps (`timed_run`; with a
    mesh, its collectives and bytes a step beside each; `before_run` is
    called before each run), then captured against eager over 10 steps
    from one State (a driven start without its window gets the window of
    its own time).  Returns (runs {"eager": [...], "captured": [...]}, the
    compiled step, pool GiB, the State of the comparison's start, {field:
    max|captured - eager| / max|eager|}, (max|div u|, top level) of the
    captured fields)."""
    from udales_tpu_torch.parallel.mesh import gather_state
    from udales_tpu_torch import entry
    mesh = model.mesh
    start = (entry._init_state(model, seed=43) if model.inputs is None
             else model.cold_start(seed=43))
    st = model.run(start, 3)                           # eager warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    step = model.step_jit()
    st = captured_run(model, st, 1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool = (torch.cuda.memory_reserved() - reserved0) / 2 ** 30
    runs = {"eager": [], "captured": []}
    for which in ("eager", "captured", "captured", "eager"):
        if before_run is not None:
            before_run()
        if mesh is not None:
            mesh.reset_counts()
        res, st = timed_run(model, st, steps, which == "captured", fused,
                            f"{label} {which}")
        if mesh is not None:
            res.update(collectives=mesh.collectives / steps,
                       bytes=mesh.bytes / steps)
        runs[which].append(res)
    st0 = st.map(torch.clone)
    if model.driver_stream is not None:
        st0 = st0.replace(drv=None)
    whole = ((lambda x: x) if mesh is None
             else (lambda x: gather_state(x, mesh)))
    a = whole(model.run(st0, 10)).c
    b = whole(captured_run(model, st0, 10)).c
    div = max_divergence(SimpleNamespace(grid=model.domain_grid), b)
    rel = {k: float((getattr(b, k) - getattr(a, k)).abs().max()
                    / getattr(a, k).abs().max().clamp(min=1e-30))
           for k in ("u", "v", "w", "thl", "qt", "e12", "sv")
           if getattr(a, k).numel()}
    return runs, step, pool, st0, rel, div


def run_main_path(model, state, warm, steps, smi, fused, label):
    """Phase 6/7/12/16/20/22 body: warm `model` up on the card, then time
    `steps` eager steps (`timed_run`: both launch counts set to 0 just
    before and read just after, the path's own variant 3 times a step and
    the other not at all).  Returns the numbers and the final State."""
    n = model.grid.itot
    state = model.run(state, warm)
    out, state = timed_run(model, state, steps, False, fused, label)
    c = state.c
    for name in ("u", "v", "w", "thl", "e12"):
        if not bool(torch.isfinite(getattr(c, name)).all()):
            raise RuntimeError(f"{label}: non-finite {name}")
    dt = float(state.dt)
    if not dt > 0:
        raise RuntimeError(f"{label}: dt = {dt}")
    div, top_div = max_divergence(model, c)
    out.update(n=n, steps=steps, dt=dt, max_div=div, top_div=top_div,
               umax=float(c.u.abs().max()))
    variant = "masked" if model.ibm is not None else "unmasked"
    print(f"  {label} on {smi}: {out['ms_per_step']:.4f} ms/step, "
          f"{out['points_per_s']:.6g} grid-points/s, "
          f"{variant} launches {out['launches']} "
          f"(= 3 x {steps}), dt {dt:.6g}, max|div u| {div:.3e}, "
          f"max|u| {out['umax']:.4f}, peak {out['peak_mem_gib']:.3f} GiB",
          flush=True)
    return out, state


def flat_main_path(n, warm, steps, smi, fused):
    from udales_tpu_torch import entry
    model = entry._build(n, n, n, "float32")    # the default device: the card
    return run_main_path(model, entry._init_state(model, seed=43), warm,
                         steps, smi, fused, f"flat {n}^3 float32")[0]


def advection_inputs(grid, dtype, seed):
    """Ghosted u, v, w, thl and the padded pressure as the advection kernel
    takes them, from a numpy seed."""
    nx, ny, nz = grid.shape
    rng = np.random.default_rng(seed)
    cell = (nx + 2, ny + 2, nz + 2)
    t = lambda a: torch.tensor(a, dtype=dtype, device="cuda")
    g = SimpleNamespace(
        u=t(rng.standard_normal(cell)), v=t(rng.standard_normal(cell)),
        w=t(rng.standard_normal((nx + 2, ny + 2, nz + 1))),
        thl=t(288.0 + rng.standard_normal(cell)))
    return g, t(rng.standard_normal((nx + 2, ny + 2, nz)))


def advection_phase(smi, grids, n=60):
    """Phase 60: the advection kernel against its plain route over the
    ragged shapes and a rank block (both dtypes, with and without thl),
    at the main paths' shapes, and its time there with thl (as
    `time_kernel`).  Any miss raises.  Returns dict(err, t128, t256)."""
    from udales_tpu_torch.grid import Grid
    from udales_tpu_torch.ops.advection import adv_mom
    from udales_tpu_torch.ops.fused_adv import fused_adv_mom, least_bytes

    def check(grid, dtype, rtol, thl, label):
        g, gp = advection_inputs(grid, dtype, seed=1)
        got = fused_adv_mom(g, gp, grid, thl=thl)
        torch.cuda.synchronize()
        ref = adv_mom(g, gp, grid, thl)
        if (got[3] is None) == thl:
            raise RuntimeError(f"advection kernel: dthl on {label}")
        keep = 4 if thl else 3
        err, scale = max_rel_err(got[:keep], ref[:keep])
        if not (err <= rtol * scale and bool((got[2][..., 0] == 0).all())
                and bool((got[2][..., -1] == 0).all())):
            raise RuntimeError(f"advection kernel disagrees with plain on "
                               f"{label}: {err:.3e} of {scale:.4g}")
        return err

    worst = {}
    for shape in RAGGED_SHAPES + [(64, 64, 128)]:
        nz = shape[2]
        zf = np.cumsum(1.04 ** np.arange(nz)) - 0.5 * 1.04 ** np.arange(nz)
        for np_dt, dtype, rtol in ((np.float64, torch.float64, 1e-12),
                                   (np.float32, torch.float32, 1e-5)):
            grid = Grid(*shape, float(shape[0]), float(shape[1]), zf,
                        dtype=np_dt)
            for thl in (True, False):
                err = check(grid, dtype, rtol, thl, f"{shape} {np_dt.__name__}"
                            f"{' thl' if thl else ''}")
                key = np_dt.__name__
                worst[key] = max(worst.get(key, 0.0), err)
    phase(n, f"advection kernel vs plain over {len(RAGGED_SHAPES) + 1} "
             f"shapes (stretched), with and without thl: max abs err "
             f"float64 {worst['float64']:.3e}, float32 {worst['float32']:.3e}")
    err = max(check(grid, torch.float32, 1e-5, True,
                    f"uniform {grid.shape} float32") for grid in grids)
    times = []
    for grid in grids:
        g, gp = advection_inputs(grid, torch.float32, seed=2)
        times.append(kernel_turns(
            lambda: fused_adv_mom(g, gp, grid, thl=True),
            lambda: adv_mom(g, gp, grid, True), grid,
            least_bytes(grid.shape, 4, True), smi,
            f"advection kernel {grid.itot}^3 float32 with thl", "adv_mom",
            n))
    return dict(err=err, t128=times[0], t256=times[1])


def kernel_turns(kernel, plain, grid, nbytes, smi, label, plain_name, n):
    """A kernel's time beside its plain route and its bound, in turns plain,
    kernel, kernel, plain (as `time_kernel`; 50 calls a run up to 128^3,
    20 above), printed as phase `n`.  Returns dict(ms, plain_ms, bound_ms,
    graph_ms, share)."""
    reps = 50 if grid.itot <= 128 else 20
    for _ in range(3):
        kernel()
        plain()
    p1 = cuda_ms(plain, reps)
    e1, k1 = cuda_ms(kernel, reps), graph_ms(kernel, reps)
    e2, k2 = cuda_ms(kernel, reps), graph_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    out = dict(ms=(e1 + e2) / 2, plain_ms=(p1 + p2) / 2,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               graph_ms=(k1 + k2) / 2)
    out["share"] = out["bound_ms"] / out["graph_ms"]
    phase(n, f"{label} on {smi}: {out['ms']:.4f} ms issued eagerly "
             f"({e1:.4f}, {e2:.4f}), {out['graph_ms']:.4f} ms in a CUDA "
             f"graph ({k1:.4f}, {k2:.4f}); plain {plain_name} "
             f"{out['plain_ms']:.4f} ms ({p1:.4f}, {p2:.4f}); bound "
             f"{out['bound_ms']:.4f} ms ({nbytes / 1e6:.2f} MB at 3.35 "
             f"TB/s): {100 * out['share']:.1f}% of it in a graph; no "
             f"library call computes it")
    return out


def vreman_inputs(grid, dtype, seed):
    """Ghosted u, v, w, and the interior dthvdz and thl, as the Vreman
    kernel takes them, from a numpy seed: (ghosts, dthvdz, thl)."""
    nx, ny, nz = grid.shape
    rng = np.random.default_rng(seed)
    cell = (nx + 2, ny + 2, nz + 2)
    t = lambda a: torch.tensor(a, dtype=dtype, device="cuda")
    g = SimpleNamespace(
        u=t(rng.standard_normal(cell)), v=t(rng.standard_normal(cell)),
        w=t(rng.standard_normal((nx + 2, ny + 2, nz + 1))))
    return (g, t(5.0 * rng.standard_normal(grid.shape)),
            t(288.0 + rng.standard_normal(grid.shape)))


def vreman_phase(smi, n=61):
    """Phase 61: the Vreman kernel against its plain route over the ragged
    shapes and a rank block (both dtypes, with and without the buoyancy
    correction), and its time without it at 128^3, 256^3 and 512 x 512 x
    128 float32 (as `advection_phase`).  Any miss raises.  Returns
    dict(err, t128, t256, t512)."""
    from udales_tpu_torch.config import (Config, DomainConfig,
                                         PhysicsConfig, SubgridConfig)
    from udales_tpu_torch.grid import Grid
    from udales_tpu_torch.ops.fused_vreman import fused_vreman, least_bytes
    from udales_tpu_torch.ops.subgrid import vreman_closure

    def config(grid, buoy):
        return Config(domain=DomainConfig(
            itot=grid.itot, jtot=grid.jtot, ktot=grid.ktot, xlen=grid.xlen,
            ylen=grid.ylen), physics=PhysicsConfig(lbuoyancy=buoy),
            subgrid=SubgridConfig(lbuoycorr=buoy))

    def check(grid, dtype, rtol, buoy, label):
        g, dthvdz, thl = vreman_inputs(grid, dtype, seed=1)
        cfg = config(grid, buoy)
        got = fused_vreman(g, grid, cfg, dthvdz, thl)
        torch.cuda.synchronize()
        err, scale = max_rel_err(got, vreman_closure(g, grid, cfg, dthvdz,
                                                     thl))
        if not err <= rtol * scale:
            raise RuntimeError(f"Vreman kernel disagrees with plain on "
                               f"{label}: {err:.3e} of {scale:.4g}")
        return err

    worst = {}
    for shape in RAGGED_SHAPES + [(64, 64, 128)]:
        nz = shape[2]
        zf = np.cumsum(1.04 ** np.arange(nz)) - 0.5 * 1.04 ** np.arange(nz)
        for np_dt, dtype, rtol in ((np.float64, torch.float64, 1e-12),
                                   (np.float32, torch.float32, 1e-5)):
            grid = Grid(*shape, float(shape[0]), float(shape[1]), zf,
                        dtype=np_dt)
            for buoy in (False, True):
                err = check(grid, dtype, rtol, buoy,
                            f"{shape} {np_dt.__name__}"
                            f"{' buoycorr' if buoy else ''}")
                key = np_dt.__name__
                worst[key] = max(worst.get(key, 0.0), err)
    phase(n, f"Vreman kernel vs plain over {len(RAGGED_SHAPES) + 1} shapes "
             f"(stretched), with and without the buoyancy correction: max "
             f"abs err float64 {worst['float64']:.3e}, float32 "
             f"{worst['float32']:.3e}")
    grids = [Grid.uniform(nx, nx, nz, float(nx), float(nx), float(nz),
                          dtype=np.float32)
             for nx, nz in ((128, 128), (256, 256), (512, 128))]
    err = max(check(grid, torch.float32, 1e-5, False,
                    f"uniform {grid.shape} float32") for grid in grids)
    times = []
    for grid in grids:
        g, _, _ = vreman_inputs(grid, torch.float32, seed=2)
        cfg = config(grid, False)
        times.append(kernel_turns(
            lambda: fused_vreman(g, grid, cfg),
            lambda: vreman_closure(g, grid, cfg), grid,
            least_bytes(grid.shape, 4, False), smi,
            f"Vreman kernel {'x'.join(map(str, grid.shape))} float32",
            "vreman_closure", n))
        del g
        torch.cuda.empty_cache()
    return dict(err=err, t128=times[0], t256=times[1], t512=times[2])


# the variants of the ibmnorm kernel: ltempeq, and the scheme of thl (cd2:
# the liberal correction; kappa: none)
IBMNORM_VARIANTS = {"thl + correction": (True, 2), "thl": (True, 7),
                    "no thl": (False, 2)}


def ibmnorm_inputs(shape, np_dt, ltempeq, iadv_thl, seed, stretch=1.0):
    """(ibm, c, m, du, dv, dw, dthl, thl_vmean) on the card as the ibmnorm
    kernel takes them: an IBM of random 0/1 masks with an enclosed solid
    box and no facet sections, random fields, from a numpy seed."""
    from udales_tpu_torch.config import (Config, DomainConfig,
                                         DynamicsConfig, PhysicsConfig)
    from udales_tpu_torch.grid import Grid
    from udales_tpu_torch.ibm.ibm import GRIDS, IBM, SecData
    from udales_tpu_torch.state import Fields
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    zf = np.cumsum(stretch ** np.arange(nz)) - 0.5 * stretch ** np.arange(nz)
    grid = Grid(nx, ny, nz, float(nx), float(ny), zf, dtype=np_dt)
    cfg = Config(domain=DomainConfig(itot=nx, jtot=ny, ktot=nz,
                                     xlen=float(nx), ylen=float(ny)),
                 physics=PhysicsConfig(ltempeq=ltempeq),
                 dynamics=DynamicsConfig(iadv_thl=iadv_thl),
                 dtype=np.dtype(np_dt).name)
    masks = {}
    for k in GRIDS:
        m = (rng.uniform(size=(nx, ny, nz + (k == "w"))) > 0.3).astype(
            np.float32)
        m[2:7, 3:8, :5] = 0.0
        masks[k] = m
    masks["w"][:, :, 0] = 0.0
    z = np.zeros(0)
    none = SecData(np.zeros((0, 3), np.int64), z, z, np.zeros(0, np.int64),
                   z.astype(bool), z.astype(bool))
    one = np.ones(1)
    ibm = IBM(cfg, grid, masks, {k: none for k in GRIDS},
              np.array([[0.0, 0.0, 1.0]]), 0.01 * one, 0.001 * one,
              295.0 * one, one, device="cuda")
    t = lambda a: torch.tensor(a, dtype=grid.torch_dtype, device="cuda")
    face = (nx, ny, nz + 1)

    def fields():
        return Fields(u=t(rng.standard_normal(shape)),
                      v=t(rng.standard_normal(shape)),
                      w=t(rng.standard_normal(face)),
                      thl=t(290.0 + rng.standard_normal(shape)),
                      qt=t(np.zeros(shape)), e12=t(np.zeros(shape)),
                      sv=t(np.zeros((0,) + shape)))
    c, m = fields(), fields()
    return (ibm, c, m, t(1e-2 * rng.standard_normal(shape)),
            t(1e-2 * rng.standard_normal(shape)),
            t(1e-2 * rng.standard_normal(face)),
            t(1e-3 * rng.standard_normal(shape)) if ltempeq else None,
            t(290.25))


def same_bits(a, b):
    """Whether two tensors hold the same bits (a zero's sign included)."""
    bits = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.shape == b.shape and bool(
        (a.contiguous().view(bits) == b.contiguous().view(bits)).all())


def ibmnorm_phase(smi, n=62):
    """Phase 62: the ibmnorm kernel against its plain route
    ``IBM.ibmnorm_uvw_thl`` over the ragged shapes and a rank block, in
    both dtypes and the three variants, bit for bit; then its time with
    thl and the correction at 128^3, 256^3 and 512 x 512 x 128 float32 (as
    `vreman_phase`).  Any miss raises.  Returns dict(shapes, t128, t256,
    t512)."""
    from udales_tpu_torch.ops.fused_ibmnorm import fused_ibmnorm, least_bytes

    def check(shape, np_dt, name, stretch):
        ibm, *args = ibmnorm_inputs(shape, np_dt, *IBMNORM_VARIANTS[name],
                                    seed=1, stretch=stretch)
        got = fused_ibmnorm(*args, ibm)
        torch.cuda.synchronize()
        ref = ibm.ibmnorm_uvw_thl(*args)
        for key, a, b in zip(("du", "dv", "dw", "dthl", "m.u", "m.v", "m.w",
                              "m.thl"), got, ref):
            if b is None or a is b:
                continue
            if not same_bits(a, b):
                raise RuntimeError(
                    f"ibmnorm kernel differs from plain in {key} on {shape} "
                    f"{np.dtype(np_dt).name} {name}: max abs err "
                    f"{float((a - b).abs().max()):.3e}")

    shapes = RAGGED_SHAPES + [(64, 64, 128)]
    for shape in shapes:
        for np_dt in (np.float64, np.float32):
            for name in IBMNORM_VARIANTS:
                check(shape, np_dt, name, 1.04)
    for nx, nz in ((128, 128), (256, 256), (512, 128)):
        check((nx, nx, nz), np.float32, "thl + correction", 1.0)
    phase(n, f"ibmnorm kernel vs plain over {len(shapes)} shapes (stretched) "
             f"in float64 and float32, {len(IBMNORM_VARIANTS)} variants, "
             f"and 128^3, 256^3, 512 x 512 x 128 float32: bit for bit")
    times = []
    for nx, nz in ((128, 128), (256, 256), (512, 128)):
        ibm, *args = ibmnorm_inputs((nx, nx, nz), np.float32,
                                    *IBMNORM_VARIANTS["thl + correction"],
                                    seed=2)
        times.append(kernel_turns(
            lambda: fused_ibmnorm(*args, ibm),
            lambda: ibm.ibmnorm_uvw_thl(*args), ibm.grid,
            least_bytes(ibm.grid.shape, 4, True, True), smi,
            f"ibmnorm kernel {nx}x{nx}x{nz} float32 with thl and the "
            f"correction", "ibmnorm_uvw_thl", n))
        del ibm, args
        torch.cuda.empty_cache()
    return dict(shapes=len(shapes) + 3, t128=times[0], t256=times[1],
                t512=times[2])


def scalars_inputs(shape, np_dt, nsv, masked, seed, stretch=1.0):
    """(g, grid, Mc) on the card as the scalar-stack kernel takes them,
    from a numpy seed: a kappa-ghosted stack of `nsv` scalars with a flat
    patch, h=1 ghosted velocities with a tenth of their faces at rest, a
    positive ekh and, when `masked`, a ghosted {0, 1} c mask with a solid
    box, over a grid of non-unit x and y spacings."""
    from udales_tpu_torch.grid import Grid
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    zf = np.cumsum(stretch ** np.arange(nz)) - 0.5 * stretch ** np.arange(nz)
    grid = Grid(nx, ny, nz, 1.3 * nx, 0.7 * ny, zf, dtype=np_dt)
    t = lambda a: torch.tensor(a, dtype=grid.torch_dtype, device="cuda")
    cell = (nx + 2, ny + 2, nz + 2)

    def velocity(size):
        a = rng.standard_normal(size)
        a[rng.uniform(size=size) < 0.1] = 0.0
        return t(a)
    sv = 1.0 + rng.standard_normal((nsv, nx + 4, ny + 4, nz + 4))
    sv[:, 3:7, 2:6, 4:9] = 0.5
    g = SimpleNamespace(sv=t(sv), u=velocity(cell), v=velocity(cell),
                        w=velocity((nx + 2, ny + 2, nz + 1)),
                        ekh=t(0.1 + rng.uniform(size=cell)))
    Mc = None
    if masked:
        m = (rng.uniform(size=cell) > 0.3).astype(np.float64)
        m[2:7, 3:8, :5] = 0.0
        Mc = t(m)
    return g, grid, Mc


def scalars_phase(smi, n=63):
    """Phase 63: the scalar-stack kernel against its plain route
    ``fused_scalars.plain_scalars`` over the ragged shapes and a rank
    block, in both dtypes, with one and three scalars, with and without
    the c mask, bit for bit; then its time with three scalars and the mask
    at 128^3 and 512 x 512 x 128 float32 (as `ibmnorm_phase`).  Any miss
    raises.  Returns dict(shapes, t128, t512)."""
    from udales_tpu_torch.ops.fused_scalars import (fused_scalars,
                                                    least_bytes,
                                                    plain_scalars)

    def check(shape, np_dt, nsv, masked, stretch):
        g, grid, Mc = scalars_inputs(shape, np_dt, nsv, masked, seed=1,
                                     stretch=stretch)
        got = fused_scalars(g, grid, Mc)
        torch.cuda.synchronize()
        ref = plain_scalars(g, grid, Mc)
        if not same_bits(got, ref):
            raise RuntimeError(
                f"scalar-stack kernel differs from plain on {shape} "
                f"{np.dtype(np_dt).name} nsv {nsv} "
                f"{'masked' if masked else 'open'}: max abs err "
                f"{float((got - ref).abs().max()):.3e}")

    shapes = RAGGED_SHAPES + [(64, 64, 128)]
    for shape in shapes:
        for np_dt in (np.float64, np.float32):
            for nsv in (1, 3):
                for masked in (False, True):
                    check(shape, np_dt, nsv, masked, 1.04)
    sizes = ((128, 128, 128), (512, 512, 128))
    for size in sizes:
        check(size, np.float32, 3, True, 1.0)
    phase(n, f"scalar-stack kernel vs plain over {len(shapes)} shapes "
             f"(stretched) in float64 and float32, 1 and 3 scalars, with "
             f"and without the mask, and 128^3, 512 x 512 x 128 float32: "
             f"bit for bit")
    times = []
    for size in sizes:
        g, grid, Mc = scalars_inputs(size, np.float32, 3, True, seed=2)
        times.append(kernel_turns(
            lambda: fused_scalars(g, grid, Mc),
            lambda: plain_scalars(g, grid, Mc), grid,
            least_bytes(size, 4, 3, True), smi,
            f"scalar-stack kernel {'x'.join(map(str, size))} float32 with 3 "
            f"scalars and the mask", "plain_scalars", n))
        del g, grid, Mc
        torch.cuda.empty_cache()
    return dict(shapes=len(shapes) + len(sizes), t128=times[0],
                t512=times[1])


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


def recycle_model(n, device="cuda"):
    """The flat open-x case with the rescale-recycle inlet generator
    (iinletgen = 1): the configuration of tests/test_inletgen.py at n^3
    float32 with ``BCxm = 2`` (what a generator case's namelist carries, so
    that the Poisson solve is open in x like the boundary), with its start
    State (the inlet profiles plus noise)."""
    import dataclasses
    from udales_tpu_torch.config import (BC_PROFILE, BCConfig, Config,
                                         DomainConfig, DriverConfig,
                                         PhysicsConfig, RunConfig, const)
    from udales_tpu_torch.grid import Grid
    from udales_tpu_torch.ops.inletgen import InletGenParams, init_inletgen
    from udales_tpu_torch.ops.openbc import BC_RECYCLE, Inlet, init_xplanes
    from udales_tpu_torch.run import Model
    from udales_tpu_torch.state import (initial_state, profile_fields,
                                        randomize)
    cfg = Config(
        domain=DomainConfig(itot=n, jtot=n, ktot=n, xlen=float(n),
                            ylen=float(n)),
        run=RunConfig(ladaptive=False, dtmax=0.02, lrandomize=False),
        physics=PhysicsConfig(ltempeq=True, inletav=5.0),
        bc=BCConfig(BCxm=BC_PROFILE, BCxT=BC_PROFILE, Uinf=2.0, thls=288.0,
                    thl_top=290.0, z0=0.03, z0h=0.003),
        driver=DriverConfig(iinletgen=1, iplane=n - 8, di=n / 2, dti=n / 2),
        dtype="float32")
    grid = Grid.uniform(n, n, n, float(n), float(n), float(n),
                        dtype=np.float32)
    model = Model(cfg, grid, device=device)
    zf = grid.zf
    uprof = 2.0 * np.minimum(zf / (0.8 * zf[-1]), 1.0) ** 0.25
    thlprof = 288.0 + 2.0 * zf / zf[-1]
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=model.device)
    model.inlet = Inlet(
        mode=BC_RECYCLE, uprof=t(uprof), vprof=t(np.zeros(n)),
        thlprof=t(thlprof), qtprof=t(np.zeros(n)),
        e12prof=t(np.full(n, const.e12min)),
        svprof=torch.zeros((0, n), dtype=torch.float32, device=model.device),
        irecy=n - 8)
    model.igparams = InletGenParams(cfg, grid)
    f = profile_fields(grid, uprof, np.zeros(n), thlprof, np.zeros(n),
                       np.full(n, const.e12min), device=model.device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(5)
    f = randomize(f, gen, 0.05, n)
    f = dataclasses.replace(f, bx=init_xplanes(f, grid))
    st = initial_state(grid, f, dt0=0.02)
    return model, st.replace(ig=init_inletgen(cfg, grid, f, model.igparams))


def open_boundary_phases(smi, fused, div_bound, pm128):
    """Phases 18 to 24: the precursor-driven urban case, the rescale-recycle
    generator, record and replay, and the kernels on open-boundary ghosts.
    Any failed check raises."""
    import dataclasses
    from udales_tpu_torch import cases
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    from udales_tpu_torch.ops import fused_vreman as fv
    from udales_tpu_torch.ops.boundary import make_ghosts
    from udales_tpu_torch.io.driverfiles import read_driver_files
    from udales_tpu_torch.ops.openbc import (driver_window_planes,
                                             load_driver_inlet)
    from udales_tpu_torch.ops.thermo import thermodynamics
    from udales_tpu_torch.run import _velocity_ghosts, load_case
    from udales_tpu_torch.sim import DriverRecorder

    # 18. stage the driven cases
    t0 = time.perf_counter()
    d32 = cases.stage_urban_driven(32, CACHE)
    d128 = cases.stage_urban_driven(128, CACHE, dtdriver=0.1)
    sizes = {p.name: p.stat().st_size for p in sorted(d128.iterdir())
             if "driver_" in p.name}
    phase(18, f"staged driven urban 32^3 and 128^3 in "
              f"{time.perf_counter() - t0:.2f} s under {CACHE.name}/; driver "
              f"files of {d128.name} (bytes): {sizes}")

    # 19. CUDA against CPU over 5 driven steps
    states, start = {}, None
    for dev in ("cpu", "cuda"):
        model = load_case(d32, "900", dtype="float64", device=dev)
        if start is None:
            start = state_to_numpy(model.cold_start(seed=43))
        states[dev] = model.run(state_from_numpy(start, device=dev), 5)
    worst = parity(states, ("u", "v", "w", "thl", "pres", "dt"))
    for name in ("u", "v", "w", "thl", "e12"):
        a = getattr(states["cpu"].c.bx, name)
        b = getattr(states["cuda"].c.bx, name).cpu()
        worst = max(worst, float((b - a).abs().max()
                                 / a.abs().max().clamp(min=1e-30)))
    phase(19, f"driven urban 32^3 float64, 5 steps, CUDA vs CPU: max rel err "
              f"{worst:.3e} over u, v, w, thl, pres, dt and the outlet "
              f"planes (tolerance 1e-9)")
    if not worst <= 1e-9:
        raise RuntimeError("driven CUDA step disagrees with the CPU step")
    m32 = model                               # float64, on the card

    # 20. the driven main path at full size
    dm = load_case(d128, "900", dtype="float32")            # on the card
    stream = dm.driver_stream
    if stream is None or dm.inlet is None or dm.ibm is None:
        raise RuntimeError("load_case built no streaming driver inlet")
    st = dm.run(dm.cold_start(seed=43), 5)
    before = stream.refills
    driven, st = run_main_path(dm, st, warm=0, steps=50, smi=smi, fused=fused,
                               label="driven urban 128^3 float32")
    want = driver_window_planes(st.drv, st.timee)["u"]
    driven.update(refills=stream.refills - before,
                  inlet_err=float((st.c.u[0] - want).abs().max()),
                  timee=float(st.timee))
    # the host wait of ensure alone, and a refill alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        stream.ensure(st)
    driven["ensure_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    t0 = time.perf_counter()
    stream._window(stream.n0)
    torch.cuda.synchronize()
    driven["refill_ms"] = (time.perf_counter() - t0) * 1e3
    phase(20, f"driven urban 128^3 main path on {smi}: t = "
              f"{driven['timee']:.3f} s, {driven['refills']} window refills "
              f"in 50 steps (window of {stream.chunk} of {stream.nt} "
              f"records), inlet face within {driven['inlet_err']:.3e} of the "
              f"interpolated driver plane (tolerance 1e-5), interior max|div "
              f"u| {driven['max_div']:.3e} <= {div_bound:g}, top level "
              f"{driven['top_div']:.3e} <= 1e-2; ensure without a refill "
              f"{driven['ensure_ms']:.4f} ms, one refill "
              f"{driven['refill_ms']:.3f} ms (host clock)")
    if not (driven["refills"] >= 1 and driven["inlet_err"] <= 1e-5
            and driven["max_div"] <= div_bound and driven["top_div"] <= 1e-2):
        raise RuntimeError("the driven main path failed a check")

    # 21. no host synchronisation inside a driven or a recycle step
    rm, rst = recycle_model(128)
    rst = rm.step(rst)                              # warm-up
    st = stream.ensure(st)                          # outside the guard
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = dm.step(st)
        rst = rm.step(rst)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    phase(21, "one driven step and one rescale-recycle step under "
              "set_sync_debug_mode('error'): no host synchronisation")

    # 22. the rescale-recycle generator at full size
    recycle, rst = run_main_path(rm, rst, warm=2, steps=20, smi=smi,
                                 fused=fused,
                                 label="rescale-recycle 128^3 float32")
    ig = rst.ig
    slab = float(rst.c.u[0].mean())
    gen_mean = float(ig.u0.mean())
    uinl = float(ig.Uinl.mean())
    recycle.update(inlet_mean=slab, uinl_mean=uinl)
    phase(22, f"rescale-recycle 128^3: inlet slab mean of u {slab:.6f} m/s, "
              f"of the generated plane {gen_mean:.6f}, of the running inlet "
              f"profile Uinl {uinl:.6f} (the inner/outer rescaling moves the "
              f"plane off its slow running mean: relative tolerance 0.2); "
              f"utau at the inlet {float(ig.utaui):.5f} m/s; interior "
              f"max|div u| {recycle['max_div']:.3e} <= {div_bound:g}, top "
              f"level {recycle['top_div']:.3e}")
    if not (all(bool(torch.isfinite(getattr(ig, k)).all())
                for k in ("u0", "v0", "w0", "t0", "Urec", "Uinl"))
            and abs(slab - gen_mean) <= 1e-6 * abs(gen_mean)
            and abs(slab - uinl) <= 0.2 * abs(uinl)
            and recycle["max_div"] <= div_bound):
        raise RuntimeError("the rescale-recycle inlet left its profile")

    # 23. record a precursor, replay it
    pdir = cases.stage_precursor(64, CACHE)
    pre = load_case(pdir, cases.PRECURSOR_EXPNR, dtype="float32")
    rec = DriverRecorder(pre.cfg, pre.grid, pdir)
    pst = pre.cold_start(seed=43)
    for _ in range(30):
        pst = pre.step(pst)
        rec.maybe_record(pst)
    rec.save()
    # the recorder's driverdata.<exp>.h5 (which load_case replays in
    # preference to the ?driver_* files) read back on the card against the
    # series of the ?driver_* files, in float64
    djob = pre.cfg.run.iexpnr
    h5 = load_driver_inlet(pdir / f"driverdata.{djob:03d}.h5", torch.float64,
                           device="cuda")
    files = read_driver_files(pdir, djob, pre.grid.jtot, pre.grid.ktot,
                              ltempeq=pre.cfg.physics.ltempeq,
                              lmoist=pre.cfg.physics.lmoist)
    keys = [k for k in ("t", "u", "v", "w", "thl", "qt")
            if files.get(k) is not None]
    series_err = max(float(np.abs(getattr(h5, k).cpu().numpy() - files[k])
                           .max()) for k in keys)
    rp = load_case(pdir, cases.REPLAY_EXPNR, dtype="float32")
    pst = rp.cold_start(seed=44).replace(timee=torch.tensor(
        rec.times[0], dtype=torch.float32, device="cuda"))
    pst = rp.run(pst, 10)
    want = rp.inlet.planes(pst.timee, 64, 64)["u"]
    replay = dict(records=len(rec.times),
                  inlet_err=float((pst.c.u[0] - want).abs().max()),
                  max_div=max_divergence(rp, pst.c)[0],
                  timee=float(pst.timee))
    finite = all(bool(torch.isfinite(getattr(pst.c, k)).all())
                 for k in ("u", "v", "w", "thl"))
    replay["series_err"] = series_err
    phase(23, f"precursor 64^3: {replay['records']} planes recorded in 30 "
              f"steps and written as ?driver_* files and driverdata."
              f"{djob:03d}.h5; the h5 series read by load_driver_inlet "
              f"against the files' ({', '.join(keys)}): max abs difference "
              f"{series_err!r}; replay (load_case takes the h5 series) of "
              f"10 steps to "
              f"t = {replay['timee']:.3f} s: inlet face within "
              f"{replay['inlet_err']:.3e} of the interpolated recorded plane "
              f"(tolerance 1e-5), interior max|div u| {replay['max_div']:.3e}")
    if not (finite and replay["records"] >= 10 and rp.inlet.u.shape[0]
            == replay["records"] == h5.t.shape[0] == files["t"].shape[0]
            and series_err == 0.0 and replay["inlet_err"] <= 1e-5
            and replay["max_div"] <= div_bound):
        raise RuntimeError("record and replay failed a check")

    # 24. the kernels on open-boundary ghosts
    def open_ghosts(model, state):
        c, cfg, grid = state.c, model.cfg, model.grid
        openx = openy = None
        if model.inlet is not None:
            openx = {"inlet": model._inlet_planes(state, c, state.ig),
                     "bx": c.bx}
        masks = model.ibm.masks if model.ibm is not None else None
        th = thermodynamics(c, cfg, grid, masks)
        ekm, ekh, _ = fv.closure(
            _velocity_ghosts(c, cfg, grid, openx, openy), grid, cfg,
            dthvdz=th.dthvdz, thl=c.thl, thvs=cfg.bc.thls)
        return make_ghosts(c, ekm, ekh, cfg, grid, openx=openx, openy=openy)
    pm32 = dict(u=m32.ibm.pmask_u, v=m32.ibm.pmask_v, w=m32.ibm.pmask_w)
    ghosts128 = open_ghosts(dm, st)
    open_err = {
        "masked": check_kernel(fused, ghosts128, dm.grid, pm128,
                               1e-5, "masked, driven urban 128^3 ghosts, "
                               "float32", 24),
        "unmasked": check_kernel(fused, open_ghosts(rm, rst), rm.grid, None,
                                 1e-5, "rescale-recycle 128^3 ghosts, "
                                 "float32", 24)}
    check_kernel(fused, open_ghosts(m32, states["cuda"]), m32.grid, pm32,
                 1e-12, "masked, driven urban 32^3 ghosts, float64", 24)
    open_xy_ghost_check(fused)
    return dict(driven=driven, recycle=recycle, replay=replay,
                open_err=open_err, case128=d128, ghosts128=ghosts128)


def leaf_errors(got, ref, prefix=""):
    """{leaf: max|got - ref| / max|ref|} over the non-empty leaves of two
    state_to_numpy trees."""
    out = {}
    for k, r in ref.items():
        if isinstance(r, dict):
            out.update(leaf_errors(got[k], r, f"{prefix}{k}."))
        elif r.size:
            scale = max(float(np.abs(r).max()), 1e-30)
            out[f"{prefix}{k}"] = float(np.abs(got[k] - r).max()) / scale
    return out


def leaf_parity(states):
    """Worst max|cuda - cpu| / max|cpu| over every leaf of two States, and
    the number of leaves compared."""
    from udales_tpu_torch.convert import state_to_numpy
    errs = leaf_errors(state_to_numpy(states["cuda"]),
                       state_to_numpy(states["cpu"]))
    return max(errs.values()), len(errs)


def dispersion_phases(smi, fused, div_bound, urban):
    """Phases 25 to 30: the street-canyon dispersion case and its purifier /
    heat-pump and one-equation variants.  `urban` is phase 12's result, the
    urban path's time in this call.  Any failed check raises."""
    from udales_tpu_torch import cases
    from udales_tpu_torch.config import const
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    from udales_tpu_torch.physics import M_NO, M_NO2, chem_update
    from udales_tpu_torch.run import load_case

    variants = {"dispersion": {},
                "purifiers + heat pumps": dict(purifiers=True,
                                               heatpumps=True),
                "one-equation": dict(sgs="oneeqn")}
    # 25. stage
    t0 = time.perf_counter()
    d32 = {k: cases.stage_urban_dispersion(32, CACHE, **v)
           for k, v in variants.items()}
    d128 = {k: cases.stage_urban_dispersion(128, CACHE, **v)
            for k, v in variants.items()}
    nveg = sum(1 for _ in open(d128["dispersion"] / "veg.inp.900")) - 1
    phase(25, f"staged dispersion 32^3 and 128^3 (3 variants each) in "
              f"{time.perf_counter() - t0:.2f} s under {CACHE.name}/: "
              f"{', '.join(p.name for p in d128.values())}; {nveg} tree "
              f"cells at 128^3")

    # 26. CUDA against CPU, 5 steps, every leaf
    for name, case in d32.items():
        states, start = {}, None
        for dev in ("cpu", "cuda"):
            model = load_case(case, "900", dtype="float64", device=dev)
            if start is None:
                start = state_to_numpy(model.cold_start(seed=43))
            states[dev] = model.run(state_from_numpy(start, device=dev), 5)
        worst, nleaves = leaf_parity(states)
        phase(26, f"{name} 32^3 float64, 5 steps, CUDA vs CPU: max rel err "
                  f"{worst:.3e} over {nleaves} State leaves (tolerance 1e-9)")
        if not worst <= 1e-9:
            raise RuntimeError(f"{name}: CUDA step disagrees with the CPU")

    # 27. the dispersion main path at full size
    dm = load_case(d128["dispersion"], "900", dtype="float32")   # the card
    if (dm.scalsources is None or dm.vegetation is None
            or not dm.cfg.chem.lchem or dm.ibm is None):
        raise RuntimeError("load_case built no dispersion physics")
    disp, st = run_main_path(dm, dm.cold_start(seed=43), warm=5, steps=50,
                             smi=smi, fused=fused,
                             label="dispersion 128^3 float32")
    sv = st.c.sv
    sv_finite = bool(torch.isfinite(sv).all())
    # the null cycle alone on the full field: NO + NO2 (molar) is kept
    after = chem_update(sv, st.dt, dm.cfg, dm.ibm.masks.c)
    nox = lambda s: s[0].double() / M_NO + s[1].double() / M_NO2
    nox_err = float((nox(after) - nox(sv)).abs().max()
                    / nox(sv).abs().max().clamp(min=1e-30))
    moved = float((after[2] - sv[2]).abs().max())
    disp.update(sv_max=[float(sv[n].max()) for n in range(3)],
                o3_min=float(sv[2].min()), nox_err=nox_err,
                ratio_to_urban=disp["ms_per_step"] / urban["ms_per_step"])
    phase(27, f"dispersion 128^3 main path on {smi}: "
              f"{disp['ms_per_step']:.4f} ms/step against urban's "
              f"{urban['ms_per_step']:.4f} in this call (ratio "
              f"{disp['ratio_to_urban']:.3f}); max NO, NO2, O3 "
              f"{', '.join(f'{v:.4g}' for v in disp['sv_max'])}, min O3 "
              f"{disp['o3_min']:.4f}, scalars finite {sv_finite}; "
              f"chem_update alone: NO + NO2 molar sum kept to {nox_err:.3e} "
              f"(tolerance 1e-6), O3 moved by {moved:.3e}; max|div u| "
              f"{disp['max_div']:.3e} <= {div_bound:g}")
    if not (sv_finite and nox_err <= 1e-6 and moved > 0
            and disp["max_div"] <= div_bound):
        raise RuntimeError("the dispersion main path failed a check")

    # 28. purifiers and heat pumps
    pm = load_case(d128["purifiers + heat pumps"], "900", dtype="float32")
    if pm.purifiers is None or pm.heatpumps is None:
        raise RuntimeError("load_case built no purifiers or heat pumps")
    pu, pst = run_main_path(pm, pm.cold_start(seed=43), warm=2, steps=20,
                            smi=smi, fused=fused,
                            label="dispersion + purifiers + heat pumps "
                                  "128^3 float32")
    c = pst.c
    div = divergence_field(pm, c)
    keep = torch.ones_like(div, dtype=torch.bool)
    box_err = 0.0
    for p in pm.purifiers.purifs:
        _, _, vel, faces, _, axis = pm.purifiers.geometry(p)
        face = getattr(c, "uvw"[axis])[faces]
        box_err = max(box_err, float((face - vel).abs().max()) / abs(vel))
        keep[max(p.il - 1, 0):p.iu + 2, max(p.jl - 1, 0):p.ju + 2,
             max(p.kl - 1, 0):p.ku + 2] = False
    i, j, k = (torch.as_tensor(a, device="cuda")
               for a in pm.heatpumps.ijk.T)
    fan = float(c.w[i, j, k + 1].mean())
    pu.update(box_err=box_err, div_outside=float(div[keep].max()),
              fan_w=fan)
    phase(28, f"purifiers + heat pumps 128^3: {len(pm.purifiers.purifs)} "
              f"boxes hold Qpu/Apu to {box_err:.3e} (relative, tolerance "
              f"1e-6), max|div u| outside the boxes and their neighbours "
              f"{pu['div_outside']:.3e} <= {div_bound:g}, mean w above the "
              f"{len(pm.heatpumps.ijk)} heat pumps {fan:.4f} m/s (fan "
              f"{pm.heatpumps.w_exhaust:.4f})")
    if not (box_err <= 1e-6 and pu["div_outside"] <= div_bound
            and bool(torch.isfinite(c.sv).all())):
        raise RuntimeError("the purifier / heat-pump path failed a check")

    # 29. the one-equation closure
    om = load_case(d128["one-equation"], "900", dtype="float32")
    one, ost = run_main_path(om, om.cold_start(seed=43), warm=2, steps=20,
                             smi=smi, fused=fused,
                             label="dispersion one-equation 128^3 float32")
    e12 = ost.c.e12
    one.update(e12_min=float(e12.min()), e12_max=float(e12.max()))
    phase(29, f"one-equation 128^3: e12 within {one['e12_min']:.4g} .. "
              f"{one['e12_max']:.4g} (e12min {const.e12min:g}), max|div u| "
              f"{one['max_div']:.3e} <= {div_bound:g}")
    if not (bool(torch.isfinite(e12).all()) and one["e12_min"]
            >= const.e12min * (1 - 1e-6) and one["e12_max"] > const.e12min
            and one["max_div"] <= div_bound):
        raise RuntimeError("the one-equation path failed a check")

    # 30. no host synchronisation inside a step of any variant
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = dm.step(st)
        pst = pm.step(pst)
        ost = om.step(ost)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    phase(30, "one step of each dispersion variant under "
              "set_sync_debug_mode('error'): no host synchronisation")
    return dict(dispersion=disp, purifiers_heatpumps=pu, oneeqn=one)


# -- phases 31 to 35: the run-time driver ------------------------------------

def step_counts(times, o, eb, walls):
    """{family: the set of record counts it may write} over a run whose
    steps end at `times`, read from the monitor file's 7 digits (the
    cadence logic of sim.Simulation on the host; a step time that ties
    with a cadence, as a dt held at dtmax makes it, counts both ways): `o`
    the &OUTPUT, `eb` the &ENERGYBALANCE, `walls` the &WALLS settings."""
    eps = 2e-6 * np.maximum(1.0, np.abs(times))
    sign = (-1.0) ** np.arange(len(times))
    runs = [_step_counts(list(times + k * sign * eps), o, eb, walls)
            for k in (-1, 0, 1)]
    return {k: {r[k] for r in runs} for k in runs[0]}


def _step_counts(times, o, eb, walls):
    def every(cad):
        tnext, n = cad, 0
        for t in times:
            if t >= tnext:
                tnext, n = tnext + cad, n + 1
        return n

    def sampled():
        tns, tnw, n = o.tsample, o.tstatsdump, 0
        for t in times:
            if t < tns:
                continue
            tns += o.tsample
            if t >= tnw:
                tnw, n = tnw + o.tstatsdump, n + 1
        return n
    last, neb = 0.0, 0
    for t in times:
        if t >= last + eb.dtEB:
            last, neb = t, neb + 1
    tnf, nfac = walls.dtfac, 0
    for t in times:
        if t >= tnf:
            tnf, nfac = round(t + walls.dtfac), nfac + 1
    n = dict(fielddump=every(o.tfielddump), xydump=every(o.tsample),
             ydump=every(o.tsample), kslicedump=every(o.tsample),
             islicedump=every(o.tsample), jslicedump=every(o.tsample),
             facT=neb, facEB=neb, fac=nfac)
    n.update({k: sampled() for k in ("xytdump", "tdump", "ytdump",
                                      "tkedump", "mintdump", "treedump")})
    return n


def writer_tables(sim):
    """{file stem: variable names} of every writer a Simulation built (the
    port's own tables), coordinates and time included."""
    out = {}
    for w in sim._writers():
        if w is None:
            continue
        writers = w.writers.values() if hasattr(w, "writers") else \
            [getattr(w, "writer", w)]
        for nc in writers:
            stem = Path(nc.path).name.split(".")[0]
            out[stem] = set(nc.f.variables)
    return out


def check_outputs(outdir, tables, counts, label, n):
    """Every expected file is there, scipy reads it, it holds the writer's
    variables and the expected records, all finite.  Raises otherwise;
    returns {stem: records}."""
    from scipy.io import netcdf_file
    found = {}
    for stem, names in sorted(tables.items()):
        path = next(Path(outdir).glob(f"{stem}.*.nc"), None)
        if path is None:
            raise RuntimeError(f"{label}: no {stem} file in {outdir}")
        with netcdf_file(path, "r", mmap=False) as f:
            if set(f.variables) != names:
                raise RuntimeError(f"{label}: {path.name} holds "
                                   f"{sorted(f.variables)}, not {sorted(names)}")
            nrec = f.variables["time"].shape[0]
            bad = [k for k, v in f.variables.items()
                   if not np.isfinite(np.asarray(v[:])).all()]
        if bad:
            raise RuntimeError(f"{label}: non-finite {bad} in {path.name}")
        if stem in counts and nrec not in counts[stem]:
            raise RuntimeError(f"{label}: {path.name} has {nrec} records, "
                               f"the cadence gives {counts[stem]}")
        found[stem] = nrec
    phase(n, f"{label}: {len(found)} files read by scipy.io.netcdf_file, "
             f"the port's variable tables, records as the cadences give, "
             f"all finite: " + ", ".join(f"{k} {v}" for k, v in found.items()))
    return found


def output_namelist(**out):
    """&OUTPUT of every family at a 1.75 s sample and 5 s write cadence."""
    o = dict(lfielddump=True, fieldvars="u0,v0,w0,th,pr,tx,ty,tz,hf,mc",
             tfielddump=5.0, lxytdump=True, lxydump=True, lydump=True,
             ltdump=True, lytdump=True, ltkedump=True, lmintdump=True,
             lkslicedump=True, lislicedump=True, ljslicedump=True,
             kslice=5, islice=20, jslice=20, tsample=1.75, tstatsdump=5.0)
    o.update(out)
    return o


def run_cli(args, timeout):
    """`python -m udales_tpu_torch ARGS` (or this script's --resume mode
    when args start with it) in a subprocess; returns (rc, stdout, stderr,
    seconds)."""
    cmd = ([sys.executable, str(Path(__file__).resolve())] + args
           if args[0] == "--resume"
           else [sys.executable, "-m", "udales_tpu_torch"] + args)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                         capture_output=True, text=True, timeout=timeout)
    return res.returncode, res.stdout, res.stderr, time.perf_counter() - t0


def launches_of(stdout):
    """(steps, unmasked, masked) from the CLI's closing lines: the steps of
    its ``done:`` line, the launches of its trace summary's counters."""
    import re
    m = re.search(r"after (\d+) steps;", stdout)
    c = re.search(r"fused_diff_mom\.launches=(\d+) "
                  r"fused_diff_mom\.masked_launches=(\d+)", stdout)
    if m is None or c is None:
        raise RuntimeError(f"no closing line in the CLI's output:\n{stdout}")
    return (int(m.group(1)),) + tuple(int(x) for x in c.groups())


def flat_numpy(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_numpy(v, f"{prefix}{k}."))
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def resume_mode(argv):
    """``chip_smoke.py --resume <CLI arguments> <npz>``: the port's CLI
    (``sim.main``) in this process, then its final State saved as npz, so
    that a continued run can be held against an uninterrupted one."""
    from udales_tpu_torch.convert import state_to_numpy
    from udales_tpu_torch.sim import main as cli
    final = cli(argv[:-1])
    np.savez(argv[-1], **flat_numpy(state_to_numpy(final)))


def flat_h5(tree, prefix=""):
    """{path: array} of a `udales_tpu_torch.io.hdf5.read` tree, the
    attributes as 0-d arrays under ``<group>@<name>``."""
    out = {f"{prefix}@{k}": np.asarray(v) for k, v in tree.attrs.items()}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_h5(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def worst_leaf(got, ref):
    """max over the leaves of `ref` of max|got - ref| / max|ref| (every
    leaf of `ref` must be in `got`, with its shape)."""
    worst = 0.0
    for k, r in ref.items():
        if got[k].shape != r.shape:
            raise RuntimeError(f"{k}: shape {got[k].shape} against {r.shape}")
        scale = max(float(np.abs(r).max(initial=0.0)), 1e-30)
        worst = max(worst, float(np.abs(got[k].astype(np.float64) - r)
                                 .max(initial=0.0)) / scale)
    return worst


def continuation(case, dtype, tmp, nsteps, label, n, fused, fmt="fortran",
                 stats=False):
    """N steps through Simulation, a restart (`fmt` "fortran": the
    reference's Fortran restart files; "h5": the native checkpoint that
    Simulation writes), then a second process (``sim.main`` with
    lwarmstart) for N more, against 2N steps in one process.  With `stats`
    the case samples xytdump every step or two and never writes it,
    and both the second process and an uninterrupted Simulation write a
    checkpoint after step 2N: the two checkpoints (State, facet state and
    the statistics accumulators) are held against each other too.
    Returns a dict: the worst leaf difference relative to the leaf's max,
    max|u| difference over max|u|, the two runs' end times' difference
    relative to the uninterrupted one's, the checkpoints' worst leaf (with
    `stats`) and the kernel launches (unmasked, masked) of the two legs."""
    from udales_tpu_torch import cases
    from udales_tpu_torch.convert import state_to_numpy
    from udales_tpu_torch.io import hdf5
    from udales_tpu_torch.io.restart import write_state_fortran
    from udales_tpu_torch.run import load_case
    from udales_tpu_torch.sim import Simulation
    model = load_case(case, "900", dtype=dtype)              # on the card
    st0 = model.cold_start(seed=43)
    st, times = st0, []
    for _ in range(2 * nsteps):
        st = model.step(st)
        times.append(float(st.timee))
    full = flat_numpy(state_to_numpy(st))
    # a run that is to end after step k stops halfway from step k - 1
    stop = lambda k: 0.5 * (times[k - 2] + times[k - 1])
    if stats:
        # a sample every step or two.  The cadence is longer than any
        # step, which keeps the next sample time ahead of the simulated
        # time, so that the restart does not fast-forward it; and its
        # multiples keep clear of every step time by a thousandth of it: a
        # step that lands on one samples or not by the last bit of its
        # time, which the two runs need not share
        t = np.asarray(times)
        tsample = next((c for c in np.diff(t, prepend=0.0).max()
                        * np.linspace(1.1, 2.0, 10)
                        if np.abs(t / c - np.round(t / c)).min() > 1e-3),
                       None)
        if tsample is None:
            raise RuntimeError(f"{label}: no sample cadence clear of the "
                               f"step times {times}")
        tsample = float(tsample)
        case = cases.with_namelist(case, tmp / "stats", OUTPUT=dict(
            lxytdump=True, tsample=tsample, tstatsdump=1e9))
        model = load_case(case, "900", dtype=dtype)
    fused.launch_count = fused.masked_launch_count = 0
    sim = Simulation(model, tmp / "leg1", monitor=False)
    if fmt == "h5":
        sim.tnextrestart = stop(nsteps)
    first = sim.run(st0, runtime=stop(nsteps))
    leg1 = (fused.launch_count, fused.masked_launch_count)
    start = (f"initd{nsteps:08d}.900.h5" if fmt == "h5"
             else f"initd{nsteps:08d}_xxx_xxx.900")
    run = dict(lwarmstart=True, startfile=start)
    if stats:
        run["trestart"] = stop(2 * nsteps)
    resumed = cases.with_namelist(case, tmp / "resumed", RUN=run)
    if fmt == "h5":
        (resumed / start).write_bytes((tmp / "leg1" / start).read_bytes())
    else:
        write_state_fortran(resumed, first, "900", model.cfg, ntrun=nsteps)
    rc, out, err, secs = run_cli(
        ["--resume", str(resumed), "--dtype", dtype, "--outdir",
         str(tmp / "leg2"), "--runtime", repr(stop(2 * nsteps) - times[nsteps - 1]),
         str(tmp / "leg2.npz")], timeout=600)
    if rc != 0:
        raise RuntimeError(f"{label}: the resumed run failed:\n{err[-4000:]}")
    steps2, unmasked2, masked2 = launches_of(out)
    got = dict(np.load(tmp / "leg2.npz"))
    worst = worst_leaf(got, full)
    du = float(np.abs(got["c.u"] - full["c.u"]).max()
               / np.abs(full["c.u"]).max())
    res = dict(worst=worst, du=du, steps=(sim.ntrun, steps2),
               launches=(leg1[0] + unmasked2, leg1[1] + masked2),
               dt_rel=abs(float(got["timee"]) - float(full["timee"]))
               / float(full["timee"]), leaves=len(full),
               groups=sorted({k.split(".")[0] for k in full}))
    more = ""
    if stats:
        ref = Simulation(model, tmp / "full", monitor=False)
        ref.tnextrestart = stop(2 * nsteps)
        ref.run(st0, runtime=stop(2 * nsteps))
        ref_ck = flat_h5(hdf5.read(
            tmp / "full" / f"initd{2 * nsteps:08d}.900.h5"))
        got_ck = flat_h5(hdf5.read(
            tmp / "leg2" / f"initd{nsteps:08d}.900.h5"))
        acc = sorted(k for k in ref_ck if k.startswith("stats/"))
        if not any(k.startswith("stats/xytdump/") for k in acc):
            raise RuntimeError(f"{label}: no xytdump accumulators in the "
                               f"checkpoint")
        res.update(checkpoint_worst=worst_leaf(
            {k: v for k, v in got_ck.items() if k != "@ntrun"},
            {k: v for k, v in ref_ck.items() if k != "@ntrun"}),
            checkpoint_leaves=len(ref_ck) - 1, stats_leaves=len(acc))
        more = (f"; the checkpoints after step {2 * nsteps} of the second "
                f"process and of an uninterrupted Simulation: worst leaf "
                f"{res['checkpoint_worst']:.3e} over "
                f"{res['checkpoint_leaves']} leaves and attributes, "
                f"{len(acc)} of them statistics accumulators (xytdump "
                f"sampled every {tsample!r} s)")
    phase(n, f"{label}: {nsteps} steps, {fmt} restart, {nsteps} more "
             f"in a second process ({secs:.1f} s) against {2 * nsteps} in "
             f"one: t = {float(got['timee']):.4f} against "
             f"{float(full['timee']):.4f} s, worst leaf difference "
             f"{worst:.3e} of the leaf's max over {len(full)} leaves, "
             f"max|du| / max|u| {du:.3e}, end times apart by "
             f"{abs(float(got['timee']) - float(full['timee'])):.3e} s; "
             f"launches (unmasked, masked) {res['launches']} in "
             f"{sim.ntrun} + {steps2} steps{more}")
    if res["steps"] != (nsteps, nsteps):
        raise RuntimeError(f"{label}: legs of {res['steps']} steps")
    return res


def profile_call(fn, reps=10):
    """(host ms a call to a synchronize, launches of one call, device
    activities the profiler captured of it, their device ms) of `fn` on the
    card.  Launches are the host's CUDA runtime calls that put work on the
    card (kernel launches, graph launches, copies, fills), counted on the
    host's side of the trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in prof.events() if e.device_type == cuda]
    runtime = [e for e in prof.events() if e.device_type != cuda
               and e.name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy",
                                      "cudaMemset", "cudaGraphLaunch"))]
    return (ms, len(runtime), len(dev),
            sum(e.time_range.elapsed_us() for e in dev) / 1e3)


def checkpoint_costs(sim, model, st, ckdir, smi):
    """Phase 34's native checkpoint of `st` (urban-EB 128^3 float32 with
    the facet state): save_checkpoint and load_checkpoint onto the card
    alone, then `sim`'s _write_restart with the accumulators of every
    family, three of each, host seconds to a synchronize (the read finds
    the file just written, in the page cache).  Raises unless the State
    reads back exactly."""
    import statistics
    from udales_tpu_torch.convert import state_to_numpy
    from udales_tpu_torch.io.restart import load_checkpoint, save_checkpoint
    ckdir.mkdir()
    secs = {"write": [], "read": [], "_write_restart": []}
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(ckdir / f"ck{i}.h5", st)
        secs["write"].append(time.perf_counter() - t0)
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = load_checkpoint(ckdir / f"ck{i}.h5", model.grid,
                               model=model)
        torch.cuda.synchronize()
        secs["read"].append(time.perf_counter() - t0)
    sim.outdir = ckdir
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim._write_restart(st)
        secs["_write_restart"].append(time.perf_counter() - t0)
    nbytes = (ckdir / "ck0.h5").stat().st_size
    full_bytes = (ckdir / "initd00000000.900.h5").stat().st_size
    # what a checkpoint holds: not the lwritefac sums, which restart at
    # zero, nor the wall-stress diagnostics
    want = {k: v for k, v in flat_numpy(state_to_numpy(st)).items()
            if k.split(".")[0] in ("m", "c", "pres", "dt", "timee", "fac",
                                   "ig")}
    back_err = worst_leaf(flat_numpy(state_to_numpy(back)), want)
    ck_med = {k: statistics.median(v) for k, v in secs.items()}
    checkpoint = dict(bytes=nbytes, seconds=secs, median_s=ck_med,
                      write_MBps=nbytes / 1e6 / ck_med["write"],
                      read_MBps=nbytes / 1e6 / ck_med["read"],
                      write_restart_bytes=full_bytes, read_back_err=back_err)
    phase(34, f"the native checkpoint of the urban-EB 128^3 float32 State "
              f"on {smi}: {nbytes} bytes; save_checkpoint "
              f"{', '.join(repr(v) for v in secs['write'])} s (median "
              f"{checkpoint['write_MBps']!r} MB/s); load_checkpoint onto the "
              f"card {', '.join(repr(v) for v in secs['read'])} s (median "
              f"{checkpoint['read_MBps']!r} MB/s), every leaf read back "
              f"within {back_err!r}; Simulation._write_restart with the "
              f"accumulators of {len(sim._stats_writers())} families "
              f"({full_bytes} bytes) "
              f"{', '.join(repr(v) for v in secs['_write_restart'])} s, the "
              f"time one checkpoint adds to a run")
    if back_err != 0.0:
        raise RuntimeError("the checkpoint read back differs from the State")
    return checkpoint


def driver_phases(smi, fused, div_bound, eb128, urban, d32):
    """Phases 31 to 35: the user's path through ``python -m
    udales_tpu_torch`` with every writer, restart continuation, the
    dispersion and driven cases through Simulation, the driver's cost and
    the runmodes.  `eb128` is the staged urban-EB 128^3 case, `urban` the
    staged urban cases by size, `d32` the driven 32^3 case.  Any failed
    check raises."""
    import shutil
    import statistics
    import tempfile
    from udales_tpu_torch import cases
    from udales_tpu_torch.config import load_namoptions
    from udales_tpu_torch.io import hdf5
    from udales_tpu_torch.run import load_case
    from udales_tpu_torch.sim import Simulation

    tmp = Path(tempfile.mkdtemp(prefix="driver_", dir=CACHE))
    # 31. the user's path: stage, every writer, the CLI in a subprocess
    case = cases.with_namelist(
        eb128, tmp / "urban128eb_all", OUTPUT=output_namelist(tcheck=1e-3),
        WALLS=dict(lwritefac=True, dtfac=5.0),
        ENERGYBALANCE=dict(lwriteEBfiles=True),
        RUN=dict(runtime=14.0, trestart=7.0))
    out = tmp / "out31"
    rc, stdout, stderr, secs = run_cli(
        [str(case), "--outdir", str(out), "--runtime", "14"], timeout=900)
    if rc != 0:
        raise RuntimeError(f"the CLI failed (rc {rc}):\n{stderr[-4000:]}")
    steps, unmasked, masked = launches_of(stdout)
    mon = np.loadtxt(out / "monitor.900.txt", ndmin=2)
    divs = [float(line.split("max|div|=")[1].split()[0])
            for line in stdout.splitlines() if "max|div|=" in line]
    cfg = load_namoptions(case / "namoptions.900")
    # the variable tables of the same writers, built in this process
    ccase = cases.with_namelist(
        eb128, tmp / "cost", OUTPUT=output_namelist(),
        WALLS=dict(lwritefac=True, dtfac=5.0),
        ENERGYBALANCE=dict(lwriteEBfiles=True))
    cm = load_case(ccase, "900", dtype="float32")
    tsim = Simulation(cm, tmp / "tables", monitor=False)
    tables = writer_tables(tsim)
    tsim._close()
    counts = step_counts(mon[:, 0], cfg.output, cfg.eb, cfg.walls)
    phase(31, f"python -m udales_tpu_torch {case.name} --runtime 14 on "
              f"{smi}: rc 0 in {secs:.1f} s, {steps} steps, monitor lines "
              f"{len(mon)}, dt {mon[0, 1]:.4g} .. {mon[-1, 1]:.4g} s; kernel "
              f"launches unmasked {unmasked}, masked {masked} (= 3 x "
              f"{steps}); max|div u| after the last step {divs[-1]:.2e} <= "
              f"{div_bound:g}")
    compiled = "step compiled (cuda graph)" in stdout
    print(f"  the CLI's closing line says the compiled step ran: "
          f"{compiled}", flush=True)
    if not (len(mon) == steps and masked == 3 * steps and unmasked == 0
            and divs and divs[-1] <= div_bound and steps >= 20
            and compiled):
        raise RuntimeError("the CLI run failed a check")
    recs = check_outputs(out, tables, counts, "urban-EB 128^3 outputs", 31)
    if min(recs[k] for k in ("xytdump", "tdump", "fielddump")) < 2:
        raise RuntimeError("a family wrote fewer than two records")
    ckpts = sorted(out.glob("initd*.900.h5"))
    if not ckpts:
        raise RuntimeError("the CLI wrote no checkpoint (trestart 7 s over "
                           "14 s)")
    ck = hdf5.read(ckpts[-1])
    families = sorted(ck["stats"])
    print(f"  checkpoints written by the CLI (trestart 7 s): "
          f"{[p.name for p in ckpts]}, {ckpts[-1].stat().st_size} bytes; "
          f"the last read back at t = {float(ck.attrs['timee']):.4f} s with "
          f"groups {sorted(ck)} and the accumulators of {families}",
          flush=True)
    if not ({"m", "c", "pres", "fac", "stats"} <= set(ck) and len(families)
            == 5 and all(np.isfinite(v).all()
                         for v in flat_h5(ck).values())):
        raise RuntimeError("the CLI's checkpoint lacks a group or holds "
                           "non-finite values")
    cli = dict(steps=steps, masked=masked, seconds=secs,
               max_div=divs[-1], records=recs, compiled_step=compiled,
               checkpoints=[p.name for p in ckpts])

    # 32. restart continuation
    c32 = continuation(urban[32], "float64", tmp / "c32", 5,
                       "urban 32^3 float64", 32, fused)
    if not (c32["worst"] <= 1e-9 and c32["dt_rel"] <= 1e-9):
        raise RuntimeError("the continued 32^3 run left the uninterrupted")
    c128 = continuation(urban[128], "float32", tmp / "c128", 10,
                        "urban 128^3 float32", 32, fused)
    if not (c128["du"] <= 1e-4 and c128["dt_rel"] <= 1e-4):
        raise RuntimeError("the continued 128^3 run left the uninterrupted")
    h32 = continuation(urban[32], "float64", tmp / "h32", 5,
                       "urban 32^3 float64", 32, fused, fmt="h5")
    heb = continuation(cases.stage_urban_eb(32, CACHE, dtEB=0.5), "float64",
                       tmp / "heb32", 5, "urban-EB 32^3 float64", 32, fused,
                       fmt="h5", stats=True)
    for label, r in (("urban", h32), ("urban-EB", heb)):
        if not (r["worst"] <= 1e-9 and r["dt_rel"] <= 1e-9
                and r.get("checkpoint_worst", 0.0) <= 1e-9
                and r["launches"] == (0, 3 * sum(r["steps"]))):
            raise RuntimeError(f"{label} 32^3 continued from the .h5 "
                               f"checkpoint left the uninterrupted run")
    if "fac" not in heb["groups"]:
        raise RuntimeError("the urban-EB continuation held no facet state")
    restart = dict(worst_32_f64=c32["worst"], du_128_f32=c128["du"],
                   h5_urban_32_f64=h32, h5_urban_eb_32_f64=heb)

    # 33. dispersion 128^3 and driven 32^3 through Simulation
    d128 = cases.stage_urban_dispersion(128, CACHE)
    dcase = cases.with_namelist(d128, tmp / "disp", OUTPUT=dict(
        lfielddump=True, fieldvars="u0,w0,th,s1,s2,s3", tfielddump=5.0,
        ltreedump=True, ltdump=True, lytdump=True, tsample=1.75,
        tstatsdump=5.0))
    dm = load_case(dcase, "900", dtype="float32")
    dsim = Simulation(dm, tmp / "out33d", monitor=False)
    tables = writer_tables(dsim)
    fused.launch_count = fused.masked_launch_count = 0
    dst = dsim.run(dm.cold_start(seed=43), runtime=10.0)
    dl = (fused.launch_count, fused.masked_launch_count)
    mon = np.loadtxt(tmp / "out33d" / "monitor.900.txt", ndmin=2)
    if dl != (0, 3 * dsim.ntrun) or len(mon) != dsim.ntrun:
        raise RuntimeError(f"dispersion: launches {dl} in {dsim.ntrun} steps")
    check_outputs(tmp / "out33d", tables,
                  step_counts(mon[:, 0], dm.cfg.output, dm.cfg.eb,
                              dm.cfg.walls),
                  f"dispersion 128^3 through Simulation ({dsim.ntrun} steps, "
                  f"masked launches {dl[1]})", 33)
    vcase = cases.with_namelist(d32, tmp / "drv", OUTPUT=dict(
        lxytdump=True, ltkedump=True, tsample=0.1, tstatsdump=0.5))
    vm = load_case(vcase, "900", dtype="float32")
    vsim = Simulation(vm, tmp / "out33v", monitor=False)
    tables = writer_tables(vsim)
    fused.launch_count = fused.masked_launch_count = 0
    vsim.run(vm.cold_start(seed=43), runtime=1.2)
    vl = (fused.launch_count, fused.masked_launch_count)
    mon = np.loadtxt(tmp / "out33v" / "monitor.900.txt", ndmin=2)
    if vl != (0, 3 * vsim.ntrun):
        raise RuntimeError(f"driven: launches {vl} in {vsim.ntrun} steps")
    check_outputs(tmp / "out33v", tables,
                  step_counts(mon[:, 0], vm.cfg.output, vm.cfg.eb,
                              vm.cfg.walls),
                  f"driven urban 32^3 through Simulation ({vsim.ntrun} "
                  f"steps, masked launches {vl[1]})", 33)
    sims = dict(dispersion_steps=dsim.ntrun, dispersion_masked=dl[1],
                driven_steps=vsim.ntrun, driven_masked=vl[1])

    # 34. the driver's cost: Simulation.run with every writer against
    # Model.run, in turns, and each family's sample and write alone
    st = cm.run(cm.cold_start(seed=43), 3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = cm.step(st)                 # with the wall-stress diagnostics
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    phase(34, "one urban-EB step with the wall-stress diagnostics under "
              "set_sync_debug_mode('error'): no host synchronisation")
    timings = {"Model.run": [], "Model.run captured": [],
               "Simulation.run": []}
    for i, which in enumerate(["Model.run", "Model.run captured",
                               "Simulation.run", "Simulation.run",
                               "Model.run captured", "Model.run",
                               "Model.run", "Simulation.run",
                               "Model.run captured"]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        if which.startswith("Model.run"):
            st = cm.run(st, 20, graph=which.endswith("captured"))
            nst = 20
        else:
            sim = Simulation(cm, tmp / f"cost{i}", monitor=False)
            t0 = float(st.timee)
            st = sim.run(st, runtime=20 * float(st.dt) - 1e-3)
            nst = sim.ntrun
        end.record()
        torch.cuda.synchronize()
        timings[which].append(start.elapsed_time(end) / nst)
    med = {k: statistics.median(v) for k, v in timings.items()}
    phase(34, f"urban-EB 128^3 float32 on {smi}, ms/step (CUDA events, 3 "
              f"runs each of ~20 steps, in turns): Model.run "
              f"{', '.join(f'{v:.3f}' for v in timings['Model.run'])} "
              f"(median {med['Model.run']:.3f}); Model.run captured "
              f"{', '.join(f'{v:.3f}' for v in timings['Model.run captured'])}"
              f" (median {med['Model.run captured']:.3f}); Simulation.run "
              f"with every writer and the compiled step (samples every 1.75 "
              f"s, writes every 5 s) "
              f"{', '.join(f'{v:.3f}' for v in timings['Simulation.run'])} "
              f"(median {med['Simulation.run']:.3f}), ratio to the captured "
              f"Model.run "
              f"{med['Simulation.run'] / med['Model.run captured']:.3f}, to "
              f"the eager {med['Simulation.run'] / med['Model.run']:.3f}")
    sim = Simulation(cm, tmp / "cost_families", monitor=False)
    masks = cm.ibm.masks
    t = float(st.timee)
    fam = {}
    for name in ("xytdump", "tdump", "ytdump", "tkedump", "mintdump"):
        w = getattr(sim, name)
        fam[name] = (lambda w=w: w._acc(w.acc, st, masks),
                     lambda w=w: w.write(t))
    fam["xydump"] = (lambda: sim.xydump.profiles(st, masks),
                     lambda: sim.xydump.maybe_dump(st, t + 1e9, masks))
    fam["ydump"] = (lambda: sim.ydump.fields(st, masks),
                    lambda: sim.ydump.maybe_dump(st, t + 1e9, masks))
    fam["slicedump"] = (None, lambda: sim.slices.maybe_dump(st, t + 1e9))
    fam["fielddump"] = (None, lambda: sim.fielddump.dump(st, t=t))
    fam["facT + facEB"] = (None, lambda: sim._write_fac(st, t))
    fam["fac"] = (None, lambda: sim._write_facstats(st, t))
    cost = {}
    print(f"  one sample and one write of each family, urban-EB 128^3 "
          f"float32 on {smi} (host ms a call to a synchronize, 10 calls; "
          f"the host's CUDA launches and copies, the device activities and "
          f"their device ms of one call from the profiler; a write includes "
          f"its host copy and the NetCDF append):",
          flush=True)
    for name, (sample, write) in fam.items():
        row = {}
        for kind, fn in (("sample", sample), ("write", write)):
            if fn is None:
                continue
            # a write of a 3-D family appends hundreds of MB: time one
            ms, nl, nd, dms = profile_call(
                fn, reps=10 if kind == "sample" else 1)
            row[kind] = dict(host_ms=ms, launches=nl, device_activities=nd,
                             device_ms=dms)
            print(f"    {name:14s} {kind:6s} {ms:9.3f} ms  {nl:5d} launches  "
                  f"{nd:5d} device activities  {dms:8.4f} device ms",
                  flush=True)
        cost[name] = row
    checkpoint = checkpoint_costs(sim, cm, st, tmp / "checkpoints", smi)
    sim._close()
    shutil.rmtree(tmp / "cost_families")
    shutil.rmtree(tmp / "checkpoints")

    # 35. the runmodes through the CLI, three processes at once
    procs = {}
    for rm in (1003, 1004, 1005):
        rcase = cases.with_namelist(urban[32], tmp / f"rm{rm}",
                                    RUN=dict(runmode=rm))
        procs[rm] = subprocess.Popen(
            [sys.executable, "-m", "udales_tpu_torch", str(rcase),
             "--outdir", str(tmp / "rmout")],
            cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    codes = {}
    for rm, p in procs.items():
        so, se = p.communicate(timeout=300)
        codes[rm] = p.returncode
        if p.returncode != 0 or f"runmode {rm}" not in so:
            raise RuntimeError(f"runmode {rm}: rc {p.returncode}\n{so}\n"
                               f"{se[-2000:]}")
        print("  " + so.strip().replace("\n", "\n  "), flush=True)
    phase(35, f"runmodes 1003, 1004, 1005 through python -m udales_tpu_torch "
              f"on {urban[32].name}: exit codes {codes}")
    return dict(cli=cli, restart=restart, sims=sims,
                cost=dict(ms_per_step=timings, median=med, families=cost,
                          checkpoint=checkpoint))


def divergence_field(model, c):
    """|div u| per cell of the projected velocity (periodic x and y)."""
    grid = model.grid
    gu = torch.cat([c.u, c.u[:1]], dim=0)
    gv = torch.cat([c.v, c.v[:, :1]], dim=1)
    dzfi = grid.t("dzfi", c.u.device)
    return ((gu[1:] - gu[:-1]) * grid.dxi + (gv[:, 1:] - gv[:, :-1])
            * grid.dyi + (c.w[:, :, 1:] - c.w[:, :, :-1])
            * dzfi[None, None, :]).abs()


def open_xy_ghost_check(fused):
    """The unmasked kernel on ghosts assembled with both directions open
    (x planes first, y planes across the corners), float64 and float32, at a
    ragged size."""
    import dataclasses
    from udales_tpu_torch.config import (BC_PROFILE, BCConfig, Config,
                                         DomainConfig)
    from udales_tpu_torch.grid import Grid
    from udales_tpu_torch.ops.boundary import make_ghosts
    from udales_tpu_torch.ops.openbc import (Inlet, init_xplanes,
                                             init_yplanes)
    from udales_tpu_torch.state import Fields
    nx, ny, nz = 33, 17, 65
    rng = np.random.default_rng(24)
    for np_dt, dtype, rtol in ((np.float64, torch.float64, 1e-12),
                               (np.float32, torch.float32, 1e-5)):
        grid = Grid.uniform(nx, ny, nz, float(nx), float(ny), float(nz),
                            dtype=np_dt)
        cfg = Config(domain=DomainConfig(itot=nx, jtot=ny, ktot=nz,
                                         xlen=float(nx), ylen=float(ny)),
                     bc=BCConfig(BCxm=BC_PROFILE, BCym=BC_PROFILE),
                     dtype=np_dt.__name__)
        t = lambda a: torch.tensor(a, dtype=dtype, device="cuda")
        cell = lambda: t(rng.standard_normal((nx, ny, nz)))
        f = Fields(u=cell(), v=cell(),
                   w=t(rng.standard_normal((nx, ny, nz + 1))), thl=cell(),
                   qt=cell(), e12=cell(), sv=t(np.zeros((0, nx, ny, nz))))
        f = dataclasses.replace(f, bx=init_xplanes(f, grid),
                                by=init_yplanes(f, grid))
        prof = t(rng.standard_normal(nz))
        inlet = Inlet(mode=BC_PROFILE, uprof=prof, vprof=prof, thlprof=prof,
                      qtprof=prof, e12prof=prof, svprof=t(np.zeros((0, nz))))
        zero = torch.zeros((), dtype=dtype, device="cuda")
        g = make_ghosts(
            f, t(rng.uniform(0.5, 1.5, (nx, ny, nz))),
            t(rng.uniform(0.5, 1.5, (nx, ny, nz))), cfg, grid,
            openx={"inlet": inlet.planes(zero, ny, nz), "bx": f.bx},
            openy={"inlet": inlet.planes(zero, nx, nz), "by": f.by})
        check_kernel(fused, g, grid, None, rtol,
                     f"open x and y ghosts {grid.shape} {np_dt.__name__}", 24)


# --- the x/y process split (phases 36-39) ------------------------------------

# Ranks that share the one card: NCCL takes one rank per device (phase 37
# prints its answer), so these ranks run gloo and stage every exchange
# through pinned host memory, explicitly.  Nothing falls back to either.
SHARED_BACKEND = "gloo"
SHARED_STAGED = True
SPLIT_MESHES = [(2, 1), (1, 2), (2, 2)]
# phase 48: the Simulation's run time and the steps of its continuation
SIM48_RUNTIME, SIM48_MORE = 0.5, 3
# phase 48: the second moments <ab> - <a><b> of xytdump and the means (a, b)
# each is formed from; such a difference rounds as max|a| max|b| does,
# which can be far above its own size (thl'thl' of a thl near 300 K)
MOMENTS = {"upwpxyt": [("uxyt", "wxyt")], "wpthlpxyt": [("wxyt", "thlxyt")],
           "vpwpxyt": [("vxyt", "wxyt")], "upvpxyt": [("uxyt", "vxyt")],
           "wpqtpxyt": [("wxyt", "qtxyt")],
           "thlpthlptxy": [("thlxyt", "thlxyt")],
           "qtpqtptxy": [("qtxyt", "qtxyt")], "upuptxyc": [("uxyt", "uxyt")],
           "vpvptxyc": [("vxyt", "vxyt")], "wpwptxyc": [("wxyt", "wxyt")],
           "tketxyc": [("uxyt", "uxyt"), ("vxyt", "vxyt"), ("wxyt", "wxyt")]}


def record_scale(name, data):
    """What the array `name` of a writer's record `data` is held relative
    to: its largest value, or, for a second moment, the product of the
    largest values of the means it is formed from where that is larger."""
    peak = lambda k: float(np.abs(data[k]).max(initial=0.0))
    return max([peak(name)] + [peak(a) * peak(b)
                               for a, b in MOMENTS.get(name, ())])


_OPEN_X = dict(BCxm=2, BCxT=2, BCxq=2, BCxs=2)
_OPEN_Y = dict(BCym=2, BCyT=2, BCyq=2, BCys=2)
_FLAT_NAMELIST = """&RUN
iexpnr = 900
ladaptive = .true.
dtmax = 0.1
/
&DOMAIN
itot = {n}
jtot = {n}
ktot = {n}
xlen = {n}.
ylen = {n}.
/
&WALLS
{walls}
/
&PHYSICS
ltempeq = .true.
lbuoyancy = .true.
/
&BC
thls = 288.
z0 = 0.01
z0h = 0.001
/
"""


def record_errors(got, ref, label):
    """(worst error, its file:variable, files) of the writers' records
    `got` {file name: [(time, {variable: array})]} against `ref`, each
    variable of each record relative to `record_scale`; raises where the
    files, the record counts or the record times differ."""
    if sorted(got) != sorted(ref):
        raise RuntimeError(f"Simulation on {label} wrote {sorted(got)}, "
                           f"the single process {sorted(ref)}")
    worst, at = 0.0, None
    for fname, recs in ref.items():
        mine = got[fname]
        if len(mine) != len(recs):
            raise RuntimeError(f"{fname}: {len(mine)} records on {label}, "
                               f"{len(recs)} in one process")
        for (tg, dg), (tr, dr) in zip(mine, recs):
            if abs(tg - tr) > 1e-12 * max(abs(tr), 1.0):
                raise RuntimeError(f"{fname}: a record at t = {tg}, the "
                                   f"single process's at {tr}")
            for k, r in dr.items():
                scale = record_scale(k, dr)
                err = float(np.abs(dg[k] - r).max(initial=0.0))
                err = err / scale if scale > 0 else (0.0 if err == 0
                                                     else math.inf)
                if err >= worst:
                    worst, at = err, f"{fname}:{k}"
    return worst, at, len(ref)


def stage_open_family(n):
    """Phase 45's open family at n^3 under .bench_cache/open{n}/ (experiment
    900): "driven" (``cases.stage_urban_driven`` with records 0.05 s apart
    read 4 at a time, so that a few steps refill the window),
    "open_x_cube" (one box, generated by the port's preprocessor, behind
    an open-x profile inlet with a convective outlet), and on a flat floor
    "open_y", "open_xy", "recycle" (``iinletgen = 1``, ``BCxm = 2``, its
    recycle plane on the second x rank of 2 x 2), "bczp2" (``BCzp = 2``)
    and "fft3d" (``POISS_FFT3D``)."""
    import shutil
    from udales_tpu_torch import cases
    from udales_tpu_torch.prep.prep import (PrepConfig, make_box_stl,
                                            prepare_case)
    root = CACHE / f"open{n}"
    shutil.rmtree(root, ignore_errors=True)
    z = np.arange(n) + 0.5

    def inputs(d):
        rows = "\n".join(f"{zk:.4f} {288 + 0.05 * zk:.4f} 0.001 "
                         f"{1 + 0.05 * zk:.4f} 0.1 0.00005" for zk in z)
        (d / "prof.inp.900").write_text("# prof\n# z thl qt u v tke\n"
                                        + rows + "\n")
        (d / "lscale.inp.900").write_text(
            "# lscale\n# z ug vg pgx pgy wfls dqtdx dqtdy dqtdt dthlrad\n"
            + "\n".join(f"{zk:.4f} 0 0 0.0001 0 0 0 0 0 0" for zk in z)
            + "\n")
    flat = root / "flat"
    flat.mkdir(parents=True)
    (flat / "namoptions.900").write_text(_FLAT_NAMELIST.format(
        n=n, walls="lbottom = .true."))
    inputs(flat)
    out = {"driven": cases.stage_urban_driven(n, CACHE, nt=40, chunk=4,
                                              dtdriver=0.05)}
    cube = root / "cube_base"
    cube.mkdir()
    make_box_stl(cube / "geom.stl", n // 4, n // 2, n // 4, n // 2, n // 4,
                 float(n), float(n))
    counts = prepare_case(cube / "geom.stl", cube, PrepConfig(
        itot=n, jtot=n, ktot=n, xlen=float(n), ylen=float(n),
        zsize=float(n), expnr="900", u0=1.0, dpdx=1e-4,
        with_radiation=False))
    (cube / "namoptions.900").write_text(_FLAT_NAMELIST.format(
        n=n, walls="\n".join(
            [f"nfcts = {counts['nfcts']}", "iwalltemp = 2"]
            + [f"{k}_{w} = {counts[f'{k}_{w}']}" for k in (
                "nsolpts", "nbndpts", "nfctsecs") for w in "uvwc"])))
    out["open_x_cube"] = cases.with_namelist(cube, root / "open_x_cube",
                                             BC=_OPEN_X)
    variants = {
        "open_y": dict(BC=_OPEN_Y),
        "open_xy": dict(BC={**_OPEN_X, **_OPEN_Y}),
        "recycle": dict(BC=dict(thl_top=290.0, Uinf=2.0, **_OPEN_X),
                        DRIVER=dict(iinletgen=1, iplane=3 * n // 4),
                        INLET=dict(di=n / 2)),
        "bczp2": dict(BC=dict(BCzp=2)),
        "fft3d": dict(DYNAMICS=dict(ipoiss=2))}
    for name, groups in variants.items():
        out[name] = cases.with_namelist(flat, root / name, **groups)
    return out


def start_ranks(fn, nprocs, args):
    """`nprocs` processes of fn(rank, *args), spawn start method."""
    return torch.multiprocessing.start_processes(
        fn, args=args, nprocs=nprocs, join=False, start_method="spawn")


def wait_ranks(ctx, timeout):
    """Wait for the ranks of `start_ranks`; raises if one fails or they
    outlive `timeout` seconds, and leaves none running."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=2.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def nccl_shared_rank(rank, port, out):
    """One of two ranks that ask NCCL for a communicator on the same card;
    writes what NCCL answered."""
    import os
    from datetime import timedelta
    import torch.distributed as dist
    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=2,
                                timeout=timedelta(seconds=30))
        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        msg = f"accepted (all_reduce gave {float(t)})"
    except Exception as e:       # NCCL's answer is what this rank reports
        msg = f"refused: {type(e).__name__}: {e}"
    Path(out, f"nccl{rank}.txt").write_text(msg)
    os._exit(0)                  # no teardown of a communicator in error


def split_rank(rank, world, port, px, py, jobs, out):
    """One rank of phases 37/38, 41/42 and 45/46/48 on the shared card: the
    `world`-process group, the px x py mesh, and each job of `jobs` (the
    flat case of `entry._build`, or a case directory through
    ``load_case(..., mesh=)`` from the job's whole-domain "start" or from
    ``cold_start``; a job with "sim" runs ``Simulation`` instead,
    `split_simulation`); writes its results to out/rank<r>.pkl."""
    import pickle
    import torch.distributed as dist
    from udales_tpu_torch import entry
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    from udales_tpu_torch.ops.fused_diff import fused_diff_mom
    from udales_tpu_torch.ops.openbc import driver_window_planes
    from udales_tpu_torch.parallel.mesh import gather_state, make_mesh
    from udales_tpu_torch.parallel.multihost import (init_distributed,
                                                     shard_state_global)
    from udales_tpu_torch.run import load_case
    torch.cuda.set_device(0)
    init_distributed(f"localhost:{port}", world, rank, backend=SHARED_BACKEND,
                     device="cuda", timeout=60.0)
    mesh = make_mesh(px, py, host_staged=SHARED_STAGED)
    res = {}
    for job in jobs:
        if "sim" in job:
            res[job["name"]] = split_simulation(job, mesh)
            continue
        steps = job["steps"]
        if "case" in job:
            model = load_case(job["case"], job.get("expnr", "900"),
                              job["dtype"], mesh=mesh)
            st = (model.cold_start(seed=job["seed"]) if job["start"] is None
                  else shard_state_global(state_from_numpy(job["start"]),
                                          mesh, device="cuda"))
            if "t0" in job:
                # the window of t = 0, then a later time
                st = model.driver_stream.ensure(st).replace(
                    timee=torch.full_like(st.timee, job["t0"]))
        else:
            n = job["n"]
            model = entry._build(n, n, n, job["dtype"], mesh=mesh)  # card
            start = state_from_numpy(numpy_state(model.domain_grid,
                                                 job["seed"]))
            st = shard_state_global(start, mesh, device="cuda")
        st = model.run(st, job.get("warm", 0))
        torch.cuda.synchronize()
        dist.barrier()
        stream = model.driver_stream
        refills = stream.refills if stream is not None else 0
        fused_diff_mom.launch_count = fused_diff_mom.masked_launch_count = 0
        mesh.reset_counts()
        t0 = time.perf_counter()
        st = model.run(st, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r = dict(launches=fused_diff_mom.launch_count,
                 masked=fused_diff_mom.masked_launch_count,
                 ms_per_step=1e3 * wall / steps,
                 collectives=mesh.collectives / steps,
                 bytes=mesh.bytes / steps,
                 comm_share=mesh.comm_seconds / wall,
                 wait_share=mesh.wait_seconds / wall)
        whole = gather_state(st, mesh)
        if job.get("divergence"):
            r["max_div"], r["top_div"] = max_divergence(
                SimpleNamespace(grid=model.domain_grid), whole.c)
            r["finite"] = all(bool(torch.isfinite(getattr(whole.c, k)).all())
                              for k in ("u", "v", "w", "thl", "e12"))
        else:
            r["state"] = state_to_numpy(whole)
        if stream is not None:
            # the driver window: refilled within the timed steps, and the
            # gathered inlet face is its interpolated plane
            want = driver_window_planes(whole.drv, whole.timee)["u"]
            r["refills"] = stream.refills - refills
            r["inlet_err"] = float((whole.c.u[0] - want).abs().max())
        if job.get("sync_debug"):
            # a host wait outside the mesh's collectives raises here; the
            # window refill is the one host wait a step, outside the step
            if stream is not None:
                st = stream.ensure(st)
                torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                st = model.step(st)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            r["sync_debug"] = True
        res[job["name"]] = r
    Path(out, f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    dist.destroy_process_group()


def recording_writers(records):
    """Make every ``NCWriter.append`` of this process also keep the arrays
    it is handed, in float64 before the file's float32 cast, in
    `records` {file name: [(time, {variable: array})]}; returns the call
    that undoes it."""
    from udales_tpu_torch.io import netcdf
    append = netcdf.NCWriter.append

    def recording(self, time, data):
        records.setdefault(Path(self.path).name, []).append(
            (time, {k: np.array(v, np.float64) for k, v in data.items()}))
        return append(self, time, data)
    netcdf.NCWriter.append = recording
    return lambda: setattr(netcdf.NCWriter, "append", append)


def split_simulation(job, mesh):
    """Phase 48 on one rank: ``Simulation.run`` of a split Model from the
    job's whole-domain start for job["runtime"] s into job["sim"], every
    writer's arrays recorded on rank 0; rank 0 then writes the gathered
    State's Fortran restart files into job["restart"]."""
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    from udales_tpu_torch.io.restart import write_state_fortran
    from udales_tpu_torch.ops.fused_diff import fused_diff_mom
    from udales_tpu_torch.parallel.mesh import gather_state
    from udales_tpu_torch.parallel.multihost import shard_state_global
    from udales_tpu_torch.run import load_case
    from udales_tpu_torch.sim import Simulation
    records = {}
    if mesh.rank == 0:
        recording_writers(records)
    model = load_case(job["case"], "900", job["dtype"], mesh=mesh)
    st = shard_state_global(state_from_numpy(job["start"]), mesh,
                            device="cuda")
    sim = Simulation(model, job["sim"])
    fused_diff_mom.launch_count = fused_diff_mom.masked_launch_count = 0
    st = sim.run(st, runtime=job["runtime"])
    whole = gather_state(st, mesh)
    if mesh.rank == 0:
        Path(job["restart"]).mkdir(parents=True, exist_ok=True)
        write_state_fortran(job["restart"], whole, "900", model.cfg,
                            ntrun=sim.ntrun)
    return dict(state=state_to_numpy(whole), records=records,
                steps=sim.ntrun, gathers=sim.gathers,
                gather_ms=1e3 * sim.gather_seconds / max(sim.gathers, 1),
                masked=fused_diff_mom.masked_launch_count)


def split_phases(smi, fused, urban_cases):
    """Phases 36-48: the x/y split (parallel/mesh.py, parallel/multihost.py)
    of the flat path, of the urban paths and of the open boundaries on the
    one card.  `urban_cases` maps "urban", "urban-EB", "dispersion" to their
    32^3 case directories, "urban128" to the urban 128^3 one, "open" to the
    open family of phase 45 ({name: 32^3 case directory}, "driven" among
    them), "driven128" to the driven urban 128^3 case of phase 18 and
    "ghosts128" to the ghosts of its whole domain after phase 20."""
    import pickle
    import tempfile
    import torch.distributed as dist
    from udales_tpu_torch import entry
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    from udales_tpu_torch.grid import Grid
    from udales_tpu_torch.io.restart import warmstart_state
    from udales_tpu_torch.parallel.mesh import gather_state, make_mesh
    from udales_tpu_torch.parallel.multihost import (free_port,
                                                     init_distributed,
                                                     shard_state_global)
    from udales_tpu_torch.run import load_case
    from udales_tpu_torch.sim import Simulation
    out = {}
    # the single-process reference on the card: 32^3 float64, 5 steps
    ref_model = entry._build(32, 32, 32, "float64")
    start = numpy_state(ref_model.grid, seed=7)
    ref = state_to_numpy(ref_model.run(state_from_numpy(start,
                                                        device="cuda"), 5))
    # and of the urban cases at 32^3, from their cold starts
    urban_start, urban_ref = {}, {}
    for name in ("urban", "urban-EB", "dispersion"):
        model = load_case(urban_cases[name], "900", "float64")
        urban_start[name] = state_to_numpy(model.cold_start(seed=43))
        urban_ref[name] = state_to_numpy(model.run(state_from_numpy(
            urban_start[name], device="cuda"), 5))
    # and of the open family at 32^3 (a fresh Model for each run: a stream
    # keeps its last window)
    open_cases = urban_cases["open"]
    open_start, open_ref = {}, {}
    for name, case in open_cases.items():
        model = load_case(case, "900", "float64")
        open_start[name] = state_to_numpy(model.cold_start(seed=43))
        model = load_case(case, "900", "float64")
        open_ref[name] = state_to_numpy(model.run(state_from_numpy(
            open_start[name], device="cuda"), 5))
    # the single-process Simulation of phase 48 and its continuation
    sim_case = urban_cases["simulation"]
    sim_records = {}
    undo = recording_writers(sim_records)
    model = load_case(sim_case, "900", "float64")
    CACHE.mkdir(exist_ok=True)
    sim_tmp = Path(tempfile.mkdtemp(prefix="sim48_", dir=CACHE))
    sim = Simulation(model, sim_tmp / "one")
    sim_ref = state_to_numpy(sim.run(state_from_numpy(
        open_start["driven"], device="cuda"), runtime=SIM48_RUNTIME))
    undo()
    sim_steps = sim.ntrun
    model = load_case(sim_case, "900", "float64")
    sim_more = state_to_numpy(model.run(state_from_numpy(
        open_start["driven"], device="cuda"), sim_steps + SIM48_MORE))

    # 36. one rank, NCCL: the real NCCL calls on CUDA tensors (spectra too)
    init_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl",
                     device="cuda", timeout=60.0)
    try:
        mesh = make_mesh(1, 1)
        model = entry._build(32, 32, 32, "float64", mesh=mesh)
        st = shard_state_global(state_from_numpy(start), mesh, device="cuda")
        mesh.reset_counts()
        st = model.run(st, 5)
        torch.cuda.synchronize()
        ncoll = mesh.collectives
        errs = leaf_errors(state_to_numpy(gather_state(st, mesh)), ref)
        # 40. (printed below, in order) the urban case on the same group
        umodel = load_case(urban_cases["urban"], "900", "float64", mesh=mesh)
        ust = shard_state_global(state_from_numpy(urban_start["urban"]),
                                 mesh, device="cuda")
        fused.launch_count = fused.masked_launch_count = 0
        mesh.reset_counts()
        ust = umodel.run(ust, 5)
        torch.cuda.synchronize()
        u1x1 = dict(collectives=mesh.collectives,
                    masked=fused.masked_launch_count,
                    errs=leaf_errors(state_to_numpy(gather_state(ust, mesh)),
                                     urban_ref["urban"]))
        # 44. (printed below) the driven case on the same group
        dmodel = load_case(open_cases["driven"], "900", "float64", mesh=mesh)
        dst = shard_state_global(state_from_numpy(open_start["driven"]),
                                 mesh, device="cuda")
        fused.launch_count = fused.masked_launch_count = 0
        mesh.reset_counts()
        dst = dmodel.run(dst, 5)
        torch.cuda.synchronize()
        d1x1 = dict(collectives=mesh.collectives,
                    masked=fused.masked_launch_count,
                    refills=dmodel.driver_stream.refills,
                    errs=leaf_errors(state_to_numpy(gather_state(dst, mesh)),
                                     open_ref["driven"]))
        # and one more step under sync-debug mode on NCCL: a host wait
        # raises; the window refill, the one host wait a step, stays
        # outside the step
        dst = dmodel.driver_stream.ensure(dst)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            dst = dmodel.step(dst)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        d1x1["sync_debug"] = True
    finally:
        dist.destroy_process_group()
    worst = max(errs, key=errs.get)
    out["nccl_1x1"] = dict(max_rel_err=errs[worst], leaf=worst,
                           collectives=ncoll, leaves=len(errs))
    phase(36, f"mesh 1 x 1, backend nccl, host_staged False, 32^3 float64, 5 "
              f"steps: {ncoll} NCCL collectives; every one of {len(errs)} "
              f"leaves against Model.run without a mesh within "
              f"{errs[worst]:.3e} relative (worst {worst}; tolerance 1e-12)")
    if not errs[worst] <= 1e-12:
        raise RuntimeError("the 1 x 1 NCCL split disagrees with Model.run")

    CACHE.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="split_", dir=CACHE) as td:
        # 37. NCCL's answer to two ranks on one card, and the shared-card
        # meshes against the single-process card run: the probe and the
        # 2 x 1 and 1 x 2 groups run together, then the 2 x 2 group alone,
        # which also runs phase 38's path
        parity = dict(name="parity", n=32, dtype="float64", steps=5, seed=7)
        main_job = dict(name="main", n=128, dtype="float32", steps=10,
                        warm=2, seed=43, divergence=True, sync_debug=True)
        urban_jobs = [dict(name=name, case=str(urban_cases[name]),
                           dtype="float64", steps=5,
                           start=urban_start[name])
                      for name in ("urban", "urban-EB", "dispersion")]
        urban_main = dict(name="urban_main", case=str(urban_cases["urban128"]),
                          dtype="float32", steps=10, warm=2, seed=43,
                          start=None, divergence=True, sync_debug=True)
        open_jobs = [dict(name=f"open_{name}", case=str(case),
                          dtype="float64", steps=5, start=open_start[name])
                     for name, case in open_cases.items()]
        # the first window (records 0-15, 0.1 s apart) loaded at t = 0,
        # then on from t = 1.1 s: it is refilled at 1.4 s, within the
        # timed steps
        driven_main = dict(name="driven_main",
                           case=str(urban_cases["driven128"]),
                           dtype="float32", steps=10, warm=2, seed=43,
                           t0=1.1, start=None, divergence=True,
                           sync_debug=True)
        sim_job = dict(name="simulation", sim=str(sim_tmp / "split"),
                       case=str(sim_case), dtype="float64",
                       start=open_start["driven"], runtime=SIM48_RUNTIME,
                       restart=str(sim_tmp / "restart"))
        started = []

        def group(fn, nprocs, args):
            started.append(start_ranks(fn, nprocs, args))
            return started[-1]

        def split_group(px, py, jobs):
            d = Path(td, f"m{px}x{py}")
            d.mkdir()
            return group(split_rank, px * py,
                         (px * py, free_port(), px, py, jobs, str(d)))
        t0 = time.perf_counter()
        try:
            probe = group(nccl_shared_rank, 2, (free_port(), td))
            small = [split_group(2, 1, [parity]), split_group(1, 2, [parity])]
            try:
                wait_ranks(probe, 120)
            except Exception as e:   # a rank NCCL killed reports nothing
                print(f"  NCCL probe ranks ended: {type(e).__name__}: {e}",
                      flush=True)
            for ctx in small:
                wait_ranks(ctx, 300)
            wait_ranks(split_group(2, 2, [parity, main_job, *urban_jobs,
                                          urban_main, *open_jobs,
                                          driven_main, sim_job]), 900)
        finally:                     # no rank outlives a failed phase
            for ctx in started:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.kill()
                    proc.join()
        answers = [Path(td, f"nccl{r}.txt").read_text()
                   if Path(td, f"nccl{r}.txt").exists() else "(no answer)"
                   for r in (0, 1)]
        out["nccl_shared_card"] = answers
        phase(37, "two NCCL ranks on one card: " + " | ".join(
            a.replace("\n", " ")[:400] for a in answers))
        out["shared"] = {"seconds": time.perf_counter() - t0}
        for px, py in SPLIT_MESHES:
            ranks = [pickle.loads(Path(td, f"m{px}x{py}", f"rank{r}.pkl")
                                  .read_bytes()) for r in range(px * py)]
            errs = leaf_errors(ranks[0]["parity"]["state"], ref)
            worst = max(errs, key=errs.get)
            launches = [r["parity"]["launches"] for r in ranks]
            out["shared"][f"{px}x{py}"] = dict(max_rel_err=errs[worst],
                                               leaf=worst, launches=launches)
            phase(37, f"mesh {px} x {py} on one card, backend "
                      f"{SHARED_BACKEND}, host_staged {SHARED_STAGED}, 32^3 "
                      f"float64, 5 steps: the gathered State against the "
                      f"single-process card run within {errs[worst]:.3e} "
                      f"relative in every leaf (worst {worst}; tolerance "
                      f"1e-9); kernel launches per rank {launches}")
            if not errs[worst] <= 1e-9 or any(n != 15 for n in launches):
                raise RuntimeError(f"the {px} x {py} split disagrees with "
                                   f"the single-process run")
        main = [r["main"] for r in ranks]
        urban_split = {name: [r[name] for r in ranks]
                       for name in ("urban", "urban-EB", "dispersion",
                                    "urban_main", "driven_main",
                                    "simulation",
                                    *(f"open_{n}" for n in open_cases))}

    # 38. flat 128^3 float32 on 2 x 2 (the ranks of the 2 x 2 group above)
    out["main_2x2"] = main
    phase(38, f"flat 128^3 float32 on mesh 2 x 2, backend {SHARED_BACKEND}, "
              f"host_staged {SHARED_STAGED}, 10 steps: gathered max|div u| "
              f"{main[0]['max_div']:.3e} (bound 1e-5); kernel launches per "
              f"rank {[m['launches'] for m in main]} (= 3 x 10); one step "
              f"under set_sync_debug_mode('error'): no host wait outside the "
              f"collectives")
    print("  4 ranks on one H100, host-staged: not a speed of the split. "
          f"{smi}: ms/step per rank "
          f"{[round(m['ms_per_step'], 3) for m in main]}; collectives a step "
          f"{main[0]['collectives']:.1f}, {main[0]['bytes'] / 1e6:.3f} MB "
          f"sent a step per rank; share of the step in the staged "
          f"collectives (host copy, gloo, copy back) "
          f"{[round(m['comm_share'], 3) for m in main]}, waiting for the "
          f"card before them {[round(m['wait_share'], 3) for m in main]}",
          flush=True)
    if not (all(m["finite"] and m["sync_debug"] for m in main)
            and main[0]["max_div"] <= 1e-5
            and all(m["launches"] == 30 and m["masked"] == 0
                    for m in main)):
        raise RuntimeError("the 2 x 2 split of the flat 128^3 path failed "
                           "its checks")

    # 39. the kernel at the block shape of the 2 x 2 split of 128^3
    gb = Grid.uniform(64, 64, 128, 64.0, 64.0, 128.0, dtype=np.float32)
    out["block_err"] = check_kernel(
        fused, random_ghosts(gb, torch.float32, "cuda", seed=39), gb, None,
        1e-5, f"block {gb.shape} float32", 39)
    out["block"] = time_kernel(
        fused, random_ghosts(gb, torch.float32, "cuda", seed=40), gb, None,
        smi, f"block {gb.shape} float32", 39)

    # 40. the urban case on the 1 x 1 NCCL mesh (run with phase 36)
    worst = max(u1x1["errs"], key=u1x1["errs"].get)
    out["urban_nccl_1x1"] = dict(max_rel_err=u1x1["errs"][worst], leaf=worst,
                                 collectives=u1x1["collectives"],
                                 masked=u1x1["masked"],
                                 leaves=len(u1x1["errs"]))
    phase(40, f"urban 32^3 float64 on mesh 1 x 1, backend nccl, 5 steps "
              f"through load_case(..., mesh=): {u1x1['collectives']} NCCL "
              f"collectives, {u1x1['masked']} masked launches; every one of "
              f"{len(u1x1['errs'])} leaves against Model.run without a mesh "
              f"within {u1x1['errs'][worst]:.3e} relative (worst {worst}; "
              f"tolerance 1e-12)")
    if not (u1x1["errs"][worst] <= 1e-12 and u1x1["masked"] == 15):
        raise RuntimeError("the 1 x 1 NCCL urban split disagrees with "
                           "Model.run")

    # 41. urban, urban-EB and dispersion on the shared card's 2 x 2 mesh
    out["urban_shared_2x2"] = {}
    for name in ("urban", "urban-EB", "dispersion"):
        ranks = urban_split[name]
        errs = leaf_errors(ranks[0]["state"], urban_ref[name])
        worst = max(errs, key=errs.get)
        masked = [r["masked"] for r in ranks]
        need = {"c.u", "pres", "fac.T"} if name == "urban-EB" else (
            {"c.u", "pres", "c.sv", "m.sv"} if name == "dispersion"
            else {"c.u", "pres"})
        out["urban_shared_2x2"][name] = dict(max_rel_err=errs[worst],
                                             leaf=worst, masked=masked,
                                             leaves=len(errs))
        phase(41, f"{name} 32^3 float64 on mesh 2 x 2 on one card, backend "
                  f"{SHARED_BACKEND}, host_staged {SHARED_STAGED}, 5 steps: "
                  f"every one of {len(errs)} leaves of the gathered State "
                  f"against the single-process card run within "
                  f"{errs[worst]:.3e} relative (worst {worst}; tolerance "
                  f"1e-9); masked launches per rank {masked}")
        if not (errs[worst] <= 1e-9 and need <= set(errs)
                and all(m == 15 for m in masked)):
            raise RuntimeError(f"the 2 x 2 split of {name} 32^3 disagrees "
                               f"with the single-process run")

    # 42. urban 128^3 float32 on 2 x 2 (the 2 x 2 group above)
    um = urban_split["urban_main"]
    out["urban_main_2x2"] = um
    phase(42, f"urban 128^3 float32 on mesh 2 x 2, backend {SHARED_BACKEND}, "
              f"host_staged {SHARED_STAGED}, 10 steps: gathered max|div u| "
              f"{um[0]['max_div']:.3e} (bound 1e-5); masked launches per "
              f"rank {[m['masked'] for m in um]} (= 3 x 10); one step under "
              f"set_sync_debug_mode('error'): no host wait outside the "
              f"collectives")
    print("  4 ranks on one H100, host-staged: not a speed of the split. "
          f"{smi}: ms/step per rank "
          f"{[round(m['ms_per_step'], 3) for m in um]}; collectives a step "
          f"{um[0]['collectives']:.1f}, {um[0]['bytes'] / 1e6:.3f} MB sent "
          f"a step per rank; share of the step in the staged collectives "
          f"{[round(m['comm_share'], 3) for m in um]}, waiting for the card "
          f"before them {[round(m['wait_share'], 3) for m in um]}",
          flush=True)
    if not (all(m["finite"] and m["sync_debug"] for m in um)
            and um[0]["max_div"] <= 1e-5
            and all(m["masked"] == 30 and m["launches"] == 0 for m in um)):
        raise RuntimeError("the 2 x 2 split of the urban 128^3 path failed "
                           "its checks")

    # 43. the masked kernel at the block shape, with a block's pmasks
    from udales_tpu_torch.config import load_namoptions
    from udales_tpu_torch.ibm.ibm import IBM
    case = urban_cases["urban128"]
    cfg = load_namoptions(case / "namoptions.900", dtype="float32")
    d = cfg.domain
    grid = Grid.from_prof_inp(case / "prof.inp.900", d.itot, d.jtot, d.ktot,
                              d.xlen, d.ylen, dtype=np.float32)
    block = SimpleNamespace(px=2, py=2, cx=1, cy=1)
    ibm = IBM.load(case, "900", cfg, grid, device="cuda", mesh=block)
    gb = ibm.grid
    pm = dict(u=ibm.pmask_u, v=ibm.pmask_v, w=ibm.pmask_w)
    solid = int((ibm.masks.c < 0.5).sum())
    out["masked_block_err"] = check_kernel(
        fused, random_ghosts(gb, torch.float32, "cuda", seed=43), gb, pm,
        1e-5, f"masked, block {gb.shape} (1, 1) of urban 128^3 on 2 x 2, "
              f"{solid} solid cells, float32", 43)
    out["masked_block"] = time_kernel(
        fused, random_ghosts(gb, torch.float32, "cuda", seed=44), gb, pm,
        smi, f"masked, block {gb.shape} float32", 43)

    # 44. the driven case on the 1 x 1 NCCL mesh (run with phase 36)
    worst = max(d1x1["errs"], key=d1x1["errs"].get)
    out["open_nccl_1x1"] = dict(max_rel_err=d1x1["errs"][worst], leaf=worst,
                                collectives=d1x1["collectives"],
                                masked=d1x1["masked"],
                                refills=d1x1["refills"],
                                leaves=len(d1x1["errs"]),
                                sync_debug=d1x1["sync_debug"])
    phase(44, f"driven urban 32^3 float64 on mesh 1 x 1, backend nccl, 5 "
              f"steps through load_case(..., mesh=): {d1x1['collectives']} "
              f"NCCL collectives, {d1x1['masked']} masked launches, "
              f"{d1x1['refills']} window loads; every one of "
              f"{len(d1x1['errs'])} leaves against Model.run without a mesh "
              f"within {d1x1['errs'][worst]:.3e} relative (worst {worst}; "
              f"tolerance 1e-12); one more step under "
              f"set_sync_debug_mode('error') with the refill outside it: no "
              f"host wait")
    if not (d1x1["errs"][worst] <= 1e-12 and d1x1["masked"] == 15
            and {"c.bx.u", "drv.u"} <= set(d1x1["errs"])):
        raise RuntimeError("the 1 x 1 NCCL driven split disagrees with "
                           "Model.run")

    # 45. the open family on the shared card's 2 x 2 mesh
    out["open_shared_2x2"] = {}
    need = {"driven": {"c.bx.u", "m.bx.thl", "drv.u"},
            "open_x_cube": {"c.bx.u"}, "open_y": {"c.by.v"},
            "open_xy": {"c.bx.u", "c.by.v"},
            "recycle": {"ig.u0", "ig.Utav", "ig.Urec", "c.bx.u"},
            "bczp2": {"pres"}, "fft3d": {"pres"}}
    for name in open_cases:
        ranks = urban_split[f"open_{name}"]
        errs = leaf_errors(ranks[0]["state"], open_ref[name])
        worst = max(errs, key=errs.get)
        launches = [r["masked"] + r["launches"] for r in ranks]
        out["open_shared_2x2"][name] = dict(max_rel_err=errs[worst],
                                            leaf=worst, launches=launches,
                                            leaves=len(errs))
        phase(45, f"{name} 32^3 float64 on mesh 2 x 2 on one card, backend "
                  f"{SHARED_BACKEND}, host_staged {SHARED_STAGED}, 5 steps: "
                  f"every one of {len(errs)} leaves of the gathered State "
                  f"against the single-process card run within "
                  f"{errs[worst]:.3e} relative (worst {worst}; tolerance "
                  f"1e-9); kernel launches per rank {launches}")
        if not (errs[worst] <= 1e-9 and need[name] <= set(errs)
                and all(n == 15 for n in launches)):
            raise RuntimeError(f"the 2 x 2 split of {name} 32^3 disagrees "
                               f"with the single-process run")
    # the first window load and at least one refill
    if not urban_split["open_driven"][0]["refills"] >= 2:
        raise RuntimeError("the driven 32^3 window was not refilled on 2 x 2")

    # 46. driven urban 128^3 float32 on 2 x 2 (the 2 x 2 group above)
    dm = urban_split["driven_main"]
    out["driven_main_2x2"] = dm
    phase(46, f"driven urban 128^3 float32 on mesh 2 x 2, backend "
              f"{SHARED_BACKEND}, host_staged {SHARED_STAGED}, 10 steps: "
              f"gathered inlet face within {dm[0]['inlet_err']:.3e} of the "
              f"interpolated driver plane (tolerance 1e-5), interior "
              f"max|div u| {dm[0]['max_div']:.3e} (bound 1e-5), top level "
              f"{dm[0]['top_div']:.3e} (bound 1e-2), window refills "
              f"{[m['refills'] for m in dm]}; masked launches per rank "
              f"{[m['masked'] for m in dm]} (= 3 x 10); one step under "
              f"set_sync_debug_mode('error') with the refill outside it: no "
              f"host wait outside the collectives")
    print("  4 ranks on one H100, host-staged: not a speed of the split. "
          f"{smi}: ms/step per rank "
          f"{[round(m['ms_per_step'], 3) for m in dm]}; collectives a step "
          f"{dm[0]['collectives']:.1f}, {dm[0]['bytes'] / 1e6:.3f} MB sent "
          f"a step per rank; share of the step in the staged collectives "
          f"{[round(m['comm_share'], 3) for m in dm]}, waiting for the card "
          f"before them {[round(m['wait_share'], 3) for m in dm]}",
          flush=True)
    if not (all(m["finite"] and m["sync_debug"] and m["refills"] >= 1
                and m["masked"] == 30 and m["launches"] == 0 for m in dm)
            and dm[0]["inlet_err"] <= 1e-5 and dm[0]["max_div"] <= 1e-5
            and dm[0]["top_div"] <= 1e-2):
        raise RuntimeError("the 2 x 2 split of the driven 128^3 path failed "
                           "its checks")

    # 47. the masked kernel on the cx == 0 block of driven urban 128^3: its
    # pmasks and its ghosts, the inlet planes on the domain's open x edge
    case = urban_cases["driven128"]
    cfg = load_namoptions(case / "namoptions.900", dtype="float32")
    d = cfg.domain
    grid = Grid.from_prof_inp(case / "prof.inp.900", d.itot, d.jtot, d.ktot,
                              d.xlen, d.ylen, dtype=np.float32)
    block = SimpleNamespace(px=2, py=2, cx=0, cy=0)
    ibm = IBM.load(case, "900", cfg, grid, device="cuda", mesh=block)
    gb = ibm.grid
    pm = dict(u=ibm.pmask_u, v=ibm.pmask_v, w=ibm.pmask_w)
    g = urban_cases["ghosts128"]
    gblock = SimpleNamespace(**{k: gb.cut(getattr(g, k), ring=1).contiguous()
                                for k in ("u", "v", "w", "ekm")})
    out["open_block_err"] = check_kernel(
        fused, gblock, gb, pm, 1e-5, f"masked, block {gb.shape} (0, 0) of "
        f"driven urban 128^3 on 2 x 2 with its inlet ghosts, float32", 47)
    out["open_block"] = time_kernel(
        fused, gblock, gb, pm, smi, f"masked, open block {gb.shape} float32",
        47)

    # 48. Simulation on the split Model against the single process, and
    # its restart continued in one process
    # (each variable of each record to 1e-9 of its largest value, a
    # second moment of the means it is formed from: `record_scale`)
    sim_ranks = urban_split["simulation"]
    got = sim_ranks[0]
    rec_worst, rec_at, files = record_errors(got["records"], sim_records,
                                             "2 x 2")
    errs = leaf_errors(got["state"], sim_ref)
    worst = max(errs, key=errs.get)
    model = load_case(sim_case, "900", "float64")
    st = warmstart_state(sim_tmp / "restart",
                         f"initd{got['steps']:08d}_xxx_xxx.900", "900",
                         model.cfg, model.grid, device="cuda", model=model)
    more = state_to_numpy(model.run(st, SIM48_MORE))
    cont = leaf_errors(more, sim_more)
    cont = {k: v for k, v in cont.items() if not k.startswith("drv.")}
    cworst = max(cont, key=cont.get)
    out["simulation_2x2"] = dict(
        steps=got["steps"], files=files, max_err_records=rec_worst,
        record=rec_at,
        max_rel_err_state=errs[worst], leaf=worst,
        max_rel_err_continued=cont[cworst],
        gathers=[r["gathers"] for r in sim_ranks],
        gather_ms_per_sample=[r["gather_ms"] for r in sim_ranks],
        masked=[r["masked"] for r in sim_ranks])
    phase(48, f"Simulation of driven urban 32^3 float64 on mesh 2 x 2 "
              f"({got['steps']} steps, field dumps, xytdump, tkedump, "
              f"monitor): {files} files, every array handed to a writer "
              f"within {rec_worst:.3e} of its largest value (a second "
              f"moment: of the means it is formed from) of the "
              f"single-process Simulation's (worst {rec_at}; tolerance "
              f"1e-9), final State within {errs[worst]:.3e} "
              f"(worst {worst}); its Fortran restart (outlet planes in the "
              f"halo) continued {SIM48_MORE} steps in one process within "
              f"{cont[cworst]:.3e} of the uninterrupted run (worst {cworst}; "
              f"tolerance 1e-9); gathers per rank "
              f"{out['simulation_2x2']['gathers']}, host ms a gather "
              f"{[round(r['gather_ms'], 3) for r in sim_ranks]}; masked "
              f"launches per rank {out['simulation_2x2']['masked']}")
    if not (files >= 3 and rec_worst <= 1e-9 and errs[worst] <= 1e-9
            and cont[cworst] <= 1e-9 and got["steps"] == sim_steps
            and all(r["masked"] == 3 * got["steps"] for r in sim_ranks)):
        raise RuntimeError("Simulation on the split Model disagrees with "
                           "the single process")
    # phase 57's reference: the single-process Simulation (not printed)
    out["_sim48"] = dict(case=sim_case, start=open_start["driven"],
                         records=sim_records, state=sim_ref, steps=sim_steps)
    return out


# --- the long-horizon validation (phases 49-51) ------------------------------

def numpy_f64(tree):
    """A state_to_numpy tree with every array in float64."""
    return {k: numpy_f64(v) if isinstance(v, dict)
            else None if v is None else np.asarray(v, np.float64)
            for k, v in tree.items()}


def validation_phases(smi, fused, recycle32):
    """Phases 49 to 51: validate_abl_torch.py at 32^3 float32 (one process,
    then chained over two), the kernel at its 64^3 shape, and the Fortran
    warm start of the rescale-recycle case `recycle32` (phase 45's)."""
    import shutil
    import validate_abl_torch as vat
    from udales_tpu_torch.cases import with_namelist
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    from udales_tpu_torch.grid import Grid
    from udales_tpu_torch.io.restart import (warmstart_state,
                                             write_state_fortran)
    from udales_tpu_torch.ops.inletgen import INLETGEN_NAMES, init_inletgen
    from udales_tpu_torch.run import load_case
    out = {}
    n, chunks, chunk = 32, 4, 100
    argv = [str(n), "200", str(chunk)]

    # 49. the validation's path in this process
    fused.launch_count = fused.masked_launch_count = 0
    whole = vat.run(vat.parse(argv + ["--stop-after", str(chunks)]))
    launches = (fused.launch_count, fused.masked_launch_count)
    steps = chunks * chunk
    if launches != (3 * steps, 0):
        raise RuntimeError(f"validation 32^3: launches (unmasked, masked) "
                           f"{launches} in {steps} steps")
    rec = whole["records"]
    if not all(np.isfinite(np.asarray(rec[k])).all()
               for k in ("prof", "tau") + vat.SCALARS):
        raise RuntimeError("validation 32^3: non-finite records")
    tau = vat.stress_profile(whole["model"], whole["state"]).cpu().double()
    ref = vat.stress_profile(
        vat.build_case(n, "cpu", "float64"),
        state_from_numpy(numpy_f64(state_to_numpy(whole["state"]))))
    tau_err = float((tau - ref).abs().max() / ref.abs().max())
    ms = 1e3 * whole["wall"] / steps
    out["validation"] = dict(
        n=n, chunks=chunks, chunk=chunk, steps=steps, launches=launches[0],
        wall_s=whole["wall"], ms_per_step=ms,
        points_per_s=n ** 3 / (ms * 1e-3), stress_rel_err=tau_err,
        tke=[float(x) for x in rec["tke"]], time=float(rec["time"][-1]),
        dt=float(rec["dt"][-1]), umax=float(rec["umax"][-1]))
    phase(49, f"validate_abl_torch {n}^3 float32 on {smi}: {chunks} chunks "
              f"of {chunk} steps, {ms:.3f} ms/step "
              f"({out['validation']['points_per_s']:.6g} points/s), t = "
              f"{out['validation']['time']:.1f} s, dt "
              f"{out['validation']['dt']:.4f}, TKE "
              f"{rec['tke'][0]:.3e} .. {rec['tke'][-1]:.3e}, max|u| "
              f"{out['validation']['umax']:.4f}; unmasked launches "
              f"{launches[0]} (= 3 x {steps}); stress profile on the card "
              f"against the CPU in float64: {tau_err:.3e} of max|tau| "
              f"{float(ref.abs().max()):.4g} (tolerance 1e-5)")
    if not tau_err <= 1e-5:
        raise RuntimeError("the stress profile on the card disagrees with "
                           "the CPU's")
    g64 = Grid.uniform(64, 64, 64, 64.0, 64.0, 64.0, dtype=np.float32)
    out["err64"] = check_kernel(
        fused, random_ghosts(g64, torch.float32, "cuda", seed=8), g64, None,
        1e-5, "uniform (64, 64, 64) float32, the validation's shape", 49)
    out["t64"] = time_kernel(
        fused, random_ghosts(g64, torch.float32, "cuda", seed=9), g64, None,
        smi, "64^3 float32", 49)

    # 50. chained: 2 chunks here, 2 more in a second process
    root = CACHE / "validation32"
    shutil.rmtree(root, ignore_errors=True)
    first, second = root / "leg1", root / "leg2"
    vat.run(vat.parse(argv + ["--stop-after", "2", "--save", str(first)]))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, str(Path(vat.__file__).resolve())] + argv
        + ["--resume", str(first), "--stop-after", "2", "--save",
           str(second)], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"the resumed validation failed:\n"
                           f"{res.stderr[-4000:]}")
    with np.load(second / vat.RECORDS) as z:
        got_rec = {k: z[k] for k in z.files}
        startfile = str(z["startfile"])
    model = whole["model"]
    got = state_to_numpy(warmstart_state(
        second, startfile, f"{model.cfg.run.iexpnr:03d}", model.cfg,
        model.grid, model=model))
    errs = leaf_errors(got, state_to_numpy(whole["state"]))
    rec_err = max(float(np.abs(got_rec[k] - np.asarray(rec[k])).max()
                        / max(float(np.abs(np.asarray(rec[k])).max()), 1e-30))
                  for k in ("prof", "tau") + vat.SCALARS)
    worst = max(errs.values())
    out["chained"] = dict(state_rel_err=worst, records_rel_err=rec_err,
                          second_process_s=secs, leaves=len(errs))
    phase(50, f"validation chained on the card: 2 chunks + --save, then "
              f"--resume for 2 in a second process ({secs:.1f} s): records "
              f"within {rec_err:.3e}, State within {worst:.3e} of each "
              f"leaf's largest value over {len(errs)} leaves, against "
              f"phase 49's uninterrupted run (tolerance 1e-6)")
    if not (rec_err <= 1e-6 and worst <= 1e-6):
        raise RuntimeError("the chained validation departs from the "
                           "uninterrupted run")

    # 51. the Fortran warm start of the rescale-recycle generator
    start = "initd00000003_xxx_xxx.900"
    model = load_case(recycle32, "900", dtype="float64")        # the card
    st = model.run(model.cold_start(seed=43), 3)
    warm_dir = CACHE / "recycle32_warm"
    shutil.rmtree(warm_dir, ignore_errors=True)
    warm = with_namelist(recycle32, warm_dir, RUN=dict(
        lwarmstart=True, startfile=start))
    write_state_fortran(warm, st, "900", model.cfg, ntrun=3)
    back = warmstart_state(warm, start, "900", model.cfg, model.grid,
                           model=model)
    if back.ig is None:
        raise RuntimeError("warmstart_state built no generator state")
    want = init_inletgen(model.cfg, model.domain_grid, back.c,
                         model.igparams)
    ig_err = max(float((getattr(back.ig, k) - getattr(want, k)).abs().max())
                 for k in INLETGEN_NAMES)
    fused.launch_count = fused.masked_launch_count = 0
    after = state_to_numpy(model.run(back, 3))
    warm_launches = fused.launch_count
    bad = [k for k, v in flat_numpy(after).items()
           if v.dtype.kind == "f" and not np.isfinite(v).all()]
    rc, so, se, cli_s = run_cli(
        [str(warm), "--dtype", "float64", "--outdir",
         str(warm_dir / "out"), "--runtime", "0.3"], timeout=600)
    if rc != 0:
        raise RuntimeError(f"the CLI's warm start failed:\n{se[-4000:]}")
    cli_steps, cli_unmasked, cli_masked = launches_of(so)
    out["recycle_warm"] = dict(ig_max_abs_err=ig_err,
                               launches=warm_launches, cli_steps=cli_steps,
                               cli_launches=cli_unmasked, cli_s=cli_s,
                               timee=float(after["timee"]))
    phase(51, f"rescale-recycle 32^3 float64: 3 steps, Fortran restart, "
              f"warmstart_state(model=): ig built, max|ig - init_inletgen "
              f"of the warm fields| {ig_err:.3e}; 3 more steps to t = "
              f"{float(after['timee']):.4f} s, {warm_launches} launches, "
              f"non-finite leaves {bad}; python -m udales_tpu_torch with "
              f"lwarmstart from {start}: exit {rc}, {cli_steps} steps, "
              f"launches {cli_unmasked} unmasked, {cli_masked} masked, "
              f"{cli_s:.1f} s")
    if not (ig_err == 0.0 and not bad and warm_launches == 9
            and "warmstart from " + start in so
            and cli_unmasked == 3 * cli_steps and cli_masked == 0
            and cli_steps > 0):
        raise RuntimeError("the Fortran warm start of the generator case "
                           "failed its checks")
    # the same case continued through the native checkpoint, which carries
    # the generator's running means (ig) that the Fortran files lack
    hdir = CACHE / "recycle32_h5"
    shutil.rmtree(hdir, ignore_errors=True)
    hdir.mkdir()
    out["recycle_h5"] = rec = continuation(
        recycle32, "float64", hdir, 3, "rescale-recycle 32^3 float64", 51,
        fused, fmt="h5")
    if not (rec["worst"] <= 1e-9 and rec["dt_rel"] <= 1e-9
            and "ig" in rec["groups"] and rec["launches"] == (18, 0)):
        raise RuntimeError("the generator case continued from the .h5 "
                           "checkpoint left the uninterrupted run")
    return out


def compiled_phases(smi, fused, div_bound, urban, eb32):
    """Phases 52 to 54: the compiled step (``Model.step_jit``, one CUDA
    graph a step) on every main path against the eager step.  `urban` are
    the staged urban cases by size, `eb32` the urban-EB 32^3 case (dtEB
    0.5 s).  Any failed check raises."""
    import statistics
    from udales_tpu_torch import cases, entry
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    from udales_tpu_torch.run import load_case
    out = {}
    # 52. captured against eager on the main paths, in turns
    paths = {
        "flat_128": lambda: entry._build(128, 128, 128, "float32"),
        "flat_256": lambda: entry._build(256, 256, 256, "float32"),
        "urban_128": lambda: load_case(urban[128], "900", "float32"),
        "urban_eb_128": lambda: load_case(cases.stage_urban_eb(128, CACHE),
                                          "900", "float32"),
        "urban_driven_128": lambda: load_case(cases.stage_urban_driven(
            128, CACHE, dtdriver=0.1), "900", "float32"),
        "dispersion_128": lambda: load_case(cases.stage_urban_dispersion(
            128, CACHE), "900", "float32"),
    }
    for name, build in paths.items():
        model = build()
        steps = 10 if name == "flat_256" else 20
        runs, step, pool, st0, rel, (div, top) = captured_turns(
            model, steps, fused, name)
        # the device's share of a step, eager and captured (the profiler's
        # device activities of one step against the host's time a step)
        busy = {}
        for which in ("eager", "captured"):
            box = [st0]

            def one(graph=which == "captured"):
                box[0] = (captured_run(model, box[0], 1) if graph
                          else model.run(box[0], 1))
            host_ms, nl, nd, dev_ms = profile_call(one, reps=5)
            busy[which] = dict(host_ms=host_ms, runtime_launches=nl,
                               device_activities=nd, device_ms=dev_ms,
                               busy_share=dev_ms / host_ms)
        med = {k: statistics.median(r["ms_per_step"] for r in v)
               for k, v in runs.items()}
        out[name] = dict(
            eager=runs["eager"], captured=runs["captured"],
            median_ms=med, speedup=med["eager"] / med["captured"],
            capture_s=step.capture_seconds, graph_pool_gib=pool,
            replay_launches=replay_launches(step),
            captured_vs_eager=rel, max_div=div, top_div=top, busy=busy)
        ms = lambda w: ", ".join(f"{r['ms_per_step']:.3f}" for r in runs[w])
        phase(52, f"{name} float32 on {smi}, ms/step in turns eager, "
                  f"captured, captured, eager ({steps} steps each, CUDA "
                  f"events): eager {ms('eager')}, captured {ms('captured')} "
                  f"(medians {med['eager']:.3f} and {med['captured']:.3f}, "
                  f"{out[name]['speedup']:.2f}x; "
                  f"{runs['captured'][0]['points_per_s']:.6g} and "
                  f"{runs['captured'][1]['points_per_s']:.6g} points/s "
                  f"captured); launches 3 x {steps} in every run (the "
                  f"{'masked' if model.ibm is not None else 'unmasked'} "
                  f"variant, {replay_launches(step)} a replay); capture "
                  f"{step.capture_seconds:.3f} s (warm-up step included), "
                  f"its pool and static State {pool:.3f} GiB; peak "
                  f"allocated eager {runs['eager'][0]['peak_mem_gib']:.3f}, "
                  f"captured {runs['captured'][0]['peak_mem_gib']:.3f} GiB; "
                  f"max|div u| {div:.3e}, top level {top:.3e}; captured vs "
                  f"eager after 10 steps, each field's max|diff| / max: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
                  + " (tolerance 1e-4); one step profiled: " + "; ".join(
                      f"{w} {b['host_ms']:.3f} host ms, "
                      f"{b['runtime_launches']} launches, "
                      f"{b['device_activities']} device activities, "
                      f"{b['device_ms']:.3f} device ms, busy "
                      f"{100 * b['busy_share']:.1f}%"
                      for w, b in busy.items()))
        driven = model.inlet is not None
        if not (div <= div_bound and (top <= 1e-2 if driven
                                      else top <= div_bound)
                and max(rel.values()) <= 1e-4):
            raise RuntimeError(f"{name}: the captured step failed a check")
        del model, st0, step
        torch.cuda.empty_cache()

    # 53. the captured step on the card against the eager CPU, 32^3 float64
    small = {"flat": None, "urban": urban[32], "urban-EB": eb32,
             "driven": cases.stage_urban_driven(32, CACHE),
             "dispersion": cases.stage_urban_dispersion(32, CACHE)}
    out["cpu_32"] = {}
    for name, case in small.items():
        states, start = {}, None
        for dev in ("cpu", "cuda"):
            model = (entry._build(32, 32, 32, "float64", device=dev)
                     if case is None
                     else load_case(case, "900", "float64", device=dev))
            if start is None:
                start = (numpy_state(model.grid, seed=7) if case is None
                         else state_to_numpy(model.cold_start(seed=43)))
            states[dev] = state_to_numpy(model.run(
                state_from_numpy(start, device=dev), 5, graph=dev == "cuda"))
        errs = leaf_errors(states["cuda"], states["cpu"])
        worst = max(errs, key=errs.get)
        out["cpu_32"][name] = dict(max_rel_err=errs[worst], leaf=worst,
                                   leaves=len(errs))
        phase(53, f"{name} 32^3 float64, 5 captured steps on the card "
                  f"against 5 eager steps on the CPU: worst {errs[worst]:.3e}"
                  f" ({worst}) over {len(errs)} State leaves (tolerance "
                  f"1e-9)")
        if not errs[worst] <= 1e-9:
            raise RuntimeError(f"{name}: the captured step disagrees with "
                               f"the CPU")

    # 54. the captured rates side by side
    phase(54, "captured runs: " + ", ".join(
        f"{k} {v['median_ms']['captured']:.3f} ms/step "
        f"({v['speedup']:.2f}x eager)" for k, v in out.items()
        if k != "cpu_32"))
    return out


# --- the compiled step of a split Model (phases 55-57) ------------------------

def split_runs_32(name, build, start, mesh):
    """Phase 55 for one case: 5 steps of the one-process Model, then of a
    Model on the 1 x 1 NCCL `mesh` eagerly and as replays of its captured
    step, each on a Model of its own (a driver stream keeps its last
    window), from the whole-domain numpy `start`.  Returns the gathered
    States, collectives and bytes of the two split runs and the one
    process's State."""
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    from udales_tpu_torch.parallel.mesh import gather_state
    from udales_tpu_torch.parallel.multihost import shard_state_global
    one = state_to_numpy(build(None).run(state_from_numpy(
        start, device="cuda"), 5))
    out = {"one": one}
    for which in ("eager", "captured"):
        model = build(mesh)
        st = shard_state_global(state_from_numpy(start), mesh, device="cuda")
        mesh.reset_counts()
        st = model.run(st, 5, graph=which == "captured")
        torch.cuda.synchronize()
        out[which] = dict(state=state_to_numpy(gather_state(st, mesh)),
                          collectives=mesh.collectives, bytes=mesh.bytes)
        if which == "captured":
            step = model.step_jit()
            if step.kind != "cuda graph" or step.graph is None:
                raise RuntimeError(f"{name}: the split step was not "
                                   f"captured ({step.kind})")
            out["per_replay"] = step.collectives_per_replay
    return out


def split_main_path(name, model, smi, fused, div_bound, one_ms):
    """Phase 56 for one 128^3 path on the 1 x 1 NCCL mesh
    (`captured_turns` of 20 steps a run, collectives and bytes a step);
    `one_ms` is the one-process captured median of phase 52.  Returns the
    numbers."""
    import statistics
    steps = 20
    runs, step, pool, _, rel, (div, top) = captured_turns(
        model, steps, fused, f"{name} on 1 x 1 NCCL")
    coll = {(r["collectives"], r["bytes"]) for v in runs.values() for r in v}
    med = {k: statistics.median(r["ms_per_step"] for r in v)
           for k, v in runs.items()}
    out = dict(eager=runs["eager"], captured=runs["captured"],
               median_ms=med, speedup=med["eager"] / med["captured"],
               one_process_captured_ms=one_ms,
               over_one_process=med["captured"] / one_ms,
               capture_s=step.capture_seconds, graph_pool_gib=pool,
               collectives_per_step=runs["captured"][0]["collectives"],
               bytes_per_step=runs["captured"][0]["bytes"],
               per_replay=step.collectives_per_replay,
               replay_launches=replay_launches(step),
               captured_vs_eager=rel, max_div=div, top_div=top)
    ms = lambda w: ", ".join(f"{r['ms_per_step']:.3f}" for r in runs[w])
    phase(56, f"{name} float32 on mesh 1 x 1 (NCCL) on {smi}, ms/step in "
              f"turns eager, captured, captured, eager ({steps} steps each, "
              f"CUDA events): eager {ms('eager')}, captured {ms('captured')} "
              f"(medians {med['eager']:.3f} and {med['captured']:.3f}, "
              f"{out['speedup']:.2f}x); one process captured "
              f"{one_ms:.3f} (phase 52), the split's captured step "
              f"{out['over_one_process']:.3f}x it; collectives and bytes a "
              f"step {out['collectives_per_step']:.1f} and "
              f"{out['bytes_per_step']:.0f} in every run, "
              f"{step.collectives_per_replay} a replay; masked launches "
              f"3 x {steps} in every run ({replay_launches(step)} a "
              f"replay); capture {step.capture_seconds:.3f} s (warm-up step "
              f"included), its pool and static State {pool:.3f} GiB; peak "
              f"allocated eager {runs['eager'][0]['peak_mem_gib']:.3f}, "
              f"captured {runs['captured'][0]['peak_mem_gib']:.3f} GiB; "
              f"max|div u| {div:.3e}, top level {top:.3e}; captured vs "
              f"eager after 10 steps, each field's max|diff| / max: "
              + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
              + " (tolerance 1e-4)")
    driven = model.inlet is not None
    if not (len(coll) == 1 and div <= div_bound
            and (top <= 1e-2 if driven else top <= div_bound)
            and max(rel.values()) <= 1e-4):
        raise RuntimeError(f"{name} on 1 x 1 NCCL: the captured split step "
                           f"failed a check (collectives and bytes a step "
                           f"{coll})")
    return out


def split_simulation_nccl(mesh, sim48, fused):
    """Phase 57's Simulation: phase 48's driven urban 32^3 float64 case on
    the 1 x 1 NCCL `mesh`, from the same start and for the same time;
    returns the step kind, the steps, the writers' records against the
    single-process Simulation's and the final State's worst leaf."""
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    from udales_tpu_torch.parallel.mesh import gather_state
    from udales_tpu_torch.parallel.multihost import shard_state_global
    from udales_tpu_torch.run import load_case
    from udales_tpu_torch.sim import Simulation
    import tempfile
    records = {}
    undo = recording_writers(records)
    try:
        model = load_case(sim48["case"], "900", "float64", mesh=mesh)
        st = shard_state_global(state_from_numpy(sim48["start"]), mesh,
                                device="cuda")
        with tempfile.TemporaryDirectory(prefix="sim57_", dir=CACHE) as td:
            sim = Simulation(model, td)
            fused.launch_count = fused.masked_launch_count = 0
            final = state_to_numpy(gather_state(
                sim.run(st, runtime=SIM48_RUNTIME), mesh))
    finally:
        undo()
    rec_worst, rec_at, files = record_errors(records, sim48["records"],
                                             "1 x 1 NCCL")
    errs = leaf_errors(final, sim48["state"])
    worst = max(errs, key=errs.get)
    return dict(step_kind=sim.step_kind, steps=sim.ntrun, files=files,
                max_err_records=rec_worst, record=rec_at,
                max_rel_err_state=errs[worst], leaf=worst,
                masked=fused.masked_launch_count, gathers=sim.gathers)


def compiled_split_phases(smi, fused, div_bound, paths, comp, sim48):
    """Phases 55 to 57: the compiled step of a Model split over a 1 x 1
    NCCL mesh, which goes through every collective of the split.  `paths`
    maps the 32^3 cases of phase 55 to their directories (None: the flat
    case) and "urban_128", "urban_driven_128" to phase 56's; `comp` is
    phase 52's result (the one-process captured step), `sim48` phase 48's
    single-process Simulation.  The NCCL group is destroyed after the
    graphs that hold its collectives are freed.  Any failed check
    raises."""
    import gc
    import torch.distributed as dist
    from udales_tpu_torch import entry
    from udales_tpu_torch.convert import state_to_numpy
    from udales_tpu_torch.parallel.mesh import make_mesh
    from udales_tpu_torch.parallel.multihost import (free_port,
                                                     init_distributed)
    from udales_tpu_torch.run import load_case
    from udales_tpu_torch.sim import Simulation
    out = {}
    init_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl",
                     device="cuda", timeout=120.0)
    nccl = torch.cuda.nccl.version()
    out["nccl_version"] = ".".join(map(str, nccl)) \
        if isinstance(nccl, tuple) else str(nccl)
    try:
        mesh = make_mesh(1, 1)
        # 55. five paths at 32^3 float64, captured against eager and
        # against one process
        out["parity_32"] = {}
        for name, case in paths.items():
            if name.endswith("_128"):
                continue

            def build(m, case=case):
                if case is None:
                    return entry._build(32, 32, 32, "float64", mesh=m)
                return load_case(case, "900", "float64", mesh=m)
            one = build(None)
            start = (numpy_state(one.grid, seed=7) if case is None
                     else state_to_numpy(one.cold_start(seed=43)))
            del one
            r = split_runs_32(name, build, start, mesh)
            vs_eager = leaf_errors(r["captured"]["state"],
                                   r["eager"]["state"])
            vs_one = leaf_errors(r["captured"]["state"], r["one"])
            we, wo = (max(e, key=e.get) for e in (vs_eager, vs_one))
            same = ((r["captured"]["collectives"], r["captured"]["bytes"])
                    == (r["eager"]["collectives"], r["eager"]["bytes"]))
            out["parity_32"][name] = dict(
                vs_eager=vs_eager[we], vs_eager_leaf=we,
                vs_one_process=vs_one[wo], vs_one_process_leaf=wo,
                leaves=len(vs_one), collectives=r["captured"]["collectives"],
                bytes=r["captured"]["bytes"],
                eager_collectives=r["eager"]["collectives"],
                per_replay=r["per_replay"])
            phase(55, f"{name} 32^3 float64 on mesh 1 x 1 (NCCL "
                      f"{out['nccl_version']}), 5 captured steps: every one "
                      f"of {len(vs_one)} leaves within {vs_eager[we]:.3e} of "
                      f"the eager split run (worst {we}) and "
                      f"{vs_one[wo]:.3e} of Model.run on one process "
                      f"(worst {wo}; tolerance 1e-12); collectives and bytes "
                      f"{r['captured']['collectives']}, "
                      f"{r['captured']['bytes']} captured, "
                      f"{r['eager']['collectives']}, {r['eager']['bytes']} "
                      f"eager; {r['per_replay']} a replay")
            if not (vs_eager[we] <= 1e-12 and vs_one[wo] <= 1e-12 and same):
                raise RuntimeError(f"{name}: the captured 1 x 1 NCCL split "
                                   f"disagrees with the eager one or with "
                                   f"one process")
            gc.collect()

        # 56. the full-width paths at 128^3 float32
        for name in ("urban_128", "urban_driven_128"):
            model = load_case(paths[name], "900", "float32", mesh=mesh)
            out[name] = split_main_path(
                name, model, smi, fused, div_bound,
                comp[name]["median_ms"]["captured"])
            del model
            gc.collect()
            torch.cuda.empty_cache()

        # 57. Simulation on the 1 x 1 NCCL mesh, stepping compiled
        sim = split_simulation_nccl(mesh, sim48, fused)
        out["simulation_32"] = sim
        phase(57, f"Simulation of driven urban 32^3 float64 on mesh 1 x 1 "
                  f"(NCCL), step {sim['step_kind']}, {sim['steps']} steps, "
                  f"{sim['gathers']} gathers: {sim['files']} files, every "
                  f"array handed to a writer within "
                  f"{sim['max_err_records']:.3e} of the single-process "
                  f"Simulation's (worst {sim['record']}; a second moment: of "
                  f"the means it is formed from; tolerance 1e-9), final "
                  f"State within {sim['max_rel_err_state']:.3e} (worst "
                  f"{sim['leaf']}); masked launches {sim['masked']}")
        if not (sim["step_kind"] == "compiled (cuda graph)"
                and sim["steps"] == sim48["steps"] and sim["files"] >= 3
                and sim["max_err_records"] <= 1e-9
                and sim["max_rel_err_state"] <= 1e-9
                and sim["masked"] == 3 * sim["steps"]):
            raise RuntimeError("Simulation on the 1 x 1 NCCL mesh did not "
                               "step compiled or disagrees with one process")
    finally:
        # the graphs hold NCCL's communicators: free them first
        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()

    # 57. a host-staged mesh on the card refuses the compiled step
    init_distributed(f"localhost:{free_port()}", 1, 0, backend="gloo",
                     device="cuda", timeout=60.0)
    try:
        model = entry._build(16, 16, 16, "float32",
                             mesh=make_mesh(1, 1, host_staged=True))
        try:
            model.step_jit()
            refusal = None
        except NotImplementedError as e:
            refusal = str(e)
        CACHE.mkdir(exist_ok=True)
        kind = Simulation(model, CACHE / "sim57_staged",
                          monitor=False).step_kind
    finally:
        dist.destroy_process_group()
    out["host_staged_refusal"] = refusal
    phase(57, f"mesh 1 x 1, backend gloo, host_staged True, on the card: "
              f"step_jit() raised NotImplementedError: {refusal}; "
              f"Simulation steps {kind}")
    if refusal is None or kind != "eager (host-staged split)":
        raise RuntimeError("a host-staged mesh did not refuse the compiled "
                           "step")
    return out


# --- the compiled split over several cards (--cards, phase 58) ---------------

CARD_STEPS = 20


def card_rank(rank, world, port, jobs, out):
    """One rank of `cards_mode`: card `rank`, the NCCL group of `world`
    ranks and the 2 x (world/2) mesh.  A job with a "start" runs its steps
    eagerly and as replays of the compiled step, each on a Model of its
    own, and keeps the gathered States; a job without one (a 128^3 path)
    runs `captured_turns` of CARD_STEPS steps a run, the ranks aligned
    before each run.  Writes out/rank<r>.pkl."""
    import pickle
    import torch.distributed as dist
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    from udales_tpu_torch.ops.fused_diff import fused_diff_mom as fused
    from udales_tpu_torch.parallel.mesh import gather_state, make_mesh
    from udales_tpu_torch.parallel.multihost import (init_distributed,
                                                     shard_state_global)
    from udales_tpu_torch.run import load_case
    torch.cuda.set_device(rank)
    init_distributed(f"localhost:{port}", world, rank, backend="nccl",
                     device="cuda", timeout=120.0)
    mesh = make_mesh(2, world // 2)
    res = {}
    for job in jobs:
        r = res[job["name"]] = {}
        if job["start"] is not None:
            for which in ("eager", "captured"):
                model = load_case(job["case"], "900", job["dtype"], mesh=mesh)
                st = shard_state_global(state_from_numpy(job["start"]), mesh,
                                        device="cuda")
                fused.launch_count = fused.masked_launch_count = 0
                mesh.reset_counts()
                st = model.run(st, job["steps"], graph=which == "captured")
                torch.cuda.synchronize()
                r[which] = dict(
                    state=state_to_numpy(gather_state(st, mesh)),
                    collectives=mesh.collectives, bytes=mesh.bytes,
                    masked=fused.masked_launch_count,
                    kind=model.step_jit().kind if which == "captured"
                    else "eager")
                del model, st
            continue
        model = load_case(job["case"], "900", "float32", mesh=mesh)

        def align():
            torch.cuda.synchronize()
            dist.barrier()
        runs, step, _, _, rel, (div, top) = captured_turns(
            model, CARD_STEPS, fused, f"{job['name']} rank {rank}", align)
        r.update(runs, max_div=div, top_div=top, captured_vs_eager=rel,
                 capture_s=step.capture_seconds,
                 per_replay=step.collectives_per_replay, kind=step.kind,
                 open_x=model.inlet is not None)
        del model, step
    Path(out, f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    import gc
    gc.collect()                 # the graphs before their communicators
    torch.cuda.synchronize()
    dist.destroy_process_group()


def cards_mode():
    """``chip_smoke.py --cards``: phase 58, the compiled step of a Model
    split over 2 x 2 NCCL ranks, one a card, on four cards.  Urban and
    driven urban 32^3 float64, 5 steps, captured against the eager split
    run (1e-12) and against Model.run on one card (1e-9, the shared-card
    2 x 2 bound of phases 41 and 45), the same collectives and bytes; then
    urban and driven urban 128^3 float32 in turns eager, captured,
    captured, eager of CARD_STEPS steps (ms/step per rank, collectives and
    bytes a step, masked launches = 3 x steps) beside the same path
    captured on one card, max|div u| and captured against eager over 10
    steps (1e-4).  Prints a JSON line of the numbers, then raises if a
    check failed."""
    import pickle
    import statistics
    import tempfile
    from udales_tpu_torch import cases
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    from udales_tpu_torch.ops.fused_diff import fused_diff_mom
    from udales_tpu_torch.parallel.multihost import free_port
    from udales_tpu_torch.run import load_case
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        raise SystemExit("chip_smoke --cards: needs four CUDA devices")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
    nccl = torch.cuda.nccl.version()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{'.'.join(map(str, nccl)) if isinstance(nccl, tuple) else nccl}",
          flush=True)
    fused_diff_mom.load()      # built once, before the ranks load it
    d32 = cases.stage_urban_driven(32, CACHE, nt=40, chunk=4, dtdriver=0.05)
    small = {"urban_32": cases.stage_urban(32, CACHE), "driven_32": d32}
    big = {"urban_128": cases.stage_urban(128, CACHE),
           "urban_driven_128": cases.stage_urban_driven(128, CACHE,
                                                        dtdriver=0.1)}
    jobs, one = [], {}
    for name, case in small.items():
        model = load_case(case, "900", "float64")
        start = state_to_numpy(model.cold_start(seed=43))
        model = load_case(case, "900", "float64")     # a fresh stream
        one[name] = state_to_numpy(model.run(state_from_numpy(
            start, device="cuda"), 5))
        jobs.append(dict(name=name, case=str(case), dtype="float64",
                         steps=5, start=start))
    one_ms = {}
    for name, case in big.items():
        model = load_case(case, "900", "float32")
        st = model.run(model.cold_start(seed=43), 3)
        st = captured_run(model, st, 1)
        one_ms[name] = statistics.median(
            timed_run(model, st, CARD_STEPS, True, fused_diff_mom,
                      f"{name} captured on one card")[0]["ms_per_step"]
            for _ in range(2))
        jobs.append(dict(name=name, case=str(case), start=None))
        del model, st
    torch.cuda.empty_cache()
    CACHE.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="cards_", dir=CACHE) as td:
        ctx = start_ranks(card_rank, 4, (4, free_port(), jobs, td))
        wait_ranks(ctx, 900)
        ranks = [pickle.loads(Path(td, f"rank{r}.pkl").read_bytes())
                 for r in range(4)]
    out, failed = {"nccl": str(nccl), "cards": smi}, []
    for name in small:
        r = [x[name] for x in ranks]
        vs_eager = max(max(leaf_errors(x["captured"]["state"],
                                       x["eager"]["state"]).values())
                       for x in r)
        errs = leaf_errors(r[0]["captured"]["state"], one[name])
        worst = max(errs, key=errs.get)
        same = all((x["captured"]["collectives"], x["captured"]["bytes"],
                    x["captured"]["masked"]) == (
                        x["eager"]["collectives"], x["eager"]["bytes"],
                        x["eager"]["masked"]) for x in r)
        out[name] = dict(vs_eager=vs_eager, vs_one_card=errs[worst],
                         leaf=worst, leaves=len(errs),
                         collectives=[x["captured"]["collectives"]
                                      for x in r],
                         bytes=[x["captured"]["bytes"] for x in r],
                         masked=[x["captured"]["masked"] for x in r],
                         kind=r[0]["captured"]["kind"])
        phase(58, f"{name} float64 on mesh 2 x 2, NCCL, one rank a card, 5 "
                  f"captured steps ({r[0]['captured']['kind']}): every leaf "
                  f"on every rank within {vs_eager:.3e} of the eager split "
                  f"run (tolerance 1e-12), rank 0's gathered State within "
                  f"{errs[worst]:.3e} of one card's Model.run (worst "
                  f"{worst}; tolerance 1e-9); collectives per rank "
                  f"{out[name]['collectives']}, bytes "
                  f"{out[name]['bytes']}, masked launches "
                  f"{out[name]['masked']}, the same eagerly")
        if not (vs_eager <= 1e-12 and errs[worst] <= 1e-9 and same
                and r[0]["captured"]["kind"] == "cuda graph"
                and all(m == 15 for m in out[name]["masked"])):
            failed.append(name)
    for name in big:
        r = [x[name] for x in ranks]
        med = {w: [statistics.median(t["ms_per_step"] for t in x[w])
                   for x in r] for w in ("eager", "captured")}
        # each rank's collectives and bytes a step, in every run
        coll = [{(t["collectives"], t["bytes"]) for w in ("eager",
                                                         "captured")
                 for t in x[w]} for x in r]
        rel = max(max(x["captured_vs_eager"].values()) for x in r)
        out[name] = dict(
            median_ms_per_rank=med, one_card_captured_ms=one_ms[name],
            runs={w: [[t["ms_per_step"] for t in x[w]] for x in r]
                  for w in ("eager", "captured")},
            collectives_bytes_per_step=[sorted(c) for c in coll],
            capture_s=[x["capture_s"] for x in r],
            per_replay=r[0]["per_replay"], max_div=r[0]["max_div"],
            top_div=r[0]["top_div"], captured_vs_eager=rel,
            launches=[[t["launches"] for t in x["captured"]] for x in r],
            peak_gib=[x["captured"][0]["peak_mem_gib"] for x in r])
        phase(58, f"{name} float32 on mesh 2 x 2, NCCL, one rank a card, "
                  f"blocks 64 x 64 x 128, {CARD_STEPS} steps a run in turns "
                  f"eager, captured, captured, eager: median ms/step per "
                  f"rank eager {[round(v, 3) for v in med['eager']]}, "
                  f"captured {[round(v, 3) for v in med['captured']]}; the "
                  f"same path captured on one card {one_ms[name]:.3f}; "
                  f"collectives and bytes a step per rank "
                  f"{[sorted(c) for c in coll]} in every run "
                  f"({r[0]['per_replay']} a replay); capture "
                  f"{[round(x['capture_s'], 3) for x in r]} s; masked "
                  f"launches {out[name]['launches']}; max|div u| "
                  f"{r[0]['max_div']:.3e}, top level {r[0]['top_div']:.3e}; "
                  f"captured vs eager after 10 steps {rel:.3e} (tolerance "
                  f"1e-4)")
        open_x = r[0]["open_x"]
        if not (all(len(c) == 1 for c in coll) and rel <= 1e-4
                and r[0]["max_div"] <= 1e-5
                and (r[0]["top_div"] <= (1e-2 if open_x else 1e-5))
                and all(n == 3 * CARD_STEPS for x in out[name]["launches"]
                        for n in x)):
            failed.append(name)
    print(json.dumps({"compiled_split_cards": out}))
    if failed:
        raise RuntimeError(f"the captured 2 x 2 split failed a check: "
                           f"{failed}")


def main():
    # 1. a CUDA device, or nothing
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); the port has no CPU "
                         "fallback here")
    from udales_tpu_torch import cases, entry
    from udales_tpu_torch.cases import (stage_urban, stage_urban_driven,
                                        stage_urban_eb)
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    from udales_tpu_torch.grid import Grid
    from udales_tpu_torch.ops.fused_adv import fused_adv_mom
    from udales_tpu_torch.ops.fused_diff import SOURCE, fused_diff_mom
    from udales_tpu_torch.ops.fused_ibmnorm import fused_ibmnorm
    from udales_tpu_torch.ops.fused_scalars import fused_scalars
    from udales_tpu_torch.ops.fused_vreman import fused_vreman
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
    t0 = time.perf_counter()
    fused_adv_mom.load()
    phase(3, f"built fused_adv_mom.cu for sm_90a in "
             f"{time.perf_counter() - t0:.2f} s")
    for line in fused_adv_mom.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    print("  resident blocks per SM: " + ", ".join(
        f"{'thl' if t else 'no thl'} {str(dt)[6:]} "
        f"{fused_adv_mom.blocks_per_sm(dt, t)}"
        for dt in (torch.float32, torch.float64) for t in (True, False)),
        flush=True)

    t0 = time.perf_counter()
    fused_vreman.load()
    phase(3, f"built fused_vreman.cu for sm_90a (no FMA contraction) in "
             f"{time.perf_counter() - t0:.2f} s")
    for line in fused_vreman.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    print("  resident blocks per SM: " + ", ".join(
        f"{'buoycorr' if b else 'plain'} {str(dt)[6:]} "
        f"{fused_vreman.blocks_per_sm(dt, b)}"
        for dt in (torch.float32, torch.float64) for b in (False, True)),
        flush=True)
    t0 = time.perf_counter()
    fused_ibmnorm.load()
    phase(3, f"built fused_ibmnorm.cu for sm_90a (no FMA contraction) in "
             f"{time.perf_counter() - t0:.2f} s")
    for line in fused_ibmnorm.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    print("  resident blocks per SM: " + ", ".join(
        f"{'thl + correction' if c else 'thl'} {str(dt)[6:]} "
        f"{fused_ibmnorm.blocks_per_sm(dt, c)}"
        for dt in (torch.float32, torch.float64) for c in (False, True)),
        flush=True)
    t0 = time.perf_counter()
    fused_scalars.load()
    phase(3, f"built fused_scalars.cu for sm_90a (no FMA contraction) in "
             f"{time.perf_counter() - t0:.2f} s")
    for line in fused_scalars.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    print("  resident blocks per SM with 3 scalars: " + ", ".join(
        f"{'masked' if m else 'open'} {str(dt)[6:]} "
        f"{fused_scalars.blocks_per_sm(dt, m)}"
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
    main = flat_main_path(128, warm=5, steps=20, smi=smi,
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

    # 60. the advection kernel against its plain route, and its time
    adv = advection_phase(smi, (g128, g256))

    # 61. the Vreman closure kernel against its plain route, and its time
    vre = vreman_phase(smi)

    # 62. the ibmnorm kernel against its plain route, and its time
    ibn = ibmnorm_phase(smi)

    # 63. the scalar-stack kernel against its plain route, and its time
    scs = scalars_phase(smi)

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
    urb, _ = run_main_path(u128, u128.cold_start(seed=43), warm=5, steps=20,
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
                            steps=30, smi=smi, fused=fused_diff_mom,
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

    # 18.-24. the open-boundary slice
    drv = open_boundary_phases(smi, fused_diff_mom, div_bound, pm128)

    # 25.-30. the dispersion slice
    disp = dispersion_phases(smi, fused_diff_mom, div_bound, urb)

    # 31.-35. the run-time driver
    drv_out = driver_phases(smi, fused_diff_mom, div_bound, eb128, urban,
                            cases.stage_urban_driven(32, CACHE))

    # 36.-43. the x/y split of the flat and the urban paths
    open32 = stage_open_family(32)
    split = split_phases(smi, fused_diff_mom, dict(
        urban=urban[32], urban128=urban[128], **{"urban-EB": eb32},
        dispersion=cases.stage_urban_dispersion(32, CACHE, purifiers=True,
                                                heatpumps=True),
        open=open32, driven128=drv["case128"], ghosts128=drv["ghosts128"],
        simulation=cases.with_namelist(
            open32["driven"], CACHE / "urban32drv_sim48",
            OUTPUT=dict(lfielddump=True, fieldvars="u0,v0,w0,th,pr",
                        tfielddump=0.1, lxytdump=True, ltkedump=True,
                        tsample=0.05, tstatsdump=0.1, tcheck=0.1))))

    # 49.-51. the long-horizon validation's path
    val = validation_phases(smi, fused_diff_mom, open32["recycle"])

    # 52.-54. the compiled step against the eager one
    comp = compiled_phases(smi, fused_diff_mom, div_bound, urban, eb32)

    # 55.-57. the compiled step of a split Model on a 1 x 1 NCCL mesh
    csplit = compiled_split_phases(smi, fused_diff_mom, div_bound, {
        "flat": None, "urban": urban[32], "urban-EB": eb32,
        "driven": open32["driven"], "recycle": open32["recycle"],
        "urban_128": urban[128],
        "urban_driven_128": cases.stage_urban_driven(128, CACHE,
                                                     dtdriver=0.1)},
        comp, split["_sim48"])

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "udales_tpu"))
    if foreign:
        raise RuntimeError(f"the port imported {foreign}")

    src = "udales_tpu_torch/csrc/fused_diff_mom.cu"
    rates = lambda d: {k: d[k] for k in ("ms_per_step", "points_per_s",
                                         "peak_mem_gib")}
    print(json.dumps({"kernels": [
        {"name": "fused_scalars", "route": "cuda",
         "source": "udales_tpu_torch/csrc/fused_scalars.cu",
         "replaces": None,
         "launches": disp["dispersion"]["scalars_launches"],
         "bit_for_bit": scs["shapes"], **scs["t128"], "bound_by": "bytes",
         "library_ms": None,
         **{f"{k}_512x512x128": v for k, v in scs["t512"].items()}},
        {"name": "fused_ibmnorm", "route": "cuda",
         "source": "udales_tpu_torch/csrc/fused_ibmnorm.cu",
         "replaces": None, "launches": urb["ibmnorm_launches"],
         "bit_for_bit": ibn["shapes"], **ibn["t128"], "bound_by": "bytes",
         "library_ms": None,
         "launches_urban_driven": drv["driven"]["ibmnorm_launches"],
         **{f"{k}_256": v for k, v in ibn["t256"].items()},
         **{f"{k}_512x512x128": v for k, v in ibn["t512"].items()}},
        {"name": "fused_vreman", "route": "cuda",
         "source": "udales_tpu_torch/csrc/fused_vreman.cu",
         "replaces": None, "launches": main["vreman_launches"],
         "max_abs_err": vre["err"], **vre["t128"], "bound_by": "bytes",
         "library_ms": None, "launches_256": big["vreman_launches"],
         "launches_urban_driven": drv["driven"]["vreman_launches"],
         **{f"{k}_256": v for k, v in vre["t256"].items()},
         **{f"{k}_512x512x128": v for k, v in vre["t512"].items()}},
        {"name": "fused_adv_mom", "route": "cuda",
         "source": "udales_tpu_torch/csrc/fused_adv_mom.cu",
         "replaces": None, "launches": main["adv_launches"],
         "max_abs_err": adv["err"], **adv["t128"], "bound_by": "bytes",
         "library_ms": None, "launches_256": big["adv_launches"],
         **{f"{k}_256": v for k, v in adv["t256"].items()}},
        {"name": "fused_diff_mom", "route": "cuda", "source": src,
         "replaces": "udales_tpu/ops/pallas_stencil.py:191",
         "launches": main["launches"], "max_abs_err": kernel_err,
         **t128, "bound_by": "bytes", "library_ms": None,
         "launches_256": big["launches"],
         "launches_recycle_128": drv["recycle"]["launches"],
         "max_abs_err_open_ghosts": drv["open_err"]["unmasked"],
         **{f"{k}_256": v for k, v in t256.items()},
         "launches_split_2x2_per_rank": [m["launches"] for m in
                                         split["main_2x2"]],
         "max_abs_err_block_64x64x128": split["block_err"],
         **{f"{k}_block_64x64x128": v for k, v in split["block"].items()},
         "launches_validation_32": val["validation"]["launches"],
         "launches_h5_continuation_recycle_32":
             val["recycle_h5"]["launches"][0],
         **{f"launches_captured_{k}": [r["launches"]
                                       for r in comp[k]["captured"]]
            for k in ("flat_128", "flat_256")},
         "max_abs_err_64": val["err64"],
         **{f"{k}_64": v for k, v in val["t64"].items()}},
        {"name": "fused_diff_mom_masked", "route": "cuda", "source": src,
         "replaces": "udales_tpu/ops/pallas_stencil.py:191",
         "launches": urb["launches"], "max_abs_err": masked_err,
         **tm128, "bound_by": "bytes", "library_ms": None,
         "launches_urban_eb": ueb["launches"],
         "launches_urban_driven": drv["driven"]["launches"],
         "launches_urban_dispersion": disp["dispersion"]["launches"],
         "launches_oneeqn": disp["oneeqn"]["launches"],
         "launches_purifiers_heatpumps":
             disp["purifiers_heatpumps"]["launches"],
         "launches_cli_urban_eb": drv_out["cli"]["masked"],
         "launches_simulation_dispersion": drv_out["sims"]["dispersion_masked"],
         "launches_simulation_driven": drv_out["sims"]["driven_masked"],
         **{f"launches_h5_continuation_{k}_32":
            drv_out["restart"][f"h5_{k}_32_f64"]["launches"][1]
            for k in ("urban", "urban_eb")},
         "max_abs_err_open_ghosts": drv["open_err"]["masked"],
         "launches_split_driven_2x2_per_rank": [
             m["masked"] for m in split["driven_main_2x2"]],
         **{f"launches_captured_{k}": [r["launches"]
                                       for r in comp[k]["captured"]]
            for k in ("urban_128", "urban_eb_128", "urban_driven_128",
                      "dispersion_128")},
         **{f"launches_captured_split_1x1_{k}": [
             r["launches"] for r in csplit[k]["captured"]]
            for k in ("urban_128", "urban_driven_128")},
         "launches_simulation_split_1x1_driven_32":
             csplit["simulation_32"]["masked"],
         "max_abs_err_block_open_ghosts": split["open_block_err"],
         **{f"{k}_block_open_ghosts": v
            for k, v in split["open_block"].items()}},
        {"name": "fused_diff_mom_masked_block_64x64x128", "route": "cuda",
         "source": src, "replaces": "udales_tpu/ops/pallas_stencil.py:191",
         "launches": sum(m["masked"] for m in split["urban_main_2x2"]),
         "launches_per_rank": [m["masked"] for m in split["urban_main_2x2"]],
         "max_abs_err": split["masked_block_err"],
         **split["masked_block"], "bound_by": "bytes", "library_ms": None,
         "path": "urban 128^3 float32 on a 2 x 2 mesh, 10 steps, 4 ranks"}],
        "main_path": rates(main), "main_path_256": rates(big),
        "urban_128": rates(urb),
        "urban_eb_128": {**rates(ueb), **{k: ueb[k] for k in (
            "tEB_last", "facT_min", "facT_max", "facT_moved")}},
        "poisson_128": pois,
        "urban_driven_128": {**rates(drv["driven"]), **{
            k: drv["driven"][k] for k in ("refills", "inlet_err", "max_div",
                                          "top_div", "dt", "ensure_ms",
                                          "refill_ms")}},
        "recycle_128": rates(drv["recycle"]),
        "precursor_replay_64": drv["replay"],
        "dispersion_128": {**rates(disp["dispersion"]), **{
            k: disp["dispersion"][k] for k in (
                "ratio_to_urban", "max_div", "nox_err", "sv_max", "o3_min",
                "dt")}},
        "purifiers_heatpumps_128": {**rates(disp["purifiers_heatpumps"]), **{
            k: disp["purifiers_heatpumps"][k] for k in (
                "box_err", "div_outside", "fan_w")}},
        "oneeqn_128": {**rates(disp["oneeqn"]), **{
            k: disp["oneeqn"][k] for k in ("e12_min", "e12_max",
                                           "max_div")}},
        "driver": drv_out,
        "split": {k: split[k] for k in ("nccl_1x1", "nccl_shared_card",
                                        "shared", "main_2x2",
                                        "urban_nccl_1x1", "urban_shared_2x2",
                                        "urban_main_2x2", "open_nccl_1x1",
                                        "open_shared_2x2", "driven_main_2x2",
                                        "simulation_2x2")},
        "validation_32": {**val["validation"], "chained": val["chained"]},
        "recycle_warm_start_32": val["recycle_warm"],
        "recycle_h5_continuation_32": val["recycle_h5"],
        "compiled": comp, "compiled_split": csplit}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resume"]:
        resume_mode(sys.argv[2:])
    elif sys.argv[1:2] == ["--cards"]:
        cards_mode()
    else:
        main()
