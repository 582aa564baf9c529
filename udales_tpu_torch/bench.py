"""The port's bench: grid-points/s of the captured RK3 step on one card (the
counterpart of the JAX side's ``bench.py``).

    python -m udales_tpu_torch.bench [--cell NAME ...] [--runs N]
                                     [--steps N] [--seed S]
    UDALES_BENCH_CPU=1 python -m udales_tpu_torch.bench

Each cell stages a case as ``bench.py`` stages it (``cases.stage_*`` under
``.bench_cache/`` beside the package, or ``entry._build`` for the flat
ABL), loads it in float32 on the card, and times it with `time_cell`: 3
eager steps from the cold start, the build of the compiled step
(``Model.step_jit``: one eager step, then the CUDA-graph capture; its
seconds are ``capture_s``), then `runs` runs of ``Model.run(state, steps,
graph=True)``, each between CUDA events, so that a driven case's window
refill and the copy the run hands back are inside the window, as a user
pays them.  A cell's rate is all the grid-points of its timed runs over
all their seconds (``itot * jtot * ktot * steps * runs / seconds``);
beside it are the median, best and worst run's rate and the ms/step of
every run, the card's clocks and power draw read once before the first
run and once after the last (``nvidia-smi``, outside the timed window),
the peak memory of a run, fused_diff_mom's launches a step as counted,
and, from one profiled run apart from the timed ones (``torch.profiler``,
5 replays), the device's busy share, the top device operations and
fused_diff_mom's device ms a step.  Every cell checks its result and
raises on a failure (finite State, launches = 3 x steps of the path's
variant and none of the other, max|div u|, the facet temperatures of the
energy balance): a cell that fails ends the command with a non-zero exit,
after the tables of the cells before it.

Departures from ``bench.py``: all the points over all the seconds of
`runs` runs (default 5), with the median, best and worst run beside it,
where ``bench.py`` takes the best of 3; checks that raise, where
``bench.py`` prints ``"failed: X"`` and carries on; no ``vs_baseline``
against an estimated Fortran rate; three more 128^3 cells (urban with the
energy balance, driven through an open x boundary, dispersion); and no
``prec_949`` or ``replay_950``, whose inputs (the uDALES reference's
examples 949 and 950) are not in the repository.

The last line of the output is one JSON object: ``metric``
(``rk3_step_urban_ibm_grid_points_per_s_per_chip``), ``value`` (urban
128^3's rate; null when that cell is not run), ``unit``, one key per
cell with its rate, ``cells`` with each cell's numbers and ``device``
(name and power limit from ``nvidia-smi``, count).  Without a card the
command raises; ``UDALES_BENCH_CPU=1`` is the one exception: the flat 64^3
case on the host CPU, 10 steps, printed as
``rk3_step_grid_points_per_s_cpu_host`` with the CPU's name.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import platform
import statistics
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import cases, entry
from .ops.fused_diff import fused_diff_mom
from .run import load_case
from .state import map_state

_REPO = Path(__file__).resolve().parents[1]
CACHE = _REPO / ".bench_cache"

METRIC = "rk3_step_urban_ibm_grid_points_per_s_per_chip"
WARM_STEPS = 3          # eager steps from the cold start before the build
PROFILE_STEPS = 5       # replays in the profiled run
DIV_BOUND = 1e-5        # max|div u| after the projection, float32
TOP_DIV_BOUND = 1e-2    # the top level of an open-x case (its inflow and
# outflow defect of the mean pressure mode sits there)
FACT_RANGE = (250.0, 350.0)     # facet temperatures of the energy balance, K


@dataclass(frozen=True)
class Cell:
    """A bench cell: the path (how the case is built), its size and the
    steps of a timed run."""
    path: str
    n: int
    steps: int


# the default cells in the order they run: bench.py's headline, the port's
# other 128^3 paths, flat 256^3 after them (its graph pool and static State
# take 4.5 GiB)
CELLS = {
    "urban_128": Cell("urban", 128, 50),
    "flat_128": Cell("flat", 128, 50),
    "urban_eb_128": Cell("urban_eb", 128, 50),
    "driven_128": Cell("driven", 128, 50),
    "dispersion_128": Cell("dispersion", 128, 50),
    "flat_256": Cell("flat", 256, 20),
}

# the host-CPU comparator of UDALES_BENCH_CPU=1 (bench.py's)
CPU_CELL = Cell("flat", 64, 10)

# case directories of the staged paths (experiment 900)
STAGE = {
    "urban": lambda n, root: cases.stage_urban(n, root),
    "urban_eb": lambda n, root: cases.stage_urban_eb(n, root),   # dtEB 2 s
    "driven": lambda n, root: cases.stage_urban_driven(n, root,
                                                       dtdriver=0.1),
    "dispersion": lambda n, root: cases.stage_urban_dispersion(n, root),
}


def build(path: str, n: int, seed: int = 43, dtype: str = "float32",
          device="cuda", root=None):
    """(Model, start State) of a cell's path at n^3: the flat ABL of
    ``entry._build`` and its ``_init_state(seed)``, or a staged case under
    `root` (default `CACHE`) through ``load_case`` and its
    ``cold_start(seed)``."""
    root = CACHE if root is None else Path(root)
    if path == "flat":
        model = entry._build(n, n, n, dtype, device=device)
        return model, entry._init_state(model, seed)
    model = load_case(STAGE[path](n, root), "900", dtype, device=device)
    return model, model.cold_start(seed=seed)


def max_divergence(grid, c) -> tuple[float, float]:
    """(max|div u| of the projected velocity `c`, the same over the top
    level alone).  Periodic directions wrap; an open x takes its outlet
    face from the prognostic plane ``c.bx.u`` (open y from ``c.by.v``),
    and the first number then leaves out the top level, where the
    inflow/outflow defect of the mean pressure mode sits."""
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


def _timed(fn, cuda: bool):
    """(fn(), its seconds): between CUDA events on the card, between host
    clock reads on the CPU."""
    if not cuda:
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def card_reading(index: int):
    """(SM clock MHz, memory clock MHz, power draw W) of card `index`, one
    ``nvidia-smi`` query; three Nones without nvidia-smi or a reading."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, timeout=60).stdout
        return tuple(float(x) for x in line.strip().split(","))
    except (OSError, subprocess.SubprocessError, ValueError):
        return None, None, None                 # no tool, or "[N/A]"


def time_cell(model, state, steps: int, runs: int):
    """Time `runs` runs of ``model.run(state, steps, graph=True)`` after the
    warm-up (`WARM_STEPS` eager steps from `state`, then the build of the
    compiled step), each run from the State the one before returned.
    On the card each run lies between CUDA events; on the CPU, where the
    compiled step runs its body eagerly, between host clock reads.  Both
    launch counts are set to 0 just before a run and read just after: on
    the card the path's variant (masked with an IBM) must launch 3 times a
    step and the other not at all; on the CPU neither launches.  Returns
    (numbers, the State of the last run)."""
    cuda = model.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(model.device)) if cuda \
        else (lambda: None)
    state = model.run(state, WARM_STEPS)
    step = model.step_jit()
    state = step(state)               # the build: one eager step + capture
    sync()
    before = card_reading(model.device.index or 0) if cuda else None
    masked = model.ibm is not None
    want = 3 * steps if cuda else 0
    stream = model.driver_stream
    eb = model.eb if state.fac is not None else None
    g = model.grid
    points = g.itot * g.jtot * g.ktot * steps
    seconds, peaks, refills, fires, sim_s = [], [], [], [], []
    launches = 0
    for _ in range(runs):
        r0 = stream.refills if stream is not None else 0
        t0, next0 = float(state.timee), (float(state.fac.tnextEB)
                                         if eb is not None else 0.0)
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(model.device)
        fused_diff_mom.launch_count = fused_diff_mom.masked_launch_count = 0
        state, sec = _timed(lambda: model.run(state, steps, graph=True),
                            cuda)
        counts = (fused_diff_mom.launch_count,
                  fused_diff_mom.masked_launch_count)
        own, other = counts[::-1] if masked else counts
        if own != want or other != 0:
            raise RuntimeError(
                f"kernel launches (unmasked, masked) = {counts} in {steps} "
                f"captured steps on {model.device.type}, expected {want} of "
                f"the {'masked' if masked else 'unmasked'} variant and none "
                f"of the other")
        launches += own
        seconds.append(sec)
        if cuda:
            peaks.append(torch.cuda.max_memory_allocated(model.device)
                         / 2 ** 30)
        sim_s.append(float(state.timee) - t0)
        if stream is not None:
            refills.append(stream.refills - r0)
        if eb is not None:
            fires.append(round((float(state.fac.tnextEB) - next0)
                               / model.cfg.eb.dtEB))
    ms = [1e3 * s / steps for s in seconds]
    rates = [points / s for s in seconds]
    out = dict(
        points_per_s=points * runs / sum(seconds),
        ms_per_step=1e3 * sum(seconds) / (steps * runs),
        points_per_s_median=statistics.median(rates),
        points_per_s_best=max(rates), points_per_s_worst=min(rates),
        ms_per_step_median=statistics.median(ms), ms_per_step_runs=ms,
        spread_pct=100.0 * (max(ms) - min(ms)) / statistics.median(ms),
        runs=runs, steps=steps, capture_s=step.capture_seconds,
        peak_gib=max(peaks) if cuda else None,
        variant="masked" if masked else "unmasked",
        launches_per_step=launches / (steps * runs), sim_s_per_run=sim_s,
        dt=float(state.dt), device=model.device.type)
    if cuda:
        keys = ("sm_clock_mhz", "mem_clock_mhz", "power_w")
        out.update(card_before=dict(zip(keys, before)),
                   card_after=dict(zip(keys, card_reading(
                       model.device.index or 0))))
    if stream is not None:
        out["refills_per_run"] = refills
    if eb is not None:
        out["eb_fires_per_run"] = fires
    return out, state


def profile_run(model, state, k: int = PROFILE_STEPS) -> dict:
    """One profiled ``model.run(state, k, graph=True)`` on the card, apart
    from the timed runs (``torch.profiler``, CPU and CUDA activities):
    the device's busy share (the union of the device activities' intervals
    over the run's host time, from a synchronize to a synchronize), the
    top device operations by time a step, and fused_diff_mom's kernels:
    device ms and count a step.  The compiled step must be built."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(model.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.run(state, k, graph=True)
        torch.cuda.synchronize(model.device)
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == cuda)
    busy_us, hi = 0.0, -float("inf")
    by_name = {}
    for s, e, name in dev:
        busy_us += max(0.0, e - max(s, hi))
        hi = max(hi, e)
        tot = by_name.setdefault(name, [0.0, 0])
        tot[0] += e - s
        tot[1] += 1
    kern = [v for name, v in by_name.items() if "fused_diff_mom" in name]
    fdm_us = sum(v[0] for v in kern)
    fdm_n = sum(v[1] for v in kern)
    if fdm_n != 3 * k:
        raise RuntimeError(f"the profile of {k} replays shows {fdm_n} "
                           f"fused_diff_mom kernels, expected {3 * k}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(busy_share=busy_us / wall_us,
                device_ms_per_step=sum(e - s for s, e, _ in dev) / 1e3 / k,
                fused_diff_mom_ms_per_step=fdm_us / 1e3 / k,
                fused_diff_mom_per_step=fdm_n / k,
                top_ops=[[name[:100], us / 1e3 / k, n / k]
                         for name, (us, n) in top])


def check_cell(model, state, out) -> None:
    """Raise unless the State of a cell is right: every floating leaf
    finite, dt > 0, max|div u| <= `DIV_BOUND` (with an open x over the
    interior, the top level <= `TOP_DIV_BOUND`), and with the energy
    balance the facet temperatures within `FACT_RANGE`.  Adds what it read
    to `out`."""
    bad = []
    map_state(lambda path, t: bad.append(".".join(map(str, path)))
              if t.is_floating_point() and not bool(torch.isfinite(t).all())
              else None, state)
    if bad:
        raise RuntimeError(f"non-finite State leaves: {bad}")
    if not float(state.dt) > 0:
        raise RuntimeError(f"dt = {float(state.dt)}")
    div, top = max_divergence(model.grid, state.c)
    out.update(max_div=div, top_div=top)
    open_x = state.c.bx is not None
    if not (div <= DIV_BOUND
            and top <= (TOP_DIV_BOUND if open_x else DIV_BOUND)):
        raise RuntimeError(f"max|div u| = {div:.3e} (top level {top:.3e}) "
                           f"beyond {DIV_BOUND:g}"
                           + (f" (top {TOP_DIV_BOUND:g})" if open_x else ""))
    if state.fac is not None:
        lo, hi = float(state.fac.T.min()), float(state.fac.T.max())
        out.update(facT_min=lo, facT_max=hi)
        if not FACT_RANGE[0] <= lo <= hi <= FACT_RANGE[1]:
            raise RuntimeError(f"facet temperatures {lo:.3f} .. {hi:.3f} K "
                               f"outside {FACT_RANGE}")


def run_cell(name: str, cell: Cell, runs: int, seed: int,
             device="cuda") -> dict:
    """Build, time, profile (on the card) and check one cell; returns its
    numbers and prints its table."""
    t0 = time.perf_counter()
    model, state = build(cell.path, cell.n, seed, device=device)
    stage_s = time.perf_counter() - t0
    out, state = time_cell(model, state, cell.steps, runs)
    check_cell(model, state, out)
    if model.device.type == "cuda":
        out.update(profile_run(model, state))
    g = model.grid
    out.update(grid=[g.itot, g.jtot, g.ktot], stage_s=stage_s)
    print_cell(name, out)
    return out


def print_cell(name: str, o: dict) -> None:
    runs = ", ".join(f"{x:.4f}" for x in o["ms_per_step_runs"])
    extra = "".join(f"; {k} {o[k]}" for k in ("refills_per_run",
                                               "eb_fires_per_run") if k in o)
    print(f"{name}: {'x'.join(map(str, o['grid']))} on {o['device']}, "
          f"{o['runs']} runs of {o['steps']} steps: "
          f"{o['points_per_s']:.6g} points/s ({o['ms_per_step']:.4f} "
          f"ms/step); median {o['points_per_s_median']:.6g}, best "
          f"{o['points_per_s_best']:.6g}; ms/step {runs} (spread "
          f"{o['spread_pct']:.2f}%); capture {o['capture_s']:.3f} s; "
          f"{o['variant']} launches {o['launches_per_step']:g} a step; "
          f"max|div u| {o['max_div']:.3e}, top {o['top_div']:.3e}{extra}",
          flush=True)
    if "card_before" in o:
        print(f"  nvidia-smi before the runs {o['card_before']}, after them "
              f"{o['card_after']}", flush=True)
    if "busy_share" in o:
        print(f"  peak {o['peak_gib']:.3f} GiB; profiled run: busy "
              f"{100 * o['busy_share']:.1f}%, device "
              f"{o['device_ms_per_step']:.4f} ms a step, fused_diff_mom "
              f"{o['fused_diff_mom_ms_per_step']:.4f} ms a step "
              f"({o['fused_diff_mom_per_step']:g} kernels); top device "
              f"operations, ms and count a step:", flush=True)
        for op, ms, n in o["top_ops"]:
            print(f"    {ms:9.4f} {n:7.1f}  {op}", flush=True)


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (the name from torch
    where nvidia-smi is missing), and the card count."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in line.split(",", 1))
    except FileNotFoundError:
        name, limit = torch.cuda.get_device_name(0), "not measured"
    return dict(name=name, power_limit=limit,
                count=torch.cuda.device_count())


def cpu_name() -> str:
    """The host CPU's model name (``/proc/cpuinfo``), else what
    ``platform`` knows, with the count of logical CPUs."""
    name = platform.processor() or platform.machine()
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                name = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    return f"{name} ({os.cpu_count()} logical CPUs)"


def parse(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m udales_tpu_torch.bench",
        description="grid-points/s of the captured RK3 step on one card")
    p.add_argument("--cell", action="append", choices=sorted(CELLS),
                   help="a cell to run (repeatable; default: all, in "
                   "their order)")
    p.add_argument("--runs", type=int, default=5,
                   help="timed runs a cell (default 5)")
    p.add_argument("--steps", type=int, default=None,
                   help="steps a run, for every cell (default: the cell's)")
    p.add_argument("--seed", type=int, default=43,
                   help="seed of the start fields (default 43)")
    args = p.parse_args(argv)
    if args.runs < 1 or (args.steps is not None and args.steps < 1):
        p.error("--runs and --steps take a positive count")
    return args


def cpu_main(args) -> dict:
    """``UDALES_BENCH_CPU=1``: `CPU_CELL`, the flat 64^3 case, on the host
    CPU (10 steps a run unless ``--steps``), the measured host
    comparator."""
    cell = Cell(CPU_CELL.path, CPU_CELL.n, args.steps or CPU_CELL.steps)
    o = run_cell("flat_64_cpu", cell, args.runs, args.seed, device="cpu")
    return {"metric": "rk3_step_grid_points_per_s_cpu_host",
            "value": o["points_per_s"], "unit": "points/s",
            "baseline": "measured:this-solver-on-host-cpu-64^3",
            "cpu": cpu_name(), "cells": {"flat_64_cpu": o}}


def main(argv=None) -> dict:
    args = parse(argv)
    if os.environ.get("UDALES_BENCH_CPU"):
        out = cpu_main(args)
        print(json.dumps(out))
        return out
    if not torch.cuda.is_available():
        raise RuntimeError("udales_tpu_torch.bench: no CUDA device (torch."
                           "cuda.is_available() is False); it measures the "
                           "card only (UDALES_BENCH_CPU=1 measures the host "
                           "CPU)")
    device = card()
    print(f"{device['name']}, {device['power_limit']}", flush=True)
    out = {"metric": METRIC, "value": None, "unit": "points/s"}
    cells = {}
    for name in args.cell or list(CELLS):
        cell = CELLS[name]
        if args.steps:
            cell = Cell(cell.path, cell.n, args.steps)
        cells[name] = run_cell(name, cell, args.runs, args.seed)
        out[name] = cells[name]["points_per_s"]
        # a Model and its compiled step refer to each other: collect them
        # before the next cell, or the graph's pool stays alive
        gc.collect()
        torch.cuda.empty_cache()
    if "urban_128" in cells:
        out["value"] = cells["urban_128"]["points_per_s"]
    out.update(cells=cells, device=device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
