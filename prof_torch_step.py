"""Where the time of one RK3 step of the PyTorch port goes, on a CUDA card.

    python3 prof_torch_step.py [N ...]        (default: 128 256 urban128)

An N is a size n for the flat-ABL case at n^3 float32, urbann for the
urban building-array case (``cases.stage_urban``, staged into
.bench_cache/), urbanebn for the same array with the facet energy
balance (``cases.stage_urban_eb``), or urbandrvn for the same array driven
through an open x boundary by precursor planes
(``cases.stage_urban_driven``, records 0.1 s apart read 16 at a time), or
urbandispn for the same array as a street-canyon dispersion case
(``cases.stage_urban_dispersion``: three scalars, sources, chemistry,
trees; urbandisppuhpn with purifiers and heat pumps, urbandisponeeqnn with
the one-equation closure).  For each N it builds the case on the card, warms
up, times 10 steps with CUDA events, then traces 3 steps with
torch.profiler and prints the device-busy share of the traced wall time and
the kernels that take the most device time.  The full kernel table goes to
chiprun_out/prof_torch_step_<N>.txt.
For an urban case it then times each IBM hook of the substep alone (host
wall clock to a synchronize, and device launches counted by the profiler),
next to the masked diffusion kernel and the unmasked thermodynamics; with
the energy balance, also the wall functions as the third substep calls them
(live facet temperatures, per-facet sums) and the balance itself, ungated
(``FacetEB.update``) and gated (``maybe_update``); with a driver inlet,
also the window interpolation, the ghosts with the open-x context, the
open-x Poisson solve, the convective plane update and
``DriverStream.ensure`` with and without a refill; with the dispersion
case, also ``Vegetation.forcing``, the scalar part of a substep (kappa
ghosts, kappa advection and masked diffusion of the whole stack, the
sources), ``chem_update``, and ``Purifiers.apply`` and ``HeatPumps.apply``
of the variant with purifiers and heat pumps.  It also runs one step
under ``torch.cuda.set_sync_debug_mode("error")``, which raises on any host
synchronisation.  The
hand-written kernel's launches are read from its wrapper's counters: the
profiler of a single hook call has missed the ctypes launch before.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
OUT = Path(__file__).resolve().parent / "chiprun_out"


def build_case(case: str):
    """(model, start state) of a CASE on the card, float32."""
    if case.startswith("urban"):
        from udales_tpu_torch.cases import (stage_urban, stage_urban_driven,
                                            stage_urban_eb)
        from udales_tpu_torch.run import load_case
        cache = ROOT / ".bench_cache"
        if case.startswith("urbandrv"):
            path = stage_urban_driven(int(case[len("urbandrv"):]), cache,
                                      dtdriver=0.1)
        elif case.startswith("urbandisp"):
            from udales_tpu_torch.cases import stage_urban_dispersion
            rest = case[len("urbandisp"):]
            kw = {"puhp": dict(purifiers=True, heatpumps=True),
                  "oneeqn": dict(sgs="oneeqn")}
            variant = next((v for v in kw if rest.startswith(v)), None)
            path = stage_urban_dispersion(
                int(rest[len(variant or ""):]), cache,
                **kw.get(variant, {}))
        elif case.startswith("urbaneb"):
            path = stage_urban_eb(int(case[len("urbaneb"):]), cache)
        else:
            path = stage_urban(int(case[len("urban"):]), cache)
        model = load_case(path, "900", dtype="float32")   # on the card
        return model, model.cold_start(seed=43)
    from udales_tpu_torch import entry
    n = int(case)
    model = entry._build(n, n, n, "float32")
    return model, entry._init_state(model)


def hook_table(model, state, smi: str) -> list:
    """Lines of ms and device launches per call of each IBM hook, run alone
    on the fields of `state` (one substep makes one call of each)."""
    from udales_tpu_torch.ops import subgrid as sgs
    from udales_tpu_torch.ops.boundary import make_ghosts
    from udales_tpu_torch.ops.fused_diff import fused_diff_mom
    from udales_tpu_torch.ops.thermo import thermodynamics
    from udales_tpu_torch.run import _velocity_ghosts
    cfg, grid, ibm = model.cfg, model.grid, model.ibm
    c, m = state.c, state.m
    th = thermodynamics(c, cfg, grid, ibm.masks)
    openx = None
    if model.inlet is not None:
        openx = {"inlet": model._inlet_planes(state, c, state.ig),
                 "bx": c.bx}
    ekm, ekh, _ = sgs.closure(_velocity_ghosts(c, cfg, grid, openx), grid,
                              cfg, e12=c.e12, dthvdz=th.dthvdz, thl=c.thl,
                              thvs=cfg.bc.thls)
    g = make_ghosts(c, ekm, ekh, cfg, grid, openx=openx)
    pm = dict(u=ibm.pmask_u, v=ibm.pmask_v, w=ibm.pmask_w)
    z = torch.zeros_like
    hooks = {
        "thermodynamics, masked": lambda: thermodynamics(c, cfg, grid,
                                                         ibm.masks),
        "thermodynamics, unmasked": lambda: thermodynamics(c, cfg, grid),
        "ibm.wallfun": lambda: ibm.wallfun(g, z(c.u), z(c.v), z(c.w),
                                           z(c.thl), fac=state.fac),
        "ibm.ibmnorm": lambda: ibm.ibmnorm(c, m, c.u, c.v, c.w, c.thl,
                                           th.thl0av[0], dsv=m.sv),
        "fused_diff_mom, masked": lambda: fused_diff_mom(g, grid, pmasks=pm),
    }
    if model.eb is not None:
        fac, eb = state.fac, model.eb
        hooks.update({
            "ibm.wallfun, substep 3": lambda: ibm.wallfun(
                g, z(c.u), z(c.v), z(c.w), z(c.thl), fac=fac, need_fac=True),
            "FacetEB.update": lambda: eb.update(fac, state.timee),
            "FacetEB.maybe_update": lambda: eb.maybe_update(fac,
                                                            state.timee),
        })
    if model.driver_stream is not None:
        from udales_tpu_torch.ops.openbc import (convect_planes,
                                                 driver_window_planes)
        stream = model.driver_stream
        rhs = torch.randn_like(c.u)
        rhs -= rhs.mean()
        rk3coef, uout = state.dt / 3.0, th.u0av.sum() * 0.0 + 1.5

        def refill():
            stream.n0 = None        # forget the window: the next call reads
            return stream.ensure(state)
        hooks.update({
            "driver_window_planes": lambda: driver_window_planes(
                state.drv, state.timee),
            "make_ghosts, openx": lambda: make_ghosts(c, ekm, ekh, cfg, grid,
                                                      openx=openx),
            "PoissonSolver.solve, open x": lambda: model.pois.solve(rhs),
            "convect_planes": lambda: convect_planes(
                c.bx, c, grid, rk3coef, uout, openx["inlet"]),
            "DriverStream.ensure": lambda: stream.ensure(state),
            "DriverStream.ensure, refill": refill,
        })
    if model.vegetation is not None:
        hooks.update(dispersion_hooks(model, state, g, th))
    lines = [f"IBM hooks alone, {grid.itot}^3 float32 on {smi} "
             f"(ms per call to a synchronize, 20 calls; device launches "
             f"and device ms per call from the profiler; the hand-written "
             f"kernel's launches from its wrapper's counters, and where the "
             f"profiler missed them (*) its device ms from CUDA events "
             f"over 20 calls):"]
    counts = lambda: (fused_diff_mom.launch_count
                      + fused_diff_mom.masked_launch_count)
    for name, fn in hooks.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 20
        before = counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        hand = counts() - before
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = sum("fused_diff_mom_kernel" in e.name for e in ev)
        dev_ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        mark = ""
        if seen < hand:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fn()
            end.record()
            torch.cuda.synchronize()
            dev_ms, mark = start.elapsed_time(end) / 20, "*"
        lines.append(f"  {name:28s} {ms:9.4f} ms  {len(ev) - seen + hand:5d} "
                     f"launches ({hand} of the hand-written kernel)  "
                     f"{dev_ms:8.4f}{mark} device ms")
    return lines


def dispersion_hooks(model, state, g, th) -> dict:
    """The long-tail physics of the dispersion case as hooks: the canopy
    forcing, the scalar part of a substep, the chemistry, and the purifiers
    and heat pumps of the same case staged with them (their own Model)."""
    from udales_tpu_torch.cases import stage_urban_dispersion
    from udales_tpu_torch.ops import advection as adv
    from udales_tpu_torch.ops import subgrid as sgs
    from udales_tpu_torch.ops.boundary import ghost_sv
    from udales_tpu_torch.physics import chem_update
    from udales_tpu_torch.run import load_case
    cfg, grid, ibm = model.cfg, model.grid, model.ibm
    c, m = state.c, state.m
    z = torch.zeros_like
    dsv = z(c.sv)

    def scalars():
        gsv = ghost_sv(c.sv, cfg)
        d = adv.adv_kappa(gsv, g, grid)
        d = d + sgs.diff_c(gsv[:, 1:-1, 1:-1, 1:-1], g.ekh, grid,
                           M=ibm.pmask_c)
        return d + model.scalsources.field
    pm = load_case(stage_urban_dispersion(grid.itot, ROOT / ".bench_cache",
                                          purifiers=True, heatpumps=True),
                   "900", dtype="float32")
    return {
        "Vegetation.forcing": lambda: model.vegetation.forcing(
            m, grid, cfg, z(c.u), z(c.v), z(c.w), z(c.thl), None, dsv),
        "scalars of a substep": scalars,
        "chem_update": lambda: chem_update(c.sv, state.dt, cfg, ibm.masks.c),
        "Purifiers.apply": lambda: pm.purifiers.apply(m, c, z(c.u), z(c.v),
                                                      z(c.w), dsv),
        "HeatPumps.apply": lambda: pm.heatpumps.apply(m, c, z(c.w),
                                                      z(c.thl)),
    }


def profile_case(case: str, smi: str) -> None:
    model, state = build_case(case)
    n = model.grid.itot
    state = model.run(state, 3)
    torch.cuda.synchronize()

    steps = 10
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state = model.run(state, steps)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps

    traced = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = model.run(state, traced)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    per_kernel: dict = {}
    for e in events:
        tot, cnt = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    # host synchronisations the traced steps made: runtime calls that wait
    # for the device, and device-to-host copies (the window's closing
    # torch.cuda.synchronize() is one cudaDeviceSynchronize)
    waits = {name: sum(e.name == name for e in prof.events())
             for name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaEventSynchronize")}
    waits["Memcpy DtoH"] = sum("Memcpy DtoH" in e.name for e in events)
    table = [f"{case} ({n}^3 float32) on {smi}: {ms:.4f} ms/step (CUDA "
             f"events, {steps} steps); traced {traced} steps: wall "
             f"{wall_us:.1f} us, "
             f"device busy {busy_us:.1f} us = {busy_us / wall_us:.4f} of "
             f"wall, {len(events)} device activities "
             f"({len(events) / traced:.1f} per step)"]
    for name, (tot, cnt) in rows:
        table.append(f"{tot / traced:12.2f} us/step {cnt // traced:6d} "
                     f"calls/step  {tot / busy_us:7.4f}  {name[:110]}")
    hooks = hook_table(model, state, smi) if model.ibm is not None else []
    # any host synchronisation inside a step raises here
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = model.step(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    table.append("one step under torch.cuda.set_sync_debug_mode('error'): "
                 "no host synchronisation; in the traced steps: "
                 + ", ".join(f"{k} {v}" for k, v in waits.items())
                 + " (the window's closing synchronize is one "
                   "cudaDeviceSynchronize)")
    OUT.mkdir(exist_ok=True)
    (OUT / f"prof_torch_step_{case}.txt").write_text(
        "\n".join(hooks + table) + "\n")
    print("\n".join(hooks + table[:1] + table[-1:] + table[1:26]),
          flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("prof_torch_step: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for case in sys.argv[1:] or ["128", "256", "urban128"]:
        profile_case(case, smi)


if __name__ == "__main__":
    main()
