"""The benchmark of udales_tpu_torch: one cell, run once.

    python3 -m lesbench --workload NAME --seed N --seconds S --trace 0|1

A cell is a file ``workloads/<NAME>.json``: its configuration (a file
``configs/<config>.json``), the entry its window drives, the end-to-end
metric its window's rate is reported as (``rate``), that entry's
parameters, its control and the limits of ``correct``.  The metrics a
cell reports are those ``BENCHMARK.json`` lists for it; a per-layer
metric is read by ``metrics/<metric>.py``.  So a new cell, configuration
or per-layer metric is a new file, found by its name.

A run: refuse without a card; set up (stage the case once per checkout,
load it on the card, start from the seed, warm up the path's shapes); take
``--seconds`` of the entry; read the peak memory; hand the program's State
from before the window's last call and after it to the reference, which
follows that call's steps in float64 and measures the gap (``correct``);
refuse if JAX or the JAX package was loaded; print the result as the last
line.  ``--trace 1`` profiles a span of the window and reports the
per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".lesbench_cache"
# top-level module names no run may load (compared whole: the program's
# own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "udales_tpu")
GIB = 2 ** 30


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = HERE / kind / f"{name}.json"
    if not path.exists():
        have = sorted(p.stem for p in (HERE / kind).glob("*.json"))
        raise SystemExit(f"lesbench: no {kind[:-1]} {name!r} (have: "
                         f"{', '.join(have)})")
    return json.loads(path.read_text())


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end metrics, per-layer metrics) ``BENCHMARK.json`` gives the
    cell: an end-to-end metric without ``workloads`` is every cell's; a
    per-layer metric without it is every cell's that reports the metric it
    moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of `FORBIDDEN`."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def read_metric(name: str, ctx: dict):
    """The per-layer metric `name` as ``metrics/<name>.py``'s ``read(ctx)``
    gives it: a number, or None where the run had nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "lesbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def card() -> dict:
    """The card's name from torch and its power limit from nvidia-smi."""
    import torch
    limit = "not measured"
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=60).stdout.strip()
        limit = line.split(",", 1)[1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return dict(kind=torch.cuda.get_device_name(0), power_limit=limit)


# -- the program's side -------------------------------------------------------

def build_program(cfg: dict, seed: int, device, case):
    """(Model, start State) of the program for a configuration: the staged
    case directory `case` through ``run.load_case`` and
    ``cold_start(seed)``."""
    from udales_tpu_torch.run import load_case
    model = load_case(case, "900", cfg["dtype"], device=device)
    return model, model.cold_start(seed=seed)


def variant(model) -> str:
    return "masked" if model.ibm is not None else "unmasked"


class Span:
    """A profiled stretch inside the window: its host seconds, from a
    synchronize to a synchronize, and the device's and host's activities
    (times in microseconds on the profiler's clock).  It starts when made
    and ends at `stop`; `overhead_s` is the host seconds the profiler's own
    start and stop took, outside the stretch."""

    def __init__(self, sync):
        from torch.profiler import ProfilerActivity, profile
        self.sync, self.seconds = sync, None
        sync()
        c0 = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()
        self.overhead_s = self.t0 - c0

    def stop(self):
        self.sync()
        c0 = time.perf_counter()
        self.seconds = c0 - self.t0
        self.prof.stop()
        self.overhead_s += time.perf_counter() - c0

    def events(self):
        """(device activities, host activities), each a sorted list of
        (start, end, name); read once the window has closed."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        device, host = [], []
        for e in self.prof.events():
            item = (e.time_range.start, e.time_range.end, e.name)
            (device if e.device_type == cuda else host).append(item)
        return sorted(device), sorted(host)


def read_span(span: Span, replays: int, top: int = 10) -> dict:
    """What the metric readers take from a profiled span: busy seconds
    (the union of the device activities' intervals), device seconds and
    count by operation name, the longest idle gaps between device
    activities labelled by the innermost host activity over the gap's
    middle, and the span's host seconds."""
    device, host = span.events()
    busy_us, hi = 0.0, None
    by_name, gaps = {}, []
    for s, e, name in device:
        if hi is not None and s > hi:
            gaps.append((s - hi, hi, s))
        busy_us += max(0.0, e - max(s, hi if hi is not None else s))
        hi = e if hi is None else max(hi, e)
        tot = by_name.setdefault(name, [0.0, 0])
        tot[0] += (e - s) / 1e6
        tot[1] += 1
    gaps.sort(reverse=True)
    labelled = []
    for length, g0, g1 in gaps[:top]:
        mid = 0.5 * (g0 + g1)
        over = [(s, name) for s, e, name in host if s <= mid <= e]
        labelled.append([max(over)[1] if over else "host: nothing traced",
                         length / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    host_by = {}
    for s, e, name in host:
        tot = host_by.setdefault(name, [0.0, 0])
        tot[0] += (e - s) / 1e6
        tot[1] += 1
    host_ops = sorted(host_by.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(replays=replays, window_s=span.seconds, busy_s=busy_us / 1e6,
                host_ops=[[k, v[0], v[1]] for k, v in host_ops],
                ops={k: v for k, v in ops}, n_ops=len(device),
                device_ops=[[k, v[0]] for k, v in ops[:top]],
                idle_gaps=labelled)


def step_window(model, state, k: int, seconds: float, trace: bool, sync):
    """The window of a ``step`` cell: calls of ``model.run(state, k,
    graph=True)`` back to back, each timed to its synchronize, until
    `seconds` have passed.  With `trace` the first call that starts after
    half the window, or that would end it, is profiled, and the window
    lasts until one has been; the profiler's own start and stop are left
    out of its seconds.  Returns
    (the State before the last call, the State after it, the calls'
    seconds, the window's seconds, the Span or None)."""
    chunks, span = [], None
    t0 = time.perf_counter()

    def clock():        # the window's seconds, less the profiler's own
        return time.perf_counter() - t0 - (span.overhead_s if span else 0.0)
    while True:
        prev = state
        now = clock()
        last = chunks[-1] if chunks else 0.0
        if trace and span is None and (now >= seconds / 2
                                       or now + last >= seconds):
            span = Span(sync)
            state = model.run(prev, k, graph=True)
            span.stop()
            chunks.append(span.seconds)
        else:
            c0 = time.perf_counter()
            state = model.run(prev, k, graph=True)
            sync()
            chunks.append(time.perf_counter() - c0)
        if clock() >= seconds and (span or not trace):
            break
    return prev, state, chunks, clock(), span


def run_step_cell(work: dict, cfg: dict, seed: int, seconds: float,
                  trace: bool, device, t_start: float, case=None):
    """Set up and measure a ``step`` cell; returns (what the rest of the
    run reads, the Model, the State before the window's last call, the
    State after it)."""
    import torch
    from .reference import check
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize()) if cuda else (lambda: None)
    k = work["steps_per_call"]
    model, state = build_program(cfg, seed, device, case)
    start = check.fingerprint(state)
    state = model.run(state, work["warm_steps"])
    state = model.run(state, k, graph=True)      # capture, then k replays
    sync()
    setup_s = time.perf_counter() - t_start
    prev, state, chunks, window_s, span = step_window(
        model, state, k, seconds, trace, sync)
    steps = k * len(chunks)
    g = model.grid
    points = g.itot * g.jtot * g.ktot
    out = dict(setup_s=setup_s, window_s=window_s, steps=steps,
               points=points, chunks=chunks, k=k, start=start,
               shape=(g.itot, g.jtot, g.ktot), variant=variant(model),
               itemsize=torch.tensor([], dtype=g.torch_dtype).element_size(),
               rates={work["rate"]: points * steps / window_s})
    if span is not None:
        out["span"] = read_span(span, k)
    return out, model, prev, state


def run_cell(work: dict, cfg: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float, cache: Path = CACHE) -> dict:
    """One run of a cell on `device` ("cuda", or "cpu" in the tests):
    set-up, window, peak memory, and the reference's check of the window's
    last call.  Returns the numbers `result` turns into the last line."""
    import torch
    from . import cases
    from .reference import check
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    case = cases.case_dir(cfg, cache)
    entry = ENTRIES[work["entry"]]
    out, model, prev, state = entry(work, cfg, seed, seconds, trace, device,
                                    t_start, case)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if device == "cuda" else None)
    # the program's outputs go to the host; its Model and States are freed
    # before the reference runs on the device
    before, after = check.to_tree(prev), check.to_tree(state)
    del model, prev, state
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()     # the reference's own peak
    t0 = time.perf_counter()
    ref_model = check.build(cfg, case, "float64", device)
    ref = check.advance(ref_model, before, out["check_steps"]
                        if "check_steps" in out else out["k"])
    gaps = check.gaps(after, ref)
    gaps["div_max"] = check.divergence(after, ref_model.grid)
    del ref_model
    # the start, checked by itself: the reference's own from the seed, in
    # the configuration's dtype on the same device
    own = check.build(cfg, case, cfg["dtype"], device)
    gaps["start_gap"] = check.start_gap(
        out.pop("start"), check.fingerprint(own.cold_start(seed=seed)))
    del own
    gaps["nonfinite_leaves"] = float(len(check.nonfinite(after)))
    if work["entry"] == "run":
        gaps.update(writer_gaps(out))
    out["reference_s"] = time.perf_counter() - t0
    out["reference_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if device == "cuda" else None)
    out["gaps"] = gaps
    return out


def writer_gaps(out: dict) -> dict:
    """The writers' numbers of a ``run`` cell (``reference.writers``): the
    last field dump against the fields it was given, the last tdump record
    against the means of its samples; inf where the window wrote none.
    The run's temporary directory goes afterwards."""
    from .reference import writers
    d, exp = out["outdir"], out["exp"]
    try:
        gaps = dict(fielddump_gap=float("inf"))
        if out["dump"] is not None:
            gaps["fielddump_gap"] = writers.fielddump_gap(
                d / f"fielddump.{exp}.nc", out["dump"])
        if out["intervals"]:
            _, samples = out["intervals"][-1]
            gaps.update(writers.tdump_gaps(d / f"tdump.{exp}.nc",
                                           out["columns"], samples))
        else:
            gaps.update({f"tdump_{n}_gap": float("inf")
                         for n in writers.TDUMP + ("thlpthlpt",)})
    finally:
        out.pop("tmp").cleanup()
    for key in ("dump", "intervals", "outdir"):
        out.pop(key)
    return gaps


class RunProbe:
    """The benchmark's hooks on one ``Simulation``, set on the instance
    (the program is not touched): the window's clock and stop, the host
    seconds of the output events, the State before the window's last
    step, the fields handed to the last field dump, a few columns of
    every sample the time-averaged statistics take, and with `traced` a
    Span over that many steps of the loop (each with the outputs after
    it) from the first step that starts after half the window; the
    window then lasts until the Span has ended, and the profiler's own
    start and stop (seconds) are left out of its clock."""

    def __init__(self, sim, seconds: float, columns, traced: int = 0,
                 sync=lambda: None):
        import torch
        self.sim, self.seconds = sim, seconds
        self.span, self.traced = None, 0
        self.ii, self.jj = columns
        self.t0 = self.window_s = None
        self.prev = self.dump = None
        self.steps = 0
        self.output_s, self.writes = 0.0, []
        self.samples, self.intervals = [], []
        # the probe's copies go to the host, so that they stay out of the
        # program's peak memory
        self.copy = lambda t: t.detach().to("cpu", copy=True)
        sentinel = sim.outdir / f"exit_now.{sim._exp()}"
        step, outputs, restart = sim.step, sim._outputs, sim._write_restart

        def timed_step(state):
            now = self.clock()
            if self.tracing() and self.traced == traced:
                self.span.stop()
            if traced and self.span is None and now >= seconds / 2:
                self.span = Span(sync)
            if self.tracing():
                self.traced += 1
            if (self.prev is None and now >= seconds
                    and (not traced or self.span is not None)
                    and not self.tracing()):
                self.prev = state.map(self.copy)
                sentinel.touch()
            return step(state)

        def timed_outputs(*args):
            c0 = time.perf_counter()
            out = outputs(*args)
            dt = time.perf_counter() - c0
            if self.window_s is None:
                self.output_s += dt
                if dt >= 0.05:
                    self.writes.append(round(dt, 4))
            return out

        def stop_restart(state):
            if self.prev is not None and self.window_s is None:
                self.window_s = self.clock()
                self.steps = sim.ntrun
            return restart(state)

        sim.step, sim._outputs = timed_step, timed_outputs
        sim._write_restart = stop_restart
        if sim.fielddump is not None:
            dump = sim.fielddump.dump

            def kept_dump(state, th=None, t=None):
                c = state.c
                self.dump = dict(t=t, u=self.copy(c.u), v=self.copy(c.v),
                                 w=self.copy(c.w), thl=self.copy(c.thl))
                return dump(state, th, t)
            sim.fielddump.dump = kept_dump
        if sim.tdump is not None:
            acc, write = sim.tdump._acc, sim.tdump.write

            def sampled(a, state, masks=None):
                c = state.c
                self.samples.append(torch.stack([
                    f[self.ii, self.jj, :c.u.shape[2]]
                    for f in (c.u, c.v, c.w, c.thl, state.pres)]))
                return acc(a, state, masks)

            def written(t):
                self.intervals.append((t, self.samples))
                self.samples = []
                return write(t)
            sim.tdump._acc, sim.tdump.write = sampled, written

    def clock(self) -> float:
        """Seconds since the window opened, less the profiler's own."""
        paused = self.span.overhead_s if self.span is not None else 0.0
        return time.perf_counter() - self.t0 - paused

    def tracing(self) -> bool:
        """Whether the Span has started and not ended."""
        return self.span is not None and self.span.seconds is None


def run_run_cell(work: dict, cfg: dict, seed: int, seconds: float,
                 trace: bool, device, t_start: float, case=None):
    """Set up and measure a ``run`` cell: the production loop
    ``Simulation.run`` with the writers the cell's file switches on, on a
    copy of the case in a temporary directory, stopped by the
    ``exit_now.<exp>`` sentinel once `seconds` have passed.  Returns as
    `run_step_cell` does; the State before is that of the last step."""
    import numpy as np
    import torch
    from udales_tpu_torch.sim import Simulation
    from .reference import check
    from .reference.les.cases import with_namelist
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize()) if cuda else (lambda: None)
    tmp = tempfile.TemporaryDirectory(prefix="lesbench-run-")
    root = Path(tmp.name)
    run_case = with_namelist(case, root / "case", **work["namelist"])
    model, state = build_program(cfg, seed, device, run_case)
    start = check.fingerprint(state)
    state = model.run(state, work["warm_steps"])
    state = model.run(state, 1, graph=True)      # capture, then 1 replay
    sync()
    sim = Simulation(model, root / "out")
    g = model.grid
    rng = np.random.default_rng(seed)
    ncol = work["stat_columns"]
    columns = (torch.as_tensor(rng.integers(0, g.itot, ncol), device=device),
               torch.as_tensor(rng.integers(0, g.jtot, ncol), device=device))
    probe = RunProbe(sim, seconds, columns,
                     traced=work["traced_steps"] if trace else 0, sync=sync)
    setup_s = time.perf_counter() - t_start
    probe.t0 = time.perf_counter()
    state = sim.run(state, runtime=work["runtime"])
    sync()
    window_s = probe.window_s
    points = g.itot * g.jtot * g.ktot
    written = sum(f.stat().st_size for f in (root / "out").rglob("*")
                  if f.is_file())
    out = dict(setup_s=setup_s, window_s=window_s, steps=probe.steps,
               points=points, chunks=[window_s], k=probe.steps, start=start,
               check_steps=1, shape=(g.itot, g.jtot, g.ktot),
               variant=variant(model), itemsize=4,
               rates={work["rate"]: points * probe.steps / window_s},
               output_s=probe.output_s, writes=probe.writes,
               bytes_written=written, tmp=tmp, outdir=root / "out",
               exp=sim._exp(), columns=[c.cpu() for c in columns],
               dump=probe.dump, intervals=probe.intervals)
    if probe.span is not None:
        out["span"] = read_span(probe.span, probe.traced)
    return out, model, probe.prev, state


ENTRIES = {"step": run_step_cell, "run": run_run_cell}


def checks(work: dict, gaps: dict) -> dict:
    """Each number the cell's file gives a limit for, with its limit (a
    number the run could not read counts as inf)."""
    return {name: dict(value=gaps.get(name, float("inf")), limit=limit)
            for name, limit in work["limits"].items()}


def is_correct(cmp: dict) -> bool:
    """Whether every number `checks` compared lies within its limit."""
    return all(c["value"] <= c["limit"] for c in cmp.values())


def result(bench: dict, name: str, work: dict, out: dict, trace: bool,
           dev: dict) -> dict:
    """The last line: correct, attempted and failed steps, the cell's
    metrics (end-to-end, or per-layer with `trace`), the device, the
    breakdown of a traced run, and the numbers compared with their
    limits."""
    e2e, per = cell_metrics(bench, name)
    cmp = checks(work, out["gaps"])
    correct = is_correct(cmp)
    k = out.get("check_steps", out["k"])
    metrics = {}
    if not trace:
        values = dict(out["rates"], setup_s=out["setup_s"],
                      peak_mem_gib=(out["peak_bytes"] / GIB
                                    if out["peak_bytes"] is not None
                                    else None))
        for m in e2e:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = dict(value=values[m["name"]],
                                          unit=m["unit"])
    else:
        ctx = dict(out, power_limit=dev.get("power_limit"))
        for m in per:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    device = dict(platform="gpu", kind=dev["kind"], count=1,
                  memory_peak_bytes=out["peak_bytes"])
    line = dict(correct=correct, attempted=out["steps"],
                failed=0 if correct else k, metrics=metrics, device=device)
    if trace and "span" in out:
        sp = out["span"]
        device.update(busy_s=sp["busy_s"], window_s=sp["window_s"])
        line["breakdown"] = dict(device_ops=sp["device_ops"],
                                 idle_gaps=sp["idle_gaps"])
    line["card"] = dev.get("power_limit")
    line["checks"] = cmp
    return line


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m lesbench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    work = load("workloads", args.workload)
    cfg = load("configs", work["config"])
    bench = benchmark()
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), 1)
    # the program's kernel and cuFFT/JIT caches stay inside the checkout
    os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "nv"))
    import torch
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"lesbench: the cell {args.workload} needs {chips} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 2
    out = run_cell(work, cfg, args.seed, args.seconds, bool(args.trace),
                   "cuda", t_start)
    # nvidia-smi only once the window has closed
    dev = card()
    print(f"lesbench: {args.workload} seed {args.seed} on {dev['kind']}, "
          f"power limit {dev['power_limit']}", file=sys.stderr, flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"lesbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    report(args.workload, out)
    line = result(bench, args.workload, work, out, bool(args.trace), dev)
    print("readings " + " ".join(f"{k} {v!r}" for k, v in out["gaps"].items()),
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def report(name: str, out: dict) -> None:
    """Earlier lines of the output: the window's calls in ms a step (both
    speeds show there), the set-up and the reference's seconds, and the
    reference's own peak on the card."""
    k = out["k"]
    ms = [1e3 * s / k for s in out["chunks"]]
    print(f"{name}: {out['steps']} steps in {out['window_s']:.4f} s, "
          f"set-up {out['setup_s']:.4f} s, reference {out['reference_s']:.3f}"
          f" s; ms/step of the {len(ms)} calls: median "
          f"{statistics.median(ms):.4f}, min {min(ms):.4f}, max "
          f"{max(ms):.4f}")
    if out.get("reference_peak_bytes") is not None:
        print(f"reference peak {out['reference_peak_bytes']} bytes")
    print("calls ms/step: " + " ".join(f"{x:.3f}" for x in ms))
    if "span" in out:
        print("host activities in the traced call (name, s, count): "
              + json.dumps(out["span"]["host_ops"]))
    if "writes" in out:
        print(f"output events of 0.05 s or more (s): {out['writes']}; "
              f"{out['output_s']:.4f} s in the output events; "
              f"{out['bytes_written']} bytes written")
