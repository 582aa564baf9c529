"""The readings the limits of ``correct`` are set from, for one cell, on
the card and at the cell's own size (never part of a benchmark run):

    python3 -m lesbench.control --workload NAME --seconds S --seeds N ...

For each seed, in one process: the program's Model starts from the seed,
warms up as a run does and takes a window of `S` seconds of the cell's
entry; then the reference follows the window's last call in float64 from
the State before it.  Three States are measured against the reference's
by ``check.gaps``: the program's (the lower readings), the control's (the
reference put in the program's place and computed in the precision below
the configuration's, the upper readings: the cell file's ``control``,
``tf32`` for float32 matrix products with TF32, ``bf16`` for float32
fields held in bfloat16), and the State before the call (a step that
returns its State unchanged).  A ``run`` cell adds its writers' numbers
(``reference.writers``), whose control is bfloat16.  Each of the three is
judged as a run judges the program (``harness.checks`` and
``harness.is_correct`` against the cell file's limits): the program has
to come out correct, the control and the unchanged State not.  One JSON
line a seed, then the largest program reading and the smallest control
reading of each number, and how often each came out correct.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import cases, harness
from .reference import check


def readings(work: dict, cfg: dict, seeds, seconds: float, device="cuda"):
    """One dict of readings a seed (see the module's docstring)."""
    sync = (lambda: torch.cuda.synchronize()) if device == "cuda" \
        else (lambda: None)
    case = cases.case_dir(cfg)
    k = work["steps_per_call"]
    model = ref = ctl = None
    rows = []
    for seed in seeds:
        if model is None:
            model, state = harness.build_program(cfg, seed, device, case)
        else:
            state = model.cold_start(seed=seed)
        started = start_gap(cfg, case, seed, state, device)
        state = model.run(state, work["warm_steps"])
        state = model.run(state, k, graph=True)
        sync()
        prev, state, chunks, window_s, _ = harness.step_window(
            model, state, k, seconds, False, sync)
        before, after = check.to_tree(prev), check.to_tree(state)
        del prev, state
        if ref is None:
            ref = check.build(cfg, case, "float64", device)
            ctl = check.build(cfg, case, "float32", device)
        want = check.advance(ref, before, k)
        got = check.advance(ctl, before, k, **CONTROLS[work["control"]])
        row = judged(work, started, seed=seed, steps=k * len(chunks),
                     window_s=window_s,
                     program=readings_of(after, want, ref.grid),
                     control=readings_of(got, want, ref.grid),
                     unchanged=readings_of(before, want, ref.grid))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


# a cell's control (its file's "control"): the reference in float32 with
# TF32 matrix products, or with its fields held in bfloat16
CONTROLS = {"tf32": dict(tf32=True), "bf16": dict(bf16=True)}


def readings_of(tree, want, grid) -> dict:
    """The numbers of a State tree against the reference's `want`, as a
    run reads them (``check.gaps``, the divergence, the non-finite
    leaves)."""
    out = check.gaps(tree, want)
    out["div_max"] = check.divergence(tree, grid)
    out["nonfinite_leaves"] = float(len(check.nonfinite(tree)))
    return out


def start_gap(cfg: dict, case, seed: int, state, device) -> float:
    """The program's start State against the reference's own from the
    seed, as a run reads it."""
    own = check.build(cfg, case, cfg["dtype"], device)
    return check.start_gap(check.fingerprint(state),
                           check.fingerprint(own.cold_start(seed=seed)))


def judged(work: dict, started: float, **row) -> dict:
    """`row` with each of its program, control and unchanged readings
    judged against the cell's limits as a run judges the program; all
    three start from the program's start State, whose gap is
    `started`."""
    for part in ("program", "control", "unchanged"):
        row[part]["start_gap"] = started
        row[f"{part}_correct"] = harness.is_correct(
            harness.checks(work, row[part]))
    return row


def run_readings(work: dict, cfg: dict, seeds, seconds: float,
                 device="cuda"):
    """The readings of a ``run`` cell, one process a seed's run (the
    production loop builds its own writers): the step numbers as for a
    step cell over the window's last step, and the writers' numbers, whose
    control computes the dumped fields and the time means in bfloat16."""
    import gc
    from .reference import writers
    case = cases.case_dir(cfg)
    ref = ctl = None
    rows = []
    for seed in seeds:
        out, model, prev, state = harness.run_run_cell(
            work, cfg, seed, seconds, False, device, time.perf_counter(),
            case)
        started = check.start_gap(out["start"], check.fingerprint(check.build(
            cfg, case, cfg["dtype"], device).cold_start(seed=seed)))
        before, after = check.to_tree(prev), check.to_tree(state)
        del model, prev, state
        gc.collect()
        if ref is None:
            ref = check.build(cfg, case, "float64", device)
            ctl = check.build(cfg, case, "float32", device)
        want = check.advance(ref, before, 1)
        control = readings_of(check.advance(
            ctl, before, 1, **CONTROLS[work["control"]]), want, ref.grid)
        if out["dump"] is not None:
            control["fielddump_gap"] = max(
                float((t.bfloat16().double() - t.double()).abs().max())
                for k, t in out["dump"].items() if k != "t")
        if out["intervals"]:
            control.update(writers.tdump_gaps(
                None, out["columns"], out["intervals"][-1][1],
                dtype=torch.bfloat16))
        program = readings_of(after, want, ref.grid)
        program.update(harness.writer_gaps(out))
        # the unchanged State's writers are the program's
        unchanged = dict(program, **readings_of(before, want, ref.grid))
        control = dict(program, **control)
        row = judged(work, started, seed=seed, steps=out["steps"],
                     window_s=out["window_s"], program=program,
                     control=control, unchanged=unchanged)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def summary(rows) -> dict:
    """The largest program reading and the smallest control reading of
    each number over the seeds, and the seeds on which each side came out
    correct."""
    names = rows[0]["program"]
    get = lambda r, part, n: r[part].get(n, float("nan"))
    out = {n: dict(program_max=max(get(r, "program", n) for r in rows),
                   control_min=min(get(r, "control", n) for r in rows),
                   unchanged_min=min(get(r, "unchanged", n) for r in rows))
           for n in names}
    out["correct"] = {part: sum(r[f"{part}_correct"] for r in rows)
                      for part in ("program", "control", "unchanged")}
    out["seeds"] = len(rows)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m lesbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("lesbench.control: no CUDA device", file=sys.stderr)
        return 2
    work = harness.load("workloads", args.workload)
    cfg = harness.load("configs", work["config"])
    t0 = time.perf_counter()
    fn = run_readings if work["entry"] == "run" else readings
    rows = fn(work, cfg, args.seeds, args.seconds)
    print(json.dumps(dict(workload=args.workload, seconds=time.perf_counter()
                          - t0, summary=summary(rows))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
