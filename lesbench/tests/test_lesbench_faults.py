"""A run with the timed path broken underneath comes out not correct: the
harness is driven on the CPU (past its look for a card) with the
program's ``Model.run(..., graph=True)`` replaced by a faulty one.  The
faults a step cell can have: a step that returns its State unchanged,
half of the domain left un-stepped, and one value altered where it is
produced.  (One chip: no exchange between chips to leave out.)"""
from __future__ import annotations

import time

import pytest
import torch

from lesbench import harness
from lesbench.tests.lesbench_small import small_config, small_work
from udales_tpu_torch import run as program_run


def _unchanged(real, model, state, n):
    return state.map(torch.clone)


def _half_left_out(real, model, state, n):
    out = real(model, state, n, graph=True)
    half = out.c.u.shape[0] // 2
    for name in ("u", "v", "w", "thl"):
        getattr(out.c, name)[:half] = getattr(state.c, name)[:half]
    return out


def _altered(real, model, state, n):
    out = real(model, state, n, graph=True)
    u = out.c.u
    u[u.shape[0] // 2, u.shape[1] // 2, u.shape[2] // 2] += \
        1e-3 * float(u.max() - u.min())
    return out


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "altered": _altered}


def _run(monkeypatch, tmp_path, config, cell, fault=None):
    if fault is not None:
        real = program_run.Model.run

        def broken(model, state, n, graph=False):
            if not graph:
                return real(model, state, n)
            return FAULTS[fault](real, model, state, n)
        monkeypatch.setattr(program_run.Model, "run", broken)
    work = small_work(cell, steps_per_call=2, warm_steps=1)
    out = harness.run_cell(work, small_config(config, SMALL.get(config, 16)),
                           2 ** 35 + 7, 0.3, False, "cpu",
                           time.perf_counter(), cache=tmp_path)
    out["peak_bytes"] = None
    line = harness.result(harness.benchmark(), cell, work, out, False,
                          dict(kind="cpu", power_limit=None))
    return line, out["gaps"]


STEP_CELLS = [("urban_cubes", "urban_128.step"),
              ("urban_cubes_driven", "driven_128.step"),
              ("urban_cubes_512", "urban_cubes_512.step")]
# cells along x of a configuration's small copy where not 16: the
# 512 x 512 x 128 array's is 64 x 64 x 16, 8 x 8 cubes of 4 cells
SMALL = {"urban_cubes_512": 64}


@pytest.mark.parametrize("config,cell", STEP_CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(monkeypatch, tmp_path, config, cell, fault):
    line, gaps = _run(monkeypatch, tmp_path, config, cell, fault)
    assert line["correct"] is False, gaps
    assert line["failed"] > 0


@pytest.mark.parametrize("config,cell", STEP_CELLS)
def test_sound_run_reads_far_below_the_faults(monkeypatch, tmp_path, config,
                                              cell):
    """The sound run's widest gap at 16^3 (64 x 64 x 16) on the CPU, two
    steps: the
    float32 program against the float64 reference, far under the altered
    value's 1e-3 of the field's range."""
    _, gaps = _run(monkeypatch, tmp_path, config, cell)
    assert max(gaps[f"{f}_gap"] for f in ("u", "v", "w")) < 1e-4, gaps


def _run_cell_line(tmp_path, trace=False):
    work = small_work("urban_128.run", warm_steps=1, traced_steps=3)
    work["namelist"]["OUTPUT"].update(tsample=0.5, tstatsdump=2.0,
                                      tfielddump=2.0)
    out = harness.run_cell(work, small_config("urban_cubes", 16),
                           2 ** 35 + 9, 4.0, trace, "cpu",
                           time.perf_counter(), cache=tmp_path)
    out["peak_bytes"] = None
    line = harness.result(harness.benchmark(), "urban_128.run", work, out,
                          trace, dict(kind="cpu", power_limit=None))
    return line, out["gaps"]


@pytest.mark.parametrize("fault", ["unchanged", "fielddump", "tdump",
                                   "tdump_zero_variance"])
def test_run_cell_fault_is_not_correct(monkeypatch, tmp_path, fault):
    """The production loop's faults: its step returns the State unchanged;
    the field dump writes an altered field; the statistics write an
    altered mean, or a variance of thl of zero."""
    from udales_tpu_torch import graph
    from udales_tpu_torch.io import fielddump, stats
    if fault == "unchanged":
        monkeypatch.setattr(graph.CompiledStep, "__call__",
                            lambda self, state: state)
    elif fault == "fielddump":
        real = fielddump._host
        monkeypatch.setattr(fielddump, "_host", lambda a: real(a) + 1e-3)
    else:
        real = stats.TDump._host_acc

        def altered(self):
            acc = real(self)
            if fault == "tdump":
                acc["u"] = acc["u"] * (1 + 1e-3)
            else:
                acc["thl2"] = acc["thl"] ** 2 / max(float(acc["n"]), 1.0)
            return acc
        monkeypatch.setattr(stats.TDump, "_host_acc", altered)
    line, gaps = _run_cell_line(tmp_path)
    assert line["correct"] is False, gaps


def test_run_cell_sound_writers_read_exactly(tmp_path):
    """The sound loop at 16^3 on the CPU: the field dump reads back exactly
    and the time means lie far under the altered mean's 1e-3."""
    _, gaps = _run_cell_line(tmp_path)
    assert gaps["fielddump_gap"] == 0.0
    assert max(gaps[f"tdump_{n}_gap"] for n in ("ut", "vt", "wt", "pt")) \
        < 1e-4, gaps


def test_run_cell_traced_line(tmp_path):
    """A traced run of the production loop profiles its steps and reports
    the traced stretch's seconds and busy seconds in ``device``, its
    per-layer metric, and every number compared (the limits are the
    128^3 cell's, so at 16^3 they are not held)."""
    line, gaps = _run_cell_line(tmp_path, trace=True)
    assert set(line["checks"]) == set(small_work("urban_128.run")["limits"])
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["device"]["window_s"] > 0
    assert "breakdown" in line
    assert set(line["metrics"]) == {"output_share.run"}


@pytest.mark.parametrize("config,cell", STEP_CELLS)
def test_start_from_another_seed_is_not_correct(monkeypatch, tmp_path,
                                                config, cell):
    """A program whose start is not the seed's (here the next seed's)."""
    cold = program_run.Model.cold_start
    monkeypatch.setattr(program_run.Model, "cold_start",
                        lambda self, seed=43, dt0=None: cold(self, seed + 1,
                                                             dt0))
    line, gaps = _run(monkeypatch, tmp_path, config, cell)
    assert gaps["start_gap"] > 0
    assert line["correct"] is False, gaps
