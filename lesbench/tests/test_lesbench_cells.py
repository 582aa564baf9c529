"""Cells, configurations and per-layer metrics are files found by name: a
copy of the benchmark gains a cell, a configuration and a metric by new
files and new entries in BENCHMARK.json alone, and a run of the new cell
reports them."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap
import time

from lesbench import harness
from lesbench.harness import ROOT, cell_metrics
from lesbench.tests.lesbench_small import small_config, small_work


def test_new_cell_is_found_by_name(tmp_path):
    shutil.copytree(ROOT / "lesbench", tmp_path / "lesbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "lesbench").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = small_config("urban_cubes", 8)
    cfg.update(name="urban_tiny")
    (tmp_path / "lesbench/configs/urban_tiny.json").write_text(
        json.dumps(cfg))
    work = small_work("urban_128.step", config="urban_tiny",
                      steps_per_call=2, warm_steps=1)
    (tmp_path / "lesbench/workloads/urban_tiny.step.json").write_text(
        json.dumps(work))
    (tmp_path / "lesbench/metrics/steps_per_call.py").write_text(
        "def read(ctx):\n    return float(ctx['k'])\n")
    bench["configs"].append(dict(bench["configs"][0], name="urban_tiny"))
    bench["workloads"].append(dict(name="urban_tiny.step", config="urban_tiny",
                                   traffic="tiny", chips=1, why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("urban_tiny.step")
    bench["per_layer"].append(dict(
        name="steps_per_call", unit="steps", better="higher",
        source="program_counter", layer="test", moves="step_points_per_s",
        workloads=["urban_tiny.step"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    e2e, per = cell_metrics(bench, "urban_tiny.step")
    assert {m["name"] for m in e2e} >= {"step_points_per_s", "setup_s"}
    code = textwrap.dedent("""
        import json, time
        from lesbench import harness
        assert str(harness.HERE).startswith(%r), harness.HERE
        work = harness.load("workloads", "urban_tiny.step")
        cfg = harness.load("configs", work["config"])
        out = harness.run_cell(work, cfg, 11, 0.2, True, "cpu",
                               time.perf_counter())
        out["peak_bytes"] = None
        line = harness.result(harness.benchmark(), "urban_tiny.step", work,
                              out, True, dict(kind="cpu", power_limit=None))
        print(json.dumps(line["metrics"]))
    """ % str(tmp_path))
    env = {"PATH": "/usr/bin:/bin",
           "PYTHONPATH": f"{tmp_path}:{ROOT}"}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    metrics = json.loads(res.stdout.strip().splitlines()[-1])
    assert metrics["steps_per_call"] == {"value": 2.0, "unit": "steps"}
    after = {p: p.read_bytes() for p in before}
    assert after == before       # no file the benchmark had was edited


def test_urban_cubes_512_small_copy_is_correct(tmp_path):
    """The 512 x 512 x 128 cell's small copy, 64 x 64 x 16 with 8 x 8
    cubes of 4 cells, through a whole run on the CPU: its steps at that
    shape, its rate, and correct by the cell's own limits.  The call
    compared comes 200 steps after the cold start, as the cell's comes
    ~280 steps after it: in the first ~100 the float32 thl of the top
    level departs from float64 by up to 2e-4 of its range, in the
    reference's own float32 too (PERF.md section 2)."""
    work = small_work("urban_cubes_512.step", steps_per_call=2,
                      warm_steps=200)
    out = harness.run_cell(work, small_config("urban_cubes_512", 64),
                           2 ** 33 + 5, 0.3, False, "cpu",
                           time.perf_counter(), cache=tmp_path)
    out["peak_bytes"] = None
    line = harness.result(harness.benchmark(), "urban_cubes_512.step", work,
                          out, False, dict(kind="cpu", power_limit=None))
    assert out["shape"] == (64, 64, 16)
    assert set(line["checks"]) == set(work["limits"])
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["step_points_per_s"]["value"] > 0
    assert line["attempted"] == out["steps"] >= 2
