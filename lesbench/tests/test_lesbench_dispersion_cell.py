"""The dispersion cell (``dispersion_128.step``: Coceal's 2 x 2 cubes with
NO, NO2 and O3 from line sources and a stack, the chemistry and tree
blocks) through a whole run on the CPU, as its small copy."""
from __future__ import annotations

import time

from lesbench import harness
from lesbench.tests.lesbench_small import small_config, small_work

NEW = {"scalars_ms_per_step", "canopy_ms_per_step", "chem_ms_per_step"}


def test_dispersion_small_copy_is_correct(tmp_path):
    """The cell's configuration cut to 32^3 (cubes of 8 cells, the source
    rows and tree blocks scaled with it): its steps at that shape, its
    rate, correct by exactly the cell's own limits, and the three leaves
    of the scalar stack among the cell's per-layer metrics.  The call
    compared comes 100 steps after the cold start, past the float32 thl
    departure of the first steps that the urban cells' copies show too
    (PERF.md section 2)."""
    work = small_work("dispersion_128.step", steps_per_call=2,
                      warm_steps=100)
    out = harness.run_cell(work, small_config("urban_cubes_dispersion", 32),
                           2 ** 33 + 9, 0.3, False, "cpu",
                           time.perf_counter(), cache=tmp_path)
    out["peak_bytes"] = None
    bench = harness.benchmark()
    line = harness.result(bench, "dispersion_128.step", work, out, False,
                          dict(kind="cpu", power_limit=None))
    assert out["shape"] == (32, 32, 32)
    assert set(line["checks"]) == set(work["limits"])
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["step_points_per_s"]["value"] > 0
    assert line["attempted"] == out["steps"] >= 2
    e2e, per = harness.cell_metrics(bench, "dispersion_128.step")
    assert {m["name"] for m in e2e} >= {"step_points_per_s", "setup_s",
                                        "peak_mem_gib"}
    names = {m["name"] for m in per}
    assert NEW <= names
    # the cell reads what every step cell reads besides
    assert names - NEW == {m["name"] for m in harness.cell_metrics(
        bench, "urban_128.step")[1]}
