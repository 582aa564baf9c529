"""The import guard: the harness drives a run with JAX and the JAX package
unimportable, judged by whole top-level name; the command refuses without
a card and prints no result."""
from __future__ import annotations

import shutil
import subprocess
import sys
import textwrap

from lesbench import harness
from lesbench.harness import ROOT
from lesbench.tests.test_lesbench_reference import BLOCKER


def test_run_without_jax_or_the_jax_package(tmp_path):
    code = BLOCKER.format(blocked=["jax", "jaxlib", "flax", "udales_tpu"]) \
        + textwrap.dedent(f"""
        import sys, time
        from pathlib import Path
        from lesbench import harness
        from lesbench.tests.lesbench_small import small_config, small_work
        work = small_work("urban_128.step", steps_per_call=2, warm_steps=1)
        out = harness.run_cell(work, small_config("urban_cubes", 8), 3, 0.2,
                               True, "cpu", time.perf_counter(),
                               cache=Path({str(tmp_path)!r}))
        assert out["steps"] >= 2 and "span" in out
        assert harness.forbidden_modules() == [], harness.forbidden_modules()
        assert "udales_tpu_torch" in sys.modules
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "udales_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "udales_tpu.config", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax", "udales_tpu"]


def _command(cwd):
    return subprocess.run(
        [sys.executable, "-m", "lesbench", "--workload", "urban_128.step",
         "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_command_refuses_without_a_card():
    res = _command(ROOT)
    assert res.returncode != 0
    assert res.stdout == ""


def test_command_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "lesbench", tmp_path / "lesbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _command(tmp_path)
    assert res.returncode != 0
    assert res.stdout == ""
