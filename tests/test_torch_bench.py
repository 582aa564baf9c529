"""The port's bench, ``udales_tpu_torch/bench.py`` (``python -m
udales_tpu_torch.bench``), on the CPU: its staging byte for byte against
``bench.py``'s, its timed runner against the eager ``Model.run`` (bit for
bit) and udales_tpu's ``Model.run`` (``lax.scan``, 1e-8), the JSON line of
the host-CPU comparator, no number without a card, no JAX, and checks
that end the command.  The test marked ``cuda`` runs the urban 32^3 cell
through ``main`` on the card and skips without one.  JAX and the JAX
package are imported only inside the tests that need them, so on the
card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_bench.py
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from udales_tpu_torch import bench, entry
from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
from udales_tpu_torch.ops.fused_diff import FusedDiffMom, fused_diff_mom

REPO = Path(__file__).resolve().parents[1]
N = 16
STEPS, RUNS = 2, 2
TOTAL = bench.WARM_STEPS + 1 + RUNS * STEPS     # warm-up, build, the runs
RTOL = 1e-8     # tests/test_torch_graph.py: torch.fft against dense DFTs


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file: the suite runs files in parallel
    processes, and each one taking every core makes all of them crawl."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_cpu():
    """JAX on the CPU in float64, as tests/conftest.py sets it up (the
    file may run without it)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def files(case):
    return {p.relative_to(case).as_posix(): p.read_bytes()
            for p in sorted(case.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("case", ["urban"])
def test_staging_is_bench_py_staging(tmp_path, monkeypatch, case):
    """The bench's staged urban 16^3 case is bench.py's, file for file and
    byte for byte."""
    jax_cpu()
    import bench as jbench
    monkeypatch.setattr(jbench, "CACHE", tmp_path / "jax")
    want = jbench._stage_urban(N)
    got = bench.STAGE[case](N, tmp_path / "port")
    assert got.name == want.name
    a, b = files(got), files(want)
    assert sorted(a) == sorted(b) and len(a) > 3
    for k in b:
        assert a[k] == b[k], k


def flat_case():
    from test_torch_graph import flat_start
    model = entry._build(N, N, N, "float64", device="cpu")
    return model, flat_start(model)


def urban_case(root, path="urban"):
    return bench.build(path, N, dtype="float64", device="cpu", root=root)


@pytest.mark.parametrize("path", ["flat", "urban", "urban_eb", "driven",
                                  "dispersion"])
def test_runner_equals_eager_run(tmp_path, path):
    """`time_cell` on the CPU (the compiled step runs its body eagerly)
    ends where the eager Model.run of the same start ends after the same
    steps, bit for bit, on every staged path of the bench; the window
    refills and balance fires it reports a run are the eager chain's, and
    no kernel launches."""
    make = flat_case if path == "flat" else lambda: urban_case(tmp_path,
                                                               path)
    steps, runs = 4, 3        # a refill and fires of the balance in them
    model, start = make()
    out, got = bench.time_cell(model, start, steps, runs)
    ref_model, want = make()
    want = ref_model.run(want, bench.WARM_STEPS + 1)
    stream, refills, fires = ref_model.driver_stream, [], []
    for _ in range(runs):
        r0 = stream.refills if stream is not None else 0
        t0 = float(want.fac.tnextEB) if want.fac is not None else 0.0
        want = ref_model.run(want, steps)
        if stream is not None:
            refills.append(stream.refills - r0)
        if want.fac is not None:
            fires.append(round((float(want.fac.tnextEB) - t0)
                               / ref_model.cfg.eb.dtEB))
    from test_torch_graph import leaves
    g, w = leaves(state_to_numpy(got)), leaves(state_to_numpy(want))
    assert g.keys() == w.keys()
    for k, v in w.items():
        assert np.array_equal(g[k], v), k
    assert model.step_jit().replays == runs * steps
    assert out["runs"] == runs and len(out["ms_per_step_runs"]) == runs
    assert out["launches_per_step"] == 0 and out["device"] == "cpu"
    assert out["points_per_s_best"] >= out["points_per_s_median"] > 0
    # the rate is all the points over all the seconds of the runs
    seconds = sum(out["ms_per_step_runs"]) * steps / 1e3
    assert out["points_per_s"] == pytest.approx(N ** 3 * steps * runs
                                                / seconds, rel=1e-12)
    assert out["points_per_s_best"] >= out["points_per_s"] \
        >= out["points_per_s_worst"]
    assert out["variant"] == ("unmasked" if path == "flat" else "masked")
    assert out.get("refills_per_run", []) == refills
    assert out.get("eb_fires_per_run", []) == fires
    assert sum(refills) >= (path == "driven")
    assert sum(fires) >= (path == "urban_eb")
    bench.check_cell(model, got, out)
    assert out["max_div"] <= bench.DIV_BOUND


@pytest.mark.parametrize("path", ["flat", "urban"])
def test_runner_matches_reference_run(tmp_path, path):
    """`time_cell` from udales_tpu's initial State (carried over with
    convert) against udales_tpu's jitted ``Model.run`` of the same number
    of steps, 16^3 float64: every leaf within 1e-8."""
    jax = jax_cpu()
    import dataclasses
    import jax.numpy as jnp
    from test_torch_graph import numpy_fields
    from test_torch_openbc import compare_states, jtree
    if path == "flat":
        import __graft_entry__ as ref_entry
        from udales_tpu import state as jstate
        from udales_tpu_torch.convert import PROFILE_NAMES, load_profiles
        jmodel = ref_entry._build(N, N, N, "float64")
        tmodel, tst = flat_case()
        load_profiles(tmodel, {k: np.asarray(getattr(jmodel, k))
                               for k in PROFILE_NAMES})
        jst = jstate.initial_state(
            jmodel.grid, jstate.Fields(**{k: jnp.asarray(a) for k, a in
                                          numpy_fields(7).items()}), dt0=0.1)
    else:
        from udales_tpu.run import load_case as jload_case
        tmodel, _ = urban_case(tmp_path)
        jmodel = jload_case(tmp_path / f"urban{N}v2", "900",
                            dtype="float64")
        jst = jmodel.cold_start(seed=43)
        fields = dataclasses.replace(jst.m, **{
            k: jnp.asarray(a) for k, a in numpy_fields(11).items()})
        jst = jst.replace(m=fields, c=fields)
        tst = state_from_numpy(jtree(jst.replace(ibmp=None)))
        jst = jst.replace(ibmp=None)
    want = jax.jit(lambda s: jmodel.run(s, TOTAL))(jst)
    _, got = bench.time_cell(tmodel, tst, STEPS, RUNS)
    names = compare_states(got, want, rtol=RTOL)
    assert {"c.u", "m.w", "pres", "dt", "timee"} <= set(names)


def last_json(text):
    lines = [ln for ln in text.splitlines() if ln.strip()]
    return json.loads(lines[-1])


def test_cpu_comparator_line(monkeypatch, capsys):
    """``UDALES_BENCH_CPU=1``: flat 64^3 on the host CPU, its last line
    the host comparator in bench.py's form with the CPU's name."""
    monkeypatch.setenv("UDALES_BENCH_CPU", "1")
    bench.main(["--steps", "1", "--runs", "2"])
    out = last_json(capsys.readouterr().out)
    assert out["metric"] == "rk3_step_grid_points_per_s_cpu_host"
    assert out["unit"] == "points/s" and out["value"] > 0
    assert out["baseline"] == "measured:this-solver-on-host-cpu-64^3"
    assert out["cpu"] and "logical CPUs" in out["cpu"]
    cell = out["cells"]["flat_64_cpu"]
    assert cell["grid"] == [64, 64, 64] and cell["steps"] == 1
    assert cell["device"] == "cpu"
    assert cell["points_per_s"] == out["value"]


def test_without_a_card_no_number(monkeypatch, capsys):
    """Without a card and without UDALES_BENCH_CPU the command raises
    before it measures anything, and prints no number."""
    monkeypatch.delenv("UDALES_BENCH_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--cell", "flat_128"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("arg", ["--runs", "--steps"])
def test_run_length_must_be_positive(arg):
    """A run length of 0 is refused before anything is built."""
    with pytest.raises(SystemExit):
        bench.parse([arg, "0"])


def test_no_jax(tmp_path):
    """In a process where ``import jax`` and ``import udales_tpu`` fail,
    the bench imports and runs the urban 16^3 cell on the CPU."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['udales_tpu'] = None; "
            "from pathlib import Path; "
            "from udales_tpu_torch import bench; "
            "bench.CACHE = Path(sys.argv[1]); "
            "o = bench.run_cell('urban_16', bench.Cell('urban', 16, 2), 2, "
            "43, device='cpu'); "
            "assert o['points_per_s_median'] > 0 and o['variant'] == "
            "'masked'; "
            "assert not any(m.split('.')[0] in ('jax', 'jaxlib', "
            "'udales_tpu') for m in sys.modules if sys.modules[m] "
            "is not None)")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr
    assert "urban_16: 16x16x16 on cpu" in res.stdout


@pytest.mark.parametrize("fault", ["launch count", "non-finite field"])
def test_a_failed_check_ends_the_command(monkeypatch, capsys, fault):
    """A cell whose check fails raises out of `main` (a non-zero exit):
    a kernel launch counted on the CPU, or a NaN carried by the State.
    Nothing prints "failed" and no JSON line follows.  (The host
    comparator's cell at 16^3 here.)"""
    monkeypatch.setenv("UDALES_BENCH_CPU", "1")
    monkeypatch.setattr(bench, "CPU_CELL", bench.Cell("flat", N, 1))
    if fault == "launch count":
        call = FusedDiffMom.__call__

        def counted(self, *a, **kw):
            self.launch_count += 1
            return call(self, *a, **kw)
        monkeypatch.setattr(FusedDiffMom, "__call__", counted)
        match = "kernel launches"
    else:
        init = entry._init_state

        def nan_start(model, seed=43):
            st = init(model, seed)
            st.c.thl[0, 0, 0] = float("nan")
            return st
        monkeypatch.setattr(entry, "_init_state", nan_start)
        match = "non-finite"
    with pytest.raises(RuntimeError, match=match):
        bench.main(["--steps", "1", "--runs", "1"])
    out = capsys.readouterr().out
    assert "failed" not in out and "{" not in out
    fused_diff_mom.launch_count = fused_diff_mom.masked_launch_count = 0


def test_a_failed_check_exits_non_zero(tmp_path):
    """The bench's process, whose cell fails its check (the divergence bound
    set to 0), exits non-zero, with the error on stderr and
    no "failed" or JSON line on stdout."""
    code = ("from udales_tpu_torch import bench; bench.DIV_BOUND = 0.0; "
            "bench.CPU_CELL = bench.Cell('flat', 16, 1); "
            "bench.main(['--runs', '1'])")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1",
                                  UDALES_BENCH_CPU="1"))
    assert res.returncode != 0
    assert "max|div u|" in res.stderr
    assert "failed" not in res.stdout and "{" not in res.stdout


@pytest.mark.parametrize("tool", ["lines", "missing"])
def test_card_reading(monkeypatch, tool):
    """`card_reading` is one nvidia-smi query of the card's SM clock,
    memory clock and power draw; a reading that does not parse, or no
    nvidia-smi, gives three Nones and the bench goes on."""
    calls = []

    def fake(cmd, **kw):
        calls.append(cmd)
        if tool == "missing":
            raise FileNotFoundError(cmd[0])
        out = "1980, 2619, 350.5\n" if len(calls) == 1 else "[N/A], 2619, 1\n"
        return subprocess.CompletedProcess(cmd, 0, stdout=out)
    monkeypatch.setattr(bench.subprocess, "run", fake)
    if tool == "lines":
        assert bench.card_reading(2) == (1980.0, 2619.0, 350.5)
        assert calls[0][0] == "nvidia-smi" and calls[0][-2:] == ["-i", "2"]
        assert "-lms" not in calls[0]
    assert bench.card_reading(0) == (None, None, None)


@pytest.fixture
def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_urban_cell_on_the_card(need_cuda, tmp_path, monkeypatch, capsys):
    """The urban 32^3 cell through ``main --cell`` on the card, 2 runs of 3
    steps: masked launches 3 a step as counted, the profiled replay's busy share and
    fused_diff_mom's device time, the card named."""
    monkeypatch.setattr(bench, "CACHE", tmp_path)
    monkeypatch.setitem(bench.CELLS, "urban_32", bench.Cell("urban", 32, 9))
    out = bench.main(["--cell", "urban_32", "--runs", "2", "--steps", "3"])
    assert last_json(capsys.readouterr().out) == json.loads(json.dumps(out))
    cell = out["cells"]["urban_32"]
    assert out["value"] is None and out["urban_32"] > 0
    assert (cell["runs"], cell["steps"], cell["launches_per_step"]) == \
        (2, 3, 3)
    assert cell["variant"] == "masked" and cell["device"] == "cuda"
    assert 0 < cell["busy_share"] <= 1.0 + 1e-6
    assert cell["fused_diff_mom_per_step"] == 3
    assert cell["fused_diff_mom_ms_per_step"] > 0 and cell["peak_gib"] > 0
    assert out["urban_32"] == cell["points_per_s"]
    assert set(cell["card_before"]) == set(cell["card_after"]) == {
        "sm_clock_mhz", "mem_clock_mhz", "power_w"}
    assert out["device"]["name"] and out["device"]["count"] >= 1
