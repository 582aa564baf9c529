"""The run's own trace (``udales_tpu_torch/trace.py``) and the benchmark's
readers of it (``lesbench/program_trace.py``, ``lesbench/metrics/``).

On the CPU: the leaves of one ``Model.step`` on the 16^3 urban, driven and
dispersion cases, each once per substep, in order, under its substep (the
dispersion case's scalars, canopy and chem leaves, which the others lack);
the scalar stack's counters under a capture and its replays; spans open
``record_function`` only under an active profiler, and then under their
paths; a compiled run counts as an eager one; the writers' bytes; each new
metric's arithmetic on a synthetic registry, and None where it has nothing
to read.  The tests marked ``cuda`` hold the leaves of a captured 32^3
urban replay, timed by the graph's own event nodes, to the step's event
span and to CUDA events around the replay, and a captured dispersion
replay's leaves and counters; they skip without a card.  On the card's
machine:

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py
"""
import gc
import importlib.util
from pathlib import Path

import pytest
import torch

from udales_tpu_torch import cases, trace
from udales_tpu_torch.run import load_case
from udales_tpu_torch.sim import Simulation

REPO = Path(__file__).resolve().parents[1]
N = 16
ENTRY = ["ghosts", "thermo", "closure", "new_dt"]
SUBSTEP = ["thermo", "openbc", "closure", "ghosts", "advection", "diffusion",
           "forces", "wallfun", "ibmnorm", "poisson", "integrate"]
LEAVES = ([f"entry/{x}" for x in ENTRY]
          + [f"rk{k}/{x}" for k in (1, 2, 3) for x in SUBSTEP] + ["eb"])
# with scalars, trees and chemistry: the scalar stack after advection, the
# canopy after ibmnorm, the chemistry last in the third substep
SCALAR_SUBSTEP = [y for x in SUBSTEP for y in
                  {"advection": [x, "scalars"], "ibmnorm": [x, "canopy"]}
                  .get(x, [x])]
DISPERSION_LEAVES = ([f"entry/{x}" for x in ENTRY]
                     + [f"rk{k}/{x}" for k in (1, 2, 3)
                        for x in SCALAR_SUBSTEP] + ["rk3/chem", "eb"])
CASE_LEAVES = {"urban": LEAVES, "driven": LEAVES,
               "dispersion": DISPERSION_LEAVES}


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace")
    return dict(urban=cases.stage_urban(N, root),
                driven=cases.stage_urban_driven(N, root, nt=40, chunk=6,
                                                dtdriver=0.05),
                dispersion=cases.stage_urban_dispersion(N, root))


@pytest.fixture
def fresh():
    trace.reset()
    yield trace.REGISTRY
    trace.reset()


def _model(staged, name, dtype="float64"):
    return load_case(staged[name], "900", dtype, device="cpu")


@pytest.mark.parametrize("name", ["urban", "driven", "dispersion"])
def test_step_leaves_in_order(staged, fresh, name):
    """One ``Model.step``: the timeline is the leaves of the step entry,
    each substep's in order and eb, so that they partition the step; each
    leaf is a host span once, under its substep
    (``model.step/rk2/poisson``), and the substeps once under the step.
    The scalars, canopy and chem leaves are the dispersion case's alone:
    the urban and driven paths keep the leaves they had."""
    model = _model(staged, name)
    state = model.cold_start(seed=3)
    if model.driver_stream is not None:
        state = model.driver_stream.ensure(state)
    model.step(state)
    LEAVES = CASE_LEAVES[name]
    assert trace.timeline() == LEAVES
    own = {x.rsplit("/", 1)[-1] for x in LEAVES} & {"scalars", "canopy",
                                                     "chem"}
    assert own == (set() if name != "dispersion"
                   else {"scalars", "canopy", "chem"})
    spans = trace.snapshot()["spans"]
    assert spans["model.step"]["count"] == 1
    for k in (1, 2, 3):
        assert spans[f"model.step/rk{k}"]["count"] == 1
    for leaf in LEAVES:
        assert spans[f"model.step/{leaf}"]["count"] == 1, leaf
    under_step = {p for p in spans if p.startswith("model.step/")}
    assert under_step == ({f"model.step/{x}" for x in LEAVES}
                          | {"model.step/entry", "model.step/rk1",
                             "model.step/rk2", "model.step/rk3"})
    # on the CPU the timeline has names only: no device ms
    assert trace.device_ms() == {}


def test_no_record_function_without_a_profiler(staged, fresh, monkeypatch):
    """With no profiler recording, a span never opens a record function;
    under one, each span opens one."""
    opened = []
    real = torch._C._profiler._RecordFunctionFast

    def counted(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted)
    model = _model(staged, "urban")
    model.run(model.cold_start(seed=3), 1)
    assert not torch.autograd._profiler_enabled()
    assert opened == []
    assert trace.snapshot()["spans"]["model.run/model.step"]["count"] == 1
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("sim.sync"):
            pass
    assert opened == ["sim.sync"]


def test_spans_in_an_active_profiler(staged, fresh):
    """Under a CPU ``torch.profiler`` the spans are host ranges of the
    profiler's trace, named by their paths."""
    model = _model(staged, "urban")
    state = model.cold_start(seed=3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            model.step(state)
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU}
    assert {"outer", "outer/model.step", "outer/model.step/rk2",
            "outer/model.step/rk2/advection",
            "outer/model.step/rk3/poisson",
            "outer/model.step/entry/new_dt"} <= names


def test_capture_is_taken_back_and_replayed(fresh):
    """What a captured body adds is taken back at the end of the capture;
    each replay adds its counts and bytes again, not its seconds."""
    class Counted:
        launches = trace.counter("test.launches")
        wait_seconds = trace.counter("test.wait_seconds")
    obj = Counted()
    obj.launches = 5
    mark = trace.REGISTRY.checkpoint()
    with trace.span("body"):
        obj.launches += 3
        obj.wait_seconds += 0.25
        trace.add_bytes(100)
    delta = trace.REGISTRY.take_back(mark)
    snap = trace.snapshot()
    assert snap["counters"]["test.launches"] == 5
    assert snap["counters"].get("test.wait_seconds", 0) == 0
    assert snap["spans"] == {}
    for _ in range(4):
        trace.REGISTRY.replay(delta)
    snap = trace.snapshot()
    assert snap["counters"]["test.launches"] == 5 + 4 * 3
    assert snap["counters"].get("test.wait_seconds", 0) == 0
    trace.reset()
    assert obj.launches == 0 and trace.snapshot()["counters"][
        "test.launches"] == 0


def test_scalar_counters_taken_back_at_capture_and_added_per_replay(
        staged, fresh):
    """``scalars.field_substeps`` (nsv a substep) and ``chem.updates`` (one
    a step): a dispersion step recorded between the capture's checkpoint
    and its end adds 3 nsv = 9 and 1, which the end takes back and each
    replay adds again; a compiled run counts them as an eager one; an
    urban step counts neither."""
    model = _model(staged, "dispersion")
    state = model.cold_start(seed=3)
    assert state.c.sv.shape[0] == 3
    mark = trace.REGISTRY.checkpoint()
    model.step(state)
    delta = trace.REGISTRY.take_back(mark)
    added = {name: n for _, name, n in delta}
    assert added["scalars.field_substeps"] == 9
    assert added["chem.updates"] == 1
    counters = trace.snapshot()["counters"]
    assert counters.get("scalars.field_substeps", 0) == 0
    assert counters.get("chem.updates", 0) == 0
    for _ in range(4):
        trace.REGISTRY.replay(delta)
    counters = trace.snapshot()["counters"]
    assert counters["scalars.field_substeps"] == 4 * 9
    assert counters["chem.updates"] == 4
    for graph in (False, True):
        trace.reset()
        model.run(state, 3, graph=graph)
        counters = trace.snapshot()["counters"]
        assert counters["scalars.field_substeps"] == 3 * 9, graph
        assert counters["chem.updates"] == 3, graph
    trace.reset()
    urban = _model(staged, "urban")
    urban.step(urban.cold_start(seed=3))
    counters = trace.snapshot()["counters"]
    assert counters.get("scalars.field_substeps", 0) == 0
    assert counters.get("chem.updates", 0) == 0


def test_compiled_run_counts_as_eager(staged, fresh):
    """``Model.run(graph=True)`` on the driven case counts what the eager
    run counts: the driver's waits and refills and the step's launches;
    the compiled one builds once and replays the other steps."""
    steps = 6
    counts = {}
    for graph in (False, True):
        trace.reset()
        model = _model(staged, "driven")
        model.run(model.cold_start(seed=5), steps, graph=graph)
        snap = trace.snapshot()
        c, s = snap["counters"], snap["spans"]
        counts[graph] = (c["driver.refills"],
                         c["fused_diff_mom.launches"],
                         c["fused_diff_mom.masked_launches"],
                         s["model.run/driver.ensure"]["count"],
                         s["model.run/driver.ensure/driver.wait"]["count"],
                         s["model.run/driver.ensure/driver.refill"]["bytes"])
        if graph:
            assert c["graph.builds"] == 1
            assert s["model.run/graph.capture"]["count"] == 1
            assert s["model.run/graph.replay"]["count"] == steps - 1
    assert counts[True] == counts[False]
    assert counts[False][0] >= 2 and counts[False][3] == steps
    assert counts[False][5] > 0


def test_writer_bytes_and_loop_spans(staged, fresh, tmp_path):
    """A short ``Simulation.run`` with tdump, xytdump and a field dump: the
    bytes handed to each writer, the loop's spans a step, and the stop's
    checkpoint outside ``sim.outputs``."""
    case = cases.with_namelist(
        staged["urban"], tmp_path / "case",
        OUTPUT=dict(lfielddump=True, fieldvars="u0,v0,w0,th",
                    tfielddump=0.5, lxytdump=True, ltdump=True,
                    tsample=0.25, tstatsdump=0.5),
        RUN=dict(trestart=1e9))
    model = load_case(case, "900", "float32", device="cpu")
    sim = Simulation(model, tmp_path / "out", monitor=False)
    trace.reset()
    state = model.cold_start(seed=2)
    (tmp_path / "out" / "exit_now.900").unlink(missing_ok=True)
    sim.run(state, runtime=1.2)
    spans = trace.snapshot()["spans"]
    n = sim.ntrun
    assert spans["sim.step"]["count"] == spans["sim.sync"]["count"] == n
    assert spans["sim.outputs"]["count"] == n
    nfield = spans["sim.outputs/fielddump"]["count"]
    assert nfield >= 2
    assert spans["sim.outputs/fielddump/write"]["bytes"] == \
        nfield * 4 * N ** 3 * 4
    ntd = spans["sim.outputs/tdump/write"]["count"]
    assert ntd >= 2 and spans["sim.outputs/tdump/sample"]["count"] >= ntd
    # every tdump record holds the same variables: 32 fields of n^3
    assert spans["sim.outputs/tdump/write"]["bytes"] == ntd * 32 * N ** 3 * 4
    assert spans["sim.outputs/xytdump/write"]["bytes"] > 0
    assert "restart" not in {p.split("/")[-1] for p in spans}
    sim._write_restart(state)
    spans = trace.snapshot()["spans"]
    ck = next((tmp_path / "out").glob("initd*.h5"))
    assert spans["restart/write"]["bytes"] == ck.stat().st_size


def _metric(name):
    path = REPO / "lesbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(count, seconds, nbytes=0):
    return dict(count=count, seconds=seconds, bytes=nbytes)


SYNTHETIC = dict(
    counters={},
    spans={"model.run/driver.ensure": _span(10, 0.2),
           "model.run/driver.ensure/driver.wait": _span(10, 0.06),
           "sim.step": _span(40, 0.8), "sim.sync": _span(40, 0.2),
           "sim.driver.ensure/driver.wait": _span(0, 0.0),
           "sim.outputs/tdump/write": _span(2, 2.0, 500_000_000),
           "sim.outputs/xytdump/write": _span(2, 0.5, 1_000_000),
           "sim.outputs/fielddump/write": _span(1, 0.5, 33_000_000),
           "sim.outputs/restart/write": _span(1, 9.0, 900_000_000),
           "restart/write": _span(1, 9.0, 900_000_000)},
    device=dict(step=17.0, leaves={
        "entry/ghosts": 0.5, "entry/closure": 0.25, "rk1/ghosts": 0.5,
        "rk1/advection": 1.0, "rk2/advection": 1.25, "rk3/advection": 1.5,
        "rk2/closure": 0.75, "rk1/wallfun": 0.3, "rk2/wallfun": 0.3,
        "rk3/wallfun": 0.4, "rk1/poisson": 2.0, "rk2/poisson": 2.0,
        "rk3/poisson": 2.5, "copy": 0.1}))

EXPECTED = {
    "advection_ms_per_step": 3.75, "closure_ms_per_step": 1.0,
    "ghosts_ms_per_step": 1.0, "wallfun_ms_per_step": 1.0,
    "poisson_ms_per_step": 6.5, "driver_wait_ms_per_step": 6.0,
    "sync_wait_ms_per_step.run": 5.0,
    "write_mb_per_s.run": 534.0 / 3.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_reads_a_synthetic_registry(name):
    """Each new metric file's arithmetic on a registry of known sums."""
    got = _metric(name)(dict(trace=SYNTHETIC, peak_bytes=1))
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_reads_none_without_its_spans(name, fresh):
    """None where the registry has nothing for the metric (an empty one,
    or no step on the card), and off the card (no peak memory read)."""
    read = _metric(name)
    empty = dict(counters={}, spans={}, device={})
    assert read(dict(trace=empty, peak_bytes=1)) is None
    assert read(dict(peak_bytes=None, window_s=1.0)) is None


def test_summary_names_spans_counters_and_device(fresh):
    """The CLI's closing lines: every span with its calls, seconds and MB,
    and the counters."""
    with trace.span("sim.outputs"):
        with trace.span("tdump"):
            with trace.span("write"):
                trace.add_bytes(2_500_000)
    class Stream:
        refills = trace.counter("driver.refills")
    Stream().refills = 3
    text = trace.summary()
    assert "sim.outputs/tdump/write 1 " in text and "2.500 MB" in text
    assert "driver.refills=3" in text


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replayed_leaves_time_the_step(cuda, tmp_path):
    """A captured 32^3 urban step on the card: its leaves, timed by the
    graph's own event nodes in the last replay, sum to within 2% of the
    step's event span, which lies inside CUDA events recorded around the
    replay; the reading survives the graph being freed."""
    trace.reset()
    model = load_case(cases.stage_urban(32, tmp_path), "900", "float32",
                      device="cuda")
    state = model.run(model.cold_start(seed=7), 2, graph=True)
    step = model.step_jit()
    assert step.graph is not None and len(step._timeline.events) == \
        len(LEAVES) + 2                          # + copy, + the end
    before = torch.cuda.Event(enable_timing=True)
    after = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    before.record()
    step(step.state)
    after.record()
    after.synchronize()
    outer = before.elapsed_time(after)
    dev = trace.device_ms()
    assert list(dev["leaves"]) == LEAVES + ["copy"]
    assert all(ms >= 0 for ms in dev["leaves"].values())
    total = sum(dev["leaves"].values())
    assert abs(total - dev["step"]) <= 0.02 * dev["step"]
    assert 0 < dev["step"] <= outer
    assert dev["leaves"]["rk1/poisson"] > 0 and \
        dev["leaves"]["rk1/wallfun"] > 0
    del model, step, state
    gc.collect()
    torch.cuda.empty_cache()
    again = trace.device_ms()
    assert again["step"] == pytest.approx(dev["step"])
    trace.reset()


@pytest.mark.cuda
def test_replayed_dispersion_leaves_and_counters(cuda, tmp_path):
    """A captured 32^3 dispersion step on the card: its timeline has the
    scalars, canopy and chem leaves, which sum with the others to within
    2% of the step's event span, each read above 0; one replay adds 9
    scalar field substeps and 1 chemistry update, and a compiled run of 4
    steps counts 36 and 4, as an eager one does."""
    trace.reset()
    model = load_case(cases.stage_urban_dispersion(32, tmp_path), "900",
                      "float32", device="cuda")
    state = model.run(model.cold_start(seed=7), 4, graph=True)
    counters = trace.snapshot()["counters"]
    assert counters["scalars.field_substeps"] == 4 * 9
    assert counters["chem.updates"] == 4
    step = model.step_jit()
    assert step.per_replay["scalars.field_substeps"] == 9
    assert step.per_replay["chem.updates"] == 1
    dev = trace.device_ms()
    assert list(dev["leaves"]) == DISPERSION_LEAVES + ["copy"]
    total = sum(dev["leaves"].values())
    assert abs(total - dev["step"]) <= 0.02 * dev["step"]
    for name in ("rk1/scalars", "rk2/canopy", "rk3/chem"):
        assert dev["leaves"][name] > 0, name
    del model, step, state
    gc.collect()
    torch.cuda.empty_cache()
    trace.reset()
