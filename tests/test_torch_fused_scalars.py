"""The scalars leaf's wrapper (``ops/fused_scalars.py``) and its CUDA kernel.

On the CPU the wrapper is ``adv_kappa`` of the kappa-ghosted stack plus
``diff_c`` of its h=1 view, bit for bit, on random inputs over a ragged
stretched grid (float32 and float64, one and three scalars, with and
without the c mask) and on the inputs of every scalars call of a real step
of the staged dispersion case; it launches nothing.  A compiled
dispersion run calls it once a substep.  The benchmark's frozen byte count
(``lesbench/metrics/fused_scalars_roofline.py``) is the wrapper's.

The tests marked ``cuda`` compare the kernel with the plain route on the
card, bit for bit, and count its launches; they skip without one.  This
file imports JAX nowhere, so the card tests also run where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_scalars.py
"""
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_fused_adv import DTYPES, _zf
from test_torch_fused_ibmnorm import CONFIG_DTYPE, RAGGED
from udales_tpu_torch import cases, run, trace
from udales_tpu_torch.grid import Grid
from udales_tpu_torch.ops import advection as adv
from udales_tpu_torch.ops import subgrid as sgs
from udales_tpu_torch.ops.fused_scalars import (FusedScalars, fused_scalars,
                                                least_bytes)
from udales_tpu_torch.run import load_case

REPO = Path(__file__).resolve().parents[1]


def reference(g, grid, Mc):
    """The leaf as the substep wrote it before the wrapper: kappa advection
    of the stack plus the diffusion of its h=1 view."""
    dsv = adv.adv_kappa(g.sv, g, grid)
    return dsv + sgs.diff_c(g.sv[:, 1:-1, 1:-1, 1:-1], g.ekh, grid, M=Mc)


def same_bits(a, b):
    """Two tensors equal bit for bit (a zero's sign included)."""
    bits = {4: torch.int32, 8: torch.int64}[b.element_size()]
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool((a.contiguous().view(bits)
                      == b.contiguous().view(bits)).all()))


def random_call(dt, nsv, masked, device="cpu", seed=0, shape=RAGGED,
                stretch=1.05):
    """(g, grid, Mc) on random inputs over a `shape` grid of non-unit x and
    y spacings with z cells growing by `stretch` a level: a kappa-ghosted
    stack of `nsv` scalars with flat patches (where the limiter's
    differences vanish), h=1 ghosted velocities with some faces at rest
    (the branch of a zero velocity), a positive ekh and, when `masked`, a
    ghosted {0, 1} c mask."""
    np_dt, dtype = DTYPES[dt]
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    grid = Grid(nx, ny, nz, 1.3 * nx, 0.7 * ny, _zf(nz, stretch),
                dtype=np_dt)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    cell = (nx + 2, ny + 2, nz + 2)

    def velocity(size):
        a = rng.standard_normal(size)
        a[rng.uniform(size=size) < 0.1] = 0.0
        return t(a)
    sv = 1.0 + rng.standard_normal((nsv, nx + 4, ny + 4, nz + 4))
    sv[:, 3:7, 2:6, 4:9] = 0.5          # a flat patch
    g = types.SimpleNamespace(
        sv=t(sv), u=velocity(cell), v=velocity(cell),
        w=velocity((nx + 2, ny + 2, nz + 1)),
        ekh=t(0.1 + rng.uniform(size=cell)))
    Mc = None
    if masked:
        m = (rng.uniform(size=cell) > 0.3).astype(np.float64)
        m[2:7, 3:8, :5] = 0.0
        Mc = t(m)
    return g, grid, Mc


@pytest.mark.parametrize("masked", [False, True], ids=["open", "masked"])
@pytest.mark.parametrize("nsv", [1, 3])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_cpu_route_is_adv_kappa_plus_diff_c(dt, nsv, masked):
    """On the CPU the wrapper returns, bit for bit, kappa advection plus
    diffusion of the stack, in a new tensor of (nsv, nx, ny, nz); it
    launches nothing.  The mask changes the result (it takes effect)."""
    g, grid, Mc = random_call(dt, nsv, masked)
    before = fused_scalars.launch_count
    got = fused_scalars(g, grid, Mc)
    assert got.shape == (nsv, *grid.shape)
    assert same_bits(got, reference(g, grid, Mc))
    assert fused_scalars.launch_count == before
    if masked:
        assert not torch.equal(got, fused_scalars(g, grid, None))


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    root = tmp_path_factory.mktemp("scalars")
    return dict(dispersion=cases.stage_urban_dispersion(16, root),
                urban=cases.stage_urban(16, root))


def scalars_calls(model, monkeypatch, state=None, steps=1, graph=None):
    """The arguments of every call the substeps make of the scalars
    wrapper in `steps` steps of `model` from a cold start (one
    ``Model.step`` when `graph` is None, else ``Model.run``)."""
    calls = []
    real = run.fused_scalars

    def spy(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(run, "fused_scalars", spy)
    state = model.cold_start(seed=3) if state is None else state
    if graph is None:
        model.step(state)
    else:
        model.run(state, steps, graph=graph)
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_cpu_route_on_substep_inputs(staged, dt, monkeypatch):
    """The inputs of each of the 3 scalars calls of a real step of the
    staged dispersion case (its buildings' mask, trees and sources, three
    scalars): the wrapper is the plain expression bit for bit."""
    model = load_case(staged["dispersion"], "900", CONFIG_DTYPE[dt],
                      device="cpu")
    calls = scalars_calls(model, monkeypatch)
    assert len(calls) == 3
    for g, grid, Mc in calls:
        assert g.sv.shape[0] == 3 and Mc is not None
        assert same_bits(fused_scalars(g, grid, Mc), reference(g, grid, Mc))


def test_one_call_a_substep_of_a_compiled_run(staged, monkeypatch):
    """A compiled dispersion run of 2 steps calls the wrapper once a
    substep, launches nothing on the CPU, and still counts 9 scalar field
    substeps a step; an urban step never calls it."""
    model = load_case(staged["dispersion"], "900", "float64", device="cpu")
    trace.reset()
    before = fused_scalars.launch_count
    calls = scalars_calls(model, monkeypatch, steps=2, graph=True)
    assert len(calls) == 3 * 2
    assert fused_scalars.launch_count == before
    assert trace.snapshot()["counters"]["scalars.field_substeps"] == 2 * 9
    trace.reset()
    urban = load_case(staged["urban"], "900", "float64", device="cpu")
    assert scalars_calls(urban, monkeypatch) == []


def test_least_bytes_counts_each_array_once():
    """The bound's byte count: the stack, ekh and the mask read once at the
    cell centres, u, v at their extra face, w at faces 1..nz, the tendency
    written once; the benchmark's frozen count (three scalars and the
    mask, as its cell runs) is the same, and its reader takes the ops
    named ``fused_scalars``."""
    n = 128
    cell = n ** 3
    assert least_bytes((n, n, n), 4, 3, True) == 4 * (11 * cell
                                                      + 2 * n * n)
    assert least_bytes((n, n, n), 4, 3, True) == 92_405_760
    assert least_bytes((n, n, n), 8, 1, False) == 8 * (6 * cell + 2 * n * n)
    assert least_bytes((3, 4, 5), 4, 2, True) == 4 * (9 * 60 + 20 + 15)
    spec = importlib.util.spec_from_file_location(
        "fused_scalars_roofline",
        REPO / "lesbench" / "metrics" / "fused_scalars_roofline.py")
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    for shape, size in (((n, n, n), 4), ((512, 512, 128), 4),
                        ((16, 16, 16), 8), ((3, 4, 5), 4)):
        assert metric.least_bytes(shape, size) == least_bytes(shape, size,
                                                              3, True)
    name = ("void (anonymous namespace)::fused_scalars_kernel<float, true>"
            "((anonymous namespace)::Args<float>, int)")
    span = dict(n_ops=10, window_s=1.0, replays=2, ops={
        name: (6 * 0.05e-3, 6),
        "fused_ibmnorm_kernel<float, true, false>": (3 * 0.04e-3, 3)})
    ctx = dict(span=span, shape=(n, n, n), itemsize=4)
    share = 100.0 * least_bytes((n, n, n), 4, 3, True) / 3.35e12 / 0.05e-3
    assert metric.read(ctx) == pytest.approx(share, rel=1e-12)
    del span["ops"][name]
    assert metric.read(ctx) is None      # a program without the kernel
    assert metric.read(dict(ctx, span=None)) is None


def test_refuses_an_empty_stack():
    """A call with no scalars is refused before any pointer is taken."""
    g, grid, Mc = random_call("f32", 1, True, shape=(6, 5, 4))
    g.sv = g.sv[:0]
    with pytest.raises(ValueError, match="^fused_scalars: sv has shape"):
        FusedScalars().launch(g, grid, Mc)


# --- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# 128^3 and a ragged shape: x-y sizes that are not tile multiples
SHAPES = {"128^3": ((128, 128, 128), 1.0), "40x24x20": (RAGGED, 1.05),
          "37x13x45": ((37, 13, 45), 1.03)}


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["open", "masked"])
@pytest.mark.parametrize("nsv", [1, 3])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_plain_on_card(cuda, shape, dt, nsv, masked):
    """Kernel == plain route bit for bit on random inputs; its output is a
    new tensor and its inputs are left as they were; one launch."""
    size, stretch = SHAPES[shape]
    g, grid, Mc = random_call(dt, nsv, masked, device=cuda, shape=size,
                              stretch=stretch)
    ins = [t for t in (g.sv, g.u, g.v, g.w, g.ekh, Mc) if t is not None]
    before = [t.clone() for t in ins]
    kern = FusedScalars()
    got = kern(g, grid, Mc)
    torch.cuda.synchronize()
    assert kern.launch_count == 1
    assert same_bits(got, kern.plain(g, grid, Mc))
    assert got.data_ptr() not in {t.data_ptr() for t in ins}
    assert all(torch.equal(a, b) for a, b in zip(ins, before))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_deep_stack_in_groups_on_card(cuda, dt):
    """A stack deeper than one block's shared memory holds (nine scalars)
    goes in groups of launches, and still equals the plain route bit for
    bit."""
    g, grid, Mc = random_call(dt, 9, True, device=cuda, seed=4)
    got = fused_scalars(g, grid, Mc)
    torch.cuda.synchronize()
    assert same_bits(got, reference(g, grid, Mc))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_kernel_on_substep_inputs_on_card(cuda, staged, dt, monkeypatch):
    """Kernel == plain route bit for bit on the inputs of every scalars
    call of a real step of the staged dispersion case on the card."""
    model = load_case(staged["dispersion"], "900", CONFIG_DTYPE[dt],
                      device=cuda)
    calls = scalars_calls(model, monkeypatch)
    assert len(calls) == 3
    for g, grid, Mc in calls:
        assert same_bits(fused_scalars(g, grid, Mc), reference(g, grid, Mc))


@pytest.mark.cuda
def test_launches_a_step_on_card(cuda, staged):
    """Every scalars call on the card goes through the kernel: 3 launches
    a step, eagerly and across the replays of the captured step, with 9
    scalar field substeps a step; none on the urban case."""
    model = load_case(staged["dispersion"], "900", "float32", device=cuda)
    start = model.cold_start(seed=5)
    for graph in (False, True):
        trace.reset()
        model.run(start, 4, graph=graph)
        torch.cuda.synchronize()
        assert fused_scalars.launch_count == 3 * 4, graph
        counters = trace.snapshot()["counters"]
        assert counters["scalars.field_substeps"] == 9 * 4, graph
    trace.reset()
    urban = load_case(staged["urban"], "900", "float32", device=cuda)
    urban.run(urban.cold_start(seed=5), 4, graph=True)
    torch.cuda.synchronize()
    assert fused_scalars.launch_count == 0
    trace.reset()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    g, grid, Mc = random_call("f32", 3, True, device=cuda, shape=(8, 6, 4))
    kern = FusedScalars()
    with pytest.raises(ValueError, match="w has shape"):
        kern(types.SimpleNamespace(**{**vars(g), "w": g.u}), grid, Mc)
    with pytest.raises(ValueError, match="pmask_c is"):
        kern(g, grid, Mc.double())
    with pytest.raises(ValueError, match="ekh is"):
        kern(types.SimpleNamespace(**{**vars(g), "ekh": g.ekh.cpu()}), grid,
             Mc)
    with pytest.raises(ValueError, match="contiguous"):
        kern(types.SimpleNamespace(**{**vars(g), "sv": g.sv.transpose(
            0, 1).contiguous().transpose(0, 1)}), grid, Mc)
    with pytest.raises(ValueError, match="grid"):
        _, grid64, _ = random_call("f64", 3, True, device=cuda,
                                   shape=(8, 6, 4))
        kern(g, grid64, Mc)
    assert kern.launch_count == 0
