"""The Vreman closure's wrapper (``ops/fused_vreman.py``) and its CUDA kernel.

On the CPU the wrapper returns the plain ``subgrid.vreman_closure``, bit for
bit, on the velocity ghosts of every closure call of a real step (periodic,
open-x and stretched-z cases, float32 and float64, with and without the
buoyancy correction): 3 calls a step with closed boundaries, 4 with an
open one.  The benchmark's frozen byte count
(``lesbench/metrics/fused_vreman_roofline.py``) is the wrapper's.

The tests marked ``cuda`` compare the kernel with the plain route on the
card; they skip without one.  This file imports JAX nowhere, so the card
tests also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_vreman.py
"""
import importlib.util
import types
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_fused_adv import DTYPES, _zf, small_model
from udales_tpu_torch import run as trun
from udales_tpu_torch.config import (Config, DomainConfig, PhysicsConfig,
                                     SubgridConfig)
from udales_tpu_torch.grid import Grid
from udales_tpu_torch.ops import fused_vreman as fv, subgrid as sgs
from udales_tpu_torch.ops.fused_vreman import (FusedVreman, fused_vreman,
                                               least_bytes)

REPO = Path(__file__).resolve().parents[1]
KINDS = ["periodic", "open-x", "stretched"]
CALLS_A_STEP = {"periodic": 3, "open-x": 4, "stretched": 3}


def vreman_model(kind, dt, buoy, device="cpu"):
    """`small_model(kind, dt, thl=True)`: stably stratified, Vreman; with
    buoyancy and the stable-stratification correction when `buoy`."""
    model = small_model(kind, dt, True, device=device)
    if not buoy:
        return model
    cfg = model.cfg
    cfg = replace(cfg, physics=replace(cfg.physics, lbuoyancy=True),
                  subgrid=replace(cfg.subgrid, lbuoycorr=True))
    out = trun.Model(cfg, model.grid, device=device)
    out.inputs, out.inlet = model.inputs, model.inlet
    return out


def closure_calls(model, monkeypatch, seed=3):
    """Every call `fused_vreman.closure` makes of the wrapper in one step of
    `model` from a cold start: (g, dthvdz, thl, (ekm, ekh)) each."""
    calls = []
    real = fv.fused_vreman

    def spy(g, grid, cfg, dthvdz=None, thl=None):
        out = real(g, grid, cfg, dthvdz, thl)
        calls.append((g, dthvdz, thl, out))
        return out
    monkeypatch.setattr(fv, "fused_vreman", spy)
    model.step(model.cold_start(seed=seed))
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("buoy", [False, True], ids=["plain", "buoycorr"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_cpu_route_is_vreman_closure(kind, dt, buoy, monkeypatch):
    """On the CPU the wrapper returns, bit for bit, what
    ``sgs.vreman_closure`` gives on the ghosts of each closure call of a
    real step (3 a step, 4 with an open x); it launches nothing."""
    model = vreman_model(kind, dt, buoy)
    assert sgs.buoycorr(model.cfg) == buoy
    before = fused_vreman.launch_count
    calls = closure_calls(model, monkeypatch)
    assert fused_vreman.launch_count == before
    assert len(calls) == CALLS_A_STEP[kind]
    for g, dthvdz, thl, (ekm, ekh) in calls:
        ref = sgs.vreman_closure(g, model.grid, model.cfg, dthvdz, thl)
        assert ekm.dtype == DTYPES[dt][1]
        assert torch.equal(ekm, ref[0]) and torch.equal(ekh, ref[1])
    if buoy:   # the correction took effect on the last call's ghosts
        g, dthvdz, thl, (ekm, _) = calls[-1]
        plain = replace(model.cfg, subgrid=replace(model.cfg.subgrid,
                                                   lbuoycorr=False))
        assert not torch.equal(ekm, sgs.vreman_closure(g, model.grid, plain,
                                                       dthvdz, thl)[0])


def test_least_bytes_counts_each_array_once():
    """The bound's byte count: inputs read once, outputs written once; the
    benchmark's frozen count (no buoyancy correction, as its cells run) is
    the same, and its reader takes the ops named ``fused_vreman``."""
    n = 128
    cell, face = (n + 2) ** 3, (n + 2) ** 2 * (n + 1)
    assert least_bytes((n, n, n), 4, False) == 4 * (2 * cell + face
                                                     + 2 * n ** 3)
    assert least_bytes((n, n, n), 4, True) == 4 * (2 * cell + face
                                                    + 4 * n ** 3)
    assert least_bytes((3, 4, 5), 8, False) == 8 * (
        2 * 5 * 6 * 7 + 5 * 6 * 6 + 2 * 60)
    assert abs(least_bytes((512, 512, 128), 4, False) - 679.5e6) < 0.1e6
    spec = importlib.util.spec_from_file_location(
        "fused_vreman_roofline",
        REPO / "lesbench" / "metrics" / "fused_vreman_roofline.py")
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    for shape, size in (((n, n, n), 4), ((512, 512, 128), 4),
                        ((16, 16, 16), 8), ((3, 4, 5), 4)):
        assert metric.least_bytes(shape, size) == least_bytes(shape, size,
                                                              False)
    name = ("void (anonymous namespace)::fused_vreman_kernel<float, false>"
            "(float const*, ...)")
    span = dict(n_ops=10, window_s=1.0, replays=2, ops={
        name: (6 * 0.02e-3, 6),
        "fused_adv_mom_kernel<float, true>": (3 * 0.04e-3, 3)})
    ctx = dict(span=span, shape=(n, n, n), itemsize=4)
    share = 100.0 * least_bytes((n, n, n), 4, False) / 3.35e12 / 0.02e-3
    assert metric.read(ctx) == pytest.approx(share, rel=1e-12)
    del span["ops"][name]
    assert metric.read(ctx) is None      # a program without the kernel
    assert metric.read(dict(ctx, span=None)) is None


def vreman_config(shape, dt, buoy):
    nx, ny, nz = shape
    return Config(domain=DomainConfig(itot=nx, jtot=ny, ktot=nz,
                                      xlen=float(nx), ylen=float(ny)),
                  physics=PhysicsConfig(ltempeq=True, lbuoyancy=buoy),
                  subgrid=SubgridConfig(lbuoycorr=buoy),
                  dtype={"f32": "float32", "f64": "float64"}[dt])


def random_inputs(shape, seed, dtype=np.float64, device="cpu"):
    """Random ghosted u, v, w for a (nx, ny, nz) grid, and an interior thl
    and dthvdz whose Richardson numbers fall below 0, inside (0, Rigc) and
    above Rigc, as (ghosts, dthvdz, thl)."""
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    cell = (nx + 2, ny + 2, nz + 2)
    t = lambda a: torch.tensor(a.astype(dtype), device=device)
    g = types.SimpleNamespace(
        u=t(rng.standard_normal(cell)), v=t(rng.standard_normal(cell)),
        w=t(rng.standard_normal((nx + 2, ny + 2, nz + 1))))
    return (g, t(5.0 * rng.standard_normal(shape)),
            t(288.0 + rng.standard_normal(shape)))


# --- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# 128^3 as the main paths run it, and a ragged stretched grid against the
# kernel's 8 x 32 (j, k) tile and its i-chunks
SHAPES = [((128, 128, 128), 1.0), ((37, 29, 23), 1.04)]
SHAPE_IDS = ["x".join(map(str, shape)) for shape, _ in SHAPES]
RTOL = {"f64": 1e-12, "f32": 1e-5}


def assert_kernel_matches_plain(kern, g, grid, cfg, dthvdz, thl, rtol):
    """Kernel == plain route on the same card tensors to rtol x the
    largest plain value."""
    got = kern(g, grid, cfg, dthvdz, thl)
    torch.cuda.synchronize()
    ref = sgs.vreman_closure(g, grid, cfg, dthvdz, thl)
    scale = max(float(b.abs().max()) for b in ref)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    assert err <= rtol * scale, (err, scale)
    assert all(a.shape == grid.shape and a.is_contiguous() for a in got)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("buoy", [False, True], ids=["plain", "buoycorr"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape,stretch", SHAPES, ids=SHAPE_IDS)
def test_kernel_matches_plain_on_card(cuda, shape, stretch, dt, buoy):
    np_dt, _ = DTYPES[dt]
    grid = Grid(*shape, float(shape[0]), float(shape[1]),
                _zf(shape[2], stretch), dtype=np_dt)
    g, dthvdz, thl = random_inputs(shape, seed=2, dtype=np_dt, device=cuda)
    kern = FusedVreman()
    assert_kernel_matches_plain(kern, g, grid, vreman_config(shape, dt, buoy),
                                dthvdz, thl, RTOL[dt])
    assert kern.launch_count == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", ["urban", "open-x", "split-block"])
def test_kernel_on_substep_ghosts_on_card(cuda, case, dt, tmp_path,
                                          monkeypatch):
    """Kernel == plain route on every closure call's ghosts of a real
    step: the staged urban case at 16^3 (the buildings' zero velocities),
    an open-x inlet and outlet, and the four blocks of a 2 x 2 split of
    the periodic case, whose halos are the neighbours' cells (there the
    kernel on a block also equals the whole domain's result cut to it)."""
    if case == "urban":
        from udales_tpu_torch.cases import stage_urban
        model = trun.load_case(stage_urban(16, tmp_path), "900",
                               {"f32": "float32", "f64": "float64"}[dt],
                               device=cuda)
    else:
        model = vreman_model("periodic" if case == "split-block" else case,
                             dt, True, device=cuda)
    calls = closure_calls(model, monkeypatch)
    assert len(calls) == (4 if case == "open-x" else 3)
    for g, dthvdz, thl, _ in calls:
        whole = assert_kernel_matches_plain(FusedVreman(), g, model.grid,
                                            model.cfg, dthvdz, thl, RTOL[dt])
        if case != "split-block":
            continue
        for cx in (0, 1):
            for cy in (0, 1):
                block = model.grid.block(types.SimpleNamespace(
                    px=2, py=2, cx=cx, cy=cy))
                # a rank's ghosts: its block with a one-cell halo
                gb = types.SimpleNamespace(
                    **{k: block.cut(getattr(g, k), ring=1).contiguous()
                       for k in "uvw"})
                cut = lambda a: block.cut(a).contiguous()
                got = assert_kernel_matches_plain(
                    FusedVreman(), gb, block, model.cfg, cut(dthvdz),
                    cut(thl), RTOL[dt])
                for a, b in zip(got, whole):
                    assert torch.equal(a, cut(b))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["periodic", "open-x"])
def test_launches_a_step_on_card(cuda, kind):
    """Every Vreman call on the card goes through the kernel: 3 launches a
    step with closed boundaries, 4 with an open x (the closure of substep
    1 is recomputed on the time-interpolated inlet planes), eagerly and
    across the replays of the captured step."""
    model = vreman_model(kind, "f64", False, device=cuda)
    start = model.cold_start(seed=5)
    for graph in (False, True):
        fused_vreman.launch_count = 0
        model.run(start, 4, graph=graph)
        torch.cuda.synchronize()
        assert fused_vreman.launch_count == 4 * CALLS_A_STEP[kind]


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    shape = (8, 8, 8)
    grid = Grid.uniform(*shape, 8.0, 8.0, 8.0, dtype=np.float32)
    g, dthvdz, thl = random_inputs(shape, seed=4, dtype=np.float32,
                                   device=cuda)
    cfg = vreman_config(shape, "f32", True)
    kern = FusedVreman()
    with_ = lambda **kw: types.SimpleNamespace(**{**vars(g), **kw})
    with pytest.raises(ValueError, match="w has shape"):
        kern(with_(w=g.u), grid, cfg, dthvdz, thl)
    with pytest.raises(ValueError, match="v is"):
        kern(with_(v=g.v.double()), grid, cfg, dthvdz, thl)
    with pytest.raises(ValueError, match="thl is"):
        kern(g, grid, cfg, dthvdz, thl.cpu())
    with pytest.raises(ValueError, match="dthvdz has shape"):
        kern(g, grid, cfg, g.u, thl)
    with pytest.raises(ValueError, match="dthvdz is missing"):
        kern(g, grid, cfg, None, thl)
    with pytest.raises(ValueError, match="grid"):
        g64, d64, t64 = random_inputs(shape, seed=4, device=cuda)
        kern(g64, grid, cfg, d64, t64)
    with pytest.raises(ValueError, match="contiguous"):
        kern(with_(u=g.u.transpose(0, 1).contiguous().transpose(0, 1)),
             grid, cfg, dthvdz, thl)
    with pytest.raises(ValueError, match="contiguous"):
        kern(g, grid, cfg, dthvdz.transpose(0, 2).contiguous()
             .transpose(0, 2), thl)
    with pytest.raises(TypeError, match="dtype"):
        kern(types.SimpleNamespace(**{k: v.half() for k, v in
                                      vars(g).items()}), grid, cfg,
             dthvdz.half(), thl.half())
    assert kern.launch_count == 0
