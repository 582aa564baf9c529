"""The advection kernel's wrapper (``ops/fused_adv.py``) and its CUDA kernel.

On the CPU the wrapper returns the plain ``advection.adv_mom``: the
expressions the substep had before the kernel, bit for bit, on the ghosts
and padded pressure of a real substep (periodic, open-x and stretched-z
cases, float32 and float64, with and without thl), and udales_tpu's
expressions in float64.  The benchmark's frozen byte count
(``lesbench/metrics/fused_adv_mom_roofline.py``) is the wrapper's.

The tests marked ``cuda`` compare the kernel with the plain route on the
card; they skip without one.  This file imports JAX only inside the test
that needs it, so the card tests also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_adv.py
"""
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from udales_tpu_torch import entry, run as trun
from udales_tpu_torch.config import (BC_PROFILE, BCConfig, Config,
                                     DomainConfig, PhysicsConfig, RunConfig,
                                     WallsConfig)
from udales_tpu_torch.grid import Grid
from udales_tpu_torch.io.inputs import CaseInputs
from udales_tpu_torch.ops import advection as adv, openbc
from udales_tpu_torch.ops.fused_adv import (FusedAdvMom, fused_adv_mom,
                                            least_bytes)

REPO = Path(__file__).resolve().parents[1]
NX, NY, NZ = 12, 10, 8
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64,
                                                       torch.float64)}
CONFIG_DTYPE = {"f32": "float32", "f64": "float64"}


def _zf(nz, r):
    return np.cumsum(r ** np.arange(nz)) - 0.5 * r ** np.arange(nz)


def small_model(kind, dt, thl, device="cpu"):
    """A 12 x 10 x 8 Model in `dt` ("f32", "f64"): "periodic" (uniform
    z), "open-x" (a profile inlet and a convective outlet in x) or
    "stretched" (periodic, z cells growing by 6% a level); thl advected
    when `thl` (ltempeq)."""
    open_x = kind == "open-x"
    bc = dict(z0=0.01, z0h=0.001, thls=288.0)
    if open_x:
        bc.update(BCxm=BC_PROFILE, BCxT=BC_PROFILE, BCxq=BC_PROFILE,
                  BCxs=BC_PROFILE)
    cfg = Config(domain=DomainConfig(itot=NX, jtot=NY, ktot=NZ,
                                     xlen=float(NX), ylen=float(NY)),
                 run=RunConfig(ladaptive=False, dtmax=0.02, lrandomize=True,
                               randu=0.05, krand=NZ),
                 physics=PhysicsConfig(ltempeq=thl),
                 walls=WallsConfig(lbottom=True), bc=BCConfig(**bc),
                 dtype=CONFIG_DTYPE[dt])
    zf = _zf(NZ, 1.06 if kind == "stretched" else 1.0)
    grid = Grid(NX, NY, NZ, float(NX), float(NY), zf, dtype=DTYPES[dt][0])
    model = trun.Model(cfg, grid, device=device)
    z = np.arange(NZ) + 0.5
    prof = dict(zf=zf, thl=288.0 + 0.05 * z, qt=np.zeros(NZ),
                u=1.0 + 0.05 * z, v=np.full(NZ, 0.1), e12=np.full(NZ, 5e-5))
    model.inputs = CaseInputs(prof=prof, lscale=None, scalar=None)
    if open_x:
        t = lambda a: torch.tensor(np.asarray(a), dtype=DTYPES[dt][1],
                                   device=device)
        model.inlet = openbc.Inlet(
            mode=BC_PROFILE, uprof=t(prof["u"]), vprof=t(prof["v"]),
            thlprof=t(prof["thl"]), qtprof=t(prof["qt"]),
            e12prof=t(prof["e12"]), svprof=t(np.zeros((0, NZ))))
    return model


def substep_inputs(model, seed=3):
    """(g, gp, pres, thl flag, the wrapper's output) of the first substep
    of one step of `model` from a cold start with a random pressure."""
    st = model.cold_start(seed=seed)
    rng = np.random.default_rng(seed)
    st = st.replace(pres=torch.tensor(
        rng.standard_normal(tuple(st.pres.shape)), dtype=st.pres.dtype,
        device=st.pres.device))
    seen = []
    pads = []

    def pad(p, *a, **kw):
        gp = pad_pres(p, *a, **kw)
        pads.append(p)
        return gp

    def spy(g, gp, grid, thl=False):
        out = call(g, gp, grid, thl=thl)
        seen.append((g, gp, pads[-1], thl, out))
        return out
    pad_pres, call = trun._pad_pres, trun.fused_adv_mom
    trun._pad_pres, trun.fused_adv_mom = pad, spy
    try:
        model.step(st)
    finally:
        trun._pad_pres, trun.fused_adv_mom = pad_pres, call
    assert len(seen) == 3
    return seen[0]


def substep_expressions(g, pres, grid, thl):
    """The advection leaf as ``run.Model._substep`` wrote it before the
    kernel (the pressure padded as ``run._pad_pres`` pads it)."""
    nz = grid.ktot
    gp = g.gp
    du = adv.adv_u(g, grid) \
        - (gp[1:-1, 1:-1, :] - gp[:-2, 1:-1, :]) * grid.dxi
    dv = adv.adv_v(g, grid) \
        - (gp[1:-1, 1:-1, :] - gp[1:-1, :-2, :]) * grid.dyi
    dw = adv.adv_w(g, grid)
    dzhi = grid.t("dzhi", pres.device)
    dw[..., 1:nz] -= (pres[:, :, 1:] - pres[:, :, :-1]) \
        * dzhi[1:nz][None, None, :]
    dthl = adv.adv_c2(g.thl, g, grid) if thl else None
    return du, dv, dw, dthl


@pytest.mark.parametrize("thl", [True, False], ids=["thl", "no-thl"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["periodic", "open-x", "stretched"])
def test_cpu_route_is_the_substeps_expressions(kind, dt, thl):
    """On the CPU the wrapper returns, bit for bit, what the substep's
    expressions gave, on a real substep's ghosts and padded pressure; it
    launches nothing."""
    model = small_model(kind, dt, thl)
    before = fused_adv_mom.launch_count
    g, gp, pres, flag, got = substep_inputs(model)
    assert fused_adv_mom.launch_count == before
    assert flag == thl
    ref = substep_expressions(types.SimpleNamespace(**vars(g), gp=gp), pres,
                              model.grid, thl)
    assert got[0].dtype == DTYPES[dt][1]
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a, b)
    if thl:
        assert torch.equal(got[3], ref[3])
    else:
        assert got[3] is None and ref[3] is None
    assert torch.all(got[2][..., 0] == 0) and torch.all(got[2][..., -1] == 0)
    if kind == "open-x":   # the x ghosts are the inlet's, not a wrap
        assert not torch.equal(gp[0], gp[-2])


def random_inputs(shape, seed, dtype=np.float64, device="cpu"):
    """Random ghosted u, v, w, thl and padded pressure for a (nx, ny, nz)
    grid, as (ghosts, gp)."""
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    cell = (nx + 2, ny + 2, nz + 2)
    t = lambda a: torch.tensor(a.astype(dtype), device=device)
    g = types.SimpleNamespace(
        u=t(rng.standard_normal(cell)), v=t(rng.standard_normal(cell)),
        w=t(rng.standard_normal((nx + 2, ny + 2, nz + 1))),
        thl=t(288.0 + rng.standard_normal(cell)))
    return g, t(rng.standard_normal((nx + 2, ny + 2, nz)))


@pytest.mark.parametrize("stretch", [1.0, 1.06], ids=["uniform", "stretched"])
def test_plain_matches_udales_tpu_f64(stretch):
    """adv_mom == udales_tpu's adv_u/v/w/c2 with the same pressure terms,
    float64, 1e-12 of the largest value."""
    import jax.numpy as jnp
    from udales_tpu.grid import Grid as JGrid
    from udales_tpu.ops import advection as jadv
    shape = (14, 11, 9)
    zf = _zf(shape[2], stretch)
    jgrid = JGrid(*shape, 14.0, 11.0, zf, dtype=np.float64)
    tgrid = Grid(*shape, 14.0, 11.0, zf, dtype=np.float64)
    g, gp = random_inputs(shape, seed=8)
    jg = types.SimpleNamespace(**{k: jnp.asarray(v.numpy())
                                  for k, v in vars(g).items()})
    p = gp.numpy()
    nz = shape[2]
    dzhi = np.asarray(jgrid.dzhi)
    dw = np.array(jadv.adv_w(jg, jgrid))
    dw[..., 1:nz] -= (p[1:-1, 1:-1, 1:] - p[1:-1, 1:-1, :-1]) * dzhi[1:nz]
    ref = (np.asarray(jadv.adv_u(jg, jgrid))
           - (p[1:-1, 1:-1] - p[:-2, 1:-1]) * jgrid.dxi,
           np.asarray(jadv.adv_v(jg, jgrid))
           - (p[1:-1, 1:-1] - p[1:-1, :-2]) * jgrid.dyi,
           dw, np.asarray(jadv.adv_c2(jg.thl, jg, jgrid)))
    got = adv.adv_mom(g, gp, tgrid, thl=True)
    scale = max(float(np.abs(r).max()) for r in ref)
    for a, b in zip(got, ref):
        assert float(np.abs(a.numpy() - b).max()) <= 1e-12 * scale


def test_least_bytes_counts_each_array_once():
    """The bound's byte count: inputs read once, outputs written once; the
    benchmark's frozen count (with thl, as its cells run) is the same."""
    n = 128
    cell, face, pcell = (n + 2) ** 3, (n + 2) ** 2 * (n + 1), \
        (n + 2) ** 2 * n
    out = n * n * (n + 1)
    assert least_bytes((n, n, n), 4, True) == 4 * (
        3 * cell + face + pcell + 3 * n ** 3 + out)
    assert least_bytes((n, n, n), 4, False) == 4 * (
        2 * cell + face + pcell + 2 * n ** 3 + out)
    assert least_bytes((3, 4, 5), 8, True) == 8 * (
        3 * 5 * 6 * 7 + 5 * 6 * 6 + 5 * 6 * 5 + 3 * 60 + 3 * 4 * 6)
    assert abs(least_bytes((n, n, n), 4, True) - 77.36e6) < 0.01e6
    spec = importlib.util.spec_from_file_location(
        "fused_adv_mom_roofline",
        REPO / "lesbench" / "metrics" / "fused_adv_mom_roofline.py")
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    for shape, size in (((n, n, n), 4), ((16, 16, 16), 8), ((3, 4, 5), 4)):
        assert metric.least_bytes(shape, size) == least_bytes(shape, size,
                                                              True)
    span = dict(n_ops=10, window_s=1.0, replays=2, ops={
        "void (anonymous namespace)::fused_adv_mom_kernel<float, true>"
        "(float const*, ...)": (6 * 0.05e-3, 6),
        "fused_diff_mom_kernel<float, true>": (3 * 0.04e-3, 3)})
    ctx = dict(span=span, shape=(n, n, n), itemsize=4)
    share = 100.0 * least_bytes((n, n, n), 4, True) / 3.35e12 / 0.05e-3
    assert metric.read(ctx) == pytest.approx(share, rel=1e-12)
    del span["ops"]["void (anonymous namespace)::fused_adv_mom_kernel"
                    "<float, true>(float const*, ...)"]
    assert metric.read(ctx) is None      # a program without the kernel
    assert metric.read(dict(ctx, span=None)) is None


# --- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# Shapes against the kernel's 8 x 32 (j, k) tile and its i-chunks (those of
# test_torch_fused_diff.py), and one rank's block of a 2 x 2 split at 128^3.
SHAPES = [((24, 20, 37), 1.04), ((5, 3, 2), 1.04), ((33, 17, 65), 1.04),
          ((9, 8, 63), 1.04), ((32, 16, 64), 1.0), ((70, 9, 130), 1.02),
          ((1, 1, 1), 1.0), ((64, 64, 128), 1.0)]
SHAPE_IDS = ["x".join(map(str, shape)) for shape, _ in SHAPES]
RTOL = {"f64": 1e-12, "f32": 1e-5}


def assert_kernel_matches_plain(kern, g, gp, grid, thl, rtol):
    """Kernel == plain route on the same card tensors to rtol x the
    largest plain value; faces 0 and nz of dw exactly zero."""
    got = kern(g, gp, grid, thl=thl)
    torch.cuda.synchronize()
    ref = adv.adv_mom(g, gp, grid, thl)
    pairs = [(a, b) for a, b in zip(got, ref) if b is not None]
    assert (got[3] is None) == (not thl)
    scale = max(float(b.abs().max()) for _, b in pairs)
    err = max(float((a - b).abs().max()) for a, b in pairs)
    assert err <= rtol * scale, (err, scale)
    assert torch.all(got[2][..., 0] == 0) and torch.all(got[2][..., -1] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("thl", [True, False], ids=["thl", "no-thl"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape,stretch", SHAPES, ids=SHAPE_IDS)
def test_kernel_matches_plain_on_card(cuda, shape, stretch, dt, thl):
    """Kernel == plain route over ragged shapes on a stretched grid;
    float32 differs by FMA contraction, hence 1e-5 x max|ref| there."""
    np_dt, _ = DTYPES[dt]
    grid = Grid(*shape, float(shape[0]), float(shape[1]),
                _zf(shape[2], stretch), dtype=np_dt)
    g, gp = random_inputs(shape, seed=2, dtype=np_dt, device=cuda)
    kern = FusedAdvMom()
    assert_kernel_matches_plain(kern, g, gp, grid, thl, RTOL[dt])
    assert kern.launch_count == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["open-x", "stretched"])
def test_kernel_on_substep_ghosts_on_card(cuda, kind, dt):
    """Kernel == plain route on a real substep's ghosts and padded pressure
    (open-x inlet ghosts, stretched z), with thl."""
    model = small_model(kind, dt, True, device=cuda)
    g, gp, _, thl, _ = substep_inputs(model)
    assert thl
    assert_kernel_matches_plain(FusedAdvMom(), g, gp, model.grid, True,
                                RTOL[dt])


@pytest.mark.cuda
def test_steps_launch_three_times_a_step_on_card(cuda):
    """Every substep on the card goes through the kernel: 3 launches a
    step, eagerly and across the replays of the captured step."""
    model = entry._build(16, 16, 16, "float64", device=cuda)
    start = entry._init_state(model, seed=5)
    for graph in (False, True):
        fused_adv_mom.launch_count = 0
        model.run(start, 4, graph=graph)
        torch.cuda.synchronize()
        assert fused_adv_mom.launch_count == 12


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    shape = (8, 8, 8)
    grid = Grid.uniform(*shape, 8.0, 8.0, 8.0, dtype=np.float32)
    g, gp = random_inputs(shape, seed=4, dtype=np.float32, device=cuda)
    kern = FusedAdvMom()
    with pytest.raises(ValueError, match="p has shape"):
        kern(g, g.u, grid)
    with pytest.raises(ValueError, match="p is"):
        kern(g, gp.double(), grid)
    with pytest.raises(ValueError, match="thl is"):
        kern(types.SimpleNamespace(**{**vars(g), "thl": g.thl.cpu()}), gp,
             grid, thl=True)
    with pytest.raises(ValueError, match="w has shape"):
        kern(types.SimpleNamespace(**{**vars(g), "w": g.u}), gp, grid)
    with pytest.raises(ValueError, match="grid"):
        g64, gp64 = random_inputs(shape, seed=4, device=cuda)
        kern(g64, gp64, grid)
    with pytest.raises(ValueError, match="contiguous"):
        kern(types.SimpleNamespace(
            **{**vars(g), "u": g.u.transpose(0, 1).contiguous()
               .transpose(0, 1)}), gp, grid)
    with pytest.raises(TypeError, match="dtype"):
        kern(types.SimpleNamespace(**{k: v.half() for k, v in
                                      vars(g).items()}), gp.half(), grid)
    assert kern.launch_count == 0
