"""The ibmnorm leaf's wrapper (``ops/fused_ibmnorm.py``) and its CUDA kernel.

On the CPU the wrapper's ``ibmnorm`` is ``IBM.ibmnorm``, bit for bit, on
the inputs of every ibmnorm call of a real step of the staged urban case
and on random inputs over a ragged stretched grid, in float32 and float64,
in each variant the kernel adapts to: thl with the liberal cd2 correction,
thl with kappa advection (no correction), the conservative correction
(left to the torch route) and no thl.  The benchmark's frozen byte count
(``lesbench/metrics/fused_ibmnorm_roofline.py``) is the wrapper's.

The tests marked ``cuda`` compare the kernel with the plain route on the
card, bit for bit; they skip without one.  This file imports JAX nowhere,
so the card tests also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_ibmnorm.py
"""
import copy
import importlib.util
import types
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_fused_adv import DTYPES, _zf
from udales_tpu_torch.cases import stage_urban
from udales_tpu_torch.config import (IADV_KAPPA, Config, DomainConfig,
                                     PhysicsConfig)
from udales_tpu_torch.grid import Grid
from udales_tpu_torch.ibm.ibm import GRIDS, IBM, SecData
from udales_tpu_torch.ops import fused_ibmnorm as fi
from udales_tpu_torch.ops.fused_ibmnorm import (FusedIbmnorm, fused_ibmnorm,
                                                least_bytes, variant)
from udales_tpu_torch.ops.halo import pad_periodic_xy
from udales_tpu_torch.run import load_case
from udales_tpu_torch.state import Fields

REPO = Path(__file__).resolve().parents[1]
CONFIG_DTYPE = {"f32": "float32", "f64": "float64"}
# the variants the kernel adapts to: (ltempeq, advection scheme of thl (-1:
# that of momentum, cd2), lconservativeibm)
VARIANTS = {"liberal": (True, -1, False), "kappa": (True, IADV_KAPPA, False),
            "conservative": (True, -1, True), "no-thl": (False, -1, False)}
# a ragged stretched grid that a 2 x 2 split divides
RAGGED = (40, 24, 20)


def with_variant(cfg: Config, name: str) -> Config:
    """`cfg` turned into the variant `name` of VARIANTS."""
    ltempeq, iadv, conservative = VARIANTS[name]
    return replace(cfg, dynamics=replace(cfg.dynamics, iadv_thl=iadv),
                   physics=replace(cfg.physics, ltempeq=ltempeq,
                                   lconservativeibm=conservative))


def ibm_variant(ibm: IBM, name: str) -> IBM:
    """A shallow copy of `ibm` whose case is the variant `name`."""
    out = copy.copy(ibm)
    out.cfg = with_variant(ibm.cfg, name)
    return out


def random_masks(shape, rng):
    """0/1 masks u, v, c (cells) and w (faces, face 0 solid) with a solid
    box, whose inner cells have no fluid neighbour, and scattered solid
    cells."""
    nx, ny, nz = shape
    out = {}
    for k, s in (("u", shape), ("v", shape), ("c", shape),
                 ("w", (nx, ny, nz + 1))):
        m = (rng.uniform(size=s) > 0.3).astype(np.float32)
        m[2:7, 3:8, :5] = 0.0
        out[k] = m
    out["w"][:, :, 0] = 0.0
    return out


def make_ibm(cfg, grid, masks, device="cpu", mesh=None):
    """An IBM of the 0/1 `masks` with no facet sections (what ibmnorm
    reads is the masks alone)."""
    z = np.zeros(0)
    none = SecData(np.zeros((0, 3), np.int64), z, z, np.zeros(0, np.int64),
                   z.astype(bool), z.astype(bool))
    one = np.ones(1)
    return IBM(cfg, grid, masks, {k: none for k in GRIDS},
               np.array([[0.0, 0.0, 1.0]]), 0.01 * one, 0.001 * one,
               295.0 * one, one, device=device, mesh=mesh)


def random_fields(shape, rng, dtype, device, thl_base=290.0):
    """A Fields of random u, v, w, thl (no qt, e12 or scalars)."""
    nx, ny, nz = shape
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return Fields(u=t(rng.standard_normal(shape)),
                  v=t(rng.standard_normal(shape)),
                  w=t(rng.standard_normal((nx, ny, nz + 1))),
                  thl=t(thl_base + rng.standard_normal(shape)),
                  qt=t(np.zeros(shape)), e12=t(np.zeros(shape)),
                  sv=t(np.zeros((0,) + shape)))


def random_call(name, dt, device="cpu", seed=0, shape=RAGGED, stretch=1.05):
    """(ibm, the arguments of ``fi.ibmnorm`` after ibm) on random inputs
    over a `shape` grid with z cells growing by `stretch` a level, for the
    variant `name`."""
    np_dt, dtype = DTYPES[dt]
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    grid = Grid(nx, ny, nz, float(nx), float(ny), _zf(nz, stretch),
                dtype=np_dt)
    cfg = with_variant(Config(
        domain=DomainConfig(itot=nx, jtot=ny, ktot=nz, xlen=float(nx),
                            ylen=float(ny)),
        physics=PhysicsConfig(ltempeq=True), dtype=CONFIG_DTYPE[dt]), name)
    ibm = make_ibm(cfg, grid, random_masks(shape, rng), device=device)
    c, m = (random_fields(shape, rng, dtype, device) for _ in range(2))
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    tend = [t(1e-2 * rng.standard_normal(s)) for s in
            (shape, shape, (nx, ny, nz + 1))]
    dthl = t(1e-3 * rng.standard_normal(shape)) if cfg.physics.ltempeq \
        else None
    return ibm, (c, m, *tend, dthl, t(290.25))


def outputs(out):
    """The tensors of an ``ibmnorm`` result that the kernel writes: du,
    dv, dw, dthl and the masked m.u, m.v, m.w, m.thl."""
    du, dv, dw, dthl, _, _, m = out
    return dict(du=du, dv=dv, dw=dw, dthl=dthl, mu=m.u, mv=m.v, mw=m.w,
                mthl=m.thl)


def assert_same(got, want):
    """Every output of two ``ibmnorm`` results equal, bit for bit (the
    bits themselves, so that a zero's sign counts too)."""
    got, want = outputs(got), outputs(want)
    for key, ref in want.items():
        if ref is None:
            assert got[key] is None, key
            continue
        a = got[key]
        assert a.dtype == ref.dtype and a.shape == ref.shape, key
        bits = {4: torch.int32, 8: torch.int64}[ref.element_size()]
        same = a.contiguous().view(bits) == ref.contiguous().view(bits)
        assert bool(same.all()), (key, int((~same).sum()))


@pytest.fixture(scope="module")
def urban16(tmp_path_factory):
    return stage_urban(16, tmp_path_factory.mktemp("cases"))


def ibmnorm_calls(model, monkeypatch, seed=3):
    """The arguments of every call the substeps make of ``fi.ibmnorm`` in
    one step of `model` from a cold start (ibm first)."""
    calls = []
    real = fi.ibmnorm

    def spy(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(fi, "ibmnorm", spy)
    model.step(model.cold_start(seed=seed))
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_cpu_route_is_ibmnorm_on_substep_inputs(urban16, dt, name,
                                                monkeypatch):
    """On the CPU ``fused_ibmnorm.ibmnorm`` returns, bit for bit, what
    ``IBM.ibmnorm`` gives on the inputs of each of the 3 ibmnorm calls of
    a real step of the staged urban case, in each variant; it launches
    nothing."""
    model = load_case(urban16, "900", CONFIG_DTYPE[dt], device="cpu")
    assert variant(model.cfg) == (True, True)   # as the urban cells run
    before = fused_ibmnorm.launch_count
    calls = ibmnorm_calls(model, monkeypatch)
    assert len(calls) == 3
    for ibm, *args in calls:
        ibm = ibm_variant(ibm, name)
        assert_same(fi.ibmnorm(ibm, *args), ibm.ibmnorm(*args))
    assert fused_ibmnorm.launch_count == before


@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_cpu_route_is_ibmnorm_on_random_inputs(dt, name):
    """The same on random fields and masks over a ragged stretched grid:
    the plain route of the wrapper is ``IBM.ibmnorm_uvw_thl``; each variant
    changes what it returns as it should (the fill and the corrections
    take effect)."""
    ibm, args = random_call(name, dt)
    got = fi.ibmnorm(ibm, *args)
    assert_same(got, ibm.ibmnorm(*args))
    c, m, du, dv, dw, dthl, vmean = args
    if name == "no-thl":
        assert got[3] is None and got[-1].thl is m.thl
        return
    assert not torch.equal(got[-1].thl, m.thl)          # solid cells filled
    kappa = ibm_variant(ibm, "kappa").ibmnorm(*args)[3]
    if name == "kappa":
        assert not torch.equal(kappa, dthl)             # the tendency's fill
    else:
        assert not torch.equal(got[3], kappa)           # the correction


def test_least_bytes_counts_each_array_once():
    """The bound's byte count: inputs read once, outputs written once, at
    their interior sizes; the benchmark's frozen count (thl with the
    liberal correction, as its cells run) is the same, and its reader
    takes the ops named ``fused_ibmnorm``."""
    n = 128
    cell, face = n ** 3, n * n * (n + 1)
    assert least_bytes((n, n, n), 4, True, True) == 4 * (18 * cell
                                                         + 6 * face)
    assert least_bytes((n, n, n), 4, True, False) == 4 * (15 * cell
                                                          + 5 * face)
    assert least_bytes((n, n, n), 8, False, False) == 8 * (10 * cell
                                                           + 5 * face)
    assert least_bytes((3, 4, 5), 4, True, True) == 4 * (18 * 60 + 6 * 72)
    # the 24 interior fields and the six extra w levels at 512 x 512 x 128
    assert abs(least_bytes((512, 512, 128), 4, True, True) - 3227.5e6) \
        < 0.1e6
    spec = importlib.util.spec_from_file_location(
        "fused_ibmnorm_roofline",
        REPO / "lesbench" / "metrics" / "fused_ibmnorm_roofline.py")
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    for shape, size in (((n, n, n), 4), ((512, 512, 128), 4),
                        ((16, 16, 16), 8), ((3, 4, 5), 4)):
        assert metric.least_bytes(shape, size) == least_bytes(shape, size,
                                                              True, True)
    name = ("void (anonymous namespace)::fused_ibmnorm_kernel<float, true, "
            "false>((anonymous namespace)::Args<float>, int)")
    span = dict(n_ops=10, window_s=1.0, replays=2, ops={
        name: (6 * 0.05e-3, 6),
        "fused_vreman_kernel<float, false>": (3 * 0.04e-3, 3)})
    ctx = dict(span=span, shape=(n, n, n), itemsize=4)
    share = 100.0 * least_bytes((n, n, n), 4, True, True) / 3.35e12 / 0.05e-3
    assert metric.read(ctx) == pytest.approx(share, rel=1e-12)
    del span["ops"][name]
    assert metric.read(ctx) is None      # a program without the kernel
    assert metric.read(dict(ctx, span=None)) is None


class BlockMesh:
    """The rank (cx, cy) of a px x py split, as far as ibmnorm sees it: its
    x/y exchange (`wrap_xy`) of a block of one of the `wholes` (the
    whole-domain fields a test hands out) is the cut, ring included, of
    that field's periodic pad."""

    def __init__(self, px, py, cx, cy, grid, wholes):
        self.px, self.py, self.cx, self.cy = px, py, cx, cy
        self.block = grid.block(self)
        self.wholes = wholes

    def wrap_xy(self, f, h=1):
        parts = []
        for blk in f.reshape(-1, *f.shape[-3:]):
            whole = next(w for w in self.wholes
                         if torch.equal(self.block.cut(w), blk))
            parts.append(self.block.cut(pad_periodic_xy(whole, h), ring=h))
        return torch.stack(parts).reshape(*f.shape[:-3], *parts[0].shape)


def block_calls(ibm, args):
    """(block IBM, block arguments, the cut) for each rank of a 2 x 2
    split of the whole-domain call (`ibm`, `args`)."""
    c, m, du, dv, dw, dthl, vmean = args
    wholes = [t for t in (m.thl, dthl, c.thl, c.u, c.v) if t is not None]
    for cx in (0, 1):
        for cy in (0, 1):
            mesh = BlockMesh(2, 2, cx, cy, ibm.domain_grid, wholes)
            masks = {k: getattr(ibm.masks, k).cpu().numpy() for k in GRIDS}
            bibm = make_ibm(ibm.cfg, ibm.domain_grid, masks,
                            device=du.device, mesh=mesh)
            cut = lambda a: None if a is None else \
                mesh.block.cut(a).contiguous()
            fcut = lambda f: f.map(lambda a: a if a.ndim != 3
                                   else cut(a))
            yield bibm, (fcut(c), fcut(m), cut(du), cut(dv), cut(dw),
                         cut(dthl), vmean), cut


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_block_plain_route_is_the_domains_cut(dt):
    """The plain route on each block of a 2 x 2 split, whose x/y
    neighbours come through the mesh's exchange, equals the whole
    domain's result cut to the block: the yardstick of the kernel's ring
    variant on the card."""
    ibm, args = random_call("liberal", dt)
    whole = outputs(ibm.ibmnorm(*args))
    for bibm, bargs, cut in block_calls(ibm, args):
        got = outputs(fi.ibmnorm(bibm, *bargs))
        for key, ref in whole.items():
            assert torch.equal(got[key], cut(ref)), key


# --- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


SHAPES = {"16^3": ((16, 16, 16), 1.0), "40x24x20": (RAGGED, 1.05)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_plain_on_card(cuda, shape, dt, name):
    """Kernel == plain route bit for bit on random inputs, each variant;
    its outputs are new tensors and its inputs are left as they were."""
    size, stretch = SHAPES[shape]
    ibm, args = random_call(name, dt, device=cuda, shape=size,
                            stretch=stretch)
    c, m = args[:2]
    ins = [t for t in (*args[2:],
                       *(getattr(f, k) for f in (c, m) for k in "uvw"),
                       c.thl, m.thl, ibm.pmask_c,
                       *(getattr(ibm.masks, k) for k in GRIDS))
           if t is not None]
    before = [t.clone() for t in ins]
    kern = FusedIbmnorm()
    got = kern(*args, ibm)
    torch.cuda.synchronize()
    assert kern.launch_count == 1
    as_result = lambda o: (*o[:4], None, None, types.SimpleNamespace(
        u=o[4], v=o[5], w=o[6], thl=o[7]))
    assert_same(as_result(got), as_result(ibm.ibmnorm_uvw_thl(*args)))
    written = got if name != "no-thl" else got[:3] + got[4:7]
    assert not {t.data_ptr() for t in written} & {t.data_ptr() for t in ins}
    assert all(torch.equal(a, b) for a, b in zip(ins, before))
    assert_same(fi.ibmnorm(ibm, *args), ibm.ibmnorm(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_kernel_on_substep_inputs_on_card(cuda, urban16, dt, monkeypatch):
    """Kernel == plain route bit for bit on the inputs of every ibmnorm
    call of a real step of the staged urban case on the card (its
    buildings, their enclosed cells, the floor)."""
    model = load_case(urban16, "900", CONFIG_DTYPE[dt], device=cuda)
    calls = ibmnorm_calls(model, monkeypatch)
    assert len(calls) == 3
    for ibm, *args in calls:
        for name in VARIANTS:
            vibm = ibm_variant(ibm, name)
            assert_same(fi.ibmnorm(vibm, *args), vibm.ibmnorm(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_split_block_ring_on_card(cuda, dt):
    """On each block of a 2 x 2 split the kernel reads the scalar fields
    with the ring of the mesh's exchange: it equals the plain route on the
    block and the whole domain's kernel result cut to it, bit for bit."""
    for name in ("liberal", "kappa"):
        ibm, args = random_call(name, dt, device=cuda)
        whole = outputs(fi.ibmnorm(ibm, *args))
        for bibm, bargs, cut in block_calls(ibm, args):
            got = fi.ibmnorm(bibm, *bargs)
            assert_same(got, bibm.ibmnorm(*bargs))
            for key, ref in outputs(got).items():
                assert torch.equal(ref, cut(whole[key])), key


@pytest.mark.cuda
def test_launches_a_step_on_card(cuda, urban16):
    """Every ibmnorm call on the card goes through the kernel: 3 launches
    a step, eagerly and across the replays of the captured step."""
    model = load_case(urban16, "900", "float64", device=cuda)
    start = model.cold_start(seed=5)
    for graph in (False, True):
        fused_ibmnorm.launch_count = 0
        model.run(start, 4, graph=graph)
        torch.cuda.synchronize()
        assert fused_ibmnorm.launch_count == 3 * 4


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    ibm, args = random_call("liberal", "f32", device=cuda, shape=(8, 6, 4))
    c, m, du, dv, dw, dthl, vmean = args
    kern = FusedIbmnorm()
    call = lambda *a: kern(*a, ibm)
    with pytest.raises(ValueError, match="dw has shape"):
        call(c, m, du, dv, du, dthl, vmean)
    with pytest.raises(ValueError, match="dv is"):
        call(c, m, du, dv.double(), dw, dthl, vmean)
    with pytest.raises(ValueError, match="dthl is"):
        call(c, m, du, dv, dw, dthl.cpu(), vmean)
    with pytest.raises(ValueError, match="thl_vmean has shape"):
        call(c, m, du, dv, dw, dthl, vmean.reshape(1))
    with pytest.raises(ValueError, match="dthl is missing"):
        call(c, m, du, dv, dw, None, vmean)
    with pytest.raises(ValueError, match="c.w has shape"):
        call(replace(c, w=c.u), m, du, dv, dw, dthl, vmean)
    with pytest.raises(ValueError, match="grid"):
        ibm64, args64 = random_call("liberal", "f64", device=cuda,
                                    shape=(8, 6, 4))
        kern(*args64, ibm)
    with pytest.raises(ValueError, match="contiguous"):
        call(c, m, du.transpose(0, 1).contiguous().transpose(0, 1), dv, dw,
             dthl, vmean)
    with pytest.raises(ValueError, match="contiguous"):
        call(c, replace(m, thl=m.thl.transpose(0, 2).contiguous()
                        .transpose(0, 2)), du, dv, dw, dthl, vmean)
    with pytest.raises(TypeError, match="dtype"):
        call(c, m, du.half(), dv.half(), dw.half(), dthl.half(),
             vmean.half())
    assert kern.launch_count == 0
