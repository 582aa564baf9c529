"""The fused momentum-diffusion wrapper and its CUDA kernel.

On the CPU the wrapper returns the plain ``diff_u/v/w``; those are held
against ``udales_tpu.ops.subgrid`` in float64 (uniform and stretched z) and
against the Pallas kernel of ``udales_tpu.ops.pallas_stencil`` run in
interpret mode in float32 (atol 1e-5, as tests/test_pallas.py does).

The tests marked ``cuda`` compare the kernel with the plain sweeps on the
card; they skip without one.  This file imports JAX only inside the tests
that need it, so the card tests also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_diff.py
"""
import types

import numpy as np
import pytest
import torch

from udales_tpu_torch.grid import Grid
from udales_tpu_torch.ops import subgrid as sgs
from udales_tpu_torch.ops.fused_diff import FusedDiffMom, fused_diff_mom


def _zf(nz, r):
    return np.cumsum(r ** np.arange(nz)) - 0.5 * r ** np.arange(nz)


def ghosted_inputs(shape, seed, dtype=np.float64):
    """Random ghosted u, v, w, ekm (numpy) for a (nx, ny, nz) grid."""
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    cell = (nx + 2, ny + 2, nz + 2)
    return dict(u=rng.standard_normal(cell).astype(dtype),
                v=rng.standard_normal(cell).astype(dtype),
                w=rng.standard_normal((nx + 2, ny + 2, nz + 1)).astype(dtype),
                ekm=rng.uniform(0.5, 1.5, cell).astype(dtype))


def torch_ghosts(arrs, device="cpu"):
    return types.SimpleNamespace(**{k: torch.tensor(a, device=device)
                                    for k, a in arrs.items()})


def max_err(got, ref):
    return max(float(np.abs(np.asarray(a.cpu()) - np.asarray(b)).max())
               for a, b in zip(got, ref))


@pytest.mark.parametrize("stretch", [1.0, 1.06], ids=["uniform", "stretched"])
def test_plain_matches_reference_f64(stretch):
    """CPU path == udales_tpu subgrid.diff_u/v/w, float64, 1e-12 relative."""
    import jax.numpy as jnp
    from udales_tpu.grid import Grid as JGrid
    from udales_tpu.ops import subgrid as jsgs
    shape = (14, 11, 9)
    zf = _zf(shape[2], stretch)
    jgrid = JGrid(*shape, 14.0, 11.0, zf, dtype=np.float64)
    tgrid = Grid(*shape, 14.0, 11.0, zf, dtype=np.float64)
    arrs = ghosted_inputs(shape, seed=3)
    jg = types.SimpleNamespace(**{k: jnp.asarray(a) for k, a in arrs.items()})
    before = fused_diff_mom.launch_count
    got = fused_diff_mom(torch_ghosts(arrs), tgrid)
    assert fused_diff_mom.launch_count == before   # CPU: no kernel launch
    ref = (jsgs.diff_u(jg, jgrid), jsgs.diff_v(jg, jgrid),
           jsgs.diff_w(jg, jgrid))
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    assert max_err(got, ref) <= 1e-12 * scale
    assert [tuple(a.shape) for a in got] == [(14, 11, 9)] * 2 + [(14, 11, 10)]


def test_plain_matches_pallas_interpret_f32(monkeypatch):
    """CPU path == the TPU Pallas kernel in interpret mode, float32."""
    monkeypatch.setenv("UDALES_PALLAS_INTERPRET", "1")
    import jax.numpy as jnp
    from udales_tpu.grid import Grid as JGrid
    from udales_tpu.ops.pallas_stencil import fused_diff_mom as pallas_fdm
    shape = (16, 12, 8)
    jgrid = JGrid.uniform(*shape, 16.0, 12.0, 8.0, dtype=np.float32)
    tgrid = Grid.uniform(*shape, 16.0, 12.0, 8.0, dtype=np.float32)
    arrs = ghosted_inputs(shape, seed=5, dtype=np.float32)
    jg = types.SimpleNamespace(**{k: jnp.asarray(a) for k, a in arrs.items()})
    ref = pallas_fdm(jg, jgrid)
    got = fused_diff_mom(torch_ghosts(arrs), tgrid)
    assert all(a.dtype == torch.float32 for a in got)
    assert max_err(got, ref) <= 1e-5


def test_masked_cpu_path_and_boundary_faces():
    """pmasks fold into the plain sweeps on the CPU; dw faces 0, nz are 0."""
    shape = (6, 5, 4)
    grid = Grid.uniform(*shape, 6.0, 5.0, 4.0, dtype=np.float64)
    g = torch_ghosts(ghosted_inputs(shape, seed=9))
    ones = {k: torch.ones_like(getattr(g, k)) for k in "uvw"}
    got = fused_diff_mom(g, grid, pmasks=ones)
    plain = fused_diff_mom(g, grid)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    zero = {k: torch.zeros_like(getattr(g, k)) for k in "uvw"}
    masked = fused_diff_mom(g, grid, pmasks=zero)
    assert not torch.equal(masked[0], plain[0])
    assert torch.all(plain[2][..., 0] == 0)
    assert torch.all(plain[2][..., -1] == 0)


def test_non_cuda_device_raises():
    grid = Grid.uniform(4, 4, 4, 4.0, 4.0, 4.0, dtype=np.float64)
    g = torch_ghosts(ghosted_inputs((4, 4, 4), seed=1), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_diff_mom(g, grid)


# --- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol",
                         [(np.float64, 1e-12), (np.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape,stretch", [((24, 20, 37), 1.04),
                                           ((32, 16, 64), 1.0)],
                         ids=["stretched-odd", "uniform"])
def test_kernel_matches_plain_on_card(cuda, dtype, rtol, shape, stretch):
    """Kernel == plain sweeps on the same card tensors; float32 differs by
    FMA contraction, hence 1e-5 x max|ref| there."""
    grid = Grid(*shape, float(shape[0]), float(shape[1]),
                _zf(shape[2], stretch), dtype=dtype)
    g = torch_ghosts(ghosted_inputs(shape, seed=2, dtype=dtype), cuda)
    kern = FusedDiffMom()
    got = kern(g, grid)
    torch.cuda.synchronize()
    assert kern.launch_count == 1
    ref = (sgs.diff_u(g, grid), sgs.diff_v(g, grid), sgs.diff_w(g, grid))
    scale = max(float(r.abs().max()) for r in ref)
    assert max(float((a - b).abs().max()) for a, b in zip(got, ref)) \
        <= rtol * scale
    assert torch.all(got[2][..., 0] == 0) and torch.all(got[2][..., -1] == 0)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    shape = (8, 8, 8)
    grid = Grid.uniform(*shape, 8.0, 8.0, 8.0, dtype=np.float32)
    arrs = ghosted_inputs(shape, seed=4, dtype=np.float32)
    g = torch_ghosts(arrs, cuda)
    kern = FusedDiffMom()
    with pytest.raises(NotImplementedError):
        kern(g, grid, pmasks={k: torch.ones_like(getattr(g, k))
                              for k in "uvw"})
    bad = types.SimpleNamespace(**vars(g))
    bad.w = g.u                               # wrong shape
    with pytest.raises(ValueError, match="shape"):
        kern(bad, grid)
    bad = types.SimpleNamespace(**vars(g))
    bad.ekm = g.ekm.double()                  # wrong dtype
    with pytest.raises(ValueError):
        kern(bad, grid)
    with pytest.raises(ValueError, match="grid"):
        kern(torch_ghosts(ghosted_inputs(shape, seed=4), cuda), grid)
    bad = types.SimpleNamespace(**vars(g))
    bad.u = g.u.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kern(bad, grid)
    assert kern.launch_count == 0
