"""Fused SGS momentum diffusion: the hand-written CUDA kernel and its wrapper.

Replaces the TPU Pallas kernel ``udales_tpu/ops/pallas_stencil.py:
fused_diff_mom`` (pallas_call at :344).  The kernel source is
``udales_tpu_torch/csrc/fused_diff_mom.cu``, built and bound by
``ops/kernel.py``.

What bounds it on the H100 is bytes: per point it reads ~4 ghosted input
fields and writes 3 outputs, memory-bound at 3.35 TB/s.  A block owns a
(j, k) window and marches along i with a ring of planes in shared memory
that ``cp.async`` fills ahead of the march, so every input byte crosses
from L2 to an SM about once (the design notes are in the source).

Two variants share the source: the unmasked kernel of the flat path and
the masked one of the urban path, which also reads the ghosted IBM fluid
masks ``pmask_u/v/w`` and folds the IBM diffusion corrections into the
sweep (JAX sends that case to its jnp sweeps, pallas_stencil.py:204-207).
The plain route is ``subgrid.diff_u/v/w`` (with ``M=`` the pmasks).
"""
from __future__ import annotations

import torch

from .. import trace
from ..grid import Grid
from . import subgrid as sgs
from .kernel import CSRC, HandKernel, check_inputs

SOURCE = CSRC / "fused_diff_mom.cu"
_METRICS = ("dzf_g", "dzhiq", "dzhi", "dzfi_g")


def least_bytes(shape, itemsize: int, masked: bool) -> int:
    """Bytes the function must move at grid `shape`: each input (the ghosted
    u, v, ekm, w, and the three pmasks when `masked`) read once and each
    output (du, dv, dw) written once.  Over the card's memory rate this is
    the kernel's bound; the metric vectors are left out as negligible."""
    nx, ny, nz = shape
    cell = (nx + 2) * (ny + 2) * (nz + 2)
    face = (nx + 2) * (ny + 2) * (nz + 1)
    reads = 3 * cell + face + (3 * cell if masked else 0)
    writes = 2 * nx * ny * nz + nx * ny * (nz + 1)
    return itemsize * (reads + writes)


class FusedDiffMom(HandKernel):
    """``fused_diff_mom(g, grid, pmasks=None)``: (du, dv, dw) SGS momentum
    tendencies from the h=1 ghosted ``g.u, g.v, g.w, g.ekm``
    (ops/boundary.py conventions); `pmasks` {"u", "v", "w"}: the ghosted
    IBM fluid masks (``ibm.IBM.pmask_*``) or None.

    ``launch_count`` counts launches of the unmasked kernel and
    ``masked_launch_count`` those of the masked one (the trace's
    ``fused_diff_mom.launches``, ``fused_diff_mom.masked_launches``)."""

    name = "fused_diff_mom"
    source = SOURCE
    signatures = {
        **dict.fromkeys(("fused_diff_mom_f32", "fused_diff_mom_f64"),
                        "p" * 11 + "i" * 3 + "d" * 4 + "p"),
        **dict.fromkeys(("fused_diff_mom_masked_f32",
                         "fused_diff_mom_masked_f64"),
                        "p" * 14 + "i" * 3 + "d" * 4 + "p")}
    launch_count = trace.counter("fused_diff_mom.launches")
    masked_launch_count = trace.counter("fused_diff_mom.masked_launches")

    def inputs(self, g, grid: Grid, pmasks=None):
        nx, ny, nz = grid.shape
        cell = (nx + 2, ny + 2, nz + 2)
        inputs = [("u", g.u, cell), ("v", g.v, cell),
                  ("w", g.w, (nx + 2, ny + 2, nz + 1)), ("ekm", g.ekm, cell)]
        if pmasks is not None:
            # pmask_w: x/y-ghosted faces 0..nz plus one top ghost face
            inputs += [(f"pmask_{k}", pmasks[k], cell) for k in "uvw"]
        return inputs

    def plain(self, g, grid: Grid, pmasks=None):
        if pmasks is None:
            return (sgs.diff_u(g, grid), sgs.diff_v(g, grid),
                    sgs.diff_w(g, grid))
        return (sgs.diff_u(g, grid, M=pmasks["u"]),
                sgs.diff_v(g, grid, M=pmasks["v"]),
                sgs.diff_w(g, grid, M=pmasks["w"]))

    def launch(self, g, grid: Grid, pmasks=None):
        check_inputs(self.name, grid, self.inputs(g, grid, pmasks))
        nx, ny, nz = grid.shape
        dtype, dev = g.u.dtype, g.u.device
        metrics = [grid.t(m, dev) for m in _METRICS]
        du = torch.empty((nx, ny, nz), dtype=dtype, device=dev)
        dv = torch.empty((nx, ny, nz), dtype=dtype, device=dev)
        dw = torch.empty((nx, ny, nz + 1), dtype=dtype, device=dev)
        masks = [] if pmasks is None else [pmasks[k] for k in "uvw"]
        self.run("fused_diff_mom" + ("_masked" if masks else ""), dtype, dev,
                 g.u, g.v, g.w, g.ekm, *masks, *metrics, du, dv, dw,
                 nx, ny, nz, grid.dxi, grid.dyi, grid.dx2i, grid.dy2i)
        if pmasks is None:
            self.launch_count += 1
        else:
            self.masked_launch_count += 1
        return du, dv, dw


# The process-wide wrapper: `fused_diff_mom(g, grid, pmasks)` is the call
# the substep makes, `fused_diff_mom.launch_count` and
# `.masked_launch_count` the counters a run reads.
fused_diff_mom = FusedDiffMom()
