"""The scalars leaf: the hand-written CUDA kernel and its wrapper.

Kappa advection and the masked subgrid diffusion of every passive scalar
of the stack in one pass over the grid, writing the stack's tendency
(``udales_tpu_torch/csrc/fused_scalars.cu``, built and bound by
``ops/kernel.py``, without FMA contraction).  It replaces no Pallas
kernel: the leaf's ~140 whole-stack torch operations a substep, on strided
views of the kappa-ghosted stack, ran at about 1% of its memory bound on
the H100.

What bounds it is bytes: per point it reads each scalar, the velocity
faces, ekh and the c mask once and writes each scalar's tendency.  The
design is ``fused_ibmnorm``'s plane ring with the stack's two-cell halo
(the source's note has it).  The plain route is `plain_scalars`.  The
kernel follows what it can observe: the dtype, the number of scalars and
whether there is a mask.  Open x/y and the split mesh need nothing of its
own: their planes and halos are in the ghosted inputs already.
"""
from __future__ import annotations

import torch

from .. import trace
from ..grid import Grid
from . import advection as adv
from . import subgrid as sgs
from .kernel import CSRC, NVCC_FLAGS, HandKernel, check_inputs

SOURCE = CSRC / "fused_scalars.cu"
# added to the shared flags: no FMA contraction, so that each product and
# sum rounds as the plain route's
NO_FMA = ("--fmad=false",)
_METRICS = ("dzhci_g", "dzfc_g", "dzfci_g", "dzf_g", "dzh2i", "dzfi")


def least_bytes(shape, itemsize: int, nsv: int, masked: bool) -> int:
    """Bytes the leaf must move at grid `shape` with `nsv` scalars: each
    scalar, ekh and (`masked`) the c mask read once at the cell centres, u
    at its nx + 1 x-faces, v at its ny + 1 y-faces and w at faces 1..nz,
    and each scalar's tendency written once, all at their interior sizes.
    Over the card's memory rate this is the kernel's bound; the metric
    vectors are left out as negligible."""
    nx, ny, nz = shape
    cell = nx * ny * nz
    n = (2 * nsv + 4 + int(masked)) * cell + ny * nz + nx * nz
    return itemsize * n


def plain_scalars(g, grid: Grid, Mc=None):
    """The stack's tendency on the torch route: kappa advection of the
    kappa-ghosted ``g.sv`` by the h=1 ghosted velocities, plus the
    subgrid diffusion of its h=1 view with ``g.ekh``, masked by the
    ghosted c mask `Mc` where there is one."""
    return (adv.adv_kappa(g.sv, g, grid)
            + sgs.diff_c(g.sv[:, 1:-1, 1:-1, 1:-1], g.ekh, grid, M=Mc))


class FusedScalars(HandKernel):
    """``fused_scalars(g, grid, Mc=None)``: the tendency (nsv, nx, ny, nz)
    of the kappa-ghosted stack ``g.sv`` (nsv, nx+4, ny+4, nz+4), in a new
    tensor, as `plain_scalars` returns it.  Reads the h=1 ghosted ``g.u``,
    ``g.v``, ``g.w`` and ``g.ekh``, and the ghosted c mask `Mc` (nx+2,
    ny+2, nz+2) where there is an IBM.

    ``launch_count`` counts calls (the trace's ``fused_scalars.launches``):
    one launch each, unless the stack is too deep for one block's shared
    memory and the launcher takes it in groups."""

    name = "fused_scalars"
    source = SOURCE
    flags = NVCC_FLAGS + NO_FMA
    signatures = dict.fromkeys(("fused_scalars_f32", "fused_scalars_f64"),
                               "p" * 13 + "i" * 4 + "d" * 5 + "p")
    launch_count = trace.counter("fused_scalars.launches")

    def inputs(self, g, grid: Grid, Mc=None):
        nx, ny, nz = grid.shape
        cell = (nx + 2, ny + 2, nz + 2)
        nsv = 1 if g.sv is None else max(g.sv.shape[0], 1)   # one or more
        inputs = [("sv", g.sv, (nsv, nx + 4, ny + 4, nz + 4)),
                  ("u", g.u, cell), ("v", g.v, cell),
                  ("w", g.w, (nx + 2, ny + 2, nz + 1)), ("ekh", g.ekh, cell)]
        if Mc is not None:
            inputs.append(("pmask_c", Mc, cell))
        return inputs

    def plain(self, g, grid: Grid, Mc=None):
        return plain_scalars(g, grid, Mc)

    def launch(self, g, grid: Grid, Mc=None):
        check_inputs(self.name, grid, self.inputs(g, grid, Mc))
        nx, ny, nz = grid.shape
        nsv = g.sv.shape[0]
        dtype, dev = g.sv.dtype, g.sv.device
        metrics = [grid.t(name, dev) for name in _METRICS]
        out = torch.empty((nsv, nx, ny, nz), dtype=dtype, device=dev)
        self.run("fused_scalars", dtype, dev, g.sv, g.u, g.v, g.w, g.ekh, Mc,
                 *metrics, out, nsv, nx, ny, nz, grid.dxi, grid.dyi, grid.dx,
                 grid.dx2i, grid.dy2i)
        self.launch_count += 1
        return out


# The process-wide wrapper: `fused_scalars(g, grid, Mc)` is the call the
# substep's scalars leaf makes, `fused_scalars.launch_count` the counter a
# run reads.
fused_scalars = FusedScalars()
