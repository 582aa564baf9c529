"""The advection leaf of a substep: the hand-written CUDA kernel and its
wrapper.

cd2 advection of u, v and w with the pressure-gradient terms, and cd2
advection of thl where the case advects it so, in one pass over the grid
(``udales_tpu_torch/csrc/fused_adv_mom.cu``, built and bound by
``ops/kernel.py``).  It replaces no Pallas kernel: the leaf's ~145
whole-field torch operations a substep ran at 2.4% of its memory bound on
the H100.

What bounds it is bytes: per point it reads five ghosted input fields and
writes four tendencies.  The design is ``fused_diff_mom``'s plane ring (the
source's note has it).  The plain route is ``advection.adv_mom``.
"""
from __future__ import annotations

import torch

from .. import trace
from ..grid import Grid
from . import advection as adv
from .kernel import CSRC, HandKernel, check_inputs

SOURCE = CSRC / "fused_adv_mom.cu"
_METRICS = ("dzf_g", "dzhi", "dzhiq", "dzfi5")


def least_bytes(shape, itemsize: int, thl: bool) -> int:
    """Bytes the function must move at grid `shape`: each input (the
    ghosted u, v, w, the padded pressure, and the ghosted thl when `thl`)
    read once and each output (du, dv, dw, and dthl) written once.  Over
    the card's memory rate this is the kernel's bound; the metric vectors
    are left out as negligible."""
    nx, ny, nz = shape
    cell = (nx + 2) * (ny + 2) * (nz + 2)
    face = (nx + 2) * (ny + 2) * (nz + 1)
    pcell = (nx + 2) * (ny + 2) * nz
    reads = (3 if thl else 2) * cell + face + pcell
    writes = (3 if thl else 2) * nx * ny * nz + nx * ny * (nz + 1)
    return itemsize * (reads + writes)


class FusedAdvMom(HandKernel):
    """``fused_adv_mom(g, gp, grid, thl=False)``: (du, dv, dw, dthl) from
    the h=1 ghosted ``g.u, g.v, g.w`` (and ``g.thl`` when `thl`; else dthl
    is None) and the pressure `gp` padded by one cell in x and y
    (``run._pad_pres``).

    ``launch_count`` counts launches (the trace's
    ``fused_adv_mom.launches``)."""

    name = "fused_adv_mom"
    source = SOURCE
    signatures = dict.fromkeys(("fused_adv_mom_f32", "fused_adv_mom_f64"),
                               "p" * 13 + "i" * 3 + "d" * 6 + "p")
    launch_count = trace.counter("fused_adv_mom.launches")

    def inputs(self, g, gp, grid: Grid, thl: bool = False):
        nx, ny, nz = grid.shape
        cell = (nx + 2, ny + 2, nz + 2)
        inputs = [("u", g.u, cell), ("v", g.v, cell),
                  ("w", g.w, (nx + 2, ny + 2, nz + 1)),
                  ("p", gp, (nx + 2, ny + 2, nz))]
        if thl:
            inputs.append(("thl", g.thl, cell))
        return inputs

    def plain(self, g, gp, grid: Grid, thl: bool = False):
        return adv.adv_mom(g, gp, grid, thl)

    def launch(self, g, gp, grid: Grid, thl: bool = False):
        check_inputs(self.name, grid, self.inputs(g, gp, grid, thl))
        nx, ny, nz = grid.shape
        dtype, dev = g.u.dtype, g.u.device
        metrics = [grid.t(m, dev) for m in _METRICS]
        du = torch.empty((nx, ny, nz), dtype=dtype, device=dev)
        dv = torch.empty((nx, ny, nz), dtype=dtype, device=dev)
        dw = torch.empty((nx, ny, nz + 1), dtype=dtype, device=dev)
        dthl = torch.empty((nx, ny, nz), dtype=dtype, device=dev) \
            if thl else None
        self.run("fused_adv_mom", dtype, dev, g.u, g.v, g.w, gp,
                 g.thl if thl else None, *metrics, du, dv, dw, dthl,
                 nx, ny, nz, grid.dxi, grid.dyi, grid.dxiq, grid.dyiq,
                 grid.dxi5, grid.dyi5)
        self.launch_count += 1
        return du, dv, dw, dthl


# The process-wide wrapper: `fused_adv_mom(g, gp, grid, thl)` is the call
# the substep makes, `fused_adv_mom.launch_count` the counter a run reads.
fused_adv_mom = FusedAdvMom()
