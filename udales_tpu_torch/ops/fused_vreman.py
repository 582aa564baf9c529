"""The Vreman closure: the hand-written CUDA kernel and its wrapper.

The velocity-gradient tensor, Vreman's invariants aa and bb, ekm and ekh
(with the stable-stratification correction where the case asks for it) in
one pass over the grid (``udales_tpu_torch/csrc/fused_vreman.cu``, built
and bound by ``ops/kernel.py``, without FMA contraction).  It replaces no
Pallas kernel: the closure's ~135 whole-field torch operations a call ran
at about 1% of its memory bound on the H100.

What bounds it is bytes: per point it reads the three ghosted velocities
and writes ekm and ekh.  The design is ``fused_diff_mom``'s plane ring (the
source's note has it).  The plain route is ``subgrid.vreman_closure``.

`closure` is ``subgrid.closure`` with its Vreman branch sent through the
wrapper: the call of the step and of every other caller on the card.
"""
from __future__ import annotations

import torch

from .. import trace
from ..config import SGS_VREMAN, Config, const
from ..grid import Grid
from . import subgrid as sgs
from .kernel import CSRC, NVCC_FLAGS, HandKernel, check_inputs

SOURCE = CSRC / "fused_vreman.cu"
# added to the shared flags: no FMA contraction, so that each product and
# sum rounds as the plain route's (the source's note says why)
NO_FMA = ("--fmad=false",)
_METRICS = ("dzf_g", "dzhi", "dzfi", "dzfiq", "dzf2")


def least_bytes(shape, itemsize: int, buoycorr: bool) -> int:
    """Bytes the closure must move at grid `shape`: each input (the
    ghosted u, v, w, and the interior thl and dthvdz when `buoycorr`) read
    once and each output (ekm, ekh) written once.  Over the card's memory
    rate this is the kernel's bound; the metric vectors are left out as
    negligible."""
    nx, ny, nz = shape
    cell = (nx + 2) * (ny + 2) * (nz + 2)
    face = (nx + 2) * (ny + 2) * (nz + 1)
    interior = nx * ny * nz
    reads = 2 * cell + face + (2 * interior if buoycorr else 0)
    return itemsize * (reads + 2 * interior)


class FusedVreman(HandKernel):
    """``fused_vreman(g, grid, cfg, dthvdz=None, thl=None)``: (ekm, ekh) at
    the cell centres from the h=1 ghosted ``g.u, g.v, g.w``
    (``run._velocity_ghosts``); the interior `dthvdz` and `thl` are read
    only where the case applies the buoyancy correction.

    ``launch_count`` counts launches (the trace's
    ``fused_vreman.launches``)."""

    name = "fused_vreman"
    source = SOURCE
    flags = NVCC_FLAGS + NO_FMA
    signatures = dict.fromkeys(("fused_vreman_f32", "fused_vreman_f64"),
                               "p" * 13 + "i" * 3 + "d" * 12 + "p")
    launch_count = trace.counter("fused_vreman.launches")

    def inputs(self, g, grid: Grid, cfg: Config, dthvdz=None, thl=None):
        nx, ny, nz = grid.shape
        cell = (nx + 2, ny + 2, nz + 2)
        inputs = [("u", g.u, cell), ("v", g.v, cell),
                  ("w", g.w, (nx + 2, ny + 2, nz + 1))]
        if sgs.buoycorr(cfg):  # the correction reads the interior fields
            inputs += [("thl", thl, grid.shape),
                       ("dthvdz", dthvdz, grid.shape)]
        return inputs

    def plain(self, g, grid: Grid, cfg: Config, dthvdz=None, thl=None):
        return sgs.vreman_closure(g, grid, cfg, dthvdz, thl)

    def launch(self, g, grid: Grid, cfg: Config, dthvdz=None, thl=None):
        check_inputs(self.name, grid,
                     self.inputs(g, grid, cfg, dthvdz, thl))
        nx, ny, nz = grid.shape
        dtype, dev = g.u.dtype, g.u.device
        buoy = sgs.buoycorr(cfg)
        metrics = [grid.t(m, dev) for m in _METRICS]
        dzh = grid.t("dzh", dev) if buoy else None
        ekm = torch.empty(grid.shape, dtype=dtype, device=dev)
        ekh = torch.empty(grid.shape, dtype=dtype, device=dev)
        sg = cfg.subgrid
        self.run("fused_vreman", dtype, dev, g.u, g.v, g.w,
                 thl if buoy else None, dthvdz if buoy else None, *metrics,
                 dzh, ekm, ekh, nx, ny, nz, grid.dxi, grid.dyi, grid.dxiq,
                 grid.dyiq, grid.dx2, grid.dy2, sg.c_vreman,
                 1.0 / sg.prandtl, const.numol * const.prandtlmoli,
                 const.numol, const.grav, sg.rigc)
        self.launch_count += 1
        return ekm, ekh


# The process-wide wrapper: `fused_vreman(g, grid, cfg, dthvdz, thl)` is
# the call `closure` makes, `fused_vreman.launch_count` the counter a run
# reads.
fused_vreman = FusedVreman()


def closure(g, grid: Grid, cfg: Config, e12=None, dthvdz=None, thl=None,
            thvs=None):
    """``subgrid.closure`` (interior ekm, ekh and zlt) with the Vreman
    model through `fused_vreman`: the kernel on the card, the plain
    ``vreman_closure`` on the CPU."""
    if cfg.subgrid.model == SGS_VREMAN:
        ekm, ekh = fused_vreman(g, grid, cfg, dthvdz, thl)
        return ekm, ekh, None
    return sgs.closure(g, grid, cfg, e12=e12, dthvdz=dthvdz, thl=thl,
                       thvs=thvs)
