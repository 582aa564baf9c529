"""The Vreman closure: the hand-written CUDA kernel and its wrapper.

The velocity-gradient tensor, Vreman's invariants aa and bb, ekm and ekh
(with the stable-stratification correction where the case asks for it) in
one pass over the grid (``udales_tpu_torch/csrc/fused_vreman.cu``).  It
replaces no Pallas kernel: the closure's ~135 whole-field torch operations
a call ran at about 1% of its memory bound on the H100.  The source is
compiled with ``nvcc`` for ``sm_90a``, without FMA contraction, into a
plain-C shared library on first use (``_build/``, as ``ops/fused_diff.py``
builds its kernel) and bound with ``ctypes``.

What bounds it is bytes: per point it reads the three ghosted velocities
and writes ekm and ekh.  The design is ``fused_diff_mom``'s plane ring (the
source's note has it).

For CPU tensors the wrapper returns the plain ``subgrid.vreman_closure``,
which is also the kernel's reference.  For CUDA tensors it launches the
kernel or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import trace
from ..config import Config, const
from ..grid import Grid
from . import fused_diff, subgrid as sgs

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fused_vreman.cu"
# added to fused_diff's flags: no FMA contraction, so that each product and
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


class FusedVreman:
    """Callable wrapper around the CUDA kernel.

    ``launch_count`` counts launches (never the CPU path), so a run can
    show that every Vreman call went through the kernel.  It is a counter
    of the run's trace (``fused_vreman.launches``), so a call captured
    into a CUDA graph counts once per replay (``graph.CompiledStep``).
    ``build_log`` holds nvcc's output (register and spill report) after
    the build."""

    launch_count = trace.counter("fused_vreman.launches")

    def __init__(self):
        self.launch_count = 0
        self.build_log = ""
        self._lib = None

    # -- build -------------------------------------------------------------
    def load(self):
        """Build if needed, then load the library and declare its entry
        points."""
        if self._lib is None:
            path, self.build_log = fused_diff.compile_library(
                SOURCE, fused_diff.NVCC_FLAGS + NO_FMA)
            lib = ctypes.CDLL(str(path))
            p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            for fn in (lib.fused_vreman_f32, lib.fused_vreman_f64):
                fn.argtypes = [p] * 13 + [i] * 3 + [d] * 12 + [p]
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def blocks_per_sm(self, dtype, buoy: bool) -> int:
        """Resident blocks per SM of one instantiation on the current card
        (the CUDA occupancy calculator's answer)."""
        return fused_diff.blocks_per_sm(self.load(), "fused_vreman", dtype,
                                        buoy)

    # -- call --------------------------------------------------------------
    def __call__(self, g, grid: Grid, cfg: Config, dthvdz=None, thl=None):
        """(ekm, ekh) at the cell centres from the h=1 ghosted ``g.u, g.v,
        g.w`` (``run._velocity_ghosts``); the interior `dthvdz` and `thl`
        are read only where the case applies the buoyancy correction."""
        dev = g.u.device
        if dev.type == "cpu":
            return sgs.vreman_closure(g, grid, cfg, dthvdz, thl)
        if dev.type != "cuda":
            raise ValueError(f"fused_vreman: unsupported device {dev}")
        return self._launch(g, grid, cfg, dthvdz, thl)

    def _launch(self, g, grid: Grid, cfg: Config, dthvdz, thl):
        nx, ny, nz = grid.shape
        dtype = g.u.dtype
        cell = (nx + 2, ny + 2, nz + 2)
        inputs = [("u", g.u, cell), ("v", g.v, cell),
                  ("w", g.w, (nx + 2, ny + 2, nz + 1))]
        buoy = sgs.buoycorr(cfg)
        if buoy:    # the correction reads the interior thl and dthvdz
            inputs += [("thl", thl, grid.shape),
                       ("dthvdz", dthvdz, grid.shape)]
        fused_diff.check_inputs("fused_vreman", grid, inputs)
        lib = self.load()
        dev = g.u.device
        metrics = [grid.t(name, dev) for name in _METRICS]
        dzh = grid.t("dzh", dev) if buoy else None
        ekm = torch.empty(grid.shape, dtype=dtype, device=dev)
        ekh = torch.empty(grid.shape, dtype=dtype, device=dev)
        sg = cfg.subgrid
        fn = (lib.fused_vreman_f32 if dtype == torch.float32
              else lib.fused_vreman_f64)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(g.u.data_ptr(), g.v.data_ptr(), g.w.data_ptr(),
                     thl.data_ptr() if buoy else None,
                     dthvdz.data_ptr() if buoy else None,
                     *[m.data_ptr() for m in metrics],
                     dzh.data_ptr() if buoy else None,
                     ekm.data_ptr(), ekh.data_ptr(), nx, ny, nz,
                     grid.dxi, grid.dyi, grid.dxiq, grid.dyiq, grid.dx2,
                     grid.dy2, sg.c_vreman, 1.0 / sg.prandtl,
                     const.numol * const.prandtlmoli, const.numol,
                     const.grav, sg.rigc, stream)
        fused_diff.check_launch("fused_vreman", err)
        self.launch_count += 1
        return ekm, ekh


# The process-wide wrapper: `fused_vreman(g, grid, cfg, dthvdz, thl)` is
# the call `subgrid.closure` makes, `fused_vreman.launch_count` the counter
# a run reads.
fused_vreman = FusedVreman()
