"""The advection leaf of a substep: the hand-written CUDA kernel and its
wrapper.

cd2 advection of u, v and w with the pressure-gradient terms, and cd2
advection of thl where the case advects it so, in one pass over the grid
(``udales_tpu_torch/csrc/fused_adv_mom.cu``).  It replaces no Pallas
kernel: the leaf's ~145 whole-field torch operations a substep ran at 2.4%
of its memory bound on the H100.  The source is compiled with ``nvcc`` for
``sm_90a`` into a plain-C shared library on first use (``_build/``, as
``ops/fused_diff.py`` builds its kernel) and bound with ``ctypes``.

What bounds it is bytes: per point it reads five ghosted input fields and
writes four tendencies.  The design is ``fused_diff_mom``'s plane ring (the
source's note has it).

For CPU tensors the wrapper returns the plain ``advection.adv_mom``, which
is also the kernel's reference.  For CUDA tensors it launches the kernel
or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import trace
from ..grid import Grid
from . import advection as adv
from .fused_diff import (blocks_per_sm, check_inputs, check_launch,
                         compile_library)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fused_adv_mom.cu"
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


class FusedAdvMom:
    """Callable wrapper around the CUDA kernel.

    ``launch_count`` counts launches (never the CPU path), so a run can
    show that its main path went through the kernel.  It is a counter of
    the run's trace (``fused_adv_mom.launches``), so a call captured into
    a CUDA graph counts once per replay (``graph.CompiledStep``).
    ``build_log`` holds nvcc's output (register and spill report) after
    the build."""

    launch_count = trace.counter("fused_adv_mom.launches")

    def __init__(self):
        self.launch_count = 0
        self.build_log = ""
        self._lib = None

    # -- build -------------------------------------------------------------
    def load(self):
        """Build if needed, then load the library and declare its entry
        points."""
        if self._lib is None:
            path, self.build_log = compile_library(SOURCE)
            lib = ctypes.CDLL(str(path))
            p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            for fn in (lib.fused_adv_mom_f32, lib.fused_adv_mom_f64):
                fn.argtypes = [p] * 13 + [i] * 3 + [d] * 6 + [p]
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def blocks_per_sm(self, dtype, thl: bool) -> int:
        """Resident blocks per SM of one instantiation on the current card
        (the CUDA occupancy calculator's answer)."""
        return blocks_per_sm(self.load(), "fused_adv_mom", dtype, thl)

    # -- call --------------------------------------------------------------
    def __call__(self, g, gp, grid: Grid, thl: bool = False):
        """(du, dv, dw, dthl) from the h=1 ghosted ``g.u, g.v, g.w`` (and
        ``g.thl`` when `thl`; else dthl is None) and the pressure `gp`
        padded by one cell in x and y (``run._pad_pres``)."""
        dev = g.u.device
        if dev.type == "cpu":
            return adv.adv_mom(g, gp, grid, thl)
        if dev.type != "cuda":
            raise ValueError(f"fused_adv_mom: unsupported device {dev}")
        return self._launch(g, gp, grid, thl)

    def _launch(self, g, gp, grid: Grid, thl: bool):
        nx, ny, nz = grid.shape
        dtype = g.u.dtype
        cell = (nx + 2, ny + 2, nz + 2)
        inputs = [("u", g.u, cell), ("v", g.v, cell),
                  ("w", g.w, (nx + 2, ny + 2, nz + 1)),
                  ("p", gp, (nx + 2, ny + 2, nz))]
        if thl:
            inputs.append(("thl", g.thl, cell))
        check_inputs("fused_adv_mom", grid, inputs)
        lib = self.load()
        dev = g.u.device
        metrics = [grid.t(name, dev) for name in _METRICS]
        du = torch.empty((nx, ny, nz), dtype=dtype, device=dev)
        dv = torch.empty((nx, ny, nz), dtype=dtype, device=dev)
        dw = torch.empty((nx, ny, nz + 1), dtype=dtype, device=dev)
        dthl = torch.empty((nx, ny, nz), dtype=dtype, device=dev) \
            if thl else None
        fn = (lib.fused_adv_mom_f32 if dtype == torch.float32
              else lib.fused_adv_mom_f64)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(g.u.data_ptr(), g.v.data_ptr(), g.w.data_ptr(),
                     gp.data_ptr(), g.thl.data_ptr() if thl else None,
                     *[m.data_ptr() for m in metrics],
                     du.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                     dthl.data_ptr() if thl else None,
                     nx, ny, nz, grid.dxi, grid.dyi, grid.dxiq, grid.dyiq,
                     grid.dxi5, grid.dyi5, stream)
        check_launch("fused_adv_mom", err)
        self.launch_count += 1
        return du, dv, dw, dthl


# The process-wide wrapper: `fused_adv_mom(g, gp, grid, thl)` is the call
# the substep makes, `fused_adv_mom.launch_count` the counter a run reads.
fused_adv_mom = FusedAdvMom()
