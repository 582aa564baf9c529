"""Fused SGS momentum diffusion: the hand-written CUDA kernel and its wrapper.

Replaces the TPU Pallas kernel ``udales_tpu/ops/pallas_stencil.py:
fused_diff_mom`` (pallas_call at :344).  The kernel source is
``udales_tpu_torch/csrc/fused_diff_mom.cu``; it is compiled with ``nvcc`` for
``sm_90a`` into a plain-C shared library on first use (into ``_build/``
beside this package) and bound with ``ctypes``.

What bounds it on the H100 is bytes: per point it reads ~4 ghosted input
fields and writes 3 outputs, memory-bound at 3.35 TB/s.  The first design is
one thread per output point with z contiguous across threads, so neighbour
loads coalesce and repeat reads hit L1/L2; shared-memory tiling comes later.

For CPU tensors the wrapper returns the plain sweeps ``subgrid.diff_u/v/w``,
which are also the kernel's reference.  For CUDA tensors it launches the
kernel or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..grid import Grid
from . import subgrid as sgs

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "fused_diff_mom.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_METRICS = ("dzf_g", "dzhiq", "dzhi", "dzfi_g")


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")
    return found


class FusedDiffMom:
    """Callable wrapper around the CUDA kernel.

    ``launch_count`` counts kernel launches (never the CPU path), so a run
    can show that its main path went through the kernel.  ``build_log``
    holds nvcc's output (register and spill report) after the build."""

    def __init__(self):
        self.launch_count = 0
        self.build_log = ""
        self._lib = None

    # -- build -------------------------------------------------------------
    def build(self) -> Path:
        """Compile the kernel library if this source has not been built;
        returns its path.  The file name carries the source and flag hash,
        so a stale library is never loaded."""
        src = SOURCE.read_bytes()
        tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        lib = BUILD_DIR / f"libfused_diff_mom-{tag[:16]}.so"
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run([_find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                  str(SOURCE)], capture_output=True,
                                 text=True)
            self.build_log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {SOURCE}:\n{self.build_log}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return lib

    def load(self):
        """Build if needed, then load the library and declare its entry
        points."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            for fn in (lib.fused_diff_mom_f32, lib.fused_diff_mom_f64):
                fn.argtypes = [p] * 11 + [i] * 3 + [d] * 4 + [p]
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    # -- call --------------------------------------------------------------
    def __call__(self, g, grid: Grid, pmasks=None):
        """(du, dv, dw) SGS momentum tendencies from the h=1 ghosted
        ``g.u, g.v, g.w, g.ekm`` (ops/boundary.py conventions)."""
        dev = g.u.device
        if dev.type == "cpu":
            if pmasks is None:
                return (sgs.diff_u(g, grid), sgs.diff_v(g, grid),
                        sgs.diff_w(g, grid))
            return (sgs.diff_u(g, grid, M=pmasks["u"]),
                    sgs.diff_v(g, grid, M=pmasks["v"]),
                    sgs.diff_w(g, grid, M=pmasks["w"]))
        if dev.type != "cuda":
            raise ValueError(f"fused_diff_mom: unsupported device {dev}")
        if pmasks is not None:
            raise NotImplementedError(
                "fused_diff_mom: IBM pmasks are not supported by the CUDA "
                "kernel yet")
        return self._launch(g, grid)

    def _launch(self, g, grid: Grid):
        nx, ny, nz = grid.shape
        dtype = g.u.dtype
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"fused_diff_mom: unsupported dtype {dtype}")
        if dtype != grid.torch_dtype:   # the metric vectors come in this type
            raise ValueError(f"fused_diff_mom: fields are {dtype}, grid "
                             f"metrics {grid.torch_dtype}")
        cell = (nx + 2, ny + 2, nz + 2)
        for name, t, shape in (("u", g.u, cell), ("v", g.v, cell),
                               ("w", g.w, (nx + 2, ny + 2, nz + 1)),
                               ("ekm", g.ekm, cell)):
            if t.device != g.u.device or t.dtype != dtype:
                raise ValueError(f"fused_diff_mom: {name} is {t.dtype} on "
                                 f"{t.device}, expected {dtype} on "
                                 f"{g.u.device}")
            if tuple(t.shape) != shape:
                raise ValueError(f"fused_diff_mom: {name} has shape "
                                 f"{tuple(t.shape)}, expected {shape}")
            if not t.is_contiguous():
                raise ValueError(f"fused_diff_mom: {name} is not contiguous")
        lib = self.load()
        dev = g.u.device
        metrics = [grid.t(name, dev) for name in _METRICS]
        du = torch.empty((nx, ny, nz), dtype=dtype, device=dev)
        dv = torch.empty((nx, ny, nz), dtype=dtype, device=dev)
        dw = torch.empty((nx, ny, nz + 1), dtype=dtype, device=dev)
        fn = (lib.fused_diff_mom_f32 if dtype == torch.float32
              else lib.fused_diff_mom_f64)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(g.u.data_ptr(), g.v.data_ptr(), g.w.data_ptr(),
                     g.ekm.data_ptr(), *[m.data_ptr() for m in metrics],
                     du.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                     nx, ny, nz, grid.dxi, grid.dyi, grid.dx2i, grid.dy2i,
                     stream)
        if err != 0:
            raise RuntimeError(f"fused_diff_mom: CUDA launch failed with "
                               f"cudaError {err}")
        self.launch_count += 1
        return du, dv, dw


# The process-wide wrapper: `fused_diff_mom(g, grid)` is the call the
# substep makes, `fused_diff_mom.launch_count` the counter a run reads.
fused_diff_mom = FusedDiffMom()
