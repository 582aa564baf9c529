"""Fused SGS momentum diffusion: the hand-written CUDA kernel and its wrapper.

Replaces the TPU Pallas kernel ``udales_tpu/ops/pallas_stencil.py:
fused_diff_mom`` (pallas_call at :344).  The kernel source is
``udales_tpu_torch/csrc/fused_diff_mom.cu``; it is compiled with ``nvcc`` for
``sm_90a`` into a plain-C shared library on first use (into ``_build/``
beside this package) and bound with ``ctypes``.

What bounds it on the H100 is bytes: per point it reads ~4 ghosted input
fields and writes 3 outputs, memory-bound at 3.35 TB/s.  A block owns a
(j, k) window and marches along i with a ring of planes in shared memory
that ``cp.async`` fills ahead of the march, so every input byte crosses
from L2 to an SM about once (the design notes are in the source).

Two variants share the source: the unmasked kernel of the flat path and
the masked one of the urban path, which also reads the ghosted IBM fluid
masks ``pmask_u/v/w`` and folds the IBM diffusion corrections into the
sweep (JAX sends that case to its jnp sweeps, pallas_stencil.py:204-207).

For CPU tensors the wrapper returns the plain sweeps ``subgrid.diff_u/v/w``
(with ``M=`` the pmasks), which are also the kernels' reference.  For CUDA
tensors it launches a kernel or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .. import trace
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


def compile_library(source: Path, flags=NVCC_FLAGS):
    """Compile `source` with nvcc into a shared library under ``_build/``
    unless that was done before; returns (path, nvcc's output, "" when the
    library was there already).  The file name carries the hash of the
    source and the flags, so a stale library is never loaded.  Processes
    that start together (the ranks of a split run) build one after another
    under a lock on ``_build/.lock``, which the system releases when its
    holder exits: the first builds, the others find the library."""
    tag = hashlib.sha1(source.read_bytes()
                       + " ".join(flags).encode()).hexdigest()
    lib = BUILD_DIR / f"lib{source.stem}-{tag[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib, ""
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run([_find_nvcc(), *flags, "-o", tmp,
                                  str(source)], capture_output=True,
                                 text=True)
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source}:\n{log}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return lib, log


def check_inputs(kernel: str, grid: Grid, inputs) -> None:
    """Raise unless the tensors a kernel reads through raw pointers are what
    it takes: each (name, tensor, shape) of `inputs` present, float32 or
    float64 in the type of the grid's metric vectors and of the first, on
    the first one's device, of `shape` and contiguous.  `kernel` names the
    kernel in the messages."""
    like = inputs[0][1]
    dtype = like.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kernel}: unsupported dtype {dtype}")
    if dtype != grid.torch_dtype:   # the metric vectors come in this type
        raise ValueError(f"{kernel}: fields are {dtype}, grid metrics "
                         f"{grid.torch_dtype}")
    for name, t, shape in inputs:
        if t is None:
            raise ValueError(f"{kernel}: {name} is missing")
        if t.device != like.device or t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {like.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")


def blocks_per_sm(lib, kernel: str, dtype, variant: bool) -> int:
    """Resident blocks per SM of one instantiation of `kernel` in `lib` on
    the current card (the CUDA occupancy calculator's answer, from the
    library's ``<kernel>_blocks_per_sm``)."""
    fn = getattr(lib, f"{kernel}_blocks_per_sm")
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn(int(dtype == torch.float64), int(variant))
    if n < 0:
        raise RuntimeError(f"{kernel}: occupancy query failed with "
                           f"cudaError {-n}")
    return n


def check_launch(kernel: str, err: int) -> None:
    """Raise if a launcher returned a cudaError."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError "
                           f"{err}")


class FusedDiffMom:
    """Callable wrapper around the CUDA kernels.

    ``launch_count`` counts launches of the unmasked kernel and
    ``masked_launch_count`` those of the masked one (never the CPU path),
    so a run can show that its main path went through them.  They are
    counters of the run's trace (``fused_diff_mom.launches``,
    ``fused_diff_mom.masked_launches``), so a call captured into a CUDA
    graph counts once per replay (``graph.CompiledStep``).  ``build_log``
    holds nvcc's output (register and spill report) after the build."""

    launch_count = trace.counter("fused_diff_mom.launches")
    masked_launch_count = trace.counter("fused_diff_mom.masked_launches")

    def __init__(self):
        self.launch_count = 0
        self.masked_launch_count = 0
        self.build_log = ""
        self._lib = None

    # -- build -------------------------------------------------------------
    def build(self) -> Path:
        """Compile the kernel library if this source has not been built;
        returns its path."""
        lib, self.build_log = compile_library(SOURCE)
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
            for fn in (lib.fused_diff_mom_masked_f32,
                       lib.fused_diff_mom_masked_f64):
                fn.argtypes = [p] * 14 + [i] * 3 + [d] * 4 + [p]
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def blocks_per_sm(self, dtype, masked: bool) -> int:
        """Resident blocks per SM of one instantiation on the current card
        (the CUDA occupancy calculator's answer)."""
        return blocks_per_sm(self.load(), "fused_diff_mom", dtype, masked)

    # -- call --------------------------------------------------------------
    def __call__(self, g, grid: Grid, pmasks=None):
        """(du, dv, dw) SGS momentum tendencies from the h=1 ghosted
        ``g.u, g.v, g.w, g.ekm`` (ops/boundary.py conventions); `pmasks`
        {"u", "v", "w"}: the ghosted IBM fluid masks (``ibm.IBM.pmask_*``)
        or None."""
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
        return self._launch(g, grid, pmasks)

    def _launch(self, g, grid: Grid, pmasks=None):
        nx, ny, nz = grid.shape
        dtype = g.u.dtype
        cell = (nx + 2, ny + 2, nz + 2)
        inputs = [("u", g.u, cell), ("v", g.v, cell),
                  ("w", g.w, (nx + 2, ny + 2, nz + 1)), ("ekm", g.ekm, cell)]
        if pmasks is not None:
            # pmask_w: x/y-ghosted faces 0..nz plus one top ghost face
            inputs += [(f"pmask_{k}", pmasks[k], cell) for k in "uvw"]
        check_inputs("fused_diff_mom", grid, inputs)
        lib = self.load()
        dev = g.u.device
        metrics = [grid.t(name, dev) for name in _METRICS]
        du = torch.empty((nx, ny, nz), dtype=dtype, device=dev)
        dv = torch.empty((nx, ny, nz), dtype=dtype, device=dev)
        dw = torch.empty((nx, ny, nz + 1), dtype=dtype, device=dev)
        f32 = dtype == torch.float32
        if pmasks is None:
            fn = lib.fused_diff_mom_f32 if f32 else lib.fused_diff_mom_f64
            masks = []
        else:
            fn = (lib.fused_diff_mom_masked_f32 if f32
                  else lib.fused_diff_mom_masked_f64)
            masks = [pmasks[k].data_ptr() for k in "uvw"]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(g.u.data_ptr(), g.v.data_ptr(), g.w.data_ptr(),
                     g.ekm.data_ptr(), *masks,
                     *[m.data_ptr() for m in metrics],
                     du.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                     nx, ny, nz, grid.dxi, grid.dyi, grid.dx2i, grid.dy2i,
                     stream)
        check_launch("fused_diff_mom", err)
        if pmasks is None:
            self.launch_count += 1
        else:
            self.masked_launch_count += 1
        return du, dv, dw


# The process-wide wrapper: `fused_diff_mom(g, grid, pmasks)` is the call
# the substep makes, `fused_diff_mom.launch_count` and
# `.masked_launch_count` the counters a run reads.
fused_diff_mom = FusedDiffMom()
