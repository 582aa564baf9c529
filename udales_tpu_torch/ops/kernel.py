"""The seam of the hand-written CUDA kernels: build, bind, check, launch.

A kernel is ``csrc/<name>.cu`` with a plain-C interface: launchers
``<name>[_<variant>]_{f32,f64}(pointers, ints, doubles, stream)`` that
return a cudaError, and ``<name>_blocks_per_sm(f64, variant)``.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library on first use
(into ``_build/`` beside this package) and bound with ``ctypes``.
`HandKernel` holds what the wrappers share; each wrapper
(``ops/fused_diff.py``, ``ops/fused_adv.py``, ``ops/fused_vreman.py``,
``ops/fused_ibmnorm.py``) keeps what is its own.
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

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# a signature's letters: a pointer, an int, a double
CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "d": ctypes.c_double}


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")
    return found


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


class HandKernel:
    """Callable wrapper around one kernel: CPU tensors take ``plain``, the
    plain route and the kernel's reference; CUDA tensors ``launch`` the
    kernel; any other device raises (there is no fallback).

    A subclass sets `name` (its symbols' prefix and its messages'),
    `source`, `flags` and `signatures`: each launcher's parameters, a
    letter of `CTYPES` each, as its ``extern "C"`` declaration lists them.
    It defines ``inputs`` (the (name, tensor, shape) list that
    `check_inputs` holds a call to), ``plain`` and ``launch``, which take
    the call's arguments; the first is the ghost set ``g``, read for the
    device.  Its launch counters are ``trace.counter``s, so a call captured
    into a CUDA graph counts once per replay (``graph.CompiledStep``).
    ``build_log`` holds nvcc's output (register and spill report)."""

    name: str
    source: Path
    flags = NVCC_FLAGS
    signatures: dict

    def __init__(self):
        self.build_log = ""
        self._lib = None
        for klass in type(self).__mro__:   # register the counters at zero
            for attr, value in vars(klass).items():
                if isinstance(value, trace.counter):
                    setattr(self, attr, 0)

    def load(self):
        """Build if needed (`compile_library`), then load the library and
        declare its launchers."""
        if self._lib is None:
            path, self.build_log = compile_library(self.source, self.flags)
            lib = ctypes.CDLL(str(path))
            for entry, params in self.signatures.items():
                fn = getattr(lib, entry)
                fn.argtypes = [CTYPES[c] for c in params]
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def blocks_per_sm(self, dtype, variant: bool) -> int:
        """Resident blocks per SM of one instantiation on the current card
        (the CUDA occupancy calculator's answer, from the library's
        ``<name>_blocks_per_sm``)."""
        fn = getattr(self.load(), f"{self.name}_blocks_per_sm")
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
        n = fn(int(dtype == torch.float64), int(variant))
        if n < 0:
            raise RuntimeError(f"{self.name}: occupancy query failed with "
                               f"cudaError {-n}")
        return n

    def __call__(self, g, *args, **kw):
        dev = g.u.device
        if dev.type == "cpu":
            return self.plain(g, *args, **kw)
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device {dev}")
        return self.launch(g, *args, **kw)

    def run(self, launcher: str, dtype, dev, *args) -> None:
        """Call ``<launcher>_f32`` or ``_f64`` (by `dtype`) with `args` (a
        tensor passes its data pointer) on the current stream of `dev`;
        raise if it returned a cudaError."""
        fn = getattr(self.load(), launcher
                     + ("_f32" if dtype == torch.float32 else "_f64"))
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with "
                               f"cudaError {err}")
