"""ctypes bindings for the native (C++) preprocessing kernels.

Builds ibmprep.cpp (beside this file) on first use with g++ -O3 into the
benchmark's cache directory (``.lesbench_cache/`` at the checkout's root)
and exposes `grid_solid_mask` / `cut_sections`.  The numpy implementations
in prep/geom.py / prep/ibmprep.py remain the reference semantics; the
native path is validated against them in tests/test_prep_native.py."""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("ibmprep.cpp")
_SO = Path(__file__).resolve().parents[4] / ".lesbench_cache" / "libibmprep.so"
_lib = None


def _build():
    """Compile into a file of this process's own, then rename it into
    place, so that an interrupted build leaves no library behind."""
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_name(f".{_SO.name}.{os.getpid()}")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-fopenmp",
           "-o", str(tmp), str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        # retry without OpenMP
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)]
        subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if (not _SO.exists()
            or _SO.stat().st_mtime < _SRC.stat().st_mtime):
        _build()
    lib = ctypes.CDLL(str(_SO))
    d = ctypes.POINTER(ctypes.c_double)
    l = ctypes.POINTER(ctypes.c_long)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.grid_solid_mask.restype = None
    lib.grid_solid_mask.argtypes = [
        d, d, ctypes.c_long, d, ctypes.c_long, d, ctypes.c_long,
        d, ctypes.c_long, ctypes.c_double, u8]
    lib.cut_sections.restype = ctypes.c_long
    lib.cut_sections.argtypes = [
        d, d, l, ctypes.c_long,
        d, d, ctypes.c_long, d, d, ctypes.c_long, d, d, ctypes.c_long,
        d, d, d, u8, ctypes.c_int, ctypes.c_double,
        ctypes.c_long, l, d, l, d]
    _lib = lib
    return lib


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _lp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_long))


def _up(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def grid_solid_mask(tris, normals, xs, ys, zs, tol=1e-7):
    lib = get_lib()
    tris = np.ascontiguousarray(tris, np.float64)
    normals = np.ascontiguousarray(normals, np.float64)
    xs = np.ascontiguousarray(xs, np.float64)
    ys = np.ascontiguousarray(ys, np.float64)
    zs = np.ascontiguousarray(zs, np.float64)
    out = np.zeros((len(xs), len(ys), len(zs)), np.uint8)
    lib.grid_solid_mask(_dp(tris), _dp(normals), len(tris),
                        _dp(xs), len(xs), _dp(ys), len(ys),
                        _dp(zs), len(zs), tol, _up(out))
    return out.astype(bool)


def cut_sections(tris, normals, facids, boxes, points, fluid,
                 skip_axis: int, area_tol=1e-9):
    """boxes: ((bxlo,bxhi),(bylo,byhi),(bzlo,bzhi)); points: (px,py,pz)."""
    lib = get_lib()
    tris = np.ascontiguousarray(tris, np.float64)
    normals = np.ascontiguousarray(normals, np.float64)
    facids = np.ascontiguousarray(facids, np.int64)
    (bxlo, bxhi), (bylo, byhi), (bzlo, bzhi) = [
        (np.ascontiguousarray(a, np.float64),
         np.ascontiguousarray(b, np.float64)) for a, b in boxes]
    px, py, pz = [np.ascontiguousarray(p, np.float64) for p in points]
    fl = np.ascontiguousarray(fluid.astype(np.uint8))
    cap = 4 * len(tris) + 64 * int(fl.size ** (2 / 3)) + 100000
    while True:
        of = np.zeros(cap, np.int64)
        oa = np.zeros(cap, np.float64)
        oi = np.zeros(3 * cap, np.int64)
        od = np.zeros(cap, np.float64)
        n = lib.cut_sections(
            _dp(tris), _dp(normals), _lp(facids), len(tris),
            _dp(bxlo), _dp(bxhi), len(bxlo),
            _dp(bylo), _dp(byhi), len(bylo),
            _dp(bzlo), _dp(bzhi), len(bzlo),
            _dp(px), _dp(py), _dp(pz), _up(fl), skip_axis, area_tol,
            cap, _lp(of), _dp(oa), _lp(oi), _dp(od))
        if n >= 0:
            break
        cap = max(2 * cap, -n + 1000)
    return (of[:n], oa[:n], oi[:3 * n].reshape(n, 3), od[:n])


# ---------------------------------------------------------------------------
