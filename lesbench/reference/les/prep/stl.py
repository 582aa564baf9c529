"""Minimal STL reader/writer (binary + ASCII).

Replaces the trimesh dependency of the reference's udgeom package
(tools/python/udgeom/udgeom.py) for the preprocessing pipeline."""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def read_stl(path: str | Path):
    """-> (tris (n,3,3) float64 vertex coords, normals (n,3))."""
    data = Path(path).read_bytes()
    if data[:5] == b"solid" and b"facet" in data[:1000]:
        return _read_ascii(data.decode("ascii", errors="ignore"))
    n = struct.unpack_from("<I", data, 80)[0]
    rec = np.frombuffer(data, dtype=np.uint8, count=n * 50, offset=84)
    rec = rec.reshape(n, 50)
    f = rec[:, :48].copy().view("<f4").reshape(n, 12)
    normals = f[:, 0:3].astype(np.float64)
    tris = f[:, 3:12].reshape(n, 3, 3).astype(np.float64)
    return tris, _fix_normals(tris, normals)


def _read_ascii(text: str):
    verts, normals = [], []
    cur = []
    for line in text.splitlines():
        t = line.split()
        if not t:
            continue
        if t[0] == "facet" and t[1] == "normal":
            normals.append([float(x) for x in t[2:5]])
        elif t[0] == "vertex":
            cur.append([float(x) for x in t[1:4]])
            if len(cur) == 3:
                verts.append(cur)
                cur = []
    tris = np.asarray(verts)
    return tris, _fix_normals(tris, np.asarray(normals))


def _fix_normals(tris, normals):
    """Recompute degenerate/zero normals from vertex winding."""
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    cn = np.cross(e1, e2)
    ln = np.linalg.norm(cn, axis=1, keepdims=True)
    cn = np.divide(cn, np.maximum(ln, 1e-300))
    bad = np.linalg.norm(normals, axis=1) < 1e-6
    out = normals.copy()
    out[bad] = cn[bad]
    # normalize
    n = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(n, 1e-300)


def write_stl(path: str | Path, tris: np.ndarray, normals=None):
    tris = np.asarray(tris, np.float32)
    n = len(tris)
    if normals is None:
        normals = _fix_normals(tris.astype(np.float64),
                               np.zeros((n, 3))).astype(np.float32)
    with open(path, "wb") as f:
        f.write(b"udales_tpu stl".ljust(80, b"\0"))
        f.write(struct.pack("<I", n))
        for i in range(n):
            f.write(np.asarray(normals[i], "<f4").tobytes())
            f.write(np.asarray(tris[i], "<f4").tobytes())
            f.write(b"\0\0")


def triangle_areas(tris):
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
