"""Computational geometry kernels for the IBM preprocessor.

Vectorized numpy replacements for the reference's Fortran preprocessing
(tools/python/fortran/ibm_preproc/: in_mypoly_functions.f90 ray casting,
matchFacetsCells.f90 triangle-box matching, and the MATLAB
sutherlandHodgman3D.m clipping)."""
from __future__ import annotations

import numpy as np

EPS = 1e-9


def points_inside(points: np.ndarray, tris: np.ndarray,
                  on_surface_tol: float = 1e-7) -> np.ndarray:
    """Ray-parity point-in-solid test with +z rays, vectorized over points.

    A point lying on the surface (within tol along any facet's plane while
    inside its triangle) counts as inside — the reference masks on-facet
    staggered points as solid (e.g. floor w-points, modibm floor handling).

    points: (np,3); tris: (nt,3,3). Returns bool (np,)."""
    pts = np.asarray(points, np.float64)
    A, B, C = tris[:, 0], tris[:, 1], tris[:, 2]
    npts = len(pts)
    inside = np.zeros(npts, bool)
    onsurf = np.zeros(npts, bool)

    # process in chunks to bound memory: (chunk, nt) pairwise tests
    chunk = max(1, int(4e7 // max(len(tris), 1)))
    # precompute 2-D projection (x,y) barycentric setup for z-rays
    A2, B2, C2 = A[:, :2], B[:, :2], C[:, :2]
    d = ((B2[:, 1] - C2[:, 1]) * (A2[:, 0] - C2[:, 0])
         + (C2[:, 0] - B2[:, 0]) * (A2[:, 1] - C2[:, 1]))
    degen = np.abs(d) < 1e-14          # vertical triangles: no z-crossing
    dsafe = np.where(degen, 1.0, d)
    n = np.cross(B - A, C - A)
    nz = n[:, 2]

    for s in range(0, npts, chunk):
        p = pts[s: s + chunk]                       # (m,3)
        px, py, pz = p[:, 0:1], p[:, 1:2], p[:, 2:3]
        l1 = ((B2[:, 1] - C2[:, 1]) * (px - C2[:, 0])
              + (C2[:, 0] - B2[:, 0]) * (py - C2[:, 1])) / dsafe
        l2 = ((C2[:, 1] - A2[:, 1]) * (px - C2[:, 0])
              + (A2[:, 0] - C2[:, 0]) * (py - C2[:, 1])) / dsafe
        l3 = 1.0 - l1 - l2
        # shared-edge double counting avoided with half-open test
        intri = ((l1 > -1e-12) & (l2 > -1e-12) & (l3 > -1e-12)
                 & ~degen[None, :])
        zhit = l1 * A[:, 2] + l2 * B[:, 2] + l3 * C[:, 2]
        on = intri & (np.abs(zhit - pz) <= on_surface_tol)
        above = intri & (zhit > pz + on_surface_tol)
        # parity: count crossings, but only once per geometric surface point:
        # weight boundary hits (l==0 edges) by 1/2 so shared edges sum to 1
        w = np.ones_like(l1)
        edge = ((np.abs(l1) <= 1e-12) | (np.abs(l2) <= 1e-12)
                | (np.abs(l3) <= 1e-12))
        w = np.where(edge, 0.5, 1.0)
        cnt = np.sum(above * w, axis=1)
        inside[s: s + chunk] = (np.round(cnt).astype(int) % 2) == 1
        onsurf[s: s + chunk] = on.any(axis=1)
    return inside | onsurf


def grid_inside(xs: np.ndarray, ys: np.ndarray, zs: np.ndarray,
                tris: np.ndarray, on_surface_tol: float = 1e-7) -> np.ndarray:
    """points_inside specialised for a tensor-product grid: the z-ray
    triangle intersections are computed once per (x,y) column and reused for
    every z level (factor nz speedup). Returns bool (nx,ny,nz)."""
    A, B, C = tris[:, 0], tris[:, 1], tris[:, 2]
    A2, B2, C2 = A[:, :2], B[:, :2], C[:, :2]
    d = ((B2[:, 1] - C2[:, 1]) * (A2[:, 0] - C2[:, 0])
         + (C2[:, 0] - B2[:, 0]) * (A2[:, 1] - C2[:, 1]))
    degen = np.abs(d) < 1e-14
    dsafe = np.where(degen, 1.0, d)
    nx, ny, nz = len(xs), len(ys), len(zs)
    out = np.zeros((nx, ny, nz), bool)
    zs = np.asarray(zs)

    X, Y = np.meshgrid(xs, ys, indexing="ij")
    cols = np.stack([X.ravel(), Y.ravel()], axis=1)   # (ncol, 2)
    ncol = len(cols)
    chunk = max(1, int(2e7 // max(len(tris), 1)))
    for s in range(0, ncol, chunk):
        px = cols[s:s + chunk, 0:1]
        py = cols[s:s + chunk, 1:2]
        l1 = ((B2[:, 1] - C2[:, 1]) * (px - C2[:, 0])
              + (C2[:, 0] - B2[:, 0]) * (py - C2[:, 1])) / dsafe
        l2 = ((C2[:, 1] - A2[:, 1]) * (px - C2[:, 0])
              + (A2[:, 0] - C2[:, 0]) * (py - C2[:, 1])) / dsafe
        l3 = 1.0 - l1 - l2
        intri = ((l1 > -1e-12) & (l2 > -1e-12) & (l3 > -1e-12)
                 & ~degen[None, :])
        zhit = l1 * A[:, 2] + l2 * B[:, 2] + l3 * C[:, 2]
        edge = ((np.abs(l1) <= 1e-12) | (np.abs(l2) <= 1e-12)
                | (np.abs(l3) <= 1e-12))
        w = np.where(edge, 0.5, 1.0) * intri          # (m, nt)
        # for each z level: crossings above + on-surface
        m = len(px)
        blk = np.zeros((m, nz), bool)
        for kz, z in enumerate(zs):
            above = (zhit > z + on_surface_tol)
            cnt = np.sum(above * w, axis=1)
            inside = (np.round(cnt).astype(int) % 2) == 1
            on = (intri & (np.abs(zhit - z) <= on_surface_tol)).any(axis=1)
            blk[:, kz] = inside | on
        out.reshape(ncol, nz)[s:s + chunk] = blk
    return out


def grid_on_surface(xs, ys, zs, tris, normals, tol: float = 1e-7):
    """Mark tensor-product grid points lying ON any facet (within tol of the
    facet plane and inside the triangle). The z-ray parity test only catches
    points on near-horizontal facets; this covers walls of any orientation
    (the reference masks on-facet staggered points as solid)."""
    nx, ny, nz = len(xs), len(ys), len(zs)
    out = np.zeros((nx, ny, nz), bool)
    xs = np.asarray(xs); ys = np.asarray(ys); zs = np.asarray(zs)
    for tri, n in zip(tris, normals):
        lo = tri.min(axis=0) - tol
        hi = tri.max(axis=0) + tol
        i0, i1 = np.searchsorted(xs, [lo[0], hi[0]])
        j0, j1 = np.searchsorted(ys, [lo[1], hi[1]])
        k0, k1 = np.searchsorted(zs, [lo[2], hi[2]])
        i1 = min(i1 + 1, nx); j1 = min(j1 + 1, ny); k1 = min(k1 + 1, nz)
        if i0 >= i1 or j0 >= j1 or k0 >= k1:
            continue
        X, Y, Z = np.meshgrid(xs[i0:i1], ys[j0:j1], zs[k0:k1],
                              indexing="ij")
        P = np.stack([X, Y, Z], axis=-1)
        dist = np.abs(np.einsum("...k,k->...", P - tri[0], n))
        near = dist <= tol
        if not near.any():
            continue
        # in-triangle test via projection along the dominant normal axis
        ax = int(np.argmax(np.abs(n)))
        keep = [a for a in range(3) if a != ax]
        p2 = P[..., keep]
        a2, b2, c2 = tri[0][keep], tri[1][keep], tri[2][keep]
        d = ((b2[1] - c2[1]) * (a2[0] - c2[0])
             + (c2[0] - b2[0]) * (a2[1] - c2[1]))
        if abs(d) < 1e-14:
            continue
        l1 = ((b2[1] - c2[1]) * (p2[..., 0] - c2[0])
              + (c2[0] - b2[0]) * (p2[..., 1] - c2[1])) / d
        l2 = ((c2[1] - a2[1]) * (p2[..., 0] - c2[0])
              + (a2[0] - c2[0]) * (p2[..., 1] - c2[1])) / d
        l3 = 1.0 - l1 - l2
        intri = (l1 > -1e-9) & (l2 > -1e-9) & (l3 > -1e-9)
        out[i0:i1, j0:j1, k0:k1] |= near & intri
    return out


def clip_triangle_box(tri: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Sutherland-Hodgman clip of a 3-D triangle against an axis-aligned box
    (tools/IBM/sutherlandHodgman3D.m). Returns the polygon vertex array
    (k,3) (possibly empty)."""
    poly = [tri[0], tri[1], tri[2]]
    for axis in range(3):
        for sign, bound in ((1.0, lo[axis]), (-1.0, hi[axis])):
            if not poly:
                return np.zeros((0, 3))
            out = []
            n = len(poly)
            for i in range(n):
                cur, nxt = poly[i], poly[(i + 1) % n]
                dc = sign * (cur[axis] - bound)
                dn = sign * (nxt[axis] - bound)
                cin = dc >= -EPS
                nin = dn >= -EPS
                if cin:
                    out.append(cur)
                if cin != nin:
                    t = dc / (dc - dn)
                    out.append(cur + t * (nxt - cur))
            poly = out
    return np.asarray(poly) if poly else np.zeros((0, 3))


def polygon_area_3d(poly: np.ndarray) -> float:
    """Area of a planar 3-D polygon (fan cross-product sum)."""
    if len(poly) < 3:
        return 0.0
    v = poly - poly[0]
    s = np.zeros(3)
    for i in range(1, len(poly) - 1):
        s += np.cross(v[i], v[i + 1])
    return 0.5 * float(np.linalg.norm(s))


def ray_hits(origins: np.ndarray, direction: np.ndarray, tris: np.ndarray,
             tmin: float = 1e-6, tmax: float = np.inf,
             exclude=None) -> np.ndarray:
    """Any-hit Moller-Trumbore: does a ray from each origin along `direction`
    hit any triangle? Vectorized (norig, ntri). Used for shading and
    view-factor occlusion (directShortwave.f90 semantics)."""
    O = np.asarray(origins, np.float64)
    D = np.asarray(direction, np.float64)
    if D.ndim == 1:
        D = np.broadcast_to(D, O.shape)
    A, B, C = tris[:, 0], tris[:, 1], tris[:, 2]
    e1 = B - A
    e2 = C - A
    nhit = np.zeros(len(O), bool)
    chunk = max(1, int(2e7 // max(len(tris), 1)))
    for s in range(0, len(O), chunk):
        o = O[s:s + chunk][:, None, :]
        d = D[s:s + chunk][:, None, :]
        pvec = np.cross(d, e2[None])
        det = np.einsum("ntk,tk->nt", pvec, e1)
        ok = np.abs(det) > 1e-14
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tvec = o - A[None]
        u = np.einsum("ntk,ntk->nt", tvec, pvec) * inv
        qvec = np.cross(tvec, e1[None])
        v = np.einsum("ntk,ntk->nt", qvec, d) * inv
        t = np.einsum("ntk,tk->nt", qvec, e2) * inv
        hit = (ok & (u >= -1e-12) & (v >= -1e-12) & (u + v <= 1 + 1e-12)
               & (t > tmin) & (t < tmax))
        if exclude is not None:
            ex = np.asarray(exclude)[s:s + chunk]
            hit[np.arange(len(ex)), ex] = False
        nhit[s:s + chunk] = hit.any(axis=1)
    return nhit
