"""Radiation preprocessing: facet-facet view factors, sky view factors, and
direct shortwave with shading.

Replaces View3D (tools/View3D, C) and directShortwave.f90
(tools/python/fortran/, 727 LoC).  View factors use subdivided
differential-area sums with centroid-ray occlusion (embarrassingly parallel
over facet pairs); shortwave uses Moller-Trumbore any-hit shading rays.
Solar position follows tools/python/udprep/solar.py (NOAA approximation).
"""
from __future__ import annotations

import numpy as np

from .geom import ray_hits
from .stl import triangle_areas


def _subdivide(tris, levels: int = 1):
    """Split each triangle into 4^levels subtriangles; returns
    (sub_tris (m,3,3), parent_ids (m,))."""
    cur = tris
    parents = np.arange(len(tris))
    for _ in range(levels):
        A, B, C = cur[:, 0], cur[:, 1], cur[:, 2]
        ab, bc, ca = (A + B) / 2, (B + C) / 2, (C + A) / 2
        cur = np.concatenate([
            np.stack([A, ab, ca], axis=1),
            np.stack([ab, B, bc], axis=1),
            np.stack([ca, bc, C], axis=1),
            np.stack([ab, bc, ca], axis=1)], axis=0)
        parents = np.tile(parents, 4)
    return cur, parents


def view_factors(tris, normals, subdiv: int = 1, occlusion: bool = True):
    """Approximate facet-facet view-factor matrix F (nf, nf) with
    F[i,j] = fraction of radiation leaving facet i arriving at j, and the
    sky view factor svf = 1 - sum_j F[i,j].

    Method: subdivide facets into patches, sum the differential kernel
    cos(th_i) cos(th_j) dA_i dA_j / (pi r^2) over patch pairs with a
    centre-to-centre visibility ray, then normalise rows to at most 1."""
    nf = len(tris)
    sub, parent = _subdivide(tris, subdiv)
    cen = sub.mean(axis=1)                      # (m,3)
    area = triangle_areas(sub)
    nrm = normals[parent]
    m = len(sub)

    # pairwise kernel (m,m) — fine for a few thousand patches
    d = cen[None, :, :] - cen[:, None, :]       # i -> j
    r2 = np.einsum("ijk,ijk->ij", d, d)
    r = np.sqrt(np.maximum(r2, 1e-30))
    ct_i = np.einsum("ijk,ik->ij", d, nrm) / r
    ct_j = -np.einsum("ijk,jk->ij", d, nrm) / r
    K = np.where((ct_i > 0) & (ct_j > 0) & (r2 > 1e-12),
                 ct_i * ct_j / (np.pi * np.maximum(r2, 1e-12)), 0.0)

    if occlusion and nf > 1:
        vis = np.ones((m, m), bool)
        pairs = np.argwhere(K > 0)
        if len(pairs):
            orig = cen[pairs[:, 0]] + 1e-6 * nrm[pairs[:, 0]]
            dirs = cen[pairs[:, 1]] - cen[pairs[:, 0]]
            lens = np.linalg.norm(dirs, axis=1)
            dirs = dirs / np.maximum(lens[:, None], 1e-30)
            blocked = _segment_blocked(orig, dirs, lens, tris,
                                       pairs, parent)
            vis[pairs[:, 0], pairs[:, 1]] = ~blocked
        K = K * vis

    # patch-pair contributions -> facet-pair view factors
    # F_ij = (1/A_i) sum_{p in i} sum_{q in j} K_pq dA_p dA_q
    weighted = K * area[:, None] * area[None, :]
    F = np.zeros((nf, nf))
    w = np.zeros(nf)
    pi = np.broadcast_to(parent[:, None], K.shape)
    pj = np.broadcast_to(parent[None, :], K.shape)
    np.add.at(F, (pi, pj), weighted)
    np.add.at(w, parent, area)
    F = F / np.maximum(w[:, None], 1e-30)
    # clip rows to the enclosure property
    rs = F.sum(axis=1)
    over = rs > 1.0
    F[over] = F[over] / rs[over, None]
    svf = np.clip(1.0 - F.sum(axis=1), 0.0, 1.0)
    return F, svf


def _segment_blocked(orig, dirs, lens, tris, pairs, parent):
    """Visibility test for patch-centre segments, ignoring the two facets
    the segment connects."""
    from .geom import ray_hits as _rh
    n = len(orig)
    blocked = np.zeros(n, bool)
    # exclusion handled by shortening the segment at both ends
    t0 = 1e-4 * lens
    out = np.zeros(n, bool)
    chunk = 4096
    A, B, C = tris[:, 0], tris[:, 1], tris[:, 2]
    e1, e2 = B - A, C - A
    for s in range(0, n, chunk):
        o = orig[s:s + chunk][:, None, :]
        d = dirs[s:s + chunk][:, None, :]
        L = lens[s:s + chunk]
        pvec = np.cross(d, e2[None])
        det = np.einsum("ntk,tk->nt", pvec, e1)
        ok = np.abs(det) > 1e-14
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tvec = o - A[None]
        u = np.einsum("ntk,ntk->nt", tvec, pvec) * inv
        qvec = np.cross(tvec, e1[None])
        v = np.einsum("ntk,ntk->nt", qvec, d) * inv
        t = np.einsum("ntk,tk->nt", qvec, e2) * inv
        hit = (ok & (u >= -1e-10) & (v >= -1e-10) & (u + v <= 1 + 1e-10)
               & (t > 1e-4 * L[:, None]) & (t < (1 - 1e-4) * L[:, None]))
        # ignore the source and target facets themselves
        pi = parent[pairs[s:s + chunk, 0]]
        pj = parent[pairs[s:s + chunk, 1]]
        hit[np.arange(len(pi)), pi] = False
        hit[np.arange(len(pj)), pj] = False
        out[s:s + chunk] = hit.any(axis=1)
    return out


# ---------------------------------------------------------------------------
# Exact (contour-integral) view factors — the algorithm class View3D itself
# uses: A_i F_ij = -1/(2 pi) * sum over edge pairs of
# (u_i . u_j) Int_i [ Int_j ln|r| ds_j ] ds_i, with the inner integral in
# closed form (handles the shared-edge log singularity of adjacent facets
# that defeats patch-sum quadrature).  Occlusion enters as a patch-sampled
# visibility fraction multiplying the unoccluded analytic value.
# ---------------------------------------------------------------------------

def _seg_log_integral(P, q0, q1):
    """G(p) = int_0^L ln|p - q(s)| ds in closed form, vectorized over
    P (..., 3)."""
    u = q1 - q0
    L = np.linalg.norm(u, axis=-1, keepdims=True)
    u = u / np.maximum(L, 1e-300)
    d = P - q0
    a = np.einsum("...k,...k->...", d, u)
    h2 = np.maximum(np.einsum("...k,...k->...", d, d) - a * a, 0.0)
    h = np.sqrt(h2)
    Lf = L[..., 0]

    def antider(t):
        tm = t - a
        r2 = tm * tm + h2
        val = 0.5 * tm * np.log(np.maximum(r2, 1e-300)) - tm
        return val + np.where(h > 1e-14,
                              h * np.arctan2(tm, np.maximum(h, 1e-300)),
                              0.0)
    return antider(Lf) - antider(0.0)


def _contour_AF(tris_i, tris_j, nq: int = 8):
    """Unoccluded A_i F_ij for paired triangle arrays (n,3,3) — one value
    per row pair, |contour integral| / 2 pi."""
    x, wq = np.polynomial.legendre.leggauss(nq)
    x = 0.5 * (x + 1)
    wq = 0.5 * wq
    tot = np.zeros(len(tris_i))
    for a in range(3):
        p0 = tris_i[:, a]
        p1 = tris_i[:, (a + 1) % 3]
        dli = p1 - p0
        Li = np.linalg.norm(dli, axis=1)
        ui = dli / np.maximum(Li[:, None], 1e-300)
        Pi = p0[:, None, :] + x[None, :, None] * dli[:, None, :]
        for b in range(3):
            q0 = tris_j[:, b]
            q1 = tris_j[:, (b + 1) % 3]
            dlj = q1 - q0
            uj = dlj / np.maximum(
                np.linalg.norm(dlj, axis=1, keepdims=True), 1e-300)
            dot = np.einsum("ik,ik->i", ui, uj)
            G = _seg_log_integral(Pi, q0[:, None, :], q1[:, None, :])
            tot += dot * Li * (wq[None, :] * G).sum(axis=1)
    # the integral's sign tracks the relative winding of the two
    # contours; at the single-facet level the integrand has uniform sign,
    # so |.| is the physical A_i F_ij for the facing pairs this is
    # called on (verified to 5+ digits on the parallel-plate and
    # shared-edge perpendicular analytic cases)
    return np.abs(tot) / (2.0 * np.pi)


def view_factors_exact(tris, normals, subdiv: int = 1,
                       occlusion: bool = True, nq: int = 8,
                       chunk: int = 20000):
    """View-factor matrix by analytic double-contour integration
    (exact for unoccluded pairs incl. touching/adjacent facets), with
    occlusion as the patch-sampled visibility fraction.  Same contract as
    :func:`view_factors`; substantially more accurate for the close pairs
    that dominate urban canyons."""
    nf = len(tris)
    areas = triangle_areas(tris)
    cen = tris.mean(axis=1)
    d = cen[None, :, :] - cen[:, None, :]
    r2 = np.einsum("ijk,ijk->ij", d, d)
    r = np.sqrt(np.maximum(r2, 1e-30))
    ct_i = np.einsum("ijk,ik->ij", d, normals) / r
    ct_j = -np.einsum("ijk,jk->ij", d, normals) / r
    facing = (ct_i > 1e-12) & (ct_j > 1e-12) & (r2 > 1e-12)
    facing &= np.triu(np.ones((nf, nf), bool), 1) | facing.T
    pi_, pj_ = np.nonzero(facing & (np.arange(nf)[:, None]
                                    < np.arange(nf)[None, :]))

    AF = np.zeros((nf, nf))
    for s in range(0, len(pi_), chunk):
        ii = pi_[s:s + chunk]
        jj = pj_[s:s + chunk]
        AF[ii, jj] = _contour_AF(tris[ii], tris[jj], nq)
    AF = AF + AF.T   # reciprocity is exact in this formulation

    if occlusion and nf > 2:
        # patch-sampled visibility fraction per facet pair
        sub, parent = _subdivide(tris, subdiv)
        cenp = sub.mean(axis=1)
        areap = triangle_areas(sub)
        nrm = normals[parent]
        dp = cenp[None, :, :] - cenp[:, None, :]
        r2p = np.einsum("ijk,ijk->ij", dp, dp)
        rp = np.sqrt(np.maximum(r2p, 1e-30))
        cti = np.einsum("ijk,ik->ij", dp, nrm) / rp
        ctj = -np.einsum("ijk,jk->ij", dp, nrm) / rp
        K = np.where((cti > 0) & (ctj > 0) & (r2p > 1e-12),
                     cti * ctj / (np.pi * np.maximum(r2p, 1e-12)), 0.0)
        K = K * areap[:, None] * areap[None, :]
        pairs = np.argwhere(K > 0)
        vism = np.ones_like(K)
        if len(pairs):
            orig = cenp[pairs[:, 0]] + 1e-6 * nrm[pairs[:, 0]]
            dirs = cenp[pairs[:, 1]] - cenp[pairs[:, 0]]
            lens = np.linalg.norm(dirs, axis=1)
            dirs = dirs / np.maximum(lens[:, None], 1e-30)
            blocked = _segment_blocked(orig, dirs, lens, tris, pairs,
                                       parent)
            vism[pairs[:, 0], pairs[:, 1]] = ~blocked
        big_idx = (np.broadcast_to(parent[:, None], K.shape),
                   np.broadcast_to(parent[None, :], K.shape))
        Ksum = np.zeros((nf, nf))
        Kvis = np.zeros((nf, nf))
        np.add.at(Ksum, big_idx, K)
        np.add.at(Kvis, big_idx, K * vism)
        frac = np.divide(Kvis, Ksum, out=np.ones_like(Ksum),
                         where=Ksum > 0)
        AF = AF * frac

    F = AF / np.maximum(areas[:, None], 1e-30)
    rs = F.sum(axis=1)
    over = rs > 1.0
    F[over] = F[over] / rs[over, None]
    svf = np.clip(1.0 - F.sum(axis=1), 0.0, 1.0)
    return F, svf


def view_factors_hybrid(tris, normals, subdiv: int = 1,
                        occlusion: bool = True, close_factor: float = 16.0,
                        nq: int = 8):
    """Patch-sum view factors (native kernel when available) with the
    CLOSE pairs — where centroid quadrature errs most — replaced by the
    analytic contour integral.  `close_factor` selects pairs with
    r^2 < close_factor * (A_i + A_j).  ~1 min for 1k facets vs ~10 min
    for the fully analytic :func:`view_factors_exact`."""
    tris = np.ascontiguousarray(tris, np.float64)
    normals = np.ascontiguousarray(normals, np.float64)
    try:
        from . import native
        native.get_radiation_lib()
        F, svf = native.view_factors(tris, normals, subdiv=subdiv,
                                     occlusion=occlusion)
    except Exception:
        F, svf = view_factors(tris, normals, subdiv=subdiv,
                              occlusion=occlusion)
    areas = triangle_areas(tris)
    cen = tris.mean(axis=1)
    d = cen[None, :, :] - cen[:, None, :]
    r2 = np.einsum("ijk,ijk->ij", d, d)
    close = r2 < close_factor * (areas[:, None] + areas[None, :])
    facing = F > 0
    pi_, pj_ = np.nonzero(close & facing
                          & (np.arange(len(tris))[:, None]
                             < np.arange(len(tris))[None, :]))
    if len(pi_):
        AF = np.zeros(len(pi_))
        for s in range(0, len(pi_), 20000):
            AF[s:s + 20000] = _contour_AF(tris[pi_[s:s + 20000]],
                                          tris[pj_[s:s + 20000]], nq)
        # occlusion: keep the patch method's visibility ratio by scaling
        # with (patch F)/(unoccluded patch F) is unnecessary for close
        # pairs (they see each other or the patch F would be 0); replace
        # directly and let reciprocity hold
        F[pi_, pj_] = AF / np.maximum(areas[pi_], 1e-30)
        F[pj_, pi_] = AF / np.maximum(areas[pj_], 1e-30)
    rs = F.sum(axis=1)
    over = rs > 1.0
    F[over] = F[over] / rs[over, None]
    svf = np.clip(1.0 - F.sum(axis=1), 0.0, 1.0)
    return F, svf


def solar_direction(zenith_deg: float, azimuth_deg: float):
    """Unit vector pointing TOWARD the sun. Azimuth measured clockwise from
    north (+y), zenith from vertical (solar.py conventions)."""
    z = np.radians(zenith_deg)
    a = np.radians(azimuth_deg)
    return np.array([np.sin(z) * np.sin(a), np.sin(z) * np.cos(a),
                     np.cos(z)])


def direct_shortwave(tris, normals, sun_dir, I_dir: float,
                     subdiv: int = 2, use_native: bool | None = None
                     ) -> np.ndarray:
    """Facet-averaged direct solar irradiance [W/m^2] with shading
    (directShortwave.f90 semantics): per sub-patch, the patch receives
    I_dir * max(0, n . s) unless a shading ray toward the sun hits any
    facet.

    Dispatches to the OpenMP C++ kernel (native/radiation.cpp) when it
    builds — the pure-numpy path is O(n_patches x n_facets) and takes
    minutes beyond ~1000 facets (use_native=False forces it; a warning is
    emitted on large pure-numpy runs)."""
    if use_native is None:
        use_native = len(tris) * 4 ** subdiv > 4096
    if use_native:
        try:
            from . import native
            native.get_radiation_lib()
            return native.direct_shortwave(tris, normals, sun_dir, I_dir,
                                           subdiv=subdiv)
        except Exception:
            pass
    if len(tris) > 1000:
        import warnings
        warnings.warn(
            f"pure-numpy direct_shortwave on {len(tris)} facets — expect "
            f"minutes; the native kernel (g++) is strongly recommended")
    sub, parent = _subdivide(tris, subdiv)
    cen = sub.mean(axis=1)
    area = triangle_areas(sub)
    nrm = normals[parent]
    cosi = np.einsum("ik,k->i", nrm, sun_dir)
    lit = cosi > 0
    shaded = np.zeros(len(sub), bool)
    idx = np.flatnonzero(lit)
    if len(idx):
        orig = cen[idx] + 1e-5 * nrm[idx]
        shaded[idx] = ray_hits(orig, sun_dir, tris, tmin=1e-5,
                               exclude=parent[idx])
    flux = np.where(lit & ~shaded, I_dir * np.maximum(cosi, 0.0), 0.0)
    out = np.zeros(len(tris))
    w = np.zeros(len(tris))
    np.add.at(out, parent, flux * area)
    np.add.at(w, parent, area)
    return out / np.maximum(w, 1e-30)


def direct_shortwave_veg(tris, normals, sun_dir, I_dir: float,
                         lad_ext, spacing, subdiv: int = 2,
                         step: float | None = None,
                         blockers=None, periodic_xy: bool = True):
    """Facet direct irradiance with Beer-Lambert vegetation attenuation
    (udprep/directshortwave.py:465-469 semantics: per-cell optical depth
    tau = lad*dec*ds along the ray; the udales_tpu caller passes the
    combined extinction field ``lad_ext = lad*dec`` on the solver grid).

    lad_ext: (itot, jtot, ktot) combined extinction [1/m]; spacing =
    (dx, dy, dz) of that grid.  The march samples the field at `step`
    intervals (default min(spacing)/2) from each sub-patch centroid toward
    the sun, wrapping x/y when periodic_xy.  If `blockers` (triangles) is
    given, facet shading is applied on top via any-hit rays."""
    sun_dir = np.asarray(sun_dir, float)
    dx, dy, dz = spacing
    ni, nj, nk = lad_ext.shape
    if step is None:
        step = min(dx, dy, dz) / 2.0
    sub, parent = _subdivide(tris, subdiv)
    cen = sub.mean(axis=1)
    area = triangle_areas(sub)
    nrm = normals[parent]
    cosi = np.einsum("ik,k->i", nrm, sun_dir)
    lit = cosi > 0
    shaded = np.zeros(len(sub), bool)
    if blockers is not None and len(blockers):
        idx = np.flatnonzero(lit)
        if len(idx):
            orig = cen[idx] + 1e-5 * nrm[idx]
            shaded[idx] = ray_hits(orig, sun_dir, blockers, tmin=1e-5)
    # optical depth: march up to the top of the vegetated volume
    zmax = nk * dz
    up = max(sun_dir[2], 1e-6)
    nsmp = int(np.ceil((zmax / up) / step)) + 1
    tau = np.zeros(len(cen))
    tvals = (np.arange(nsmp) + 0.5) * step
    for c0 in range(0, len(cen), 4096):
        c = cen[c0:c0 + 4096]
        pos = c[:, None, :] + tvals[None, :, None] * sun_dir[None, None, :]
        i = np.floor(pos[..., 0] / dx).astype(int)
        j = np.floor(pos[..., 1] / dy).astype(int)
        k = np.floor(pos[..., 2] / dz).astype(int)
        if periodic_xy:
            i %= ni
            j %= nj
        else:
            i = np.clip(i, 0, ni - 1)
            j = np.clip(j, 0, nj - 1)
        valid = (k >= 0) & (k < nk)
        ext = np.where(valid, lad_ext[i, j, np.clip(k, 0, nk - 1)], 0.0)
        tau[c0:c0 + 4096] = ext.sum(axis=1) * step
    flux = np.where(lit & ~shaded,
                    I_dir * np.maximum(cosi, 0.0) * np.exp(-tau), 0.0)
    out = np.zeros(len(tris))
    w = np.zeros(len(tris))
    np.add.at(out, parent, flux * area)
    np.add.at(w, parent, area)
    return out / np.maximum(w, 1e-30)


def net_shortwave(tris, normals, sun_dir, I_dir, D_diff, svf, albedo):
    """netsw.inp contents: absorbed shortwave per facet
    = (1 - albedo) * (direct + svf * diffuse) (udprep radiation chain)."""
    S = direct_shortwave(tris, normals, sun_dir, I_dir)
    return (1.0 - albedo) * (S + svf * D_diff)
