"""IBM preprocessor: STL geometry -> solver input files.

Replaces the reference's Fortran preprocessing pipeline
(tools/python/fortran/ibm_preproc/, ~3.2k LoC: boundaryMasking.f90 ray-cast
solid masking, matchFacetsCells.f90 facet-section matching) with a
vectorized numpy implementation producing the identical file contract
(SURVEY.md Appendix A.1):

  solid_{u,v,w,c}.txt            staggered solid points (1-based i j k)
  fluid_boundary_{u,v,w,c}.txt   first fluid points adjacent to the surface
  facet_sections_{u,v,w,c}.txt   facet id, wetted area, boundary point id,
                                 wall distance
  facets.inp.<exp>, facetarea.inp.<exp>

Semantics established against the committed reference cases: staggered
points lying ON a facet are solid (floor w-points); boundary points are
fluid points with a solid same-grid 6-neighbour (below-domain counts as
solid); a facet section exists where the facet's plane clips a nonzero area
inside the boundary point's staggered control volume.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..grid import Grid
from .geom import (clip_triangle_box, grid_inside, grid_on_surface,
                   polygon_area_3d)
from .stl import read_stl, triangle_areas


@dataclass
class GridPoints:
    """Point coordinates + control-volume boxes for one staggered grid."""
    name: str
    x: np.ndarray  # (nx,) point x coords
    y: np.ndarray
    z: np.ndarray  # (nzg,)
    dir_axis: int | None  # velocity component axis, None for c


def staggered_grids(grid: Grid):
    g = grid
    return {
        "u": GridPoints("u", g.xh[:-1], g.yf, g.zf, 0),
        "v": GridPoints("v", g.xf, g.yh[:-1], g.zf, 1),
        "w": GridPoints("w", g.xf, g.yf, g.zh[:-1], 2),
        "c": GridPoints("c", g.xf, g.yf, g.zf, None),
    }


def _cell_box_arrays(gp: GridPoints, grid: Grid):
    """Per-axis box face coordinate arrays for every staggered point."""
    g = grid
    dx2, dy2 = g.dx / 2, g.dy / 2
    if gp.name == "u":
        bx = (gp.x - dx2, gp.x + dx2)
        by = (g.yh[:-1], g.yh[1:])
        bz = (g.zh[:-1], g.zh[1:])
    elif gp.name == "v":
        bx = (g.xh[:-1], g.xh[1:])
        by = (gp.y - dy2, gp.y + dy2)
        bz = (g.zh[:-1], g.zh[1:])
    elif gp.name == "w":
        nz = grid.ktot
        k = np.arange(nz)
        zlo = gp.z - g.dzf[np.maximum(k - 1, 0)] / 2
        zhi = gp.z + g.dzf[np.minimum(k, nz - 1)] / 2
        bx = (g.xh[:-1], g.xh[1:])
        by = (g.yh[:-1], g.yh[1:])
        bz = (zlo, zhi)
    else:
        bx = (g.xh[:-1], g.xh[1:])
        by = (g.yh[:-1], g.yh[1:])
        bz = (g.zh[:-1], g.zh[1:])
    return bx, by, bz


def _cell_box(gp: GridPoints, grid: Grid, i, j, k):
    """Control volume of staggered point (i,j,k)."""
    g = grid
    dx2, dy2 = g.dx / 2, g.dy / 2
    if gp.name == "u":
        lo = (gp.x[i] - dx2, g.yh[j], g.zh[k])
        hi = (gp.x[i] + dx2, g.yh[j + 1], g.zh[k + 1])
    elif gp.name == "v":
        lo = (g.xh[i], gp.y[j] - dy2, g.zh[k])
        hi = (g.xh[i + 1], gp.y[j] + dy2, g.zh[k + 1])
    elif gp.name == "w":
        # w control volume straddles the face (reference assumes
        # near-equidistant z for this, matchFacetsCells.f90)
        zlo = gp.z[k] - g.dzf[max(k - 1, 0)] / 2
        zhi = gp.z[k] + g.dzf[min(k, grid.ktot - 1)] / 2
        lo = (g.xh[i], g.yh[j], zlo)
        hi = (g.xh[i + 1], g.yh[j + 1], zhi)
    else:
        lo = (g.xh[i], g.yh[j], g.zh[k])
        hi = (g.xh[i + 1], g.yh[j + 1], g.zh[k + 1])
    return np.asarray(lo), np.asarray(hi)


class IBMPreproc:
    def __init__(self, grid: Grid, tris: np.ndarray, normals: np.ndarray,
                 stl_ground: bool = True, diag_neighbs: bool = True):
        self.grid = grid
        self.tris = tris
        self.normals = normals
        self.stl_ground = stl_ground
        self.diag_neighbs = diag_neighbs
        self.gps = staggered_grids(grid)
        # periodic images: facets touching the x/y domain boundaries also
        # act on points at the opposite edge (e.g. a wall on y=ylen covers
        # v-points at y=0). Images are used for masking/cutting; section
        # facet ids refer back to the original facet.
        tol = 1e-9
        # facets entirely outside the domain interior are listed in
        # facets.inp but never matched (the committed example-001 inputs use
        # only the 32 in-domain floor tiles of the 128-triangle STL)
        lo_all = tris.min(axis=1)
        hi_all = tris.max(axis=1)
        indom = ((lo_all[:, 0] < grid.xlen - tol) & (hi_all[:, 0] > tol)
                 & (lo_all[:, 1] < grid.ylen - tol) & (hi_all[:, 1] > tol))
        base_ids = np.flatnonzero(indom)
        imgs, img_ids = [], []
        for fi in base_ids:
            tri = tris[fi]
            lo, hi = tri.min(axis=0), tri.max(axis=0)
            shifts = []
            if hi[0] >= grid.xlen - tol:
                shifts.append((-grid.xlen, 0.0))
            if lo[0] <= tol:
                shifts.append((grid.xlen, 0.0))
            if hi[1] >= grid.ylen - tol:
                shifts.append((0.0, -grid.ylen))
            if lo[1] <= tol:
                shifts.append((0.0, grid.ylen))
            for sx, sy in shifts:
                t2 = tri.copy()
                t2[:, 0] += sx
                t2[:, 1] += sy
                imgs.append(t2)
                img_ids.append(fi)
        self.tris_ext = np.concatenate(
            [tris[base_ids]] + ([np.asarray(imgs)] if imgs else []))
        self.norm_ext = np.concatenate(
            [normals[base_ids]]
            + ([normals[np.asarray(img_ids)]] if imgs else []))
        self.facid_ext = np.concatenate(
            [base_ids] + ([np.asarray(img_ids)] if imgs else []))
        # native C++ kernels (native/ibmprep.cpp) if g++ is available
        try:
            from .native import get_lib
            get_lib()
            self.use_native = True
        except Exception:
            self.use_native = False

    @classmethod
    def from_stl(cls, stl_path, grid: Grid, use_native: bool | None = None,
                 stl_ground: bool = True, diag_neighbs: bool = True):
        tris, normals = read_stl(stl_path)
        obj = cls(grid, tris, normals, stl_ground=stl_ground,
                  diag_neighbs=diag_neighbs)
        if use_native is not None:
            obj.use_native = use_native
        return obj

    # -- solid masks -------------------------------------------------------
    def solid_mask(self, which: str) -> np.ndarray:
        if not hasattr(self, "_mask_cache"):
            self._mask_cache = {}
        if which not in self._mask_cache:
            gp = self.gps[which]
            if self.use_native:
                from .native import grid_solid_mask
                m = grid_solid_mask(self.tris_ext, self.norm_ext,
                                    gp.x, gp.y, gp.z)
            else:
                m = (grid_inside(gp.x, gp.y, gp.z, self.tris_ext)
                     | grid_on_surface(gp.x, gp.y, gp.z, self.tris_ext,
                                       self.norm_ext))
            self._mask_cache[which] = m
        return self._mask_cache[which]

    def solid_points(self, which: str) -> np.ndarray:
        """(ns,3) 0-based solid point indices for one staggered grid."""
        return np.argwhere(self.solid_mask(which))

    def class_mask(self, which: str) -> np.ndarray:
        """Solid mask used for boundary CLASSIFICATION (not for writing
        solid_*.txt): with stl_ground, the w-grid z=0 plane always counts
        as solid (boundaryMasking.f90:53-60 'Bottom is always solid for
        w'), so bottom-cell sections and boundary status move to the w
        points one level up — the shipped inputs (e.g. 201, whose ground
        STL leaves 2461 columns uncovered) encode exactly this."""
        m = self.solid_mask(which)
        if which == "w" and self.stl_ground:
            m = m.copy()
            m[:, :, 0] = True
        return m

    # -- boundary points ---------------------------------------------------
    @staticmethod
    def boundary_points(solid: np.ndarray, diag: bool = True,
                        below_solid: bool = True,
                        exclude_k0: bool = False) -> np.ndarray:
        """Fluid points with a solid neighbour — 6-neighbourhood, plus the
        corner diagonals when `diag` (the reference's diag_neighbs, default
        true in udprep defaults.json); x/y periodic, above-domain fluid.
        `below_solid` pads below the domain as solid (== the reference's
        stl_ground forcing of the whole lowest u/v/c level into fluid_IB,
        boundaryMasking.f90:70-75).  `exclude_k0` drops the z=0 plane from
        the result (the w grid: 'fluid_IB(:,:,1)=.false.',
        boundaryMasking.f90:62).  (nb,3) 0-based, lexicographic."""
        s = solid
        below = np.ones_like if below_solid else np.zeros_like
        sz = np.concatenate([below(s[:, :, :1]), s,
                             np.zeros_like(s[:, :, :1])], axis=2)
        nbr = np.zeros_like(s)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                for dk in (-1, 0, 1):
                    if di == dj == dk == 0:
                        continue
                    if not diag and (di != 0) + (dj != 0) + (dk != 0) > 1:
                        continue
                    sh = np.roll(np.roll(sz, di, axis=0), dj, axis=1)
                    nbr |= sh[:, :, 1 + dk: 1 + dk + s.shape[2]]
        out = nbr & ~s
        if exclude_k0:
            out[:, :, 0] = False
        return np.argwhere(out)

    # -- facet cuts & sections --------------------------------------------
    def cut_sections(self, which: str, fluid: np.ndarray,
                     area_tol: float = 1e-9):
        """Clip every facet (incl. periodic images) against the control
        volumes of the FLUID staggered points it overlaps
        (matchFacetsCells.f90 semantics). Returns {ijk: [(facid, area,
        dist), ...]}. Facets whose normal is aligned with the staggered
        direction carry no tangential stress and are skipped for u/v/w."""
        gp = self.gps[which]
        g = self.grid
        out: dict = {}
        nxg, nyg, nzg = len(gp.x), len(gp.y), len(gp.z)
        dzmax = float(g.dzf.max())
        for tri, nrm, fid in zip(self.tris_ext, self.norm_ext,
                                 self.facid_ext):
            if gp.dir_axis is not None and \
                    abs(abs(nrm[gp.dir_axis]) - 1.0) < 1e-9:
                continue
            lo = tri.min(axis=0)
            hi = tri.max(axis=0)
            i0 = int(np.searchsorted(gp.x, lo[0] - g.dx))
            i1 = int(np.searchsorted(gp.x, hi[0] + g.dx))
            j0 = int(np.searchsorted(gp.y, lo[1] - g.dy))
            j1 = int(np.searchsorted(gp.y, hi[1] + g.dy))
            k0 = int(np.searchsorted(gp.z, lo[2] - dzmax))
            k1 = int(np.searchsorted(gp.z, hi[2] + dzmax))
            for i in range(max(i0 - 1, 0), min(i1 + 1, nxg)):
                for j in range(max(j0 - 1, 0), min(j1 + 1, nyg)):
                    for k in range(max(k0 - 1, 0), min(k1 + 1, nzg)):
                        blo, bhi = _cell_box(gp, g, i, j, k)
                        poly = clip_triangle_box(tri, blo, bhi)
                        area = polygon_area_3d(poly)
                        if area <= area_tol:
                            continue
                        # a piece coincident with a box FACE belongs only to
                        # the cell the facet normal points into (each face
                        # piece is claimed by exactly one of the two cells)
                        ftol = 1e-9
                        skip = False
                        for ax in range(3):
                            if np.all(np.abs(poly[:, ax] - blo[ax]) < ftol):
                                if nrm[ax] <= 0:
                                    skip = True
                            elif np.all(np.abs(poly[:, ax] - bhi[ax]) < ftol):
                                if nrm[ax] >= 0:
                                    skip = True
                        if skip:
                            continue
                        if fluid[i, j, k]:
                            p = np.array([gp.x[i], gp.y[j], gp.z[k]])
                            dist = abs(float(np.dot(p - tri[0], nrm)))
                            out.setdefault((i, j, k), []).append(
                                (int(fid), area, dist))
                        else:
                            # piece in a solid-point cell: reassign to the
                            # nearest fluid point in the 26-neighbourhood so
                            # the full facet area exerts stress (the
                            # committed reference inputs show these as
                            # duplicate facet/point rows at e.g. sqrt(2)/2
                            # distances)
                            best = None
                            for di in (-1, 0, 1):
                                for dj in (-1, 0, 1):
                                    for dk in (-1, 0, 1):
                                        ii = (i + di) % nxg
                                        jj = (j + dj) % nyg
                                        kk = k + dk
                                        if kk < 0 or kk >= nzg:
                                            continue
                                        if not fluid[ii, jj, kk]:
                                            continue
                                        p = np.array([gp.x[ii], gp.y[jj],
                                                      gp.z[kk]])
                                        dmin = float(np.min(
                                            np.linalg.norm(poly - p,
                                                           axis=1)))
                                        if best is None or dmin < best[0]:
                                            best = (dmin, (ii, jj, kk))
                            if best is not None:
                                out.setdefault(best[1], []).append(
                                    (int(fid), area, best[0]))
        return out

    def boundary_and_sections(self, which: str):
        """Boundary points = fluid points with a solid same-grid neighbour
        UNION fluid points whose control volume is cut by a facet (the
        committed reference inputs satisfy exactly this: e.g. example 001's
        w grid has 16384 boundary points from the neighbour rule but zero
        sections since the floor lies outside every w control volume).
        Returns (bnd (nb,3) sorted, section rows (facid, area, bnd_id,
        dist))."""
        solid_cls = self.class_mask(which)
        nbr_bnd = self.boundary_points(
            solid_cls, diag=self.diag_neighbs,
            below_solid=self.stl_ground and which != "w",
            exclude_k0=(which == "w"))
        # section-eligible points: fluid per the classification mask, and
        # never the bottom w plane (sections reassign upward there)
        eligible = ~solid_cls
        if which == "w":
            eligible = eligible.copy()
            eligible[:, :, 0] = False
        if self.use_native:
            from .native import cut_sections as native_cut
            gp = self.gps[which]
            boxes = _cell_box_arrays(gp, self.grid)
            axis = gp.dir_axis if gp.dir_axis is not None else -1
            fac, area, ijk, dist = native_cut(
                self.tris_ext, self.norm_ext, self.facid_ext, boxes,
                (gp.x, gp.y, gp.z), eligible, axis)
            cuts = {}
            for f_, a_, (i, j, k), d_ in zip(fac, area, ijk, dist):
                cuts.setdefault((int(i), int(j), int(k)), []).append(
                    (int(f_), float(a_), float(d_)))
        else:
            cuts = self.cut_sections(which, eligible)
        keys = set(map(tuple, nbr_bnd)) | set(cuts.keys())
        bnd = np.asarray(sorted(keys), np.int64).reshape(-1, 3)
        bidx = {tuple(p): n for n, p in enumerate(map(tuple, bnd))}
        rows = []
        for key, secs in sorted(cuts.items()):
            for fid, area, dist in secs:
                rows.append((fid, area, bidx[key], dist))
        return bnd, rows

    # -- full pipeline -----------------------------------------------------
    def run(self, outdir: str | Path, expnr: str, floor_type: int = -1,
            wall_type: int = 1, write_facets: bool = True,
            facet_types=None):
        """Generate all IBM input files; returns the &WALLS counts dict.

        `facet_types`: per-facet wall-type ids (the udprep read_types /
        types_path pathway) overriding the floor/wall heuristic.  An
        existing facets.inp is treated as authored input and is NOT
        overwritten (udprep_ibm.py write_facets protection)."""
        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        counts = {"nfcts": len(self.tris)}
        crows = []
        for which in ("u", "v", "w", "c"):
            bnd, rows = self.boundary_and_sections(which)
            if which == "c":
                crows = rows
            solid = self.solid_mask(which)
            sp = np.argwhere(solid)
            _write_sparse(outdir / f"solid_{which}.txt", sp)
            _write_sparse(outdir / f"fluid_boundary_{which}.txt", bnd)
            _write_sections(outdir / f"facet_sections_{which}.txt", rows)
            counts[f"nsolpts_{which}"] = len(sp)
            counts[f"nbndpts_{which}"] = len(bnd)
            counts[f"nfctsecs_{which}"] = len(rows)
        if write_facets:
            if facet_types is not None:
                types = np.asarray(facet_types, int)
                if len(types) != len(self.tris):
                    raise ValueError(
                        f"facet types carry {len(types)} values for "
                        f"{len(self.tris)} facets")
            else:
                # floor facets: normal +z at z ~ 0
                z0 = np.abs(self.tris[:, :, 2]).max(axis=1) < 1e-9
                types = np.where(z0, floor_type, wall_type)
            fpath = outdir / f"facets.inp.{expnr}"
            if not fpath.exists():
                with open(fpath, "w") as f:
                    f.write("# type, normal\n")
                    for t, n in zip(types, self.normals):
                        f.write(f"{t:4d}  {n[0]:9.4f} {n[1]:9.4f} "
                                f"{n[2]:9.4f}\n")
            areas = triangle_areas(self.tris)
            with open(outdir / f"facetarea.inp.{expnr}", "w") as f:
                f.write("# area\n")
                for a in areas:
                    f.write(f"{a:.6f}\n")
            # facets without any c-grid section (udprep_ibm.py
            # write_facets_unused): 1-based ids, one per line, no header
            used = ({int(r[0]) + 1 for r in crows}   # rows are 0-based
                    if len(crows) else set())
            unused = [n for n in range(1, len(self.tris) + 1)
                      if n not in used]
            with open(outdir / f"facets_unused.{expnr}", "w") as f:
                for n in unused:
                    f.write(f"{n}\n")
        return counts


def _write_sparse(path, idx0):
    """1-based Fortran-index sparse ijk writer (read_sparse_ijk format)."""
    with open(path, "w") as f:
        f.write("# position (i,j,k)\n")
        for i, j, k in idx0 + 1:
            f.write(f"{i:5d}{j:5d}{k:5d}\n")


def _write_sections(path, rows):
    with open(path, "w") as f:
        f.write(" # facet      area flux point distance\n")
        for fi, area, bi, dist in rows:
            f.write(f"{fi+1:8d}{area:10.4f}{bi+1:11d}{dist:9.4f}\n")
