"""Geometry toolkit for urban STL models.

Dependency-free numpy re-implementation of the reference's udgeom package
(tools/python/udgeom/udgeom.py, trimesh-based, ~5.3k LoC): mesh repair,
building splitting, watertightness/volume, footprint outlines, extrusion
to the ground, and ground-plane generation — the operations udprep relies
on when preparing a case from a raw building STL.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .stl import read_stl, triangle_areas, write_stl


class UDGeom:
    """A triangulated surface (tools/python/udgeom/udgeom.py:55 UDGeom).

    Holds (n, 3, 3) triangle vertices + (n, 3) outward unit normals.
    """

    def __init__(self, tris=None, normals=None, path=None):
        if path is not None:
            tris, normals = read_stl(path)
        self.tris = np.asarray(tris, float)
        if normals is None:
            normals = _face_normals(self.tris)
        self.normals = np.asarray(normals, float)

    # -- basic properties (udgeom.py:359-790) -------------------------------
    @property
    def n_faces(self) -> int:
        return len(self.tris)

    @property
    def bounds(self) -> np.ndarray:
        return np.stack([self.tris.reshape(-1, 3).min(axis=0),
                         self.tris.reshape(-1, 3).max(axis=0)])

    @property
    def face_centers(self) -> np.ndarray:
        return self.tris.mean(axis=1)

    @property
    def face_areas(self) -> np.ndarray:
        return triangle_areas(self.tris)

    @property
    def total_area(self) -> float:
        return float(self.face_areas.sum())

    def volume(self) -> float:
        """Signed enclosed volume via the divergence theorem
        (udgeom.py:777)."""
        a, b, c = self.tris[:, 0], self.tris[:, 1], self.tris[:, 2]
        return float(np.einsum("ij,ij->i", a, np.cross(b, c)).sum() / 6.0)

    def save(self, path):
        write_stl(path, self.tris, self.normals)

    # -- connectivity --------------------------------------------------------
    def _vertex_ids(self, decimals: int = 9):
        """Map triangle corners to merged vertex ids (exact-coordinate
        merge after rounding)."""
        pts = np.round(self.tris.reshape(-1, 3), decimals)
        uniq, inv = np.unique(pts, axis=0, return_inverse=True)
        return uniq, inv.reshape(-1, 3)

    def _edges(self):
        _, f = self._vertex_ids()
        e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        return np.sort(e, axis=1)

    def is_watertight(self) -> bool:
        """Every edge shared by exactly two faces (udgeom.py:790)."""
        e = self._edges()
        _, counts = np.unique(e, axis=0, return_counts=True)
        return bool((counts == 2).all())

    def boundary_edges(self):
        """Edges used by exactly one face, as vertex-id pairs."""
        e = self._edges()
        uniq, counts = np.unique(e, axis=0, return_counts=True)
        return uniq[counts == 1]

    def face_to_component(self) -> np.ndarray:
        """Connected-component label per face (vertex-shared connectivity;
        udgeom.get_face_to_building_map:471)."""
        _, f = self._vertex_ids()
        nv = f.max() + 1
        parent = np.arange(nv)

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        for tri in f:
            r = find(tri[0])
            for v in tri[1:]:
                parent[find(v)] = r
        roots = np.array([find(tri[0]) for tri in f])
        _, labels = np.unique(roots, return_inverse=True)
        return labels

    def identify_ground_faces(self, eps: float = 1e-9) -> np.ndarray:
        """Horizontal faces lying in the domain-floor plane
        (udgeom.identify_ground_faces:926)."""
        zmin = self.tris[..., 2].min()
        flat = (np.abs(self.tris[..., 2] - zmin) < eps).all(axis=1)
        return flat & (np.abs(self.normals[:, 2]) > 0.99)

    def get_buildings(self, exclude_ground: bool = True):
        """Split into per-component UDGeoms (udgeom.get_buildings:438).
        Ground-plane faces are removed FIRST (buildings share floor-ring
        vertices with the ground, so components are computed on the
        building faces only), matching udgeom._split_buildings:497."""
        if exclude_ground:
            keep = ~self.identify_ground_faces()
            base = UDGeom(self.tris[keep], self.normals[keep])
        else:
            base = self
        if base.n_faces == 0:
            return []
        labels = base.face_to_component()
        return [UDGeom(base.tris[labels == lb], base.normals[labels == lb])
                for lb in range(labels.max() + 1)]

    # -- repair (udgeom.check:851 / fix:985) --------------------------------
    def fix(self, min_area: float = 1e-12):
        """Repair pass: drop degenerate/duplicate faces and orient
        normals outward (ray-parity test from each face centroid)."""
        areas = triangle_areas(self.tris)
        keep = areas > min_area
        tris, normals = self.tris[keep], self.normals[keep]
        # duplicate faces: same vertex-id set
        pts = np.round(tris.reshape(-1, 3), 9)
        uniq, inv = np.unique(pts, axis=0, return_inverse=True)
        fids = np.sort(inv.reshape(-1, 3), axis=1)
        _, first = np.unique(fids, axis=0, return_index=True)
        keep2 = np.zeros(len(tris), bool)
        keep2[first] = True
        tris, normals = tris[keep2], normals[keep2]
        # outward orientation: a point just along the normal must see an
        # even number of surface crossings along +z (outside test)
        from .geom import ray_hits
        geom_n = _face_normals(tris)
        flip = np.einsum("ij,ij->i", geom_n,
                         normals) < 0
        normals = np.where(flip[:, None], -normals, normals)
        cen = tris.mean(axis=1)
        probes = cen + 1e-6 * normals
        inside = _crossing_parity(probes, tris)
        tris[inside] = tris[inside][:, ::-1]
        normals[inside] = -normals[inside]
        return UDGeom(tris, _face_normals(tris))

    # -- footprints / outlines (udgeom.calculate_outline2d:567) -------------
    def footprint_polygons(self, z: float | None = None, eps: float = 1e-6):
        """2-D footprint outline per building: the boundary edges of the
        horizontal cross-section near ground level, chained into closed
        polygons.  Returns a list of (m, 2) vertex loops."""
        zmin = self.tris[..., 2].min() if z is None else z
        polys = []
        for b in self.get_buildings():
            # vertical faces touching the ground: collect their bottom edges
            edges = []
            for tri in b.tris:
                zs = tri[:, 2]
                low = np.abs(zs - zmin) < eps
                if low.sum() == 2:
                    p = tri[low][:, :2]
                    edges.append((tuple(np.round(p[0], 9)),
                                  tuple(np.round(p[1], 9))))
            if not edges:
                continue
            polys.extend(_chain_loops(edges))
        return polys

    def get_outline(self):
        """All footprint loops merged as one (m, 2) polyline array with
        NaN separators (udgeom.get_outline:720 flavor)."""
        polys = self.footprint_polygons()
        if not polys:
            return np.zeros((0, 2))
        parts = []
        for p in polys:
            parts.append(np.asarray(p))
            parts.append(np.full((1, 2), np.nan))
        return np.concatenate(parts[:-1])

    # -- generation ----------------------------------------------------------
    def add_ground(self, xlen: float, ylen: float, tile: float | None = None):
        """Append a triangulated ground plane at z=0 covering
        [0,xlen]x[0,ylen] (udgeom.add_ground:870).  `tile` sets the tile
        edge length (default: one tile)."""
        tile_x = xlen if tile is None else tile
        tile_y = ylen if tile is None else tile
        nx = max(int(round(xlen / tile_x)), 1)
        ny = max(int(round(ylen / tile_y)), 1)
        tris = []
        for i in range(nx):
            for j in range(ny):
                x0, x1 = i * xlen / nx, (i + 1) * xlen / nx
                y0, y1 = j * ylen / ny, (j + 1) * ylen / ny
                tris.append([[x0, y0, 0], [x1, y0, 0], [x1, y1, 0]])
                tris.append([[x0, y0, 0], [x1, y1, 0], [x0, y1, 0]])
        gt = np.asarray(tris, float)
        return UDGeom(np.concatenate([self.tris, gt]),
                      np.concatenate([self.normals,
                                      np.tile([0.0, 0.0, 1.0],
                                              (len(gt), 1))]))

    def extrude_to_ground(self):
        """Close a floating geometry downward: every boundary edge is
        extruded to z=0 with a vertical quad (udgeom extrude-to-ground
        semantics for shapes cut above the terrain)."""
        uniq, f = self._vertex_ids()
        be = self.boundary_edges()
        new = []
        for a, b in be:
            pa, pb = uniq[a], uniq[b]
            ga, gb = pa.copy(), pb.copy()
            ga[2] = 0.0
            gb[2] = 0.0
            new.append([pa, pb, gb])
            new.append([pa, gb, ga])
        if not new:
            return self
        nt = np.asarray(new)
        return UDGeom(np.concatenate([self.tris, nt]),
                      np.concatenate([self.normals, _face_normals(nt)]))


def _face_normals(tris):
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)


def _crossing_parity(points, tris):
    """True where a +z ray from the point crosses the surface an odd
    number of times (inside test)."""
    from .geom import points_inside
    return points_inside(points, tris, on_surface_tol=0.0)


def _chain_loops(edges):
    """Chain undirected 2-D edges into closed vertex loops."""
    from collections import defaultdict
    adj = defaultdict(list)
    for a, b in edges:
        adj[a].append(b)
        adj[b].append(a)
    seen_e = set()
    loops = []
    for a, b in edges:
        if (a, b) in seen_e or (b, a) in seen_e:
            continue
        loop = [a, b]
        seen_e.add((a, b))
        cur, prev = b, a
        while True:
            nxts = [v for v in adj[cur]
                    if v != prev and (cur, v) not in seen_e
                    and (v, cur) not in seen_e]
            if not nxts:
                break
            nxt = nxts[0]
            seen_e.add((cur, nxt))
            if nxt == loop[0]:
                break
            loop.append(nxt)
            prev, cur = cur, nxt
        loops.append(np.asarray(loop, float))
    return loops


# ---------------------------------------------------------------------------
# Mesh diagnostics (tools/python/udgeom/check_mesh.py)
# ---------------------------------------------------------------------------

def find_nonmanifold_regions(geom: UDGeom) -> list:
    """Cluster edges shared by >2 faces into defect regions
    (check_mesh.py:365-448).  Each region: edge vertex-id pairs, endpoint
    coordinates, incident face ids, counts, bbox."""
    uniq, f = geom._vertex_ids()
    edge_to_faces: dict = {}
    for fid, tri in enumerate(f):
        a, b, c = map(int, tri)
        for e in (tuple(sorted((a, b))), tuple(sorted((b, c))),
                  tuple(sorted((c, a)))):
            edge_to_faces.setdefault(e, []).append(fid)
    nonman = {e: ids for e, ids in edge_to_faces.items() if len(ids) > 2}
    if not nonman:
        return []
    # cluster edges sharing a vertex
    vert_to_edges: dict = {}
    for e in nonman:
        for v in e:
            vert_to_edges.setdefault(v, []).append(e)
    visited, regions = set(), []
    for e0 in nonman:
        if e0 in visited:
            continue
        stack, redges, rfaces = [e0], [], set()
        visited.add(e0)
        while stack:
            cur = stack.pop()
            redges.append(cur)
            rfaces.update(nonman[cur])
            for v in cur:
                for nb in vert_to_edges[v]:
                    if nb not in visited:
                        visited.add(nb)
                        stack.append(nb)
        pts = uniq[np.unique(f[sorted(rfaces)].ravel())]
        regions.append(dict(
            edge_vertex_ids=sorted(redges),
            edge_points=[(uniq[a].tolist(), uniq[b].tolist())
                         for a, b in sorted(redges)],
            face_ids=sorted(rfaces),
            n_edges=len(redges), n_faces=len(rfaces),
            bbox=np.stack([pts.min(axis=0), pts.max(axis=0)])))
    regions.sort(key=lambda r: (-r["n_edges"], -r["n_faces"]))
    return regions


def calculate_independent_surfaces(geom: UDGeom) -> dict:
    """Face-connectivity components with per-surface face ids and bboxes
    (check_mesh.py:456-513)."""
    if geom.n_faces == 0:
        return dict(n_surfaces=0, surfaces=[])
    labels = geom.face_to_component()
    surfaces = []
    for lb in range(labels.max() + 1):
        ids = np.flatnonzero(labels == lb)
        pts = geom.tris[ids].reshape(-1, 3)
        surfaces.append(dict(
            surface_id=int(lb), face_ids=ids.tolist(),
            n_faces=int(len(ids)),
            bbox=np.stack([pts.min(axis=0), pts.max(axis=0)])))
    surfaces.sort(key=lambda s: -s["n_faces"])
    return dict(n_surfaces=len(surfaces), surfaces=surfaces)


def find_touching_regions(geom: UDGeom, tol: float = 1e-8) -> list:
    """Boundary (single-face) edges geometrically overlapping other
    boundary edges along the same carrier line — the
    'touching but unstitched' defect family (check_mesh.py
    find_unstitched_touching_regions / find_internal_touching_wall_regions,
    detected here on the welded soup as overlapping collinear boundary
    edges across components)."""
    uniq, f = geom._vertex_ids()
    labels = geom.face_to_component()
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    eface = np.tile(np.arange(len(f)), 3)
    es = np.sort(e, axis=1)
    order = np.lexsort((es[:, 1], es[:, 0]))
    es, eface = es[order], eface[order]
    uniq_e, start, counts = np.unique(es, axis=0, return_index=True,
                                      return_counts=True)
    bmask = counts == 1
    bedges = uniq_e[bmask]
    bfaces = eface[start[bmask]]
    if len(bedges) == 0:
        return []
    p0, p1 = uniq[bedges[:, 0]], uniq[bedges[:, 1]]
    mid = 0.5 * (p0 + p1)
    dirs = p1 - p0
    lens = np.linalg.norm(dirs, axis=1)
    dirs = dirs / np.maximum(lens[:, None], 1e-30)
    comp = labels[bfaces]
    regions = []
    # group edges by their carrier LINE (canonical direction + anchor,
    # check_mesh._line_group_key) so the pair scan stays near-linear on
    # large meshes (domain-perimeter ground edges are all boundary edges)
    groups: dict = {}
    for idx in range(len(bedges)):
        d = dirs[idx]
        # canonical direction: flip so the first nonzero component is +
        nz = np.flatnonzero(np.abs(d) > 1e-9)
        if len(nz) == 0:
            continue
        if d[nz[0]] < 0:
            d = -d
        anchor = p0[idx] - np.dot(p0[idx], d) * d
        key = (tuple(np.round(d, 6)), tuple(np.round(anchor, 6)))
        groups.setdefault(key, []).append(idx)
    for ids in groups.values():
        for a in range(len(ids)):
            for b in range(a + 1, len(ids)):
                i, j = ids[a], ids[b]
                # interval overlap along the carrier line: a T-junction /
                # duplicated edge has interior overlap > tol, while
                # adjacent edges of an open ring only share an endpoint
                ti = sorted((np.dot(p0[i], dirs[i]), np.dot(p1[i], dirs[i])))
                tj = sorted((np.dot(p0[j], dirs[i]), np.dot(p1[j], dirs[i])))
                overlap = min(ti[1], tj[1]) - max(ti[0], tj[0])
                if overlap <= tol:
                    continue
                regions.append(dict(
                    components=(int(comp[i]), int(comp[j])),
                    overlap=float(overlap),
                    face_ids=[int(bfaces[i]), int(bfaces[j])],
                    points=(p0[i].tolist(), p1[i].tolist())))
    return regions


def _format_check_summary(report: dict) -> str:
    lines = [f"mesh: {report['n_faces']} faces, "
             f"{report['n_vertices']} vertices, "
             f"{report['n_independent_surfaces']} independent surfaces"]
    if report["issues"]:
        lines.append("issues:")
        lines.extend(f"  - {s}" for s in report["issues"])
    else:
        lines.append("no issues found")
    return "\n".join(lines)


def check(geom: UDGeom, require_single_component: bool = False) -> dict:
    """Validate a surface mesh for the common udgeom topology problems
    (tools/python/udgeom/check_mesh.py:553-829, adapted to the welded
    triangle soup this package uses): non-finite values, duplicate /
    degenerate / zero-area faces, zero or non-unit normals,
    downward-facing ground faces, vertices below the planar ground,
    non-manifold edges (clustered into regions), cross-component
    touching-but-unstitched boundary edges, independent surfaces, and
    per-building watertightness.  Returns the reference's report
    vocabulary: `valid`, `issues`, `summary`, `n_*` counts and a
    `details` dict with face/region ids and bboxes."""
    tris, normals = geom.tris, geom.normals
    uniq, f = geom._vertex_ids()
    report = dict(valid=True, issues=[], summary="", details={},
                  n_vertices=int(len(uniq)), n_faces=int(len(tris)),
                  n_nonfinite_vertices=0, n_duplicate_faces=0,
                  n_degenerate_faces=0, n_zero_area_faces=0,
                  n_zero_normals=0, n_bad_normal_lengths=0,
                  n_below_ground_vertices=0, n_downward_ground_faces=0,
                  n_nonmanifold_edges=0, n_touching_regions=0,
                  n_connected_components=0, n_independent_surfaces=0,
                  n_open_buildings=0)
    det = report["details"]

    def issue(msg):
        report["valid"] = False
        report["issues"].append(msg)

    if len(tris) == 0:
        issue("mesh has no faces")
        report["summary"] = _format_check_summary(report)
        return report

    nonfin = ~np.isfinite(tris.reshape(len(tris), -1)).all(axis=1)
    report["n_nonfinite_vertices"] = int(nonfin.sum())
    if nonfin.any():
        det["nonfinite_face_ids"] = np.flatnonzero(nonfin).tolist()
        issue(f"mesh has {int(nonfin.sum())} faces with non-finite "
              "vertices")

    # duplicate faces: same vertex-id set regardless of winding
    fids = np.sort(f, axis=1)
    _, inv, counts = np.unique(fids, axis=0, return_inverse=True,
                               return_counts=True)
    ndup = int(np.clip(counts - 1, 0, None).sum())
    report["n_duplicate_faces"] = ndup
    if ndup:
        det["duplicate_face_groups"] = [
            np.flatnonzero(inv == g).tolist()
            for g in np.flatnonzero(counts > 1)]
        issue(f"mesh has {ndup} duplicate faces")

    degen = np.array([len(set(tri)) < 3 for tri in fids])
    report["n_degenerate_faces"] = int(degen.sum())
    if degen.any():
        det["degenerate_face_ids"] = np.flatnonzero(degen).tolist()
        issue(f"mesh has {int(degen.sum())} degenerate faces")

    areas = triangle_areas(tris)
    zarea = np.isfinite(areas) & (areas <= 1e-12)
    report["n_zero_area_faces"] = int(zarea.sum())
    if zarea.any():
        det["zero_area_face_ids"] = np.flatnonzero(zarea).tolist()
        issue(f"mesh has {int(zarea.sum())} zero-area faces")

    nl = np.linalg.norm(normals, axis=1)
    zn = np.isfinite(nl) & (nl <= 1e-12)
    report["n_zero_normals"] = int(zn.sum())
    if zn.any():
        det["zero_normal_face_ids"] = np.flatnonzero(zn).tolist()
        issue(f"mesh has {int(zn.sum())} zero normals")
    badn = np.isfinite(nl) & ~zn & (np.abs(nl - 1.0) > 1e-6)
    report["n_bad_normal_lengths"] = int(badn.sum())
    if badn.any():
        det["bad_normal_length_face_ids"] = np.flatnonzero(badn).tolist()
        issue(f"mesh has {int(badn.sum())} non-unit face normals")

    # orientation sanity: downward-facing ground faces are ignored by the
    # IBM preprocessor and are almost always accidental
    ground = geom.identify_ground_faces()
    down = ground & (normals[:, 2] < -1e-6)
    report["n_downward_ground_faces"] = int(down.sum())
    if down.any():
        ids = np.flatnonzero(down)
        det["downward_ground_face_ids"] = ids.tolist()
        pts = tris[ids].reshape(-1, 3)
        det["downward_ground_bbox"] = np.stack([pts.min(axis=0),
                                                pts.max(axis=0)])
        issue(f"mesh has {int(down.sum())} downward-facing ground faces")

    # planar ground level: the dominant (max total area) flat
    # horizontal face level — NOT the global z-min, which a stray
    # below-ground face would hijack (check_mesh.py:534-551)
    flat = ((np.abs(tris[..., 2] - tris[:, :1, 2]) < 1e-9).all(axis=1)
            & (np.abs(normals[:, 2]) > 0.99))
    if flat.any():
        levels = np.round(tris[flat, 0, 2], 9)
        areas_f = areas[flat]
        zs, inv_z = np.unique(levels, return_inverse=True)
        gz = float(zs[np.argmax(np.bincount(inv_z, weights=areas_f))])
        ground = flat.copy()
        ground[flat] = levels == gz
    if ground.any():
        below = uniq[:, 2] < gz - 1e-9
        report["n_below_ground_vertices"] = int(below.sum())
        if below.any():
            det["below_ground_vertex_ids"] = np.flatnonzero(below).tolist()
            pts = uniq[below]
            det["below_ground_bbox"] = np.stack([pts.min(axis=0),
                                                 pts.max(axis=0)])
            issue(f"mesh has {int(below.sum())} vertices below planar "
                  "ground")

    # non-manifold edges
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]),
                axis=1)
    _, ecnt = np.unique(e, axis=0, return_counts=True)
    nman = int((ecnt > 2).sum())
    report["n_nonmanifold_edges"] = nman
    if nman:
        det["nonmanifold_regions"] = find_nonmanifold_regions(geom)
        issue(f"mesh has {nman} non-manifold edges")

    touching = find_touching_regions(geom)
    report["n_touching_regions"] = len(touching)
    if touching:
        det["touching_regions"] = touching
        issue(f"mesh has {len(touching)} touching-but-unstitched "
              "boundary-edge regions")

    surf = calculate_independent_surfaces(geom)
    report["n_connected_components"] = surf["n_surfaces"]
    report["n_independent_surfaces"] = surf["n_surfaces"]
    det["independent_surfaces"] = [
        dict(surface_id=s["surface_id"], n_faces=s["n_faces"],
             bbox=s["bbox"], face_ids_preview=s["face_ids"][:20])
        for s in surf["surfaces"]]
    if require_single_component and surf["n_surfaces"] != 1:
        issue(f"mesh has {surf['n_surfaces']} disconnected face "
              "components")

    # per-building watertightness: every boundary edge must lie at
    # ground level OR on a lateral domain-boundary plane (periodic
    # geometry — canyons / edge-clipped staggered cubes — is open there
    # by construction)
    open_b = []
    lo = geom.tris.reshape(-1, 3).min(axis=0)
    hi = geom.tris.reshape(-1, 3).max(axis=0)
    for bi, b in enumerate(geom.get_buildings()):
        be = b.boundary_edges()
        if len(be) == 0:
            continue
        u2, _ = b._vertex_ids()
        zmin = geom.tris[..., 2].min()
        pts = u2[np.unique(be.ravel())]
        ok = (np.abs(pts[:, 2] - zmin) < 1e-6)
        for ax in (0, 1):
            ok |= (np.abs(pts[:, ax] - lo[ax]) < 1e-6)
            ok |= (np.abs(pts[:, ax] - hi[ax]) < 1e-6)
        if not np.all(ok):
            open_b.append(bi)
    report["n_open_buildings"] = len(open_b)
    if open_b:
        det["open_building_ids"] = open_b
        issue(f"mesh has {len(open_b)} buildings with boundary edges "
              "above ground (not watertight)")

    report["summary"] = _format_check_summary(report)
    return report


# ---------------------------------------------------------------------------
# Canonical geometry generators
# (tools/python/udgeom/geometry_generation.py: createFlatSurface,
#  createCanyons, createCubes — MATLAB-era generators, numpy version)
# ---------------------------------------------------------------------------

def _quad_mesh(p0, p1, p2, p3, nu: int, nv: int):
    """Structured triangulation of the (possibly non-planar) quad
    p0->p1->p2->p3 into 2*nu*nv triangles
    (geometry_generation._structured_quad_mesh)."""
    p0, p1, p2, p3 = (np.asarray(p, float) for p in (p0, p1, p2, p3))
    u = np.linspace(0.0, 1.0, nu + 1)[:, None, None]
    v = np.linspace(0.0, 1.0, nv + 1)[None, :, None]
    grid = ((1 - u) * (1 - v) * p0 + u * (1 - v) * p1
            + u * v * p2 + (1 - u) * v * p3)
    a = grid[:-1, :-1]
    b = grid[1:, :-1]
    c = grid[1:, 1:]
    d = grid[:-1, 1:]
    t1 = np.stack([a, b, c], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], axis=2).reshape(-1, 3, 3)
    return np.concatenate([t1, t2])


def _box_tris(x0, x1, y0, y1, z0, z1, n: int = 1):
    """Walls + roof of an axis-aligned box (no floor), outward normals."""
    out = [
        _quad_mesh((x0, y0, z1), (x1, y0, z1), (x1, y1, z1),
                   (x0, y1, z1), n, n),                       # roof +z
        _quad_mesh((x0, y0, z0), (x0, y0, z1), (x0, y1, z1),
                   (x0, y1, z0), n, n),                       # -x
        _quad_mesh((x1, y0, z0), (x1, y1, z0), (x1, y1, z1),
                   (x1, y0, z1), n, n),                       # +x
        _quad_mesh((x0, y0, z0), (x1, y0, z0), (x1, y0, z1),
                   (x0, y0, z1), n, n),                       # -y
        _quad_mesh((x0, y1, z0), (x0, y1, z1), (x1, y1, z1),
                   (x1, y1, z0), n, n),                       # +y
    ]
    return np.concatenate(out)


def _ground_with_holes(xsize, ysize, footprints, edgelength):
    """Triangulated z=0 ground covering [0,xsize]x[0,ysize] minus the
    axis-aligned footprint rectangles (x0,x1,y0,y1)
    (geometry_generation._remove_under_building_ground_faces semantics:
    grid lines are aligned to every footprint edge so holes are exact)."""
    xb = {0.0, float(xsize)}
    yb = {0.0, float(ysize)}
    for x0, x1, y0, y1 in footprints:
        xb.update((float(x0), float(x1)))
        yb.update((float(y0), float(y1)))
    xs = sorted(v for v in xb if 0.0 <= v <= xsize)
    ys = sorted(v for v in yb if 0.0 <= v <= ysize)
    # refine each strip to ~edgelength
    def refine(breaks):
        out = [breaks[0]]
        for a, b in zip(breaks[:-1], breaks[1:]):
            n = max(1, int(np.ceil((b - a) / edgelength - 1e-9)))
            out.extend(a + (b - a) * (i + 1) / n for i in range(n))
        return np.asarray(out)
    xs, ys = refine(xs), refine(ys)
    tris = []
    for i in range(len(xs) - 1):
        for j in range(len(ys) - 1):
            cx = 0.5 * (xs[i] + xs[i + 1])
            cy = 0.5 * (ys[j] + ys[j + 1])
            if any(x0 - 1e-9 < cx < x1 + 1e-9 and
                   y0 - 1e-9 < cy < y1 + 1e-9
                   for x0, x1, y0, y1 in footprints):
                continue
            tris.append(_quad_mesh((xs[i], ys[j], 0.0),
                                   (xs[i + 1], ys[j], 0.0),
                                   (xs[i + 1], ys[j + 1], 0.0),
                                   (xs[i], ys[j + 1], 0.0), 1, 1))
    return (np.concatenate(tris) if tris
            else np.zeros((0, 3, 3)))


def create_flat_surface(xsize: float, ysize: float,
                        edgelength: float) -> UDGeom:
    """Flat triangulated ground (createFlatSurface,
    geometry_generation.py:959)."""
    nu = max(1, int(np.ceil(xsize / edgelength)))
    nv = max(1, int(np.ceil(ysize / edgelength)))
    tris = _quad_mesh((0, 0, 0), (xsize, 0, 0), (xsize, ysize, 0),
                      (0, ysize, 0), nu, nv)
    return UDGeom(tris)


def create_canyons(xsize: float, ysize: float, B: float, W: float,
                   H: float, shift: float = 0.0, edgelength: float = None,
                   rotate90: bool = False) -> UDGeom:
    """One-dimensional street canyons: infinite strips of width B spaced W
    apart, height H, walls + roofs + ground between
    (createCanyons, geometry_generation.py:967-1086).  The domain must be
    an integer multiple of B+W in x."""
    edgelength = edgelength or B
    Nx = xsize / (B + W)
    if abs(Nx - round(Nx)) > 1e-9:
        raise ValueError("The domain size should be a multiple of canyon "
                         "width/length")
    Nx = int(round(Nx))
    ny = max(1, int(np.ceil(ysize / edgelength)))
    nz = max(1, int(np.ceil(H / edgelength)))
    nx = max(1, int(np.ceil(B / edgelength)))
    parts, feet = [], []
    for i in range(Nx):
        x0 = i * (B + W) + W / 2.0
        x1 = x0 + B
        if 0.0 < x0 < xsize:
            x0 += shift
        if 0.0 < x1 < xsize:
            x1 += shift
        parts.append(_quad_mesh((x0, 0, 0), (x0, 0, H), (x0, ysize, H),
                                (x0, ysize, 0), nz, ny))     # left wall -x
        parts.append(_quad_mesh((x1, 0, 0), (x1, ysize, 0), (x1, ysize, H),
                                (x1, 0, H), ny, nz))         # right wall +x
        parts.append(_quad_mesh((x0, 0, H), (x1, 0, H), (x1, ysize, H),
                                (x0, ysize, H), nx, ny))     # roof
        feet.append((x0, x1, 0.0, ysize))
    parts.append(_ground_with_holes(xsize, ysize, feet, edgelength))
    tris = np.concatenate(parts)
    if rotate90:
        R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
        tris = tris @ R.T
        tris[..., 0] += xsize
    return UDGeom(tris)


def create_cubes(xsize: float, ysize: float, Hx: float, Hy: float,
                 Hz: float, Cx: float = 0.0, Cy: float = 0.0,
                 geom_option: str = "AC",
                 edgelength: float = None) -> UDGeom:
    """Single ('S'), aligned ('AC') or staggered ('SC') cube arrays with
    the surrounding ground (createCubes, geometry_generation.py:1089-1184).
    Cube centres sit at i*(Cx+Hx) - Hx/2 - Cx/2 per the MATLAB layout;
    staggered rows shift alternate columns by half the y pitch (cubes cut
    by the domain edge are clipped)."""
    edgelength = edgelength or Hx
    n = max(1, int(round(Hx / edgelength)))
    opt = geom_option.upper()
    if opt not in {"S", "AC", "SC"}:
        raise ValueError("geom_option must be 'S', 'AC', or 'SC'")
    boxes = []
    if opt == "S":
        cx, cy = xsize / 2.0, ysize / 2.0
        boxes.append((cx - Hx / 2, cx + Hx / 2, cy - Hy / 2, cy + Hy / 2))
    else:
        Nx = xsize / (Hx + Cx)
        Ny = ysize / (Hy + Cy)
        if abs(Nx - round(Nx)) > 1e-9 or abs(Ny - round(Ny)) > 1e-9:
            raise ValueError("The domain size should be a multiple of "
                             "cube width + canyon width")
        Nx, Ny = int(round(Nx)), int(round(Ny))
        for i in range(1, Nx + 1):
            ccx = i * (Cx + Hx) - Hx / 2 - Cx / 2
            stag = opt == "SC" and i % 2 == 0
            for j in range(1, Ny + 1):
                ccy = (j * (Cy + Hy) if stag
                       else j * (Cy + Hy) - Hy / 2 - Cy / 2)
                boxes.append((ccx - Hx / 2, ccx + Hx / 2,
                              ccy - Hy / 2, ccy + Hy / 2))
            if stag:   # the half cube wrapping in from y=0
                boxes.append((ccx - Hx / 2, ccx + Hx / 2,
                              -Hy / 2, Hy / 2))
    parts, feet = [], []
    for x0, x1, y0, y1 in boxes:
        cy0, cy1 = max(y0, 0.0), min(y1, ysize)
        if cy1 - cy0 < 1e-9:
            continue
        parts.append(_box_tris(x0, x1, cy0, cy1, 0.0, Hz, n))
        feet.append((x0, x1, cy0, cy1))
    parts.append(_ground_with_holes(xsize, ysize, feet, edgelength))
    tris = np.concatenate(parts)
    # clip triangles outside the domain in y (staggered halves)
    cen = tris.mean(axis=1)
    keep = (cen[:, 1] > 0.0) & (cen[:, 1] < ysize)
    return UDGeom(tris[keep])
