"""Visualization — the `udvis` companion of the framework.

Mirrors the reference's `tools/python/udvis/` (scene.py + udbase_vis.py):
a backend-neutral :class:`Scene` of mesh/line/point/glyph primitives plus a
:class:`UDVis` front-end attached to :class:`udales_tpu.post.UDPost`.  The
always-available backend is matplotlib (3-D `Poly3DCollection`); the
reference's plotly/pyvista backends are exposed behind the same `backend=`
argument and raise a clear error when those optional packages are absent.

Color policy (CVD-safe by construction):
  * identity (buildings vs ground, wall types, scalar indices): the fixed
    Okabe-Ito order, never cycled — more than 8 classes fold into "other";
  * magnitude (facet fluxes, 2-D maps): one-hue sequential `viridis`;
  * polarity (signed facet values): diverging `RdBu_r` centred on zero;
  * text/axes stay in neutral ink, never series colors.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

# fixed categorical order (Okabe-Ito, colorblind-safe); index 8 = "other"
OKABE_ITO = ("#0072B2", "#E69F00", "#009E73", "#CC79A7",
             "#56B4E9", "#D55E00", "#F0E442", "#000000", "#999999")
GROUND_RGB = "#b0a58c"
BUILDING_RGB = "#8f9aa6"
SEQUENTIAL_CMAP = "viridis"
DIVERGING_CMAP = "RdBu_r"


# ---------------------------------------------------------------------------
# Scene primitives (tools/python/udvis/scene.py:34-180)
# ---------------------------------------------------------------------------

@dataclass
class MeshPrimitive:
    vertices: np.ndarray          # (nv, 3)
    faces: np.ndarray             # (nf, 3) int
    solid_color: Optional[str] = None
    face_values: Optional[np.ndarray] = None   # (nf,) -> colormapped
    face_colors: Optional[np.ndarray] = None   # (nf, 3|4) explicit RGB(A)
    cmap: Optional[str] = None
    vmin: Optional[float] = None
    vmax: Optional[float] = None
    name: str = ""
    alpha: float = 1.0


@dataclass
class LineSet:
    vertices: np.ndarray          # (nv, 3)
    segments: np.ndarray          # (ns, 2) int
    color: str = "black"
    width: float = 1.0
    name: str = ""


@dataclass
class PointSet:
    points: np.ndarray            # (np, 3)
    color: str = OKABE_ITO[0]
    size: float = 6.0
    name: str = ""
    alpha: float = 1.0


@dataclass
class GlyphSet:
    points: np.ndarray            # (ng, 3)
    vectors: np.ndarray           # (ng, 3)
    scale: float = 1.0
    color: str = OKABE_ITO[5]
    name: str = ""


@dataclass
class Scene:
    meshes: list = field(default_factory=list)
    lines: list = field(default_factory=list)
    points: list = field(default_factory=list)
    glyphs: list = field(default_factory=list)
    title: str = ""
    bounds: Optional[tuple] = None   # (mins(3,), maxs(3,))

    def compute_bounds(self):
        if self.bounds is not None:
            return np.asarray(self.bounds[0]), np.asarray(self.bounds[1])
        pts = [m.vertices for m in self.meshes] + \
              [l.vertices for l in self.lines] + \
              [p.points for p in self.points] + \
              [g.points for g in self.glyphs]
        if not pts:
            return np.zeros(3), np.ones(3)
        allp = np.concatenate([np.asarray(p).reshape(-1, 3) for p in pts])
        return allp.min(axis=0), allp.max(axis=0)


def _set_equal_axes(ax, mins, maxs):
    """Equal data aspect in 3-D (udbase_vis.py:73-84)."""
    ctr = 0.5 * (mins + maxs)
    r = 0.5 * float(np.max(maxs - mins))
    r = r if r > 0 else 1.0
    ax.set_xlim(ctr[0] - r, ctr[0] + r)
    ax.set_ylim(ctr[1] - r, ctr[1] + r)
    ax.set_zlim(max(ctr[2] - r, 0.0), ctr[2] + r)
    try:
        ax.set_box_aspect((1, 1, 1))
    except Exception:
        pass


def _render_plotly(scene: Scene, show: bool):
    """plotly backend (udvis/backend_plotly.py semantics): Mesh3d per mesh
    primitive, Scatter3d for lines/points, cone traces for glyphs."""
    import plotly.graph_objects as go
    traces = []
    for m in scene.meshes:
        v = np.asarray(m.vertices, float)
        f = np.asarray(m.faces, int)
        kw = dict(x=v[:, 0], y=v[:, 1], z=v[:, 2],
                  i=f[:, 0], j=f[:, 1], k=f[:, 2],
                  name=m.name or None, opacity=float(m.alpha),
                  flatshading=True)
        if m.face_values is not None:
            kw.update(intensity=np.asarray(m.face_values, float),
                      intensitymode="cell",
                      colorscale=(m.cmap or SEQUENTIAL_CMAP).capitalize()
                      if (m.cmap or SEQUENTIAL_CMAP).lower() == "viridis"
                      else "RdBu", showscale=True)
            if m.vmin is not None:
                kw["cmin"] = float(m.vmin)
            if m.vmax is not None:
                kw["cmax"] = float(m.vmax)
            if (m.cmap or "").lower() == DIVERGING_CMAP.lower():
                kw["colorscale"] = "RdBu"
                kw["reversescale"] = True
        elif m.face_colors is not None:
            fc = np.asarray(m.face_colors, float)
            kw["facecolor"] = ["rgb(%d,%d,%d)" % tuple(
                (255 * c[:3]).astype(int)) for c in fc]
        else:
            kw["color"] = m.solid_color or BUILDING_RGB
        traces.append(go.Mesh3d(**kw))
    for ln in scene.lines:
        v = np.asarray(ln.vertices, float)
        xs, ys, zs = [], [], []
        for a, b in np.asarray(ln.segments, int):
            xs += [v[a, 0], v[b, 0], None]
            ys += [v[a, 1], v[b, 1], None]
            zs += [v[a, 2], v[b, 2], None]
        traces.append(go.Scatter3d(
            x=xs, y=ys, z=zs, mode="lines", name=ln.name or None,
            line=dict(color=ln.color, width=2.0 * ln.width)))
    for p in scene.points:
        pts = np.asarray(p.points, float).reshape(-1, 3)
        traces.append(go.Scatter3d(
            x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], mode="markers",
            name=p.name or None,
            marker=dict(color=p.color, size=p.size, opacity=p.alpha)))
    for g in scene.glyphs:
        pts = np.asarray(g.points, float).reshape(-1, 3)
        vec = np.asarray(g.vectors, float).reshape(-1, 3) * g.scale
        traces.append(go.Cone(
            x=pts[:, 0], y=pts[:, 1], z=pts[:, 2],
            u=vec[:, 0], v=vec[:, 1], w=vec[:, 2],
            sizemode="absolute", showscale=False,
            colorscale=[[0, g.color], [1, g.color]], name=g.name or None))
    mins, maxs = scene.compute_bounds()
    fig = go.Figure(data=traces)
    fig.update_layout(
        title=scene.title or None,
        scene=dict(aspectmode="data",
                   xaxis=dict(range=[float(mins[0]), float(maxs[0])]),
                   yaxis=dict(range=[float(mins[1]), float(maxs[1])]),
                   zaxis=dict(range=[0.0, float(maxs[2])])))
    if show:        # pragma: no cover - interactive
        fig.show()
    return fig


def render_scene(scene: Scene, backend: str = "matplotlib", show: bool = False):
    """Render a Scene. Returns the backend figure (matplotlib Figure or
    plotly Figure).  `pyvista` (the reference's third backend) is not
    bundled in this image and raises with a clear message."""
    if backend == "plotly":
        try:
            __import__("plotly")
        except ImportError as e:
            raise ImportError(
                "backend 'plotly' requires the optional plotly package "
                "(not bundled); use backend='matplotlib'") from e
        return _render_plotly(scene, show)
    if backend == "pyvista":
        try:
            __import__(backend)
        except ImportError as e:
            raise ImportError(
                f"backend {backend!r} requires the optional {backend} package "
                f"(not bundled); use backend='matplotlib'") from e
        raise NotImplementedError(
            "backend 'pyvista': install-time hook only; matplotlib and "
            "plotly are the supported backends")
    import matplotlib
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import (Line3DCollection,
                                            Poly3DCollection)

    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(projection="3d")
    mappable = None
    for m in scene.meshes:
        polys = np.asarray(m.vertices)[np.asarray(m.faces)]
        coll = Poly3DCollection(polys, alpha=m.alpha)
        if m.face_values is not None:
            vals = np.asarray(m.face_values, float)
            vmin = m.vmin if m.vmin is not None else float(np.nanmin(vals))
            vmax = m.vmax if m.vmax is not None else float(np.nanmax(vals))
            cmap = m.cmap or SEQUENTIAL_CMAP
            norm = matplotlib.colors.Normalize(vmin=vmin, vmax=vmax)
            coll.set_facecolor(plt.get_cmap(cmap)(norm(vals)))
            mappable = matplotlib.cm.ScalarMappable(norm=norm, cmap=cmap)
        elif m.face_colors is not None:
            coll.set_facecolor(m.face_colors)
        else:
            coll.set_facecolor(m.solid_color or BUILDING_RGB)
        coll.set_edgecolor("none")
        if m.name:
            coll.set_label(m.name)
        ax.add_collection3d(coll)
    for l in scene.lines:
        segs = np.asarray(l.vertices)[np.asarray(l.segments)]
        ax.add_collection3d(
            Line3DCollection(segs, colors=l.color, linewidths=l.width))
    for p in scene.points:
        pts = np.asarray(p.points)
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=p.size,
                       c=p.color, alpha=p.alpha, label=p.name or None,
                       depthshade=False)
    for g in scene.glyphs:
        pts, vec = np.asarray(g.points), np.asarray(g.vectors) * g.scale
        ax.quiver(pts[:, 0], pts[:, 1], pts[:, 2],
                  vec[:, 0], vec[:, 1], vec[:, 2], color=g.color,
                  linewidth=0.8)
    mins, maxs = scene.compute_bounds()
    _set_equal_axes(ax, mins, maxs)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_zlabel("z (m)")
    if scene.title:
        ax.set_title(scene.title)
    if mappable is not None:
        fig.colorbar(mappable, ax=ax, shrink=0.6, pad=0.1)
    if show:   # pragma: no cover - interactive
        plt.show()
    return fig


# ---------------------------------------------------------------------------
# UDVis front-end (tools/python/udvis/udbase_vis.py:37-1107)
# ---------------------------------------------------------------------------

class UDVis:
    """Visualization methods over a loaded :class:`UDPost` case.

    Unlike the reference (plotly/pyvista, `show=True` default), figures
    default to `show=False` and are returned, which suits headless use;
    pass `show=True` interactively.
    """

    def __init__(self, sim, backend: str = "matplotlib"):
        self.sim = sim
        self.backend = backend
        self._tris = None
        self._normals = None

    # -- geometry access ----------------------------------------------------
    @property
    def geom(self):
        """(tris (n,3,3), normals (n,3)) from the case STL, or None."""
        if self._tris is None:
            from .prep.stl import read_stl
            cand = [self.sim.path / f"geom.{self.sim.expnr}.stl",
                    self.sim.path / f"geom.{self.sim.expnr}.STL"]
            cand += sorted(self.sim.path.glob("*.stl"))
            cand += sorted(self.sim.path.glob("*.STL"))
            for p in cand:
                if Path(p).exists():
                    self._tris, self._normals = read_stl(p)
                    break
        if self._tris is None:
            return None
        return self._tris, self._normals

    def _mesh_arrays(self):
        g = self.geom
        if g is None:
            raise ValueError("No geometry (STL) found in the case directory.")
        tris, normals = g
        verts = tris.reshape(-1, 3)
        faces = np.arange(len(verts)).reshape(-1, 3)
        centers = tris.mean(axis=1)
        return verts, faces, centers, normals

    # -- 3-D scenes ---------------------------------------------------------
    def show_geometry(self, color_buildings: bool = True,
                      plot_quiver: bool = False, normal_scale: float = 0.2,
                      show_edges: bool = True, show_ground: bool = True,
                      show: bool = False, backend: Optional[str] = None):
        """Building/ground mesh (udbase_vis.py:125-201)."""
        verts, faces, centers, normals = self._mesh_arrays()
        is_b = centers[:, 2] > 0
        meshes = []
        if color_buildings:
            if show_ground and np.any(~is_b):
                meshes.append(MeshPrimitive(verts, faces[~is_b],
                                            solid_color=GROUND_RGB,
                                            name="ground"))
            if np.any(is_b):
                meshes.append(MeshPrimitive(verts, faces[is_b],
                                            solid_color=BUILDING_RGB,
                                            name="buildings"))
        else:
            sel = faces if show_ground else faces[is_b]
            meshes.append(MeshPrimitive(verts, sel, solid_color=GROUND_RGB,
                                        name="geometry"))
        scene = Scene(meshes=meshes, title=f"Geometry: {len(faces)} facets")
        if show_edges:
            sel = faces if show_ground else faces[is_b]
            segs = np.concatenate([sel[:, [0, 1]], sel[:, [1, 2]],
                                   sel[:, [2, 0]]])
            scene.lines.append(LineSet(verts, segs, color="#00000040",
                                       width=0.5))
        if plot_quiver:
            scene.glyphs.append(GlyphSet(centers, normals,
                                         scale=normal_scale,
                                         name="normals"))
        return render_scene(scene, backend or self.backend, show)

    def plot_fac(self, var: np.ndarray, cmap: Optional[str] = None,
                 title: str = "", show: bool = False,
                 backend: Optional[str] = None):
        """Color the facet mesh by a per-facet value (udbase_vis.py:584).

        Sequential viridis for one-signed data, diverging RdBu_r centred
        on zero otherwise."""
        verts, faces, centers, _ = self._mesh_arrays()
        var = np.asarray(var, float)
        if len(var) != len(faces):
            raise ValueError(
                f"var has {len(var)} values for {len(faces)} facets")
        vmin, vmax = float(np.nanmin(var)), float(np.nanmax(var))
        if cmap is None:
            if vmin < 0 < vmax:
                cmap = DIVERGING_CMAP
                r = max(abs(vmin), abs(vmax))
                vmin, vmax = -r, r
            else:
                cmap = SEQUENTIAL_CMAP
        scene = Scene(meshes=[MeshPrimitive(verts, faces, face_values=var,
                                            cmap=cmap, vmin=vmin, vmax=vmax)],
                      title=title or "facet values")
        return render_scene(scene, backend or self.backend, show)

    def plot_fac_type(self, show: bool = False,
                      backend: Optional[str] = None):
        """Facets colored by wall type — fixed categorical order, >8 types
        fold into 'other' (udbase_vis.py:717)."""
        verts, faces, centers, _ = self._mesh_arrays()
        if self.sim.facets is None:
            raise ValueError("facets.inp not loaded")
        wtypes = np.asarray(self.sim.facets, int)
        uniq = sorted(set(wtypes.tolist()))
        colors = np.empty((len(faces), 4))
        import matplotlib.colors as mc
        for i, wt in enumerate(uniq):
            col = OKABE_ITO[i] if i < 8 else OKABE_ITO[8]
            colors[wtypes == wt] = mc.to_rgba(col)
        scene = Scene(meshes=[MeshPrimitive(verts, faces,
                                            face_colors=colors)],
                      title=f"wall types ({len(uniq)})")
        fig = render_scene(scene, backend or self.backend, show)
        # legend: one labeled proxy per type (identity never color-alone)
        import matplotlib.patches as mp
        handles = [mp.Patch(color=OKABE_ITO[min(i, 8)], label=f"type {wt}")
                   for i, wt in enumerate(uniq)]
        fig.axes[0].legend(handles=handles, loc="upper left", fontsize=8)
        return fig

    def _cell_points(self, ijk: np.ndarray):
        s = self.sim
        return np.column_stack([s.xt[np.clip(ijk[:, 0], 0, s.itot - 1)],
                                s.yt[np.clip(ijk[:, 1], 0, s.jtot - 1)],
                                s.zt[np.clip(ijk[:, 2], 0, s.ktot - 1)]])

    def plot_solid(self, which: str = "c", show: bool = False,
                   backend: Optional[str] = None):
        """Solid-point cloud of one staggered grid (udbase_vis.py:421)."""
        masks = self.sim.load_solid_masks()
        if which not in masks:
            raise ValueError(f"no solid_{which}.txt in case dir")
        ijk = np.argwhere(masks[which])
        scene = Scene(points=[PointSet(self._cell_points(ijk),
                                       color=OKABE_ITO[7], size=2.0,
                                       name=f"solid_{which}", alpha=0.3)],
                      title=f"solid points ({which}): {len(ijk)}")
        return render_scene(scene, backend or self.backend, show)

    def plot_fluid_boundary(self, which: str = "c", show: bool = False,
                            backend: Optional[str] = None):
        """Fluid boundary points of one grid (udbase_vis.py:484)."""
        fs = self.sim.facsec.get(which)
        if fs is None:
            raise ValueError(f"no facet_sections_{which}.txt in case dir")
        scene = Scene(points=[PointSet(self._cell_points(fs["locs"]),
                                       color=OKABE_ITO[0], size=3.0,
                                       name=f"boundary_{which}")],
                      title=f"fluid boundary points ({which})")
        return render_scene(scene, backend or self.backend, show)

    def plot_veg(self, show: bool = False, backend: Optional[str] = None):
        """Vegetation cells (udbase_vis.py:295)."""
        veg = self.sim.load_veg()
        if veg is None:
            raise ValueError("no veg.inp in case dir")
        scene = Scene(points=[PointSet(self._cell_points(veg["ijk"]),
                                       color=OKABE_ITO[2], size=4.0,
                                       name="vegetation")],
                      title=f"vegetation cells: {len(veg['ijk'])}")
        return render_scene(scene, backend or self.backend, show)

    def plot_scalar_source(self, show: bool = False,
                           backend: Optional[str] = None):
        """Point/line scalar sources, one fixed color per scalar index
        (udbase_vis.py:359)."""
        src = self.sim.load_scalar_sources()
        scene = Scene(title="scalar sources")
        for n, tab in src["point"].items():
            scene.points.append(PointSet(tab[:, 0:3],
                                         color=OKABE_ITO[min(n - 1, 8)],
                                         size=20.0, name=f"sv{n} point"))
        for n, tab in src["line"].items():
            nv = len(tab)
            verts = np.concatenate([tab[:, 0:3], tab[:, 3:6]])
            segs = np.column_stack([np.arange(nv), np.arange(nv) + nv])
            scene.lines.append(LineSet(verts, segs,
                                       color=OKABE_ITO[min(n - 1, 8)],
                                       width=2.0, name=f"sv{n} line"))
        if not (scene.points or scene.lines):
            raise ValueError("no scalar source files in case dir")
        return render_scene(scene, backend or self.backend, show)

    # -- 2-D figures --------------------------------------------------------
    def plot_2dmap(self, val, labels=None, show: bool = False):
        """Horizontal (x,y) map(s) — sequential colormap + colorbar
        (udbase_vis.py:819)."""
        import matplotlib.pyplot as plt
        vals = np.asarray(val)
        if vals.ndim == 2:
            vals = vals[None]
        labels = ([labels] if isinstance(labels, str) else
                  labels or [f"field {i}" for i in range(len(vals))])
        n = len(vals)
        fig, axs = plt.subplots(1, n, figsize=(5 * n, 4), squeeze=False)
        s = self.sim
        for i, (v, lab) in enumerate(zip(vals, labels)):
            ax = axs[0, i]
            pm = ax.pcolormesh(s.xt, s.yt, v.T, cmap=SEQUENTIAL_CMAP,
                               shading="auto")
            ax.set_aspect("equal")
            ax.set_xlabel("x (m)")
            ax.set_ylabel("y (m)")
            ax.set_title(lab)
            fig.colorbar(pm, ax=ax, shrink=0.85)
        fig.tight_layout()
        if show:   # pragma: no cover
            plt.show()
        return fig

    def plot_profiles(self, save: bool = False, show: bool = False,
                      outdir: str | Path | None = None):
        """Initial profiles from prof.inp (udbase_vis.py:899)."""
        import matplotlib.pyplot as plt
        p = self.sim.load_prof()
        zt = self.sim.zt
        names = [("u", "u (m/s)"), ("v", "v (m/s)"), ("thl", "thl (K)"),
                 ("qt", "qt (kg/kg)"), ("e12", "e12 (m/s)")]
        fig, axs = plt.subplots(1, len(names), figsize=(3 * len(names), 4),
                                sharey=True)
        for ax, (k, lab) in zip(axs, names):
            ax.plot(p[k], zt, color=OKABE_ITO[0], lw=2)
            ax.set_xlabel(lab)
            ax.grid(alpha=0.25)
        axs[0].set_ylabel("z (m)")
        fig.suptitle(f"initial profiles ({self.sim.expnr})")
        fig.tight_layout()
        if save:
            out = Path(outdir or self.sim.path)
            fig.savefig(out / f"profiles_{self.sim.expnr}.png", dpi=150)
        if show:   # pragma: no cover
            plt.show()
        return fig

    def plot_dz_variation(self, save: bool = False, show: bool = False,
                          outdir: str | Path | None = None):
        """Vertical grid spacing vs height (udbase_vis.py:978)."""
        import matplotlib.pyplot as plt
        zt, dzt = self.sim.zt, self.sim.dzt
        fig, ax = plt.subplots(figsize=(4.5, 4.5))
        ax.plot(dzt, zt, marker="o", ms=3, color=OKABE_ITO[0], lw=1.5)
        ax.set_xlabel("dz (m)")
        ax.set_ylabel("z (m)")
        ax.set_title("vertical grid spacing")
        ax.grid(alpha=0.25)
        fig.tight_layout()
        if save:
            out = Path(outdir or self.sim.path)
            fig.savefig(out / f"dz_{self.sim.expnr}.png", dpi=150)
        if show:   # pragma: no cover
            plt.show()
        return fig

    def plot_lscale(self, save: bool = False, show: bool = False,
                    outdir: str | Path | None = None):
        """Large-scale forcing profiles (udbase_vis.py:1032)."""
        import matplotlib.pyplot as plt
        ls = self.sim.load_lscale()
        zt = self.sim.zt
        keys = [k for k in ("ug", "vg", "pgx", "pgy", "wfls", "thlpcar")
                if k in ls]
        fig, axs = plt.subplots(1, len(keys), figsize=(3 * len(keys), 4),
                                sharey=True, squeeze=False)
        for ax, k in zip(axs[0], keys):
            ax.plot(ls[k], zt, color=OKABE_ITO[0], lw=2)
            ax.set_xlabel(k)
            ax.grid(alpha=0.25)
        axs[0, 0].set_ylabel("z (m)")
        fig.suptitle(f"large-scale forcings ({self.sim.expnr})")
        fig.tight_layout()
        if save:
            out = Path(outdir or self.sim.path)
            fig.savefig(out / f"lscale_{self.sim.expnr}.png", dpi=150)
        if show:   # pragma: no cover
            plt.show()
        return fig
