"""Immersed boundary method: solid masks, facet-section wall functions and
the solid-cell normalisation (port of ``udales_tpu.ibm.ibm``; src/modibm.f90).

The static geometry is read on the host (``IBM.load``: initibm and the
initfac readers) into

  - dense 0/1 fluid masks u/v/w/c (w face 0, the floor, solid;
    modibm.f90:156) and their ghosted forms ``pmask_u/v/w/c``, which fold
    the diffusion corrections diffu/v/w/c_corr into the diffusion sweeps
  - one flat list of active facet sections per staggered grid: the
    boundary point's flat index, gather indices and weights of the
    interpolated velocity and air temperature, the facet normal and the
    static wall-function terms (initibmwallfun :273-383)

and the run-time work of ``wallfun`` is one gather per source field, the
transfer coefficients on the section vectors and one ``index_add_`` per
grid (wallfunmom :1286, wallfunheat :1436).  That is the reference's own
sparse form (``_gather_uvw``/``_wallfunmom``/``_wallfunheat``); sections
that share a boundary point sum, as the TPU package's coplanar merge does.

Sections whose boundary point lies too deep in the roughness layer
(log(dist/z0) <= 1) sample the flow at a static reconstruction point
instead (initibmwallfun :384-533, trilinear_interp_var :1609): their
gather tables hold the 8 trilinear corners, and ``lnorec`` skips them.

With a facet state (``ibm.eb.FacetState``, energy-balance runs) the surface
temperature of a section is the live ``fac.T[:, 0]`` of its facet, gathered
per call; `wallfun` then also returns the per-facet flux sums the balance
integrates (one more ``index_add_`` over the facet id), the domain totals
for ``periodic_eb_corr``, the latent flux of moist walls (fixed, or the
green-roof resistances of the facet state) and the ``lwritefac`` facet
statistics.

Under an x/y process split (``IBM.load(..., mesh=)``, ``parallel.mesh``)
the geometry is prepared on the domain grid as on one device and then cut:
each rank keeps its block of the masks, its block of the ghosted masks with
their one-cell ring, and the sections whose boundary point lies in its
block, their gather points re-based to its ghosted block.  The periodic
pads of ibmnorm are the mesh's halo exchange, and the per-facet sums and
domain totals of `wallfun` are summed over the ranks in one all-reduce, so
every rank returns the domain's.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np
import torch

from ..config import IADV_CD2, Config, const
from ..grid import Grid
from ..io.inputs import (read_column_file, read_facet_sections,
                         read_facets_inp, read_sparse_ijk)
from ..ops.halo import pad_edge, pad_periodic_xy, pad_wrap
from ..state import FACSTAT_FIELDS
from .wallfn import UMIN, _stability_fm_fh

GRIDS = ("u", "v", "w", "c")
# alignment code of the facets each grid skips (initibmwallfun:371-380):
# u sections skip x-normal facets, v y-normal, w z-normal; c skips none
SKIP_ALIGN = {"u": 1, "v": 2, "w": 3, "c": 0}


@dataclass(frozen=True)
class Masks:
    """Dense 0/1 fluid masks in the solver dtype.  u/v/c are cell-count
    shaped; w is face-shaped (nx, ny, nz+1) with face 0 solid."""
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    c: torch.Tensor


@dataclass(frozen=True)
class SecData:
    """Facet sections of one staggered grid as read (host NumPy)."""
    ijk: np.ndarray      # (S, 3) 0-based boundary-point indices
    area: np.ndarray     # (S,)
    dist: np.ndarray     # (S,) wall distance (to the reconstruction point
                         # for rec sections)
    fac: np.ndarray      # (S,) facet id, 0-based
    active: np.ndarray   # (S,) bool: not skipped (modibm.f90:371-380, 1364)
    rec: np.ndarray      # (S,) bool: sample at the reconstruction point
    interp: dict | None = None   # grid -> corners (S, 8, 3), weights (S, 8)


@dataclass(frozen=True)
class Sections:
    """The active sections of one staggered grid on the device.

    ``flat`` indexes the grid's field (nx, ny, nz), or (nx, ny, nz+1) for
    w.  ``idx_*``/``wgt_*`` are (S, P) flat indices into the ghosted fields
    (ops/boundary.py layout) and weights whose weighted sum is the
    interpolated u, v, w or air temperature (t) at the boundary point, or
    at the reconstruction point of a rec section (P = 4, or 8 when the grid
    has rec sections: their trilinear corners).
    ``coef`` is area / cell volume (u, v, w) or area / (dx dy dzh) (c)."""
    flat: torch.Tensor
    idx_u: torch.Tensor
    wgt_u: torch.Tensor
    idx_v: torch.Tensor
    wgt_v: torch.Tensor
    idx_w: torch.Tensor
    wgt_w: torch.Tensor
    idx_t: torch.Tensor
    wgt_t: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    dist: torch.Tensor
    logdz: torch.Tensor      # log(dist / z0)
    logzh: torch.Tensor      # log(z0 / z0h)
    sqdz: torch.Tensor       # sqrt(dist / z0)
    tsurf: torch.Tensor      # static facet temperature (no facet state)
    ctm_neutral: torch.Tensor
    coef: torch.Tensor
    fid: torch.Tensor        # facet id of each section
    area: torch.Tensor
    # c sections only:
    orient: torch.Tensor | None = None  # index of the section's fixed heat
                                        # flux in (bctfxm, xp, ym, yp, z, 0)
    mflux: torch.Tensor | None = None   # fixed moisture flux (iwallmoist=1)
    lGR: torch.Tensor | None = None     # bool: on a green-roof facet


def _alignment(norms: np.ndarray) -> np.ndarray:
    """Vectorized `alignment` (modibm.f90:1682-1705): +-1/2/3 for
    axis-aligned unit normals, 0 otherwise."""
    out = np.zeros(len(norms), np.int64)
    for ax, code in ((0, 1), (1, 2), (2, 3)):
        e = np.zeros(3)
        e[ax] = 1.0
        out[np.all(np.abs(norms - e) < const.eps1, axis=1)] = code
        out[np.all(np.abs(norms + e) < const.eps1, axis=1)] = -code
    return out


def _flat_index(ijk, shape, what: str) -> np.ndarray:
    """C-order flat indices of the (S, 3) points `ijk` in `shape`; raises
    ValueError on a point outside it (never wraps or clamps)."""
    ijk = np.asarray(ijk, np.int64).reshape(-1, 3)
    bad = np.any((ijk < 0) | (ijk >= np.asarray(shape)), axis=1)
    if bad.any():
        raise ValueError(f"{what}: {int(bad.sum())} point(s) outside "
                         f"{tuple(shape)}, first {ijk[bad][0].tolist()}")
    return np.ravel_multi_index((ijk[:, 0], ijk[:, 1], ijk[:, 2]), shape)


def _interp_stencils(which: str, ijk, mask_c, grid: Grid):
    """Gather points and weights of the interpolated velocity and air
    temperature at the boundary points of one grid (interp_velocity_* and
    interp_temperature_*, modibm.f90:1737-1829; udales_tpu ``_gather_uvw``
    and its stencil form ``_dense_uvwT``).

    Returns {field: (points (S, 4, 3), weights (S, 4))} with points as
    (i, j, k) into the unghosted fields; x/y neighbours may be -1 or n (the
    periodic ghosts).  The temperature pair 0.5 (t0 m0 (2 - m1) + t1 m1
    (2 - m0)) takes the static c-mask values m0, m1 as weights."""
    nz = grid.ktot
    i, j, k = ijk[:, 0], ijk[:, 1], ijk[:, 2]
    P = lambda *pts: np.stack([np.stack(p, axis=1) for p in pts], axis=1)
    S = len(i)
    full = lambda *w: np.broadcast_to(np.asarray(w, float), (S, 4)).copy()
    quarter = full(.25, .25, .25, .25)
    if which == "w":
        # w lives on faces: face k lies between cells kmc = k-1 and kc = k
        kc, kmc, kp = (np.minimum(k, nz - 1), np.maximum(k - 1, 0),
                       np.minimum(k + 1, nz))
    else:
        kc, kp = k, k + 1
    if which == "c":
        return dict(u=(P((i, j, k), (i + 1, j, k), (i, j, k), (i, j, k)),
                       full(.5, .5, 0, 0)),
                    v=(P((i, j, k), (i, j + 1, k), (i, j, k), (i, j, k)),
                       full(.5, .5, 0, 0)),
                    w=(P((i, j, k), (i, j, kp), (i, j, k), (i, j, k)),
                       full(.5, .5, 0, 0)),
                    t=(P((i, j, k), (i, j, k), (i, j, k), (i, j, k)),
                       full(1, 0, 0, 0)))
    if which == "u":
        u = (P((i, j, k), (i, j, k), (i, j, k), (i, j, k)), full(1, 0, 0, 0))
        v = (P((i, j, k), (i, j + 1, k), (i - 1, j, k), (i - 1, j + 1, k)),
             quarter)
        w = (P((i, j, k), (i, j, kp), (i - 1, j, k), (i - 1, j, kp)),
             quarter)
        t_other = (i - 1, j, k)
    else:   # v or w
        u = (P((i, j, kc), (i + 1, j, kc), (i, j - 1, kc),
               (i + 1, j - 1, kc)), quarter)
        v = (P((i, j, kc), (i, j, kc), (i, j, kc), (i, j, kc)),
             full(1, 0, 0, 0))
        w = (P((i, j, k), (i, j, kp), (i, j - 1, k), (i, j - 1, kp)),
             quarter)
        t_other = (i, j - 1, kc) if which == "v" else (i, j, kmc)
    nx, ny = grid.itot, grid.jtot
    m0 = mask_c[i % nx, j % ny, kc]
    m1 = mask_c[t_other[0] % nx, t_other[1] % ny, t_other[2]]
    wt = np.zeros((S, 4))
    wt[:, 0] = 0.5 * m0 * (2.0 - m1)
    wt[:, 1] = 0.5 * m1 * (2.0 - m0)
    t = (P((i, j, kc), t_other, (i, j, kc), (i, j, kc)), wt)
    return dict(u=u, v=v, w=w, t=t)


def _tri_axis(coord, x, n, clamp=False):
    """Base index and fraction along one axis of a trilinear interpolation
    (initibmwallfun findloc calls, modibm.f90:432-451; udales_tpu
    ibm.py:66).  ``coord`` is the 1-D coordinate array searched (with one
    ghost entry for cell-centre grids); corner indices wrap periodically in
    x/y and clamp at the top in z."""
    i0 = np.searchsorted(coord, x, side="right") - 1
    ok = (i0 >= 0) & (i0 <= len(coord) - 2)
    i0c = np.clip(i0, 0, len(coord) - 2)
    t = (x - coord[i0c]) / (coord[i0c + 1] - coord[i0c])
    idx = i0c[:, None] + np.array([0, 1])[None, :]
    idx = np.minimum(idx, n - 1) if clamp else idx % n
    return idx, np.clip(t, 0.0, 1.0), ok


def _reconstruction_data(ijk, dist, norms, z0, dir_align, grid: Grid):
    """Static reconstruction points and trilinear gather tables
    (initibmwallfun, modibm.f90:384-533; udales_tpu ibm.py:83).

    For each section: the exit point of the segment from the boundary cell
    centre along the facet normal (length sqrt(3) (dx dy dz)^(1/3)) through
    the cell's six faces, the extended wall distance, and per staggered
    grid the corner indices and weights of the trilinear interpolation at
    that point.  Returns (ok, recdist, interp)."""
    nx, ny, nz = grid.shape
    dx, dy = grid.dx, grid.dy
    dz0 = float(grid.dzf[0])   # the reference assumes equidistant z here
    xh, xf, yh, yf = grid.xh, grid.xf, grid.yh, grid.yf
    zf, zh = grid.zf, grid.zh
    cgrid = {1: (xh, yf, zf), 2: (xf, yh, zf),
             3: (xf, yf, zh), 0: (xf, yf, zf)}[dir_align]
    p0 = np.stack([cgrid[0][ijk[:, 0]], cgrid[1][ijk[:, 1]],
                   cgrid[2][ijk[:, 2]]], axis=1)
    L = np.sqrt(3.0) * (dx * dy * dz0) ** (1.0 / 3.0)
    seg = norms * L
    # first intersection with the six cell-face planes
    half = np.array([dx / 2, dy / 2, dz0 / 2])
    t_best = np.full(len(ijk), np.inf)
    for ax in range(3):
        for sgn in (-1.0, 1.0):
            D = seg[:, ax]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (sgn * half[ax]) / D
            valid = (np.abs(D) > const.eps1) & (t >= 0.0) & (t <= 1.0)
            t_best = np.where(valid & (t < t_best), t, t_best)
    ok = np.isfinite(t_best)
    t_best = np.where(ok, t_best, 0.0)
    recpt = p0 + t_best[:, None] * seg
    recdist = dist + t_best * L
    # the run-time guard made static (wallfunmom:1364): still too shallow
    with np.errstate(divide="ignore", invalid="ignore"):
        ok &= np.log(np.maximum(recdist, 1e-30)
                     / np.maximum(z0, 1e-30)) > 1.0
    # x/y ghost centres mirror the periodic halo; z gets one ghost centre
    xf_e = np.append(xf, xf[-1] + dx)
    yf_e = np.append(yf, yf[-1] + dy)
    zf_e = np.append(zf, zf[-1] + (zh[-1] - zf[-1]) * 2)
    axes = {"xh": (xh, nx, False), "xf": (xf_e, nx, False),
            "yh": (yh, ny, False), "yf": (yf_e, ny, False),
            "zf": (zf_e, nz, True), "zh": (zh, nz + 1, True)}
    grids = {"u": ("xh", "yf", "zf"), "v": ("xf", "yh", "zf"),
             "w": ("xf", "yf", "zh"), "c": ("xf", "yf", "zf")}
    di = np.array([0, 0, 0, 0, 1, 1, 1, 1])
    dj = np.array([0, 0, 1, 1, 0, 0, 1, 1])
    dk = np.array([0, 1, 0, 1, 0, 1, 0, 1])
    interp = {}
    for key, (ax, ay, az) in grids.items():
        ix, tx, okx = _tri_axis(axes[ax][0], recpt[:, 0], axes[ax][1],
                                clamp=axes[ax][2])
        iy, ty, oky = _tri_axis(axes[ay][0], recpt[:, 1], axes[ay][1],
                                clamp=axes[ay][2])
        iz, tz, okz = _tri_axis(axes[az][0], recpt[:, 2], axes[az][1],
                                clamp=axes[az][2])
        ok &= okx & oky & okz
        idx = np.stack([ix[:, di], iy[:, dj], iz[:, dk]], axis=2)
        wx = np.stack([1 - tx, tx], 1)[:, di]
        wy = np.stack([1 - ty, ty], 1)[:, dj]
        wz = np.stack([1 - tz, tz], 1)[:, dk]
        interp[key] = (idx, wx * wy * wz)
    return ok, recdist, interp


def _block_stencils(ijk, stencils: dict, dom: Grid, blk: Grid, which: str):
    """The sections of one grid whose boundary point lies in the block of
    `blk` (``Grid.block``): (their points in block coordinates, their
    stencils {name: (points, weights)} re-based to the block, the boolean
    selection).  A stencil point is stored either as a -1 / n ghost index
    (`_interp_stencils`) or wrapped modulo n (`_tri_axis`'s corners), so
    each is re-based from its offset to the boundary point, unwrapped.  A
    point of weight 0 (a trilinear corner two cells away when the
    reconstruction point lies on a face of the staggered grid) reads the
    boundary point's own cell instead; a weighted point outside the
    block's one-cell ring raises ValueError."""
    bx, by = blk.itot, blk.jtot
    mine = ((ijk[:, 0] >= blk.i0) & (ijk[:, 0] < blk.i0 + bx)
            & (ijk[:, 1] >= blk.j0) & (ijk[:, 1] < blk.j0 + by))
    bp = ijk[mine]
    local = bp - np.array([blk.i0, blk.j0, 0])
    out = {}
    for name, (pts, wgt) in stencils.items():
        pts, wgt = pts[mine].copy(), wgt[mine]
        for ax, n, b in ((0, dom.itot, bx), (1, dom.jtot, by)):
            d = pts[..., ax] - bp[:, None, ax]
            d = np.where(wgt != 0, (d + n // 2) % n - n // 2, 0)
            p = local[:, None, ax] + d
            bad = (p < -1) | (p > b)
            if bad.any():
                raise ValueError(
                    f"interpolation of {which} sections: {int(bad.sum())} "
                    f"stencil point(s) beyond the one-cell ring of the "
                    f"{bx} x {by} block at ({blk.i0}, {blk.j0})")
            pts[..., ax] = p
        out[name] = (pts, wgt)
    return local, out, mine


class IBM:
    """Static IBM geometry of one case and its run-time operators."""

    def __init__(self, cfg: Config, grid: Grid, masks_np: dict, sec: dict,
                 facnorm, facz0, facz0h, facT, faca, faclGR=None,
                 device="cpu", mesh=None):
        """`grid` is the domain's; with a `mesh` the IBM is this rank's
        block of it (``grid`` the block grid, ``domain_grid`` the
        domain's)."""
        self.cfg = cfg
        self.domain_grid = grid
        self.mesh = mesh
        self.grid = grid.block(mesh) if mesh is not None else grid
        self.device = torch.device(device)
        kw = dict(dtype=grid.torch_dtype, device=self.device)
        whole = {k: torch.as_tensor(masks_np[k], **kw) for k in GRIDS}
        self.masks = Masks(**{k: self.grid.cut(m).clone(
            memory_format=torch.contiguous_format) for k, m in whole.items()})
        self.sec = sec                 # grid name -> SecData (host)
        self.facnorm = np.asarray(facnorm, np.float64)   # (nfcts, 3)
        self.facz0 = np.asarray(facz0, np.float64)
        self.facz0h = np.asarray(facz0h, np.float64)
        self.facT = np.asarray(facT, np.float64)
        self.faca = np.asarray(faca, np.float64)
        self.nfcts = len(self.facz0)
        self.faclGR = (np.zeros(self.nfcts, bool) if faclGR is None
                       else np.asarray(faclGR, bool))
        self.faca_t = torch.as_tensor(self.faca, **kw)
        self._prep_pmasks(Masks(**whole))
        # per grid, the rows of the domain's active sections this IBM holds
        self.rows = {}
        self.lists = {k: self._sections(k, masks_np["c"]) for k in GRIDS}

    # ------------------------------------------------------------------
    # Loading (initibm + initfac readers)
    # ------------------------------------------------------------------
    @classmethod
    def load(cls, case_dir, expnr: str, cfg: Config, grid: Grid,
             device="cpu", mesh=None) -> "IBM":
        """Read the masks, facets and sections of a case directory
        (udales_tpu ``IBM.load``, ibm.py:192-278) on the domain `grid`;
        with a `mesh` (``parallel.mesh.Mesh``) the IBM of this rank's
        block."""
        case_dir = Path(case_dir)
        nx, ny, nz = grid.shape
        w = cfg.walls

        def mask_from(fname, shape, n_expected):
            m = np.ones(shape, np.float32)
            p = case_dir / fname
            if p.exists() and n_expected != 0:
                m.reshape(-1)[_flat_index(read_sparse_ijk(p), shape,
                                          fname)] = 0.0
            return m

        masks = dict(u=mask_from("solid_u.txt", (nx, ny, nz), w.nsolpts_u),
                     v=mask_from("solid_v.txt", (nx, ny, nz), w.nsolpts_v),
                     w=mask_from("solid_w.txt", (nx, ny, nz + 1),
                                 w.nsolpts_w),
                     c=mask_from("solid_c.txt", (nx, ny, nz), w.nsolpts_c))
        masks["w"][:, :, 0] = 0.0   # floor faces always solid

        walltype, facnorm = read_facets_inp(case_dir / f"facets.inp.{expnr}")
        ft = np.loadtxt(case_dir / f"factypes.inp.{expnr}", skiprows=3,
                        ndmin=2)
        # columns: wallid lGR z0 z0h al em ... (initfac.f90:166-193)
        typemap = {int(r[0]): r for r in ft}
        facz0 = np.array([typemap[int(t)][2] for t in walltype])
        facz0h = np.array([typemap[int(t)][3] for t in walltype])
        faclGR = np.array([abs(typemap[int(t)][1] - 1.0) < 1e-5
                           for t in walltype])
        faca_p = case_dir / f"facetarea.inp.{expnr}"
        faca = (read_column_file(faca_p) if faca_p.exists()
                else np.ones(len(facz0)))
        tfac_p = case_dir / f"Tfacinit.inp.{expnr}"
        facT = (read_column_file(tfac_p) if tfac_p.exists()
                else np.full(len(facz0), cfg.bc.thls if cfg.bc.thls > 0
                             else 288.0))

        def load_sec(sfx):
            sec_p = case_dir / f"facet_sections_{sfx}.txt"
            if not sec_p.exists():
                z = np.zeros(0)
                return SecData(np.zeros((0, 3), np.int64), z, z,
                               np.zeros(0, np.int64), z.astype(bool),
                               z.astype(bool))
            bndpts = read_sparse_ijk(case_dir / f"fluid_boundary_{sfx}.txt")
            fac, area, bnd_id, dist = read_facet_sections(sec_p)
            for name, ids, n in (("boundary point", bnd_id, len(bndpts)),
                                 ("facet", fac, len(facz0))):
                if len(ids) and (ids.min() < 0 or ids.max() >= n):
                    raise ValueError(f"{sec_p.name}: {name} id outside "
                                     f"1..{n}")
            ijk = bndpts[bnd_id]
            # static skip logic (initibmwallfun:371-383 + wallfunmom:1364)
            skip = np.zeros(len(fac), bool)
            if SKIP_ALIGN[sfx] != 0:
                skip |= _alignment(facnorm[fac]) == SKIP_ALIGN[sfx]
            skip |= facz0[fac] < const.eps1
            with np.errstate(divide="ignore", invalid="ignore"):
                close = ~(np.log(np.maximum(dist, 1e-30)
                                 / facz0[fac]) > 1.0) & ~skip
            rec = np.zeros(len(fac), bool)
            interp = None
            if cfg.walls.lnorec or not close.any():
                skip |= close
            else:
                ok, recdist, interp = _reconstruction_data(
                    ijk, dist, facnorm[fac], facz0[fac], SKIP_ALIGN[sfx],
                    grid)
                rec = close & ok
                skip |= close & ~ok
                dist = np.where(rec, recdist, dist)
            return SecData(ijk=ijk, area=area, dist=dist, fac=fac,
                           active=~skip, rec=rec, interp=interp)

        sec = {k: load_sec(k) for k in GRIDS}
        return cls(cfg, grid, masks, sec, facnorm, facz0, facz0h, facT, faca,
                   faclGR=faclGR, device=device, mesh=mesh)

    def _prep_pmasks(self, masks: Masks):
        """Ghosted masks for the neighbour logic (udales_tpu ``_prep_pmasks``,
        ibm.py:577-591) from the domain's `masks`: periodic x/y; k ghosts
        bottom solid, top fluid (modibm.f90:156-159).  pmask_w has no bottom
        ghost: index k is face k, with one fluid ghost face above the top.
        On a block, its part with the one-cell ring, contiguous (the kernel
        takes no strided mask)."""
        def padm(m):
            mp = pad_periodic_xy(m, 1)
            return torch.cat([torch.zeros_like(mp[:, :, :1]), mp,
                              torch.ones_like(mp[:, :, :1])], dim=2)
        mw = pad_periodic_xy(masks.w, 1)
        cut = lambda m: self.grid.cut(m, ring=1).clone(
            memory_format=torch.contiguous_format)
        self.pmask_u = cut(padm(masks.u))
        self.pmask_v = cut(padm(masks.v))
        self.pmask_c = cut(padm(masks.c))
        self.pmask_w = cut(torch.cat([mw, torch.ones_like(mw[:, :, :1])],
                                     dim=2))

    def _sections(self, which: str, mask_c: np.ndarray) -> Sections | None:
        """Device section list of one grid (active sections only; on a
        block, those whose boundary point lies in it).  The stencils are
        built on the domain grid, so the mask values and the reconstruction
        corners are the domain's."""
        s = self.sec[which]
        act = s.active
        self.rows[which] = np.arange(int(act.sum()))
        if not act.any():
            return None
        dom, g, cfg = self.domain_grid, self.grid, self.cfg
        ijk = s.ijk[act]
        # gather points into the unghosted domain fields; rec sections take
        # the 8 trilinear corners of their reconstruction point (zero-weight
        # padding for the others)
        rec = s.rec[act]
        stencils = {}
        for name, (pts, wgt) in _interp_stencils(which, ijk, mask_c,
                                                 dom).items():
            if rec.any():
                cpts, cwgt = s.interp["c" if name == "t" else name]
                pts = np.concatenate([pts, np.repeat(pts[:, :1], 4, 1)], 1)
                wgt = np.concatenate([wgt, np.zeros_like(wgt)], 1)
                pts[rec], wgt[rec] = cpts[act][rec], cwgt[act][rec]
            stencils[name] = (pts, wgt)
        if self.mesh is not None:
            ijk, stencils, mine = _block_stencils(ijk, stencils, dom, g,
                                                  which)
            self.rows[which] = np.flatnonzero(mine)
            if not mine.any():
                return None
            act = act.copy()
            act[act] = mine
        nx, ny, nz = g.shape
        fid = s.fac[act]
        shape = (nx, ny, nz + 1) if which == "w" else (nx, ny, nz)
        flat = _flat_index(ijk, shape, f"facet_sections_{which}.txt")
        kw = dict(dtype=g.torch_dtype, device=self.device)
        f = lambda a: torch.as_tensor(np.asarray(a, np.float64), **kw)
        li = lambda a: torch.as_tensor(a, dtype=torch.int64,
                                       device=self.device)

        # gather tables into the ghosted fields: G[1+i, 1+j, 1+k] for the
        # cell fields, W[1+i, 1+j, k] for w
        tables = {}
        for name, (pts, wgt) in stencils.items():
            face = name == "w"
            gshape = (nx + 2, ny + 2, nz + 1 if face else nz + 2)
            idx = _flat_index(pts.reshape(-1, 3) + (1, 1, 0 if face else 1),
                              gshape, f"interpolation of {which} sections")
            tables[f"idx_{name}"] = li(idx.reshape(pts.shape[:2]))
            tables[f"wgt_{name}"] = f(wgt)
        z0 = np.maximum(self.facz0[fid], 1e-30)
        z0h = np.maximum(self.facz0h[fid], 1e-30)
        dist = s.dist[act]
        logdz = np.log(np.maximum(dist, 1e-30) / z0)
        if which == "c":
            coef = s.area[act] / (g.dx * g.dy * g.dzh[ijk[:, 2]])
        else:
            # cell volume at dzf of the cell; w sections use the face's
            # upper cell (wallfunmom:1411)
            kcell = np.minimum(ijk[:, 2], nz - 1)
            coef = s.area[act] / (g.dx * g.dy * g.dzf[kcell])
        norm = self.facnorm[fid]
        extra = {}
        if which == "c":
            b = cfg.bc
            # the reference assigns bctfxm to -y facets too (kept)
            extra["orient"] = li(_orientation(norm, (1, 0, 3, 0, 4, 5)))
            if cfg.physics.lmoist:
                extra["lGR"] = torch.as_tensor(self.faclGR[fid],
                                               device=self.device)
                extra["mflux"] = f(np.array(
                    [b.bcqfxp, b.bcqfxm, b.bcqfyp, b.bcqfym, b.bcqfz, 0.0])[
                        _orientation(norm, (0, 1, 2, 3, 4, 5))])
        return Sections(
            flat=li(flat), **tables,
            n0=f(norm[:, 0]), n1=f(norm[:, 1]), n2=f(norm[:, 2]),
            dist=f(dist), logdz=f(logdz), logzh=f(np.log(z0 / z0h)),
            sqdz=f(np.exp(0.5 * logdz)), tsurf=f(self.facT[fid]),
            ctm_neutral=f((const.fkar / logdz) ** 2), coef=f(coef),
            fid=li(fid), area=f(s.area[act]), **extra)

    # ------------------------------------------------------------------
    # Wall functions (ibmwallfun, modibm.f90:1167-1283)
    # ------------------------------------------------------------------
    def wallfun(self, g, du, dv, dw, dthl, dqt=None, fac=None, bctf=None,
                need_fac: bool = False, need_facstats: bool = False,
                pres=None):
        """Add the facet wall stresses (iwallmom 2: stability-corrected,
        3: neutral; 1: none), with ltempeq the facet heat fluxes (iwalltemp
        1: fixed per orientation, `bctf` when time-dependent; 2: wall
        function) and with lmoist the latent fluxes (iwallmoist 1: fixed;
        2: green roofs, from the facet state) to the tendencies.  `g` is the
        substep's Ghosts, `fac` the facet state of an energy-balance run.
        The diffusion corrections are folded into the sweeps (pmask_*), as
        udales_tpu does by default.

        The passive scalars need nothing here: their correction
        (udales_tpu ibm.py:726-729, taken only when the folding is off) is
        the pmask_c folded into their ``diff_c``, as for thl and qt.

        Returns (du, dv, dw, dthl, dqt, fachf, facef, hf_tot, ef_tot,
        fstats): the tendencies, the per-facet sensible and latent flux
        sums ((nfcts,), None unless `need_fac`), their domain totals (None
        unless `need_fac` or ``lperiodicEBcorr``) and the lwritefac
        diagnostics dict (None unless `need_facstats`; modibm.f90:
        1416-1430, 1475-1476, 1539-1540).  Without a facet state and
        without those outputs no per-facet or domain sum is formed.  On a
        block the sums are the domain's: this rank's sections' sums, added
        over the ranks in one all-reduce."""
        cfg = self.cfg
        facT = fac.T[:, 0] if fac is not None else None
        hf_tot = ef_tot = (self.faca_t.new_zeros(())
                           if need_fac or cfg.eb.lperiodicEBcorr else None)
        fachf = facef = None
        fstats = {} if need_facstats else None
        if cfg.walls.iwallmom > 1:
            du, tx = self._wallfunmom("u", g, du, facT, need_facstats)
            dv, ty = self._wallfunmom("v", g, dv, facT, need_facstats)
            dw, tz = self._wallfunmom("w", g, dw, facT, need_facstats)
            if need_facstats:
                fstats.update(tau_x=tx, tau_y=ty, tau_z=tz)
        if cfg.physics.ltempeq or cfg.physics.lmoist:
            (dthl, dqt, hf_tot, ef_tot, fachf, facef,
             hstats) = self._wallfunheat(g, dthl, dqt, fac, bctf, need_fac,
                                         need_facstats)
            if need_facstats:
                fstats.update(hstats)
        if need_facstats:
            # fac_pres / fac_pres2: pres0 at the c-section cells
            zf = torch.zeros_like(self.faca_t)
            sc = self.lists["c"]
            if sc is not None and pres is not None:
                pcell = pres.reshape(-1)[sc.flat]
                fstats["pres"] = self._facsum(sc, pcell)
                fstats["pres2"] = self._facsum(sc, pcell * pcell)
            for key in FACSTAT_FIELDS:
                fstats.setdefault(key, zf)
        sums = [fachf, facef, hf_tot, ef_tot] + (
            [fstats[k] for k in FACSTAT_FIELDS] if need_facstats else [])
        live = [v for v in sums if v is not None]
        if self.mesh is not None and live:
            summed = iter(self.mesh.allreduce_parts(live))
            sums = [None if v is None else next(summed) for v in sums]
        fachf, facef, hf_tot, ef_tot = sums[:4]
        if need_facstats:
            # the statistics are facet-area averages of the summed values
            fstats = {k: v / self.faca_t
                      for k, v in zip(FACSTAT_FIELDS, sums[4:])}
        return du, dv, dw, dthl, dqt, fachf, facef, hf_tot, ef_tot, fstats

    def _facsum(self, s: Sections, vals):
        """Per-facet area-weighted sum of per-section values."""
        return torch.zeros_like(self.faca_t).index_add(0, s.fid,
                                                       vals * s.area)

    @staticmethod
    def _interp(s: Sections, g):
        """Interpolated u, v, w and air temperature at the sections."""
        at = lambda G, idx, wgt: (G.reshape(-1)[idx] * wgt).sum(dim=1)
        return (at(g.u, s.idx_u, s.wgt_u), at(g.v, s.idx_v, s.wgt_v),
                at(g.w, s.idx_w, s.wgt_w), at(g.thl, s.idx_t, s.wgt_t))

    @staticmethod
    def _tangent(s: Sections, uu, vv, ww):
        """Streamwise unit vector and tangential speed (the cross products
        of wallfunmom, modibm.f90:1330-1350); `ok` where the velocity is
        not normal to the facet."""
        n0, n1, n2 = s.n0, s.n1, s.n2
        sx = n1 * ww - n2 * vv
        sy = n2 * uu - n0 * ww
        sz = n0 * vv - n1 * uu
        sn = torch.sqrt(sx * sx + sy * sy + sz * sz)
        ok = sn > const.eps1
        sni = 1.0 / torch.clamp(sn, min=const.eps1)
        sx, sy, sz = sx * sni, sy * sni, sz * sni
        tx = sy * n2 - sz * n1
        ty = sz * n0 - sx * n2
        tz = sx * n1 - sy * n0
        return (tx, ty, tz), tx * uu + ty * vv + tz * ww, ok

    def _wallfunmom(self, which, g, tend, facT=None, need_tau=False):
        """wallfunmom (modibm.f90:1286-1433) on one grid, added to `tend`.
        With `need_tau` also the per-facet area-weighted sums of the signed
        stress (fac_tau_x/y/z once `wallfun` divides them by the facet
        area), else None."""
        s = self.lists[which]
        if s is None:
            return tend, (torch.zeros_like(self.faca_t) if need_tau
                          else None)
        uu, vv, ww, Ta = self._interp(s, g)
        (tx, ty, tz), utan, ok = self._tangent(s, uu, vv, ww)
        if self.cfg.walls.iwallmom == 2:
            Ts = s.tsurf if facT is None else facT[s.fid]
            ctm = _mom_coef_stability(utan, s.dist, s.logdz, s.logzh, s.sqdz,
                                      Ta, Ts, self.cfg.walls.prandtlturb)
        else:
            ctm = s.ctm_neutral
        stress = ctm * utan * utan
        a, ua = {"u": (tx, uu), "v": (ty, vv), "w": (tz, ww)}[which]
        stress_dir = torch.where(ok, torch.sign(ua) * torch.abs(a * stress),
                                 0.0)
        tend = tend.reshape(-1).index_add(0, s.flat, -stress_dir * s.coef) \
            .view(tend.shape)
        tau = self._facsum(s, stress_dir) if need_tau else None
        return tend, tau

    def _wallfunheat(self, g, dthl, dqt, fac=None, bctf=None,
                     need_fac=False, need_stats=False):
        """wallfunheat (modibm.f90:1436-1606): the sensible heat flux at the
        c-sections added to `dthl` and, on moist walls, the latent flux
        added to `dqt`.  Returns (dthl, dqt, hf_tot, ef_tot, fachf, facef,
        stats) as `wallfun` documents them; stats holds the per-facet sums
        of htc and cth that `wallfun` divides by the facet area."""
        cfg = self.cfg
        need_tot = need_fac or cfg.eb.lperiodicEBcorr
        zt = self.faca_t.new_zeros(()) if need_tot else None
        nf0 = torch.zeros_like(self.faca_t) if need_fac else None
        stats = dict(htc=torch.zeros_like(self.faca_t),
                     cth=torch.zeros_like(self.faca_t)) if need_stats else None
        s = self.lists["c"]
        if s is None:
            return dthl, dqt, zt, zt, nf0, nf0, stats
        uu, vv, ww, Ta = self._interp(s, g)
        _, utan, ok = self._tangent(s, uu, vv, ww)
        hf_tot = ef_tot = zt
        fachf = facef = nf0
        htc = None
        scatter = lambda tend, fl: tend.reshape(-1).index_add(
            0, s.flat, -fl * s.coef).view(tend.shape)
        if cfg.physics.ltempeq:
            if cfg.walls.iwalltemp == 1:
                # fixed flux per orientation (modibm.f90:1519-1535), or its
                # time-interpolated values (modtimedep timedepsurf)
                b = cfg.bc
                vals = (torch.stack(list(bctf)).to(utan.dtype)
                        if bctf is not None else utan.new_tensor(
                            [b.bctfxm, b.bctfxp, b.bctfym, b.bctfyp,
                             b.bctfz]))
                flux = torch.cat([vals, vals.new_zeros(1)])[s.orient]
            else:
                Ts = s.tsurf if fac is None else fac.T[:, 0][s.fid]
                # htc feeds the statistics and the green-roof resistance
                cth, flux, htc = _heat_coef_flux(
                    utan, s.dist, s.logdz, s.logzh, s.sqdz, Ta, Ts,
                    cfg.walls.prandtlturb, with_htc=need_stats or (
                        cfg.physics.lmoist and cfg.walls.iwallmoist == 2
                        and fac is not None))
                if need_stats:
                    stats = dict(
                        htc=self._facsum(s, torch.where(ok, htc, 0.0)),
                        cth=self._facsum(s, torch.where(ok, cth, 0.0)))
            fl = torch.where(ok, flux, 0.0)
            dthl = scatter(dthl, fl)
            if need_tot:
                hf_tot = torch.sum(fl * s.area)
            if need_fac:
                fachf = self._facsum(s, fl)
        # latent heat on green-roof facets (modibm.f90:1555-1589)
        mfl = None
        if cfg.physics.lmoist and cfg.walls.iwallmoist == 1:
            mfl = torch.where(ok & s.lGR, s.mflux, 0.0)
        elif (cfg.physics.lmoist and cfg.walls.iwallmoist == 2
              and fac is not None):
            exch = (htc * torch.abs(utan) if htc is not None
                    else torch.zeros_like(utan))
            qtair = (g.qt.reshape(-1)[s.idx_t] * s.wgt_t).sum(dim=1)
            qwall, hurel = fac.qsat[s.fid], fac.hurel[s.fid]
            resa = 1.0 / torch.clamp(exch, min=1e-10)
            resc, ress = fac.f[:, 3][s.fid], fac.f[:, 4][s.fid]
            cveg = 0.8
            mflux = torch.clamp(
                cveg * (qtair - qwall) / (resa + resc)
                + (1.0 - cveg) * (qtair - qwall * hurel) / (resa + ress),
                max=0.0)
            mfl = torch.where(ok & s.lGR & (exch > 0.0), mflux, 0.0)
        if mfl is not None:
            dqt = scatter(dqt, mfl)
            if need_tot:
                ef_tot = torch.sum(mfl * s.area)
            if need_fac:
                facef = self._facsum(s, mfl)
        return dthl, dqt, hf_tot, ef_tot, fachf, facef, stats

    # ------------------------------------------------------------------
    # ibmnorm: zero solid velocities, fill solid scalar cells
    # ------------------------------------------------------------------
    def ibmnorm(self, c, m, du, dv, dw, dthl, thl_vmean, dqt=None,
                dsv=None):
        """ibmnorm (modibm.f90:697-745): zero the solid velocities and
        their tendencies, fill solid thl, qt and passive-scalar cells (value
        and tendency; all scalars in one pass) and add the cd2 scalar
        advection correction to thl and qt.  Returns the tendencies (du,
        dv, dw, dthl, dqt, dsv) and the masked `m` fields.  It is
        `ibmnorm_uvw_thl`, `ibmnorm_finish` and then `fill_scalars`."""
        du, dv, dw, dthl, dqt, m_new = self.ibmnorm_finish(
            c, m, *self.ibmnorm_uvw_thl(c, m, du, dv, dw, dthl, thl_vmean),
            dqt)
        m_new, dsv = self.fill_scalars(m_new, dsv)
        return du, dv, dw, dthl, dqt, dsv, m_new

    def ibmnorm_uvw_thl(self, c, m, du, dv, dw, dthl, thl_vmean):
        """The part of `ibmnorm` that ``ops/fused_ibmnorm.py``'s kernel
        does in one pass on the card: the masked velocities and their
        tendencies and, with ltempeq, the solid fill of thl (value and
        tendency) and the liberal cd2 correction where the case takes it.
        Returns (du, dv, dw, dthl, m.u, m.v, m.w, m.thl), the last four
        new."""
        cfg, M = self.cfg, self.masks
        du, dv, dw = du * M.u, dv * M.v, dw * M.w
        mu, mv, mw, mthl = m.u * M.u, m.v * M.v, m.w * M.w, m.thl
        if cfg.physics.ltempeq:
            mthl, dthl = self.solid_fill(m.thl, dthl, thl_vmean)
            if cfg.iadv_thl == IADV_CD2 and not cfg.physics.lconservativeibm:
                dthl = dthl + self.advecc2nd_corr_liberal(c.thl, c)
        return du, dv, dw, dthl, mu, mv, mw, mthl

    def ibmnorm_finish(self, c, m, du, dv, dw, dthl, mu, mv, mw, mthl,
                       dqt=None):
        """The part of `ibmnorm` after `ibmnorm_uvw_thl`, whose outputs it
        takes, and before `fill_scalars`: the conservative cd2 correction of
        thl, and qt.  Returns (du, dv, dw, dthl, dqt, the masked `m`)."""
        cfg = self.cfg
        m_new = replace(m, u=mu, v=mv, w=mw, thl=mthl)
        corr = (self.advecc2nd_corr_conservative
                if cfg.physics.lconservativeibm
                else self.advecc2nd_corr_liberal)
        if (cfg.physics.ltempeq and cfg.iadv_thl == IADV_CD2
                and cfg.physics.lconservativeibm):
            dthl = dthl + corr(c.thl, c)
        if cfg.physics.lmoist:
            qtm, dqt = self.solid_fill(m.qt, dqt, 0.0)
            m_new = replace(m_new, qt=qtm)
            dqt = dqt + corr(c.qt, c)
        return du, dv, dw, dthl, dqt, m_new

    def fill_scalars(self, m, dsv):
        """The last part of `ibmnorm`: the solid fill of the passive
        scalars, value and tendency, all of them in one pass (the substep
        runs it in its ``canopy`` leaf).  Returns (`m` with the filled
        ``sv``, the filled `dsv`); without scalars both as given."""
        if dsv is None or dsv.shape[0] == 0:
            return m, dsv
        svm, dsv = self.solid_fill(m.sv, dsv, 0.0)
        return replace(m, sv=svm), dsv

    def solid_fill(self, var, rhs, val):
        """`solid` (modibm.f90:748-826): solid cells take the average of
        their fluid neighbours (value and tendency), or `val` (tendency 0)
        when enclosed (udales_tpu ``_solid_fill_full``, ibm.py:1518).
        `var` and `rhs` may carry a leading stack axis; both are padded in
        one halo exchange."""
        Mp = self.pmask_c
        s = _shifts(var.shape)
        pv, pr = _pad_scalar(torch.stack([var, rhs]), self.mesh).unbind(0)

        def navg(fp):
            tot = (s(fp, 1, 0, 0) * s(Mp, 1, 0, 0)
                   + s(fp, -1, 0, 0) * s(Mp, -1, 0, 0)
                   + s(fp, 0, 1, 0) * s(Mp, 0, 1, 0)
                   + s(fp, 0, -1, 0) * s(Mp, 0, -1, 0)
                   + s(fp, 0, 0, 1) * s(Mp, 0, 0, 1)
                   + s(fp, 0, 0, -1) * s(Mp, 0, 0, -1))
            cnt = (s(Mp, 1, 0, 0) + s(Mp, -1, 0, 0) + s(Mp, 0, 1, 0)
                   + s(Mp, 0, -1, 0) + s(Mp, 0, 0, 1) + s(Mp, 0, 0, -1))
            return tot, cnt

        tot_v, cnt = navg(pv)
        tot_r, _ = navg(pr)
        has = cnt > 0
        den = torch.clamp(cnt, min=1.0)
        fill_v = torch.where(has, tot_v / den, val)
        fill_r = torch.where(has, tot_r / den, 0.0)
        fluid = self.masks.c > 0.5
        return (torch.where(fluid, var, fill_v),
                torch.where(fluid, rhs, fill_r))

    def _advec_ctx(self, var, c):
        """Shared pieces of the cd2 corrections: the padded scalar, face
        velocities and z metrics."""
        grid = self.grid
        nz = grid.ktot
        dev = var.device
        up = pad_periodic_xy(c.u, 1, self.mesh)
        vp = pad_periodic_xy(c.v, 1, self.mesh)
        kv = lambda name, lo: grid.t(name, dev)[lo: lo + nz][None, None, :]
        return dict(
            vp=_pad_scalar(var, self.mesh), u_ip=up[2:, 1:-1, :],
            u_i=up[1:-1, 1:-1, :],
            v_jp=vp[1:-1, 2:, :], v_j=vp[1:-1, 1:-1, :],
            w_t=c.w[:, :, 1:], w_b=c.w[:, :, :nz],
            dzf_k=kv("dzf_g", 1), dzf_kp=kv("dzf_g", 2),
            dzf_km=kv("dzf_g", 0), dzhi_k=kv("dzhi", 0),
            dzhi_kp=kv("dzhi", 1), dzfi5=kv("dzfi5", 0))

    def advecc2nd_corr_liberal(self, var, c):
        """advecc2nd_corr_liberal (modibm.f90:936-987): the cd2 flux through
        a face with a solid neighbour becomes the zero-flux variant
        (var_solid := var_here); fluid cells only (udales_tpu
        ``_advecc2nd_corr_liberal_full``, ibm.py:1733)."""
        grid = self.grid
        x = self._advec_ctx(var, c)
        s = _shifts(var.shape)
        vp, vc = x["vp"], var
        sol = lambda di, dj, dk: 1.0 - s(self.pmask_c, di, dj, dk)
        corr = (
            sol(1, 0, 0) * x["u_ip"] * ((s(vp, 1, 0, 0) + vc) - (vc + vc))
            * grid.dxi5
            - sol(-1, 0, 0) * x["u_i"] * ((s(vp, -1, 0, 0) + vc) - (vc + vc))
            * grid.dxi5
            + sol(0, 1, 0) * x["v_jp"] * ((s(vp, 0, 1, 0) + vc) - (vc + vc))
            * grid.dyi5
            - sol(0, -1, 0) * x["v_j"] * ((s(vp, 0, -1, 0) + vc) - (vc + vc))
            * grid.dyi5
            + sol(0, 0, 1) * x["w_t"]
            * ((s(vp, 0, 0, 1) * x["dzf_k"] + vc * x["dzf_kp"])
               - (vc * x["dzf_k"] + vc * x["dzf_kp"]))
            * x["dzhi_kp"] * x["dzfi5"]
            - sol(0, 0, -1) * x["w_b"]
            * ((s(vp, 0, 0, -1) * x["dzf_k"] + vc * x["dzf_km"])
               - (vc * x["dzf_k"] + vc * x["dzf_km"]))
            * x["dzhi_k"] * x["dzfi5"])
        return corr * self.masks.c

    def advecc2nd_corr_conservative(self, var, c):
        """advecc2nd_corr_conservative (modibm.f90:889-933): remove the cd2
        flux through any face whose face velocity or neighbour cell is solid
        (udales_tpu ``_advecc2nd_corr_conservative_full``, ibm.py:1680)."""
        grid = self.grid
        nz = grid.ktot
        x = self._advec_ctx(var, c)
        s = _shifts(var.shape)
        vp, vc = x["vp"], var
        Mc, Mu, Mv, Mw = (self.pmask_c, self.pmask_u, self.pmask_v,
                          self.pmask_w)
        blk_e = 1.0 - s(Mu, 1, 0, 0) * s(Mc, 1, 0, 0)
        blk_w = 1.0 - s(Mu, 0, 0, 0) * s(Mc, -1, 0, 0)
        blk_n = 1.0 - s(Mv, 0, 1, 0) * s(Mc, 0, 1, 0)
        blk_s = 1.0 - s(Mv, 0, 0, 0) * s(Mc, 0, -1, 0)
        blk_t = 1.0 - Mw[1:-1, 1:-1, 1:nz + 1] * s(Mc, 0, 0, 1)
        blk_b = 1.0 - Mw[1:-1, 1:-1, :nz] * s(Mc, 0, 0, -1)
        corr = (
            blk_e * x["u_ip"] * (s(vp, 1, 0, 0) + vc) * grid.dxi5
            - blk_w * x["u_i"] * (s(vp, -1, 0, 0) + vc) * grid.dxi5
            + blk_n * x["v_jp"] * (s(vp, 0, 1, 0) + vc) * grid.dyi5
            - blk_s * x["v_j"] * (s(vp, 0, -1, 0) + vc) * grid.dyi5
            + blk_t * x["w_t"]
            * (s(vp, 0, 0, 1) * x["dzf_k"] + vc * x["dzf_kp"])
            * x["dzhi_kp"] * x["dzfi5"]
            - blk_b * x["w_b"]
            * (s(vp, 0, 0, -1) * x["dzf_k"] + vc * x["dzf_km"])
            * x["dzhi_k"] * x["dzfi5"])
        return corr * self.masks.c


def _shifts(shape):
    """s(a, di, dj, dk): the (di, dj, dk) neighbour view of a field padded
    by one cell on every side (the last three axes of `shape`; leading
    axes ride along)."""
    nx, ny, nz = shape[-3:]
    return lambda a, di, dj, dk: a[..., 1 + di: 1 + di + nx,
                                   1 + dj: 1 + dj + ny, 1 + dk: 1 + dk + nz]


def _pad_scalar(f, mesh=None):
    """Periodic x/y halo (from the neighbouring ranks of `mesh`) and
    zero-gradient k ghosts of a cell field (or of a stack of them along a
    leading axis)."""
    fx = (mesh.wrap_xy(f, 1) if mesh is not None
          else pad_wrap(pad_wrap(f, -3, 1), -2, 1))
    return pad_edge(fx, -1, 1)


# ---------------------------------------------------------------------------
# Per-section transfer coefficients (modibm.f90:1855-1985; udales_tpu
# ibm.py:1785-1850).  The stability functions Fm, Fh are the floor's
# (ibm/wallfn.py); the facet path takes Ribl0 = g d dT / (Ts utan^2).
# ---------------------------------------------------------------------------

def _ribl0(utan, dist, Tair, Tsurf):
    """Bulk Richardson number of the facet layer (modibm.f90:1866)."""
    dT = Tair - Tsurf
    utan2 = torch.clamp(utan ** 2, min=UMIN)
    return const.grav * dist * dT / (Tsurf * utan2)


def _mom_coef_stability(utan, dist, logdz, logzh, sqdz, Tair, Tsurf,
                        prandtlturb=const.prandtlmol):
    """mom_transfer_coef_stability (modibm.f90:1855-1903) with the static
    log/sqrt terms precomputed (udales_tpu ``_mom_coef_stability_pre``)."""
    fkar2 = const.fkar ** 2
    Ribl0 = _ribl0(utan, dist, Tair, Tsurf)
    Fm, Fh = _stability_fm_fh(Ribl0, logdz, sqdz, fkar2)
    M = prandtlturb * logdz * torch.sqrt(Fm) / Fh
    Ribl1 = Ribl0 - Ribl0 * prandtlturb * logzh / (prandtlturb * logzh + M)
    Fm1, _ = _stability_fm_fh(Ribl1, logdz, sqdz, fkar2)
    return fkar2 / (logdz ** 2) * Fm1


def _heat_coef_flux(utan, dist, logdz, logzh, sqdz, Tair, Tsurf,
                    prandtlturb=const.prandtlmol, with_htc=True):
    """heat_transfer_coef_flux (modibm.f90:1919-1985): (cth, flux, htc), the
    kinematic heat flux being |utan| cth dT_rough and htc = flux / (|utan|
    dT), 0 where that denominator is (udales_tpu ``_heat_coef_flux_pre``);
    htc is None unless `with_htc`."""
    fkar2 = const.fkar ** 2
    dT = Tair - Tsurf
    Ribl0 = _ribl0(utan, dist, Tair, Tsurf)
    Fm, Fh = _stability_fm_fh(Ribl0, logdz, sqdz, fkar2)
    M = prandtlturb * logdz * torch.sqrt(Fm) / Fh
    Ribl1 = Ribl0 - Ribl0 * prandtlturb * logzh / (prandtlturb * logzh + M)
    Fm1, Fh1 = _stability_fm_fh(Ribl1, logdz, sqdz, fkar2)
    M1 = prandtlturb * logdz * torch.sqrt(Fm1) / Fh1
    dTrough = dT / (prandtlturb * logzh / M1 + 1.0)
    cth = fkar2 / (logdz ** 2) * Fh1 / prandtlturb
    flux = torch.abs(utan) * cth * dTrough
    if not with_htc:
        return cth, flux, None
    denom = torch.abs(utan) * dT
    nz = torch.abs(denom) > 0
    htc = torch.where(nz, flux / torch.where(nz, denom, 1.0), 0.0)
    return cth, flux, htc


def _orientation(norm: np.ndarray, codes) -> np.ndarray:
    """Per-section code by facet orientation: `codes` = (+x, -x, +y, -y, +z,
    other), the order of the reference's where-chains (modibm.f90:1519-1535,
    1556-1568)."""
    e = const.eps1
    n0, n1, n2 = norm[:, 0], norm[:, 1], norm[:, 2]
    return np.where(np.abs(n0 - 1) < e, codes[0],
           np.where(np.abs(n0 + 1) < e, codes[1],
           np.where(np.abs(n1 - 1) < e, codes[2],
           np.where(np.abs(n1 + 1) < e, codes[3],
           np.where(np.abs(n2 - 1) < e, codes[4], codes[5])))))
