"""Vegetation preprocessing (the port's own copy of
``udales_tpu/prep/vegetation.py``; NumPy only): trees.inp blocks or tree
STL volumes -> sparse vegetation input files (veg.inp / veg_params.inp /
sveg.inp).

Replaces tools/python/udprep/udprep_vegetation.py: `load_block` expands
legacy trees.inp index boxes into per-cell point lists with uniform canopy
parameters (udprep_vegetation.py:99-186), `load_stl` voxelizes a closed
tree-crown STL onto the solver grid, and `compute_sveg` estimates the
absorbed shortwave density per vegetation cell with the same Beer-Lambert
ray march as prep.radiation.direct_shortwave_veg.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class VegParams:
    """Uniform canopy properties (&TREES namelist defaults)."""
    lad: float = 1.0       # leaf area density [m2/m3]
    cd: float = 0.3        # drag coefficient
    ud: float = 2e-4       # deposition velocity [m/s]
    dec: float = 0.3       # shortwave extinction coefficient
    lsize: float = 0.15    # leaf size [m]
    r_s: float = 50.0      # stomatal resistance [s/m]


def trees_to_veg(tree_file: str | Path, itot: int, jtot: int, ktot: int):
    """Expand trees.inp blocks (1-based inclusive il iu jl ju kl ku, with
    an optional leading tree id) to sparse 1-based (i,j,k) points + block
    ids (udprep_vegetation.load_block:99)."""
    points, ids = [], []
    next_id = 1
    for line in Path(tree_file).read_text().splitlines():
        tok = line.strip()
        if not tok or tok.startswith("#"):
            continue
        vals = [int(v) for v in tok.split()]
        if len(vals) == 7:
            vals = vals[1:]
        if len(vals) != 6:
            raise ValueError(f"expected 6 or 7 integers: {line!r}")
        il, iu, jl, ju, kl, ku = vals
        il, iu = sorted((il, iu))
        jl, ju = sorted((jl, ju))
        kl, ku = sorted((kl, ku))
        if il < 1 or iu > itot or jl < 1 or ju > jtot or kl < 1 or ku > ktot:
            raise ValueError(f"tree block {vals} outside the grid")
        ii, jj, kk = np.meshgrid(np.arange(il, iu + 1),
                                 np.arange(jl, ju + 1),
                                 np.arange(kl, ku + 1), indexing="ij")
        pts = np.stack([ii.ravel(), jj.ravel(), kk.ravel()], axis=1)
        points.append(pts)
        ids.append(np.full(len(pts), next_id))
        next_id += 1
    if not points:
        raise ValueError(f"no tree entries in {tree_file}")
    return np.concatenate(points), np.concatenate(ids)


def stl_to_veg(stl_path: str | Path, grid, id0: int = 1):
    """Cell centres inside a closed crown STL -> 1-based points
    (udprep_vegetation.load_stl voxelization)."""
    from .geom import points_inside
    from .stl import read_stl
    tris, _ = read_stl(stl_path)
    lo = tris.reshape(-1, 3).min(axis=0)
    hi = tris.reshape(-1, 3).max(axis=0)
    xs = np.asarray(grid.xf)
    ys = np.asarray(grid.yf)
    zs = np.asarray(grid.zf)
    isel = np.flatnonzero((xs > lo[0] - grid.dx) & (xs < hi[0] + grid.dx))
    jsel = np.flatnonzero((ys > lo[1] - grid.dy) & (ys < hi[1] + grid.dy))
    ksel = np.flatnonzero((zs > lo[2] - 1.0) & (zs < hi[2] + 1.0))
    ii, jj, kk = np.meshgrid(isel, jsel, ksel, indexing="ij")
    cand = np.stack([xs[ii.ravel()], ys[jj.ravel()], zs[kk.ravel()]],
                    axis=1)
    inside = points_inside(cand, tris, on_surface_tol=0.0)
    idx = np.stack([ii.ravel(), jj.ravel(), kk.ravel()], axis=1)[inside]
    return idx + 1, np.full(inside.sum(), id0)


def compute_sveg(points1, lad_ext_grid, spacing, sun_dir, I_dir: float,
                 step: float | None = None, periodic_xy: bool = True):
    """Absorbed shortwave density per vegetation cell [W/m3]:
    I_in(cell) * lad * dec with I_in the Beer-Lambert-attenuated direct
    beam at the cell centre (optically-thin per-cell absorption; the
    reference's ray-deposited veg absorption,
    udprep/directshortwave.py:465-474).

    NOTE: the committed tests/cases/525/sveg.inp values are NOT reproduced
    by any direct-beam configuration of the committed inputs (they sit two
    orders of magnitude below I*k at every candidate sun position), so no
    parity is claimed for that fixture — its provenance is presumably a
    canopy-EB (Qstar) pathway."""
    dx, dy, dz = spacing
    ni, nj, nk = lad_ext_grid.shape
    sun_dir = np.asarray(sun_dir, float)
    if step is None:
        step = min(dx, dy, dz) / 2.0
    cen = (np.asarray(points1, float) - 0.5) * np.array([dx, dy, dz])
    up = max(sun_dir[2], 1e-6)
    nsmp = int(np.ceil((nk * dz / up) / step)) + 1
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
        ext = np.where(valid, lad_ext_grid[i, j, np.clip(k, 0, nk - 1)],
                       0.0)
        tau[c0:c0 + 4096] = ext.sum(axis=1) * step
    k_cell = lad_ext_grid[points1[:, 0] - 1, points1[:, 1] - 1,
                          points1[:, 2] - 1]
    return I_dir * np.exp(-tau) * k_cell


def write_veg_files(outdir: str | Path, expnr: str, points1, ids,
                    params: VegParams, sveg=None):
    """Write veg.inp / veg_params.inp (/ sveg.inp) in the reference
    formats (readinput.read_sparse_ijk + vegetation.init_vegetation)."""
    outdir = Path(outdir)
    with open(outdir / f"veg.inp.{expnr}", "w") as f:
        f.write("# position (i,j,k)\n")
        for i, j, k in points1:
            f.write(f"{i:7d} {j:7d} {k:7d}\n")
    with open(outdir / f"veg_params.inp.{expnr}", "w") as f:
        f.write("# id lad cd ud dec lsize r_s\n")
        for bid in ids:
            f.write(f"{bid:7d} {params.lad:12.6f} {params.cd:12.6f} "
                    f"{params.ud:12.6f} {params.dec:12.6f} "
                    f"{params.lsize:12.6f} {params.r_s:12.6f}\n")
    if sveg is not None:
        with open(outdir / f"sveg.inp.{expnr}", "w") as f:
            f.write("# vegetation absorption on vegetation cells [W/m3]\n")
            for v in sveg:
                f.write(f"{v:.4f}\n")
    return len(points1)
