"""Long-tail physics (port of ``udales_tpu.physics``): chemistry, scalar
sources, purifiers, heat pumps, vegetation.

Re-derivations of src/modchem.f90, src/modscalsource.f90,
src/modpurifiers.f90, src/heatpump.f90 and src/vegetation.f90.  The
reference's sparse point loops become dense fields built once on the host
at load (scalar sources, vegetation drag coefficients at the faces) or
small box and point updates whose geometry is Python ints and index tensors
made at load, so that a step makes no host synchronisation:

  - `chem_update` takes `dt` as the State's 0-d device tensor;
  - the purifier loop runs over Python ints only;
  - the heat pumps' index and value tensors live on the device; their
    scatter into ``dthl`` sums duplicate points (``index_put_`` with
    ``accumulate=True``, as JAX's ``.at[].add``).

Under an x/y process split (``parallel.mesh``) each is built on the domain
grid as on one device and then cut to the rank's block (``block(grid)``
with the block grid of ``Grid.block``): the source field and the
vegetation arrays like fields, the heat pumps to their points in the
block, the purifier boxes clipped to it.  The vegetation's periodic
neighbours come from the mesh's halo exchange, and a purifier's intake
plane, which may lie on another rank, from one all-reduce of every box's
intake.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np
import torch

from .config import Config, const
from .grid import Grid
from .io.inputs import read_sparse_ijk
from .ops.halo import pad_periodic_xy

# molar masses of the NO-NO2-O3 null cycle (modchem.f90)
M_NO, M_NO2, M_O3 = 30.006, 46.005, 47.997


def chem_update(sv, dt, cfg: Config, IIc):
    """Fully implicit backward-Euler NO-NO2-O3 null cycle applied once per
    full step (modchem.f90:29-77).  `sv` is (nsv >= 3, nx, ny, nz), `dt` a
    number or a 0-d tensor, `IIc` the fluid mask (or ones).  Returns a new
    tensor; scalars past the third pass through.

    The molar change `d` is added in mass units, ``sv + M d``: the same
    update as modchem's ``M (sv / M + d)``, which rounds sv three times a
    step, and on the card divides by M as a multiply by its rounded
    reciprocal, an error of one sign at every point; ``sv + M d`` rounds
    the sum once."""
    k1 = cfg.chem.k1
    JNO2 = cfg.chem.JNO2
    no = IIc * sv[0] / M_NO
    no2 = IIc * sv[1] / M_NO2
    o3 = IIc * sv[2] / M_O3
    num = dt * (-k1 * no * o3 + JNO2 * no2)
    den = 1.0 + ((no + o3) * k1 + JNO2) * dt
    d = num / den
    return torch.cat([(sv[0] + M_NO * d)[None],
                      (sv[1] - M_NO2 * d)[None],
                      (sv[2] + M_O3 * d)[None], sv[3:]])


# ---------------------------------------------------------------------------
# Scalar sources (Gaussian point / line plumes)
# ---------------------------------------------------------------------------

class ScalarSources:
    """Dense source fields (modscalsource.f90:385-484): the tendency is
    constant in time, so it is evaluated once on the host and kept as one
    (nsv, nx, ny, nz) device tensor."""

    def __init__(self, field):
        self.field = field  # (nsv, nx, ny, nz)

    @staticmethod
    def build_numpy(cfg: Config, grid: Grid, points=None, lines=None):
        """The source field in float64 NumPy.  points: per scalar a (nsrc,
        5) array of rows [xS yS zS SS sigS]; lines: per scalar (nsrc, 8)
        rows [xSb ySb zSb xSe ySe zSe SS sigS]."""
        nx, ny, nz = grid.shape
        nsv = cfg.scalars.nsv
        X = grid.xf[:, None, None]
        Y = grid.yf[None, :, None]
        Z = grid.zf[None, None, :]
        dzfi = grid.dzfi[None, None, :]
        out = np.zeros((nsv, nx, ny, nz))
        fac = grid.dxi * grid.dyi * dzfi
        if points is not None:
            for n in range(nsv):
                for (xS, yS, zS, SS, sigS) in points[n]:
                    ra2 = (X - xS) ** 2 + (Y - yS) ** 2 + (Z - zS) ** 2
                    src = np.where(ra2 <= 9 * sigS ** 2,
                                   SS * np.exp(-ra2 / (2 * sigS ** 2)), 0.0)
                    out[n] += fac * src
        if lines is not None:
            from scipy.special import erf
            for n in range(nsv):
                for (xb, yb, zb, xe, ye, ze, SS, sigS) in lines[n]:
                    lx, ly, lz = xe - xb, ye - yb, ze - zb
                    L2 = lx * lx + ly * ly + lz * lz
                    t = ((X - xb) * lx + (Y - yb) * ly + (Z - zb) * lz) / L2
                    tc = np.clip(t, 0.0, 1.0)
                    ra2 = ((X - (xb + tc * lx)) ** 2
                           + (Y - (yb + tc * ly)) ** 2
                           + (Z - (zb + tc * lz)) ** 2)
                    inside = ra2 <= 9 * sigS ** 2
                    amp = (np.sqrt(2 * np.pi) * SS * sigS
                           * np.exp(-ra2 / (2 * sigS ** 2))
                           * erf(np.sqrt(np.maximum(
                               9 * sigS ** 2 - ra2, 0.0)
                               / (2 * sigS ** 2))))
                    out[n] += fac * np.where(inside, amp, 0.0)
        return out

    @classmethod
    def build(cls, cfg: Config, grid: Grid, points=None, lines=None,
              device="cpu"):
        """`build_numpy`, in the solver dtype on `device`."""
        return cls(torch.as_tensor(
            cls.build_numpy(cfg, grid, points, lines).astype(grid.dtype),
            device=device))

    @staticmethod
    def read(case_dir, expnr: str, cfg: Config):
        """(points, lines) of a case: ``scalarsourcep.inp.<n>.<expnr>`` and
        ``scalarsourcel.inp.<n>.<expnr>``, one file per scalar, each read
        when its switch is on and its count is positive."""
        case_dir = Path(case_dir)
        nsv = cfg.scalars.nsv
        pts = lns = None
        if cfg.scalars.lscasrc and cfg.scalars.nscasrc > 0:
            pts = [np.loadtxt(case_dir / f"scalarsourcep.inp.{n+1}.{expnr}",
                              skiprows=2, ndmin=2) for n in range(nsv)]
        if cfg.scalars.lscasrcl and cfg.scalars.nscasrcl > 0:
            lns = [np.loadtxt(case_dir / f"scalarsourcel.inp.{n+1}.{expnr}",
                              skiprows=2, ndmin=2) for n in range(nsv)]
        return pts, lns

    @classmethod
    def load(cls, case_dir, expnr: str, cfg: Config, grid: Grid,
             device="cpu"):
        pts, lns = cls.read(case_dir, expnr, cfg)
        return cls.build(cfg, grid, pts, lns, device=device)

    def block(self, grid: Grid) -> "ScalarSources":
        """The sources of the block of `grid` (``Grid.block``)."""
        return ScalarSources(grid.cut(self.field).clone(
            memory_format=torch.contiguous_format))


# ---------------------------------------------------------------------------
# Purifiers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Purifier:
    """One box purifier (modpurifiers.f90): 0-based inclusive cell bounds and
    flow direction code ipu (1..6: +-x, +-y, +-z)."""
    il: int
    iu: int
    jl: int
    ju: int
    kl: int
    ku: int
    ipu: int


# scrubbing efficiencies per scalar: epu for the first, then the values the
# reference hard-codes (modpurifiers.f90; udales_tpu physics.py:190)
_EFFS_AFTER_FIRST = [0.7, 0.0, 0.65]


class Purifiers:
    """The purifier boxes of a case on the domain `grid`; ``block(grid)``
    the same boxes applied to one rank's block."""

    def __init__(self, cfg: Config, grid: Grid, purifs):
        self.cfg = cfg
        self.grid = grid
        self.purifs = list(purifs)
        self.blk = None     # the block grid under an x/y split

    def block(self, grid: Grid) -> "Purifiers":
        """These purifiers on the block of `grid` (``Grid.block``); their
        geometry stays the domain's."""
        p = copy.copy(self)
        p.blk = grid
        return p

    def _clip(self, box):
        """(the block's part of the domain slices `box` (x, y, z) in block
        indices, the offsets of that part in the box along x and y), or
        None when the box misses the block; on the whole domain the box
        itself."""
        g = self.blk
        if g is None:
            return box, (0, 0)
        out, off = [], []
        for s, b0, bn, n in ((box[0], g.i0, g.itot, self.grid.itot),
                             (box[1], g.j0, g.jtot, self.grid.jtot)):
            lo, hi, _ = s.indices(n)
            a, b = max(lo, b0), min(hi, b0 + bn)
            if a >= b:
                return None
            out.append(slice(a - b0, b - b0))
            off.append(a - lo)
        return (out[0], out[1], box[2]), tuple(off)

    def _intake_slabs(self, sv):
        """The intake slab (nsv, ...) of every box.  On a block each rank
        fills the part it holds and one all-reduce sums them, so every rank
        has the whole slab of every box."""
        intakes = [self.geometry(p)[4] for p in self.purifs]
        if self.blk is None:
            return [sv[(slice(None),) + s] for s in intakes]
        dom = self.grid.shape
        bufs = []
        for s in intakes:
            buf = sv.new_zeros((sv.shape[0], *(
                len(range(*a.indices(n))) for a, n in zip(s, dom))))
            part = self._clip(s)
            if part is not None:
                (lx, ly, lz), (ox, oy) = part
                buf[:, ox: ox + lx.stop - lx.start,
                    oy: oy + ly.stop - ly.start] = sv[:, lx, ly, lz]
            bufs.append(buf)
        return self.blk.mesh.allreduce_parts(bufs)

    @staticmethod
    def read(case_dir, expnr: str):
        """The boxes of ``purifs.inp.<expnr>`` (1-based il iu jl ju kl ku
        ipu rows after two header lines)."""
        d = np.loadtxt(Path(case_dir) / f"purifs.inp.{expnr}", skiprows=2,
                       ndmin=2).astype(int)
        return [Purifier(*(int(v) - 1 for v in r[:6]), int(r[6])) for r in d]

    @classmethod
    def load(cls, case_dir, expnr, cfg, grid):
        return cls(cfg, grid, cls.read(case_dir, expnr))

    def geometry(self, p: Purifier):
        """(Apu, dpu, vel, face slices, intake slices, axis) of a box: the
        flow area, the box depth along the flow, the enforced velocity, the
        index slices of the velocity faces it sets and the scalar slab it
        draws from (modpurifiers.f90:63-268, cases 1-6)."""
        g = self.grid
        Qpu = self.cfg.purifs.Qpu
        niy = p.ju - p.jl + 1
        hz = g.zh[p.ku + 1] - g.zh[p.kl]
        wx = g.xh[p.iu + 1] - g.xh[p.il]
        box = (slice(p.il, p.iu + 1), slice(p.jl, p.ju + 1),
               slice(p.kl, p.ku + 1))
        if p.ipu in (1, 2):
            Apu, dpu, axis = niy * g.dy * hz, wx, 0
            sgn = 1 if p.ipu == 1 else -1
            inlet = p.il - 1 if p.ipu == 1 else min(p.iu + 1, g.itot - 1)
        elif p.ipu in (3, 4):
            Apu, dpu, axis = wx * hz, niy * g.dy, 1
            sgn = 1 if p.ipu == 3 else -1
            inlet = p.jl - 1 if p.ipu == 3 else min(p.ju + 1, g.jtot - 1)
        else:
            Apu, dpu, axis = niy * g.dy * wx, hz, 2
            sgn = 1 if p.ipu == 5 else -1
            inlet = p.kl - 1 if p.ipu == 5 else min(p.ku + 1, g.ktot - 1)
        faces = list(box)
        faces[axis] = slice(box[axis].start, box[axis].stop + 1)
        intake = list(box)
        # a negative intake index wraps, as the reference's does
        intake[axis] = slice(inlet, inlet + 1) if inlet >= 0 else \
            slice(inlet, inlet + 1 or None)
        return Apu, dpu, Qpu / Apu * sgn, tuple(faces), tuple(intake), axis

    def apply(self, m, c, du, dv, dw, dsv):
        """Enforce the purifier flow rates on the `m` and `c` velocities
        (their tendencies zeroed, so the integration keeps them) and scrub
        the scalars drawn in at the intake (modpurifiers.f90:63-268).
        Called between the projection and the integrate step.  Returns new
        (m, c, du, dv, dw, dsv); the arguments are not modified.  On a
        block each box is clipped to it."""
        if not self.purifs:
            return m, c, du, dv, dw, dsv
        epu = self.cfg.purifs.epu
        Qpu = self.cfg.purifs.Qpu
        vel_name = ("u", "v", "w")
        new = {}     # (which, name) -> the written copy

        def target(which, name, src):
            key = (which, name)
            if key not in new:
                new[key] = src.clone()
            return new[key]
        nsv = dsv.shape[0]
        effs = [epu] + _EFFS_AFTER_FIRST
        # the intake slabs are read from m.sv as it was on entry
        slabs = self._intake_slabs(m.sv) if nsv else None
        for q, p in enumerate(self.purifs):
            Apu, dpu, vel, faces, _, axis = self.geometry(p)
            name = vel_name[axis]
            part = self._clip(faces)
            if part is not None:
                fl = part[0]
                target("m", name, getattr(m, name))[fl] = vel
                target("c", name, getattr(c, name))[fl] = vel
                target("d", name, (du, dv, dw)[axis])[fl] = 0.0
            part = self._clip((slice(p.il, p.iu + 1), slice(p.jl, p.ju + 1),
                               slice(p.kl, p.ku + 1)))
            if nsv == 0 or part is None:
                continue
            (bx, by, bz), (ox, oy) = part
            # the slab's part across this block's share of the box (the
            # flow axis has one plane, which broadcasts)
            slab = slabs[q]
            if axis != 0:
                slab = slab[:, ox: ox + bx.stop - bx.start]
            if axis != 1:
                slab = slab[:, :, oy: oy + by.stop - by.start]
            for n in range(nsv):
                e = effs[n] if n < len(effs) else 0.0
                if e == 0.0:
                    continue
                box = (n, bx, by, bz)
                t = target("d", "sv", dsv)
                t[box] = t[box] + (-(Qpu / Apu) * e * slab[n] / dpu)
        fields = lambda which, f: replace(f, **{
            k: v for (w, k), v in new.items() if w == which and k != "sv"})
        d = lambda name, old: new.get(("d", name), old)
        return (fields("m", m), fields("c", c), d("u", du), d("v", dv),
                d("w", dw), d("sv", dsv))


# ---------------------------------------------------------------------------
# Heat pumps
# ---------------------------------------------------------------------------

class HeatPumps:
    """Point heat extractors and their exhaust momentum source
    (heatpump.f90).  `ijk` is (n, 3), 0-based; a point may repeat."""

    def __init__(self, cfg: Config, grid: Grid, ijk, device="cpu"):
        self.cfg = cfg
        self.grid = grid
        self.ijk = np.asarray(ijk, np.int64).reshape(-1, 3)
        n = len(self.ijk)
        self.thl_dot = (cfg.heatpump.QH_dot_hp / (n * const.rhoa * const.cp)
                        if n else 0.0)
        self.w_exhaust = (cfg.heatpump.Q_dot_hp / n * grid.dxi * grid.dyi
                          if n else 0.0)
        li = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
        i, j, k = self.ijk.T
        self.idx = (li(i), li(j), li(k))
        self.idx_w = (li(i), li(j), li(k + 1))
        kw = dict(dtype=grid.torch_dtype, device=device)
        # the per-point extraction, in the reference's order of products
        self.thl_src = torch.as_tensor(
            (-self.thl_dot * grid.dxi * grid.dyi
             * np.asarray(grid.dzfi, dtype=grid.dtype)[k]).astype(grid.dtype),
            device=device)
        self.w_vals = torch.full((n,), self.w_exhaust, **kw)
        self.zeros = torch.zeros((n,), **kw)

    @classmethod
    def load(cls, case_dir, expnr, cfg, grid, device="cpu"):
        pts = read_sparse_ijk(Path(case_dir) / f"heatpump.inp.{expnr}")
        return cls(cfg, grid, pts, device=device)

    def block(self, grid: Grid) -> "HeatPumps":
        """The heat pumps of the block of `grid` (``Grid.block``): its
        points in block indices, each extracting and blowing as on the
        domain (the shares of the domain's count)."""
        i, j, _ = self.ijk.T
        keep = ((i >= grid.i0) & (i < grid.i0 + grid.itot)
                & (j >= grid.j0) & (j < grid.j0 + grid.jtot))
        hp = copy.copy(self)
        hp.grid = grid
        hp.ijk = self.ijk[keep] - np.array([grid.i0, grid.j0, 0])
        dev = self.thl_src.device
        li = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
        i, j, k = hp.ijk.T
        hp.idx = (li(i), li(j), li(k))
        hp.idx_w = (li(i), li(j), li(k + 1))
        sel = torch.as_tensor(keep, device=dev)
        hp.thl_src = self.thl_src[sel]
        hp.w_vals = self.w_vals[sel]
        hp.zeros = self.zeros[sel]
        return hp

    def apply(self, m, c, dw, dthl):
        """heatpump.f90:60-90: with ``lfan_hp`` the w face above each point
        is set to the exhaust velocity in `m` and `c` and its tendency to
        zero; every point extracts heat from `dthl` (summed over repeated
        points).  Returns new (m, c, dw, dthl)."""
        if self.cfg.heatpump.lfan_hp:
            m = replace(m, w=m.w.index_put(self.idx_w, self.w_vals))
            c = replace(c, w=c.w.index_put(self.idx_w, self.w_vals))
            dw = dw.index_put(self.idx_w, self.zeros)
        dthl = dthl.index_put(self.idx, self.thl_src, accumulate=True)
        return m, c, dw, dthl


# ---------------------------------------------------------------------------
# Vegetation
# ---------------------------------------------------------------------------

class Vegetation:
    """Canopy drag, canopy energy balance and scalar deposition
    (vegetation.f90).  The cell drag coefficient lad*cd is averaged to the
    faces once at load (with the reference's periodic wrap, whatever the
    lateral boundary); a call is three face sweeps, the deposition and, in
    moist runs with an absorbed-shortwave field, the energy balance."""

    def __init__(self, cfg: Config, grid: Grid, lad, dcoef, ud, lsize, rs,
                 dec=None, sveg=None, device="cpu"):
        dc = np.asarray(dcoef, np.float64)
        # face averages (vegetation.f90:255-268); periodic wrap
        dcz = np.zeros(dc.shape[:2] + (dc.shape[2] + 1,))
        dcz[:, :, 1:-1] = 0.5 * (dc[:, :, 1:] + dc[:, :, :-1])
        self._setup(cfg, grid, lad, 0.5 * (dc + np.roll(dc, 1, axis=0)),
                    0.5 * (dc + np.roll(dc, 1, axis=1)), dcz, ud, lsize, rs,
                    sveg, bool((dc > 0).any()), device)

    @classmethod
    def from_faces(cls, cfg: Config, grid: Grid, lad, dcoef_u, dcoef_v,
                   dcoef_w, ud, lsize, rs, sveg=None, device="cpu"):
        """A Vegetation from drag coefficients already at the faces (as
        udales_tpu's Vegetation holds them; ``convert.physics_from_numpy``)."""
        veg = cls.__new__(cls)
        veg._setup(cfg, grid, lad, dcoef_u, dcoef_v, dcoef_w, ud, lsize, rs,
                   sveg, bool(any((np.asarray(a) > 0).any()
                                  for a in (dcoef_u, dcoef_v, dcoef_w))),
                   device)
        return veg

    def _setup(self, cfg, grid, lad, dcx, dcy, dcz, ud, lsize, rs, sveg,
               has_canopy, device):
        self.cfg = cfg
        self.grid = grid
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64)
                                      .astype(grid.dtype), device=device)
        self.lad = t(lad)              # (nx, ny, nz) leaf area density
        self.dcoef_u = t(dcx)
        self.dcoef_v = t(dcy)
        self.dcoef_w = t(dcz)          # (nx, ny, nz+1)
        self.ud = t(ud)                # deposition velocity field
        self.lsize = t(np.maximum(lsize, 1e-6))
        self.rs = t(np.maximum(rs, 1e-6))
        self.sveg = None if sveg is None else t(sveg)
        self.has_canopy = has_canopy
        self.dep = self.lad * self.ud   # deposition rate lad * ud
        self.active = self.lad > 0
        self._zero = torch.zeros((), dtype=grid.torch_dtype, device=device)

    @staticmethod
    def read(case_dir, expnr, grid: Grid):
        """Dense (lad, dcoef, ud, lsize, rs, sveg) of a case: ``veg.inp``
        (sparse i j k [id]), ``veg_params.inp`` (id lad cd ud dec lsize rs)
        and, when present, ``sveg.inp`` (absorbed shortwave per point)."""
        case_dir = Path(case_dir)
        nx, ny, nz = grid.shape
        pts = np.loadtxt(case_dir / f"veg.inp.{expnr}", skiprows=1,
                         dtype=np.int64, ndmin=2)
        params = np.loadtxt(case_dir / f"veg_params.inp.{expnr}", skiprows=1,
                            ndmin=2)
        ids = pts[:, 3] if pts.shape[1] >= 4 else np.ones(len(pts), np.int64)
        pmap = {int(r[0]): r for r in params}
        lad, dcoef, ud, lsize, rs = (np.zeros((nx, ny, nz)) for _ in range(5))
        for (i, j, k), pid in zip(pts[:, :3] - 1, ids):
            r = pmap.get(int(pid), params[0])
            lad[i, j, k] = r[1]
            dcoef[i, j, k] = r[1] * r[2]
            ud[i, j, k] = r[3]
            lsize[i, j, k] = r[5]
            rs[i, j, k] = r[6]
        svp_path = case_dir / f"sveg.inp.{expnr}"
        sveg = None
        if svp_path.exists():
            sveg = np.zeros((nx, ny, nz))
            vals = np.loadtxt(svp_path, skiprows=1, ndmin=2)
            sveg[pts[:, 0] - 1, pts[:, 1] - 1, pts[:, 2] - 1] = vals[:, -1]
        return lad, dcoef, ud, lsize, rs, sveg

    @classmethod
    def load(cls, case_dir, expnr, cfg, grid, device="cpu"):
        lad, dcoef, ud, lsize, rs, sveg = cls.read(case_dir, expnr, grid)
        return cls(cfg, grid, lad, dcoef, ud, lsize, rs, sveg=sveg,
                   device=device)

    def block(self, grid: Grid) -> "Vegetation":
        """The canopy of the block of `grid` (``Grid.block``): the arrays
        built on the domain (face averages included), cut; ``has_canopy``
        stays the domain's, so every rank takes the same path."""
        veg = copy.copy(self)
        veg.grid = grid
        for name in ("lad", "dcoef_u", "dcoef_v", "dcoef_w", "ud", "lsize",
                     "rs", "sveg", "dep", "active"):
            a = getattr(self, name)
            setattr(veg, name, None if a is None else grid.cut(a).clone(
                memory_format=torch.contiguous_format))
        return veg

    def _moist_eb(self, cfg):
        return (cfg.physics.lmoist and cfg.physics.ltempeq
                and self.sveg is not None)

    def forcing(self, m, grid: Grid, cfg: Config, du, dv, dw, dthl, dqt,
                dsv):
        """vegetation_forcing (vegetation.f90:351-437, and the sveg energy
        balance :500-540).  Returns new (du, dv, dw, dthl, dqt, dsv); `dthl`
        and `dqt` may be None where their equation is off."""
        nz = grid.ktot
        mesh = grid.mesh
        # quadratic drag at the faces with the reference's interpolations
        gu = pad_periodic_xy(m.u, 1, mesh)
        gv = pad_periodic_xy(m.v, 1, mesh)
        gw = pad_periodic_xy(m.w, 1, mesh)
        # u faces
        v_at_u = 0.25 * (gv[1:-1, 1:-1, :] + gv[1:-1, 2:, :]
                         + gv[:-2, 1:-1, :] + gv[:-2, 2:, :])
        w_at_u = 0.25 * (gw[1:-1, 1:-1, :-1] + gw[1:-1, 1:-1, 1:]
                         + gw[:-2, 1:-1, :-1] + gw[:-2, 1:-1, 1:])
        spd_u = torch.sqrt(m.u ** 2 + v_at_u ** 2 + w_at_u ** 2)
        du = du - self.dcoef_u * m.u * spd_u
        # v faces
        u_at_v = 0.25 * (gu[1:-1, 1:-1, :] + gu[2:, 1:-1, :]
                         + gu[1:-1, :-2, :] + gu[2:, :-2, :])
        w_at_v = 0.25 * (gw[1:-1, 1:-1, :-1] + gw[1:-1, 1:-1, 1:]
                         + gw[1:-1, :-2, :-1] + gw[1:-1, :-2, 1:])
        spd_v = torch.sqrt(m.v ** 2 + u_at_v ** 2 + w_at_v ** 2)
        dv = dv - self.dcoef_v * m.v * spd_v
        # w faces 0..nz-1 (the cell below face 0 repeats cell 0)
        gu2 = pad_periodic_xy(torch.cat([m.u[..., :1], m.u], dim=2), 1,
                              mesh)
        u_at_w = 0.25 * (gu2[1:-1, 1:-1, 1:] + gu2[2:, 1:-1, 1:]
                         + gu2[1:-1, 1:-1, :-1] + gu2[2:, 1:-1, :-1])
        gv2 = pad_periodic_xy(torch.cat([m.v[..., :1], m.v], dim=2), 1,
                              mesh)
        v_at_w = 0.25 * (gv2[1:-1, 1:-1, 1:] + gv2[1:-1, 2:, 1:]
                         + gv2[1:-1, 1:-1, :-1] + gv2[1:-1, 2:, :-1])
        w_lo = m.w[..., :nz]
        spd_w = torch.sqrt(w_lo ** 2 + u_at_w ** 2 + v_at_w ** 2)
        dw = torch.cat([dw[..., :nz]
                        + (-self.dcoef_w[..., :nz] * w_lo * spd_w),
                        dw[..., nz:]], dim=2)

        # canopy energy balance (sveg mode, vegetation.f90:500-540)
        if self._moist_eb(cfg):
            eb = self._canopy_eb(m)
            dqt = dqt + eb["dqt"]
            dthl = dthl + eb["dthl"]

        # scalar deposition (vegetation.f90:424-437)
        if dsv.shape[0] > 0:
            dsv = dsv - m.sv * self.dep[None]
        return du, dv, dw, dthl, dqt, dsv

    def _canopy_eb(self, m):
        """Penman-Monteith canopy energy balance (vegetation.f90:500-540):
        the thl and qt tendencies, the radiative and aerodynamic parts of
        the latent flux and the decoupling factor omega (the treedump
        statistics, modstatsdump.f90:1245-1279)."""
        nz = self.grid.ktot
        gam = (const.cp * const.pref0 * const.rv) / (const.rlv * const.rd)
        q_av = self.sveg / torch.clamp(self.lad, min=1e-12)
        e_sat = 610.8 * torch.exp(17.27 * (m.thl - 273.15)
                                  / (m.thl - 35.85))
        e_vap = (m.qt * const.pref0) / (0.378 * m.qt + 0.622)
        d_vap = torch.clamp(e_sat - e_vap, min=0.0)
        slope = (4098 * e_sat) / ((m.thl - 35.85) ** 2)
        mesh = self.grid.mesh
        if mesh is None:
            uc2 = 0.5 * (m.u + torch.roll(m.u, -1, dims=0))
            vc2 = 0.5 * (m.v + torch.roll(m.v, -1, dims=1))
        else:
            uc2 = 0.5 * (m.u + mesh.wrap(m.u, 0, 1, "x")[2:])
            vc2 = 0.5 * (m.v + mesh.wrap(m.v, 1, 1, "y")[:, 2:])
        wc2 = 0.5 * (m.w[..., :nz] + m.w[..., 1:])
        wind2 = torch.clamp(uc2 ** 2 + vc2 ** 2 + wc2 ** 2, min=1e-12)
        r_a = 130.0 * torch.sqrt(self.lsize / torch.sqrt(wind2))
        omega = 1.0 / (1.0 + 2.0 * (gam / (slope + 2 * gam))
                       * (self.rs / r_a))
        qeR = omega * (slope / (slope + 2 * gam)) * q_av
        qeA = ((1 - omega) * (1.0 / (gam * self.rs))
               * const.rhoa * const.cp * d_vap)
        qe = qeR + qeA
        qh = q_av - qe
        z = self._zero
        scale_q = self.lad / (const.rhoa * const.rlv)
        on = lambda f: torch.where(self.active, f, z)
        return dict(dqt=on(scale_q * qe), dqtR=on(scale_q * qeR),
                    dqtA=on(scale_q * qeA),
                    dthl=on(self.lad * qh / (const.rhoa * const.cp)),
                    omega=on(omega))

    def diagnostics(self, m):
        """The vegetation tendencies of the fields `m` as dense 3-D tensors,
        in the treedump variable layout (modstatsdump.f90:371-380):
        tr_u, tr_v, tr_w, tr_thl, tr_qt, tr_qtR, tr_qtA, tr_omega, tr_sv1,
        tr_sv2."""
        nx, ny, nz = self.grid.shape
        kw = dict(dtype=self.grid.torch_dtype, device=self.lad.device)
        z3 = torch.zeros((nx, ny, nz), **kw)
        du, dv, dw, dthl, dqt, dsv = self.forcing(
            m, self.grid, self.cfg, z3, z3,
            torch.zeros((nx, ny, nz + 1), **kw), z3, z3,
            torch.zeros_like(m.sv))
        out = dict(tr_u=du, tr_v=dv, tr_w=dw[..., :nz], tr_thl=dthl,
                   tr_qt=dqt, tr_qtR=z3, tr_qtA=z3, tr_omega=z3,
                   tr_sv1=z3, tr_sv2=z3)
        if self._moist_eb(self.cfg):
            eb = self._canopy_eb(m)
            out.update(tr_qtR=eb["dqtR"], tr_qtA=eb["dqtA"],
                       tr_omega=eb["omega"])
        if m.sv.shape[0] > 0:
            out["tr_sv1"] = dsv[0]
        if m.sv.shape[0] > 1:
            out["tr_sv2"] = dsv[1]
        return out
