"""Checkpoint/restore (port of ``udales_tpu.io.restart``).

Native checkpoints are HDF5 files holding the full prognostic state +
timee/dt — the analogue of the reference's per-rank unformatted
``initd<ntrun>_<px>_<py>.<exp>`` files (src/modsave.f90:37-131), but merged
and portable.  The layout is udales_tpu's, so a checkpoint written by
either package loads in the other; the port reads and writes it with
`udales_tpu_torch.io.hdf5`, which needs only numpy.

`write_fortran_restart` / `read_fortran_restart` handle the reference's own
restart files (record layout at modsave.f90:80-100: sequential unformatted
with 4-byte little-endian markers, real(8) data, per-rank subdomains with
1-cell halos); they need only numpy.

Open boundaries: a native checkpoint also holds the outlet planes
(``Fields.bx``/``by``) and the inlet generator's state (``State.ig``); the
Fortran files hold the outlet planes where the reference has them, in the
halo cell past the domain's last x (y) cell of the last x (y) rank
(``outlet=`` of `write_fortran_restart`, `read_fortran_outlet_planes`).
The rolling driver window is not state: ``DriverStream.ensure`` reloads it.
A State written from a split run is the gathered one; `load_checkpoint`
and `warmstart_state` cut a split Model's blocks from the whole State.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

from ..ibm.eb import FacetState
from ..ops.inletgen import INLETGEN_NAMES, InletGen, init_inletgen
from ..ops.openbc import XPlanes, YPlanes
from ..parallel.mesh import shard_state
from ..state import Fields, State, zero_facstats
from .. import trace
from . import hdf5

_FIELD_LEAVES = ("u", "v", "w", "thl", "qt", "e12", "sv")
_FAC_LEAVES = ("T", "Tdash", "hfi", "efi", "wsoil", "hurel", "qsat", "f",
               "tnextEB", "tEB_last")
_PLANE_LEAVES = ("u", "v", "w", "thl", "qt", "e12", "sv")


def _host(a):
    return a.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Native checkpoints
# ---------------------------------------------------------------------------

def save_checkpoint(path: str | Path, state, ntrun: int = 0,
                    extra: dict | None = None):
    """Write `state` as a native checkpoint; `extra` adds members to the
    file's root (``Simulation``'s ``stats`` group) in the same write.  In
    the run's trace: ``sample`` the host copies, ``write`` the file, with
    its bytes."""
    with trace.span("sample"):
        tree = _checkpoint_tree(state, ntrun)
    tree.update(extra or {})
    with trace.span("write"):
        trace.add_bytes(hdf5.write(path, tree))


def _checkpoint_tree(state, ntrun: int) -> "hdf5.Group":
    """The host copy of `state` as a checkpoint's groups."""
    tree = hdf5.Group(attrs=dict(timee=float(state.timee),
                                 dt=float(state.dt), ntrun=ntrun))
    for grp, flds in (("m", state.m), ("c", state.c)):
        g = tree[grp] = {name: _host(getattr(flds, name))
                         for name in _FIELD_LEAVES}
        for side in ("bx", "by"):
            planes = getattr(flds, side)
            if planes is not None:
                g[side] = {name: _host(getattr(planes, name))
                           for name in _PLANE_LEAVES}
    tree["pres"] = _host(state.pres)
    if state.ig is not None:
        tree["ig"] = {name: _host(getattr(state.ig, name))
                      for name in INLETGEN_NAMES}
    # facet-EB state (the reference restarts facet temperatures via a
    # re-written Tfacinit_layers.inp, initfac.f90:301-310; here the
    # whole FacetState rides in the checkpoint)
    if state.fac is not None:
        tree["fac"] = {name: _host(getattr(state.fac, name))
                       for name in _FAC_LEAVES}
    return tree


def _device(device, model):
    """`device`, else the model's, else the card."""
    if device is not None:
        return device
    return model.device if model is not None else "cuda"


def load_checkpoint(path: str | Path, grid, dtype=None, model=None,
                    device=None):
    """Rebuild a State from a native checkpoint, on `device` (default: the
    model's, else the card).  Pass `model` to restore the facet-EB state and
    to start fresh lwritefac accumulators, as the reference does; the State
    of a split `model` is its blocks of the checkpoint's whole State."""
    device = _device(device, model)
    t = lambda a: torch.as_tensor(a, device=device)
    f = hdf5.read(path)

    def fields(grp):
        g = f[grp]
        planes = {side: cls(**{k: t(g[side][k]) for k in _PLANE_LEAVES})
                  for side, cls in (("bx", XPlanes), ("by", YPlanes))
                  if side in g}
        return Fields(**{name: t(g[name]) for name in _FIELD_LEAVES},
                      **planes)
    fac = None
    if "fac" in f and model is not None and model.eb is not None:
        fac = FacetState(**{name: t(f["fac"][name])
                            for name in _FAC_LEAVES})
    scalar = lambda v: torch.as_tensor(v, dtype=grid.torch_dtype,
                                       device=device)
    st = State(m=fields("m"), c=fields("c"), pres=t(f["pres"]),
               dt=scalar(f.attrs["dt"]), timee=scalar(f.attrs["timee"]),
               fac=fac)
    if "ig" in f:
        st = st.replace(ig=InletGen(**{k: t(f["ig"][k])
                                       for k in INLETGEN_NAMES}))
    if (model is not None and model.cfg.walls.lwritefac
            and model.ibm is not None):
        st = st.replace(facstats=zero_facstats(model.ibm.nfcts,
                                               grid.torch_dtype, device))
    if model is not None and model.mesh is not None:
        st = shard_state(st, model.mesh)
    return st


# ---------------------------------------------------------------------------
# Reference Fortran restart write (modsave.f90:83-131 record layout)
# ---------------------------------------------------------------------------

def _write_record(fh, payload: bytes):
    fh.write(struct.pack("<i", len(payload)))
    fh.write(payload)
    fh.write(struct.pack("<i", len(payload)))


def write_fortran_restart(case_dir: str | Path, fields: dict, timee: float,
                          dt: float, expnr: str, itot: int, jtot: int,
                          ktot: int, nprocx: int = 1, nprocy: int = 1,
                          ntrun: int = 0, sv=None, outlet=None):
    """Write per-rank ``initd<ntrun>_<px>_<py>.<exp>`` (+ ``inits*`` when
    scalars are present) in the reference's sequential-unformatted layout
    (modsave.f90:83-131): records mindist, wall(5), then
    u0,v0,w0,pres0,thl0,e120,ekm,qt0,ql0,ql0h on (imax+2, jmax+2, ktot+1)
    subdomains with 1-cell periodic halos, then (timee, dt).

    `fields` maps those ten names to global (itot, jtot, ktot[+1]) arrays;
    missing entries are written as zeros.  `outlet` ({"x": planes, "y":
    planes}, each mapping u, v, w, thl, qt, e12 and sv to whole (jtot, ...)
    or (itot, ...) arrays) puts the outlet planes of an open boundary into
    the halo cell past the domain's last cell, where the reference keeps
    them (the last x rank's ie+1, the last y rank's je+1).  mindist/wall
    (wall-distance search caches, modfields.f90) are written as zeros —
    the solver recomputes wall geometry from the IBM inputs on startup and
    its ingest skips these records (read_fortran_restart below)."""
    case_dir = Path(case_dir)
    imax, jmax = itot // nprocx, jtot // nprocy
    ih = jh = kh = 1
    names = ["u", "v", "w", "pres", "thl", "e12", "ekm", "qt", "ql", "qlh"]

    outlet = outlet or {}
    ii = lambda px: np.arange(px * imax - ih, (px + 1) * imax + ih)
    jj = lambda py: np.arange(py * jmax - jh, (py + 1) * jmax + jh)

    def kpad(a):
        out = np.zeros(a.shape[:-1] + (ktot + kh,))
        out[..., :min(a.shape[-1], ktot + kh)] = \
            np.asarray(a, np.float64)[..., :ktot + kh]
        return out

    def halo_block(glob, px, py, name=None, n=None):
        """(imax+2, jmax+2, ktot+1) little-endian f8, Fortran order; the
        outlet plane `name` (scalar `n`) in the ghost past the domain."""
        g = kpad(glob)
        b = np.take(np.take(g, ii(px), axis=0, mode="wrap"), jj(py),
                    axis=1, mode="wrap")
        for side, last, cut, ax in (("x", px == nprocx - 1, jj(py), 0),
                                    ("y", py == nprocy - 1, ii(px), 1)):
            plane = outlet.get(side, {}).get(name)
            if last and plane is not None:
                plane = kpad(plane if n is None else plane[n])
                idx = [slice(None)] * 3
                idx[ax] = -1
                b[tuple(idx)] = np.take(plane, cut, axis=0, mode="wrap")
        return b

    zero_int = np.zeros((imax, jmax, ktot))
    for px in range(nprocx):
        for py in range(nprocy):
            name = f"initd{ntrun:08d}_{px:03d}_{py:03d}.{expnr}"
            with open(case_dir / name, "wb") as fh:
                _write_record(fh, zero_int.tobytes(order="F"))       # mindist
                _write_record(fh, np.zeros(
                    (imax, jmax, ktot, 5)).tobytes(order="F"))       # wall
                for n in names:
                    glob = fields.get(n)
                    if glob is None:
                        glob = np.zeros((itot, jtot, ktot))
                    _write_record(fh, halo_block(glob, px, py, n)
                                  .tobytes(order="F"))
                _write_record(fh, struct.pack("<2d", timee, dt))
            if sv is not None and len(sv):
                sname = f"inits{ntrun:08d}_{px:03d}_{py:03d}.{expnr}"
                blocks = np.stack([halo_block(s, px, py, "sv", i)
                                   for i, s in enumerate(sv)], axis=-1)
                with open(case_dir / sname, "wb") as fh:
                    _write_record(fh, blocks.tobytes(order="F"))
                    _write_record(fh, struct.pack("<d", timee))


# ---------------------------------------------------------------------------
# Reference Fortran restart ingest
# ---------------------------------------------------------------------------

def _read_records(path: Path):
    """Yield raw payloads of a little-endian sequential unformatted file."""
    data = Path(path).read_bytes()
    off = 0
    while off < len(data):
        (n,) = struct.unpack_from("<i", data, off)
        off += 4
        yield data[off: off + n]
        off += n
        (n2,) = struct.unpack_from("<i", data, off)
        if n2 != n:
            raise ValueError(f"{path}: corrupt record marker")
        off += 4


def read_fortran_restart(case_dir: str | Path, startfile: str, expnr: str,
                         itot: int, jtot: int, ktot: int,
                         nprocx: int, nprocy: int, nsv: int = 0):
    """Read the reference's per-rank initd/inits files and assemble global
    fields (interiors only; halos dropped).

    startfile pattern: ``initd<ntrun>_xxx_xxx.<exp>`` — xxx placeholders are
    replaced per rank (modstartup.f90:2156+). Returns dict of (itot,jtot,
    ktot[+1]) float64 arrays + timee, dt."""
    case_dir = Path(case_dir)
    imax, jmax = itot // nprocx, jtot // nprocy
    ih = jh = kh = 1
    shape = (imax + 2 * ih, jmax + 2 * jh, ktot + kh)  # (i,j,k) fortran order
    names = ["u", "v", "w", "pres", "thl", "e12", "ekm", "qt", "ql", "qlh"]
    out = {n: np.zeros((itot, jtot, ktot + kh)) for n in names}
    out_sv = np.zeros((nsv, itot, jtot, ktot + kh)) if nsv else None
    timee = dt = 0.0

    for px in range(nprocx):
        for py in range(nprocy):
            fname = startfile.replace("xxx", f"{px:03d}", 1)
            fname = fname.replace("xxx", f"{py:03d}", 1)
            path = case_dir / fname
            recs = list(_read_records(path))
            # records: mindist, wall(5), then the 10 fields, then (timee, dt)
            fld_recs = recs[2:12]
            for name, payload in zip(names, fld_recs):
                a = np.frombuffer(payload, "<f8").reshape(shape, order="F")
                interior = a[ih:-ih, jh:-jh, :]
                out[name][px * imax:(px + 1) * imax,
                          py * jmax:(py + 1) * jmax, :] = interior
            timee, dt = struct.unpack("<2d", recs[12])
            if nsv:
                spath = case_dir / fname.replace("initd", "inits")
                if spath.exists():
                    srecs = list(_read_records(spath))
                    a = np.frombuffer(srecs[0], "<f8").reshape(
                        shape + (nsv,), order="F")
                    out_sv[:, px * imax:(px + 1) * imax,
                           py * jmax:(py + 1) * jmax, :] = \
                        a[ih:-ih, jh:-jh, :, :].transpose(3, 0, 1, 2)
    return out, out_sv, timee, dt


def _rank_files(startfile, nprocx, nprocy):
    """(px, py, file name) of every rank of a ``..._xxx_xxx.<exp>``
    start file."""
    for px in range(nprocx):
        for py in range(nprocy):
            fname = startfile.replace("xxx", f"{px:03d}", 1)
            yield px, py, fname.replace("xxx", f"{py:03d}", 1)


def read_fortran_outlet_planes(case_dir, startfile: str, itot: int,
                               jtot: int, ktot: int, nprocx: int,
                               nprocy: int, nsv: int = 0):
    """The outlet planes held in the restart files' halo past the domain's
    last cells (`write_fortran_restart` ``outlet=``): {"x": {u, v, w, thl,
    qt, e12: (jtot, ktot+1), sv: (nsv, jtot, ktot+1)}, "y": the same over
    itot}."""
    case_dir = Path(case_dir)
    imax, jmax = itot // nprocx, jtot // nprocy
    shape = (imax + 2, jmax + 2, ktot + 1)
    names = ["u", "v", "w", "pres", "thl", "e12", "ekm", "qt", "ql", "qlh"]
    out = {"x": {n: np.zeros((jtot, ktot + 1)) for n in _PLANE_LEAVES[:-1]},
           "y": {n: np.zeros((itot, ktot + 1)) for n in _PLANE_LEAVES[:-1]}}
    out["x"]["sv"] = np.zeros((nsv, jtot, ktot + 1))
    out["y"]["sv"] = np.zeros((nsv, itot, ktot + 1))
    for px, py, fname in _rank_files(startfile, nprocx, nprocy):
        if px != nprocx - 1 and py != nprocy - 1:
            continue
        recs = dict(zip(names, list(_read_records(case_dir / fname))[2:12]))
        arrays = {n: np.frombuffer(recs[n], "<f8").reshape(shape, order="F")
                  for n in _PLANE_LEAVES[:-1]}
        spath = case_dir / fname.replace("initd", "inits")
        if nsv and spath.exists():
            a = np.frombuffer(list(_read_records(spath))[0], "<f8").reshape(
                shape + (nsv,), order="F")
            arrays["sv"] = np.moveaxis(a, -1, 0)
        rows = {"x": slice(py * jmax, (py + 1) * jmax),
                "y": slice(px * imax, (px + 1) * imax)}
        for n, a in arrays.items():
            if px == nprocx - 1:
                out["x"][n][..., rows["x"], :] = a[..., -1, 1:-1, :]
            if py == nprocy - 1:
                out["y"][n][..., rows["y"], :] = a[..., 1:-1, -1, :]
    return out


def write_state_fortran(case_dir, state, expnr: str, cfg, ntrun: int = 0):
    """`write_fortran_restart` of a whole-domain State (a split run's
    gathered one): its c fields, pressure, scalars and outlet planes."""
    host = lambda a: a.detach().cpu().numpy()
    c, d = state.c, cfg.domain
    outlet = {side: {k: host(getattr(planes, k)) for k in _PLANE_LEAVES}
              for side, planes in (("x", c.bx), ("y", c.by))
              if planes is not None}
    write_fortran_restart(
        case_dir, {k: host(getattr(c, k)) for k in ("u", "v", "w", "thl",
                                                     "e12", "qt")}
        | {"pres": host(state.pres)}, float(state.timee), float(state.dt),
        expnr, d.itot, d.jtot, d.ktot, cfg.run.nprocx, cfg.run.nprocy,
        ntrun=ntrun,
        sv=host(c.sv) if c.sv.shape[0] else None, outlet=outlet)


def warmstart_state(case_dir, startfile, expnr, cfg, grid, dtype=None,
                    device=None, model=None):
    """Build a State on `device` (default: the model's, else the card) from
    reference restart files (lwarmstart path, modstartup.f90:2156).  With
    `model`: the outlet planes of its open boundaries from the files'
    halos, the rescale-recycle generator's state of a model with
    `igparams` (``init_inletgen`` of the warm whole-domain fields, as
    ``Model.cold_start`` builds it), and a split Model's blocks of the
    whole State.  The Fortran files hold none of the generator's running
    means (Utav, Urec, Uinl, ...), so they restart from the warm fields and
    a continued generator case is not the uninterrupted run; the native
    ``.h5`` checkpoint carries them exactly."""
    d = cfg.domain
    device = _device(device, model)
    out, out_sv, timee, dt = read_fortran_restart(
        case_dir, startfile, expnr, d.itot, d.jtot, d.ktot,
        cfg.run.nprocx, cfg.run.nprocy, cfg.scalars.nsv)
    kw = dict(dtype=grid.torch_dtype, device=device)
    nz = d.ktot
    to = lambda a: torch.as_tensor(np.ascontiguousarray(a[..., :nz]), **kw)
    # w: faces 0..nz (restart array holds kb..ke+kh = faces 0..nz)
    w = torch.as_tensor(out["w"], **kw)
    f = Fields(u=to(out["u"]), v=to(out["v"]), w=w,
               thl=to(out["thl"]), qt=to(out["qt"]), e12=to(out["e12"]),
               sv=(to(out_sv) if out_sv is not None
                   else torch.zeros((0, d.itot, d.jtot, nz), **kw)))
    if model is not None and (model.inlet is not None
                              or model.inlet_y is not None):
        pl = read_fortran_outlet_planes(case_dir, startfile, d.itot, d.jtot,
                                        nz, cfg.run.nprocx, cfg.run.nprocy,
                                        cfg.scalars.nsv)
        planes = lambda side, cls: cls(**{
            k: torch.as_tensor(np.ascontiguousarray(
                a if k == "w" else a[..., :nz]), **kw)
            for k, a in pl[side].items()})
        f = Fields(**{k: getattr(f, k) for k in _FIELD_LEAVES},
                   bx=planes("x", XPlanes) if model.inlet is not None
                   else None,
                   by=planes("y", YPlanes) if model.inlet_y is not None
                   else None)
    st = State(m=f, c=f, pres=to(out["pres"]),
               dt=torch.tensor(dt, **kw), timee=torch.tensor(timee, **kw))
    igparams = getattr(model, "igparams", None)
    if igparams is not None:
        st = st.replace(ig=init_inletgen(cfg, model.domain_grid, f,
                                         igparams))
    if model is not None and model.mesh is not None:
        st = shard_state(st, model.mesh)
    return st
