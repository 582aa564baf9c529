"""Checkpoint/restore (port of ``udales_tpu.io.restart``).

Native checkpoints are HDF5 (h5py) holding the full prognostic state +
timee/dt — the analogue of the reference's per-rank unformatted
``initd<ntrun>_<px>_<py>.<exp>`` files (src/modsave.f90:37-131), but merged
and portable.  The layout is udales_tpu's, so a checkpoint written by
either package loads in the other.  h5py is imported where a checkpoint is
written or read, and a missing h5py raises there.

`write_fortran_restart` / `read_fortran_restart` handle the reference's own
restart files (record layout at modsave.f90:80-100: sequential unformatted
with 4-byte little-endian markers, real(8) data, per-rank subdomains with
1-cell halos); they need only numpy.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

from ..ibm.eb import FacetState
from ..state import Fields, State, zero_facstats

_FIELD_LEAVES = ("u", "v", "w", "thl", "qt", "e12", "sv")
_FAC_LEAVES = ("T", "Tdash", "hfi", "efi", "wsoil", "hurel", "qsat", "f",
               "tnextEB", "tEB_last")


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "native checkpoints (.h5) need the h5py package, which is not "
            "installed; write_fortran_restart / warmstart_state need only "
            "numpy") from e
    return h5py


def _host(a):
    return a.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Native checkpoints
# ---------------------------------------------------------------------------

def save_checkpoint(path: str | Path, state, ntrun: int = 0):
    h5py = _h5py()
    with h5py.File(path, "w") as f:
        f.attrs["timee"] = float(state.timee)
        f.attrs["dt"] = float(state.dt)
        f.attrs["ntrun"] = ntrun
        for grp, flds in (("m", state.m), ("c", state.c)):
            g = f.create_group(grp)
            for name in _FIELD_LEAVES:
                g.create_dataset(name, data=_host(getattr(flds, name)))
        f.create_dataset("pres", data=_host(state.pres))
        # facet-EB state (the reference restarts facet temperatures via a
        # re-written Tfacinit_layers.inp, initfac.f90:301-310; here the
        # whole FacetState rides in the checkpoint)
        if state.fac is not None:
            g = f.create_group("fac")
            for name in _FAC_LEAVES:
                g.create_dataset(name, data=_host(getattr(state.fac, name)))


def load_checkpoint(path: str | Path, grid, dtype=None, model=None,
                    device=None):
    """Rebuild a State from a native checkpoint, on `device` (default: the
    model's, else the CPU).  Pass `model` to restore the facet-EB state and
    to start fresh lwritefac accumulators, as the reference does."""
    h5py = _h5py()
    if device is None:
        device = model.device if model is not None else "cpu"
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)
    with h5py.File(path, "r") as f:
        def fields(grp):
            g = f[grp]
            return Fields(**{name: t(g[name][()]) for name in _FIELD_LEAVES})
        fac = None
        if "fac" in f and model is not None and model.eb is not None:
            g = f["fac"]
            fac = FacetState(**{name: t(g[name][()]) for name in _FAC_LEAVES})
        dt = torch.as_tensor(f.attrs["dt"], dtype=grid.torch_dtype,
                             device=device)
        st = State(m=fields("m"), c=fields("c"), pres=t(f["pres"][()]),
                   dt=dt, timee=torch.as_tensor(f.attrs["timee"],
                                                dtype=grid.torch_dtype,
                                                device=device),
                   fac=fac)
    if (model is not None and model.cfg.walls.lwritefac
            and model.ibm is not None):
        st = st.replace(facstats=zero_facstats(model.ibm.nfcts,
                                               grid.torch_dtype, device))
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
                          ntrun: int = 0, sv=None):
    """Write per-rank ``initd<ntrun>_<px>_<py>.<exp>`` (+ ``inits*`` when
    scalars are present) in the reference's sequential-unformatted layout
    (modsave.f90:83-131): records mindist, wall(5), then
    u0,v0,w0,pres0,thl0,e120,ekm,qt0,ql0,ql0h on (imax+2, jmax+2, ktot+1)
    subdomains with 1-cell periodic halos, then (timee, dt).

    `fields` maps those ten names to global (itot, jtot, ktot[+1]) arrays;
    missing entries are written as zeros.  mindist/wall (wall-distance
    search caches, modfields.f90) are written as zeros — the solver
    recomputes wall geometry from the IBM inputs on startup and its ingest
    skips these records (read_fortran_restart below)."""
    case_dir = Path(case_dir)
    imax, jmax = itot // nprocx, jtot // nprocy
    ih = jh = kh = 1
    names = ["u", "v", "w", "pres", "thl", "e12", "ekm", "qt", "ql", "qlh"]

    def halo_block(glob, px, py):
        """(imax+2, jmax+2, ktot+1) little-endian f8, Fortran order."""
        g = np.zeros((itot, jtot, ktot + kh))
        g[:, :, :min(glob.shape[2], ktot + kh)] = \
            np.asarray(glob, np.float64)[:, :, :ktot + kh]
        gi = np.take(g, np.arange(px * imax - ih, (px + 1) * imax + ih),
                     axis=0, mode="wrap")
        return np.take(gi, np.arange(py * jmax - jh, (py + 1) * jmax + jh),
                       axis=1, mode="wrap")

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
                    _write_record(fh, halo_block(glob, px, py)
                                  .tobytes(order="F"))
                _write_record(fh, struct.pack("<2d", timee, dt))
            if sv is not None and len(sv):
                sname = f"inits{ntrun:08d}_{px:03d}_{py:03d}.{expnr}"
                blocks = np.stack([halo_block(s, px, py) for s in sv],
                                  axis=-1)
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


def warmstart_state(case_dir, startfile, expnr, cfg, grid, dtype=None,
                    device="cpu"):
    """Build a State on `device` from reference restart files (lwarmstart
    path, modstartup.f90:2156)."""
    d = cfg.domain
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
    return State(m=f, c=f, pres=to(out["pres"]),
                 dt=torch.tensor(dt, **kw), timee=torch.tensor(timee, **kw))
