"""Reference-format precursor driver files (moddriver.f90).

The reference records inlet y-z planes into Fortran DIRECT-ACCESS
unformatted files — raw float64 planes, no record markers
(moddriver.f90 writedriverfile:515, readdriverfile:750):

- ``tdriver_000.<exp>``: one f8 per record = timee - tdriverstart
  (recl = 8 bytes; validated against the committed
  examples/950/driver_files/tdriver_000.949: 101 x f8, monotone).
- ``{u,v,w}driver_<did>.<exp>``: record n = the halo-extended plane
  ``u0(iplane, jb-jh:je+jh, kb-kh:ke+kh)`` in Fortran order (j fastest),
  i.e. (jmax+2, ktot+2) float64 per y-rank ``did = mod(myidy, nprocy)``.
- ``hdriver``/``qdriver``: thl/qt planes, same shape (written when
  ltempeq&lhdriver / lmoist&lqdriver).
- ``sdriver_<did>.<exp>``: scalars with the WIDER kappa halos
  (jb-jhc:je+jhc, kb-khc:ke+khc, 1:nsv), jhc=khc=2
  (moddriver.f90:930-937).

The solver holds global fields, so the writer emits the per-y-rank
split from global planes and the reader reassembles rank files into global
(nt, jtot, ktot[+1]) arrays, dropping halos.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

JH = KH = 1
JHC = KHC = 2


def _halo_j(plane, j0, j1, h):
    """Take rows j0-h .. j1+h-1 of axis 0 with periodic wrap."""
    return np.take(plane, np.arange(j0 - h, j1 + h), axis=0, mode="wrap")


def _halo_k(plane, nz_out, h):
    """Pad axis 1 (k) to nz_out + 2h by edge-clamping (the reference dumps
    whatever sits in the ghost cells; replay uses interior levels only)."""
    nz = plane.shape[1]
    base = plane[:, :min(nz, nz_out)]
    if base.shape[1] < nz_out:
        base = np.concatenate(
            [base, np.repeat(base[:, -1:], nz_out - base.shape[1], axis=1)],
            axis=1)
    lo = np.repeat(base[:, :1], h, axis=1)
    hi = np.repeat(base[:, -1:], h, axis=1)
    return np.concatenate([lo, base, hi], axis=1)


def write_driver_files(outdir: str | Path, expnr: str, times, planes: dict,
                       jtot: int, ktot: int, nprocy: int = 1,
                       tdriverstart: float = 0.0):
    """Write the full reference driver-file set.

    times: (nt,) absolute sim times; stored as ``t - tdriverstart``.
    planes: name -> (nt, jtot, nz) arrays for u/v/w/thl/qt and
    (nt, nsv, jtot, nz) for 'sv' (w may carry ktot+1 face levels; extra
    levels land in the k-halo slots)."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    times = np.asarray(times, np.float64)
    (outdir / f"tdriver_000.{expnr}").write_bytes(
        (times - tdriverstart).tobytes())
    jmax = jtot // nprocy
    fnames = {"u": "u", "v": "v", "w": "w", "thl": "h", "qt": "q"}
    for name, pref in fnames.items():
        if planes.get(name) is None:
            continue
        data = np.asarray(planes[name], np.float64)     # (nt, jtot, nz)
        for did in range(nprocy):
            recs = []
            for n in range(len(times)):
                pl = _halo_j(data[n], did * jmax, (did + 1) * jmax, JH)
                if name == "w":
                    # faces 0..ktot occupy Fortran k=kb-?.. : levels
                    # [face0 | faces 0..ktot] -> bottom ghost duplicates
                    # face 0, then ktot+1 face values
                    full = np.concatenate([pl[:, :1], pl[:, :ktot + 1]],
                                          axis=1)
                    if full.shape[1] < ktot + 2 * KH:
                        full = np.concatenate(
                            [full, np.repeat(full[:, -1:],
                                             ktot + 2 * KH - full.shape[1],
                                             axis=1)], axis=1)
                else:
                    full = _halo_k(pl, ktot, KH)
                recs.append(full.tobytes(order="F"))
            (outdir / f"{pref}driver_{did:03d}.{expnr}").write_bytes(
                b"".join(recs))
    if planes.get("sv") is not None and planes["sv"].shape[1]:
        data = np.asarray(planes["sv"], np.float64)     # (nt, nsv, jtot, nz)
        nsv = data.shape[1]
        for did in range(nprocy):
            recs = []
            for n in range(len(times)):
                comps = []
                for m in range(nsv):
                    pl = _halo_j(data[n, m], did * jmax, (did + 1) * jmax,
                                 JHC)
                    comps.append(_halo_k(pl, ktot, KHC))
                recs.append(np.stack(comps, axis=-1).tobytes(order="F"))
            (outdir / f"sdriver_{did:03d}.{expnr}").write_bytes(
                b"".join(recs))


def read_driver_files(ddir: str | Path, driverjobnr: int, jtot: int,
                      ktot: int, driverstore: int | None = None,
                      nprocy: int | None = None, nsv: int = 0,
                      ltempeq: bool = True, lmoist: bool = False,
                      start: int = 0):
    """Read a reference driver-file set into global arrays
    (moddriver.f90 readdriverfile:750 semantics, all y-ranks assembled).

    `start`/`driverstore` select a record window [start, start+driverstore)
    — the chunked-read pathway (readdriverfile_chunk, moddriver.f90:933)
    reads windows without touching the rest of the file.

    Returns dict with t (nt,), u/v (nt, jtot, ktot), w (nt, jtot, ktot+1),
    thl/qt when present, sv (nt, nsv, jtot, ktot) when present."""
    ddir = Path(ddir)
    exp = f"{driverjobnr:03d}"
    if nprocy is None:  # autodetect the precursor's y decomposition
        nprocy = max(len(list(ddir.glob(f"udriver_*.{exp}"))), 1)
    t = np.frombuffer((ddir / f"tdriver_000.{exp}").read_bytes(), "<f8")
    t = t[start:]
    if driverstore is not None:
        t = t[:driverstore]
    nt = len(t)
    jmax = jtot // nprocy
    out = {"t": np.array(t)}

    def read_planes(pref, jh, kh, ncomp=1):
        nj, nk = jmax + 2 * jh, ktot + 2 * kh
        glob = np.zeros((nt, ncomp, jtot, nk))
        rec = nj * nk * ncomp
        for did in range(nprocy):
            path = ddir / f"{pref}driver_{did:03d}.{exp}"
            n_file = path.stat().st_size // (8 * rec)
            # an interrupted precursor can leave fewer plane records than
            # timestamps; use what exists (remaining steps stay zero and
            # the time-interp clamps before them)
            nuse = max(min(nt, n_file - start), 0)
            if nuse == 0:
                continue
            with open(path, "rb") as f:
                f.seek(start * rec * 8)
                raw = np.frombuffer(f.read(nuse * rec * 8), "<f8")
            arr = raw.reshape((nuse, ncomp, nk, nj)).transpose(0, 1, 3, 2)
            # Fortran order (j fastest, then k, then component)
            glob[:nuse, :, did * jmax:(did + 1) * jmax, :] = \
                arr[:, :, jh:jh + jmax, :]
        return glob

    for name, pref in (("u", "u"), ("v", "v")):
        p = ddir / f"{pref}driver_000.{exp}"
        if p.exists():
            out[name] = read_planes(pref, JH, KH)[:, 0, :, KH:KH + ktot]
    if (ddir / f"wdriver_000.{exp}").exists():
        w = read_planes("w", JH, KH)[:, 0]
        out["w"] = w[:, :, KH:KH + ktot + 1]   # faces 0..ktot
    if ltempeq and (ddir / f"hdriver_000.{exp}").exists():
        out["thl"] = read_planes("h", JH, KH)[:, 0, :, KH:KH + ktot]
    if lmoist and (ddir / f"qdriver_000.{exp}").exists():
        out["qt"] = read_planes("q", JH, KH)[:, 0, :, KH:KH + ktot]
    if nsv > 0 and (ddir / f"sdriver_000.{exp}").exists():
        out["sv"] = read_planes("s", JHC, KHC, ncomp=nsv)[
            :, :, :, KHC:KHC + ktot]
    return out
