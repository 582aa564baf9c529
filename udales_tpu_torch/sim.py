"""The precursor-plane recorder of ``udales_tpu.sim``.

Only `DriverRecorder` is ported: the rest of the simulation driver
(`Simulation`, its output cadences, restart writes and `main`) waits for
the output modules.  A caller steps the Model itself and hands each State
to `maybe_record`.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .io.driverfiles import write_driver_files


class DriverRecorder:
    """Precursor-plane recorder (idriver=1, moddriver.f90 drivergen:174 /
    writedriverfile:515): every dtdriver after tdriverstart, store the y-z
    planes of u (at face iplane), v, w, thl, qt, sv.  `save` writes the
    reference's Fortran direct-access ``?driver_*`` files, which
    ``run.load_case`` replays (idriver=2), and, where h5py is installed,
    ``driverdata.<exp>.h5`` for ``ops.openbc.load_driver_inlet``."""

    def __init__(self, cfg, grid, outdir):
        self.cfg = cfg
        self.grid = grid
        self.outdir = Path(outdir)
        self.tnext = cfg.driver.tdriverstart
        self.frames = []
        self.times = []

    def maybe_record(self, state):
        t = float(state.timee)
        if t < self.tnext:
            return
        self.tnext += self.cfg.driver.dtdriver
        c = state.c
        nx = self.grid.itot
        ip = self.cfg.driver.iplane % nx    # face index (wraps at itot)
        ic = min(ip, nx - 1)
        n = lambda a: a.detach().cpu().numpy()
        self.times.append(t)
        self.frames.append(dict(
            u=n(c.u[ip % nx]), v=n(c.v[ic]), w=n(c.w[ic]), thl=n(c.thl[ic]),
            qt=n(c.qt[ic]),
            sv=n(c.sv[:, ic]) if c.sv.shape[0] else None))

    def save(self):
        """Write the recorded series; returns the path of the time file
        (None when nothing was recorded)."""
        if not self.frames:
            return None
        exp = f"{self.cfg.run.iexpnr:03d}"
        planes = {k: np.stack([fr[k] for fr in self.frames])
                  for k in ("u", "v", "w", "thl", "qt")}
        planes["sv"] = (np.stack([fr["sv"] for fr in self.frames])
                        if self.frames[0]["sv"] is not None else None)
        write_driver_files(self.outdir, exp, np.asarray(self.times), planes,
                           self.grid.jtot, self.grid.ktot,
                           tdriverstart=self.cfg.driver.tdriverstart)
        try:
            import h5py
        except ImportError:
            return self.outdir / f"tdriver_000.{exp}"
        with h5py.File(self.outdir / f"driverdata.{exp}.h5", "w") as f:
            f.create_dataset("t", data=np.asarray(self.times))
            for k, v in planes.items():
                if v is not None:
                    f.create_dataset(k, data=v)
        return self.outdir / f"tdriver_000.{exp}"
