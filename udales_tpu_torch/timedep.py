"""Time-dependent forcings (port of ``udales_tpu.timedep``;
src/modtimedep.f90).

Piecewise-linear interpolation in time of: IBM surface fluxes
(timedepsurf.inp), nudging profiles (timedepnudge.inp), sky longwave
(timedeplw.inp) and per-facet net shortwave (timedepsw.inp).  The series
are static device tensors and `timee` is a 0-d device tensor, so the
interpolation makes no host synchronisation; it is clamped, holding the
last value after the series ends (modtimedep.f90:330-344).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch


def _lerp_series(t_arr, v_arr, timee):
    """Clamped piecewise-linear interpolation of `v_arr` (nt, ...) given at
    times `t_arr` (nt,); holds the last value after the series end."""
    # a 1-element index and index_select: indexing with a 0-d device
    # tensor would read the index back to the host
    idx = torch.clamp(
        torch.searchsorted(t_arr, timee.reshape(1), right=True) - 1,
        0, t_arr.shape[0] - 2)
    at = lambda a, i: a.index_select(0, i)[0]
    t0, t1 = at(t_arr, idx), at(t_arr, idx + 1)
    fac = torch.clamp((timee - t0) / torch.clamp(t1 - t0, min=1e-12),
                      0.0, 1.0)
    return at(v_arr, idx) + fac * (at(v_arr, idx + 1) - at(v_arr, idx))


class Timedep:
    def __init__(self, dtype=torch.float32, device="cpu"):
        self.surf_t = None    # (nt,)
        self.surf = None      # (nt, 5): bctfxm bctfxp bctfym bctfyp bctfz
        self.nudge_t = None   # (nt,)
        self.nudge = None     # (nt, 4, nz): thl qt u v
        self.lw_t = None
        self.skyLW = None     # (nt,)
        self.sw_t = None
        self.netsw = None     # (nt, nfcts)
        self.dtype = dtype
        self.device = torch.device(device)

    @classmethod
    def load(cls, case_dir: str | Path, expnr: str, cfg, nz: int,
             dtype=torch.float32, device="cpu") -> Optional["Timedep"]:
        """The series a case directory holds, or None when it holds none.
        Each is gated by its &PHYSICS switch, as in the reference
        (modtimedep.f90:79-150 reads only the enabled blocks)."""
        case_dir = Path(case_dir)
        td = cls(dtype, device)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=td.device)
        found = False
        ph = cfg.physics
        p = case_dir / f"timedepsurf.inp.{expnr}"
        if ph.ltimedepsurf and p.exists():
            d = np.loadtxt(p, skiprows=2, ndmin=2)
            td.surf_t, td.surf = t(d[:, 0]), t(d[:, 1:6])
            found = True
        p = case_dir / f"timedepnudge.inp.{expnr}"
        if ph.ltimedepnudge and p.exists():
            # format (modtimedep.f90:156-213): blocks per time, header lines
            # '# time', then nz rows of [z thl qt u v]
            times, blocks, cur = [], [], []
            for line in p.read_text().splitlines()[1:]:
                s = line.strip()
                if not s:
                    continue
                if s.startswith("#"):
                    if cur:
                        blocks.append(np.asarray(cur))
                        cur = []
                    times.append(float(s.split()[-1]))
                else:
                    cur.append([float(x) for x in s.split()])
            if cur:
                blocks.append(np.asarray(cur))
            if blocks:
                arr = np.stack([b[:nz, 1:5].T for b in blocks])  # (nt,4,nz)
                td.nudge_t, td.nudge = t(np.asarray(times)), t(arr)
                found = True
        p = case_dir / f"timedeplw.inp.{expnr}"
        if ph.ltimedeplw and p.exists():
            d = np.loadtxt(p, skiprows=1, ndmin=2)
            td.lw_t, td.skyLW = t(d[:, 0]), t(d[:, 1])
            found = True
        p = case_dir / f"timedepsw.inp.{expnr}"
        if ph.ltimedepsw and p.exists():
            d = np.loadtxt(p, skiprows=1, ndmin=2)
            td.sw_t, td.netsw = t(d[:, 0]), t(d[:, 1:])
            found = True
        return td if found else None

    # --- interpolators (timee: 0-d tensor on the series' device) ----------
    def surf_fluxes(self, timee):
        """-> (bctfxm, bctfxp, bctfym, bctfyp, bctfz) 0-d tensors."""
        if self.surf is None:
            return None
        v = _lerp_series(self.surf_t, self.surf, timee)
        return v[0], v[1], v[2], v[3], v[4]

    def nudge_profiles(self, timee):
        """-> dict(thl, qt, u, v) profiles (nz,)."""
        if self.nudge is None:
            return None
        v = _lerp_series(self.nudge_t, self.nudge, timee)
        return dict(thl=v[0], qt=v[1], u=v[2], v=v[3])

    def sky_lw(self, timee):
        return (None if self.skyLW is None
                else _lerp_series(self.lw_t, self.skyLW, timee))

    def net_sw(self, timee):
        return (None if self.netsw is None
                else _lerp_series(self.sw_t, self.netsw, timee))
