"""Minimal NetCDF-3 writer with the reference's dimension/variable layout.

Mirrors src/modstat_nc.f90 (open_nc :55, define_nc, writestat_nc): dims
time (unlimited) / xt / xm / yt / ym / zt / zm (+ facet dims), float32
variables (the reference writes NF90_FLOAT even though the solver is r8,
SURVEY.md Appendix B).  Built on scipy.io.netcdf_file (NetCDF-3 classic),
which the reference toolchain (udbase/xarray) reads unchanged.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.io import netcdf_file


class NCWriter:
    """One output file with a record (time) dimension."""

    def __init__(self, path: str | Path, grid=None, nfcts: int = 0,
                 nlayers: int = 0):
        self.path = str(path)
        self.f = netcdf_file(self.path, "w", version=2)
        self.f.createDimension("time", None)
        self.tvar = self.f.createVariable("time", "f4", ("time",))
        self.tvar.units = "s"
        self.nrec = 0
        self._vars = {}
        if grid is not None:
            g = grid
            for name, vals in (("xt", g.xf), ("xm", g.xh[:-1]),
                               ("yt", g.yf), ("ym", g.yh[:-1]),
                               ("zt", g.zf), ("zm", g.zh[:-1])):
                self.f.createDimension(name, len(vals))
                v = self.f.createVariable(name, "f4", (name,))
                v[:] = np.asarray(vals, np.float32)
                v.units = "m"
        if nfcts > 0:
            self.f.createDimension("facet", nfcts)
            fv = self.f.createVariable("facet", "f4", ("facet",))
            fv[:] = np.arange(1, nfcts + 1, dtype=np.float32)
        if nlayers > 0:
            self.f.createDimension("layer", nlayers)
            lv = self.f.createVariable("layer", "f4", ("layer",))
            lv[:] = np.arange(1, nlayers + 1, dtype=np.float32)

    def define(self, name: str, dims: tuple, units: str = "",
               long_name: str = ""):
        v = self.f.createVariable(name, "f4", ("time",) + dims)
        if units:
            v.units = units
        if long_name:
            v.long_name = long_name
        self._vars[name] = v
        return v

    def append(self, time: float, data: dict):
        """Write one record. Arrays are given in (x, y, z) solver order and
        stored transposed to the reference's (time, z, y, x) layout."""
        i = self.nrec
        self.tvar[i] = time
        for name, arr in data.items():
            v = self._vars[name]
            a = np.asarray(arr, np.float32)
            if a.ndim == 3:
                a = a.transpose(2, 1, 0)
            elif a.ndim == 2:
                expected = tuple(self.f.dimensions[d]
                                 for d in v.dimensions[1:])
                if a.shape != expected and a.T.shape == expected:
                    a = a.T
            v[i] = a
        self.nrec += 1
        self.f.sync()

    def close(self):
        self.f.close()
