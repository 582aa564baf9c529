"""The NetCDF writer of the run's outputs: ``netcdf.NCWriter`` (kept a
copy of udales_tpu's) whose `append` also adds the bytes of the record it
is handed, as float32, to the run's trace (the open ``write`` span of the
writer's family)."""
from __future__ import annotations

import numpy as np

from .. import trace
from . import netcdf


class NCWriter(netcdf.NCWriter):

    def append(self, time: float, data: dict):
        super().append(time, data)
        trace.add_bytes(sum(4 * np.size(a) for a in data.values()))
