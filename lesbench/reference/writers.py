"""The reference's side of ``correct`` for the writers of a production run:
what the program's field dump and time-averaged statistics wrote in the
window, read back from their NetCDF files and held against what the
program handed them.

- The field dump: the last record of ``fielddump.<exp>.nc`` against the
  fields of the State the dump was given, exactly (both are float32).
- The time-averaged 3-D statistics: the last record of ``tdump.<exp>.nc``
  at a few columns drawn from the seed, against the means over that
  record's samples of the same columns, computed here in float64 (or in
  bfloat16, the precision below the configuration's float32, as the
  control): the means of u, v, w, thl and p and the variance of thl.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.io import netcdf_file

# tdump's names of the numbers compared, in the order of the sampled rows
# (u, v, w, thl, p), then the variance of thl
TDUMP = ("ut", "vt", "wt", "thlt", "pt")


def last_record(path, names) -> dict:
    """The last record of each variable of a NetCDF file, as (x, y, z)."""
    with netcdf_file(path, "r", mmap=False) as f:
        return {n: np.asarray(f.variables[n][-1]).transpose(2, 1, 0).copy()
                for n in names}


def fielddump_gap(path, kept: dict) -> float:
    """The largest absolute difference between the last record of the field
    dump and the fields the dump was given (w without its top face)."""
    rec = last_record(path, ("u", "v", "w", "thl"))
    nz = kept["u"].shape[2]
    worst = 0.0
    for name in ("u", "v", "w", "thl"):
        want = kept[name].cpu().numpy()[..., :nz]
        worst = max(worst, float(np.abs(rec[name] - want).max()))
    return worst


def tdump_means(samples, dtype=torch.float64) -> dict:
    """The time means of the sampled columns and the variance of thl,
    computed in `dtype`: `samples` is a list of (5, columns, nz) tensors,
    one a sample, rows u, v, w, thl, p."""
    s = torch.stack([x.to("cpu", dtype) for x in samples])
    mean = s.mean(dim=0)
    out = {name: mean[i] for i, name in enumerate(TDUMP)}
    thl = s[:, 3]
    out["thlpthlpt"] = (thl * thl).mean(dim=0) - mean[3] * mean[3]
    return {k: v.double().numpy() for k, v in out.items()}


def tdump_gaps(path, columns, samples, dtype=torch.float64) -> dict:
    """For each compared statistic, the largest absolute difference between
    the last record of ``tdump`` at the sampled columns and the float64
    means of its samples, over the range of those means.  With another
    `dtype` the record is replaced by the means computed in it (the
    control)."""
    ii, jj = (np.asarray(c) for c in columns)
    ref = tdump_means(samples)
    if dtype == torch.float64:
        rec = last_record(path, TDUMP + ("thlpthlpt",))
        nz = ref["ut"].shape[1]
        got = {n: rec[n][ii, jj, :nz] for n in rec}
    else:
        got = tdump_means(samples, dtype)
    out = {}
    for name, r in ref.items():
        scale = float(r.max() - r.min())
        diff = float(np.abs(got[name] - r).max())
        out[f"tdump_{name}_gap"] = diff / scale if scale > 0 else diff
    return out
