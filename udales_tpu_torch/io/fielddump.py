"""Instantaneous 3-D field dumps (port of ``udales_tpu.io.fielddump``;
src/modfielddump.f90).

The reference writes per-rank ``fielddump.<px>.<py>.<exp>.nc`` files merged
offline by tools/gather_outputs.sh; this writes the already-merged
full-domain file ``fielddump.<exp>.nc`` directly.  Variable naming follows
modfielddump.f90:117-176 so udbase reads the output unchanged.  Each dump
makes one host copy per variable; in the run's trace a dump that
`maybe_dump` serves is the span ``fielddump`` (``sample``: the host copies,
``write``: the file).
"""
from __future__ import annotations

from pathlib import Path

from .. import trace
from .ncwriter import NCWriter

# fieldvars 2-letter codes -> (nc name, dims, units) (modfielddump.f90:121-176)
_CODES = {
    "u0": ("u", ("zt", "yt", "xm"), "m/s"),
    "v0": ("v", ("zt", "ym", "xt"), "m/s"),
    "w0": ("w", ("zm", "yt", "xt"), "m/s"),
    "th": ("thl", ("zt", "yt", "xt"), "K"),
    "ql": ("ql", ("zt", "yt", "xt"), "1e-5kg/kg"),
    "qt": ("qt", ("zt", "yt", "xt"), "1e-5kg/kg"),
    "s1": ("sca1", ("zt", "yt", "xt"), "M"),
    "s2": ("sca2", ("zt", "yt", "xt"), "M"),
    "s3": ("sca3", ("zt", "yt", "xt"), "M"),
    "s4": ("sca4", ("zt", "yt", "xt"), "M"),
    "s5": ("sca5", ("zt", "yt", "xt"), "M"),
    "pr": ("pres", ("zt", "yt", "xt"), "m^2/s^2"),
    "p0": ("pres", ("zt", "yt", "xt"), "m^2/s^2"),  # reference code name
    # wall-stress tendency diagnostics (modfielddump.f90:225-236)
    "tx": ("tau_x", ("zt", "yt", "xm"), "M"),
    "ty": ("tau_y", ("zt", "ym", "xt"), "M"),
    "tz": ("tau_z", ("zm", "yt", "xt"), "M"),
    "hf": ("thl_flux", ("zt", "yt", "xt"), "M"),
    # IBM fluid masks (modfielddump.f90:238-248)
    "mu": ("mask_u", ("zt", "yt", "xm"), "M"),
    "mv": ("mask_v", ("zt", "ym", "xt"), "M"),
    "mw": ("mask_w", ("zm", "yt", "xt"), "M"),
    "mc": ("mask_c", ("zt", "yt", "xt"), "M"),
}


def _host(a):
    return a.detach().cpu().numpy()


class FieldDump:
    def __init__(self, cfg, grid, outdir: str | Path = ".", masks=None):
        self.cfg = cfg
        self.grid = grid
        self.masks = masks   # IBM Masks for the mu/mv/mw/mc codes
        codes = [c.strip() for c in cfg.output.fieldvars.split(",")
                 if c.strip()]
        self.codes = [c for c in codes if c in _CODES]
        exp = f"{cfg.run.iexpnr:03d}"
        self.writer = NCWriter(Path(outdir) / f"fielddump.{exp}.nc", grid)
        for c in self.codes:
            name, dims, units = _CODES[c]
            self.writer.define(name, dims, units)
        self.tnext = cfg.output.tfielddump

    def due(self, t: float) -> bool:
        """Whether the simulated time `t` has reached the cadence."""
        return t >= self.tnext

    def maybe_dump(self, state, t: float, th=None):
        """Dump when the simulated time `t` (the host copy of
        ``state.timee``) has reached the cadence."""
        if not self.due(t):
            return False
        self.tnext += self.cfg.output.tfielddump
        with trace.span("fielddump"):
            self.dump(state, th, t)
        return True

    def dump(self, state, th=None, t: float | None = None):
        with trace.span("sample"):
            data = self._fields(state, th)
        with trace.span("write"):
            self.writer.append(float(state.timee) if t is None else t, data)

    def _fields(self, state, th=None) -> dict:
        """Host copies of the dumped fields, by their file names."""
        c = state.c
        nz = self.grid.ktot
        data = {}
        for code in self.codes:
            name, _, _ = _CODES[code]
            if code == "u0":
                data[name] = _host(c.u)
            elif code == "v0":
                data[name] = _host(c.v)
            elif code == "w0":
                data[name] = _host(c.w[..., :nz])
            elif code == "th":
                data[name] = _host(c.thl)
            elif code == "qt":
                data[name] = _host(c.qt)
            elif code == "ql" and th is not None:
                data[name] = _host(th.ql0)
            elif code in ("pr", "p0"):
                data[name] = _host(state.pres)
            elif code in ("tx", "ty", "tz", "hf") and state.taud is not None:
                key = {"tx": "x", "ty": "y", "tz": "z", "hf": "hf"}[code]
                arr = state.taud[key]
                data[name] = _host(arr[..., :nz] if code == "tz" else arr)
            elif code in ("mu", "mv", "mw", "mc") and self.masks is not None:
                m = getattr(self.masks, code[1])
                data[name] = _host(m[..., :nz] if code == "mw" else m)
            elif code.startswith("s") and code[1:].isdigit():
                n = int(code[1:]) - 1
                if n < c.sv.shape[0]:
                    data[name] = _host(c.sv[n])
        return data

    def close(self):
        self.writer.close()
