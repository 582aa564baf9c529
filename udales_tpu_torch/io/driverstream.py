"""Chunked streaming replay of precursor driver files (port of
``udales_tpu.io.driverstream``).

The reference's `lchunkread` path (moddriver.f90:933 readdriverfile_chunk,
live call site modboundary.f90:263 driverchunkread) keeps only
`chunkread_size` (modglobal.f90:457-458, default 100) time planes of the
precursor series in memory and reads the next chunk from disk when the
simulation time crosses the window.

Here the device holds a fixed-shape rolling window (`DriverWindow`, a State
leaf) and the host `DriverStream` swaps the window tensors between steps
(same shapes, new values).  The full timestamp vector stays on the host;
only `chunk` planes of each variable live in device memory at any moment,
so a `driverstore = 10_000`-plane production series replays at bounded
device memory.  `ensure` reads ``float(state.timee)``: one host wait a
step, outside ``Model.step``.  A rank of an x/y split keeps its y rows of
the records (`rows`); every rank reads the same whole ``timee`` and so
picks the same window.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import trace
from ..ops.openbc import DriverWindow, ycut_series
from .driverfiles import read_driver_files


class DriverStream:
    """Host-side chunk reader + device-window manager for driver replay.
    `dtype` is the torch dtype of the fields, `device` where the window
    lives, `rows` the y rows of a split Model's block (a slice; None: all
    jtot).  `refills` counts the chunks read so far (the trace's
    ``driver.refills``).  `ensure` is the trace's span ``driver.ensure``:
    ``driver.wait`` the host read of ``timee``, ``driver.refill`` a chunk
    read with the bytes it puts on the device."""

    refills = trace.counter("driver.refills")

    def __init__(self, ddir: str | Path, driverjobnr: int, jtot: int,
                 ktot: int, dtype, chunk: int = 100,
                 driverstore: int | None = None, nsv: int = 0,
                 ltempeq: bool = True, lmoist: bool = False, device="cuda",
                 rows: slice | None = None):
        self.ddir = Path(ddir)
        self.jobnr = driverjobnr
        self.jtot, self.ktot = jtot, ktot
        self.dtype = dtype
        self.device = torch.device(device)
        self.nsv = nsv
        self.ltempeq, self.lmoist = ltempeq, lmoist
        self.rows = rows
        exp = f"{driverjobnr:03d}"
        t = np.frombuffer((self.ddir / f"tdriver_000.{exp}").read_bytes(),
                          "<f8")
        if driverstore:
            t = t[:driverstore]
        self.t_all = np.asarray(t)
        self.nt = len(t)
        self.chunk = min(max(int(chunk), 4), self.nt)
        self.n0: int | None = None   # current window start record
        self.refills = 0

    def _window(self, n0: int) -> DriverWindow:
        """Load records [n0, n0+chunk) into a DriverWindow on the device."""
        d = ycut_series(read_driver_files(
            self.ddir, self.jobnr, self.jtot, self.ktot,
            driverstore=self.chunk, start=n0, nsv=self.nsv,
            ltempeq=self.ltempeq, lmoist=self.lmoist), self.rows)
        self.refills += 1
        W, ny, nz = self.chunk, d["u"].shape[1], self.ktot
        kw = dict(dtype=self.dtype, device=self.device)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), **kw)
        zero = lambda: torch.zeros((W, ny, nz), **kw)
        win = DriverWindow(
            t=t(d["t"]), u=t(d["u"]), v=t(d["v"]), w=t(d["w"]),
            thl=t(d["thl"]) if "thl" in d else zero(),
            qt=t(d["qt"]) if "qt" in d else zero(),
            sv=(t(d["sv"]) if "sv" in d
                else torch.zeros((W, 0, ny, nz), **kw)))
        trace.add_bytes(sum(a.numel() * a.element_size() for a in (
            win.t, win.u, win.v, win.w, win.thl, win.qt, win.sv)))
        return win

    def _pick_n0(self, timee: float) -> int:
        idx = int(np.searchsorted(self.t_all, timee, side="right")) - 1
        return int(np.clip(idx - 1, 0, self.nt - self.chunk))

    def ensure(self, state):
        """Return `state` with a window covering `state.timee` (+ margin);
        loads a fresh chunk only when the time has crossed the window.  A
        State without a window (a cold or warm start) gets the window of
        its own time, whatever this stream served before.  Called between
        steps (host-side; the comparison waits for timee)."""
        with trace.span("driver.ensure"):
            with trace.span("driver.wait"):
                timee = float(state.timee)
            if self.n0 is not None and state.drv is not None:
                hi = min(self.n0 + self.chunk - 2, self.nt - 2)
                if timee < self.t_all[hi] or self.n0 >= self.nt - self.chunk:
                    return state
            self.n0 = self._pick_n0(timee)
            with trace.span("driver.refill"):
                return state.replace(drv=self._window(self.n0))
