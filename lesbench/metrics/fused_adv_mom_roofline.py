"""fused_adv_mom_roofline: the advection kernel's share of its memory
roofline, in %.  The least bytes it must move at the cell's shape (frozen
here, so that a change to the program cannot move it) over the card's
3.35 TB/s, divided by its mean device time a launch; from the device
operations of the traced call whose name holds ``fused_adv_mom``.  None
where the call has none (a program without the kernel)."""
from __future__ import annotations

from lesbench.roofline import PEAK_BYTES_PER_S
from lesbench.spans import _span


def least_bytes(shape, itemsize: int) -> int:
    """Bytes cd2 advection of u, v, w and thl with the pressure-gradient
    terms must move at grid `shape`: each input (the ghosted u, v, thl and
    w, the pressure padded in x and y) read once and each output (du, dv,
    dthl, dw) written once; the metric vectors are left out as
    negligible."""
    nx, ny, nz = shape
    cell = (nx + 2) * (ny + 2) * (nz + 2)
    face = (nx + 2) * (ny + 2) * (nz + 1)
    pcell = (nx + 2) * (ny + 2) * nz
    reads = 3 * cell + face + pcell
    writes = 3 * nx * ny * nz + nx * ny * (nz + 1)
    return itemsize * (reads + writes)


def read(ctx):
    span = _span(ctx)
    if span is None:
        return None
    ops = [v for name, v in span["ops"].items() if "fused_adv_mom" in name]
    seconds = sum(s for s, _ in ops)
    launches = sum(n for _, n in ops)
    if launches == 0 or seconds <= 0:
        return None
    least = least_bytes(ctx["shape"], ctx["itemsize"])
    return 100.0 * (least / PEAK_BYTES_PER_S) / (seconds / launches)
