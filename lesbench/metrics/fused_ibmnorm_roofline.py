"""fused_ibmnorm_roofline: the ibmnorm kernel's share of its memory
roofline, in %.  The least bytes it must move at the cell's shape (frozen
here, so that a change to the program cannot move it) over the card's
3.35 TB/s, divided by its mean device time a launch; from the device
operations of the traced call whose name holds ``fused_ibmnorm``.  None
where the call has none (a program without the kernel)."""
from __future__ import annotations

from lesbench.roofline import PEAK_BYTES_PER_S
from lesbench.spans import _span


def least_bytes(shape, itemsize: int) -> int:
    """Bytes the velocity and thl part of ibmnorm must move at grid
    `shape`, with the solid fill of thl and the liberal cd2 correction (as
    every cell runs it): each input (du, dv, dw, m.u, m.v, m.w, the u, v, w
    and c masks, m.thl, dthl, c.thl, c.u, c.v, c.w) read once and each
    output (du, dv, dw, m.u, m.v, m.w, m.thl, dthl) written once, at its
    interior size; the metric vectors are left out as negligible."""
    nx, ny, nz = shape
    cell = nx * ny * nz
    face = nx * ny * (nz + 1)
    reads = 12 * cell + 4 * face
    writes = 6 * cell + 2 * face
    return itemsize * (reads + writes)


def read(ctx):
    span = _span(ctx)
    if span is None:
        return None
    ops = [v for name, v in span["ops"].items() if "fused_ibmnorm" in name]
    seconds = sum(s for s, _ in ops)
    launches = sum(n for _, n in ops)
    if launches == 0 or seconds <= 0:
        return None
    least = least_bytes(ctx["shape"], ctx["itemsize"])
    return 100.0 * (least / PEAK_BYTES_PER_S) / (seconds / launches)
