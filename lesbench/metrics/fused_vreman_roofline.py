"""fused_vreman_roofline: the Vreman closure kernel's share of its memory
roofline, in %.  The least bytes it must move at the cell's shape (frozen
here, so that a change to the program cannot move it) over the card's
3.35 TB/s, divided by its mean device time a launch; from the device
operations of the traced call whose name holds ``fused_vreman``.  None
where the call has none (a program without the kernel)."""
from __future__ import annotations

from lesbench.roofline import PEAK_BYTES_PER_S
from lesbench.spans import _span


def least_bytes(shape, itemsize: int) -> int:
    """Bytes the Vreman closure must move at grid `shape`, without the
    buoyancy correction (which no cell runs): each input (the ghosted u, v
    and w) read once and each output (ekm, ekh) written once; the metric
    vectors are left out as negligible."""
    nx, ny, nz = shape
    cell = (nx + 2) * (ny + 2) * (nz + 2)
    face = (nx + 2) * (ny + 2) * (nz + 1)
    reads = 2 * cell + face
    writes = 2 * nx * ny * nz
    return itemsize * (reads + writes)


def read(ctx):
    span = _span(ctx)
    if span is None:
        return None
    ops = [v for name, v in span["ops"].items() if "fused_vreman" in name]
    seconds = sum(s for s, _ in ops)
    launches = sum(n for _, n in ops)
    if launches == 0 or seconds <= 0:
        return None
    least = least_bytes(ctx["shape"], ctx["itemsize"])
    return 100.0 * (least / PEAK_BYTES_PER_S) / (seconds / launches)
