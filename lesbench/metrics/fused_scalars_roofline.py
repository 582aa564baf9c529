"""fused_scalars_roofline: the scalar-stack kernel's share of its memory
roofline, in %.  The least bytes it must move at the cell's shape (frozen
here, so that a change to the program cannot move it) over the card's
3.35 TB/s, divided by its mean device time a launch; from the device
operations of the traced call whose name holds ``fused_scalars``.  None
where the call has none (a program without the kernel, or a cell without
scalars)."""
from __future__ import annotations

from lesbench.roofline import PEAK_BYTES_PER_S
from lesbench.spans import _span


def least_bytes(shape, itemsize: int) -> int:
    """Bytes the kappa advection and masked diffusion of a stack of three
    scalars must move at grid `shape` (as the only cell with scalars runs
    it): the three scalars, ekh and the c mask read once at the cell
    centres, u at its nx + 1 x-faces, v at its ny + 1 y-faces, w at faces
    1..nz, and the three tendencies written once, all at their interior
    sizes; the metric vectors are left out as negligible."""
    nx, ny, nz = shape
    return itemsize * (11 * nx * ny * nz + nx * nz + ny * nz)


def read(ctx):
    span = _span(ctx)
    if span is None:
        return None
    ops = [v for name, v in span["ops"].items() if "fused_scalars" in name]
    seconds = sum(s for s, _ in ops)
    launches = sum(n for _, n in ops)
    if launches == 0 or seconds <= 0:
        return None
    least = least_bytes(ctx["shape"], ctx["itemsize"])
    return 100.0 * (least / PEAK_BYTES_PER_S) / (seconds / launches)
