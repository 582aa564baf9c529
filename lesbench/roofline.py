"""The yardstick of the kernels' roofline shares: the card's published peak
and the least bytes each hand-written kernel must move.  Frozen here, so
that a change to the program cannot move it."""
from __future__ import annotations

# NVIDIA H100 SXM 80 GB: HBM3 at 3.35 TB/s (NVIDIA's data sheet, at the
# full 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12


def fused_diff_mom_least_bytes(shape, itemsize: int, masked: bool) -> int:
    """Bytes the SGS momentum diffusion must move at grid `shape`: each
    input (the ghosted u, v, ekm, w, and the three ghosted fluid masks when
    `masked`) read once and each output (du, dv, dw) written once; the
    metric vectors are left out as negligible."""
    nx, ny, nz = shape
    cell = (nx + 2) * (ny + 2) * (nz + 2)
    face = (nx + 2) * (ny + 2) * (nz + 1)
    reads = 3 * cell + face + (3 * cell if masked else 0)
    writes = 2 * nx * ny * nz + nx * ny * (nz + 1)
    return itemsize * (reads + writes)
