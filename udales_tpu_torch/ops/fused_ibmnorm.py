"""The ibmnorm leaf: the hand-written CUDA kernel and its wrapper.

The masked velocities and their tendencies, the solid fill of thl (value
and tendency) and the liberal cd2 correction of thl in one pass over the
grid (``udales_tpu_torch/csrc/fused_ibmnorm.cu``, built and bound by
``ops/kernel.py``, without FMA contraction).  It replaces no Pallas kernel:
the leaf's ~110 whole-field torch operations a substep ran at about 6% of
its memory bound on the H100.

What bounds it is bytes: per point it reads 16 fields and writes 8.  The
design is ``fused_vreman``'s plane ring (the source's note has it).  The
plain route is ``IBM.ibmnorm_uvw_thl``.  The kernel follows what it can
observe: the dtype; without ltempeq it masks the velocities alone; the
correction is taken where the plain route takes it (cd2 thl, not
``lconservativeibm``); on one process it wraps x and y in its own indexing,
and on a rank of a split (``ibm.mesh``) it reads the scalar fields with the
one-cell ring of the mesh's exchange, stacked into one.

`ibmnorm` is ``IBM.ibmnorm`` with that part sent through the wrapper: the
call of the substep.  The conservative correction and qt stay on the torch
route (``IBM.ibmnorm_finish``), and so does the passive scalars' fill
(``IBM.fill_scalars``), which the substep runs in its own leaf.
"""
from __future__ import annotations

import torch

from .. import trace
from ..config import IADV_CD2, Config
from .kernel import CSRC, NVCC_FLAGS, HandKernel, check_inputs

SOURCE = CSRC / "fused_ibmnorm.cu"
# added to the shared flags: no FMA contraction, so that each product and
# sum rounds as the plain route's
NO_FMA = ("--fmad=false",)
_METRICS = ("dzf_g", "dzhi", "dzfi5")


def variant(cfg: Config):
    """(thl, corr): whether the kernel fills thl (ltempeq) and whether it
    adds the liberal cd2 correction (as ``IBM.ibmnorm_uvw_thl``)."""
    thl = cfg.physics.ltempeq
    corr = (thl and cfg.iadv_thl == IADV_CD2
            and not cfg.physics.lconservativeibm)
    return thl, corr


def least_bytes(shape, itemsize: int, thl: bool, corr: bool) -> int:
    """Bytes the leaf must move at grid `shape`: each input read once and
    each output written once, at its interior size.  The velocities: du,
    dv, dw, m.u, m.v, m.w and the masks M.u, M.v, M.w in, the six masked
    fields out; with `thl` m.thl, dthl and the c mask in, m.thl and dthl
    out; with `corr` c.thl, c.u, c.v and c.w in.  Over the card's memory
    rate this is the kernel's bound; the metric vectors are left out as
    negligible."""
    nx, ny, nz = shape
    cell, face = nx * ny * nz, nx * ny * (nz + 1)
    n = 10 * cell + 5 * face
    if thl:
        n += 5 * cell
    if corr:
        n += 3 * cell + face
    return itemsize * n


class FusedIbmnorm(HandKernel):
    """``fused_ibmnorm(c, m, du, dv, dw, dthl, thl_vmean, ibm)``: (du, dv,
    dw, dthl, m.u, m.v, m.w, m.thl), new tensors, as
    ``ibm.ibmnorm_uvw_thl`` returns them; `thl_vmean` is a 0-d tensor.
    Without ltempeq dthl and m.thl pass through.

    ``launch_count`` counts launches (the trace's
    ``fused_ibmnorm.launches``)."""

    name = "fused_ibmnorm"
    source = SOURCE
    flags = NVCC_FLAGS + NO_FMA
    signatures = dict.fromkeys(("fused_ibmnorm_f32", "fused_ibmnorm_f64"),
                               "p" * 28 + "i" * 4 + "d" * 2 + "p")
    launch_count = trace.counter("fused_ibmnorm.launches")

    def inputs(self, c, m, du, dv, dw, dthl, thl_vmean, ibm):
        nx, ny, nz = ibm.grid.shape
        cell, face = (nx, ny, nz), (nx, ny, nz + 1)
        M = ibm.masks
        inputs = [("du", du, cell), ("dv", dv, cell), ("dw", dw, face),
                  ("m.u", m.u, cell), ("m.v", m.v, cell), ("m.w", m.w, face),
                  ("masks.u", M.u, cell), ("masks.v", M.v, cell),
                  ("masks.w", M.w, face)]
        thl, corr = variant(ibm.cfg)
        if thl:
            inputs += [("m.thl", m.thl, cell), ("dthl", dthl, cell),
                       ("pmask_c", ibm.pmask_c, (nx + 2, ny + 2, nz + 2)),
                       ("thl_vmean", thl_vmean, ())]
        if corr:
            inputs += [("c.thl", c.thl, cell), ("c.u", c.u, cell),
                       ("c.v", c.v, cell), ("c.w", c.w, face)]
        return inputs

    def plain(self, c, m, du, dv, dw, dthl, thl_vmean, ibm):
        return ibm.ibmnorm_uvw_thl(c, m, du, dv, dw, dthl, thl_vmean)

    def launch(self, c, m, du, dv, dw, dthl, thl_vmean, ibm):
        grid, M = ibm.grid, ibm.masks
        check_inputs(self.name, grid,
                     self.inputs(c, m, du, dv, dw, dthl, thl_vmean, ibm))
        nx, ny, nz = grid.shape
        dtype, dev = du.dtype, du.device
        thl, corr = variant(ibm.cfg)
        ring = thl and ibm.mesh is not None
        outs = [torch.empty_like(t) for t in (du, dv, dw, m.u, m.v, m.w)]
        mthl_o = dthl_o = None
        # m.thl, dthl, c.thl, c.u, c.v as the kernel reads them
        scalars = [None] * 5
        if thl:
            mthl_o, dthl_o = torch.empty_like(m.thl), torch.empty_like(dthl)
            live = [m.thl, dthl] + ([c.thl, c.u, c.v] if corr else [])
            if ring:   # one exchange of the mesh for all of them
                live = ibm.mesh.wrap_xy(torch.stack(live), 1).unbind(0)
            scalars[:len(live)] = live
        metrics = ([grid.t(name, dev) for name in _METRICS] if corr
                   else [None] * 3)
        self.run("fused_ibmnorm", dtype, dev, du, dv, dw, m.u, m.v, m.w,
                 M.u, M.v, M.w, *scalars, c.w if corr else None,
                 ibm.pmask_c if thl else None, thl_vmean if thl else None,
                 *metrics, *outs, mthl_o, dthl_o, nx, ny, nz, int(ring),
                 grid.dxi5, grid.dyi5)
        self.launch_count += 1
        du, dv, dw, mu, mv, mw = outs
        if thl:
            dthl, mthl = dthl_o, mthl_o
        else:
            mthl = m.thl
        return du, dv, dw, dthl, mu, mv, mw, mthl


# The process-wide wrapper: `fused_ibmnorm(...)` is the call `ibmnorm`
# makes, `fused_ibmnorm.launch_count` the counter a run reads.
fused_ibmnorm = FusedIbmnorm()


def ibmnorm(ibm, c, m, du, dv, dw, dthl, thl_vmean, dqt=None, dsv=None):
    """``ibm.ibmnorm`` with its velocity and thl part through
    `fused_ibmnorm`: the kernel on the card, the plain
    ``ibm.ibmnorm_uvw_thl`` on the CPU; the rest on the torch route
    (``ibm.ibmnorm_finish``, ``ibm.fill_scalars``).  Returns what
    ``IBM.ibmnorm`` returns."""
    du, dv, dw, dthl, dqt, m = ibm.ibmnorm_finish(
        c, m, *fused_ibmnorm(c, m, du, dv, dw, dthl, thl_vmean, ibm), dqt)
    m, dsv = ibm.fill_scalars(m, dsv)
    return du, dv, dw, dthl, dqt, dsv, m
