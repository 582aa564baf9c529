"""Process mesh for the x/y split (port of ``udales_tpu.parallel.mesh``).

The reference decomposes the domain over an nprocx x nprocy MPI process grid
(2DECOMP z-pencils, modmpi.f90).  udales_tpu places every field on a JAX
device mesh and lets GSPMD write the communication.  PyTorch has no such
partitioner, so here every rank is one process that holds its (itot/px,
jtot/py, ktot) block of each field, and each exchange is a
``torch.distributed`` collective written out on the `Mesh`:

  - ``wrap``: the periodic halo of width h along a split axis, from the two
    neighbours in the rank's x row or y column (one ``all_to_all_single``);
  - ``halo_hi``: the high-side halo alone (the next rank's first faces of
    the projection's divergence at an open boundary);
  - ``allreduce_sum`` / ``allreduce_max``: the slab means and the dt limit;
  - ``axis_sum``: a sum over the rank's x row or y column only (the y
    means of the inlet generator); ``from_owner``: the tensors of one rank
    of the row or column on every rank of it (a plane at a global x index,
    the outlet planes of the domain's last block), an all-reduce in which
    every other rank adds zeros;
  - ``to_ypencil`` / ``to_xpencil`` and their inverses: the transposes of
    the Poisson solve, z-pencils (x/px, y/py, z) -> y-pencils (x/px, y,
    z/py) -> x-pencils (x, y/px, z/py), ``all_to_all_single`` in the column
    or row group.

A mesh of one rank still goes through the collectives.  With
``host_staged`` (the gloo backend on CUDA tensors: ranks that share one
card, where NCCL takes one rank per device) every exchange buffer is copied
to pinned host memory and back, explicitly.  Rank r sits at (cx, cy) =
divmod(r, py), the row-major order of udales_tpu's ``make_mesh``.

A CUDA graph can hold the collectives of a mesh that is not host-staged
(``Mesh.capturable``): NCCL's are operations on the card's streams, which a
capture records and a replay runs again, with no host wait; gloo on CPU
tensors has no graph to hold them.  ``collectives`` and ``bytes`` count
executions: ``graph.CompiledStep`` takes back what a capture recorded and
adds it again at each replay.

``shard_state`` / ``gather_state`` cut a whole-domain State into this rank's
blocks and put it back together; ``_leaf_spec`` says how each State leaf is
split, with udales_tpu's table: the fields and the passive-scalar stack
along x and y, the outlet planes along their one lateral axis (``bx``
along y, ``by`` along x; whole along the other, every rank of the row or
column holding the same planes), the driver window along y, the inlet
generator's planes along y and its ``Utav`` along x, the facet state and
its statistics whole on every rank.
``IBM.load(..., mesh=)`` and the block constructors of ``physics.py`` cut
the static geometry the same way.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch
import torch.distributed as dist

from .. import trace
from ..state import map_state

@contextmanager
def _host_wait_allowed():
    """Lift ``torch.cuda.set_sync_debug_mode`` around a host-staged
    collective, whose host waits are the collective itself."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class Mesh:
    """An nprocx x nprocy process mesh over the initialized default process
    group: this rank's (cx, cy), the process groups of its x row (the px
    ranks that share cy) and y column (the py ranks that share cx), and the
    collectives of the split.

    ``collectives``, ``bytes`` (sent by this rank), and for host-staged
    exchanges ``wait_seconds`` (host waits for the card's queue before each
    copy out) and ``comm_seconds`` (the host copy, the backend call and the
    copy back issued) count since ``reset_counts``; they are counters of the
    run's trace (``mesh.<name>``)."""

    axis_names = ("x", "y")
    collectives = trace.counter("mesh.collectives")
    bytes = trace.counter("mesh.bytes")
    wait_seconds = trace.counter("mesh.wait_seconds")
    comm_seconds = trace.counter("mesh.comm_seconds")

    def __init__(self, nprocx: int, nprocy: int, host_staged: bool = False):
        if not dist.is_initialized():
            raise RuntimeError("make_mesh needs an initialized process group "
                               "(parallel.multihost.init_distributed)")
        world = dist.get_world_size()
        if world != nprocx * nprocy:
            raise ValueError(f"a {nprocx} x {nprocy} mesh needs world_size "
                             f"{nprocx * nprocy}, the group has {world}")
        self.backend = dist.get_backend()
        if host_staged and self.backend != "gloo":
            raise ValueError(f"host_staged needs the gloo backend, the group "
                             f"runs {self.backend}")
        self.px, self.py = nprocx, nprocy
        self.host_staged = host_staged
        self.rank = dist.get_rank()
        self.cx, self.cy = divmod(self.rank, nprocy)
        # new_group is collective: every rank makes every group, in one order
        self.xgroup = self.ygroup = None
        for cy in range(nprocy):
            g = dist.new_group([cx * nprocy + cy for cx in range(nprocx)])
            if cy == self.cy:
                self.xgroup = g
        for cx in range(nprocx):
            g = dist.new_group([cx * nprocy + cy for cy in range(nprocy)])
            if cx == self.cx:
                self.ygroup = g
        self.reset_counts()

    @property
    def shape(self):
        return (self.px, self.py)

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this mesh's collectives: not when
        they are host-staged, since each then waits on the host for the
        card's queue and for the backend."""
        return not self.host_staged

    def reset_counts(self):
        self.collectives = 0
        self.bytes = 0
        self.wait_seconds = 0.0
        self.comm_seconds = 0.0

    # -- the backend call ---------------------------------------------------
    def _run(self, fn, send, recv):
        """fn(recv, send) through the backend, `recv` filled in place (it may
        be `send`).  Host-staged CUDA tensors go through pinned host
        buffers."""
        self.collectives += 1
        self.bytes += send.numel() * send.element_size()
        if not (self.host_staged and send.is_cuda):
            fn(recv, send)
            return recv
        with _host_wait_allowed():
            t0 = time.perf_counter()
            hs = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
            hs.copy_(send, non_blocking=True)
            torch.cuda.current_stream(send.device).synchronize()
            t1 = time.perf_counter()
            hr = hs if recv is send else torch.empty(
                recv.shape, dtype=recv.dtype, pin_memory=True)
            fn(hr, hs)
            recv.copy_(hr, non_blocking=True)
            t2 = time.perf_counter()
        self.wait_seconds += t1 - t0
        self.comm_seconds += t2 - t1
        return recv

    def _alltoall(self, send, in_rows, out_rows, group):
        """all_to_all_single along dim 0 of `send` within `group`: rows
        in_rows[p] go to group rank p, out_rows[p] come from it.  Complex
        tensors travel as their real view."""
        cplx = send.is_complex()
        s = torch.view_as_real(send) if cplx else send
        s = s.contiguous()
        recv = s.new_empty((sum(out_rows), *s.shape[1:]))
        self._run(lambda r, x: dist.all_to_all_single(
            r, x, list(out_rows), list(in_rows), group=group), s, recv)
        return torch.view_as_complex(recv) if cplx else recv

    def _axis(self, axis: str):
        if axis == "x":
            return self.px, self.cx, self.xgroup
        if axis == "y":
            return self.py, self.cy, self.ygroup
        raise ValueError(f"mesh axis {axis!r}: expected 'x' or 'y'")

    # -- halos ----------------------------------------------------------------
    def wrap(self, f, dim: int, h: int, axis: str):
        """Periodic pad of width `h` along `dim` of this rank's block, which
        the mesh splits along `axis`: the low ghosts are the last h planes of
        the left neighbour in the row (column), the high ghosts the first h
        of the right one; on one rank, its own (``halo.pad_wrap``)."""
        n, c, group = self._axis(axis)
        dim = dim % f.ndim
        if f.shape[dim] < h:
            raise ValueError(f"wrap: a block of {f.shape[dim]} planes along "
                             f"dim {dim} cannot fill a halo of {h}")
        first = f.narrow(dim, 0, h).movedim(dim, 0)
        last = f.narrow(dim, f.shape[dim] - h, h).movedim(dim, 0)
        left, right = (c - 1) % n, (c + 1) % n
        # to rank p: its low ghosts if p is on the right, its high ghosts if
        # p is on the left (both when n <= 2); received in the same order
        parts, rows = [], []
        for p in range(n):
            chunk = ([last] if p == right else []) + \
                ([first] if p == left else [])
            parts += chunk
            rows.append(h * len(chunk))
        recv = self._alltoall(torch.cat(parts), rows, rows, group)
        off, lo, hi = 0, None, None
        for q in range(n):
            if q == left:
                lo, off = recv[off: off + h], off + h
            if q == right:
                hi, off = recv[off: off + h], off + h
        return torch.cat([lo.movedim(0, dim), f, hi.movedim(0, dim)],
                         dim=dim)

    def wrap_xy(self, f, h: int = 1):
        """The periodic wrap pad of width h of axes -3 (x) and -2 (y): x
        first, then y over the x-padded block, so the corners come out as
        the single-device ``pad_wrap(pad_wrap(f, -3, h), -2, h)``."""
        return self.wrap(self.wrap(f, -3, h, "x"), -2, h, "y")

    def halo_hi(self, f, dim: int, h: int, axis: str):
        """The first h planes along `dim` of the next rank in the row
        (column), periodically: the high-side half of `wrap`."""
        n, c, group = self._axis(axis)
        dim = dim % f.ndim
        first = f.narrow(dim, 0, h).movedim(dim, 0)
        left, right = (c - 1) % n, (c + 1) % n
        send = [h if p == left else 0 for p in range(n)]
        recv = [h if p == right else 0 for p in range(n)]
        return self._alltoall(first, send, recv, group).movedim(0, dim)

    # -- reductions -------------------------------------------------------------
    def allreduce_sum(self, t):
        """Sum of `t` over every rank (t is overwritten and returned)."""
        t = t.contiguous()
        return self._run(lambda r, x: dist.all_reduce(r), t, t)

    def allreduce_parts(self, parts):
        """`allreduce_sum` of every tensor of the list `parts` (any shapes,
        one dtype) in one collective; returns the summed tensors in their
        shapes."""
        flat = self.allreduce_sum(torch.cat([p.reshape(-1) for p in parts]))
        return [t.view(p.shape) for p, t in zip(
            parts, flat.split([p.numel() for p in parts]))]

    def axis_sum(self, parts, axis: str):
        """`allreduce_parts` over the rank's x row (`axis` "x") or y column
        ("y") only."""
        _, _, group = self._axis(axis)
        flat = torch.cat([p.reshape(-1) for p in parts])
        self._run(lambda r, x: dist.all_reduce(r, group=group), flat, flat)
        return [t.view(p.shape) for p, t in zip(
            parts, flat.split([p.numel() for p in parts]))]

    def from_owner(self, parts, owner: int, axis: str):
        """The tensors `parts` of the rank at position `owner` of this
        rank's x row (`axis` "x": the rank with cx == owner) or y column,
        on every rank of it; the other ranks' `parts` give only shapes.  One
        all-reduce in which they add zeros, so the owner's values arrive
        exactly."""
        _, c, _ = self._axis(axis)
        if c != owner:
            parts = [torch.zeros(p.shape, dtype=p.dtype, device=p.device)
                     for p in parts]
        return self.axis_sum(parts, axis)

    def allreduce_max(self, t):
        """Max of `t` over every rank (t is overwritten and returned)."""
        t = t.contiguous()
        return self._run(lambda r, x: dist.all_reduce(
            r, op=dist.ReduceOp.MAX), t, t)

    # -- Poisson transposes -----------------------------------------------------
    def to_ypencil(self, f):
        """z-pencil (a, b, nz) -> y-pencil (a, py b, nz/py) in the column."""
        n = self.py
        a, b, c = f.shape
        send = f.reshape(a, b, n, c // n).permute(2, 0, 1, 3)
        rows = [a * b] * n
        recv = self._alltoall(send.reshape(n * a * b, c // n), rows, rows,
                              self.ygroup).reshape(n, a, b, c // n)
        return recv.permute(1, 0, 2, 3).reshape(a, n * b, c // n)

    def from_ypencil(self, f):
        """Inverse of `to_ypencil`: (a, B, C) -> (a, B/py, py C)."""
        n = self.py
        a, B, C = f.shape
        send = f.reshape(a, n, B // n, C).permute(1, 0, 2, 3)
        rows = [a] * n
        recv = self._alltoall(send.reshape(n * a, B // n, C), rows, rows,
                              self.ygroup).reshape(n, a, B // n, C)
        return recv.permute(1, 2, 0, 3).reshape(a, B // n, n * C)

    def to_xpencil(self, f):
        """y-pencil (a, B, C) -> x-pencil (px a, B/px, C) in the row."""
        n = self.px
        a, B, C = f.shape
        send = f.reshape(a, n, B // n, C).permute(1, 0, 2, 3)
        rows = [a] * n
        recv = self._alltoall(send.reshape(n * a, B // n, C), rows, rows,
                              self.xgroup)
        return recv.reshape(n * a, B // n, C)

    def from_xpencil(self, f):
        """Inverse of `to_xpencil`: (A, b, C) -> (A/px, px b, C)."""
        n = self.px
        A, b, C = f.shape
        rows = [A // n] * n
        recv = self._alltoall(f, rows, rows, self.xgroup)
        recv = recv.reshape(n, A // n, b, C)
        return recv.permute(1, 0, 2, 3).reshape(A // n, n * b, C)

    # -- whole leaves -------------------------------------------------------------
    def gather(self, t, spec):
        """The whole-domain tensor of which `t` is this rank's block under
        `spec` (a `_leaf_spec`), on every rank."""
        if "x" not in spec and "y" not in spec:
            return t
        if "x" not in spec or "y" not in spec:
            # split along one axis, the same on every rank of the other
            axis = "x" if "x" in spec else "y"
            n, _, group = self._axis(axis)
            send = t.contiguous()
            recv = send.new_empty((n, *send.shape))
            self._run(lambda r, x: dist.all_gather(list(r.unbind(0)), x,
                                                   group=group), send, recv)
            return torch.cat(list(recv.unbind(0)), dim=spec.index(axis))
        send = t.contiguous()
        world = self.px * self.py
        recv = send.new_empty((world, *send.shape))
        self._run(lambda r, x: dist.all_gather(list(r.unbind(0)), x),
                  send, recv)
        dx, dy = spec.index("x"), spec.index("y")
        rows = [torch.cat([recv[cx * self.py + cy] for cy in range(self.py)],
                          dim=dy) for cx in range(self.px)]
        return torch.cat(rows, dim=dx)

    def block_slices(self, spec, shape):
        """The slices of this rank's block of a `shape` leaf under
        `spec`."""
        out = []
        for name, n in zip(spec, shape):
            if name is None:
                out.append(slice(None))
                continue
            parts, c = (self.px, self.cx) if name == "x" else (self.py,
                                                               self.cy)
            if n % parts:
                raise ValueError(f"a leaf of shape {tuple(shape)} does not "
                                 f"split {parts} ways along {name}")
            out.append(slice(c * (n // parts), (c + 1) * (n // parts)))
        return tuple(out) + (slice(None),) * (len(shape) - len(spec))


def make_mesh(nprocx: int, nprocy: int, host_staged: bool = False) -> Mesh:
    """The nprocx x nprocy mesh over the default process group, whose
    world size must be nprocx * nprocy."""
    return Mesh(nprocx, nprocy, host_staged=host_staged)


def field_spec(ndim: int, leading_batch: bool = False) -> tuple:
    """Axis names of a field: (nx, ny, ...) -> ("x", "y", None, ...);
    scalars and profiles stay whole (``()``)."""
    if ndim >= 3 and leading_batch:
        return (None, "x", "y", *([None] * (ndim - 3)))
    if ndim >= 2:
        return ("x", "y", *([None] * (ndim - 2)))
    return ()


def _leaf_spec(path, leaf) -> tuple:
    """How one State leaf is split, as udales_tpu's table gives it
    (``udales_tpu/parallel/mesh.py`` ``_leaf_spec``): the fields of ``c``,
    ``m``, ``pres`` and the ``taud`` diagnostics along x and y, the scalar
    stack ``sv`` (nsv, nx, ny, nz) along its x and y axes; the x outlet
    planes ``bx`` ((ny, nz[+1]), sv (nsv, ny, nz)) along y and the y outlet
    planes ``by`` along x; the driver window ``drv`` along y, never along
    its record axis (``t`` whole); the inlet generator's planes ``ig.u0``,
    ``v0``, ``w0``, ``t0`` along y and ``ig.Utav`` along x, its profiles and
    scalars whole; the facet state ``fac`` and the ``facstats``
    accumulators whole (every rank holds the same copy), ``dt``, ``timee``,
    ``ctl`` and the profiles whole."""
    names = [str(p) for p in path]
    nd = getattr(leaf, "ndim", 0)
    lateral = {"bx": "y", "by": "x", "drv": "y"}
    for part, axis in lateral.items():
        if part in names:
            if part == "drv" and nd == 4:       # sv: (W, nsv, ny, nz)
                return (None, None, "y", None)
            if nd == 3:
                return (None, axis, None)
            if nd == 2 and part != "drv":
                return (axis, None)
            return ()
    if "ig" in names:
        return {"u0": ("y", None), "v0": ("y", None), "w0": ("y", None),
                "t0": ("y", None), "Utav": ("x", None)}.get(names[-1], ())
    if "ctl" in names or "fac" in names or "facstats" in names:
        return ()
    if nd == 4:
        return field_spec(4, leading_batch=True)
    if nd >= 2:
        return field_spec(nd)
    return ()


def shard_state(state, mesh: Mesh):
    """This rank's block of every leaf of the whole-domain `state`, as fresh
    contiguous tensors on the leaves' device."""
    def cut(path, leaf):
        block = leaf[mesh.block_slices(_leaf_spec(path, leaf), leaf.shape)]
        return block.clone(memory_format=torch.contiguous_format)
    return map_state(cut, state)


def state_shardings(state, mesh: Mesh):
    """The pytree of this rank's block slices, leaf for leaf."""
    return map_state(lambda path, leaf: mesh.block_slices(
        _leaf_spec(path, leaf), leaf.shape), state)


def gather_state(state, mesh: Mesh):
    """The whole-domain State from every rank's blocks, on every rank (the
    counterpart of ``np.asarray`` on a sharded ``jax.Array``)."""
    return map_state(lambda path, leaf: mesh.gather(
        leaf, _leaf_spec(path, leaf)), state)
