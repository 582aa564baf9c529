"""The compiled step: one RK3 step of a Model as one captured CUDA graph
(port of udales_tpu's ``jax.jit(model.step)``, run.py:716-717, and of the
``lax.scan`` of ``Model.run``, run.py:709-714).

`CompiledStep(model)` keeps a static State ``S`` with the structure that
``model.step`` produces and, on the card, a ``torch.cuda.CUDAGraph`` of
``copy_into(S, model.step(S))`` with its own memory pool.  A call copies
the caller's State into ``S`` (unless it is ``S``) and replays the graph
once: the step's ~2,000-6,500 launches become one, and the arithmetic is
the eager step's, kernel for kernel.  Each of the three hand-written
kernels (``ops/kernel.py``) is a kernel node of the graph at each of its
launches: ``fused_adv_mom`` and ``fused_diff_mom`` three a step, and
``fused_vreman`` three or four on a Vreman case.

The first call, and a call with a State of another structure (a part that
is None in one and set in the other, other shapes or dtypes), builds: one
eager step of the caller's State on a side stream, which is also the
warm-up (it fills ``Grid.t``'s tensors, the inlet generator's profiles,
the nudging profiles, the cuFFT plans and the cuBLAS/cuSOLVER handles, and
builds the kernel library), its result cloned into a new ``S``, then the
capture.  The first call's State is that eager step's, so a chain of calls
runs the same steps as ``model.step``.  A capture that fails raises; there
is no eager fallback on the card.

On the CPU, where CUDA graphs do not exist, a call runs the same
``copy_into(S, model.step(S))`` body eagerly, so the CPU tests hold the
compiled step's State handling against ``Model.step`` bit for bit.

What a caller may hold: the State a call returns is ``S`` itself and stays
valid until the next call of the same CompiledStep, which overwrites it in
place.  The State a caller passes in is never written.  A caller that
keeps a State across calls keeps a copy (``state.map(torch.clone)``);
``Model.run(..., graph=True)`` and ``sim.Simulation.run`` hand back such a
copy.  Host work between calls (``DriverStream.ensure``, the writers of
``Simulation``) reads ``S`` after the replay that wrote it and before the
next one, on the same stream.

Every count and byte counter of the run's trace (``trace``: among them
the hand kernels' launch counters and a split Model's ``Mesh.collectives``
and ``Mesh.bytes``) counts executions: what the capture recorded is taken
back at the end of the capture, and each replay adds it again, so
"launches = 3 x steps" and the collectives a step hold for a captured run
as for an eager one; ``per_replay`` gives what one replay adds, by counter
name (``per_replay["fused_diff_mom.launches"]``).  The body is a device
step of the trace (the leaves of ``Model.step`` and ``copy``, the copy into
``S``): its events are nodes of the graph, so each replay times its leaves
on the card (``trace.device_ms``).
A call is the host span ``graph.replay``, a build ``graph.capture``.

A Model split over a mesh (``parallel.mesh``, the counterpart of
udales_tpu's ``jax.jit(model.step)`` of a sharded Model) compiles the same
way when its mesh is capturable (NCCL, or gloo on the CPU): the graph holds
the step's collectives as stream operations of NCCL's communicators.  The
build is collective: every rank builds at the same call, since
``parallel.mesh._leaf_spec`` gives every rank the same leaves, so a State
of another structure is another structure on every rank; the warm-up step
runs every collective of the step, in the capture's order, so it creates
the communicator of every group the capture uses (the world, x-row and
y-column groups; ``from_owner`` and ``axis_sum`` on the open-boundary and
generator paths) before the capture, which must create none.  The capture
takes the thread-local error mode: NCCL's watchdog thread queries events
of earlier collectives while it runs.  A host-staged mesh (gloo on CUDA
tensors) waits on the host in every exchange, which a graph cannot hold:
``CompiledStep`` raises NotImplementedError there, on the card and on the
CPU alike, and nothing falls back to the eager step.  The graph holds
NCCL's communicators: free it before ``dist.destroy_process_group()``
(the Model and its compiled step refer to each other, so drop both and
``gc.collect()``); destroying the group under a live graph can hang.
"""
from __future__ import annotations

import time

import torch

from . import trace
from .state import State, copy_into, same_structure


class CompiledStep:
    """One RK3 step of `model` as a replayed CUDA graph (an eager body on
    the CPU); call it as ``model.step``.  ``builds`` counts the builds
    (captures on the card), ``capture_seconds`` the seconds of the last
    one, warm-up step included, and ``replays`` the calls since."""

    builds = trace.counter("graph.builds")

    def __init__(self, model):
        if model.mesh is not None and not model.mesh.capturable:
            raise NotImplementedError(
                "the compiled step of a Model split over a host-staged mesh: "
                "its gloo exchanges go through pinned host memory and wait "
                "on the host, which a CUDA graph cannot hold; step it with "
                "model.step, or split over NCCL (one rank a card)")
        self.model = model
        self.state: State | None = None     # the static State S
        self.graph: torch.cuda.CUDAGraph | None = None
        self.builds = 0
        self.replays = 0
        self.capture_seconds = 0.0
        # what one replay adds to the trace's counters, and its timeline
        self._delta, self._timeline = [], None

    @property
    def per_replay(self) -> dict:
        """What one replay adds to each count and byte counter of the
        trace, by name."""
        out = {}
        for _, name, n in self._delta:
            out[name] = out.get(name, 0) + n
        return out

    @property
    def collectives_per_replay(self) -> tuple:
        """A split Model's (collectives, bytes) in one replay; (0, 0)
        without a mesh."""
        pr = self.per_replay
        return (pr.get("mesh.collectives", 0), pr.get("mesh.bytes", 0))

    @property
    def kind(self) -> str:
        """How a call steps: "cuda graph" on the card, "eager body" on the
        CPU."""
        return "cuda graph" if self.model.device.type == "cuda" \
            else "eager body"

    def _body(self, S: State):
        """``copy_into(S, model.step(S))`` as one device step of the trace."""
        with trace.device_step("graph.body", self.model.device):
            out = self.model.step(S)
            trace.leaf("copy")
            copy_into(S, out)

    def __call__(self, state: State) -> State:
        S = self.state
        if S is None or (state is not S and not same_structure(S, state)):
            return self._build(state)
        with trace.span("graph.replay"):
            if state is not S:
                copy_into(S, state)
            if self.graph is None:
                self._body(S)
            else:
                self.graph.replay()
                trace.REGISTRY.replay(self._delta)
                trace.REGISTRY.replayed(self._timeline)
        self.replays += 1
        return S

    def _build(self, state: State) -> State:
        """One eager step of `state` into a new static State, then (on the
        card) the capture of the step on it; returns the static State."""
        model = self.model
        t0 = time.perf_counter()
        self.graph = None
        self.state = None
        with trace.span("graph.capture"):
            if model.device.type != "cuda":
                self.state = model.step(state).map(torch.clone)
            else:
                self.state = self._capture(state)
        self.builds += 1
        self.replays = 0
        self.capture_seconds = time.perf_counter() - t0
        return self.state

    def _capture(self, state: State) -> State:
        model = self.model
        cur = torch.cuda.current_stream(model.device)
        side = torch.cuda.Stream(model.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = model.step(state)            # the warm-up
        cur.wait_stream(side)
        S = out.map(torch.clone)
        # `out` lives in the side stream's blocks: free them only after the
        # clones have read them
        torch.cuda.synchronize(model.device)
        del out
        graph = torch.cuda.CUDAGraph()
        # the capture records the step's launches and collectives; none ran
        mark = trace.REGISTRY.checkpoint()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._body(S)
        finally:
            delta = trace.REGISTRY.take_back(mark)
        self._delta, self._timeline = delta, trace.REGISTRY.captured
        self.graph = graph
        return S
