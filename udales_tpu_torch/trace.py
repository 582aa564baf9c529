"""The run's own trace: named counters, host spans and the device spans of
the step, in one process-wide registry (`REGISTRY`).

Host spans.  ``with span(name):`` adds one call and its host seconds (two
``time.perf_counter`` reads) to the span's path, the names of the spans
open around it joined by ``/`` (``sim.outputs/tdump/write``); the
registry keeps sums, not events.  While a ``torch.profiler`` is recording,
and only then, a span also opens a record function of its path, so the
profiler's trace (the CLI's ``--profile``) carries the program's phases on
the clock of its device activities.  It is a function-scope record
(``_RecordFunctionFast``), a host range only: a user annotation
(``torch.profiler.record_function``) would also be drawn on the device's
timeline over the kernels launched inside it, as if it were a device
activity.  ``add_bytes(n)``
adds bytes to the innermost open span: the writers count there what they
are handed.

Device spans.  ``with device_step(name, device):`` around a step makes a
timeline: each ``leaf(name)`` inside it ends the leaf before it and starts
the next one, so the leaves partition the step and adjacent leaves share
one boundary.  On the card each boundary, and the step's end, is a
``torch.cuda.Event`` recorded on the current stream; inside a CUDA graph
capture these become event-record nodes of the graph (``external=True``),
so every replay times its own leaves on the device.  A leaf is a host span
as well (its path relative to the step is its name in the timeline:
``rk2/poisson``).  `device_ms` reads the last step that ran, eagerly or as
a replay (``graph.CompiledStep`` marks its timeline at each replay); it
waits for that step's last event when asked and never on the step's path.
On the CPU a timeline has its names and no events.

Counters.  `counter` is a descriptor for a counter that an object keeps
as an attribute (a Mesh's collectives, a driver stream's refills), held in
the registry, so that `snapshot` sums it by name over every instance, a
live one or not.  Names that end in ``_seconds`` hold seconds.

The compiled step records its body once, at the capture, and replays it:
`checkpoint` before the capture and `take_back` after it return the
registry to where it was and give what the body added; `replay` adds the
counts and bytes of that (not its seconds) once per replay, so a counter
bumped inside the step counts executions under replay as it does eagerly.
"""
from __future__ import annotations

import time

import torch

_perf = time.perf_counter


def _is_seconds(name: str) -> bool:
    return name.endswith("_seconds")


class _Timeline:
    """The leaves of one step: their paths, in order, and on the card one
    event per boundary plus the step's end (``len(names) + 1``)."""

    __slots__ = ("names", "events", "ran")

    def __init__(self):
        self.names, self.events, self.ran = [], None, False


class Registry:
    """Counters, host spans and device timelines of one process (see the
    module's text).  `REGISTRY` is the one the program writes."""

    def __init__(self):
        self.spans: dict[str, list] = {}     # path -> [calls, seconds, bytes]
        self.cells: list[dict] = []          # `counter` values, per object
        # open spans: [path, t0, record_function or None, is_leaf]
        self._stack: list[list] = []
        self._tl: _Timeline | None = None    # the timeline being recorded
        self._tl_base = 0                    # stack depth of its root
        self._tl_dev = self._pool_events = None
        self._pool: dict[int, list] = {}     # eager events, per card
        self.last: _Timeline | None = None   # the last step that ran
        self.captured: _Timeline | None = None

    # -- host spans --------------------------------------------------------
    def _open(self, name: str, leaf: bool):
        stack = self._stack
        path = f"{stack[-1][0]}/{name}" if stack else name
        rf = None
        if torch.autograd._profiler_enabled():
            rf = torch._C._profiler._RecordFunctionFast(path)
            rf.__enter__()
        stack.append([path, _perf(), rf, leaf])

    def _close(self):
        path, t0, rf, _ = self._stack.pop()
        dt = _perf() - t0
        if rf is not None:
            rf.__exit__(None, None, None)
        tot = self.spans.get(path)
        if tot is None:
            self.spans[path] = [1, dt, 0]
        else:
            tot[0] += 1
            tot[1] += dt

    def _close_leaf(self):
        if self._stack and self._stack[-1][3]:
            self._close()

    def add_bytes(self, n: int):
        """Add `n` bytes to the innermost open span (none open: dropped)."""
        if self._stack:
            path = self._stack[-1][0]
            tot = self.spans.get(path)
            if tot is None:
                self.spans[path] = tot = [0, 0.0, 0]
            tot[2] += int(n)

    # -- device spans ------------------------------------------------------
    def _start_timeline(self, device):
        tl = _Timeline()
        dev = torch.device(device)
        self._pool_events = None
        if dev.type == "cuda":
            tl.events = []
            if not torch.cuda.is_current_stream_capturing():
                idx = dev.index if dev.index is not None \
                    else torch.cuda.current_device()
                self._pool_events = self._pool.setdefault(idx, [])
        self._tl, self._tl_dev = tl, dev
        self._tl_base = len(self._stack)

    def _record(self):
        """Record the timeline's next boundary event on the card: a fresh
        one under capture, else the next of the card's reused events."""
        tl = self._tl
        if tl.events is None:
            return
        pool = self._pool_events
        if pool is None:
            ev = torch.cuda.Event(enable_timing=True, external=True)
        else:
            if len(tl.events) == len(pool):
                pool.append(torch.cuda.Event(enable_timing=True))
            ev = pool[len(tl.events)]
        ev.record(torch.cuda.current_stream(self._tl_dev))
        tl.events.append(ev)

    def leaf(self, name: str):
        """End the open leaf, if any, and start the leaf `name`."""
        self._close_leaf()
        self._open(name, True)
        tl = self._tl
        if tl is not None:
            rel = self._stack[-1][0].split("/")[self._tl_base:]
            tl.names.append("/".join(rel))
            self._record()

    def _end_timeline(self, ok: bool):
        tl = self._tl
        if ok and tl.events is not None and tl.names:
            self._record()                      # the step's end
        self._tl = None
        if not ok:
            return
        if tl.events is not None and self._pool_events is None:
            self.captured = tl                  # runs at each replay
        else:
            tl.ran = True
            self.last = tl

    def replayed(self, tl: _Timeline | None):
        """`tl` (a captured timeline) ran: the last step `device_ms` reads."""
        if tl is not None:
            tl.ran = True
            self.last = tl

    def device_ms(self) -> dict:
        """The last step that ran on the card: ``step``, its ms from its
        first boundary to its end, and ``leaves``, each leaf's ms in
        order; {} if none ran (or on the CPU).  Waits for that step."""
        tl = self.last
        if tl is None or not tl.ran or not tl.events:
            return {}
        ev = tl.events
        ev[-1].synchronize()
        leaves = {name: a.elapsed_time(b)
                  for name, a, b in zip(tl.names, ev, ev[1:])}
        return dict(step=ev[0].elapsed_time(ev[-1]), leaves=leaves)

    def timeline(self) -> list:
        """The leaves of the last step that ran, in order."""
        return list(self.last.names) if self.last is not None else []

    # -- the compiled step's capture --------------------------------------
    def checkpoint(self):
        """What `take_back` returns the registry to."""
        return ([(c, dict(c)) for c in self.cells],
                {k: list(v) for k, v in self.spans.items()})

    def take_back(self, mark) -> list:
        """Return to `mark` and give what was added since, as the
        (table, name, amount) of every count and byte counter that
        `replay` adds again."""
        cells, spans = mark
        delta = []
        for table, before in cells:
            for k, v in list(table.items()):
                n = v - before.get(k, 0)
                if n and not _is_seconds(k):
                    delta.append((table, k, n))
                if k in before:
                    table[k] = before[k]
                else:
                    del table[k]
        self.spans = spans
        return delta

    @staticmethod
    def replay(delta):
        for table, k, n in delta:
            table[k] = table.get(k, 0) + n

    # -- reading -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Every counter (a `counter` summed over its objects), every host
        span as its calls, seconds and bytes, and `device_ms`."""
        counters = {}
        for c in self.cells:
            for k, v in c.items():
                counters[k] = counters.get(k, 0) + v
        spans = {k: dict(count=v[0], seconds=v[1], bytes=v[2])
                 for k, v in self.spans.items()}
        return dict(counters=counters, spans=spans, device=self.device_ms())

    def reset(self):
        """Zero every counter and forget every span and step."""
        self.spans.clear()
        for c in self.cells:
            for k, v in c.items():
                c[k] = type(v)(0)
        self.last = self.captured = None

    def summary(self) -> str:
        """Lines for the end of a run: the host spans (calls, seconds, MB),
        the counters, and the last step's device ms by leaf name."""
        snap = self.snapshot()
        lines = ["trace: host spans (calls, s, MB):"]
        for path, s in sorted(snap["spans"].items()):
            mb = f" {s['bytes'] / 1e6:.3f} MB" if s["bytes"] else ""
            lines.append(f"  {path} {s['count']} {s['seconds']:.4f} s{mb}")
        lines.append("trace: counters: " + " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(snap["counters"].items())))
        dev = snap["device"]
        if dev:
            by = {}
            for name, ms in dev["leaves"].items():
                key = name.rsplit("/", 1)[-1]
                by[key] = by.get(key, 0.0) + ms
            lines.append(f"trace: device ms of the last step "
                         f"{dev['step']:.4f}: " + ", ".join(
                             f"{k} {v:.4f}" for k, v in by.items()))
        return "\n".join(lines)


REGISTRY = Registry()


class span:
    """``with span(name):`` a host span of the registry (see the module)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        REGISTRY._open(self.name, False)
        return self

    def __exit__(self, *exc):
        REGISTRY._close_leaf()
        REGISTRY._close()
        return False


class device_step:
    """``with device_step(name, device):`` the host span of a step that
    records its timeline of `leaf` boundaries on `device`; inside another
    step (the compiled step's body around ``Model.step``) it does nothing,
    and the leaves are that step's."""

    __slots__ = ("name", "device", "root")

    def __init__(self, name: str, device):
        self.name, self.device, self.root = name, device, False

    def __enter__(self):
        reg = REGISTRY
        self.root = reg._tl is None
        if self.root:
            reg._open(self.name, False)
            reg._start_timeline(self.device)
        return self

    def __exit__(self, *exc):
        if self.root:
            reg = REGISTRY
            reg._close_leaf()
            reg._end_timeline(exc[0] is None)
            reg._close()
        return False


class counter:
    """A class attribute: ``refills = trace.counter("driver.refills")``
    makes ``obj.refills`` a counter of `obj` held in the registry."""

    def __init__(self, name: str):
        self.name = name

    @staticmethod
    def _cells(obj) -> dict:
        cells = obj.__dict__.get("_trace_cells")
        if cells is None:
            cells = obj.__dict__["_trace_cells"] = {}
            REGISTRY.cells.append(cells)
        return cells

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        return self._cells(obj).get(self.name, 0)

    def __set__(self, obj, value):
        self._cells(obj)[self.name] = value


def leaf(name: str):
    """End the open leaf of the step and start the leaf `name`."""
    REGISTRY.leaf(name)


def add_bytes(n: int):
    REGISTRY.add_bytes(n)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset():
    REGISTRY.reset()


def summary() -> str:
    return REGISTRY.summary()


def device_ms() -> dict:
    return REGISTRY.device_ms()


def timeline() -> list:
    return REGISTRY.timeline()
