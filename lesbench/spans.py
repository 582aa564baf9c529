"""Readers of the profiled call of a ``step`` cell's window (the ``span``
that ``harness.read_span`` leaves in a traced run's context), shared by
the per-layer metric files in ``metrics/``.  Each returns None where the
run has nothing to read: no traced call, or no device activity in it."""
from __future__ import annotations

from .roofline import PEAK_BYTES_PER_S, fused_diff_mom_least_bytes


def _span(ctx):
    span = ctx.get("span")
    if span is None or span["n_ops"] == 0 or span["window_s"] <= 0:
        return None
    return span


def idle_share(ctx):
    """1 - (the union of the device activities' intervals) / (the call's
    host seconds, from a synchronize to a synchronize), in %."""
    span = _span(ctx)
    if span is None:
        return None
    return 100.0 * (1.0 - span["busy_s"] / span["window_s"])


def device_ops_per_step(ctx):
    """Device operations per replay of the compiled step (kernels, copies
    and sets the profiler sees on the card)."""
    span = _span(ctx)
    return None if span is None else span["n_ops"] / span["replays"]


def device_ms_per_step(ctx):
    """The device operations' summed time per replay, in ms."""
    span = _span(ctx)
    if span is None:
        return None
    return 1e3 * sum(s for s, _ in span["ops"].values()) / span["replays"]


def cat_copy_ms_per_step(ctx):
    """Device ms per replay of the kernels whose profiler name holds
    ``CatArrayBatchedCopy`` (the ghost cells built by ``torch.cat``)."""
    span = _span(ctx)
    if span is None:
        return None
    ops = [v for name, v in span["ops"].items()
           if "CatArrayBatchedCopy" in name]
    if not ops:
        return None
    return 1e3 * sum(s for s, _ in ops) / span["replays"]


def fused_diff_mom_roofline(ctx):
    """The SGS momentum diffusion kernel's share of its memory roofline:
    the least bytes it must move at the cell's shape and variant (the
    benchmark's frozen count) over the card's 3.35 TB/s, divided by its
    mean device time a launch, in %."""
    span = _span(ctx)
    if span is None:
        return None
    ops = [v for name, v in span["ops"].items() if "fused_diff_mom" in name]
    seconds = sum(s for s, _ in ops)
    launches = sum(n for _, n in ops)
    if launches == 0 or seconds <= 0:
        return None
    least = fused_diff_mom_least_bytes(ctx["shape"], ctx["itemsize"],
                                       ctx["variant"] == "masked")
    return 100.0 * (least / PEAK_BYTES_PER_S) / (seconds / launches)
