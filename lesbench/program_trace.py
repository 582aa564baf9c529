"""Readers of the program's own trace (``udales_tpu_torch.trace``): the
registry of the process the run took place in, read once the window has
closed.  The device metrics read the leaves of the last step that ran (a
replay of the captured step: its own event nodes time it on the card);
the host metrics are ratios of the registry's sums over the whole run, so
they need no window boundaries.  Each returns None where the run has
nothing to read, and off the card: the harness's CPU runs share one
process, and so one registry, between runs.

A test hands a snapshot of its own under ``ctx["trace"]``."""
from __future__ import annotations

# the writer families whose write spans `write_mb_per_s` reads
WRITERS = ("tdump", "xytdump", "fielddump")


def _snapshot(ctx):
    if "trace" in ctx:
        return ctx["trace"]
    if ctx.get("peak_bytes") is None:
        return None
    try:
        from udales_tpu_torch import trace
    except ImportError:         # a program without its own trace
        return None
    return trace.snapshot()


def _last(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def leaf_ms(ctx, name: str):
    """Device ms of every leaf called `name` in the last step (step entry
    and the three substeps together)."""
    snap = _snapshot(ctx)
    if snap is None or not snap["device"]:
        return None
    ms = [v for k, v in snap["device"]["leaves"].items() if _last(k) == name]
    return sum(ms) if ms else None


def _spans(snap, name: str):
    """(calls, seconds, bytes) summed over the spans called `name`."""
    hits = [s for k, s in snap["spans"].items() if _last(k) == name]
    return (sum(s["count"] for s in hits), sum(s["seconds"] for s in hits),
            sum(s["bytes"] for s in hits))


def host_ms_per(ctx, name: str, per: str):
    """1000 x the host seconds in the spans called `name` over the calls
    of the spans called `per`."""
    snap = _snapshot(ctx)
    if snap is None:
        return None
    n = _spans(snap, per)[0]
    calls, seconds, _ = _spans(snap, name)
    if n == 0 or calls == 0:
        return None
    return 1e3 * seconds / n


def advection_ms_per_step(ctx):
    return leaf_ms(ctx, "advection")


def closure_ms_per_step(ctx):
    return leaf_ms(ctx, "closure")


def ghosts_ms_per_step(ctx):
    return leaf_ms(ctx, "ghosts")


def wallfun_ms_per_step(ctx):
    return leaf_ms(ctx, "wallfun")


def poisson_ms_per_step(ctx):
    return leaf_ms(ctx, "poisson")


def driver_wait_ms_per_step(ctx):
    """The host's read of ``timee`` before each step (``driver.wait``), in
    ms per ``DriverStream.ensure`` call."""
    return host_ms_per(ctx, "driver.wait", "driver.ensure")


def sync_wait_ms_per_step(ctx):
    """The run loop's one host read a step (``sim.sync``), in ms per loop
    step (``sim.step``)."""
    return host_ms_per(ctx, "sim.sync", "sim.step")


def write_mb_per_s(ctx):
    """Bytes handed to the tdump, xytdump and field-dump writers over the
    host seconds of their ``write`` spans under ``sim.outputs`` (the stop's
    checkpoint is not among them), in MB/s."""
    snap = _snapshot(ctx)
    if snap is None:
        return None
    hits = [snap["spans"].get(f"sim.outputs/{w}/write") for w in WRITERS]
    hits = [s for s in hits if s is not None]
    seconds = sum(s["seconds"] for s in hits)
    nbytes = sum(s["bytes"] for s in hits)
    if seconds <= 0 or nbytes == 0:
        return None
    return nbytes / 1e6 / seconds
