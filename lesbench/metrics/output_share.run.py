"""The output layer's share of a production run's window: host seconds
inside ``Simulation._outputs`` (every sample, write and monitor line the
loop serves between steps) over the window's seconds, in %."""


def read(ctx):
    if "output_s" not in ctx or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["output_s"] / ctx["window_s"]
