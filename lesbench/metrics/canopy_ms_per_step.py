"""canopy_ms_per_step: device ms of the program's ``canopy`` leaves in the last
replay (``lesbench.program_trace.leaf_ms``); None where the step has none."""
from lesbench.program_trace import leaf_ms


def read(ctx):
    return leaf_ms(ctx, "canopy")
