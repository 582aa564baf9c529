"""advection_ms_per_step: ``lesbench.program_trace.advection_ms_per_step``."""
from lesbench.program_trace import advection_ms_per_step as read  # noqa: F401
