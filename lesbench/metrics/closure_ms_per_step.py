"""closure_ms_per_step: ``lesbench.program_trace.closure_ms_per_step``."""
from lesbench.program_trace import closure_ms_per_step as read  # noqa: F401
