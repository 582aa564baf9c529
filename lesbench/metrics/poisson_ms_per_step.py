"""poisson_ms_per_step: ``lesbench.program_trace.poisson_ms_per_step``."""
from lesbench.program_trace import poisson_ms_per_step as read  # noqa: F401
