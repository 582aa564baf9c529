"""driver_wait_ms_per_step: ``lesbench.program_trace.driver_wait_ms_per_step``."""
from lesbench.program_trace import driver_wait_ms_per_step as read  # noqa: F401
