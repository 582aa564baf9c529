"""sync_wait_ms_per_step.run:
``lesbench.program_trace.sync_wait_ms_per_step``."""
from lesbench.program_trace import sync_wait_ms_per_step as read  # noqa: F401
