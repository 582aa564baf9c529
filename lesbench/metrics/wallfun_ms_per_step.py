"""wallfun_ms_per_step: ``lesbench.program_trace.wallfun_ms_per_step``."""
from lesbench.program_trace import wallfun_ms_per_step as read  # noqa: F401
