"""ghosts_ms_per_step: ``lesbench.program_trace.ghosts_ms_per_step``."""
from lesbench.program_trace import ghosts_ms_per_step as read  # noqa: F401
