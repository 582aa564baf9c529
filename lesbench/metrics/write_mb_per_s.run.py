"""write_mb_per_s.run: ``lesbench.program_trace.write_mb_per_s``."""
from lesbench.program_trace import write_mb_per_s as read  # noqa: F401
