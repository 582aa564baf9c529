"""device_ops_per_step: ``lesbench.spans.device_ops_per_step``."""
from lesbench.spans import device_ops_per_step as read  # noqa: F401
