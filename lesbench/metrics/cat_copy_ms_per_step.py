"""cat_copy_ms_per_step: ``lesbench.spans.cat_copy_ms_per_step``."""
from lesbench.spans import cat_copy_ms_per_step as read  # noqa: F401
