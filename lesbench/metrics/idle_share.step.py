"""idle_share.step: ``lesbench.spans.idle_share``."""
from lesbench.spans import idle_share as read  # noqa: F401
