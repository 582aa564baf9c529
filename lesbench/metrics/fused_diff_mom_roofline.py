"""fused_diff_mom_roofline: ``lesbench.spans.fused_diff_mom_roofline``."""
from lesbench.spans import fused_diff_mom_roofline as read  # noqa: F401
