"""The benchmark's frozen byte count of the diffusion kernel equals the
program's on each cell's shape and variant."""
from __future__ import annotations

import pytest

from lesbench.roofline import fused_diff_mom_least_bytes
from udales_tpu_torch.ops.fused_diff import least_bytes


@pytest.mark.parametrize("shape,masked", [
    ((128, 128, 128), True),    # urban_128.step, urban_128.run, driven_128
    ((256, 256, 256), False),
    ((16, 16, 16), True), ((16, 16, 16), False)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_least_bytes_is_the_programs(shape, masked, itemsize):
    assert fused_diff_mom_least_bytes(shape, itemsize, masked) \
        == least_bytes(shape, itemsize, masked)
