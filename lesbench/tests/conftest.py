"""The benchmark's CPU tests run on one thread each: their small cases
(up to 64 x 64 x 16) are large enough for torch to spread an operation
over every core, and several pytest workers doing so at once slow each
other down a hundredfold."""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
