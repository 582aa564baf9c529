"""Solver configuration, shared with the reference package.

``udales_tpu.config`` is plain Python (dataclasses, the namelist parser and
the physical constants) and imports no JAX, so the port re-exports it rather
than keeping a second copy that could drift.
"""
from udales_tpu.config import *  # noqa: F401,F403
