"""PyTorch port of the udales_tpu urban LES (flat-ABL slice).

The package mirrors the module layout of ``udales_tpu`` so each function has
an obvious counterpart; ``udales_tpu`` stays the numerical reference.  It
imports ``torch`` and never ``jax``: configuration dataclasses are shared
with the reference through the JAX-free ``udales_tpu.config``.
"""
