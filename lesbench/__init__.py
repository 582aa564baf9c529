"""lesbench: the benchmark of udales_tpu_torch on one NVIDIA H100 (see
``harness``).  It imports neither JAX nor the JAX package."""
