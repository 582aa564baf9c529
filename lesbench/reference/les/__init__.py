"""A frozen copy of the LES step, its case loading and its case staging,
in plain PyTorch and NumPy: the benchmark's reference.

The modules are copies of the measured package's host and tensor code as
it stood when the benchmark was written, cut to the paths the benchmark's
cases run (the facet energy balance, time-dependent series, the inlet
generator, the long-tail physics, radiation and vegetation staging and the
split over ranks are left out, and a case that asks for one is refused),
with two departures: the SGS momentum diffusion is the plain sweeps
(``ops/fused_diff.py``) where the program launches its hand-written
kernel, and ``run.Model.run`` steps eagerly (no compiled step).  Later
changes to the program do not reach this copy, so it stays the yardstick
the program is held to.  Being a copy, it shares every fault the program
had when it was frozen: what it detects is a departure from the program
as it was then, not a fault in the physics.  It imports neither JAX nor
the measured package.
"""
