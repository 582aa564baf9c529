"""A frozen copy of the LES step, its case loading and its case staging,
in plain PyTorch and NumPy: the benchmark's reference.

The modules are copies of the measured package's host and tensor code as
it stood when the benchmark was written, cut to the paths the benchmark's
cases run (the facet energy balance, time-dependent series, the inlet
generator, purifiers, heat pumps, radiation staging and the split over
ranks are left out, and a case that asks for one is refused),
with two departures: the SGS momentum diffusion is the plain sweeps
(``ops/fused_diff.py``) where the program launches its hand-written
kernel, and ``run.Model.run`` steps eagerly (no compiled step).  Later
changes to the program do not reach this copy, so it stays the yardstick
the program is held to.  Being a copy, it shares every fault the program
had when it was frozen: what it detects is a departure from the program
as it was then, not a fault in the physics.  The air-quality physics
(scalar sources, the NO-NO2-O3 chemistry, the tree canopy: ``physics.py``)
and the staging of its inputs (``cases.stage_urban_dispersion``) were
written for the benchmark; ``physics.py`` follows the measured package's
reading of uDALES's routines and is independent of it only as far as its
oracles reach.  It imports neither JAX nor the measured
package.
"""
