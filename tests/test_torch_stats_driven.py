"""The statistics families of the port against udales_tpu (CPU, float64)
on the dispersion case (the scalar slots and the tree dump) and the
precursor-driven case (``compute_diag``'s driver-window ghosts); the
helpers and the method are those of ``test_torch_stats.py``.
"""
import pytest

from test_torch_stats import (compute_diag_matches, family_matches,
                              family_params, runs)  # noqa: F401

HERE = ("dispersion", "driven")


@pytest.mark.parametrize("case", HERE)
def test_compute_diag_matches_reference(runs, case):
    compute_diag_matches(runs, case)


@pytest.mark.parametrize("case,family", family_params(HERE))
def test_family_matches_reference(runs, tmp_path, case, family):
    family_matches(runs, tmp_path, case, family)
