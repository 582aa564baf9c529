"""The staged street-canyon dispersion case of the PyTorch port against
udales_tpu (CPU, float64): ``cases.stage_urban_dispersion`` loaded by both
packages from one directory, 5 adaptive steps from udales_tpu's cold start,
every State leaf to 1e-8 relative (case (ii) of the long-tail physics; the
variant with purifiers and heat pumps is in test_torch_physics.py, the
one-equation variant in test_torch_oneeqn.py).  The same for the
benchmark's dispersion configuration (``lesbench/configs/
urban_cubes_dispersion.json``) cut to 32^3 and staged by the benchmark.
"""
import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

import jax

from udales_tpu.run import load_case as jload

from udales_tpu_torch import cases
from udales_tpu_torch.convert import state_from_numpy
from udales_tpu_torch.run import load_case as tload

from test_torch_openbc import compare_states, jtree


@pytest.fixture(scope="module")
def disp_root(tmp_path_factory):
    return tmp_path_factory.mktemp("disp")


def staged_pair(case):
    jm = jload(case, "900", dtype="float64")
    tm = tload(case, "900", dtype="float64", device="cpu")
    return jm, tm


def five_case_steps(jm, tm):
    """5 adaptive steps from udales_tpu's cold start of a staged case;
    every leaf of the State to 1e-8.  Returns the port's State."""
    jst = jm.cold_start(seed=43)
    tst = state_from_numpy(jtree(jst.replace(ibmp=None)))
    jstep = jax.jit(jm.step)
    for _ in range(5):
        jst, tst = jstep(jst), tm.step(tst)
    names = compare_states(tst, jst.replace(ibmp=None))
    assert {"c.sv", "m.sv", "c.e12", "pres", "dt"} <= set(names)
    return tst


@pytest.mark.parametrize("n", [16, 32])
def test_dispersion_steps_match_reference(disp_root, n):
    """(ii) the staged dispersion case: NO, NO2, O3 from canyon lines and a
    stack, the null cycle, trees; 5 steps, every leaf to 1e-8; NOx emitted,
    ozone titrated below its background somewhere."""
    case = cases.stage_urban_dispersion(n, disp_root)
    jm, tm = staged_pair(case)
    assert tm.vegetation.has_canopy and tm.scalsources is not None
    assert tm.cfg.chem.lchem and tm.purifiers is None and tm.heatpumps is None
    tst = five_case_steps(jm, tm)
    sv = tst.c.sv
    assert float(sv[0].max()) > 0.1 and float(sv[1].max()) > 0.01
    assert float(sv[2].min()) < cases.O3_BACKGROUND


def test_benchmark_dispersion_case_matches_reference(disp_root):
    """The case of the benchmark's dispersion cell, its configuration cut
    to 32^3 and staged by ``lesbench.cases``: the port steps it through
    its scalars, canopy and chem leaves as udales_tpu does, every leaf to
    1e-8 over 5 steps."""
    from lesbench import cases as bench_cases
    from lesbench.tests.lesbench_small import small_config
    cfg = small_config("urban_cubes_dispersion", 32)
    case = bench_cases.case_dir(cfg, disp_root / "bench")
    jm, tm = staged_pair(case)
    assert tm.vegetation.has_canopy and tm.scalsources is not None
    assert tm.cfg.chem.lchem and tm.cfg.scalars.nsv == 3
    tst = five_case_steps(jm, tm)
    assert tm.field_substeps == 5 * 3 * 3 and tm.chem_updates == 5
    assert float(tst.c.sv[0].max()) > 0.1
