"""The frozen reference against the program's eager path on the CPU, at
16^3 (64 x 64 x 16 for the 512 x 512 x 128 array) in float64, on each
configuration; and the reference's imports."""
from __future__ import annotations

import subprocess
import sys
import textwrap

import pytest

from lesbench import cases
from lesbench.harness import ROOT
from lesbench.reference import check
from lesbench.tests.lesbench_small import small_config


def _program(cfg, case):
    """The program's Model in float64 on the CPU and its start State."""
    from udales_tpu_torch.run import load_case
    model = load_case(case, "900", "float64", device="cpu")
    return model, model.cold_start(seed=5)


@pytest.mark.parametrize("config", ["urban_cubes", "urban_cubes_driven",
                                    "urban_cubes_512"])
def test_reference_follows_the_program(tmp_path, config):
    """Three steps of the reference from the program's State after two
    equal the program's next three steps to rounding, in every compared
    field (the driven case's outlet planes too)."""
    cfg = small_config(config, 64 if config == "urban_cubes_512" else 16)
    case = cases.case_dir(cfg, tmp_path)
    model, state = _program(cfg, case)
    state = model.run(state, 2)
    before = check.to_tree(state)
    after = check.to_tree(model.run(state, 3))
    ref = check.advance(check.build(cfg, case, "float64", "cpu"), before, 3)
    gaps = check.gaps(after, ref)
    if cfg["case"] == "urban_driven":
        assert "bx_u_gap" in gaps
    assert max(gaps.values()) <= 1e-12, gaps
    assert check.nonfinite(after) == []


BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = {blocked!r}
    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None
    sys.meta_path.insert(0, Block())
""")


def test_reference_imports_neither_program_nor_jax(tmp_path):
    """The reference stages, loads and steps a case, and the street-canyon
    dispersion case with its sources, chemistry and trees, with the
    program, the JAX package and JAX unimportable, and loads none of
    them."""
    code = BLOCKER.format(blocked=["jax", "jaxlib", "flax", "udales_tpu",
                                   "udales_tpu_torch"]) + textwrap.dedent(f"""
        import sys
        from pathlib import Path
        from lesbench import cases
        from lesbench.reference import check
        from lesbench.tests.lesbench_small import (dispersion_config,
                                                   small_config)
        for cfg in (small_config("urban_cubes", 8), dispersion_config(32)):
            case = cases.case_dir(cfg, Path({str(tmp_path)!r}))
            model = check.build(cfg, case, "float64", "cpu")
            tree = check.to_tree(model.cold_start(seed=1))
            out = check.advance(model, tree, 1)
            assert check.nonfinite(out) == []
        assert model.sources is not None and model.canopy is not None
        assert model.cfg.chem.lchem and check.leaf(out, "c.sv").shape[0] == 3
        loaded = {{m.split(".")[0] for m in sys.modules}}
        assert not loaded & {{"jax", "jaxlib", "flax", "udales_tpu",
                              "udales_tpu_torch"}}, loaded
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


# the keys ``check.gaps`` gave before it compared scalars, for a State
# without them: periodic, and with an open x's outlet planes
PARENT_GAPS = {
    "urban_cubes": ["u_gap", "u_rms", "v_gap", "v_rms", "w_gap", "w_rms",
                    "thl_gap", "thl_rms", "pres_gap", "pres_rms", "dt_gap"],
    "urban_cubes_driven": ["u_gap", "u_rms", "v_gap", "v_rms", "w_gap",
                           "w_rms", "thl_gap", "thl_rms", "pres_gap",
                           "pres_rms", "bx_u_gap", "bx_u_rms", "bx_v_gap",
                           "bx_v_rms", "bx_w_gap", "bx_w_rms", "bx_thl_gap",
                           "bx_thl_rms", "dt_gap"],
}


@pytest.mark.parametrize("config", sorted(PARENT_GAPS))
def test_gaps_without_scalars_keep_the_parents_keys(tmp_path, config):
    """A State without scalars is compared in the fields, and in the
    order, it was before the scalars were compared; a State against itself
    reads 0 in each."""
    cfg = small_config(config, 16)
    model = check.build(cfg, cases.case_dir(cfg, tmp_path), "float64", "cpu")
    tree = check.to_tree(model.run(model.cold_start(seed=3), 1))
    assert check.leaf(tree, "c.sv").shape[0] == 0
    gaps = check.gaps(tree, tree)
    assert list(gaps) == PARENT_GAPS[config]
    assert set(gaps.values()) == {0.0}
