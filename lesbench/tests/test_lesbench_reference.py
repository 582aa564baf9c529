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
    """The reference stages, loads and steps a case with the program, the
    JAX package and JAX unimportable, and loads none of them."""
    code = BLOCKER.format(blocked=["jax", "jaxlib", "flax", "udales_tpu",
                                   "udales_tpu_torch"]) + textwrap.dedent(f"""
        import sys
        from pathlib import Path
        from lesbench import cases
        from lesbench.reference import check
        from lesbench.tests.lesbench_small import small_config
        cfg = small_config("urban_cubes", 8)
        case = cases.case_dir(cfg, Path({str(tmp_path)!r}))
        model = check.build(cfg, case, "float64", "cpu")
        tree = check.to_tree(model.cold_start(seed=1))
        out = check.advance(model, tree, 1)
        assert check.nonfinite(out) == []
        loaded = {{m.split(".")[0] for m in sys.modules}}
        assert not loaded & {{"jax", "jaxlib", "flax", "udales_tpu",
                              "udales_tpu_torch"}}, loaded
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
