"""The x/y process split of the port's rescale-recycle inlet generator
(``ops/inletgen.py``: the recycle planes from the ranks that hold them, the
domain's y means and displacement thickness) against the port on one
process and against udales_tpu on one device and on its 2 x 2 mesh (CPU,
float64, gloo); the helpers are tests/test_torch_split_open.py's.

Mirrors tests/test_sharding_hard.py's ``TestInletGenSharding``.  The flat
16^3 case with ``iinletgen = 1`` and ``BCxm = 2``, loaded on every rank by
``run.load_case(..., mesh=)`` from udales_tpu's cold start, 2 steps, with
its recycle plane at x index

  - 12 (on the last x rank of 2 x 2): against the single process,
    udales_tpu on one device and udales_tpu's 2 x 2 mesh, ``ig``'s leaves
    included;
  - 8 on 2 x 2 (u from rank 1, v, w and thl one cell before, from rank 0),
    and 3, 6 and 14 on 4 x 2 (the first, a middle and the last x rank):
    against the single process.

Every State leaf to 1e-9 of its largest value (the generator's y and x
means are sums in another order than one process's).  Beside them on 2 x
2, "gen12" warm-started from the reference's Fortran restart files of its
single-process run after 2 steps (``warmstart_state(..., model=)`` builds
the generator's state before it cuts the blocks), 1 step, against the same
in one process.
"""
import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

from test_torch_split_open import (GEN, assert_blocks, assert_close,
                                   check_against_references, flat_case,
                                   run_split)

MESH_CASES = {(2, 2): ("gen12", "gen8"), (4, 2): ("gen3", "gen6", "gen14")}


WARM = "initd00000002_xxx_xxx.007"


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    from udales_tpu_torch.io.restart import (warmstart_state,
                                             write_state_fortran)
    from udales_tpu_torch.run import load_case
    root = tmp_path_factory.mktemp("recycle_split")
    specs = {f"gen{ip}": (flat_case(root, f"gen{ip}", GEN.format(ip)),
                          "007", 2) for ip in (3, 6, 8, 12, 14)}
    case, warm = specs["gen12"][0], root / "warm12"

    def warm_job(start_np):
        """The restart files of gen12 after 2 steps in one process, and
        the 2 x 2 job that starts from them."""
        model = load_case(case, "007", "float64", device="cpu")
        st = model.run(state_from_numpy(start_np["gen12"]), 2)
        warm.mkdir()
        write_state_fortran(warm, st, "007", model.cfg, ntrun=2)
        return [dict(name="gen12warm", case_dir=str(case), expnr="007",
                     dtype="float64", warm=(str(warm), WARM), steps=1)]

    def warm_single(_):
        model = load_case(case, "007", "float64", device="cpu")
        st = warmstart_state(warm, WARM, "007", model.cfg, model.grid,
                             model=model)
        return state_to_numpy(model.run(st, 1))
    return run_split(root, specs, MESH_CASES, ("gen12",), ("gen12",),
                     extra=warm_job, after=warm_single)


def test_generator_on_2x2_matches_single_process_and_jax(split):
    """The recycle plane on the last x rank of 2 x 2: every leaf, the
    generator's included, against the single process, udales_tpu on one
    device and udales_tpu's 2 x 2 mesh, to 1e-9."""
    check_against_references(split, "gen12")


@pytest.mark.parametrize("mesh,name", [((2, 2), "gen8"), ((4, 2), "gen3"),
                                       ((4, 2), "gen6"), ((4, 2), "gen14")],
                         ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_recycle_plane_on_every_rank(split, mesh, name):
    """The recycle plane and the planes one cell before it on the first, a
    middle or the last x rank, or on two ranks: the gathered State against
    the single process, to 1e-9."""
    for rank, res in enumerate(split["runs"][mesh]):
        assert_close(res["cases"][name]["gathered"], split["single"][name],
                     1e-9, f"{mesh} {name} rank {rank}")


def test_generator_leaves_are_the_blocks_of_the_gathered_state(split):
    """The generator's planes along y, its Utav along x, its displacement
    thickness and profiles whole, the outlet planes along y."""
    for mesh in MESH_CASES:
        assert_blocks(split["runs"][mesh], MESH_CASES[mesh][0], {
            "ig.u0": "y", "ig.w0": "y", "ig.Utav": "x", "ig.displ": "",
            "ig.Urec": "", "c.bx.thl": "y", "c.u": "xy"})


def test_fortran_warm_start_on_2x2_matches_single_process(split):
    """The generator case warm-started from the Fortran files on 2 x 2 and
    stepped once: every leaf, the generator's built from the warm fields
    included, against the same in one process, to 1e-9."""
    ref = split["after"]
    assert ref["ig"] is not None and "u0" in ref["ig"]
    for rank, res in enumerate(split["runs"][(2, 2)]):
        assert_close(res["cases"]["gen12warm"]["gathered"], ref, 1e-9,
                     f"warm gen12 rank {rank}")
