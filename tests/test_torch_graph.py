"""The compiled step of the PyTorch port (``udales_tpu_torch/graph.py``:
``CompiledStep``, ``Model.step_jit``, ``Model.run(..., graph=True)``) and
the State helpers it stands on (``State.map``, ``copy_into``).

On the CPU a CompiledStep runs its body, ``copy_into(S, model.step(S))``,
eagerly: the chain of its calls must equal the eager ``Model.run`` bit for
bit (0.0) on every path (flat, urban, urban-EB, driven with window
refills, the rescale-recycle generator, dispersion with its scalar stack,
purifiers and heat pumps, and a Model that keeps the wall-stress
diagnostics), and the flat and urban chains must match udales_tpu's
``Model.run`` (``lax.scan``) to 1e-8 from one initial State made with
numpy.  The test marked ``cuda`` holds 5 captured steps on the card
against 5 eager steps on the CPU (32^3 float64, 1e-9); it skips without a
card.  JAX and the JAX package are imported only inside the tests that
need them, so on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_graph.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from udales_tpu_torch import cases, entry
from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
from udales_tpu_torch.ops.fused_diff import fused_diff_mom
from udales_tpu_torch.run import load_case
from udales_tpu_torch.state import State, copy_into, same_structure

N = 16
NSTEPS = 4
RTOL = 1e-8     # tests/test_torch_step.py: torch.fft against dense DFTs


def leaves(tree, prefix=""):
    """{path: array} of a state_to_numpy tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def numpy_fields(seed, nx=N, ny=N, nz=N):
    """A flow around u = 1.5, thl = 290 made with numpy; w is zero on the
    floor and top faces."""
    rng = np.random.default_rng(seed)
    c3 = (nx, ny, nz)
    w = 0.2 * rng.standard_normal((nx, ny, nz + 1))
    w[..., 0] = w[..., nz] = 0.0
    return dict(u=1.5 + 0.4 * rng.standard_normal(c3),
                v=0.3 * rng.standard_normal(c3), w=w,
                thl=290.0 + 2.0 * rng.standard_normal(c3),
                qt=np.zeros(c3), e12=np.full(c3, 1e-4),
                sv=np.zeros((0,) + c3))


def flat_start(model, seed=7):
    """The numpy start of `model` (a flat Model) as a port State."""
    f = numpy_fields(seed, *model.grid.shape)
    kw = lambda a: np.asarray(a, np.float64)
    return state_from_numpy({
        "m": f, "c": f, "pres": np.zeros(model.grid.shape),
        "dt": kw(0.1), "timee": kw(0.0)}, device=model.device)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("graph")


def recycle_model():
    """The rescale-recycle generator case of tests/test_torch_recycle.py at
    16^3 (the port's Model) and its start, udales_tpu's cold start."""
    from test_torch_openbc import jtree
    from test_torch_recycle import generator_pair
    _, tmodel, jst = generator_pair(N)
    return tmodel, state_from_numpy(jtree(jst))


def staged(stage):
    def build(root):
        model = load_case(stage(root), "900", dtype="float64", device="cpu")
        return model, model.cold_start(seed=43)
    return build


PATHS = {
    "flat": lambda root: (lambda m: (m, flat_start(m)))(
        entry._build(N, N, N, "float64", device="cpu")),
    "urban": staged(lambda root: cases.stage_urban(N, root)),
    "urban-EB": staged(lambda root: cases.stage_urban_eb(N, root, dtEB=0.5)),
    "driven": staged(lambda root: cases.stage_urban_driven(
        N, root, nt=40, chunk=4, dtdriver=0.05)),
    "recycle": lambda root: recycle_model(),
    "dispersion": staged(lambda root: cases.stage_urban_dispersion(
        N, root, purifiers=True, heatpumps=True)),
    "taud": staged(lambda root: cases.with_namelist(
        cases.stage_urban(N, root), root / "urban_taud", OUTPUT=dict(
            lfielddump=True, fieldvars="u0,tx,ty,tz,hf"))),
}


@pytest.mark.parametrize("name", sorted(PATHS))
def test_compiled_chain_equals_eager_run(root, name):
    """NSTEPS calls of ``model.step_jit()`` on the CPU (the window refilled
    between them where the case streams one) against ``Model.run``: every
    leaf of the State equal, bit for bit; the start is not written."""
    model, start = PATHS[name](root)
    keep = start.map(torch.clone)
    eager = state_to_numpy(model.run(start, NSTEPS))
    step = model.step_jit()
    stream = model.driver_stream
    st, refills = start, []
    for _ in range(NSTEPS):
        if stream is not None:
            st = stream.ensure(st)
            refills.append(stream.refills)
        st = step(st)
    assert step is model.step_jit() and st is step.state
    assert (step.kind, step.builds, step.replays) == ("eager body", 1,
                                                      NSTEPS - 1)
    got = leaves(state_to_numpy(st))
    want = leaves(eager)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    for k, v in leaves(state_to_numpy(keep)).items():
        assert np.array_equal(leaves(state_to_numpy(start))[k], v), k
    # what each path carries through the static State
    part = {"urban-EB": "fac.T", "driven": "drv.u", "recycle": "ig.Uinl",
            "dispersion": "c.sv", "taud": "taud.x"}.get(name)
    if part is not None:
        assert part in got and np.abs(got[part]).max() > 0, part
    if name == "driven":
        # a window refilled while the static State existed: copied into
        # its drv buffers
        assert refills[-1] > refills[0], refills
    if name == "urban-EB":
        assert float(st.fac.tEB_last) > 0


def test_flat_compiled_run_matches_reference_scan():
    """udales_tpu's Model.run (lax.scan under jax.jit) and the port's
    ``run(..., graph=True)`` from one numpy start, flat 16^3 float64."""
    import jax
    import jax.numpy as jnp
    import __graft_entry__ as ref_entry
    from udales_tpu import state as jstate
    from udales_tpu_torch.convert import PROFILE_NAMES, load_profiles
    from test_torch_openbc import compare_states
    jmodel = ref_entry._build(N, N, N, "float64")
    tmodel = entry._build(N, N, N, "float64", device="cpu")
    load_profiles(tmodel, {k: np.asarray(getattr(jmodel, k))
                           for k in PROFILE_NAMES})
    f = numpy_fields(7)
    jst = jstate.initial_state(
        jmodel.grid, jstate.Fields(**{k: jnp.asarray(a)
                                      for k, a in f.items()}), dt0=0.1)
    tst = flat_start(tmodel)
    jst = jax.jit(lambda s: jmodel.run(s, NSTEPS))(jst)
    tst = tmodel.run(tst, NSTEPS, graph=True)
    assert tmodel.step_jit().replays == NSTEPS - 1
    names = compare_states(tst, jst, rtol=RTOL)
    assert {"c.u", "m.w", "pres", "dt", "timee"} <= set(names)


def test_urban_compiled_run_matches_reference_scan(root):
    """The same for the staged urban 16^3 case: udales_tpu's cold start
    with its fields replaced by a numpy start, every leaf to 1e-8."""
    import jax
    import jax.numpy as jnp
    from udales_tpu.run import load_case as jload_case
    from test_torch_openbc import compare_states, jtree
    case = cases.stage_urban(N, root)
    jmodel = jload_case(case, "900", dtype="float64")
    tmodel = load_case(case, "900", dtype="float64", device="cpu")
    jst = jmodel.cold_start(seed=43)
    fields = dataclasses.replace(jst.m, **{
        k: jnp.asarray(a) for k, a in numpy_fields(11).items()})
    jst = jst.replace(m=fields, c=fields)
    tst = state_from_numpy(jtree(jst.replace(ibmp=None)))
    jst = jax.jit(lambda s: jmodel.run(s, NSTEPS))(jst)
    tst = tmodel.run(tst, NSTEPS, graph=True)
    names = compare_states(tst, jst.replace(ibmp=None), rtol=RTOL)
    assert {"c.u", "c.thl", "m.v", "pres", "dt"} <= set(names)


def small_state(dtype="float64", n=4):
    model = entry._build(n, n, n, dtype, device="cpu")
    return model.run(entry._init_state(model, seed=3), 1)


@pytest.mark.parametrize("change", ["shape", "dtype", "missing part",
                                    "extra part", "dict keys", "type"])
def test_copy_into_raises_on_a_mismatch(change):
    """copy_into refuses a source of another structure, shape or dtype, and
    writes nothing before it raises."""
    dst = small_state()
    before = dst.map(torch.clone)
    src = dst.map(lambda t: t + 1.0)
    taud = lambda s: {k: s.c.u.clone() for k in ("x", "y", "z", "hf")}
    src = {
        "shape": lambda: src.replace(pres=src.pres[:-1]),
        "dtype": lambda: small_state("float32"),
        "missing part": lambda: src,
        "extra part": lambda: src.replace(taud=taud(src)),
        "dict keys": lambda: src.replace(taud={"x": src.c.u.clone()}),
        "type": lambda: src.replace(c=dataclasses.replace(src.c, u=1.0)),
    }[change]()
    if change in ("missing part", "dict keys"):
        dst = dst.replace(taud=taud(dst))
        before = dst.map(torch.clone)
    assert not same_structure(dst, src)
    with pytest.raises(ValueError, match="copy_into"):
        copy_into(dst, src)
    for a, b in zip(leaves(state_to_numpy(dst)).values(),
                    leaves(state_to_numpy(before)).values()):
        assert np.array_equal(a, b)


def test_copy_into_writes_in_place_whatever_the_aliasing():
    """copy_into writes every leaf in place (the destination's tensors keep
    their memory), skips a leaf that is its own source, and takes a
    source leaf that is another destination leaf as it was before the
    copy, whatever the order of the copies."""
    dst = small_state().map(torch.clone)    # m and c apart (m is c after a
    # full step)
    ptrs = [t.data_ptr() for t in leaves_of(dst)]
    old_m_u = dst.m.u.clone()
    # c.u from dst.m.u (which is itself overwritten), m.u fresh, the rest
    # the destination's own leaves
    src = dst.replace(c=dataclasses.replace(dst.c, u=dst.m.u),
                      m=dataclasses.replace(dst.m, u=dst.m.u + 5.0))
    copy_into(dst, src)
    assert torch.equal(dst.c.u, old_m_u)
    assert torch.equal(dst.m.u, old_m_u + 5.0)
    assert [t.data_ptr() for t in leaves_of(dst)] == ptrs


def leaves_of(state):
    out = []
    state.map(lambda t: out.append(t) or t)
    return out


def test_state_map_reaches_every_part(root):
    """State.map and Fields.map apply to every tensor leaf: the outlet
    planes, the driver window, the facet state and the dicts; None stays
    None."""
    model, st = PATHS["driven"](root)
    st = model.run(st, 1)
    doubled = st.map(lambda t: t * 2)
    for (k, a), b in zip(leaves(state_to_numpy(st)).items(),
                         leaves(state_to_numpy(doubled)).values()):
        assert np.array_equal(2 * a, b), k
    assert doubled.fac is None and doubled.c.by is None
    assert torch.equal(st.c.map(torch.neg).bx.u, -st.c.bx.u)
    assert isinstance(doubled, State) and doubled.drv.u.shape == st.drv.u.shape


def test_compiled_step_aliasing_rule():
    """What the docstring of graph.py promises a caller: a call returns the
    static State, which the next call overwrites in place; the State passed
    in is never written; Model.run(graph=True) and Simulation.run hand back
    a State of their own."""
    model = entry._build(8, 8, 8, "float64", device="cpu")
    start = entry._init_state(model, seed=2)
    keep = start.map(torch.clone)
    step = model.step_jit()
    first = step(start)
    snap = first.map(torch.clone)
    second = step(first)
    assert second is first and first is step.state
    assert not torch.equal(first.c.u, snap.c.u)      # overwritten in place
    for a, b in zip(leaves_of(start), leaves_of(keep)):
        assert torch.equal(a, b)                     # the input untouched
    own = model.run(start, 2, graph=True)
    snap = own.map(torch.clone)
    model.run(own, 2, graph=True)
    step(own)
    for a, b in zip(leaves_of(own), leaves_of(snap)):
        assert torch.equal(a, b)                     # the caller's copy


def test_a_state_of_another_structure_builds_again(root):
    """A State whose structure differs from the static State's (here an
    energy-balance State without its facet state, as the reference's
    Fortran restart files give it) builds the compiled step again, as
    ``jax.jit`` traces again; the chain still equals the eager steps."""
    model, start = PATHS["urban-EB"](root)
    step = model.step_jit()
    step(start)
    bare = start.replace(fac=None)
    got = step(bare)
    assert step.builds == 2 and got.fac is None and got is step.state
    got = step(got)
    assert step.builds == 2 and step.replays == 1
    want = model.step(model.step(bare))
    for k, v in leaves(state_to_numpy(want)).items():
        assert np.array_equal(leaves(state_to_numpy(got))[k], v), k


def test_simulation_steps_with_the_compiled_step(tmp_path):
    """Simulation of a one-process Model steps with model.step_jit() and
    says so; its result equals Model.run and is its own State, and a
    recorder that keeps planes past the step (the precursor's
    DriverRecorder) keeps each step's own, not views of the static
    State."""
    from udales_tpu_torch.sim import Simulation
    model = entry._build(8, 8, 8, "float64", device="cpu")
    model.cfg = dataclasses.replace(model.cfg, driver=dataclasses.replace(
        model.cfg.driver, idriver=1, tdriverstart=0.0, dtdriver=0.1,
        iplane=4))
    start = entry._init_state(model, seed=2)
    sim = Simulation(model, tmp_path, monitor=False)
    assert sim.step is model.step_jit() and sim.step_kind == \
        "compiled (eager body)"
    final = sim.run(start, runtime=1.2)
    assert sim.ntrun >= 3 and final is not model.step_jit().state
    st, want_u = start, []
    for _ in range(sim.ntrun):
        st = model.step(st)
        want_u.append(st.c.u[4].numpy().copy())
    for k, v in leaves(state_to_numpy(final)).items():
        assert np.array_equal(v, leaves(state_to_numpy(st))[k]), k
    frames = sim.driver_rec.frames
    assert len(frames) == sim.ntrun
    for fr, u in zip(frames, want_u):
        assert np.array_equal(fr["u"], u)


def test_step_jit_refuses_a_split_model(tmp_path):
    """The compiled step of a Model on a mesh (one gloo rank, 1 x 1):
    on the CPU it runs the eager body, and 2 calls equal 2 calls of
    model.step bit for bit, with the same collectives and bytes a step;
    Simulation of it steps with it.  Only a host-staged mesh refuses,
    naming the host staging, and Simulation of that one steps eagerly."""
    import torch.distributed as dist
    from udales_tpu_torch.parallel.mesh import make_mesh
    from udales_tpu_torch.sim import Simulation
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        model = entry._build(8, 8, 8, "float64", device="cpu", mesh=mesh)
        assert mesh.capturable
        start = entry._init_state(model)
        counts = {}
        for graph in (False, True):
            mesh.reset_counts()
            got = state_to_numpy(model.run(start, 2, graph=graph))
            counts[graph] = (mesh.collectives, mesh.bytes)
            if graph:
                assert model.step_jit().kind == "eager body"
                assert model.step_jit().collectives_per_replay == (0, 0)
            else:
                want = got
        assert counts[True] == counts[False] and counts[True][0] > 0
        for k, v in leaves(want).items():
            assert np.array_equal(leaves(got)[k], v), k
        sim = Simulation(model, tmp_path / "out", monitor=False)
        assert sim.step is model.step_jit() and \
            sim.step_kind == "compiled (eager body)"
        staged = entry._build(8, 8, 8, "float64", device="cpu",
                              mesh=make_mesh(1, 1, host_staged=True))
        assert not staged.mesh.capturable
        with pytest.raises(NotImplementedError, match="host-staged"):
            staged.step_jit()
        with pytest.raises(NotImplementedError, match="host-staged"):
            staged.run(entry._init_state(staged), 1, graph=True)
        sim = Simulation(staged, tmp_path / "staged", monitor=False)
        assert sim.step == staged.step and \
            sim.step_kind == "eager (host-staged split)"
    finally:
        dist.destroy_process_group()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_steps_on_card_match_cpu(cuda):
    """5 replays of the captured step on the card (flat 32^3 float64)
    against 5 eager steps on the CPU from one numpy start: every leaf
    within 1e-9 of its largest value; the kernel launched 3 times a step,
    counted across the replays."""
    n = 32
    states = {}
    for dev in ("cpu", "cuda"):
        model = entry._build(n, n, n, "float64", device=dev)
        start = flat_start(model)
        fused_diff_mom.launch_count = 0
        states[dev] = state_to_numpy(model.run(start, 5, graph=dev == "cuda"))
        if dev == "cuda":
            step = model.step_jit()
            assert step.kind == "cuda graph" and step.graph is not None
            assert fused_diff_mom.launch_count == 15
            assert step.per_replay["fused_diff_mom.launches"] == 3
            assert "fused_diff_mom.masked_launches" not in step.per_replay
    ref, got = leaves(states["cpu"]), leaves(states["cuda"])
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        scale = max(float(np.abs(r).max(initial=0.0)), 1e-30)
        assert float(np.abs(got[k] - r).max(initial=0.0)) <= 1e-9 * scale, k
