"""The seam of the hand-written kernels (``ops/kernel.py``) under each of its
five wrappers, on the CPU: the input checks refuse, naming the kernel and
the tensor, what a kernel does not take; a device other than the CPU and
CUDA raises; the launch counters are taken back at capture and added per
replay; each launcher's declared ctypes signature is the parameter list of
its ``extern "C"`` declaration in ``csrc/``; and the modules import in any
order, the plain layer importing none of them.  The kernels themselves are
held against their plain routes in tests/test_torch_fused_{diff,adv,
vreman,ibmnorm,scalars}.py.
"""
import ast
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from udales_tpu_torch import trace
from udales_tpu_torch.config import (Config, DomainConfig, PhysicsConfig,
                                     SubgridConfig)
from udales_tpu_torch.grid import Grid
from udales_tpu_torch.ops.fused_adv import FusedAdvMom
from udales_tpu_torch.ops.fused_diff import FusedDiffMom
from udales_tpu_torch.ops.fused_ibmnorm import FusedIbmnorm
from udales_tpu_torch.ops.fused_scalars import FusedScalars
from udales_tpu_torch.ops.fused_vreman import FusedVreman
from udales_tpu_torch.ops.kernel import NVCC_FLAGS, check_inputs
from test_torch_fused_ibmnorm import random_call
from test_torch_fused_scalars import random_call as scalars_call

REPO = Path(__file__).resolve().parents[1]
KERNELS = {k.name: k for k in (FusedDiffMom, FusedAdvMom, FusedVreman,
                                FusedIbmnorm, FusedScalars)}
# built with --fmad=false
NO_FMA = ("fused_vreman", "fused_ibmnorm", "fused_scalars")
SHAPE = (4, 3, 5)
DT_NAMES = {np.dtype(np.float32): "f32", np.dtype(np.float64): "f64"}


def call_args(name, device="cpu", dtype=np.float32, seed=6):
    """(grid, the arguments of a call of kernel `name` in its variant that
    reads the most tensors: masked diffusion, advection with thl, the
    Vreman closure with the buoyancy correction, ibmnorm with the thl fill
    and the liberal correction, the scalar stack with the c mask) on random
    inputs."""
    nx, ny, nz = SHAPE
    grid = Grid.uniform(*SHAPE, 4.0, 3.0, 5.0, dtype=dtype)
    rng = np.random.default_rng(seed)
    t = lambda shape: torch.tensor(rng.standard_normal(shape).astype(dtype),
                                   device=device)
    cell = (nx + 2, ny + 2, nz + 2)
    g = types.SimpleNamespace(u=t(cell), v=t(cell), w=t((nx + 2, ny + 2,
                                                         nz + 1)),
                              ekm=t(cell), thl=t(cell))
    if name == "fused_diff_mom":   # {0, 1} fluid masks
        mask = lambda: torch.tensor((rng.uniform(size=cell) > 0.3)
                                    .astype(dtype), device=device)
        return grid, (g, grid, {k: mask() for k in "uvw"})
    if name == "fused_adv_mom":
        return grid, (g, t((nx + 2, ny + 2, nz)), grid, True)
    if name == "fused_ibmnorm":
        ibm, args = random_call("liberal", DT_NAMES[np.dtype(dtype)],
                                device=device, seed=seed, shape=SHAPE)
        return ibm.grid, (*args, ibm)
    if name == "fused_scalars":
        g, grid, Mc = scalars_call(DT_NAMES[np.dtype(dtype)], 3, True,
                                   device=device, seed=seed, shape=SHAPE)
        return grid, (g, grid, Mc)
    cfg = Config(domain=DomainConfig(itot=nx, jtot=ny, ktot=nz,
                                     xlen=float(nx), ylen=float(ny)),
                 physics=PhysicsConfig(ltempeq=True, lbuoyancy=True),
                 subgrid=SubgridConfig(lbuoycorr=True),
                 dtype=np.dtype(dtype).name)
    return grid, (g, grid, cfg, 5.0 * t(SHAPE), 288.0 + t(SHAPE))


# spoil an input list -> (exception, the message after "<kernel>: ")
REFUSALS = {
    "half": (lambda ins: [(n, t.half(), s) for n, t, s in ins],
             TypeError, lambda ins: "unsupported dtype torch.float16"),
    "metrics": (lambda ins: [(n, t.double(), s) for n, t, s in ins],
                ValueError,
                lambda ins: "fields are torch.float64, grid metrics"),
    "missing": (lambda ins: ins[:-1] + [(ins[-1][0], None, ins[-1][2])],
                ValueError, lambda ins: f"{ins[-1][0]} is missing"),
    "dtype": (lambda ins: ins[:1] + [("v", ins[1][1].double(), ins[1][2])]
              + ins[2:], ValueError, lambda ins: "v is torch.float64 on cpu"),
    "device": (lambda ins: ins[:3] + [(ins[3][0], ins[3][1].to("meta"),
                                       ins[3][2])] + ins[4:],
               ValueError, lambda ins: f"{ins[3][0]} is torch.float32 on "
                                       f"meta"),
    "shape": (lambda ins: ins[:2] + [("w", ins[0][1], ins[2][2])] + ins[3:],
              ValueError, lambda ins: re.escape(
                  f"w has shape {tuple(ins[0][1].shape)}, expected "
                  f"{ins[2][2]}")),
    "layout": (lambda ins: [(n, t.transpose(0, 1).contiguous()
                             .transpose(0, 1), s) for n, t, s in ins[:1]]
               + ins[1:], ValueError,
               lambda ins: f"{re.escape(ins[0][0])} is not contiguous"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_check_inputs_refuses_what_a_kernel_does_not_take(name, case):
    """The shared check refuses, before any pointer reaches a kernel, each
    dtype, device, shape and layout the kernel does not take, on the
    wrapper's own input list, naming the kernel and the tensor; what it
    takes passes."""
    grid, args = call_args(name)
    inputs = KERNELS[name]().inputs(*args)
    check_inputs(name, grid, inputs)
    spoil, exc, match = REFUSALS[case]
    with pytest.raises(exc, match=f"^{name}: {match(inputs)}"):
        check_inputs(name, grid, spoil(inputs))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_non_cuda_device_raises(name):
    """Tensors neither on the CPU nor on CUDA: no route, no launch."""
    kern = KERNELS[name]()
    _, args = call_args(name, device="meta", dtype=np.float64)
    with pytest.raises(ValueError, match=f"^{name}: unsupported device meta"):
        kern(*args)
    assert not any(trace.counter._cells(kern).values())


COUNTERS = [(FusedDiffMom, "launch_count", "fused_diff_mom.launches"),
            (FusedDiffMom, "masked_launch_count",
             "fused_diff_mom.masked_launches"),
            (FusedAdvMom, "launch_count", "fused_adv_mom.launches"),
            (FusedVreman, "launch_count", "fused_vreman.launches"),
            (FusedIbmnorm, "launch_count", "fused_ibmnorm.launches"),
            (FusedScalars, "launch_count", "fused_scalars.launches")]


@pytest.mark.parametrize("cls,attr,counter", COUNTERS,
                         ids=[c for _, _, c in COUNTERS])
def test_launches_rolled_back_at_capture_and_added_per_replay(cls, attr,
                                                              counter):
    """A launch counter is a counter of the trace, registered at zero: what
    a captured body launched is taken back at the end of the capture, and
    each replay adds it again."""
    kern = cls()
    assert getattr(kern, attr) == 0
    setattr(kern, attr, 4)
    total = trace.snapshot()["counters"][counter]
    mark = trace.REGISTRY.checkpoint()
    for _ in range(3):           # the launches during a capture
        setattr(kern, attr, getattr(kern, attr) + 1)
    delta = trace.REGISTRY.take_back(mark)
    assert getattr(kern, attr) == 4
    assert trace.snapshot()["counters"][counter] == total
    for _ in range(5):
        trace.REGISTRY.replay(delta)
    assert getattr(kern, attr) == 4 + 5 * 3
    assert trace.snapshot()["counters"][counter] == total + 15


def extern_c(source: Path) -> dict:
    """Every ``extern "C"`` function of `source`: its parameters, a letter
    each ("p" a pointer, "i" an int, "d" a double), in order."""
    letter = lambda p: ("p" if "*" in p else {"int": "i", "double": "d"}[
        p.split()[0]])
    return {m[1]: "".join(letter(p) for p in m[2].split(","))
            for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)',
                                 source.read_text())}


@pytest.mark.parametrize("name,entry", [
    (k.name, e) for k in KERNELS.values() for e in k.signatures])
def test_signature_is_the_extern_c_declaration(name, entry):
    """The ctypes signature a wrapper declares for a launcher is its
    parameter list in the source: a wrong list would read the arguments
    wrongly on the card, and no CPU route would show it."""
    kern = KERNELS[name]
    assert kern.signatures[entry] == extern_c(kern.source)[entry]


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_every_entry_point_is_declared(name):
    """The source exports the declared launchers and the occupancy query,
    nothing else; the Vreman, ibmnorm and scalar-stack kernels alone add
    to the shared flags."""
    kern = KERNELS[name]
    assert extern_c(kern.source) == {**kern.signatures,
                                     f"{name}_blocks_per_sm": "ii"}
    assert kern.flags == NVCC_FLAGS + (("--fmad=false",)
                                       if name in NO_FMA else ())


@pytest.mark.parametrize("first", ["ops.kernel", "ops.fused_diff",
                                   "ops.fused_adv", "ops.fused_vreman",
                                   "ops.fused_ibmnorm", "ops.fused_scalars"])
def test_imports_in_any_order(first):
    """The seam and each wrapper imported first in a fresh interpreter
    leave every wrapper, its counters and its build flags whole: no import
    cycle between them."""
    code = (f"import udales_tpu_torch.{first}\n"
            "from udales_tpu_torch.ops import fused_adv, fused_diff, kernel\n"
            "from udales_tpu_torch.ops import fused_vreman as fv\n"
            "from udales_tpu_torch.ops import fused_ibmnorm as fi\n"
            "from udales_tpu_torch.ops import fused_scalars as fs\n"
            "assert fs.fused_scalars.launch_count == 0\n"
            "assert fv.fused_vreman.launch_count == 0\n"
            "assert fi.fused_ibmnorm.launch_count == 0\n"
            "assert fused_adv.fused_adv_mom.launch_count == 0\n"
            "assert fused_diff.fused_diff_mom.masked_launch_count == 0\n"
            "assert kernel.NVCC_FLAGS and fv.NO_FMA and fi.NO_FMA\n"
            "assert fs.NO_FMA\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def port_imports(module: str, seen=None) -> set:
    """The port's modules that `module` imports, by import statements at
    any depth of its code, and theirs in turn."""
    seen = set() if seen is None else seen
    path = REPO / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = path.with_suffix("") / "__init__.py"
    package = module if path.name == "__init__.py" else \
        module.rpartition(".")[0]
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = ".".join(package.split(".")[:len(package.split("."))
                                               - node.level + 1]) \
                if node.level else ""
            base = ".".join(filter(None, [base, node.module]))
            found = [base] + [f"{base}.{a.name}" for a in node.names]
        else:
            continue
        for name in found:
            if name.startswith("udales_tpu_torch") and name not in seen \
                    and (REPO / (name.replace(".", "/") + ".py")).exists():
                seen.add(name)
                port_imports(name, seen)
    return seen


@pytest.mark.parametrize("plain", ["ops.subgrid", "ops.advection"])
def test_plain_layer_imports_no_kernel(plain):
    """A plain module imports, directly or through others, neither the
    seam nor a wrapper: the choice of a kernel is made above it."""
    found = port_imports(f"udales_tpu_torch.{plain}")
    assert "udales_tpu_torch.ops.stencil" in found
    assert not [m for m in found if m.split(".")[-1] == "kernel"
                or m.split(".")[-1].startswith("fused_")], found
    run = port_imports("udales_tpu_torch.run")
    assert {"udales_tpu_torch.ops.fused_vreman",
            "udales_tpu_torch.ops.fused_ibmnorm",
            "udales_tpu_torch.ops.fused_scalars"} <= run


# --- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_seam_on_card(cuda, name):
    """Through the seam on the card: the library loads with every declared
    launcher, each instantiation has resident blocks, and a call in its
    fullest variant launches once (counted), on the CUDA route, and agrees
    with the plain route on the same tensors."""
    kern = KERNELS[name]()
    lib = kern.load()
    assert all(getattr(lib, e).argtypes for e in kern.signatures)
    assert min(kern.blocks_per_sm(dt, v) for dt in (torch.float32,
                                                    torch.float64)
               for v in (False, True)) >= 1
    _, args = call_args(name, device=cuda)
    got = kern(*args)
    torch.cuda.synchronize()
    assert sum(trace.counter._cells(kern).values()) == 1
    ref = kern.plain(*args)
    pairs = [(a, b) for a, b in zip(got, ref) if b is not None]
    assert all(a.device.type == "cuda" for a, _ in pairs)
    scale = max(float(b.abs().max()) for _, b in pairs)
    assert max(float((a - b).abs().max()) for a, b in pairs) \
        <= 1e-5 * scale
