"""Field dumps and the wall-stress diagnostics of the port against
udales_tpu (CPU, float64).

The staged urban case (16^3) with a field dump of every code: one step of
each package from the reference's cold start gives the same ``State.taud``
(1e-12), and ``FieldDump`` of one converted State writes the same file.
The helpers that read and compare NetCDF outputs are shared with
``test_torch_stats.py``, ``test_torch_restart.py`` and
``test_torch_sim.py``.
"""
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from udales_tpu_torch import cases
from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
from udales_tpu_torch.io.fielddump import _CODES, FieldDump
from udales_tpu_torch.run import load_case

N = 16
# every code whose variable the urban case has ("p0" writes the same
# variable as "pr"; "ql" needs a thermodynamics diagnostic, s1 a scalar)
CODES = "u0,v0,w0,th,qt,pr,tx,ty,tz,hf,mu,mv,mw,mc"


def read_nc(path):
    """{variable: array} of a NetCDF-3 file, the coordinates included."""
    with netcdf_file(path, "r", mmap=False) as f:
        return {k: np.array(v[:]) for k, v in f.variables.items()}


def assert_files_match(got_path, ref_path, rtol, atol=0.0, skip=()):
    """Every variable of two NetCDF files: the same names and shapes, and
    max|got - ref| <= rtol x max|ref| + atol per variable (`atol` for the
    variables that are rounding noise in both), the values of those in
    `skip` left out.  Returns the port's variables."""
    got, ref = read_nc(got_path), read_nc(ref_path)
    assert sorted(got) == sorted(ref), (got_path.name, sorted(got))
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape and g.dtype == r.dtype, (k, g.shape)
        if k in skip:
            continue
        scale = float(np.abs(r).max(initial=0.0))
        err = float(np.abs(g.astype(np.float64) - r).max(initial=0.0))
        assert err <= rtol * scale + atol, \
            f"{got_path.name}:{k}: max abs err {err:.3e} > {rtol:g} x " \
            f"{scale:.3e} + {atol:g}"
    return got


def assert_close(got, ref, what, rtol=1e-12):
    """max|got - ref| <= rtol x max(1, max|ref|)."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = rtol * max(1.0, float(np.abs(ref).max(initial=0.0)))
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= tol, f"{what}: max abs err {err:.3e} > {tol:.3e}"


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """(case dir, reference model and State, port model and State) after
    one step of the field-dump urban case from the reference's cold
    start."""
    import jax
    from udales_tpu.run import load_case as jload_case
    from test_torch_openbc import jtree
    root = tmp_path_factory.mktemp("io")
    case = cases.with_namelist(
        cases.stage_urban(N, root), root / "dump",
        OUTPUT=dict(lfielddump=True, fieldvars=CODES, tfielddump=1.0))
    jmodel = jload_case(case, "900", dtype="float64")
    tmodel = load_case(case, "900", dtype="float64", device="cpu")
    assert jmodel.need_taudiag and tmodel.need_taudiag
    jst = jmodel.cold_start(seed=43)
    tst = state_from_numpy(jtree(jst))
    assert set(tst.taud) == {"x", "y", "z", "hf"}
    jst = jax.jit(jmodel.step)(jst)
    tst = tmodel.step(tst)
    return case, jmodel, jst, tmodel, tst


def test_wall_stress_after_one_urban_step_matches_reference(stepped):
    """The tx/ty/tz/hf diagnostics of the third substep: the bottom and
    wall-function increments of u, v, w and thl (udales_tpu run.py:356-403)
    to 1e-12."""
    _, _, jst, _, tst = stepped
    for k in ("x", "y", "z", "hf"):
        assert_close(tst.taud[k], jst.taud[k], f"taud.{k}")
        assert float(torch.abs(tst.taud[k]).max()) > 0, k


def test_fielddump_of_one_state_matches_reference(stepped, tmp_path):
    """FieldDump of one converted State, every code of the urban case: the
    two files hold the same variables, equal as float32."""
    from udales_tpu.io.fielddump import FieldDump as JFieldDump
    from test_torch_openbc import jtree
    case, jmodel, jst, tmodel, _ = stepped
    tst = state_from_numpy(jtree(jst))
    paths = {}
    for name, cls, model, st in (("ref", JFieldDump, jmodel, jst),
                                 ("got", FieldDump, tmodel, tst)):
        out = tmp_path / name
        out.mkdir()
        w = cls(model.cfg, model.grid, out, masks=model.ibm.masks)
        w.dump(st)
        w.close()
        paths[name] = out / "fielddump.900.nc"
    got = read_nc(paths["got"])
    ref = read_nc(paths["ref"])
    assert sorted(got) == sorted(ref)
    names = {_CODES[c][0] for c in CODES.split(",")}
    assert names <= set(got)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k
    # the written wall stresses are the State's, transposed to (z, y, x)
    tz = state_to_numpy(tst)["taud"]["z"][..., :N].astype(np.float32)
    assert np.array_equal(got["tau_z"][0], tz.transpose(2, 1, 0))
