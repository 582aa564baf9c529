"""Several processes through ``udales_tpu_torch.parallel.multihost`` (CPU,
gloo), mirroring tests/test_multihost.py.

Two real processes take their group from torchrun's environment
(``init_distributed()`` with no arguments), form the mesh with
``global_mesh()`` (2 x 1, the most-square factorization), take their blocks
of one whole-domain State with ``shard_state_global`` and run one flat RK3
step of ``__graft_entry__``'s 16^3 float64 case; each rank's blocks agree
with the single-process step of the port and of udales_tpu to 1e-9.  One
process with neither arguments nor environment forms a group of one on a
free port; its 1 x 1 mesh still goes through the collectives.  The ranks
are processes of tests/torch_split_worker.py (torch and the port only).
"""
import pytest

# the card's machine has no JAX: the whole file skips there
pytest.importorskip("jax")

import jax
import numpy as np

from __graft_entry__ import _build as jbuild
from __graft_entry__ import _init_state as jinit

from udales_tpu_torch import entry
from udales_tpu_torch.convert import (FIELD_NAMES, state_from_numpy,
                                      state_to_numpy)

from torch_split_worker import launch


def to_numpy(st):
    fields = lambda f: {k: np.asarray(getattr(f, k)) for k in FIELD_NAMES}
    return {"m": fields(st.m), "c": fields(st.c), "pres": np.asarray(st.pres),
            "dt": np.asarray(st.dt), "timee": np.asarray(st.timee)}


def flat_case(n=16):
    """The start (udales_tpu's _init_state), udales_tpu's one-device step,
    the port's, and the job case of the port's model."""
    jm = jbuild(n, n, n, dtype="float64", ladaptive=False)
    st = jinit(jm)
    jref = to_numpy(jax.jit(jm.step)(st))
    start = to_numpy(st)
    tm = entry._build(n, n, n, "float64", ladaptive=False, device="cpu")
    tref = state_to_numpy(tm.step(state_from_numpy(start)))
    case = dict(name="flat", cfg=tm.cfg, zf=tm.grid.zf,
                dpdxl=np.full(n, -1e-4), state=start, steps=1)
    return case, jref, tref


def assert_block_close(res, ref, what):
    px, py, cx, cy = res["mesh"]
    blk = res["cases"]["flat"]["block"]
    for k in ("u", "v", "w", "thl"):
        whole = ref["c"][k]
        bx, by = whole.shape[0] // px, whole.shape[1] // py
        want = whole[cx * bx:(cx + 1) * bx, cy * by:(cy + 1) * by]
        err = np.abs(blk["c"][k] - want).max()
        assert err < 1e-9, (what, k, res["mesh"], err)
    assert abs(float(blk["dt"]) - float(ref["dt"])) < 1e-12


def test_two_processes_from_the_environment(tmp_path):
    case, jref, tref = flat_case()
    res = launch(dict(world=2, address=None, backend="gloo", device="cpu",
                      host_staged=False, timeout=60.0, mesh=None,
                      cases=[case]), tmp_path)
    assert [r["mesh"] for r in res] == [(2, 1, 0, 0), (2, 1, 1, 0)]
    for r in res:
        assert_block_close(r, tref, "port, one process")
        assert_block_close(r, jref, "udales_tpu, one device")


def test_one_process_without_environment(tmp_path):
    case, _, tref = flat_case()
    res = launch(dict(world=1, address=None, bare=True, backend="gloo",
                      device="cpu", host_staged=False, timeout=60.0,
                      mesh=None, cases=[case]), tmp_path)
    assert res[0]["mesh"] == (1, 1, 0, 0)
    assert res[0]["cases"]["flat"]["collectives"] > 0
    assert_block_close(res[0], tref, "port, one process")
