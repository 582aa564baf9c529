"""``udales_tpu_torch.io.hdf5`` against h5py (CPU).

- Trees of nested groups, f32/f64/i32/i64 and other integer datasets, 0-d
  and zero-length datasets, attributes on the root and on groups, and
  groups of 1, 9, 70 and 300 members (one symbol-table node, several, a
  B-tree node of several children, a B-tree two levels deep): written by
  the port and read by h5py, and written by h5py (its default format) and
  read by the port, equal to the bit.  The same for random trees
  (hypothesis).
- Files h5py writes in structures the module does not read (chunked or
  compressed data, the latest format, new-style groups, strings,
  big-endian data) raise ValueError naming what was met; so do dtypes the
  writer cannot write.
- A checkpoint of the urban-EB case at 8^3 f64, with its facet state,
  written by either package loads in the other, every leaf equal, and
  both packages write the same names, dtypes, shapes and attributes.
- No module of the port imports h5py but the copy of the reference's
  prep tool, ``prep/syntheticinflow.py``.
"""
import ast
import dataclasses
from pathlib import Path

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

import udales_tpu_torch
from udales_tpu_torch.io import hdf5

DTYPES = ("<f4", "<f8", "<i4", "<i8", "<i1", "<i2", "<u1", "<u2", "<u4",
          "<u8")


def h5py_write(path, tree):
    def fill(g, tree):
        g.attrs.update(getattr(tree, "attrs", {}))
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(g.create_group(k), v)
            else:
                g.create_dataset(k, data=v)
    with h5py.File(path, "w") as f:
        fill(f, tree)


def h5py_read(path):
    def tree(g):
        out = hdf5.Group(attrs=dict(g.attrs))
        for k, v in g.items():
            out[k] = tree(v) if isinstance(v, h5py.Group) else \
                np.asarray(v[()])
        return out
    with h5py.File(path, "r") as f:
        return tree(f)


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def assert_trees_equal(got, want, where="/"):
    """The same members, attributes, dtypes, shapes and bytes."""
    assert sorted(got) == sorted(want), where
    gattrs, wattrs = getattr(got, "attrs", {}), getattr(want, "attrs", {})
    assert sorted(gattrs) == sorted(wattrs), where
    for k, v in wattrs.items():
        assert same(gattrs[k], v), (where, k, gattrs[k], v)
    for k, v in want.items():
        if isinstance(v, dict):
            assert isinstance(got[k], dict), where + k
            assert_trees_equal(got[k], v, f"{where}{k}/")
        else:
            assert same(got[k], v), (where + k, got[k], v)


def sample_tree(members):
    rng = np.random.default_rng(members)
    many = {f"x{i:03d}": rng.standard_normal(i % 4 + 1).astype(
        DTYPES[i % 2]) if i % 3 else np.asarray(i % 100, DTYPES[2 + i % 8])
        for i in range(members)}
    return hdf5.Group({
        "m": hdf5.Group({
            "u": rng.standard_normal((4, 3, 2)).astype("<f4"),
            "w": rng.standard_normal((4, 3, 3)),
            "i": rng.integers(-9, 9, (5,), dtype="<i4"),
            "l": rng.integers(-2**62, 2**62, (2, 3), dtype="<i8"),
            "z": np.asarray(2.5),
            "sv": np.zeros((0, 4, 3, 2), "<f4"),
            "deep": {"er": {"est": np.asarray(7, "<i8")}},
        }, attrs={"tnext_sample": 13.0, "k": np.int32(-3)}),
        "many": many,
        "empty": {},
        "pres": rng.standard_normal((4, 3, 2)),
    }, attrs={"timee": 12.5, "dt": 0.25, "ntrun": 7})


@pytest.mark.parametrize("members", [1, 9, 70, 300])
@pytest.mark.parametrize("writer", ["port", "h5py"])
def test_round_trip(tmp_path, writer, members):
    tree = sample_tree(members)
    path = tmp_path / "t.h5"
    if writer == "port":
        hdf5.write(path, tree)
        assert_trees_equal(h5py_read(path), tree)
    else:
        h5py_write(path, tree)
    assert_trees_equal(hdf5.read(path), tree)


names = st.text("abcdefghijklmnopqrstuvwxyzABCXYZ0123456789_-",
                min_size=1, max_size=6)
leaves = st.sampled_from(DTYPES).flatmap(lambda dt: hnp.arrays(
    dt, hnp.array_shapes(min_dims=0, max_dims=3, min_side=0, max_side=4)))
attr_values = st.one_of(
    st.floats(allow_nan=False, width=64),
    st.integers(-2**63, 2**63 - 1),
    leaves.filter(lambda a: a.ndim == 0).map(lambda a: a[()]))


@st.composite
def trees(draw, depth=0):
    members = draw(st.dictionaries(
        names, leaves if depth == 2 else st.one_of(leaves, trees(depth + 1)),
        max_size=12 if depth else 20))
    return hdf5.Group(members,
                      attrs=draw(st.dictionaries(names, attr_values,
                                                 max_size=3)))


@pytest.mark.parametrize("writer", ["port", "h5py"])
@settings(max_examples=25, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture,
                                 HealthCheck.too_slow])
@given(tree=trees())
def test_round_trip_random_trees(tmp_path, writer, tree):
    path = tmp_path / "t.h5"
    path.unlink(missing_ok=True)
    if writer == "port":
        hdf5.write(path, tree)
        assert_trees_equal(h5py_read(path), tree)
    else:
        h5py_write(path, tree)
    assert_trees_equal(hdf5.read(path), tree)


def _chunked(f):
    f.create_dataset("x", data=np.zeros((4, 4)), chunks=(2, 2))


def _gzip(f):
    f.create_dataset("x", data=np.zeros((4, 4)), compression="gzip")


def _string(f):
    f.create_dataset("x", data="abc")


def _big_endian(f):
    f.create_dataset("x", data=np.zeros(3, ">f8"))


def _new_style_group(f):
    f.create_group("g", track_order=True)


@pytest.mark.parametrize("make, libver, what", [
    (_chunked, None, "chunked layout"),
    (_gzip, None, "filter pipeline"),
    (_string, None, "variable-length datatype"),
    (_big_endian, None, "big-endian"),
    (_new_style_group, None, "version 2 object header"),
    (lambda f: f.create_dataset("x", data=np.zeros(3)), "latest",
     "superblock version 3"),
], ids=["chunked", "gzip", "string", "big-endian", "track-order",
        "libver-latest"])
def test_unsupported_files_raise(tmp_path, make, libver, what):
    path = tmp_path / "t.h5"
    with h5py.File(path, "w", **({"libver": libver} if libver else {})) as f:
        make(f)
    with pytest.raises(ValueError, match=what):
        hdf5.read(path)


@pytest.mark.parametrize("value", [np.zeros(2, bool), np.zeros(2, complex),
                                   np.asarray("abc"), np.zeros(2, "<f2")],
                         ids=["bool", "complex", "str", "f16"])
def test_unsupported_dtypes_raise(tmp_path, value):
    with pytest.raises(ValueError, match="not supported"):
        hdf5.write(tmp_path / "t.h5", {"g": {"x": value}})


def test_not_an_hdf5_file_raises(tmp_path):
    (tmp_path / "t.h5").write_bytes(bytes(200))
    with pytest.raises(ValueError, match="no HDF5 signature"):
        hdf5.read(tmp_path / "t.h5")


@pytest.fixture(scope="module")
def eb8(tmp_path_factory):
    from udales_tpu_torch import cases
    return cases.stage_urban_eb(8, tmp_path_factory.mktemp("eb8"),
                                dtEB=0.5)


@pytest.mark.parametrize("direction", ["port-to-reference",
                                       "reference-to-port"])
def test_checkpoint_across_packages(eb8, tmp_path, direction):
    """``save_checkpoint`` of one package, ``load_checkpoint`` (with the
    model, so with the facet state) of the other: every leaf equal; both
    files hold the same names, dtypes, shapes and attributes."""
    import jax.numpy as jnp
    from udales_tpu.io import restart as jrestart
    from udales_tpu.run import load_case as jload_case
    from udales_tpu_torch.convert import state_from_numpy, state_to_numpy
    from udales_tpu_torch.io import restart as trestart
    from udales_tpu_torch.run import load_case
    from test_torch_openbc import jtree
    from test_torch_restart import assert_states_equal
    jmodel = jload_case(eb8, "900", dtype="float64")
    tmodel = load_case(eb8, "900", dtype="float64", device="cpu")
    rng = np.random.default_rng(8)
    jst = jmodel.cold_start(seed=43)
    jst = jst.replace(
        pres=jnp.asarray(rng.standard_normal(jst.pres.shape)),
        timee=jnp.asarray(12.5), dt=jnp.asarray(0.25),
        fac=dataclasses.replace(
            jst.fac, T=jst.fac.T + rng.uniform(-2, 2, jst.fac.T.shape),
            hfi=jnp.asarray(rng.standard_normal(jst.fac.hfi.shape))))
    tst = state_from_numpy(jtree(jst))
    jrestart.save_checkpoint(tmp_path / "ref.h5", jst, 5)
    trestart.save_checkpoint(tmp_path / "got.h5", tst, 5)
    assert_trees_equal(h5py_read(tmp_path / "got.h5"),
                       h5py_read(tmp_path / "ref.h5"))
    if direction == "port-to-reference":
        got = jtree(jrestart.load_checkpoint(tmp_path / "got.h5",
                                             jmodel.grid, model=jmodel))
    else:
        got = state_to_numpy(trestart.load_checkpoint(
            tmp_path / "ref.h5", tmodel.grid, model=tmodel))
    assert_states_equal(got, state_to_numpy(tst), skip=("facstats",))
    assert np.array_equal(got["fac"]["T"], state_to_numpy(tst)["fac"]["T"])


def test_no_port_module_imports_h5py():
    root = Path(udales_tpu_torch.__file__).parent
    importers = set()
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            if any(m.split(".")[0] == "h5py" for m in mods):
                importers.add(path.relative_to(root).as_posix())
    assert importers == {"prep/syntheticinflow.py"}
