"""The port's own host-side modules against the JAX package's (CPU).

``udales_tpu_torch`` keeps copies of the JAX-free host code it needs:
``config.py``, ``io/inputs.py`` and the ``prep`` modules that stage the urban
case.  The port imports nothing of ``udales_tpu``, so these tests are what
keeps the copies from drifting: the same inputs go through both packages and
the results must be identical (files byte for byte, parsed configurations
and arrays exactly equal; no tolerance, since it is the same NumPy code).
"""
import ast
import dataclasses
import filecmp
from pathlib import Path

import numpy as np
import pytest

import udales_tpu.config as jconfig
import udales_tpu.io.inputs as jinputs
from udales_tpu.prep.udgeom import create_cubes as jcreate_cubes

import udales_tpu_torch.config as tconfig
import udales_tpu_torch.io.inputs as tinputs
from udales_tpu_torch import cases
from udales_tpu_torch.prep.udgeom import create_cubes as tcreate_cubes

REPO = Path(__file__).resolve().parents[1]
SIZES = (16, 32)


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """{n: (reference case dir, port case dir)} of the urban case, staged by
    bench._stage_urban (udales_tpu.prep) and by cases.stage_urban
    (udales_tpu_torch.prep)."""
    import bench
    root = tmp_path_factory.mktemp("prep")
    out = {}
    old = bench.CACHE
    bench.CACHE = root / "ref"
    try:
        for n in SIZES:
            out[n] = (bench._stage_urban(n),
                      cases.stage_urban(n, root / "port"))
    finally:
        bench.CACHE = old
    return out


@pytest.mark.parametrize("n", SIZES)
def test_staged_files_are_byte_identical(staged, n):
    ref, got = staged[n]
    names = sorted(p.name for p in ref.iterdir())
    assert names == sorted(p.name for p in got.iterdir())
    assert len(names) >= 20
    match, mismatch, errors = filecmp.cmpfiles(ref, got, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


@pytest.mark.parametrize("n", SIZES)
def test_create_cubes_stl_is_byte_identical(tmp_path, n):
    pitch = n / 4.0
    args = (float(n), float(n), pitch / 2, pitch / 2, pitch, pitch / 2,
            pitch / 2, "AC")
    jcreate_cubes(*args, edgelength=pitch / 2).save(tmp_path / "ref.stl")
    tcreate_cubes(*args, edgelength=pitch / 2).save(tmp_path / "got.stl")
    assert (tmp_path / "ref.stl").read_bytes() \
        == (tmp_path / "got.stl").read_bytes()


@pytest.mark.parametrize("n", SIZES)
def test_parse_namelists_matches(staged, n):
    """The staged namelist through both parsers and both load_namoptions:
    equal dataclass trees."""
    nam = staged[n][1] / "namoptions.900"
    assert tconfig.parse_namelists(nam.read_text()) \
        == jconfig.parse_namelists(nam.read_text())
    for dtype in ("float32", "float64"):
        ref = jconfig.load_namoptions(nam, dtype=dtype)
        got = tconfig.load_namoptions(nam, dtype=dtype)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(tconfig.Config()) \
        == dataclasses.asdict(jconfig.Config())
    consts = lambda c: {k: v for k, v in vars(c).items()
                        if not k.startswith("_")}
    assert consts(tconfig.const) == consts(jconfig.const)


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None:
        assert b is None
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


READERS = {
    "prof": ("read_prof_inp", "prof.inp.900", lambda n: (n,)),
    "lscale": ("read_lscale_inp", "lscale.inp.900", lambda n: (n,)),
    "scalar": ("read_scalar_inp", "lscale.inp.900", lambda n: (n, 2)),
    "sparse_ijk": ("read_sparse_ijk", "solid_u.txt", lambda n: ()),
    "facet_sections": ("read_facet_sections", "facet_sections_c.txt",
                       lambda n: ()),
    "facets": ("read_facets_inp", "facets.inp.900", lambda n: ()),
    "column": ("read_column_file", "Tfacinit.inp.900", lambda n: ()),
}


@pytest.mark.parametrize("reader", sorted(READERS))
def test_input_readers_match(staged, reader):
    """Each reader of io/inputs.py on a staged file (scalar.inp has the
    layout of lscale.inp, which stands in for it): exactly equal arrays."""
    fn, name, extra = READERS[reader]
    for n in SIZES:
        path = staged[n][1] / name
        assert path.exists(), path
        _same(getattr(tinputs, fn)(path, *extra(n)),
              getattr(jinputs, fn)(path, *extra(n)))


def test_case_inputs_and_pressure_gradient_match(staged):
    case = staged[32][1]
    ref = jinputs.CaseInputs.load(case, "900", 32)
    got = tinputs.CaseInputs.load(case, "900", 32)
    _same(dataclasses.asdict(got), dataclasses.asdict(ref))
    cfg = tconfig.load_namoptions(case / "namoptions.900")
    _same(tinputs.large_scale_pressure_gradient(got.lscale, cfg),
          jinputs.large_scale_pressure_gradient(ref.lscale, cfg))
    with pytest.raises(ValueError, match="expected"):
        tinputs.read_sparse_ijk(case / "solid_u.txt", n_expected=1)


COPIES = ["config.py", "io/inputs.py", "prep/stl.py", "prep/geom.py",
          "prep/zgrid.py", "prep/ibmprep.py", "prep/udgeom.py",
          "prep/native.py", "prep/radiation.py", "prep/solar.py",
          "prep/weather.py", "prep/prep.py", "io/driverfiles.py",
          "prep/syntheticinflow.py", "prep/harmonie.py",
          "prep/vegetation.py", "prep/inps.py", "io/netcdf.py",
          "prep/__main__.py", "post.py", "vis.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copies_hold_the_originals_code(rel):
    """Apart from docstrings (which may name the package) a copied module
    has the original's syntax tree."""
    def tree(path):
        mod = ast.parse(path.read_text())
        for node in ast.walk(mod):
            body = getattr(node, "body", None)
            if (isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef))
                    and body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
        return mod
    ref = tree(REPO / "udales_tpu" / rel)
    got = tree(REPO / "udales_tpu_torch" / rel)
    assert ast.dump(got) == ast.dump(ref)


@pytest.mark.parametrize("kw", [dict(with_radiation=False)], ids=["trees"])
def test_formerly_unported_prep_branches_match(tmp_path, kw):
    """The trees branch of prepare_case, which used to raise: a trees.inp of
    two blocks (one with a leading id) expanded by both packages' prep into
    veg.inp / veg_params.inp byte for byte, and the counts equal."""
    from udales_tpu.prep.prep import PrepConfig as JPrepConfig
    from udales_tpu.prep.prep import prepare_case as jprepare
    from udales_tpu_torch.prep.prep import PrepConfig, prepare_case
    n = 8
    tcreate_cubes(float(n), float(n), 2.0, 2.0, 2.0, 2.0, 2.0, "AC",
                  edgelength=2.0).save(tmp_path / "geom.stl")
    trees = tmp_path / "trees.inp"
    trees.write_text("# il iu jl ju kl ku\n3 4 1 2 1 2\n7 7 8 5 6 1 3\n")
    counts = {}
    for name, cls, fn in (("ref", JPrepConfig, jprepare),
                          ("got", PrepConfig, prepare_case)):
        cfg = cls(itot=n, jtot=n, ktot=n, xlen=float(n), ylen=float(n),
                  zsize=float(n), expnr="900", trees_file=str(trees), **kw)
        counts[name] = fn(tmp_path / "geom.stl", tmp_path / name, cfg)
    assert counts["got"] == counts["ref"] and counts["got"]["ntrees"] == 20
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert {"veg.inp.900", "veg_params.inp.900"} <= set(names)
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "ref",
                                               tmp_path / "got", names,
                                               shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_inps_case_regenerates_identically(tmp_path):
    """prepare_from_case (prep/inps.py) on a case whose &INPS group names
    its STL, profiles, a tree file and a scalar line and point source: both
    packages write the same files byte for byte (scalar.inp and the source
    files included) and patch &WALLS into the namelist alike."""
    from udales_tpu.prep import inps as jinps
    from udales_tpu.prep.prep import make_box_stl
    from udales_tpu_torch.prep import inps as tinps
    src = tmp_path / "case"
    src.mkdir()
    make_box_stl(src / "box.stl", 4, 8, 4, 8, 6, 12.0, 12.0)
    (src / "trees.inp.301").write_text("2 3 2 3 1 2\n")
    (src / "namoptions.301").write_text(
        "&RUN\niexpnr = 301\nlibm = .true.\n/\n&DOMAIN\nitot = 12\n"
        "jtot = 12\nktot = 12\nxlen = 12.\nylen = 12.\n/\n"
        "&SCALARS\nnsv = 2\nlscasrcl = .true.\nnscasrcl = 1\n"
        "lscasrc = .true.\nnscasrc = 1\n/\n&WALLS\nnfcts = 0\n/\n"
        "&INPS\nstl_file = 'box.stl'\nzsize = 12.\nu0 = 1.2\n"
        "thl0 = 289.\nsv10 = 0.5\nsv20 = 2.\ntreesfile = 'trees.inp.301'\n"
        "xSb = 2.\nySb = 0.\nzSb = 1.\nxSe = 2.\nySe = 12.\nzSe = 1.\n"
        "SSl = 1.5\nsigSl = 0.8\nxS = 10.\nyS = 6.\nzS = 2.\nSSp = 3.\n"
        "sigSp = 0.7\nltrees = .true.\n/\n")
    counts = {name: mod.prepare_from_case(src, tmp_path / name)
              for name, mod in (("ref", jinps), ("got", tinps))}
    assert counts["got"] == counts["ref"] and counts["got"]["nfcts"] > 0
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert {"namoptions.301", "scalar.inp.301", "scalarsourcel.inp.1.301",
            "scalarsourcep.inp.1.301", "veg.inp.301"} <= set(names)
    assert names == sorted(p.name for p in (tmp_path / "got").iterdir())
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "ref",
                                               tmp_path / "got", names,
                                               shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def _weather_table(path):
    """A synthetic day of hourly records in the reference column layout
    (as tests/test_weather.py writes it)."""
    rows = ["date TIME SOLAR SOLAR_1 HELIOM DIFSOLAR"]
    for h in range(24):
        if 6 <= h <= 18:
            zen = 30.0 + 60.0 * abs(h - 12) / 6.0
            beam, dsky = 800.0 * max(np.cos(np.radians(zen)), 0.0), 120.0
        else:
            zen, beam, dsky = 120.0, 0.0, 0.0
        rows.append(f"300911 {h*3600} {zen:.1f} {180.0 - 15.0*(h-12):.1f} "
                    f"{beam:.1f} {dsky:.1f}")
    path.write_text("\n".join(rows) + "\n")
    return path


@pytest.mark.parametrize("pathway", ["fixed-sun", "solar", "weather"])
def test_radiation_pathways_write_identical_cases(tmp_path, pathway):
    """prepare_case with the radiation inputs on, by the fixed sun angles,
    the date/site solar state (prep/solar.py) and a measured weather table
    (prep/weather.py): both packages write the same bytes."""
    from udales_tpu.prep import prep as jprep
    from udales_tpu_torch.prep import prep as tprep
    kw = {"fixed-sun": {},
          "solar": dict(solar_datetime="2011-06-21T12:00", latitude=52.0,
                        longitude=4.4, timezone=1.0, xazimuth=20.0),
          "weather": dict(solar_datetime="2011-09-30T11:00",
                          weather_file=str(_weather_table(tmp_path / "wx")))
          }[pathway]
    dirs = {}
    for name, mod in (("ref", jprep), ("got", tprep)):
        stl = tmp_path / f"{name}.stl"
        mod.make_box_stl(stl, 4, 8, 4, 8, 6, 12.0, 12.0)
        cfg = mod.PrepConfig(itot=12, jtot=12, ktot=12, xlen=12.0, ylen=12.0,
                             zsize=12.0, expnr="001", with_radiation=True,
                             vf_subdiv=1, **kw)
        dirs[name] = tmp_path / name
        mod.prepare_case(stl, dirs[name], cfg)
    names = sorted(p.name for p in dirs["ref"].iterdir())
    assert names == sorted(p.name for p in dirs["got"].iterdir())
    assert {"netsw.inp.001", "svf.inp.001", "vfsparse.inp.001"} <= set(names)
    match, mismatch, errors = filecmp.cmpfiles(dirs["ref"], dirs["got"],
                                               names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    nsw = np.loadtxt(dirs["got"] / "netsw.inp.001", skiprows=1)
    assert np.isfinite(nsw).all() and nsw.max() > 0


def test_solar_and_weather_functions_match(tmp_path):
    """solar_state and the weather readers of both packages: equal."""
    from datetime import datetime
    from udales_tpu.prep import solar as jsolar, weather as jweather
    from udales_tpu_torch.prep import solar as tsolar, weather as tweather
    when = datetime(2011, 6, 21, 10, 30)
    _same(tsolar.solar_state(when, 51.5, -0.1, 0.0, 35.0),
          jsolar.solar_state(when, 51.5, -0.1, 0.0, 35.0))
    wx = _weather_table(tmp_path / "wx")
    _same(tweather.read_weather_table(wx), jweather.read_weather_table(wx))
    noon = datetime(2011, 9, 30, 12)
    _same(tweather.weather_single_shot(wx, noon),
          jweather.weather_single_shot(wx, noon))
    _same(tweather.weather_day_series(wx, noon)[:2],
          jweather.weather_day_series(wx, noon)[:2])


def test_synthetic_inflow_outputs_match(tmp_path):
    """generate_synthetic_inflow of both packages from one seed: the same
    times, the same ``?driver_*`` files byte for byte, the same h5 series."""
    import h5py
    from udales_tpu.prep import syntheticinflow as jsyn
    from udales_tpu_torch.prep import syntheticinflow as tsyn
    ny, nz = 10, 8
    z = np.arange(nz) + 0.5
    kw = dict(ny=ny, nz=nz, dy=1.0, dzf=np.ones(nz), t_end=1.0, dt=0.1,
              u_mean=1.0 + 0.1 * z, uu=np.full(nz, 0.04), vv=np.full(nz, 0.02),
              ww=np.full(nz, 0.01), uw=np.full(nz, -0.005), Ly=2.0, Lz=2.0,
              Tscale=0.5, thl_mean=288.0 + 0.0 * z, tt=np.full(nz, 0.01),
              wth=np.full(nz, 0.001), expnr="123", seed=11)
    out = {}
    for name, mod in (("ref", jsyn), ("got", tsyn)):
        d = tmp_path / name
        d.mkdir()
        out[name] = mod.generate_synthetic_inflow(d / "driverdata.123.h5",
                                                  fortran_dir=d, **kw)
    _same(out["got"], out["ref"])
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "got").iterdir())
    assert {"udriver_000.123", "hdriver_000.123", "tdriver_000.123"} \
        <= set(names)
    for name in names:
        a, b = tmp_path / "ref" / name, tmp_path / "got" / name
        if name.endswith(".h5"):
            with h5py.File(a) as fa, h5py.File(b) as fb:
                assert sorted(fa) == sorted(fb)
                for k in fa:
                    _same(fb[k][()], fa[k][()])
        else:
            assert a.read_bytes() == b.read_bytes(), name


def test_harmonie_outputs_match(tmp_path):
    """The HARMONIE radiation coupling of both packages on one accumulated
    series: the same flux decomposition, atmosphere and written files."""
    from datetime import datetime
    from udales_tpu.prep import harmonie as jhm
    from udales_tpu_torch.prep import harmonie as thm
    start = datetime(2023, 8, 2, 8, 0)
    offsets = np.arange(6 * 3600 - 900, 9 * 3600 + 901, 900)
    accum = 2.0e5 * (offsets / 3600.0) ** 1.5
    strd = 3.0e5 * offsets / 900.0
    res = {}
    for name, mod in (("ref", jhm), ("got", thm)):
        atmos = mod.harmonie_shortwave_atmosphere(
            offsets, accum, start, 3 * 3600.0, 1800.0, 48.0, 2.0, 2.0)
        lw = mod.harmonie_longwave_series(offsets, strd, 3 * 3600.0, 1800.0)
        d = tmp_path / name
        d.mkdir()
        mod.write_weather_table(d / "weather.txt", atmos, start)
        mod.write_timedeplw(d / "timedeplw.inp.001", *lw)
        mod.write_timedepsw(d / "timedepsw.inp.001", atmos.times,
                            np.outer(atmos.ghi, np.arange(1.0, 4.0)))
        res[name] = (mod.accumulated_to_flux(offsets, accum),
                     dataclasses.asdict(atmos), lw,
                     mod.erbs_diffuse_fraction(0.5))
    _same(res["got"], res["ref"])
    assert res["ref"][1]["ghi"].max() > 0
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "ref", tmp_path / "got", names, shallow=False)
    assert len(match) == 3 and not mismatch and not errors


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every import statement (any depth, also inside functions) of every
    module of the port and of chip_smoke.py: none names ``jax`` or
    ``udales_tpu``."""
    files = sorted((REPO / "udales_tpu_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    bad = []
    for path in files:
        for lineno, name in _imports(ast.parse(path.read_text())):
            if name.split(".")[0] in ("jax", "jaxlib", "udales_tpu"):
                bad.append(f"{path.relative_to(REPO)}:{lineno}: {name}")
    assert not bad, bad
    assert not hasattr(cases, "numpy_grid")
