"""The port's copy of the postprocessing (``udales_tpu_torch/post.py``)
against udales_tpu's, on outputs the port itself writes (CPU).

The staged 16^3 urban energy-balance case (``cases.stage_urban_eb``) runs
for 1 s through the port's ``Simulation`` with the field dump, the
statistics families, a k slice and the facet outputs on.  Both packages'
``UDPost`` then load the case and those files, and every array they return
must be equal: case inputs, every variable of every output family, the
surface energy balance, the facet properties, averages and facet-to-field
conversions.  ``merge_stat`` and ``coarsegrain_field`` are held against the
originals on seeded numpy input.  Nothing here reads a reference checkout.
"""
import numpy as np
import pytest

from udales_tpu import post as jpost

from udales_tpu_torch import cases
from udales_tpu_torch import post as tpost
from udales_tpu_torch.run import load_case
from udales_tpu_torch.sim import Simulation

N = 16
FAMILIES = ["fielddump", "xytdump", "tdump", "kslicedump", "fac", "facT",
            "facEB"]


@pytest.fixture(scope="module")
def posts(tmp_path_factory):
    """(udales_tpu's UDPost, the port's UDPost) of the case and the files
    the port's Simulation wrote."""
    root = tmp_path_factory.mktemp("post")
    case = cases.with_namelist(
        cases.stage_urban_eb(N, root, dtEB=0.5), root / "case",
        OUTPUT=dict(lfielddump=True, fieldvars="u0,v0,w0,th,pr",
                    tfielddump=0.5, lxytdump=True, ltdump=True,
                    lkslicedump=True, kslice=3, tsample=0.25,
                    tstatsdump=0.5),
        WALLS=dict(lwritefac=True, dtfac=0.5),
        ENERGYBALANCE=dict(lwriteEBfiles=True), RUN=dict(trestart=1e4))
    out = root / "out"
    model = load_case(case, "900", dtype="float64", device="cpu")
    Simulation(model, out, monitor=False).run(runtime=1.0)
    return (jpost.UDPost("900", case, outdir=out),
            tpost.UDPost("900", case, outdir=out))


def assert_same(got, ref, what=""):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), what
        for k in ref:
            assert_same(got[k], ref[k], f"{what}.{k}")
    elif ref is None:
        assert got is None, what
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref),
                                      err_msg=what)


def test_case_inputs_match(posts):
    ref, got = posts
    for name in ("itot", "jtot", "ktot", "xlen", "ylen", "nfcts", "nsv",
                 "xt", "yt", "zt", "dzt", "dx", "dy", "zsize", "facets",
                 "facnorm", "faca"):
        assert_same(getattr(got, name), getattr(ref, name), name)
    assert_same(got.facsec, ref.facsec, "facsec")
    assert_same(got.load_solid_masks(), ref.load_solid_masks(), "masks")
    assert_same(got.load_prof(), ref.load_prof(), "prof")
    assert_same(got.load_lscale(), ref.load_lscale(), "lscale")
    assert_same(got.load_scalar_sources(), ref.load_scalar_sources())
    assert_same(got.load_veg(), ref.load_veg(), "veg")
    assert got.describe() == ref.describe()
    for fam in FAMILIES:
        assert f"{fam}" in got.describe()


@pytest.mark.parametrize("fam", FAMILIES)
def test_output_family_matches(posts, fam):
    ref, got = posts
    d_ref, d_got = ref._open(fam), got._open(fam)
    try:
        names = sorted(d_ref.variables())
        assert names and sorted(d_got.variables()) == names
        assert len(d_ref.time) >= 2
        assert_same(d_got.time, d_ref.time, f"{fam}.time")
        assert d_got.dims == d_ref.dims
        for v in names:
            a = d_ref[v]
            assert np.isfinite(a).all(), (fam, v)
            assert_same(d_got[v], a, f"{fam}.{v}")
    finally:
        d_ref.close()
        d_got.close()


LOADERS = {"fielddump": ("load_field", ()), "xytdump": ("load_stat_xyt", ()),
           "tdump": ("load_stat_t", ()), "kslicedump": ("load_slice", ("k",)),
           "fac": ("load_fac_momentum", ()),
           "facT": ("load_fac_temperature", ()),
           "facEB": ("load_fac_eb", ())}


@pytest.mark.parametrize("fam", FAMILIES)
def test_loader_of_each_family_matches(posts, fam):
    """The family's UDPost loader, for every variable of its file."""
    ref, got = posts
    name, args = LOADERS[fam]
    d = getattr(ref, name)(*args)
    names = sorted(d.variables())
    d.close()
    for v in names:
        assert_same(getattr(got, name)(*args, v),
                    getattr(ref, name)(*args, v), f"{fam}.{v}")


def test_surface_energy_balance_matches(posts):
    ref, got = posts
    seb_ref, seb_got = ref.load_seb(), got.load_seb()
    assert_same(seb_got, seb_ref, "seb")
    assert_same(got.area_average_seb(seb_got), ref.area_average_seb(seb_ref))
    assert np.isfinite(seb_got["Tsurf"]).all()


@pytest.mark.parametrize("prop", ["lGR", "z0", "z0h", "al", "em", "d", "C",
                                  "lam"])
def test_facet_properties_match(posts, prop):
    ref, got = posts
    assert_same(got.assign_prop_to_fac(prop), ref.assign_prop_to_fac(prop))


def test_facet_conversions_match(posts):
    ref, got = posts
    rng = np.random.default_rng(11)
    var = rng.standard_normal(ref.nfcts)
    sel = rng.random(ref.nfcts) < 0.5
    assert_same(got.area_average_fac(var), ref.area_average_fac(var))
    assert_same(got.area_average_fac(var, sel), ref.area_average_fac(var, sel))
    for g in "uvwc":
        assert_same(got.convert_fac_to_field(var, grid_type=g),
                    ref.convert_fac_to_field(var, grid_type=g), g)
    assert_same(got.convert_facflx_to_field(var),
                ref.convert_facflx_to_field(var))
    assert_same(got.calculate_frontal_properties(),
                ref.calculate_frontal_properties())
    t = np.linspace(0.0, 1.0, 7)
    x = rng.standard_normal((4, 7))
    assert_same(got.time_average(x, t), ref.time_average(x, t))


@pytest.mark.parametrize("form", ["mean", "variance", "covariance",
                                  "keywords"])
def test_merge_stat_matches_original(form):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((5, 4, 13))
    Y = rng.standard_normal((5, 4, 13))
    XpXp = rng.random((5, 4, 13))
    XpYp = rng.standard_normal((5, 4, 13))
    args = {"mean": ((X, 4), {}), "variance": ((X, XpXp, 3), {}),
            "covariance": ((X, Y, XpYp, 5), {}),
            "keywords": ((X, 2), dict(Y=Y, XpYp=XpYp))}[form]
    got = tpost.merge_stat(*args[0], **args[1])
    ref = jpost.merge_stat(*args[0], **args[1])
    assert_same(got, ref, form)
    assert_same(tpost.UDPost.merge_stat(*args[0], **args[1]), ref, form)


@pytest.mark.parametrize("lflt", [[2.0], [2.0, 4.0, 8.0]])
def test_coarsegrain_field_matches_original(lflt):
    rng = np.random.default_rng(4)
    var = rng.standard_normal((16, 12, 5))
    xm = (np.arange(16) + 0.5) * 1.0
    ym = (np.arange(12) + 0.5) * 1.0
    got = tpost.coarsegrain_field(var, lflt, xm, ym)
    assert_same(got, jpost.coarsegrain_field(var, lflt, xm, ym))
    assert got.shape == (16, 12, 5, len(lflt))
    assert_same(tpost.UDPost.coarsegrain_field(var, lflt, xm, ym), got)
