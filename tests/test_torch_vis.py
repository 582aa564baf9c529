"""The port's copy of the visualization (``udales_tpu_torch/vis.py``):
every ``UDVis`` plot renders headlessly (Agg) on cases the port stages, and
draws what udales_tpu's draws (the same axes, titles, artists and colour
limits).  The staged 16^3 urban energy-balance case serves every plot but
the vegetation and scalar-source ones, which take the staged 16^3
dispersion case (trees, line and point sources).  Nothing here reads a
reference checkout.
"""
import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from udales_tpu import post as jpost  # noqa: E402

from udales_tpu_torch import cases  # noqa: E402
from udales_tpu_torch import post as tpost  # noqa: E402
from udales_tpu_torch import vis as tvis  # noqa: E402


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    root = tmp_path_factory.mktemp("vis")
    return {"eb": cases.stage_urban_eb(16, root),
            "disp": cases.stage_urban_dispersion(16, root)}


@pytest.fixture(autouse=True)
def _close_figs():
    yield
    plt.close("all")


def both(staged, name):
    """(udales_tpu's UDPost, the port's UDPost) of a staged case."""
    return (jpost.UDPost("900", staged[name]), tpost.UDPost("900",
                                                            staged[name]))


def summary(fig):
    """What a figure draws: per axes its title, artist counts, limits and
    the colour limits of its mappables."""
    out = []
    for ax in fig.axes:
        clims = [tuple(np.round(c.get_clim(), 12)) for c in ax.collections
                 if c.get_array() is not None]
        out.append((ax.get_title(), ax.name, len(ax.collections),
                    len(ax.lines), len(ax.patches),
                    tuple(np.round(ax.get_xlim(), 9)), clims,
                    ax.get_legend() is not None))
    return out


PLOTS = {
    "show_geometry": ("eb", lambda v, p: v.show_geometry(plot_quiver=True)),
    "plot_fac_signed": ("eb", lambda v, p: v.plot_fac(
        np.linspace(-1.0, 2.0, p.nfcts))),
    "plot_fac_positive": ("eb", lambda v, p: v.plot_fac(
        np.linspace(1.0, 2.0, p.nfcts), title="T")),
    "plot_fac_type": ("eb", lambda v, p: v.plot_fac_type()),
    "plot_solid": ("eb", lambda v, p: v.plot_solid("u")),
    "plot_fluid_boundary": ("eb", lambda v, p: v.plot_fluid_boundary("w")),
    "plot_2dmap": ("eb", lambda v, p: v.plot_2dmap(
        np.random.default_rng(0).random((2, p.itot, p.jtot)),
        labels=["a", "b"])),
    "plot_profiles": ("eb", lambda v, p: v.plot_profiles()),
    "plot_dz_variation": ("eb", lambda v, p: v.plot_dz_variation()),
    "plot_lscale": ("eb", lambda v, p: v.plot_lscale()),
    "plot_veg": ("disp", lambda v, p: v.plot_veg()),
    "plot_scalar_source": ("disp", lambda v, p: v.plot_scalar_source()),
}


@pytest.mark.parametrize("plot", list(PLOTS))
def test_plot_renders_as_the_original(staged, plot):
    case, draw = PLOTS[plot]
    ref, got = both(staged, case)
    assert type(got.vis) is tvis.UDVis
    fig_ref, fig_got = draw(ref.vis, ref), draw(got.vis, got)
    assert fig_got.axes and summary(fig_got) == summary(fig_ref)
    fig_got.canvas.draw()      # renders under Agg


def test_plot_fac_signed_is_centred(staged):
    _, got = both(staged, "eb")
    fig = got.vis.plot_fac(np.linspace(-1.0, 2.0, got.nfcts))
    lo, hi = fig.axes[-1].get_ylim()
    assert lo == pytest.approx(-hi)


def test_saved_figures(staged, tmp_path):
    _, got = both(staged, "eb")
    got.vis.plot_profiles(save=True, outdir=tmp_path)
    got.vis.plot_dz_variation(save=True, outdir=tmp_path)
    got.vis.plot_lscale(save=True, outdir=tmp_path)
    for stem in ("profiles", "dz", "lscale"):
        assert (tmp_path / f"{stem}_900.png").stat().st_size > 0


def test_errors_as_the_original(staged):
    _, got = both(staged, "eb")
    with pytest.raises(ValueError, match="values for"):
        got.vis.plot_fac(np.zeros(3))
    with pytest.raises(ValueError, match="veg.inp"):
        got.vis.plot_veg()
    with pytest.raises(ValueError, match="scalar source"):
        got.vis.plot_scalar_source()
    with pytest.raises((ImportError, NotImplementedError)):
        got.vis.show_geometry(backend="pyvista")


def test_vis_imports_no_plotting_package():
    """vis.py imports matplotlib and plotly only inside its functions, so
    the port imports where neither is installed (the card's machine)."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "sys.modules['plotly'] = None; "
            "import udales_tpu_torch.vis, udales_tpu_torch.post")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
