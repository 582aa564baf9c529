"""The benchmark's own staging: its frozen copy writes the files the
program's staging writes today, byte for byte, at small n; the
configurations' buildings are the source's array, and the staged case
holds exactly those buildings."""
from __future__ import annotations

import filecmp
import json

import pytest

from lesbench import cases
from lesbench.harness import ROOT, load
from lesbench.reference.les import cases as frozen
from lesbench.tests.lesbench_small import small_config
from udales_tpu_torch import cases as program_cases

CONFIGS = ["urban_cubes", "urban_cubes_driven"]


def _same_tree(a, b):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert [n for n in names if not filecmp.cmp(a / n, b / n,
                                                shallow=False)] == []


@pytest.mark.parametrize("config", CONFIGS)
def test_staging_matches_the_program(tmp_path, config):
    """The frozen staging with the program's own array (``bench.py``'s
    4 x 4 blocks) and the program's staging write the same bytes."""
    if config == "urban_cubes":
        ours = frozen.stage_urban(16, tmp_path / "bench")
        theirs = program_cases.stage_urban(16, tmp_path / "program")
    else:
        d = small_config(config, 16)["driver"]
        kw = dict(nt=d["nt"], chunk=d["chunk"], dtdriver=d["dtdriver"])
        ours = frozen.stage_urban_driven(16, tmp_path / "bench", **kw)
        theirs = program_cases.stage_urban_driven(16, tmp_path / "program",
                                                  **kw)
    _same_tree(ours, theirs)


@pytest.mark.parametrize("config", CONFIGS)
def test_case_dir_stages_the_configuration(tmp_path, config):
    """The case of a configuration: whole, renamed into place with
    nothing half-staged beside it, and holding the configuration's
    buildings (here 2 x 2 cubes of 4 cells at 16^3)."""
    cfg = small_config(config, 16)
    ours = cases.case_dir(cfg, tmp_path / "bench")
    assert [p.name for p in (tmp_path / "bench").iterdir()] == [ours.name]
    assert ours.name.startswith(config + "-")
    assert len(cases.solid_cells(cfg)) == 4 * 4 ** 3
    cases.check_geometry(cfg, ours)


def test_geometry_check_refuses_other_buildings(tmp_path):
    """The program's own array staged under a configuration that states
    Coceal's cubes is refused."""
    cfg = small_config("urban_cubes", 16)
    other = frozen.stage_urban(16, tmp_path)
    with pytest.raises(ValueError, match="solid cells"):
        cases.check_geometry(cfg, other)


@pytest.mark.parametrize("config", CONFIGS)
def test_geometry_is_the_sources_array(config):
    """Coceal et al. 2006's aligned array as the configuration states it:
    cubes (as wide as tall) of side h at lambda_p = 0.25, 2 x 2 of them in
    a domain 4h on each side, h resolved by 32 cells."""
    cfg = load("configs", config)
    g, dom = cfg["geometry"], cfg["namelist"]["DOMAIN"]
    h = g["h_m"]
    assert g["box_m"] == [h, h, h]
    assert g["cubes"] == [2, 2]
    nx, ny = g["cubes"]
    assert g["lambda_p"] == 0.25 == nx * ny * h * h / (dom["xlen"]
                                                       * dom["ylen"])
    pitch = [b + s for b, s in zip(g["box_m"][:2], g["street_m"])]
    assert [nx * pitch[0], ny * pitch[1]] == [dom["xlen"], dom["ylen"]]
    assert [dom["xlen"], dom["ylen"], cfg["n"] * g["cell_m"]] == \
        [d * h for d in g["domain_h"]] == [4 * h] * 3
    assert h / g["cell_m"] == g["cells_per_h"] == 32
    assert dom["itot"] == dom["jtot"] == dom["ktot"] == cfg["n"]


def test_driven_series_outlasts_the_window():
    """The full configuration's series, 0.1 s apart, against ~23 records a
    wall-second at the fastest driven step seen (22.5 ms at dt ~0.05 s)
    over a window of run_seconds, twice over."""
    cfg = load("configs", "urban_cubes_driven")
    d = cfg["driver"]
    seconds = json.loads((ROOT / "BENCHMARK.json").read_text())[
        "run_seconds"]
    assert d["nt"] >= 2 * 23 * seconds
    assert cfg["namelist"]["DRIVER"]["driverstore"] == d["nt"]
    n = cfg["n"]
    assert d["bytes"] == 8 * d["nt"] * (1 + 4 * (n + 2) * (n + 2))


def test_namelist_check_refuses_a_changed_value(tmp_path):
    cfg = small_config("urban_cubes", 16)
    case = cases.case_dir(cfg, tmp_path)
    cfg["namelist"]["BC"]["z0"] = 0.1
    with pytest.raises(ValueError, match="z0"):
        cases.check_namelist(cfg, case / "namoptions.900")
