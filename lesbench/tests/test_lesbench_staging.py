"""The benchmark's own staging: its frozen copy writes the files the
program's staging and host prep write today, byte for byte, at small
sizes, cubic or not; the configurations' domains and buildings are the
source's array, and the staged case holds exactly those buildings."""
from __future__ import annotations

import filecmp
import hashlib
import json

import pytest

from lesbench import cases
from lesbench.harness import ROOT, load
from lesbench.reference.les import cases as frozen
from lesbench.tests.lesbench_small import small_config
from udales_tpu_torch import cases as program_cases

CONFIGS = ["urban_cubes", "urban_cubes_driven"]
# every configuration, with the cells along x of its small copy: the
# 512 x 512 x 128 array's is 64 x 64 x 16, 8 x 8 cubes of 4 cells
SMALL = {"urban_cubes": 16, "urban_cubes_driven": 16, "urban_cubes_512": 64}


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


def test_non_cubic_staging_matches_the_programs_prep(tmp_path):
    """The small copy of the 512 x 512 x 128 array, 64 x 64 x 16: the
    frozen staging writes what the program's own host prep writes with
    the same domain and array, and the template with the same values."""
    from udales_tpu_torch.prep.prep import PrepConfig, prepare_case
    from udales_tpu_torch.prep.udgeom import create_cubes
    cfg = small_config("urban_cubes_512", 64)
    dom, lay = cases.domain(cfg), cases.layout(cfg)
    assert dom == frozen.Domain(64, 64, 16, 64.0, 64.0, 16.0)
    ours = frozen.stage_urban(dom, tmp_path / "bench", lay)
    assert ours.name == "urban64x64x16v2"
    theirs = tmp_path / "program"
    theirs.mkdir()
    create_cubes(dom.xlen, dom.ylen, *lay[:5], "AC",
                 edgelength=lay.edge).save(theirs / "geom.stl")
    counts = prepare_case(theirs / "geom.stl", theirs, PrepConfig(
        itot=64, jtot=64, ktot=16, xlen=64.0, ylen=64.0, zsize=16.0,
        expnr="900", u0=1.5, thl0=290.0, facT0=295.0, with_radiation=False,
        vf_subdiv=1))
    (theirs / "namoptions.900").write_text(
        frozen.namelist_text(frozen._NAMELIST, dom, counts))
    _same_tree(ours, theirs)


@pytest.mark.parametrize("config", CONFIGS + ["urban_cubes_512"])
def test_case_dir_stages_the_configuration(tmp_path, config):
    """The case of a configuration: whole, renamed into place with
    nothing half-staged beside it, and holding the configuration's
    buildings (2 x 2 cubes of 4 cells at 16^3; 8 x 8 at 64 x 64 x 16)."""
    cfg = small_config(config, SMALL[config])
    ours = cases.case_dir(cfg, tmp_path / "bench")
    assert [p.name for p in (tmp_path / "bench").iterdir()] == [ours.name]
    assert ours.name.startswith(config + "-")
    nx, ny = cfg["geometry"]["cubes"]
    assert len(cases.solid_cells(cfg)) == nx * ny * 4 ** 3
    cases.check_geometry(cfg, ours)


# the parent's case names of the full configurations, and digests of the
# cases it staged from their small copies at 16^3 (name and bytes of each
# file): this staging leaves both as they were
PARENT = {
    "urban_cubes": ("urban_cubes-41adb892708d", "b010b42a2e3e6da5f45f889b"
                    "e84a1e61071554b80f8e3a96b280ad3721960931"),
    "urban_cubes_driven": ("urban_cubes_driven-24e998ebba26",
                           "658f1c3e14616c8e1244bef077868ccee7d44c4563f3f823"
                           "c09540e5300a3df3"),
}


@pytest.mark.parametrize("config", CONFIGS)
def test_cache_keys_and_staged_bytes_are_the_parents(tmp_path, config):
    name, digest = PARENT[config]
    assert cases.case_name(load("configs", config)) == name
    case = cases.case_dir(small_config(config, 16), tmp_path)
    h = hashlib.sha256()
    for p in sorted(case.iterdir()):
        h.update(p.name.encode())
        h.update(hashlib.sha256(p.read_bytes()).digest())
    assert h.hexdigest() == digest


@pytest.mark.parametrize("key,value,message", [
    ("ktot", 8, "n = 16"), ("xlen", 32.0, "cells of 1 m")])
def test_a_domain_that_disagrees_is_refused(tmp_path, key, value, message):
    """A configuration whose n and &DOMAIN disagree, or whose &DOMAIN's
    lengths are not its cells, is refused before anything is staged."""
    cfg = small_config("urban_cubes", 16)
    cfg["namelist"]["DOMAIN"][key] = value
    with pytest.raises(ValueError, match=message):
        cases.case_dir(cfg, tmp_path)
    assert list(tmp_path.iterdir()) == []


def test_geometry_check_refuses_other_buildings(tmp_path):
    """The program's own array staged under a configuration that states
    Coceal's cubes is refused."""
    cfg = small_config("urban_cubes", 16)
    other = frozen.stage_urban(16, tmp_path)
    with pytest.raises(ValueError, match="solid cells"):
        cases.check_geometry(cfg, other)


@pytest.mark.parametrize("config", CONFIGS + ["urban_cubes_512"])
def test_geometry_is_the_sources_array(config):
    """Coceal et al. 2006's aligned array as the configuration states it:
    cubes (as wide as tall) of side h at lambda_p = 0.25, the source's
    2 x 2 unit repeated so that `cubes` of them at their pitch fill the
    domain, which is 4h high, h resolved by 32 cells; a cubic
    configuration's n is its &DOMAIN."""
    cfg = load("configs", config)
    g, dom = cfg["geometry"], cfg["namelist"]["DOMAIN"]
    h = g["h_m"]
    assert g["box_m"] == [h, h, h]
    nx, ny = g["cubes"]
    assert nx % 2 == ny % 2 == 0
    assert g["lambda_p"] == 0.25 == nx * ny * h * h / (dom["xlen"]
                                                       * dom["ylen"])
    pitch = [b + s for b, s in zip(g["box_m"][:2], g["street_m"])]
    assert pitch == [2 * h, 2 * h]
    assert [nx * pitch[0], ny * pitch[1]] == [dom["xlen"], dom["ylen"]]
    assert [dom["xlen"], dom["ylen"], dom["ktot"] * g["cell_m"]] == \
        [d * h for d in g["domain_h"]] == [nx * 2 * h, ny * 2 * h, 4 * h]
    assert h / g["cell_m"] == g["cells_per_h"] == 32
    assert [dom["itot"], dom["jtot"]] == [dom["xlen"] / g["cell_m"],
                                          dom["ylen"] / g["cell_m"]]
    if "n" in cfg:
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
