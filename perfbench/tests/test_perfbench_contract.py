"""BENCHMARK.json against the benchmark's contract, and every file it
names."""
import json
import math
import re

import pytest

from perfbench.tests.cells import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
#: Keys of a configuration that name a width, which ``reduced`` may not.
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head_dim|d_model|d_ff|expansion|top_k|"
                   r"experts_per_tok)")
CELLS = [w["name"] for w in SPEC["workloads"]]


def metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def cells_of(metric):
    return metric.get("workloads", CELLS)


def test_top_level_keys_and_size():
    assert set(SPEC) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    cmd, paths = SPEC["command"], SPEC["paths"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word


def test_run_seconds_fits_a_full_check():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]]
                         + CELLS + [m["name"] for m in metrics()])
def test_names(name):
    assert NAME.match(name), name


def test_names_unique():
    for group in (SPEC["configs"], SPEC["workloads"], metrics()):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert LINE.match(cfg["source"]) and LINE.match(cfg["why"])
    assert cfg["file"].startswith("perfbench/configs/")
    assert cfg["source"].startswith("https://")
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key), key
        assert key in data and key in data.get("changed", {}), key
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])
    files = [c["file"] for c in SPEC["configs"]]
    assert files.count(cfg["file"]) == 1


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_entry(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert LINE.match(cell["why"]) and cell["chips"] in (1, 4)
    assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    assert cell["config"] in {c["name"] for c in SPEC["configs"]}
    traffic = BENCH / "traffic" / f"{cell['traffic']}.json"
    kind = json.loads(traffic.read_text())["kind"]
    assert (BENCH / "harness" / f"{kind}.py").is_file()
    assert (BENCH / "limits" / f"{cell['name']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, math.floor(0.25 * len(CELLS)))


@pytest.mark.parametrize("m", metrics(), ids=lambda m: m["name"])
def test_metric_entry(m):
    allowed = {"name", "unit", "better", "source"}
    if m in SPEC["end_to_end"]:
        allowed |= {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    assert set(m) - {"workloads"} == allowed
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert set(cells_of(m)) <= set(CELLS) and cells_of(m)


def test_setup_s_bound():
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_moves_an_end_to_end_metric_of_its_cells(m):
    e2e = {e["name"]: e for e in SPEC["end_to_end"]}
    assert m["moves"] in e2e
    assert set(cells_of(m)) <= set(cells_of(e2e[m["moves"]]))


def test_a_quantity_names_one_layer():
    """``x.train`` and ``x.prefill`` (one quantity in two kinds of cell)
    name the same layer, letter for letter."""
    layers = {}
    for m in SPEC["per_layer"]:
        base, _, kind = m["name"].rpartition(".")
        key = base if kind in ("train", "prefill") else m["name"]
        layers.setdefault(key, set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in SPEC["end_to_end"] if cell in cells_of(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in cells_of(m) for m in SPEC["per_layer"])


def test_roofline_and_mfu_names():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    roofline_moves = {m["moves"] for m in SPEC["per_layer"]
                      if m["name"].endswith("_roofline")}
    for moves in roofline_moves:
        assert any("mfu" in m["name"] and m["moves"] == moves
                   for m in SPEC["per_layer"])
