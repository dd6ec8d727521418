"""``BENCHMARK.json`` against the contract's shape, and every file it
names found by name: configurations, traffic, limits, the model kinds'
modules and the per-layer metrics' readers."""
import json
import math
import re

import pytest

from cb_testkit import CELLS, HERE, STAGED, tiny
from cbench import check, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = [m["name"] for m in BENCH["per_layer"]]
CHECKED = ("loss_gap", "loss1_gap", "grad_gap", "grad_median_gap",
           "change_gap", "change_median_gap", "grad_diff_median")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["caraml_bench"]
    assert BENCH["command"] == ["python3", "caraml_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    total = 2 + 14 * 24
    assert total * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_bounds():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    layers = {}
    for m in BENCH["per_layer"]:
        base = m["name"].split(".")[0]
        assert layers.setdefault(base, m["layer"]) == m["layer"]
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.find_cell(BENCH, name)
    assert cell.chips == 1
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:        # every metric moves one it reports
        assert m["moves"] in e2e
    names = check.compared(cell.limits)
    assert names and set(names) <= set(CHECKED)
    for n in names:
        v = cell.limits[n]
        assert v["lower"] < v["limit"] < v["upper"]
    for kind in ("models", "work", "reference"):
        assert spec.arch_module(kind, cell.arch)
    assert cell.traffic["kind"] in ("lm_tokens", "images")


@pytest.mark.parametrize("name", CELLS + sorted(STAGED))
def test_cpu_size_is_the_kinds_own(name):
    """The CPU tests run a cell at its model kind's ``TINY`` and
    ``TINY_TRAFFIC``, whatever the kind."""
    cell = tiny(name)
    models = spec.arch_module("models", cell.arch)
    assert {k: cell.config[k] for k in models.TINY} == models.TINY
    assert {k: cell.traffic[k] for k in models.TINY_TRAFFIC} \
        == models.TINY_TRAFFIC


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (HERE / "configs").glob("*.json")))
def test_config_file_holds_what_runs(name):
    """A configuration cut to fit the card lists each key it cut in
    ``reduced`` and gives the key's published value in its file's
    ``published``; one that runs whole has neither. ``params`` counts
    the leaves of the file as it runs, cut or not."""
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    assert cfg["name"] == name
    published = cfg.get("published", {})
    assert isinstance(published, dict)
    for key, value in published.items():
        assert key in cfg and cfg[key] != value, key
    entry = next((c for c in BENCH["configs"] if c["name"] == name), None)
    if entry is not None:
        assert entry["file"] == f"caraml_bench/configs/{name}.json"
        assert cfg["source"].startswith(entry["source"].split(" ")[0])
        assert len(entry["reduced"]) <= 16
        assert all(NAME.match(k) for k in entry["reduced"])
        assert sorted(entry["reduced"]) == sorted(published)
    models = spec.arch_module("models", cfg["arch"])
    n = sum(math.prod(s) for _n, s, *_ in models.leaf_specs(cfg))
    assert n == cfg["params"]


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found_by_name(name):
    mod = spec.metric_module(name)
    assert callable(mod.read)
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert all(w in CELLS for w in entry["workloads"])


def test_every_traffic_and_config_file_is_used():
    """By a cell of BENCHMARK.json or a staged one; only the benchmark's
    cells have limits."""
    used = {w["traffic"] for w in BENCH["workloads"]}
    used |= {t for _c, t in STAGED.values()}
    assert used == {p.stem for p in (HERE / "traffic").glob("*.json")}
    confs = {c["file"].split("/")[-1][:-5] for c in BENCH["configs"]}
    confs |= {c for c, _t in STAGED.values()}
    assert confs == {p.stem for p in (HERE / "configs").glob("*.json")}
    assert not set(STAGED) & set(CELLS)
    limits = {p.stem for p in (HERE / "limits").glob("*.json")}
    assert limits == set(CELLS)
