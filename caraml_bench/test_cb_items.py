"""A rate counts what its cells' traffic makes. ``cbench.runner`` reports
``<items>_per_s`` and ``<items>_per_wh`` from the window's items,
whatever ``<items>`` says, so the names are held here: a rate lists only
cells whose traffic ``kind`` makes ``<items>`` (``lm_tokens`` tokens,
``images`` images), which is also what the cell's model kind counts
(``ITEMS``)."""
import pytest

from cb_testkit import CELLS, STAGED, tiny
from cbench import spec

BENCH = spec.load_benchmark()
ITEMS_OF_KIND = {"lm_tokens": "tokens", "images": "images"}
RATES = [m for m in BENCH["end_to_end"]
         if m["name"].endswith(("_per_s", "_per_wh"))]


def _items(rate: str) -> str:
    return rate.rsplit("_per_", 1)[0]


@pytest.mark.parametrize("rate", RATES, ids=lambda m: m["name"])
def test_rate_lists_only_cells_that_make_its_items(rate):
    items = _items(rate["name"])
    per = "s" if rate["name"].endswith("_per_s") else "Wh"
    assert rate["unit"] == f"{items}/{per}"
    assert rate["workloads"]
    for name in rate["workloads"]:
        cell = spec.find_cell(BENCH, name)
        assert ITEMS_OF_KIND[cell.traffic["kind"]] == items, name


@pytest.mark.parametrize("name", CELLS + sorted(STAGED))
def test_traffic_makes_what_the_model_kind_counts(name):
    """And each cell of BENCHMARK.json reports both rates of its items."""
    cell = tiny(name)
    items = spec.arch_module("models", cell.arch).ITEMS
    assert ITEMS_OF_KIND[cell.traffic["kind"]] == items
    if name in CELLS:
        reported = {m["name"] for m in spec.find_cell(BENCH, name).end_to_end}
        assert {f"{items}_per_s", f"{items}_per_wh"} <= reported
