"""A new model kind and a cut configuration join the benchmark with new
files and new entries only.

``probe_kind/`` holds them, laid out as the benchmark's folder is: a
model kind ``probe`` (a two-layer MLP: its glue to the port, its work
and its plain reference), a configuration cut to a slice of its head
(``reduced`` and ``published``), the limits of a cell of it on
``img-b256``, and in ``entries.json`` what it adds to
``BENCHMARK.json``. A copy of the benchmark takes them; the cases of the
CPU tests that concern the probe then pass there, its tiny run is
``correct`` and not under the half-batch fault, and no file that the
copy took from the repository has changed. Beside that: each kind's CPU
size comes from its own module, and the sizes the kinds had before they
moved there are kept.
"""
import json
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from cb_testkit import CELLS, HERE, STAGED, tiny
from cbench import spec

ROOT = HERE.parent
PROBE = HERE / "probe_kind"
TESTS = ("test_cb_discovery.py", "test_cb_isolation.py", "test_cb_items.py",
         "test_cb_oracle.py", "test_cb_run.py")
#: the cases that concern the probe, which have to pass in the copy
WANT = {
    "test_cb_discovery.py::test_cell_resolves[probe-mlp-b256]",
    "test_cb_discovery.py::test_cpu_size_is_the_kinds_own[probe-mlp-b256]",
    "test_cb_discovery.py::test_config_file_holds_what_runs[probe-mlp]",
    "test_cb_discovery.py::test_metric_reader_found_by_name[board_w.probe]",
    "test_cb_discovery.py::test_every_traffic_and_config_file_is_used",
    *(f"test_cb_isolation.py::test_no_jax_and_no_jax_package"
      f"[cbench/{kind}/probe.py]" for kind in ("models", "reference", "work")),
    "test_cb_isolation.py::test_references_import_torch_and_each_other_only"
    "[probe.py]",
    "test_cb_items.py::test_traffic_makes_what_the_model_kind_counts"
    "[probe-mlp-b256]",
    *(f"test_cb_oracle.py::test_reference_follows_the_port_in_fp32"
      f"[{seed}-probe-mlp-b256]" for seed in (0, 2 ** 31 + 11, -5)),
    "test_cb_oracle.py::test_leaves_are_the_ports_tree[probe-mlp-b256]",
    "test_cb_run.py::test_sound_run_is_correct_and_its_line_has_the_schema"
    "[probe-mlp-b256]",
    "test_cb_run.py::test_traced_run_reports_per_layer_metrics"
    "[probe-mlp-b256]",
    "test_cb_run.py::test_a_broken_timed_path_is_not_correct"
    "[probe-mlp-b256-half_batch]",
    "test_cb_run.py::test_a_broken_timed_path_is_not_correct"
    "[probe-mlp-b256-state_unchanged]",
}
#: the CPU sizes of the kinds as the tests ran them before each kind's
#: module gave its own (configuration keys, traffic keys)
BEFORE = {
    "lm": (dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
                d_ff=128, vocab=500),
           dict(seq_len=32, global_batch=4, microbatches=2)),
    "resnet": (dict(stage_sizes=[1, 1, 1, 1], width=8, n_classes=16,
                    img_size=32),
               dict(global_batch=8)),
}


def _with(bench: dict, entries: dict) -> dict:
    """``bench`` with the entries appended, and the new cells added to
    the ``workloads`` of the end-to-end metrics ``entries`` names."""
    out = json.loads(json.dumps(bench))
    for group in ("configs", "workloads", "per_layer"):
        out[group] += entries[group]
    cells = [w["name"] for w in entries["workloads"]]
    for m in out["end_to_end"]:
        if m["name"] in entries["end_to_end_workloads"]:
            m["workloads"] += cells
    return out


def _without(bench: dict, entries: dict) -> dict:
    """``bench`` with every name that ``entries`` adds taken out again."""
    out = json.loads(json.dumps(bench))
    for group in ("configs", "workloads", "per_layer"):
        names = {e["name"] for e in entries[group]}
        out[group] = [e for e in out[group] if e["name"] not in names]
    cells = {w["name"] for w in entries["workloads"]}
    for m in out["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w not in cells]
    return out


def _checkout(dst):
    """A checkout of ``BENCHMARK.json`` and the benchmark's folder, with
    the probe's files and entries added; ``{path: bytes}`` of the files
    it took from the repository."""
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    shutil.copytree(HERE, dst / HERE.name, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache", "out", PROBE.name))
    taken = {p.relative_to(dst): p.read_bytes()
             for p in dst.rglob("*") if p.is_file()}
    for src in sorted(PROBE.rglob("*")):
        if not src.is_file() or src.name == "entries.json" \
                or "__pycache__" in src.parts:
            continue
        dest = dst / HERE.name / src.relative_to(PROBE)
        assert dest.parent.is_dir() and not dest.exists(), dest
        shutil.copy(src, dest)
    entries = json.loads((PROBE / "entries.json").read_text())
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    (dst / "BENCHMARK.json").write_text(
        json.dumps(_with(bench, entries), indent=1) + "\n")
    return taken, entries


def test_a_new_kind_and_a_cut_configuration_join_with_new_files_only(
        tmp_path):
    taken, entries = _checkout(tmp_path)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTEST_ADDOPTS", "PYTHONPATH")}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["PYTHONDONTWRITEBYTECODE"] = "1"
    expr = "probe or test_every_traffic_and_config_file_is_used"
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-k", expr,
         *(f"{HERE.name}/{t}" for t in TESTS)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    tail = p.stdout[-4000:] + p.stderr[-2000:]
    assert p.returncode == 0, tail
    passed = {m.split("/", 1)[1] for m in
              re.findall(r"^PASSED (\S+)", p.stdout, re.MULTILINE)}
    assert passed == WANT, tail
    original = json.loads(taken.pop(Path("BENCHMARK.json")))
    for rel, data in taken.items():
        assert (ROOT / rel).read_bytes() == data, rel
        assert (tmp_path / rel).read_bytes() == data, rel
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    assert bench != original
    assert _without(bench, entries) == original


def test_the_probe_is_not_in_the_benchmark():
    entries = json.loads((PROBE / "entries.json").read_text())
    bench = spec.load_benchmark()
    assert _without(bench, entries) == bench
    assert not {w["name"] for w in entries["workloads"]} & set(CELLS)


@pytest.mark.parametrize("name", CELLS + sorted(STAGED))
def test_cpu_size_is_as_before_it_moved_to_the_kind(name):
    """Exactly the configuration and traffic that the CPU tests ran each
    cell at before, from the files and the literal sizes above."""
    cell = tiny(name, "bfloat16")
    if name in STAGED:
        conf, traffic = STAGED[name]
        config = spec._json(HERE / "configs" / f"{conf}.json")
        traffic = spec._json(spec.traffic_file(traffic))
    else:
        full = spec.find_cell(spec.load_benchmark(), name)
        config, traffic = full.config, full.traffic
    sizes, traffic_sizes = BEFORE[config["arch"]]
    assert cell.config == dict(config, **sizes, dtype="bfloat16",
                               param_dtype="bfloat16")
    assert cell.traffic == dict(traffic, **traffic_sizes)


def test_a_kind_without_a_cpu_size_is_refused(monkeypatch):
    bare = types.ModuleType("cbench.models.bare")
    bare.ITEMS = "images"
    monkeypatch.setattr(spec, "arch_module", lambda kind, arch: bare)
    with pytest.raises(ValueError, match=r"cbench\.models\.bare"):
        tiny(CELLS[0])
