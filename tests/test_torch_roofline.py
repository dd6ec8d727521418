"""The port's roofline model against the reference's, on the CPU.

  * ``model_flops`` equals the reference's for every (arch x shape) cell;
  * ``analyze`` with the reference's TPU v5e constants passed as keywords
    equals the reference's ``Roofline`` field for field, and with its
    own defaults uses one H100's (989 TFLOP/s bf16, 3.35 TB/s, NVLink's
    450 GB/s a direction);
  * ``CollectiveStats`` has the reference's schema;
  * ``largest_shapes`` over a ``ShapeTrace`` of a known program returns
    the reference's ``(bytes, count, shape_str)`` rows;
  * the ``roofline`` workload with no records writes an empty but green
    record for ``1xh100`` and defers the reference's two meshes.
"""
import dataclasses
import json

import pytest
import torch

from repro import configs as ref_configs
from repro.roofline import analysis as ref_analysis
from repro.roofline.buffers import largest_shapes as ref_largest_shapes
from repro.roofline.hlo import CollectiveStats as RefCollectiveStats
from repro_torch import configs
from repro_torch.bench import cli
from repro_torch.roofline import analysis
from repro_torch.roofline.buffers import ShapeTrace, largest_shapes
from repro_torch.roofline.hlo import CollectiveStats

V5E = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


@pytest.mark.parametrize("arch", list(configs.ASSIGNED))
def test_model_flops_equal_the_references(arch):
    for name, shape in configs.SHAPES.items():
        assert analysis.model_flops(configs.get_config(arch), shape) == \
            ref_analysis.model_flops(ref_configs.get_config(arch),
                                     ref_configs.SHAPES[name])


@pytest.mark.parametrize("counts", [(1e15, 1e12, 1e10), (1e12, 1e13, 0.0),
                                    (0.0, 1e9, 1e12)])
def test_analyze_with_v5e_constants_is_the_references(counts):
    f, b, w = counts
    c, rc = configs.get_config("granite-8b"), \
        ref_configs.get_config("granite-8b")
    for name in configs.SHAPES:
        got = analysis.analyze(c, configs.SHAPES[name], mesh_name="single",
                               n_devices=256, flops_per_device=f,
                               hbm_bytes_per_device=b,
                               wire_bytes_per_device=w, **V5E)
        want = ref_analysis.analyze(rc, ref_configs.SHAPES[name],
                                    mesh_name="single", n_devices=256,
                                    flops_per_device=f,
                                    hbm_bytes_per_device=b,
                                    wire_bytes_per_device=w)
        assert got.to_dict() == dataclasses.asdict(want)


def test_analyze_defaults_are_one_h100():
    c = configs.get_config("qwen2-0.5b")
    r = analysis.analyze(c, configs.SHAPES["decode_32k"], mesh_name="1xh100",
                         n_devices=1, flops_per_device=989e12,
                         hbm_bytes_per_device=3.35e12 * 2,
                         wire_bytes_per_device=0.0)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 2.0, 0.0)
    assert r.bottleneck == "memory" and r.step_time_s == 2.0
    assert r.roofline_fraction == 0.5
    assert analysis.LINK_BW == 450e9


def test_collective_stats_schema():
    for st in (CollectiveStats(), RefCollectiveStats()):
        st.counts["all-reduce"] += 2
        st.result_bytes["all-reduce"] += 64
        st.wire_bytes["all-reduce"] += 96.0
    assert CollectiveStats().to_dict() == RefCollectiveStats().to_dict()
    got, want = CollectiveStats(), RefCollectiveStats()
    for st in (got, want):
        st.counts["all-gather"] += 1
        st.wire_bytes["all-gather"] += 8.0
        st.result_bytes["all-gather"] += 16
    assert got.to_dict() == want.to_dict()
    assert got.total_result_bytes == want.total_result_bytes == 16


def test_largest_shapes_of_a_known_program():
    """The program makes one bf16[16,4096,512] (twice), one
    f32[16,4096] and int32 indices: the rows, their byte sizes and
    counts, in the reference's format and order."""
    x = torch.zeros((16, 4096, 512), dtype=torch.bfloat16, device="meta")
    with ShapeTrace() as tr:
        y = x * 2
        z = (y + 1).float().sum(-1)
        idx = torch.arange(7, dtype=torch.int32, device="meta")
    assert z.shape == (16, 4096) and idx.shape == (7,)
    got = largest_shapes(tr, top=3)
    assert got[0] == (16 * 4096 * 512 * 4.0, 1, "f32[16,4096,512]")
    assert got[1] == (16 * 4096 * 512 * 2.0, 2, "bf16[16,4096,512]")
    assert got[2] == (16 * 4096 * 4.0, 1, "f32[16,4096]")
    hlo = ("%a = f32[16,4096,512] convert(%x)\n"
           "%b = bf16[16,4096,512] multiply(%x, %c)\n"
           "%d = bf16[16,4096,512] add(%b, %e)\n"
           "%r = f32[16,4096] reduce(%a)\n")
    assert ref_largest_shapes(hlo, top=3) == got
    assert len(largest_shapes(tr)) == 4


def test_roofline_workload_without_records(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_DRYRUN_DIR", str(tmp_path / "none"))
    rc = cli.main(["run", "--suite", "roofline", "--smoke", "--device",
                   "cpu", "--power", "none", "--out", str(tmp_path)])
    assert rc == 0
    recs = json.loads((tmp_path / "roofline" / "results.json").read_text())
    by = {r["point"]["mesh"]: r for r in recs["records"]}
    assert set(by) == {"1xh100", "single", "multi"}
    assert by["1xh100"]["status"] == "ok"
    assert by["1xh100"]["metrics"]["n_rows"] == 0
    assert by["1xh100"]["noise"]["rel_std"] == 0.0
    assert {by[m]["status"] for m in ("single", "multi")} == {"deferred"}
    assert by["single"]["placement"] == {"dp": 256}
    assert by["multi"]["placement"] == {"dp": 512}
