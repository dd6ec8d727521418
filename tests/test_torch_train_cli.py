"""The training launcher on pipeline placements and under fault schedules
across ranks, the dry run's memory pass, and the repo's four examples on
the port, on the CPU (gloo ranks, reduced gpt-117m).

  * A pipeline placement trains as data parallelism over ``stage``, as
    the reference's launcher trains it (``launch.mesh.dp_axes``): the
    ``pp2``, ``pp2tp2`` and ``dp2pp2`` launcher runs equal the ``dp2``,
    ``dp2tp2`` and ``dp4`` runs bit for bit. (On the card they agree at
    rtol 1e-4, ``chip_smoke.py`` phase 15a: ZeRO-1 slices a dp run's
    AdamW state over ``data`` and, by the reference's ``zero1_spec``,
    not a pp run's over ``stage``, so the clip's global norm is summed
    over slices in one and whole leaves in the other; the CPU's sum of a
    power-of-two slice gives the whole leaf's bits, the card's need
    not.)
  * The plan step on the ``(data 1, model 1, stage 2)`` mesh against the
    reference's GSPMD step on the same mesh of two forced host devices
    (``conftest.run_in_subprocess``), from the reference's weights
    (``bridge.py``): losses at rtol 1e-6, the first step's gradients at
    atol 1e-4.
  * Every fault preset at dp2 (12 steps, a checkpoint every 2): ``flaky``
    and ``power_fail`` restart nothing and give the fault-free dp2 run's
    losses; ``crash_mid``, ``crash_double``, ``ckpt_corrupt`` and
    ``device_loss`` finish every step, both ranks resume from the same
    step, and the final attempt's losses equal the fault-free dp2 run's
    at the same steps (``loss_bitmatch``). The reference has no passing
    run of these four to compare with: its launcher dies on the first
    step after a restart (an aliased-input error of its donated step),
    so the port's own fault-free run is the twin. Checkpoints hold whole
    leaves (the shapes of a one-device run's checkpoint) and nothing
    else, and a dp2 checkpoint restores into a dp1 run.
  * ``dryrun --no-metrics`` records ``metrics_pass: false`` with the
    metrics pass's peak and FLOPs on a cell of 64 microbatches.
  * Each example's ``main`` runs on the CPU at its smallest setting.
"""
import json
import pickle
import shutil
import textwrap

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from conftest import run_in_subprocess
from repro_torch.faults.schedule import TRAIN_PRESETS
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train as train_cli

torch.set_num_threads(1)

#: the launcher runs: steps, sequence, global batch
STEPS, SEQ, GB = 3, 32, 4
#: the faulted runs: steps and checkpoint cadence
FAULT_STEPS, CKPT_EVERY = 12, 2
FAULTS = [p for p in TRAIN_PRESETS if p != "none"]
CRASHES = ("crash_mid", "crash_double", "ckpt_corrupt", "device_loss")
#: pipeline placement -> its data-parallel twin
TWINS = {"pp2": "dp2", "pp2tp2": "dp2tp2", "dp2pp2": "dp4"}
#: the plan step against the reference's: batch, sequence, steps
B, S, PLAN_STEPS = 4, 16, 3

REF = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_mesh
from repro.models import lm
from repro.parallel import sharding as shd
from repro.train.optimizer import OptConfig, opt_init
from repro.train.step import StepConfig, make_loss_fn, make_train_step

batches = pickle.load(open(IN, "rb"))
c = get_config("gpt-117m").reduced(dtype="float32", param_dtype="float32")
oc = OptConfig(warmup=2, total_steps=100, eps=1e-6)
mesh = make_mesh((1, 1, 2), ("data", "model", "stage"))
params = jax.jit(lm.init, static_argnums=1)(jax.random.key(0), c)
b, s = batches[0]["tokens"].shape
plan = shd.make_plan(c, mesh, ShapeConfig("t", s, b, "train"))
rec = {"params": jax.tree.map(np.asarray, params), "dp": plan.dp}
p, o, psh, osh, gsh = shd.shard_train_state(plan, params,
                                            opt_init(oc, params), c)
bsh = {k: shd.batch_sharding(plan, v.shape) for k, v in batches[0].items()}
put = lambda bt: jax.device_put({k: jnp.asarray(v) for k, v in bt.items()},
                                bsh)
with mesh:
    vg = jax.jit(jax.value_and_grad(make_loss_fn(c, StepConfig()),
                                    has_aux=True))
    rec["grads"] = [np.asarray(g) for g in
                    jax.tree.leaves(vg(p, put(batches[0]))[1])]
    step = jax.jit(make_train_step(c, oc, StepConfig(), grad_shardings=gsh,
                                   batch_shardings=bsh),
                   out_shardings=(psh, osh, None))
    rec["losses"] = []
    for bt in batches:
        p, o, m = step(p, o, put(bt))
        rec["losses"].append(float(m["loss"]))
pickle.dump(rec, open(OUT, "wb"))
"""


def _argv(placement: str, steps: int = STEPS, *extra) -> list:
    return ["--device", "cpu", "--preset", "tiny", "--placement", placement,
            "--steps", str(steps), "--seq-len", str(SEQ), "--global-batch",
            str(GB), *extra]


def _fault_argv(preset: str, ckpt_dir) -> list:
    return _argv("dp2", FAULT_STEPS, "--ckpt-dir", str(ckpt_dir),
                 "--ckpt-every", str(CKPT_EVERY), "--fault-preset", preset)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's GSPMD steps (one subprocess, two forced host
    devices), then one two-rank world (pp2 and dp2 runs, the fault-free
    dp2 run with checkpoints, every fault preset, the plan step) and one
    four-rank world (pp2tp2, dp2tp2, dp2pp2, dp4)."""
    d = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(26)
    vocab = ranks.lm_config().vocab
    batches = []
    for _ in range(PLAN_STEPS):
        t = rng.integers(0, vocab, (B, S)).astype(np.int32)
        batches.append({"tokens": t, "labels": np.roll(t, -1, 1)})
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(batches, f)
    run_in_subprocess(f"IN = {str(d / 'in.pkl')!r}\nOUT = "
                      f"{str(d / 'out.pkl')!r}\n" + textwrap.dedent(REF),
                      n_devices=2, timeout=600)
    with open(d / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    pair_runs = [("pp2", _argv("pp2")), ("dp2", _argv("dp2")),
                 ("twin", _argv("dp2", FAULT_STEPS, "--ckpt-dir",
                                str(d / "twin"), "--ckpt-every",
                                str(CKPT_EVERY)))]
    pair_runs += [(p, _fault_argv(p, d / p)) for p in FAULTS]
    cases = [("pp2", "gpt-117m", {}, "pp2", ref["params"], batches,
              {"eps": 1e-6}, 1, None, None)]
    pair = mesh_mod.spawn(ranks.launcher_and_plan, 2,
                          args=(pair_runs, cases), device="cpu")
    quad = mesh_mod.spawn(ranks.launcher_runs, 4, args=(
        [(p, _argv(p)) for p in ("pp2tp2", "dp2tp2", "dp2pp2", "dp4")],),
        device="cpu")
    return {"ref": ref, "pair": pair, "quad": quad, "dir": d}


@pytest.mark.parametrize("placement", sorted(TWINS))
def test_pipeline_placement_trains_as_data_parallel(placement, runs):
    world = runs["pair"] if placement == "pp2" else runs["quad"]
    got = [r["runs"] if "runs" in r else r for r in world]
    for r in got:
        assert len(r[placement]["losses"]) == STEPS
        assert np.isfinite(r[placement]["losses"]).all()
        assert r[placement]["losses"] == r[TWINS[placement]]["losses"]
        assert r[placement]["losses"] == got[0][placement]["losses"]


def test_pp2_plan_step_matches_the_reference(runs):
    ref = runs["ref"]
    assert tuple(ref["dp"]) == ("data", "stage")
    mine = [r["plan"]["pp2"] for r in runs["pair"]]
    losses = [m["loss"] for m in mine[0]["metrics"]]
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-6)
    for a, b in zip(mine[0]["grads"], ref["grads"], strict=True):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    # each stage rank holds whole layers and the same params after
    assert mine[0]["elems"] == mine[1]["elems"]
    for a, b in zip(mine[0]["params"], mine[1]["params"], strict=True):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("preset", FAULTS)
def test_fault_preset_at_dp2_matches_the_fault_free_run(preset, runs):
    twin = runs["pair"][0]["runs"]["twin"]["losses"]
    assert len(twin) == FAULT_STEPS
    got = [r["runs"][preset] for r in runs["pair"]]
    for g in got:
        assert g["final_step"] == FAULT_STEPS
        assert g["resumed_from"] == got[0]["resumed_from"]
        assert g["resume_steps"] == got[0]["resume_steps"]
        assert g["ckpt_fallbacks"] == got[0]["ckpt_fallbacks"]
        assert g["wasted_steps"] == got[0]["wasted_steps"]
        # the final attempt's losses are the fault-free run's at its steps
        assert g["losses"] == twin[FAULT_STEPS - len(g["losses"]):]
    r = got[0]
    if preset in CRASHES:
        assert r["restarts"] == (2 if preset == "crash_double" else 1)
        assert r["resumed_from"] is not None and r["resumed_from"] > 0
        assert len(r["losses"]) == FAULT_STEPS - r["resumed_from"]
    else:
        assert r["restarts"] == 0 and r["resumed_from"] is None
        assert r["losses"] == twin
    if preset == "ckpt_corrupt":
        assert r["ckpt_fallbacks"] >= 1


def _manifests(d) -> dict:
    return {p.name: {k: v["shape"] for k, v in json.loads(
        (p / "manifest.json").read_text())["leaves"].items()}
            for p in sorted(d.iterdir())}


def test_dp2_checkpoints_are_whole_and_restore_in_dp1(runs, capsys):
    """The fault-free dp2 run's checkpoints restore into a dp1 run: from
    step 8 it takes the dp2 run's last four steps (at rtol 1e-5: one
    device sums the batch's rows in another order), and its own
    checkpoint's leaves have the shapes of every dp2 checkpoint's."""
    d = runs["dir"]
    twin = runs["pair"][0]["runs"]["twin"]["losses"]
    dp1 = d / "dp1"
    shutil.copytree(d / "twin", dp1)
    for s in (10, 12):
        shutil.rmtree(dp1 / f"step_{s}")
    res = train_cli.main(_argv("dp1", FAULT_STEPS, "--ckpt-dir", str(dp1),
                               "--ckpt-every", str(CKPT_EVERY)))
    assert res.resumed_from == 8 and res.final_step == FAULT_STEPS
    np.testing.assert_allclose(res.losses, twin[8:], rtol=1e-5)
    whole = _manifests(dp1)["step_12"]
    for name in ["twin", *FAULTS]:
        got = _manifests(d / name)
        assert got and all(k.startswith("step_") for k in got), got.keys()
        assert all(m == whole for m in got.values()), name
    assert "step_12" in _manifests(d / "ckpt_corrupt")


def test_dryrun_memory_pass(tmp_path, capsys):
    """``--no-metrics`` on a cell of k = 64 microbatches: the record says
    so, and its peak and FLOPs are the metrics pass's (its bytes are
    scaled from the trace of two microbatches)."""
    cell = ["--arch", "qwen2-0.5b", "--shape", "train_4k"]
    assert dryrun.main(cell + ["--out", str(tmp_path / "m")]) == 0
    assert dryrun.main(cell + ["--no-metrics", "--out",
                               str(tmp_path / "n")]) == 0
    fn = "1xh100__qwen2-0.5b__train_4k.json"
    full, mem = (json.loads((tmp_path / k / fn).read_text())
                 for k in ("m", "n"))
    assert full["metrics_pass"] is True and mem["metrics_pass"] is False
    assert mem["microbatches"] == full["microbatches"] == 64
    assert mem["bytes_per_device"] == full["bytes_per_device"]
    assert mem["cost_analysis"]["flops"] == full["cost_analysis"]["flops"]
    np.testing.assert_allclose(mem["cost_analysis"]["bytes_accessed"],
                               full["cost_analysis"]["bytes_accessed"],
                               rtol=0.05)


#: example -> its smallest setting on the CPU (``OUT`` is a temporary
#: records directory)
EXAMPLES = {
    "quickstart": ["--device", "cpu", "--steps", "10"],
    "fault_tolerance": ["--device", "cpu", "--out", "OUT"],
    "llm_sweep": ["--device", "cpu", "--power", "none", "--out", "OUT"],
    "serve_decode": ["--device", "cpu"],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path, capsys):
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    argv = [str(tmp_path) if a == "OUT" else a for a in EXAMPLES[name]]
    got = mod.main(argv)
    out = capsys.readouterr().out
    if name == "quickstart":
        assert got.steps_run == 10 and "decreased: True" in out
    elif name == "serve_decode":
        assert set(got) == {"llama3.2-3b", "mamba2-1.3b",
                            "granite-moe-3b-a800m"}
    else:
        assert got and all(r.ok for r in got)
        assert (tmp_path / name / "results.json").exists()
        if name == "fault_tolerance":
            assert got[0].metrics["final_step"] == 30
            assert got[0].metrics["resumed_from"] is not None
        else:
            assert len(got) == 6 and "heatmap" in out
