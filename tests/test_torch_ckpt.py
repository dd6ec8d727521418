"""The port's checkpoints, fault schedules, supervisor and training loop,
against ``repro``'s where both have them, on the CPU.

  * checkpoints round-trip bit-exactly (fp32, bf16, int32 and 0-d
    leaves, ``(params, opt_state)`` tuples), keep the newest ``keep``
    steps, publish atomically (a crash before the rename leaves the
    previous step), re-raise a failed async save at ``wait``, and skip a
    corrupted step; ``save_async`` snapshots before it returns (save,
    then change the tensors in place, then restore: the old values);
    either package restores the other's checkpoints;
  * ``FaultSchedule`` events and ``schedule_hash`` equal the reference's
    for every preset, and ``run_supervised`` on a fake clock gives the
    reference's restarts, wasted steps, resume steps and backoff sleeps;
  * ``train_loop`` resumes from its checkpoints (a resumed loss trace
    equals an uninterrupted one, element for element), and the training
    CLI completes a ``crash_mid`` run on the CPU, refuses a launcher's
    world whose size is not the placement's and, left at its default
    device, a machine without a card.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt.checkpoint as ref_ckpt
from repro.faults import schedule as ref_schedule
from repro.faults import supervisor as ref_supervisor
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.faults import schedule, supervisor
from repro_torch.faults.schedule import InjectedCrash
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import make_data_fn
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import init_train_state, make_train_step

torch.set_num_threads(1)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return ({"w": torch.randn(4, 8, generator=g),
             "h": torch.randn(3, 5, generator=g).to(torch.bfloat16)},
            {"step": torch.tensor(seed, dtype=torch.int32),
             "nested": {"b": torch.arange(10, dtype=torch.int32),
                        "s": torch.tensor(1.5 + seed)}})


def _assert_equal(a, b):
    for x, y in zip(tree.leaves(a), tree.leaves(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_round_trip_is_bit_exact(tmp_path):
    t = _tree(3)
    path = ckpt.save(t, tmp_path, step=5, extra_meta={"arch": "x"})
    assert path.endswith("step_5")
    got, manifest = ckpt.restore(_tree(0), tmp_path)
    assert manifest["step"] == 5 and manifest["meta"] == {"arch": "x"}
    assert manifest["leaves"]["0/h"]["dtype"] == "bfloat16"
    assert isinstance(got, tuple)
    _assert_equal(got, t)


def test_restore_casts_to_the_template(tmp_path):
    ckpt.save({"w": torch.ones(4)}, tmp_path, step=1)
    got, _ = ckpt.restore({"w": torch.zeros(4, dtype=torch.bfloat16)},
                          tmp_path)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], torch.ones(4, dtype=torch.bfloat16))


def test_retention_and_latest_step(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_sync(_tree(s), s)
    assert ckpt.latest_step(tmp_path) == 4 == mgr.last_saved
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_3",
                                                          "step_4"]


def test_crash_before_publish_keeps_previous_step(tmp_path, monkeypatch):
    ckpt.save(_tree(1), tmp_path, step=1)

    def boom(src, dst):
        raise OSError("simulated crash mid-publish")

    monkeypatch.setattr(ckpt.os, "replace", boom)
    with pytest.raises(OSError, match="mid-publish"):
        ckpt.save(_tree(2), tmp_path, step=2)
    monkeypatch.undo()
    assert ckpt.latest_step(tmp_path) == 1 == ckpt.latest_valid_step(tmp_path)
    got, manifest, skipped = ckpt.restore_resilient(_tree(), tmp_path)
    assert manifest["step"] == 1 and skipped == []
    _assert_equal(got, _tree(1))


def test_async_save_failure_is_reraised_at_wait(tmp_path, monkeypatch):
    mgr = ckpt.CheckpointManager(tmp_path)
    monkeypatch.setattr(ckpt, "_write", lambda *a, **kw: (_ for _ in ())
                        .throw(OSError("disk full")))
    mgr.save_async(_tree(), 1)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    monkeypatch.undo()                 # consumed once; reusable after
    mgr.save_async(_tree(), 2)
    mgr.wait()
    assert ckpt.latest_step(tmp_path) == 2


def test_corrupted_step_falls_back(tmp_path):
    ckpt.save(_tree(2), tmp_path, step=2)
    ckpt.save(_tree(4), tmp_path, step=4)
    assert schedule.corrupt_checkpoint(tmp_path) == 4
    assert ckpt.latest_step(tmp_path) == 4
    assert not ckpt.verify_step(tmp_path, 4)
    assert ckpt.latest_valid_step(tmp_path) == 2
    got, manifest, skipped = ckpt.restore_resilient(_tree(), tmp_path)
    assert manifest["step"] == 2 and skipped == [4]
    _assert_equal(got, _tree(2))
    schedule.corrupt_checkpoint(tmp_path, step=2)
    with pytest.raises(FileNotFoundError, match="corrupted"):
        ckpt.restore_resilient(_tree(), tmp_path)


def test_async_snapshot_is_taken_before_save_async_returns(tmp_path,
                                                          monkeypatch):
    """Save, change every leaf in place (the next optimizer step), then
    let the writer run: the checkpoint holds the values at the save. The
    writer is held until the change is made, so a snapshot that aliased
    the live tensors (``.numpy()`` of a CPU tensor does) would fail."""
    release = threading.Event()
    write = ckpt._write

    def held(*a, **kw):
        release.wait(10)
        return write(*a, **kw)

    monkeypatch.setattr(ckpt, "_write", held)
    t = _tree(1)
    want = tree.tree_map(torch.Tensor.clone, t)
    mgr = ckpt.CheckpointManager(tmp_path)
    mgr.save_async(t, 1)
    with torch.no_grad():
        for x in tree.leaves(t):
            x.add_(1)
    release.set()
    mgr.wait()
    got, _ = ckpt.restore(t, tmp_path)
    _assert_equal(got, want)


def test_checkpoints_cross_between_packages(tmp_path):
    """The reference restores the port's checkpoint and the port the
    reference's, bf16 leaves included, bit for bit."""
    t = _tree(2)
    ckpt.save(t, tmp_path / "port", step=3)
    as_np = tree.tree_map(lambda x: np.asarray(
        jnp.asarray(x.float().numpy(), jnp.bfloat16))
        if x.dtype == torch.bfloat16 else x.numpy(), t)
    ref_template = jax.tree.map(jnp.zeros_like, (as_np[0], as_np[1]))
    got, manifest = ref_ckpt.restore(ref_template, tmp_path / "port")
    assert manifest["step"] == 3
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(as_np)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    ref_ckpt.save(as_np, tmp_path / "ref", step=4)
    assert ckpt.verify_step(tmp_path / "ref", 4)
    got, manifest = ckpt.restore(_tree(0), tmp_path / "ref")
    assert manifest["step"] == 4
    _assert_equal(got, t)


# ---------------------------------------------------------------------------
# fault schedules and the supervisor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", schedule.TRAIN_PRESETS
                         + schedule.SERVE_PRESETS[1:])
def test_schedules_match_reference(preset):
    assert schedule.TRAIN_PRESETS == ref_schedule.TRAIN_PRESETS
    for seed in (0, 1, 7):
        for total in (20, 30, 100):
            got = schedule.FaultSchedule.from_preset(preset, seed, total)
            want = ref_schedule.FaultSchedule.from_preset(preset, seed,
                                                          total)
            assert got.canonical() == want.canonical()
            assert got.schedule_hash == want.schedule_hash
            assert [got.crash_at(s) is not None for s in range(total + 2)] \
                == [want.crash_at(s) is not None for s in range(total + 2)]
            assert [got.slowdown_s(s) for s in range(total)] == \
                [want.slowdown_s(s) for s in range(total)]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _supervise(mod, sched_mod, ckpt_dir, script):
    """Run ``mod.run_supervised`` over a scripted attempt sequence: each
    entry is an exception to raise (after advancing the fake clock) or
    None (a completed attempt that reports one step)."""
    clock, sleeps, calls = _FakeClock(), [], iter(script)

    def run_once(hook):
        kind = next(calls)
        clock.t += 1.0
        if kind is None:
            hook(0, {}, 0.0)
            return "done"
        name, step = kind
        if name == "loss":
            raise sched_mod.DeviceLoss(step, 2)
        raise sched_mod.InjectedCrash(step)

    out = mod.run_supervised(run_once, ckpt_dir=ckpt_dir, seed=3,
                             sleep_fn=sleeps.append, clock=clock,
                             on_device_loss=lambda e: None)
    return out, sleeps


def test_supervisor_matches_reference(tmp_path):
    ckpt.save(_tree(2), tmp_path, step=2)
    ckpt.save(_tree(5), tmp_path, step=5)
    schedule.corrupt_checkpoint(tmp_path, step=5)
    script = [("crash", 6), ("loss", 7), ("crash", 9), None]
    got, got_sleeps = _supervise(supervisor, schedule, tmp_path, script)
    want, want_sleeps = _supervise(ref_supervisor, ref_schedule, tmp_path,
                                   script)
    assert got_sleeps == want_sleeps and len(got_sleeps) == 3
    for f in ("result", "restarts", "crash_steps", "resume_steps",
              "wasted_steps", "recovery_s", "backoff_s", "rescales",
              "ckpt_fallbacks"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.restarts == 3 and got.resume_steps == [2, 2, 2]
    assert got.ckpt_fallbacks == 3 and got.rescales == 1
    with pytest.raises(InjectedCrash):
        supervisor.run_supervised(lambda hook: (_ for _ in ()).throw(
            InjectedCrash(3)), ckpt_dir=None, max_restarts=2,
            sleep_fn=lambda s: None, clock=_FakeClock())


# ---------------------------------------------------------------------------
# the training loop and CLI
# ---------------------------------------------------------------------------


def _tiny():
    c = get_config("gpt-117m").reduced()
    oc = OptConfig(warmup=2, total_steps=12)
    step = make_train_step(c, oc)
    data = make_data_fn(c, 2, 16, seed=0, device="cpu")

    def init():
        return init_train_state(c, oc, torch.Generator().manual_seed(0),
                                "cpu")
    return step, data, init


def test_train_loop_resumes_bit_exactly(tmp_path):
    step, data, init = _tiny()
    cfg = LoopConfig(total_steps=12, ckpt_every=4, ckpt_dir=str(tmp_path),
                     log_every=0, seq_len=16, global_batch=2)
    twin = train_loop(step, *init(), data,
                      LoopConfig(total_steps=12, ckpt_dir=None, log_every=0))
    with pytest.raises(InjectedCrash):
        train_loop(step, *init(), data, cfg, fail_at_step=6)
    assert ckpt.latest_step(tmp_path) == 4
    res = train_loop(step, *init(), data, cfg)
    assert res.resumed_from == 4 and res.final_step == 12
    assert res.steps_run == 8 and res.losses == twin.losses[4:]
    assert ckpt.latest_step(tmp_path) == 12


def test_train_loop_under_the_supervisor_matches_its_twin(tmp_path):
    step, data, init = _tiny()
    faults = schedule.FaultSchedule.from_preset("ckpt_corrupt", 0, 12)
    cfg = LoopConfig(total_steps=12, ckpt_every=2, ckpt_dir=str(tmp_path),
                     log_every=0, seq_len=16, global_batch=2)
    twin = train_loop(step, *init(), data,
                      LoopConfig(total_steps=12, ckpt_dir=None, log_every=0))
    sup = supervisor.run_supervised(
        lambda hook: train_loop(step, *init(), data, cfg, hooks=[hook],
                                faults=faults),
        ckpt_dir=tmp_path, seed=0, sleep_fn=lambda s: None)
    res = sup.result
    assert sup.restarts == 1 and sup.ckpt_fallbacks == 1
    assert res.ckpt_skipped and res.final_step == 12
    assert res.losses == twin.losses[len(twin.losses) - len(res.losses):]


def test_train_cli_crash_mid_on_cpu(tmp_path, capsys):
    res = train_cli.main(["--device", "cpu", "--preset", "tiny", "--steps",
                          "20", "--global-batch", "2", "--seq-len", "32",
                          "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
                          "--fault-preset", "crash_mid"])
    out = capsys.readouterr().out
    assert "supervised: restarts=1" in out
    assert res.final_step == 20 and res.resumed_from is not None


def test_train_cli_refuses_what_it_cannot_run(monkeypatch):
    # a launcher's world (WORLD_SIZE set) of another size than the
    # placement's: refused before the rank joins it
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="needs 4 ranks, the world has 2"):
        train_cli.main(["--device", "cpu", "--placement", "dp2pp2"])
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--steps", "1"])
