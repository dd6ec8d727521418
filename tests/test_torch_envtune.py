"""The port's opt-in environment tuning against the reference's.

  * with a fake tcmalloc library (``REPRO_TCMALLOC_PATH``) and with
    none, ``apply`` gives the reference's LD_PRELOAD and applied record;
  * ``REPRO_XLA_STEP_MARKER`` has no analog: it is recorded as unmet
    and changes no variable (the reference appends an XLA flag);
  * ``requested``/``pending``/``active`` behave as the reference's;
  * the bench CLI re-execs once with the tuned environment, and the
    runner stamps the applied record into every record as
    ``env_tuning``.
"""
import json
import subprocess

import pytest

from repro.bench import envtune as ref_envtune
from repro_torch.bench import cli, envtune


@pytest.fixture
def fake_lib(tmp_path):
    lib = tmp_path / "libtcmalloc_minimal.so.4"
    lib.write_bytes(b"")
    return str(lib)


@pytest.mark.parametrize("preload", ["", "libother.so"])
@pytest.mark.parametrize("found", [True, False])
def test_tcmalloc_record_is_the_references(found, preload, fake_lib,
                                           monkeypatch):
    monkeypatch.setattr(envtune, "_TCMALLOC_CANDIDATES", ())
    monkeypatch.setattr(ref_envtune, "_TCMALLOC_CANDIDATES", ())
    if found:
        monkeypatch.setenv("REPRO_TCMALLOC_PATH", fake_lib)
    else:
        monkeypatch.delenv("REPRO_TCMALLOC_PATH", raising=False)
    env = {"REPRO_TCMALLOC": "1"}
    if preload:
        env["LD_PRELOAD"] = preload
    got, want = envtune.apply(dict(env)), ref_envtune.apply(dict(env))
    assert got == want
    assert got["REPRO_ENV_TUNING"] == ("tcmalloc" if found
                                       else "tcmalloc-missing")
    if found:
        assert got["LD_PRELOAD"].split(":")[0] == fake_lib
    assert envtune.find_tcmalloc() == ref_envtune.find_tcmalloc()


def test_step_marker_is_recorded_unmet():
    env = {"REPRO_XLA_STEP_MARKER": "1", "XLA_FLAGS": "--x"}
    got = envtune.apply(dict(env))
    assert got == {**env, "REPRO_ENV_TUNING": "step_marker-unmet"}
    assert "step_marker=" in ref_envtune.apply(dict(env))["REPRO_ENV_TUNING"]


@pytest.mark.parametrize("env", [{}, {"REPRO_TCMALLOC": "0"},
                                 {"REPRO_TCMALLOC": "yes"},
                                 {"REPRO_XLA_STEP_MARKER": "0"},
                                 {"REPRO_TCMALLOC": "1",
                                  "REPRO_ENV_TUNING": "tcmalloc"}])
def test_requests_are_the_references(env):
    assert envtune.requested(env) == ref_envtune.requested(env)
    assert envtune.pending(env) == ref_envtune.pending(env)
    assert envtune.apply(dict(env)).get("REPRO_ENV_TUNING") == (
        "none" if not envtune.requested(env) else
        envtune.apply(dict(env))["REPRO_ENV_TUNING"])


def test_cli_reexecs_once_with_the_tuned_env(monkeypatch, fake_lib):
    monkeypatch.delenv("REPRO_ENV_TUNING", raising=False)
    monkeypatch.delenv("REPRO_TCMALLOC", raising=False)
    assert cli.reexec_tuned(["run"]) is None       # nothing requested
    monkeypatch.setenv("REPRO_TCMALLOC", "1")
    monkeypatch.setenv("REPRO_TCMALLOC_PATH", fake_lib)
    calls = []

    def run(cmd, env):
        calls.append((cmd, env))
        return subprocess.CompletedProcess(cmd, 7)

    monkeypatch.setattr(cli.subprocess, "run", run)
    assert cli.main(["run", "--suite", "roofline", "--device", "cpu"]) == 7
    (cmd, env), = calls
    assert cmd[1:] == ["-m", "repro_torch.bench", "run", "--suite",
                       "roofline", "--device", "cpu"]
    assert env["REPRO_ENV_TUNING"] == "tcmalloc"
    assert env["LD_PRELOAD"].startswith(fake_lib)
    monkeypatch.setenv("REPRO_ENV_TUNING", "tcmalloc")
    assert cli.reexec_tuned(["run"]) is None       # the child proceeds


def test_runner_stamps_env_tuning(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_DRYRUN_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("REPRO_ENV_TUNING", "tcmalloc-missing")
    assert cli.main(["run", "--suite", "roofline", "--device", "cpu",
                     "--power", "none", "--out", str(tmp_path)]) == 0
    recs = json.loads((tmp_path / "roofline" / "results.json").read_text())
    ok = [r for r in recs["records"] if r["status"] == "ok"]
    assert ok and all(r["metrics"]["env_tuning"] == "tcmalloc-missing"
                      for r in ok)
    monkeypatch.delenv("REPRO_ENV_TUNING")
    assert envtune.active() == ""
