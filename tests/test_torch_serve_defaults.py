"""The port's serving defaults are the reference's:

  * the serve launcher's ``parse_args([])`` equals the reference's, flag
    for flag (``--arch gpt-117m``, ``--mode batch``, ``--cache slotted``,
    ...), but for the port-only ``--device`` (the card) and
    ``--prefix-cache``;
  * ``ServeEngine.__init__``'s keyword defaults equal the reference's
    (``cache="slotted"``, ...), but for the port-only ``device`` and the
    reference-only kernel switches (``impl_prefill``, ``impl_decode``,
    ``donate``, ``paged_impl``, ``paged_interpret``: the port has one
    implementation and updates no donated buffer);
  * ``BatchedServer`` follows the engine's default cache, as the
    reference's does;
  * the launcher with the reference's defaults (``--mode batch`` on
    gpt-117m) generates on the CPU.
"""
import argparse
import inspect

import pytest
import torch

from repro.launch import serve as ref_serve
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.serve import engine

PORT_ONLY_FLAGS = {"device", "prefix_cache"}
PORT_ONLY_ARGS = {"device"}
REF_ONLY_ARGS = {"impl_prefill", "impl_decode", "donate", "paged_impl",
                 "paged_interpret"}


class _Parsed(Exception):
    pass


def _defaults(main, monkeypatch) -> dict:
    """``vars(parse_args([]))`` of a launcher's ``main``, stopped right
    after parsing."""
    parse = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        raise _Parsed(vars(parse(self, args, namespace)))

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", spy)
        with pytest.raises(_Parsed) as e:
            main([])
    return e.value.args[0]


def test_launcher_defaults_are_the_references(monkeypatch):
    got = _defaults(serve.main, monkeypatch)
    want = _defaults(ref_serve.main, monkeypatch)
    assert set(got) - set(want) == PORT_ONLY_FLAGS
    assert not set(want) - set(got)
    assert {k: got[k] for k in want} == want
    assert (got["arch"], got["mode"], got["cache"]) == \
        ("gpt-117m", "batch", "slotted")
    assert (got["device"], got["prefix_cache"]) == ("cuda", False)


def _kw_defaults(fn) -> dict:
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


def test_engine_defaults_are_the_references():
    got = _kw_defaults(engine.ServeEngine.__init__)
    want = _kw_defaults(ref_engine.ServeEngine.__init__)
    assert set(got) - set(want) == PORT_ONLY_ARGS
    assert set(want) - set(got) == REF_ONLY_ARGS
    for k in set(got) & set(want):
        if callable(want[k]):
            assert got[k] is want[k], k      # time.monotonic
        else:
            assert got[k] == want[k], k
    assert got["cache"] == "slotted"
    ref_batched = _kw_defaults(ref_engine.BatchedServer.__init__)
    assert _kw_defaults(engine.BatchedServer.__init__) == {
        **{k: v for k, v in ref_batched.items() if k not in REF_ONLY_ARGS},
        "device": None}


def test_engine_and_batched_server_build_slotted_caches():
    c = get_config("gpt-117m").reduced()
    p = lm.init(c, torch.Generator().manual_seed(0), "cpu")
    assert engine.ServeEngine(c, p, device="cpu").cache_kind == "slotted"
    server = engine.BatchedServer(c, p, max_len=8, device="cpu")
    assert server.engine.cache_kind == "slotted"


def test_launcher_runs_the_references_configuration(capsys):
    res = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                      "16", "--gen", "4"])
    assert tuple(res.tokens.shape) == (2, 4)
    out = capsys.readouterr().out
    assert "[serve] arch=gpt-117m-reduced device=cpu batch=2" in out
