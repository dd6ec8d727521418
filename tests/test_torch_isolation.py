"""The port stands alone: no JAX, nothing of ``repro``, the card by
default.

  * every ``repro_torch`` module (and ``chip_smoke.py``) imports in a
    process where importing ``jax``, ``jaxlib``, ``ml_dtypes`` or
    ``repro`` fails;
  * no such import appears anywhere in their source (AST scan);
  * entry points given no ``device`` raise when there is no card;
  * ``kernels.ops`` on CPU tensors runs the plain version and counts no
    launch.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh
from repro_torch.launch import serve as serve_cli
from repro_torch.models import lm
from repro_torch.serve.engine import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BANNED = ("jax", "jaxlib", "ml_dtypes", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _banned(module: str) -> bool:
    return module.split(".")[0] in BANNED


def test_port_imports_without_jax_or_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        f"for name in {BANNED!r}:\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 20


def test_the_model_code_imports_nothing_of_the_launcher():
    """The language models, their loss and the sharded layout they run
    under reach no launcher and no roofline module: the layout owns
    Megatron's operators, the dry run its counting mesh."""
    code = ("import sys\n"
            "import repro_torch.models.lm, repro_torch.train.loss\n"
            "print(sorted(m for m in sys.modules if m.startswith(\n"
            "    ('repro_torch.launch', 'repro_torch.roofline'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["[]"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_banned_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _banned(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_lm_init_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init(get_config("llama3.2-3b").reduced())


def test_engine_defaults_to_the_card(no_card):
    c = get_config("llama3.2-3b").reduced()
    params = lm.init(c, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(c, params)


def test_cli_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--preset", "tiny", "--requests", "1"])


def test_spawn_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.spawn(len, 2)


def test_init_world_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.init_world(rank=0, world_size=1)


def test_ops_on_cpu_run_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    q, pool = t(2, 4, 16), t(5, 8, 2, 16)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lengths = torch.tensor([9, 16], dtype=torch.int32)
    torch.testing.assert_close(
        ops.paged_decode_attention(q, pool, pool, tables, lengths),
        ref.paged_decode_attention_ref(q, pool, pool, tables, lengths),
        rtol=0, atol=0)
    qs, ks = t(2, 8, 4, 16), t(2, 8, 2, 16)
    torch.testing.assert_close(
        ops.paged_prefill_attention(qs, ks, ks, pool, pool, tables),
        ref.paged_prefill_attention_ref(qs, ks, ks, pool, pool, tables),
        rtol=0, atol=0)
    assert ops.launch_counts() == {"paged_decode_attention": 0,
                                   "paged_prefill_attention": 0,
                                   "flash_attention": 0, "rmsnorm": 0,
                                   "adamw": 0, "batchnorm": 0}
