"""Nothing of the benchmark imports JAX or the JAX package (``repro``),
compared by whole top-level name, and the plain references import
nothing of the program either."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FILES = sorted(p for p in HERE.rglob("*.py") if ".cache" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
REFERENCE = sorted((HERE / "cbench" / "reference").glob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_scan_sees_every_file():
    assert len(FILES) >= 20 and len(REFERENCE) >= 4


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_references_import_torch_and_each_other_only(path):
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    allowed = ("__future__", "math", "contextlib", "torch", "numpy",
               "cbench.reference")
    bad = {m for m in mods
           if not any(m == a or m.startswith(a + ".") for a in allowed)}
    assert not bad


def test_the_check_compares_whole_names():
    """``repro_torch`` begins with ``repro`` and is no JAX package."""
    import sys
    sys.path.insert(0, str(HERE))
    from cbench.runner import FORBIDDEN as runtime
    assert set(runtime) == FORBIDDEN
    assert "repro_torch".split(".")[0] not in FORBIDDEN
