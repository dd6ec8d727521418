import subprocess
import sys
import textwrap

import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked @pytest.mark.slow")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (deselected by default; run with "
        "--runslow or an explicit -m expression)")
    config.addinivalue_line(
        "markers",
        "cuda: runs a CUDA kernel on the card (skips where there is none)")


def pytest_collection_modifyitems(config, items):
    """Default to ``-m "not slow"``: tier-1 stays fast; an explicit
    ``--runslow`` or any user-supplied ``-m`` expression overrides."""
    if config.option.runslow or config.option.markexpr:
        return
    skip_slow = pytest.mark.skip(
        reason="slow: needs --runslow (or -m slow)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


def run_in_subprocess(code: str, n_devices: int = 8, timeout: int = 600):
    """Run a snippet under a multi-device (forced host platform) jax.

    Keeps the main test process at 1 device (per the dry-run contract:
    only repro.launch.dryrun forces 512 devices).
    """
    prelude = (
        "import os\n"
        f"os.environ['XLA_FLAGS'] = "
        f"'--xla_force_host_platform_device_count={n_devices}'\n"
        "import sys\n"
        "sys.path.insert(0, 'src')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", prelude + textwrap.dedent(code)],
        capture_output=True, text=True, timeout=timeout, cwd=".")
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed:\nSTDOUT:\n{proc.stdout}\n"
            f"STDERR:\n{proc.stderr[-4000:]}")
    return proc.stdout


@pytest.fixture
def subproc():
    return run_in_subprocess
