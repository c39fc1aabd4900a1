"""P5 of chip_smoke.py at real widths, as a test that needs a GPU.

    python -m pytest -m chip tests/test_chip.py

The test session itself stays on the CPU (tests/conftest.py), so the
comparisons run in one child process that uses the card; the fixture
asks a child whether JAX finds a GPU at all, and skips when it does not.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child_env():
    # conftest pins this process to CPU through these variables
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "JAX_ENABLE_X64")}
    env["PYTHONPATH"] = REPO
    return env


@pytest.fixture(scope="module")
def gpu_env():
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=_child_env(), capture_output=True, text=True, timeout=300,
    )
    platform = probe.stdout.strip().splitlines()[-1:] or ["none"]
    if probe.returncode != 0 or platform[0] != "gpu":
        pytest.skip(f"needs a GPU; JAX found {platform[0]}")
    return _child_env()


@pytest.mark.chip
def test_p5_comparisons_on_gpu(gpu_env):
    code = (
        "import sys, tempfile\n"
        "import chip_smoke as cs\n"
        "from ldpcsimulation_tpu.runtime import enable_compile_cache\n"
        "enable_compile_cache()\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    cs.phase_compare(cs.Widths(), d, cs.CompileClock())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=gpu_env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
