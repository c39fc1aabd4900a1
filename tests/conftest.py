"""Test configuration: run everything on a virtual 8-device CPU mesh.

The tests run on the CPU backend, wherever they run: sharding logic is
validated on 8 host-platform virtual devices (the same XLA partitioner
runs on real cards).  The environment may pre-set JAX_PLATFORMS (to a GPU,
say), so plain env-var defaults are not enough: override the env *and*
the live jax config before any backend initializes.  The GPU is exercised
by ``python chip_smoke.py`` and by the ``chip``-marked tests, which run
their work in a child process (tests/test_chip.py).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


REFERENCE_ROOT = "/root/reference"


def reference_path(rel: str) -> str:
    """Path inside the read-only reference checkout (for parity tests only).

    Reference data files are *not* vendored into this repo; parity tests that
    need the exact shipped parity-check matrices skip when the checkout is
    absent.
    """
    return os.path.join(REFERENCE_ROOT, rel)


def require_reference(rel: str) -> str:
    p = reference_path(rel)
    if not os.path.exists(p):
        pytest.skip(f"reference data {rel} not available")
    return p


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
