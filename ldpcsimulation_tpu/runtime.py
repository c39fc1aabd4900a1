"""Process set-up shared by the entry points: compile cache and device guard.

Library imports change no JAX setting; the command-line entry points
(``tools.sweep``, ``tools.perf_report``, ``bench.py``, ``chip_smoke.py``)
call these helpers first.
"""

from __future__ import annotations

import os

import jax

__all__ = [
    "DEFAULT_CACHE_DIR",
    "enable_compile_cache",
    "device_summary",
    "require_gpu",
]

#: Persistent compile cache used when ``JAX_COMPILATION_CACHE_DIR`` is unset:
#: a fixed directory of the checkout, so every run of this checkout shares it.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is what JAX already uses, and
    nothing else is set here.  Otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def device_summary() -> dict:
    """Platform, device kind and count of the devices JAX runs on."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu() -> dict:
    """:func:`device_summary`, or RuntimeError when JAX found no GPU.

    Measurement and smoke entry points call this: a number taken on the
    CPU backend is never reported as a device number.
    """
    summary = device_summary()
    if summary["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {summary['platform']} "
            f"({summary['kind']}); this entry point needs a GPU"
        )
    return summary
