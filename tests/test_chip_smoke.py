"""chip_smoke.py, the device guard and the compile-cache helper on CPU.

The smoke script's phases take their sizes as arguments; here each runs
at tiny widths on the CPU backend.  Its ``main`` has no CPU mode: without
a GPU it exits 1 and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

import chip_smoke as cs
from ldpcsimulation_tpu import runtime
from ldpcsimulation_tpu.channel.nb import symbol_priors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tiny batches; the QC decoders compile per base-matrix block, so the
# flagship's 36-block code compiles faster than any smaller named QC code
TINY = cs.Widths(
    flagship_batch=64, flagship_frames=128, stream_lanes=64, ber_tol=0.5,
    standard_code="qc_1008_504", standard_frames=8, frames=16,
    generic="peg_96_48", qc=("qc_1008_504",), highrate=(256, 64, 4, 8),
    rs=(4, 8, 4), ddbmp_code="peg_96_48",
    nb=((48, 24, 3, 4), (48, 24, 3, 8)),
    compare_frames=64, prior_frames=4, prior_symbols=16, timing_reps=2,
)


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_fails_without_gpu(argv, capsys):
    assert cs.main(argv) == 1
    out = capsys.readouterr()
    assert "no GPU" in out.err
    assert '"ok"' not in out.out


@pytest.mark.parametrize("entry", ["bench", "perf_report"])
def test_measurement_entry_points_fail_without_gpu(entry, monkeypatch):
    if entry == "bench":
        import bench

        monkeypatch.setattr(sys, "argv", ["bench.py"])
        run = bench.main
    else:
        from ldpcsimulation_tpu.tools import perf_report

        def run():
            return perf_report.main([])
    with pytest.raises(RuntimeError, match="no GPU"):
        run()


@pytest.mark.parametrize("phase", ["P1", "P2", "P3", "P5", "P6"])
def test_phase_runs_at_tiny_widths(phase, tmp_path):
    """P4 and the four-card phases: tests/test_chip_smoke_families.py."""
    clock = cs.CompileClock()
    d = str(tmp_path)
    out = {
        "P1": lambda: cs.phase_flagship(TINY, d, clock, "cpu"),
        "P2": lambda: cs.phase_stream(TINY, d, clock),
        "P3": lambda: cs.phase_standard(TINY, d, clock),
        "P5": lambda: cs.phase_compare(TINY, d, clock),
        "P6": lambda: cs.phase_report(TINY, d, clock, "cpu"),
    }[phase]()
    assert out


@pytest.mark.parametrize("q", [4, 8, 16, 64])
def test_symbol_priors_match_float64_reference(q):
    """f32 priors within rtol 1e-5 / atol 1e-7 of float64 NumPy (the
    tolerance chip_smoke's P5 holds the card to)."""
    import jax.numpy as jnp

    m = q.bit_length() - 1
    rng = np.random.default_rng(q)
    n0 = 1.26
    y = 1.0 + np.sqrt(n0 / 2) * rng.standard_normal((8, 50, m))
    got = np.asarray(symbol_priors(jnp.asarray(y, jnp.float32), n0, q),
                     np.float64)
    want = cs.priors_reference(y.astype(np.float32), n0, q)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_peaks_table():
    from ldpcsimulation_tpu.tools.perf_report import PEAKS, device_peaks

    h100 = device_peaks("NVIDIA H100 80GB HBM3")
    assert h100["hbm_bytes_per_s"] == 3.35e12
    assert h100["bf16_flops"] == 989e12 and h100["f32_flops"] == 67e12
    assert all("source" in v for v in PEAKS.values())
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks("cpu")


def _cache_probe(env_extra):
    """Run enable_compile_cache + one compile in a fresh process; returns
    (directory it returned, jax_compilation_cache_dir after it)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               PYTHONPATH=REPO, **env_extra)
    code = (
        "import json, os, jax, jax.numpy as jnp\n"
        "from ldpcsimulation_tpu.runtime import enable_compile_cache\n"
        "d = enable_compile_cache()\n"
        "jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)(jnp.arange(7.0))"
        ".block_until_ready()\n"
        "print(json.dumps([d, jax.config.jax_compilation_cache_dir]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_compile_cache_honours_env_var():
    with tempfile.TemporaryDirectory() as d:
        reported, config_dir = _cache_probe({"JAX_COMPILATION_CACHE_DIR": d})
        assert reported == config_dir == d
        assert os.listdir(d), "nothing cached in JAX_COMPILATION_CACHE_DIR"


def test_compile_cache_default_is_fixed_inside_checkout():
    assert runtime.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    reported, config_dir = _cache_probe({})
    assert reported == config_dir == runtime.DEFAULT_CACHE_DIR
    assert os.listdir(runtime.DEFAULT_CACHE_DIR)
