"""Dense matmul graph ops: bit-exact equivalence with the generic gather path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpcsimulation_tpu.codes import build_code, load_alist, make_regular_code
from ldpcsimulation_tpu.codes.construct import peg
from ldpcsimulation_tpu.decoders.base import syndrome_from_hard
from ldpcsimulation_tpu.decoders.dense_ops import (
    DenseGraph,
    dense_sat_sum_per_vn,
    dense_syndrome01,
    dense_syndrome_bipolar,
    dense_syndrome_sum_per_vn,
    dense_worthwhile,
)
from ldpcsimulation_tpu.decoders.gdbf import decode_gdbf, preset
from ldpcsimulation_tpu.decoders.ngdbf_hw import NGDBFHwConfig, decode_ngdbf_hw
from ldpcsimulation_tpu.decoders.gdbf import _syndrome_sum_per_vn
from tests.conftest import require_reference


@pytest.fixture(scope="module", params=["regular", "irregular"])
def any_code(request):
    if request.param == "regular":
        return make_regular_code(96, 48, 3, seed=0)
    # PEG gives irregular check degrees -> exercises padding slots
    return build_code(peg(120, 40, 3, seed=7))


def test_dense_ops_match_generic(any_code, rng):
    code = any_code
    dg = DenseGraph.from_code(code)
    d = jnp.asarray(rng.choice([-1, 1], size=(code.n, 32)), jnp.int32)
    syn_ref = np.asarray(syndrome_from_hard(code, d))
    syn_dense = np.asarray(dense_syndrome_bipolar(dg, d))
    np.testing.assert_array_equal(syn_dense, syn_ref)

    ss_ref = np.asarray(_syndrome_sum_per_vn(code, jnp.asarray(syn_ref)))
    ss_dense = np.asarray(dense_syndrome_sum_per_vn(dg, jnp.asarray(syn_ref)))
    np.testing.assert_array_equal(ss_dense, ss_ref)

    # {0,1} forms used by NGDBFhw
    d01 = ((1 - np.asarray(d)) // 2).astype(np.int32)
    syn01 = np.asarray(dense_syndrome01(dg, jnp.asarray(d01)))
    np.testing.assert_array_equal(syn01, (1 - syn_ref) // 2)
    sat = np.asarray(dense_sat_sum_per_vn(dg, jnp.asarray(syn01)))
    deg = np.asarray(any_code.vn_deg)
    # satisfied-neighbor count + unsatisfied-neighbor count = degree
    unsat_ref = np.zeros_like(sat)
    vn_cn = np.asarray(code.vn_cn)
    vn_mask = np.asarray(code.vn_mask)
    for v in range(code.n):
        for s in range(code.dv_max):
            if vn_mask[v, s]:
                unsat_ref[v] += syn01[vn_cn[v, s]]
    np.testing.assert_array_equal(sat, deg[:, None] - unsat_ref)


def test_decode_gdbf_dense_bit_exact(any_code, rng):
    """Full SM-NGDBF decode: dense path == generic path, frame for frame."""
    code = any_code
    dg = DenseGraph.from_code(code)
    cfg = preset("SMNGDBF", num_iterations=15, theta=-0.7, alpha=0.9,
                 window_size=8)
    y = jnp.asarray(
        1.0 + 0.6 * rng.standard_normal((24, code.n)), jnp.float32
    )
    key = jax.random.key(11)
    a = decode_gdbf(code, y, 0.6, cfg, key=key)
    b = decode_gdbf(code, y, 0.6, cfg, key=key, dense=dg)
    np.testing.assert_array_equal(np.asarray(a.hard), np.asarray(b.hard))
    np.testing.assert_array_equal(
        np.asarray(a.iterations), np.asarray(b.iterations)
    )
    np.testing.assert_array_equal(
        np.asarray(a.satisfied), np.asarray(b.satisfied)
    )


def test_decode_ngdbf_hw_dense_bit_exact(any_code, rng):
    code = any_code
    dg = DenseGraph.from_code(code)
    cfg = NGDBFHwConfig(
        num_iterations=30, ring_len=code.n + 200, max_phases=2
    )
    y = jnp.asarray(
        1.0 + 0.5 * rng.standard_normal((16, code.n)), jnp.float32
    )
    key = jax.random.key(3)
    a = decode_ngdbf_hw(code, y, 0.5, cfg, key=key)
    b = decode_ngdbf_hw(code, y, 0.5, cfg, key=key, dense=dg)
    np.testing.assert_array_equal(np.asarray(a.hard), np.asarray(b.hard))
    np.testing.assert_array_equal(
        np.asarray(a.iterations), np.asarray(b.iterations)
    )
    np.testing.assert_array_equal(
        np.asarray(a.least_errors), np.asarray(b.least_errors)
    )


def test_dense_on_reference_802_3_h(rng):
    """The real 802.3an H (dc=32, redundant rows): dense == generic."""
    p = require_reference("C_implementations/codes/802_3/802_3_H.alist")
    code = build_code(load_alist(p))
    assert dense_worthwhile(code)
    dg = DenseGraph.from_code(code)
    d = jnp.asarray(rng.choice([-1, 1], size=(code.n, 8)), jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(dense_syndrome_bipolar(dg, d)),
        np.asarray(syndrome_from_hard(code, d)),
    )
    syn = syndrome_from_hard(code, d)
    np.testing.assert_array_equal(
        np.asarray(dense_syndrome_sum_per_vn(dg, syn)),
        np.asarray(_syndrome_sum_per_vn(code, syn)),
    )


def test_dense_worthwhile_threshold():
    small = make_regular_code(96, 48, 3, seed=0)
    assert dense_worthwhile(small)

    class Fake:
        m, n = 32400, 64800  # DVB-S2: past the threshold

    assert not dense_worthwhile(Fake())
