"""Dense-matmul graph operations for the bit-flip family.

The GDBF/NGDBF decoders touch the Tanner graph in exactly two places — the
syndrome per check and the per-variable sum of neighboring syndromes — and
both are linear in the graph's incidence matrix:

  * syndrome parity  = (H @ bits) mod 2            (bits ∈ {0,1})
  * neighbor sums    = Hᵀ @ syn                    (syn per check)

Many reference codes (the 802.3an RS-LDPC above all) have no circulant
structure the roll path (:mod:`.qc_ops`) could exploit, which leaves the
generic path's dynamic row gathers.  But a *dense* H of 2048×384 is only
1.5 MB in bf16 — the two ops become plain matrix products with bf16
operands and f32 accumulation, which a GPU's tensor cores run.  The
arithmetic is exact: operands are 0/±1 (exact in bf16) and every
accumulation is an integer ≤ dc_max/dv_max ≪ 2²⁴, accumulated in f32 by
``preferred_element_type``.  Outputs are therefore bit-identical to the
generic implementations.

Use :meth:`DenseGraph.from_code` for any code where ``n*m`` entries fit
comfortably in device memory (see :func:`dense_worthwhile`); the DVB-S2 64800-bit
class is past the threshold and keeps the gather/QC paths.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.code import Code

__all__ = [
    "DenseGraph",
    "dense_worthwhile",
    "dense_syndrome_bipolar",
    "dense_syndrome_sum_per_vn",
    "dense_syndrome01",
    "dense_sat_sum_per_vn",
]

# n*m above this many entries, the dense H (bf16) stops paying for itself
# (memory traffic of the operand matrix plus matmul time grow linearly while
# the gather path's cost is fixed per edge).  64M entries = 128 MB bf16.
DENSE_MAX_ENTRIES = 64 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class DenseGraph:
    """Dense incidence-matrix companion to :class:`Code` (same H).

    A JAX pytree: ``h`` is the [M, N] 0/1 matrix in bf16 (exact), and
    ``vn_deg_f`` the [N] per-variable degrees as f32 (for satisfied-count
    complements).  Construction is one-time host work via
    :meth:`from_code`.
    """

    m: int
    n: int
    dc_max: int
    dv_max: int
    h: jax.Array  # [M, N] bf16 0/1
    vn_deg_f: jax.Array  # [N] f32

    @classmethod
    def from_code(cls, code: Code) -> "DenseGraph":
        h = np.zeros((code.m, code.n), np.float32)
        cn_vn = np.asarray(code.cn_vn)
        cn_mask = np.asarray(code.cn_mask)
        rows = np.repeat(np.arange(code.m), code.dc_max)
        keep = cn_mask.reshape(-1)
        h[rows[keep], cn_vn.reshape(-1)[keep]] = 1.0
        return cls(
            m=code.m,
            n=code.n,
            dc_max=code.dc_max,
            dv_max=code.dv_max,
            h=jnp.asarray(h, jnp.bfloat16),
            vn_deg_f=jnp.asarray(code.vn_deg, jnp.float32),
        )


jax.tree_util.register_dataclass(
    DenseGraph,
    data_fields=["h", "vn_deg_f"],
    meta_fields=["m", "n", "dc_max", "dv_max"],
)


def dense_worthwhile(code: Code) -> bool:
    """Whether the dense path is expected to beat the gather path."""
    return code.m * code.n <= DENSE_MAX_ENTRIES


def _mm(a, x):
    """Exact integer matmul of 0/1-(or small-int)-valued operands."""
    return jax.lax.dot_general(
        a,
        x.astype(jnp.bfloat16),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def dense_syndrome_bipolar(dg: DenseGraph, d) -> jax.Array:
    """d: [N, B] ±1 -> bipolar syndrome [M, B] (+1 satisfied), int32.

    prod(d) over a row == (−1)^(#negatives); #negatives = H @ (1−d)/2.
    """
    bits = (1 - d) * 0.5  # {0, 1}
    cnt = _mm(dg.h, bits)  # [M, B] integer-valued f32, ≤ dc_max
    par = cnt - 2.0 * jnp.floor(cnt * 0.5)  # mod 2
    return (1 - 2 * par.astype(jnp.int32)).astype(jnp.int32)


def dense_syndrome_sum_per_vn(dg: DenseGraph, syn) -> jax.Array:
    """syn: [M, B] -> per-variable neighbor syndrome sums [N, B] (f32).

    Exact for any small-integer syn (±1 bipolar): Hᵀ @ syn with f32
    accumulation.
    """
    return _mm(dg.h.T, syn)


def dense_syndrome01(dg: DenseGraph, d01) -> jax.Array:
    """d01: [N, B] {0,1} -> {0,1} syndrome [M, B] int32 (0 = satisfied)."""
    cnt = _mm(dg.h, d01)
    par = cnt - 2.0 * jnp.floor(cnt * 0.5)
    return par.astype(jnp.int32)


def dense_sat_sum_per_vn(dg: DenseGraph, syn01) -> jax.Array:
    """syn01: [M, B] {0,1} -> per-variable count of SATISFIED neighboring
    checks [N, B] int32 (the NGDBFhw ``Σ_j (1 − s_j)`` term)."""
    unsat = _mm(dg.h.T, syn01)  # [N, B] count of unsatisfied neighbors
    return (dg.vn_deg_f[:, None] - unsat).astype(jnp.int32)
