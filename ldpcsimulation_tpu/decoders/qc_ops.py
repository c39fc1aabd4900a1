"""Roll-based graph operations for QC codes, shared by the bit-flip family.

The GDBF/NGDBF decoders touch the Tanner graph in exactly two places: the
bipolar syndrome per check and the per-variable sum of neighboring
syndromes.  Both are dynamic gathers in the generic path; for QC codes they
become static per-block rolls (see codes/qc.py).  Outputs are
bit-identical to the generic implementations — products
and sums of the same operands in a different static order.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..codes.qc import QCCode

__all__ = ["qc_syndrome_bipolar", "qc_syndrome_sum_per_vn"]


def qc_syndrome_bipolar(qc: QCCode, d):
    """d: [N, B] ±1 -> bipolar syndrome [M, B] (+1 satisfied).

    Multi-edge blocks are just repeated rolls; defect edges
    (``qc.minus_edges``) are corrected afterwards — the spurious factor is
    ±1, so multiplying by the same value again removes it exactly.
    """
    b = d.shape[-1]
    db = d.reshape(qc.nb, qc.z, b)
    rows = [None] * qc.mb
    for bi in range(qc.mb):
        prod = None
        for bj, shift in qc.cn_blocks[bi]:
            v = jnp.roll(db[bj], -shift, axis=0)
            prod = v if prod is None else prod * v
        rows[bi] = prod
    for bi, bj, s, r in qc.minus_edges:
        spurious = db[bj, (r + s) % qc.z]  # [B] ±1
        rows[bi] = rows[bi].at[r].multiply(spurious)
    return jnp.stack(rows).reshape(qc.m, b)


def qc_syndrome_sum_per_vn(qc: QCCode, syn):
    """syn: [M, B] -> per-variable neighbor syndrome sums [N, B].

    Defect edges subtract their syndrome contribution from the one
    affected variable.
    """
    b = syn.shape[-1]
    sb = syn.reshape(qc.mb, qc.z, b)
    cols = [None] * qc.nb
    for bj in range(qc.nb):
        acc = None
        for bi, shift in qc.vn_blocks[bj]:
            v = jnp.roll(sb[bi], shift, axis=0)
            acc = v if acc is None else acc + v
        cols[bj] = acc
    for bi, bj, s, r in qc.minus_edges:
        cols[bj] = cols[bj].at[(r + s) % qc.z].add(-sb[bi, r])
    return jnp.stack(cols).reshape(qc.n, b)
