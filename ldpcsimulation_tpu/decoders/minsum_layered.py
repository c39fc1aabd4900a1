"""Row-layered min-sum schedule for QC codes.

The reference implements only the flooding schedule (every program updates
all checks, then all variables — e.g. ``decodeMinSum.cpp:247-263``).  A
layered (serial-C) schedule propagates information within an iteration and
typically halves the iteration count at equal BER; the BASELINE config list
includes a "layered vs flooding schedule comparison" on an 802.11n-class QC
code, so layered decoding is a first-class framework feature (no
reference counterpart).

Semantics (standard row-layered min-sum):
  * State: posterior LLRs ``q[N]`` (init = channel samples) and stored
    check messages ``L[c, j]`` (init = 0).
  * For each layer (here: one QC base-row, whose z checks touch each
    variable at most once — conflict-free by block structure):
        q_ext[j] = q[v_j] − L_old[c, j]
        L_new[c, j] = minsum over the row's q_ext (same two-min scan and
                      <=-tie-break as the flooding CN update)
        q[v_j] = q_ext[j] + L_new[c, j]
  * One iteration = one pass over all Mb layers (base-row order).
  * Decisions d = sign(q) with the BP/MS sgn(0)=+1 ... decision rule
    ``q > 0 ? +1 : −1`` matching decodeMinSum.cpp:470-474.

Normalized/offset variants apply to L_new exactly as in flooding.

Generalized QC structures (:class:`..codes.qc.QCCode`): a layer's z
checks touch each variable of a single-edge block exactly once, so the
posterior writes are conflict-free; a multi-edge PAIR touches every
column of its block twice within the layer.  Those blocks use the
block-parallel layered rule — all z checks of the layer read the same
pre-layer posterior and their updates accumulate,
``q' = (a1 − q) + a2`` with ``a_t = roll(qext_t + out_t)`` — which is
what pipelined QC layered hardware does.  Minus edges (absent from a
single-edge circulant, e.g. DVB-S2's accumulator corner) are excluded
from the scan via the +inf neutral and leave their column's posterior
and stored message untouched.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..codes.qc import QCCode
from .base import (
    DecodeResult,
    run_flooding,
    sgn_pos,
    storage_cast,
    vma_like,
)
from .minsum_qc import (
    assert_layered_compatible,
    qc_check_satisfied,
    qc_slot_plan,
)

__all__ = ["decode_minsum_layered_qc", "qc_minsum_layered_step",
           "layered_l0"]


def layered_l0(qc: QCCode, b: int, sdt, ref):
    """Zero-initialized stored check messages, one [dc_bi, z, B] leaf per
    layer (vma-typed off ``ref`` so ET while_loop carries match under
    shard_map — see base.vma_like)."""
    cn_plan, _ = qc_slot_plan(qc)
    return tuple(
        vma_like(jnp.zeros((len(cn_plan[bi]), qc.z, b), sdt), ref)
        for bi in range(qc.mb)
    )


def qc_minsum_layered_step(
    qc: QCCode,
    variant: str = "plain",
    alpha: float = 1.0,
    delta: float = 0.0,
    storage_dtype=None,
):
    """The :func:`decode_minsum_layered_qc` iteration as a pure function
    of the layered state: ``step((q, L)) -> ((q', L'), total)`` with
    ``q`` the per-VN-block posterior tuple, ``L`` the per-layer stored
    check messages, and ``total`` the stacked ``[Nb, z, B]`` posterior
    (decisions are its sign).  One call = one full pass over all Mb
    layers.  Identical operations (and therefore bit-identical results)
    to the closure inside :func:`decode_minsum_layered_qc` — factored
    out so the streaming refill harness (:mod:`...harness.stream`)
    shares one definition with the batch decoder.
    """
    cn_plan, _ = qc_slot_plan(qc)
    assert_layered_compatible(qc)
    z = qc.z

    def step(qL):
        q, L = qL
        dtype = q[0].dtype
        sdt = storage_dtype if storage_dtype is not None else dtype
        inf = jnp.asarray(jnp.inf, dtype)
        b = q[0].shape[-1]
        q = list(q)
        L = list(L)
        for bi in range(qc.mb):
            entries = cn_plan[bi]
            dc = len(entries)
            # extrinsic inputs in CN-row space; absent edges read the
            # scan-neutral +inf
            qext = []
            for t, e in enumerate(entries):
                qv = jnp.roll(q[e.bj], -e.shift, axis=0)
                qe = qv - L[bi][t].astype(dtype)
                if e.cn_mask is not None:
                    qe = jnp.where(jnp.asarray(e.cn_mask)[:, None], inf, qe)
                qext.append(qe)
            # two-min scan, <= tie-break (decodeMinSum.cpp:410-450)
            min1 = jnp.full((z, b), inf, dtype)
            min2 = jnp.full((z, b), inf, dtype)
            minidx = jnp.full((z, b), -1, jnp.int32)
            sprod = jnp.ones((z, b), dtype)
            for t in range(dc):
                a = jnp.abs(qext[t])
                sprod = sprod * sgn_pos(qext[t])
                is_min = a <= min1
                min2 = jnp.where(is_min, min1, jnp.where(a < min2, a, min2))
                minidx = jnp.where(is_min, t, minidx)
                min1 = jnp.where(is_min, a, min1)
            new_rows = []
            posts = []  # per-entry VN-layout posterior term a_t
            for t, e in enumerate(entries):
                mag = jnp.where(minidx == t, min2, min1)
                out = sprod * mag * sgn_pos(qext[t])
                if variant == "normalized":
                    out = out / alpha
                elif variant == "offset":
                    m2 = jnp.abs(out) - delta
                    out = jnp.where(
                        m2 > 0, sgn_pos(out) * m2, jnp.zeros_like(out)
                    )
                if e.cn_mask is not None:
                    # absent edge: no stored message, column untouched
                    cm = jnp.asarray(e.cn_mask)[:, None]
                    out = jnp.where(cm, jnp.zeros_like(out), out)
                    a_t = jnp.roll(
                        jnp.where(cm, jnp.roll(q[e.bj], -e.shift, axis=0),
                                  qext[t] + out),
                        e.shift, axis=0,
                    )
                else:
                    a_t = jnp.roll(qext[t] + out, e.shift, axis=0)
                posts.append(a_t)
                new_rows.append(storage_cast(out, sdt))
            t = 0
            while t < dc:
                e = entries[t]
                if t + 1 < dc and entries[t + 1].pair_second:
                    # pair block: block-parallel accumulate (see module
                    # docstring); grouping (a1 - q) + a2 fixed for the
                    # oracle equivalence
                    q[e.bj] = (posts[t] - q[e.bj]) + posts[t + 1]
                    t += 2
                else:
                    # single edge: conflict-free immediate update
                    q[e.bj] = posts[t]
                    t += 1
            L[bi] = jnp.stack(new_rows)
        q = tuple(q)
        return (q, tuple(L)), jnp.stack(q)

    return step


@functools.partial(
    jax.jit,
    static_argnames=(
        "qc",
        "num_iterations",
        "variant",
        "early_termination",
        "storage_dtype",
    ),
)
def decode_minsum_layered_qc(
    qc: QCCode,
    y: jax.Array,
    num_iterations: int,
    variant: str = "plain",
    alpha: float = 1.0,
    delta: float = 0.0,
    early_termination: bool = False,
    storage_dtype=None,
) -> DecodeResult:
    """Batched row-layered min-sum on a QC code.  y: [B, N]."""
    y_t = jnp.asarray(y).T
    n, b = y_t.shape
    assert n == qc.n
    z = qc.z
    dtype = y_t.dtype
    sdt = storage_dtype if storage_dtype is not None else dtype
    # The posterior and the stored check messages are carried as PYTREE
    # TUPLES of per-block arrays, not stacked buffers: a layer update then
    # rebinds only the [z, B] blocks it touches (pure SSA values), where a
    # stacked q with 90 interleaved `.at[bj].set`s made XLA materialize
    # full-posterior copies, ~26x the actual per-layer traffic on DVB-S2.
    q0 = tuple(y_t.reshape(qc.nb, z, b))
    # stored messages per layer: [dc_bi, z, B] (exact row degree, no pad);
    # vma-typed from the input so the early-termination while_loop carry
    # matches under shard_map (see base.vma_like)
    l0 = layered_l0(qc, b, sdt, y_t)
    step = qc_minsum_layered_step(qc, variant, alpha, delta, storage_dtype)

    def decide(q):
        return tuple(
            jnp.where(qb > 0, 1, -1).astype(jnp.int32) for qb in q
        )

    d, iters, done = run_flooding(
        (q0, l0),
        lambda st: step(st)[0],
        lambda st: decide(st[0]),
        lambda d: qc_check_satisfied(qc, d),
        num_iterations, early_termination, b,
    )
    return DecodeResult(
        hard=jnp.stack(d).reshape(n, b).T, iterations=iters, satisfied=done
    )
