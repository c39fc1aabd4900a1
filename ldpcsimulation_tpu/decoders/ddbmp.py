"""DD-BMP: Differential Decoding with Binary Message Passing.

Behavioral reference: ``C_implementations/src/decodeDDBMP.cpp``:
  * Channel samples are always quantized with the no-zero-level quantizer
    (``:433-443``, Nq = 2^Q levels) — done by the caller/harness here.
  * Init (``:301-310``): every VN slot's accumulator memory starts at the
    channel sample; outgoing binary message = its sign.
  * CN update (``:350-372``): sign product excluding self (signs are ±1, so
    exclusion is multiplication by self).
  * VN update (``:395-422``): ``memory[v][s] += (total − c2v[s])`` where
    ``total = y[v] + Σ c2v``; outgoing message = sign(memory); decision =
    majority of ``sign(y[v]) + Σ outgoing`` (ties → −1).
  * Stopping (``:202-204, 375-393``): hard-decision syndrome checked *after*
    each update round; the reported iteration count is the loop index at
    break (0-based), or T if never satisfied — one less than the number of
    update rounds performed, matching ``totalIterations += it``.

The invariant ``outgoing = sgn(memory)`` lets the decoder carry only the
memory array; sgn uses the +1-at-zero convention (``:426-430``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..codes.code import Code
from .base import DecodeResult, check_satisfied, gather_cn, gather_vn, sgn_pos, vma_like

__all__ = ["decode_ddbmp", "decode_ddbmp_qc", "decode_ddbmp_stratified"]


@functools.partial(jax.jit, static_argnames=("num_iterations",))
def decode_ddbmp(
    code: Code, yq: jax.Array, num_iterations: int
) -> DecodeResult:
    """Batched DD-BMP decode.  yq: [B, N] (quantized) channel samples."""
    y_t = jnp.asarray(yq).T  # [N, B]
    dtype = y_t.dtype
    n, b = y_t.shape
    mem0 = jnp.repeat(y_t, code.dv_max, axis=0)  # [N*dv_max, B]
    d0 = jnp.where(y_t > 0, 1, -1).astype(jnp.int32)
    sign_y = sgn_pos(y_t)

    def one_round(mem):
        s2c = sgn_pos(mem)  # ±1 binary messages
        # CN: product over row signs, exclusion by self-multiplication.
        # Sequential product + per-slot emission: values are ±1 so any
        # order is exact.  (The reduce-broadcast form, jnp.prod keepdims
        # * g, once crashed the compiler of the first target device when
        # composed with the downstream gather; this form avoids it.)
        g = gather_cn(code, s2c)  # [M, dc_max, B]
        g = jnp.where(code.cn_mask[:, :, None], g, jnp.ones_like(g))
        prod = g[:, 0, :]
        for t in range(1, code.dc_max):
            prod = prod * g[:, t, :]
        c2v = jnp.stack(
            [prod * g[:, t, :] for t in range(code.dc_max)], axis=1
        ).reshape(code.m * code.dc_max, b)
        # VN
        gv = gather_vn(code, c2v)  # [N, dv_max, B]
        gv = jnp.where(code.vn_mask[:, :, None], gv, jnp.zeros_like(gv))
        # left fold FROM y (decodeDDBMP.cpp:399-407 ``sum = y[i]; sum +=
        # msg``): the y + sum(gv) association differed by 1 ulp on
        # non-representable quantized samples and, because the memories
        # accumulate it every round, flipped message signs at zero
        # crossings — a real trajectory divergence vs the C loop
        total = y_t
        for s in range(code.dv_max):
            total = total + gv[:, s, :]
        # grouping matters at the ulp: the reference accumulates
        # ``memories[i][j] += sum - msg`` (decodeDDBMP.cpp:413) — i.e.
        # mem + (sum - msg), NOT (mem + sum) - msg
        mem_new = mem.reshape(n, code.dv_max, b) + (total[:, None, :] - gv)
        mem_new = mem_new.reshape(n * code.dv_max, b)
        out_signs = sgn_pos(mem_new).reshape(n, code.dv_max, b)
        out_signs = jnp.where(
            code.vn_mask[:, :, None], out_signs, jnp.zeros_like(out_signs)
        )
        dsum = sign_y + jnp.sum(out_signs, axis=1)
        d = jnp.where(dsum > 0, 1, -1).astype(jnp.int32)
        return mem_new, d

    init = (
        jnp.int32(0),
        mem0,
        d0,
        vma_like(jnp.full((b,), num_iterations, jnp.int32), d0),
        vma_like(jnp.zeros((b,), bool), d0),
    )

    def cond(carry):
        t, _mem, _d, _iters, done = carry
        return (t < num_iterations) & ~jnp.all(done)

    def body(carry):
        t, mem, d, iters, done = carry
        mem_new, d_new = one_round(mem)
        act = ~done
        # decision-only masking: only the latched decision carry freezes —
        # a satisfied frame's memories may keep evolving (frames are
        # independent along the batch and d/iters are latched), saving a
        # full memory-plane read+write per iteration (same finding as
        # run_flooding_soft for BP/min-sum and the NB ET loop).
        d = jnp.where(act[None, :], d_new, d)
        sat = check_satisfied(code, d)
        newly = act & sat
        iters = jnp.where(newly, t, iters)  # break index, it = t
        done = done | sat
        return (t + 1, mem_new, d, iters, done)

    _t, _mem, d, iters, done = jax.lax.while_loop(cond, body, init)
    return DecodeResult(hard=d.T, iterations=iters, satisfied=done)


def qc_ddbmp_round(qc, cn_plan, vn_plan, mem, yb, fresh=None):
    """One DD-BMP update round on the QC roll path -> (mem', d).

    mem: [nb, dv_max, z, B] accumulator memories; yb: [nb, z, B] channel.
    Shared verbatim by :func:`decode_ddbmp_qc` and the streaming adapter
    (harness/stream.py ``ddbmp_qc_stream``) so the two cannot drift.

    ``d`` is emitted as INT8 (values ±1; round-5 item: the decision
    latch + per-round syndrome pass move [nb, z, B] planes every
    iteration, and int8 quarters that traffic — the ablation measured
    the int32 planes at ~0.75 ms/iter of recoverable cost at 4096
    lanes).  Decisions are sign bits, so the narrowing is exact.

    ``fresh``: optional [B] bool — lanes whose memories must read as
    freshly initialized (every slot = the channel sample,
    ``decodeDDBMP.cpp:301-310``).  The select is applied AT EACH READ
    SITE instead of materializing a merged [nb, dv_max, z, B] array
    (the streaming adapter's lazy-init path: the array-level merge was
    the ablation's measured ~1.0 ms/iter — DD-BMP's 4-slot f32
    accumulator state is ~4× the soft decoders').  Values are identical
    to merging first (the select commutes into the reads), so the
    streamed trajectories stay bit-exact.
    """
    z = qc.z
    dv_max = qc.dv_max
    b = yb.shape[-1]
    sign_y = sgn_pos(yb)
    zero = jnp.zeros((z, b), yb.dtype)

    if fresh is None:
        read = lambda bj, s: mem[bj, s]  # noqa: E731
    else:
        fr = fresh[None, :]
        read = lambda bj, s: jnp.where(fr, yb[bj], mem[bj, s])  # noqa: E731
    # CN: sign product with exclusion-by-self (values ±1, order-free)
    c2v = [[None] * len(qc.vn_blocks[bj]) for bj in range(qc.nb)]
    for bi in range(qc.mb):
        views = []
        for e in cn_plan[bi]:
            v = jnp.roll(sgn_pos(read(e.bj, e.vslot)), -e.shift, axis=0)
            if e.cn_mask is not None:
                v = jnp.where(
                    jnp.asarray(e.cn_mask)[:, None], jnp.ones_like(v), v
                )
            views.append(v)
        prod = views[0]
        for v in views[1:]:
            prod = prod * v
        for t, e in enumerate(cn_plan[bi]):
            c2v[e.bj][e.vslot] = jnp.roll(
                prod * views[t], e.shift, axis=0
            )
    totals = []
    planes = []
    dsums = []
    for bj in range(qc.nb):
        slots = []
        for e, sa in zip(vn_plan[bj], c2v[bj]):
            if e.zero_mask is not None:
                sa = jnp.where(
                    jnp.asarray(e.zero_mask)[:, None],
                    jnp.zeros_like(sa), sa,
                )
            slots.append(sa)
        # left fold FROM y (decodeDDBMP.cpp:399-407; see the generic
        # decoder) — keeps QC bit-exact with generic AND with the C
        acc = yb[bj]
        for sa in slots:
            acc = acc + sa
        total = acc
        totals.append(total)
        mem_rows = []
        outs = []
        for s, (e, sa) in enumerate(zip(vn_plan[bj], slots)):
            mrow = read(bj, s) + (total - sa)
            mem_rows.append(mrow)
            o = sgn_pos(mrow)
            if e.zero_mask is not None:
                o = jnp.where(
                    jnp.asarray(e.zero_mask)[:, None],
                    jnp.zeros_like(o), o,
                )
            outs.append(o)
        mem_rows += [zero] * (dv_max - len(mem_rows))
        planes.append(jnp.stack(mem_rows))
        osum = outs[0]
        for o in outs[1:]:
            osum = osum + o
        dsums.append(sign_y[bj] + osum)
    d = jnp.where(jnp.stack(dsums) > 0, 1, -1).astype(jnp.int8)
    return jnp.stack(planes), d


@functools.partial(jax.jit, static_argnames=("qc", "num_iterations"))
def decode_ddbmp_qc(
    qc, yq: jax.Array, num_iterations: int
) -> DecodeResult:
    """Gather-free DD-BMP on a QC code (same semantics as
    :func:`decode_ddbmp`; the VN<->CN permutation runs as static per-block
    rolls, see :mod:`.minsum_qc`).

    Bit-exact with the generic decoder on the same expanded H for ANY slot
    order: messages are ±1 and the accumulator sums add small exact f32
    values, so no reduction-order rounding exists to preserve.  Generalized
    structures use the qc_slot_plan masks — absent edges contribute the +1
    product neutral, a zero c2v term, and a zeroed decision vote.
    """
    from .minsum_qc import qc_check_satisfied, qc_slot_plan

    y_t = jnp.asarray(yq).T  # [N, B]
    n, b = y_t.shape
    assert n == qc.n
    yb = y_t.reshape(qc.nb, qc.z, b)
    cn_plan, vn_plan = qc_slot_plan(qc)
    mem0 = jnp.broadcast_to(
        yb[:, None], (qc.nb, qc.dv_max, qc.z, b)
    ).astype(y_t.dtype)
    # int8 decision planes (values ±1): the latch + syndrome pass touch
    # [nb, z, B] every round — 4x less traffic than int32, exact
    d0 = jnp.where(yb > 0, 1, -1).astype(jnp.int8)

    def one_round(mem):
        return qc_ddbmp_round(qc, cn_plan, vn_plan, mem, yb)


    init = (
        jnp.int32(0),
        mem0,
        d0,
        vma_like(jnp.full((b,), num_iterations, jnp.int32), d0),
        vma_like(jnp.zeros((b,), bool), d0),
    )

    def cond(carry):
        t, _mem, _d, _iters, done = carry
        return (t < num_iterations) & ~jnp.all(done)

    def body(carry):
        t, mem, d, iters, done = carry
        mem_new, d_new = one_round(mem)
        act = ~done
        # decision-only masking (see decode_ddbmp): the memory planes of
        # satisfied frames evolve freely; d/iters latch preserves outputs.
        d = jnp.where(act[None, None, :], d_new, d)
        sat = qc_check_satisfied(qc, d)
        newly = act & sat
        iters = jnp.where(newly, t, iters)  # break index, it = t
        done = done | sat
        return (t + 1, mem_new, d, iters, done)

    _t, _mem, d, iters, done = jax.lax.while_loop(cond, body, init)
    return DecodeResult(hard=d.reshape(n, b).T.astype(jnp.int32),
                        iterations=iters, satisfied=done)


@functools.partial(jax.jit, static_argnames=("num_iterations",))
def decode_ddbmp_stratified(
    sc, yq: jax.Array, num_iterations: int
) -> DecodeResult:
    """Gather-free DD-BMP on a stratified code (same semantics as
    :func:`decode_ddbmp`; the VN<->CN movement is the one-hot matmul
    interleaver, see :mod:`..codes.stratified`) — the universal fallback
    for unstructured matrices that fail QC detection.

    The einsum moves ±1/0 payloads exactly (single-term sums at
    Precision.HIGHEST) and messages are ±1, so the result is bit-exact
    with the generic decoder whenever both sum the accumulator in the same
    order — contiguous strata, the 802.3an layout, sum in the alist's row
    order — or the sums are exact in f32 (quantizer levels that are dyadic
    rationals: Ymax=1.75 with 8 levels, steps of 0.5).  Greedy strata with
    other levels (the default Ymax=1.5, 8 levels: steps of 3/7) round
    differently: on the 2048-bit PEG code at 5 dB, 9 of 256 frames ended
    on other decisions, all of them run to the iteration cap with equal
    iteration counts.
    """
    from .minsum_stratified import (
        stratified_check_satisfied,
        stratified_to_cn,
        stratified_to_vn,
    )

    y_t = jnp.asarray(yq).T  # [N, B]
    n, b = y_t.shape
    assert n == sc.n, (n, sc.n)
    safe_slot = jnp.maximum(sc.col_slot, 0)
    yg = jnp.take(y_t, safe_slot.reshape(-1), axis=0).reshape(
        sc.kg, sc.w, b
    )
    yg = jnp.where((sc.col_slot >= 0)[..., None], yg, 0.0)
    vnv = sc.vn_valid[..., None]
    cnv = sc.cn_valid[..., None]
    mem0 = jnp.where(
        vnv, jnp.broadcast_to(yg[None], (sc.mb, sc.kg, sc.w, b)), 0.0
    ).astype(y_t.dtype)
    d0 = jnp.where(yg > 0, 1, -1).astype(jnp.int32)
    sign_y = sgn_pos(yg)

    def one_round(mem):
        s2c = jnp.where(vnv, sgn_pos(mem), 0.0)
        g = stratified_to_cn(sc, s2c)  # [mb, h, kg, B]
        g = jnp.where(cnv, g, jnp.ones_like(g))
        # sign product with exclusion-by-self (values ±1, order-free)
        prod = jnp.prod(g, axis=2, keepdims=True)
        c2v_cn = jnp.where(cnv, prod * g, 0.0)
        c2v = stratified_to_vn(sc, c2v_cn)  # [mb, kg, w, B]
        c2v = jnp.where(vnv, c2v, 0.0)
        # left fold FROM y (decodeDDBMP.cpp:399-407)
        total = yg
        for s in range(sc.mb):
            total = total + c2v[s]
        # mem + (sum - msg), NOT (mem + sum) - msg (decodeDDBMP.cpp:413)
        mem_new = jnp.where(vnv, mem + (total[None] - c2v), 0.0)
        out_signs = jnp.where(vnv, sgn_pos(mem_new), 0.0)
        dsum = sign_y + jnp.sum(out_signs, axis=0)
        d = jnp.where(dsum > 0, 1, -1).astype(jnp.int32)
        return mem_new, d

    init = (
        jnp.int32(0),
        mem0,
        d0,
        vma_like(jnp.full((b,), num_iterations, jnp.int32), d0),
        vma_like(jnp.zeros((b,), bool), d0),
    )

    def cond(carry):
        t, _mem, _d, _iters, done = carry
        return (t < num_iterations) & ~jnp.all(done)

    def body(carry):
        t, mem, d, iters, done = carry
        mem_new, d_new = one_round(mem)
        act = ~done
        # decision-only masking (see decode_ddbmp)
        d = jnp.where(act[None, None, :], d_new, d)
        sat = stratified_check_satisfied(sc, d)
        newly = act & sat
        iters = jnp.where(newly, t, iters)  # break index, it = t
        done = done | sat
        return (t + 1, mem_new, d, iters, done)

    _t, _mem, d, iters, done = jax.lax.while_loop(cond, body, init)
    hard = jnp.take(d.reshape(sc.kg * sc.w, b), sc.pos_of_col, axis=0)
    return DecodeResult(hard=hard.T, iterations=iters, satisfied=done)
