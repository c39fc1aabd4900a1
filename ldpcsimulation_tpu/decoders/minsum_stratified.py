"""Gather-free min-sum for stratified block-permutation codes (802.3an).

Same arithmetic and tie-breaking as :mod:`.minsum` (bit-exact equivalence
is tested on the reference's real ``802_3_H.alist``), but the VN<->CN edge
permutation is ``mb*kg`` static partial permutations applied as one batched
one-hot einsum (see :mod:`..codes.stratified`) — no dynamic gathers on
the iteration path, unlike the generic slot-array decoder.

Two semantic notes versus the sequential-scan CN update of
``minsum_cn_update`` (`decodeMinSum.cpp:410-450`):

  * The reference's ``<=`` tie-break means the LAST minimum in alist slot
    order receives min2.  Here CN slots are ordered by column group, not
    alist order, so the scan is replaced by an order-independent
    formulation: min1/min2 by masked reductions, and the min2 recipient
    picked as the valid slot with the highest ``cn_rank`` (the edge's
    alist position) among those equal to min1.  This reproduces the scan
    exactly: a slot equals the running minimum at its last global-minimum
    occurrence and never after, so the final minidx IS the last argmin in
    alist order.
  * The VN sum accumulates strata in index order; when strata are the
    contiguous blocks auto-detected for 802.3an this coincides with the
    alist's ascending-row column order, making the f32 sums bit-identical
    to the generic decoder's.  (For greedy non-contiguous strata the sum
    order — and only the rounding — may differ.)

One-hot matmuls are exact for the payloads used here: each output is a
single-term sum (one 1.0 per row of the one-hot), and
``Precision.HIGHEST`` keeps f32 operands intact (a GPU would otherwise
run an f32 dot in TF32, which rounds the payloads).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..codes.stratified import StratifiedCode
from .base import DecodeResult, run_flooding_soft, sgn_pos, storage_cast

__all__ = [
    "decode_minsum_stratified",
    "stratified_to_cn",
    "stratified_to_vn",
    "stratified_check_satisfied",
    "stratified_grid",
    "stratified_init",
    "stratified_minsum_step",
]

_HI = jax.lax.Precision.HIGHEST


def stratified_to_cn(sc: StratifiedCode, x_vn: jax.Array) -> jax.Array:
    """VN slots [mb, kg, w, B] -> CN slots [mb, h, kg, B] (one-hot einsum).

    Invalid CN slots receive exact 0.0 (their one-hot rows are all-zero).
    The f32 single-term contraction moves f16/f32 payloads exactly.

    Inputs MUST be finite: a matmul interleaver computes ``0 * inf = NaN``
    against its structural zeros, and one NaN poisons the whole block
    (every frame in it comes back sign-inverted).  ``storage_cast``
    saturates the f16 store so messages can never reach ``inf``; the
    explicit f32 upcast keeps the contraction on the exact f32 HIGHEST
    path regardless of storage dtype."""
    out = jnp.einsum(
        "sgch,sgcB->shgB",
        sc.onehot,
        x_vn.astype(jnp.float32),
        precision=_HI,
        preferred_element_type=jnp.float32,
    )
    return out.astype(x_vn.dtype)


def stratified_to_vn(sc: StratifiedCode, x_cn: jax.Array) -> jax.Array:
    """CN slots [mb, h, kg, B] -> VN slots [mb, kg, w, B].

    Callers must zero invalid CN slots first (0 * onehot contributes 0).
    Finite-input requirement and f32 upcast as in
    :func:`stratified_to_cn`."""
    out = jnp.einsum(
        "sgch,shgB->sgcB",
        sc.onehot,
        x_cn.astype(jnp.float32),
        precision=_HI,
        preferred_element_type=jnp.float32,
    )
    return out.astype(x_cn.dtype)


def stratified_check_satisfied(sc: StratifiedCode, d_grid: jax.Array):
    """d_grid: [kg, w, B] ±1 (pad slots arbitrary) -> [B] all satisfied."""
    dv = jnp.where(sc.vn_valid[..., None], d_grid[None].astype(jnp.float32), 0.0)
    dc = stratified_to_cn(sc, dv)  # [mb, h, kg, B]
    dc = jnp.where(sc.cn_valid[..., None], dc, 1.0)
    syn = jnp.prod(dc, axis=2)  # [mb, h, B]
    return jnp.all(syn > 0, axis=(0, 1))


def _cn_minsum(sc: StratifiedCode, v2c_cn, variant, alpha, delta):
    """Order-independent CN min-sum over [mb, h, kg, B] slots; returns c2v
    in the same CN layout with invalid slots zeroed."""
    dtype = v2c_cn.dtype
    inf = jnp.asarray(jnp.inf, dtype)
    valid = sc.cn_valid[..., None]  # [mb, h, kg, 1]
    rank = sc.cn_rank[..., None]    # [mb, h, kg, 1]

    a = jnp.where(valid, jnp.abs(v2c_cn), inf)
    min1 = jnp.min(a, axis=2, keepdims=True)
    is_min = valid & (a == min1)
    nmin = jnp.sum(is_min, axis=2, keepdims=True)
    min2_excl = jnp.min(jnp.where(is_min, inf, a), axis=2, keepdims=True)
    min2 = jnp.where(nmin > 1, min1, min2_excl)
    # the reference's `<=` scan: the LAST minimum in alist order gets min2
    last_rank = jnp.max(jnp.where(is_min, rank, -1), axis=2, keepdims=True)
    takes_min2 = is_min & (rank == last_rank)
    sprod = jnp.prod(jnp.where(valid, sgn_pos(v2c_cn), jnp.ones((), dtype)),
                     axis=2, keepdims=True)
    mag = jnp.where(takes_min2, min2, min1)
    out = sprod * mag * sgn_pos(v2c_cn)
    if variant == "normalized":
        out = out / alpha
    elif variant == "offset":
        m2 = jnp.abs(out) - delta
        out = jnp.where(m2 > 0, sgn_pos(out) * m2, jnp.zeros_like(out))
    return jnp.where(valid, out, jnp.zeros((), dtype))


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_iterations",
        "variant",
        "early_termination",
        "storage_dtype",
    ),
)
def decode_minsum_stratified(
    sc: StratifiedCode,
    y: jax.Array,
    num_iterations: int,
    variant: str = "plain",
    alpha: float = 1.0,
    delta: float = 0.0,
    early_termination: bool = False,
    storage_dtype=None,
) -> DecodeResult:
    """Batched flooding min-sum on a stratified code.  y: [B, N].

    Same flags and semantics as :func:`..decoders.minsum.decode_minsum`
    (variant/alpha/delta per decodeMinSum.cpp's three binaries; optional
    f16 message storage with f32 arithmetic).
    """
    if variant not in ("plain", "normalized", "offset"):
        raise ValueError(f"unknown min-sum variant {variant!r}")
    y_t = jnp.asarray(y).T  # [N, B]
    n, b = y_t.shape
    assert n == sc.n, (n, sc.n)
    sdt = storage_dtype if storage_dtype is not None else y_t.dtype

    # scatter columns into the padded group grid (one gather per decode)
    yg = stratified_grid(sc, y_t)

    v2c0 = stratified_init(sc, yg, sdt)
    step_y = stratified_minsum_step(sc, variant, alpha, delta,
                                    storage_dtype)

    d, iters, done = run_flooding_soft(
        yg, v2c0, lambda v2c: step_y(v2c, yg),
        lambda d: stratified_check_satisfied(sc, d),
        num_iterations, early_termination, b,
    )
    hard = jnp.take(d.reshape(sc.kg * sc.w, b), sc.pos_of_col, axis=0)
    return DecodeResult(hard=hard.T, iterations=iters, satisfied=done)


def stratified_grid(sc: StratifiedCode, y_t: jax.Array) -> jax.Array:
    """[N, B] column-ordered samples -> the padded [kg, w, B] group grid
    (one gather per decode; invalid cells are exact zeros)."""
    safe_slot = jnp.maximum(sc.col_slot, 0)
    yg = jnp.take(y_t, safe_slot.reshape(-1), axis=0).reshape(
        sc.kg, sc.w, y_t.shape[-1]
    )
    return jnp.where((sc.col_slot >= 0)[..., None], yg, 0.0)


def stratified_init(sc: StratifiedCode, yg: jax.Array, sdt) -> jax.Array:
    """Initial v2c planes: every valid slot starts at the channel sample
    (initializeSymMessages, decodeMinSum.cpp:364-370)."""
    vnv = sc.vn_valid[..., None]
    return jnp.where(
        vnv,
        jnp.broadcast_to(yg[None], (sc.mb,) + yg.shape),
        0.0,
    ).astype(sdt)


def stratified_minsum_step(sc: StratifiedCode, variant="plain", alpha=1.0,
                           delta=0.0, storage_dtype=None):
    """The :func:`decode_minsum_stratified` iteration as a pure function
    of (messages, channel grid): ``step(v2c, yg) -> (v2c', totals)``.
    Identical operations to the batch decoder (factored out for the
    streaming refill harness, exactly as minsum_qc.qc_minsum_step)."""
    vnv = sc.vn_valid[..., None]

    def step(v2c, yg):
        # the VN fold runs in the CHANNEL-GRID dtype, exactly like the
        # generic decoder's vn_update (bit-exact equivalence contract;
        # f16 grids fold in f16) — the stream adapter upcasts its pool
        # rows to f32 before this step, so both drivers agree
        v2c_cn = stratified_to_cn(sc, v2c)
        c2v_cn = _cn_minsum(sc, v2c_cn, variant, alpha, delta)
        c2v = stratified_to_vn(sc, c2v_cn).astype(yg.dtype)
        c2v = jnp.where(vnv, c2v, 0.0)
        # messages (strata) left-fold first, channel term last — the
        # generic decoder's exact grouping (minsum.vn_update)
        acc = c2v[0]
        for s in range(1, sc.mb):
            acc = acc + c2v[s]
        total = yg + acc
        sdt = storage_dtype if storage_dtype is not None else yg.dtype
        v2c_new = jnp.where(vnv, storage_cast(total[None] - c2v, sdt),
                            jnp.zeros((), sdt))
        return v2c_new, total

    return step
