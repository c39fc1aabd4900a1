"""Gather-free sum-product BP for stratified block-permutation codes.

Same arithmetic as :mod:`.bp` (hyperbolic-pair CN update with exact
extrinsic exclusion, ±MAXLLR VN clamp, ``decodeBP.cpp:353-409`` semantics)
with the VN<->CN edge movement on the one-hot matmul interleaver of
:mod:`..codes.stratified` — the universal fallback for unstructured
matrices that fail QC detection but admit a cheap row-coloring (the
``find()`` scan this retires: ``decodeMinSum.cpp:527-536``).

Unlike stratified min-sum (whose CN is reformulated order-independently
and stays bit-exact vs the generic decoder), the BP CN pair-fold here runs
in column-group slot order rather than alist slot order — the same
arithmetic reassociated, exactly as :func:`..decoders.bp.bp_cn_update`
itself reassociates the reference's O(dc²) per-output products.  Decisions
agree with the generic decoder except on ulp-level posterior near-ties
(statistical equivalence is tested; BER curves are identical).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..codes.stratified import StratifiedCode
from .base import DecodeResult, run_flooding_soft, sgn_pos, storage_cast
from .bp import MAXLLR, pair_excl_logmags
from .minsum_stratified import (
    stratified_check_satisfied,
    stratified_grid,
    stratified_init,
    stratified_to_cn,
    stratified_to_vn,
)

__all__ = ["decode_bp_stratified", "stratified_bp_step"]


def stratified_bp_step(sc: StratifiedCode, max_llr: float = MAXLLR,
                       storage_dtype=None):
    """The :func:`decode_bp_stratified` iteration as a pure function of
    (messages, channel grid): ``step(v2c, yg) -> (v2c', totals)``.
    Identical operations to the batch decoder (factored for the
    streaming refill harness)."""
    vnv = sc.vn_valid[..., None]

    def step(v2c, yg):
        sdt = storage_dtype if storage_dtype is not None else yg.dtype
        v2c_cn = stratified_to_cn(sc, v2c)
        c2v_cn = _cn_bp(sc, v2c_cn)
        c2v = stratified_to_vn(sc, c2v_cn)  # f32 out of the einsum
        c2v = jnp.where(vnv, c2v, 0.0)
        # messages (strata) left-fold first, channel term last (bp/minsum
        # VN grouping)
        acc = c2v[0]
        for s in range(1, sc.mb):
            acc = acc + c2v[s]
        total = yg.astype(c2v.dtype) + acc
        v2c_new = jnp.where(
            vnv,
            storage_cast(jnp.clip(total[None] - c2v, -max_llr, max_llr),
                         sdt),
            jnp.zeros((), sdt),
        )
        return v2c_new, total

    return step


def _cn_bp(sc: StratifiedCode, v2c_cn):
    """Hyperbolic-pair CN update over [mb, h, kg, B] slots; invalid slots
    present the fold neutrals (u = 0, sign +1) and emit exact zeros."""
    cdt = jnp.promote_types(v2c_cn.dtype, jnp.float32)
    x = v2c_cn.astype(cdt)
    valid = sc.cn_valid[..., None]
    u = jnp.where(valid, jnp.exp(-jnp.abs(x)), jnp.zeros_like(x))
    sign = jnp.where(valid, sgn_pos(x), jnp.ones_like(x))

    kg = sc.kg
    mags = pair_excl_logmags([u[:, :, g] for g in range(kg)])
    ones = jnp.ones_like(u[:, :, 0])
    pre_s = [ones]
    for g in range(kg - 1):
        pre_s.append(pre_s[-1] * sign[:, :, g])
    suf_s = [ones]
    for g in range(kg - 1, 0, -1):
        suf_s.append(suf_s[-1] * sign[:, :, g])
    suf_s.reverse()
    out = jnp.stack(
        [pre_s[g] * suf_s[g] * mags[g] for g in range(kg)], axis=2
    )
    return jnp.where(valid, out, jnp.zeros_like(out))


@functools.partial(
    jax.jit,
    static_argnames=("num_iterations", "early_termination", "storage_dtype"),
)
def decode_bp_stratified(
    sc: StratifiedCode,
    llr: jax.Array,
    num_iterations: int,
    max_llr: float = MAXLLR,
    early_termination: bool = False,
    storage_dtype=None,
) -> DecodeResult:
    """Batched flooding sum-product on a stratified code.  llr: [B, N].

    Same flags as :func:`..decoders.bp.decode_bp` (input clamp, optional
    f16 message storage with f32 arithmetic).
    """
    llr_t = jnp.clip(jnp.asarray(llr).T, -max_llr, max_llr)  # [N, B]
    n, b = llr_t.shape
    assert n == sc.n, (n, sc.n)
    sdt = storage_dtype if storage_dtype is not None else llr_t.dtype

    yg = stratified_grid(sc, llr_t)
    v2c0 = stratified_init(sc, yg, sdt)
    step_y = stratified_bp_step(sc, max_llr, storage_dtype)

    d, iters, done = run_flooding_soft(
        yg, v2c0, lambda v2c: step_y(v2c, yg),
        lambda d: stratified_check_satisfied(sc, d),
        num_iterations, early_termination, b,
    )
    hard = jnp.take(d.reshape(sc.kg * sc.w, b), sc.pos_of_col, axis=0)
    return DecodeResult(hard=hard.T, iterations=iters, satisfied=done)
