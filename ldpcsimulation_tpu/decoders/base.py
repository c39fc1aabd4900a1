"""Shared decoder machinery: layouts, sign conventions, syndrome checks.

Layout convention
-----------------
All decoders are *batched over frames with the batch on the last axis*:
channel samples enter as ``[B, N]`` (user-facing) and are transposed to
``[N, B]`` internally, so that every Tanner-graph gather moves contiguous
batch vectors (B is the last, contiguous dimension).  Messages live in
flat padded slot arrays:

  * v2c (variable→check) : ``[N * dv_max, B]`` in VN-slot order
  * c2v (check→variable) : ``[M * dc_max, B]`` in CN-slot order

and move between layouts with one static gather (``Code.cn_from_vn`` /
``Code.vn_from_cn``) instead of the reference's per-message linear ``find()``
(``C_implementations/src/decodeMinSum.cpp:527-536``).

Sign conventions (a documented bit-exactness trap, SURVEY §7):
  * BP / min-sum / DDBMP: ``sgn(0) = +1`` (``decodeBP.cpp:412-417``)
  * GDBF family / NGDBFhw: ``sgn(0) = -1`` (``decodeGDBF.cpp:495-501``)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..codes.code import Code

__all__ = [
    "DecodeResult",
    "sgn_pos",
    "sgn_neg",
    "storage_cast",
    "gather_cn",
    "gather_vn",
    "syndrome_from_hard",
    "check_satisfied",
    "run_flooding",
    "run_flooding_soft",
]


@dataclasses.dataclass
class DecodeResult:
    """Outcome of a batched decode.  A JAX pytree.

    hard:       [B, N] int32, bipolar ±1 decisions (reference's ``d``).
    iterations: [B] int32 — for early-terminating decoders, the loop index at
                which the frame's syndrome first checked out (the reference's
                ``it`` at ``break``); for fixed-trip decoders, T.
    satisfied:  [B] bool — all parity checks satisfied at exit.
    """

    hard: jax.Array
    iterations: jax.Array
    satisfied: jax.Array


jax.tree_util.register_dataclass(
    DecodeResult, data_fields=["hard", "iterations", "satisfied"], meta_fields=[]
)


def vma_like(x, ref):
    """Give ``x`` the varying-manual-axes (vma) type of ``ref`` without
    changing its value.

    Under ``shard_map(..., check_vma=True)`` a ``while_loop``/``fori_loop``
    carry init built from constants (``jnp.zeros``/``full``) is
    mesh-constant, but the body's masked updates make the output
    data-varying — a type mismatch.  Adding a varying zero derived from a
    per-device input fixes the type axis-name-agnostically; outside a mesh
    it is a no-op the compiler folds away.
    """
    z = ref.astype(jnp.int32).ravel()[0] * 0
    if x.dtype == jnp.bool_:
        return x | (z != 0)
    return x + z.astype(x.dtype)


def storage_cast(x, sdt):
    """Cast messages to the storage dtype, SATURATING at its finite range.

    min-sum magnitudes grow roughly ×(dv+1) per iteration (each total sums
    dv check messages plus the channel), so deep runs on high-degree codes
    (802.3an: dv=6, T=10) exceed float16's 65504 and a plain ``astype``
    produces ``inf``.  Gather-based decoders shrug that off (the CN min
    recovers a finite magnitude), but the matmul interleavers multiply
    messages by structural zeros — ``0 * inf = NaN`` — and one NaN poisons
    the whole einsum block, sign-inverting entire frames.  Saturating the
    store keeps every storage mode NaN-free and keeps the gather and
    matmul decoders bit-identical at all operating points.  No-op for f32.
    """
    if jnp.issubdtype(sdt, jnp.floating):
        info = jnp.finfo(sdt)
        if info.bits < 32:
            m = jnp.asarray(info.max, x.dtype)
            x = jnp.clip(x, -m, m)
    return x.astype(sdt)


def sgn_pos(x):
    """sgn(0) = +1 convention (BP/min-sum/DDBMP)."""
    return jnp.where(x >= 0, 1.0, -1.0).astype(x.dtype)


def sgn_neg(x):
    """sgn(0) = -1 convention (GDBF family)."""
    return jnp.where(x > 0, 1.0, -1.0).astype(x.dtype)


def gather_cn(code: Code, v2c_flat: jax.Array) -> jax.Array:
    """[N*dv_max, B] v2c -> [M, dc_max, B] per-check incoming messages."""
    g = jnp.take(v2c_flat, code.cn_from_vn.reshape(-1), axis=0)
    return g.reshape(code.m, code.dc_max, -1)


def gather_vn(code: Code, c2v_flat: jax.Array) -> jax.Array:
    """[M*dc_max, B] c2v -> [N, dv_max, B] per-variable incoming messages."""
    g = jnp.take(c2v_flat, code.vn_from_cn.reshape(-1), axis=0)
    return g.reshape(code.n, code.dv_max, -1)


def syndrome_from_hard(code: Code, d: jax.Array) -> jax.Array:
    """Bipolar syndrome per check from hard decisions.

    d: [N, B] ±1.  Returns [M, B] with +1 = satisfied, -1 = unsatisfied
    (the reference's bipolar product, ``decodeGDBF.cpp:517-534``).
    Padding slots contribute +1.
    """
    vals = jnp.take(d, code.cn_vn.reshape(-1), axis=0).reshape(
        code.m, code.dc_max, -1
    )
    vals = jnp.where(code.cn_mask[:, :, None], vals, jnp.ones_like(vals))
    return jnp.prod(vals, axis=1)


def check_satisfied(code: Code, d: jax.Array) -> jax.Array:
    """[B] bool: all parity checks satisfied for each frame."""
    return jnp.all(syndrome_from_hard(code, d) > 0, axis=0)


def _mask_last(act: jax.Array, new, old):
    """Per-leaf masked update with the batch on the LAST axis of every
    leaf: frozen frames keep their old state."""
    return jax.tree.map(
        lambda n, o: jnp.where(
            act.reshape((1,) * (n.ndim - 1) + (-1,)), n, o
        ),
        new,
        old,
    )


def run_flooding(
    state0,
    step,
    decide,
    satisfied_of,
    num_iterations: int,
    early_termination: bool,
    batch: int,
):
    """Shared flooding-iteration driver used by the message-passing decoders.

    state0: pytree of arrays with the batch on the LAST axis of every leaf.
    step(state) -> state'            — one full decoder iteration.
    decide(state) -> d               — hard decisions (batch last).
    satisfied_of(d) -> [B] bool      — all-checks-satisfied per frame.

    Without early termination (the reference BP/min-sum semantics,
    ``decodeBP.cpp:206-213``): run exactly T iterations; ``iterations`` is
    T for every frame and ``satisfied`` reflects the final state.

    With early termination: a per-frame masked ``lax.while_loop`` — the
    loop exits when every frame's syndrome passes (or at T), frozen frames
    keep the first satisfying DECISION, and ``iterations`` counts the
    update rounds each frame actually used.  Only the decision carry is
    masked: frames are independent along the batch and the state is
    consumed solely through ``decide``, so a satisfied frame's state may
    keep evolving harmlessly — masking it cost a full state read+write
    per iteration (same finding as run_flooding_soft / decode_nb_qspa).

    Returns (d, iterations [B] int32, satisfied [B] bool).
    """
    if not early_termination:
        def body(_, st):
            return step(st)

        state = jax.lax.fori_loop(0, num_iterations, body, state0)
        d = decide(state)
        return (
            d,
            jnp.full((batch,), num_iterations, jnp.int32),
            satisfied_of(d),
        )

    d0 = decide(state0)
    done0 = satisfied_of(d0)

    def cond(carry):
        t, _st, _d, _iters, done = carry
        return (t < num_iterations) & ~jnp.all(done)

    def body(carry):
        t, st, d, iters, done = carry
        st = step(st)
        d_new = decide(st)
        act = ~done
        d = _mask_last(act, d_new, d)
        iters = jnp.where(act, t + 1, iters)
        done = done | satisfied_of(d)
        return (t + 1, st, d, iters, done)

    # Derive the iteration-count init from done0 (not fresh zeros) so its
    # varying-manual-axes type matches the body output under shard_map's
    # check_vma — the body's masked update makes it data-varying.
    iters0 = done0.astype(jnp.int32) * 0
    _t, _st, d, iters, done = jax.lax.while_loop(
        cond,
        body,
        (jnp.int32(0), state0, d0, iters0, done0),
    )
    return d, iters, done


def run_flooding_soft(
    total0,
    msgs0,
    step,
    satisfied_of,
    num_iterations: int,
    early_termination: bool,
    batch: int,
):
    """Flooding driver for soft decoders whose hard decisions are the sign
    of a posterior total that ``step`` computes anyway (BP / min-sum and
    their QC/stratified forms).

    step(msgs) -> (msgs', total)  — one full iteration.
    total0: the pre-iteration posterior (the channel term), in the same
    layout as step's total; supplies decisions when T == 0 and the
    early-termination initial state.
    satisfied_of(d) -> [B] bool, with d in total's layout.

    Fixed-trip (the reference BP/min-sum semantics): the loop carries ONLY
    the messages — the decisions of iterations 1..T-1 are dead values, and
    carrying them costs a posterior-sized store per iteration (measured
    ~8% of the flagship iteration time).  The T-th iteration runs outside
    the loop so its total feeds the decision directly.

    Early termination: a masked while_loop that freezes ONLY the decision
    carry (int8: values are ±1, 4x less traffic than int32).  Frames are
    independent along the batch, so the message state of a satisfied frame
    may keep evolving — its latched ``d`` is what the decoder returns —
    and NOT masking the message leaf saves a full message-state read+write
    per iteration.

    Returns (d int32 in total's layout, iterations [B] i32, done [B] bool).
    """
    def d_of(total, dt):
        return jnp.where(total > 0, 1, -1).astype(dt)

    if not early_termination:
        if num_iterations <= 0:
            d = d_of(total0, jnp.int32)
        else:
            msgs = jax.lax.fori_loop(
                0, num_iterations - 1, lambda _, m: step(m)[0], msgs0
            )
            _, total = step(msgs)
            d = d_of(total, jnp.int32)
        return (
            d,
            jnp.full((batch,), num_iterations, jnp.int32),
            satisfied_of(d),
        )

    d0 = d_of(total0, jnp.int8)
    done0 = satisfied_of(d0)
    iters0 = done0.astype(jnp.int32) * 0  # vma-typed like the body output

    def cond(carry):
        t, _msgs, _d, _iters, done = carry
        return (t < num_iterations) & ~jnp.all(done)

    def body(carry):
        t, msgs, d, iters, done = carry
        msgs_new, total = step(msgs)
        act = ~done
        d = _mask_last(act, d_of(total, jnp.int8), d)
        iters = jnp.where(act, t + 1, iters)
        done = done | satisfied_of(d)
        return (t + 1, msgs_new, d, iters, done)

    _t, _msgs, d, iters, done = jax.lax.while_loop(
        cond, body, (jnp.int32(0), msgs0, d0, iters0, done0)
    )
    return d.astype(jnp.int32), iters, done
