"""Streaming early-termination harness: continuous refill of converged lanes.

The batched masked ``lax.while_loop`` ET driver
(:func:`..decoders.base.run_flooding_soft`) pays a *straggler tax*: the whole
batch iterates until its slowest frame converges, so at 2 dB the flagship
geometry executes ~28 iterations per lane against a 10.4 average — roughly
half the iterations decode already-satisfied frames.

This driver removes the tax by keeping a persistent ``lanes``-wide decode
state on device.  Every ``refill_every`` iterations, lanes whose frame has
converged (or hit the iteration cap) are *retired* into on-device counters
and *refilled* with fresh frames from a pre-generated channel pool, so the
device always decodes active work.  Per-frame statistics are bit-identical
to the batched harness (tests/test_stream.py asserts per-frame equality):

  * Each frame's channel row is a pure function of ``(seed, frame index)``
    — the same counter-based replayability contract as
    :func:`.montecarlo.simulate` (replacing the reference's GSL state
    snapshots, ``newstat.cpp:783-791``).
  * The decoders here are deterministic and frames are independent along
    the batch, so a frame's trajectory does not depend on *when* it is
    scheduled into a lane — only scheduling changes, never results.
  * The iteration count keeps the reference's definition (syndrome checked
    before the first update — a frame satisfied at injection reports 0
    iterations; ``decodeGDBF.cpp:300-306`` semantics, exactly as in
    ``run_flooding_soft``), and capped frames run exactly T updates.

The per-iteration machinery mirrors ``run_flooding_soft``'s measured policy:
only the int8 decision carry is masked; a satisfied frame's message state
evolves freely until its lane is refilled.

Scope: deterministic decoders (min-sum variants and BP — generic
slot-array, QC, stratified-fallback, and row-LAYERED QC paths (one
stream iteration = one full layer sweep) —, DD-BMP on the QC path,
non-binary QSPA); the GDBF family streams through :mod:`.stream_gdbf`
(per-(frame, step) noise keying) and the fixed-point NGDBFhw through
:mod:`.stream_ngdbfhw` (per-frame noise rings, shared-slice pointer).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.code import Code
from ..codes.qc import QCCode
from .montecarlo import MCStats, StopRule, default_min_word_errors

__all__ = [
    "StreamDecoder",
    "minsum_qc_stream",
    "bp_qc_stream",
    "minsum_stream",
    "minsum_stratified_stream",
    "bp_stratified_stream",
    "minsum_layered_qc_stream",
    "bp_layered_qc_stream",
    "ddbmp_qc_stream",
    "stream_init",
    "pool_policy",
    "DEFAULT_POOL_BYTES",
    "make_stream_call",
    "build_channel_pool",
    "run_drain",
    "simulate_stream",
]


@dataclasses.dataclass(frozen=True)
class StreamDecoder:
    """A decoder exposed at iteration granularity for the stream driver.

    All callables operate in the decoder's internal layout with the batch
    on the LAST axis (see decoders/base.py).

    prep(rows [B, R]) -> ych        — channel term in decoder layout; for
                                      soft decoders ych IS the iteration-0
                                      posterior.  R = per-frame pool row
                                      width (N for binary decoders).
    init(ych) -> msgs               — initial message pytree.
    step(msgs, ych) -> (msgs, total)
    satisfied(d) -> [B] bool        — all parity checks pass.
    hard(d) -> [N, B]               — decisions in bit order (binary).

    Optional hooks (non-binary decoders):
    d_of(total) -> d                — decisions from the step total
                                      (default: int8 sign, binary ±1).
    errs_of(d) -> [B] int32         — primary error metric per frame
                                      (default: ``hard(d) != +1`` count;
                                      NB: bit errors of the symbols).
    errs2_of(d) -> [B] int32        — optional secondary counter
                                      (NB: symbol errors).

    Iteration-count conventions (DD-BMP differs from the soft decoders,
    ``decodeDDBMP.cpp:202-204`` vs ``decodeGDBF.cpp:300-306``):
    check_at_injection=False        — do NOT retire channel-satisfied
                                      frames at 0 iterations; the decoder
                                      always runs >=1 update round before
                                      its first syndrome check.
    break_index=True                — report the 0-based break index
                                      (updates executed minus one) for
                                      satisfied frames; capped frames
                                      still report T.
    """

    prep: Callable
    init: Callable
    step: Callable
    satisfied: Callable
    hard: Callable
    d_of: Optional[Callable] = None
    errs_of: Optional[Callable] = None
    errs2_of: Optional[Callable] = None
    check_at_injection: bool = True
    break_index: bool = False
    #: optional lazy-init step: ``step_fresh(msgs, ych, fresh) ->
    #: (msgs, total)`` applies the fresh-lane re-initialization select at
    #: each READ SITE inside the step instead of the driver's array-level
    #: ``_merge(fresh, init(ych), msgs)`` — worth it for decoders with
    #: heavy message state (DD-BMP's 4-slot f32 accumulators: the merge
    #: measured ~1.0 ms/iter at 4096 lanes).  Must be value-identical to
    #: merging first.
    step_fresh: Optional[Callable] = None
    #: optional pool-build front-end: ``prep_raw(raw_rows) -> pool_rows``
    #: maps raw channel samples to PRE-PREPPED pool rows once per frame
    #: at pool build, making ``prep`` a cheap relayout at the boundary
    #: (NB-QSPA: symbol priors + log ran per boundary otherwise).
    prep_raw: Optional[Callable] = None


def minsum_qc_stream(
    qc: QCCode,
    variant: str = "plain",
    alpha: float = 1.0,
    delta: float = 0.0,
    storage_dtype=None,
) -> StreamDecoder:
    """Stream adapter for :func:`..decoders.minsum_qc.decode_minsum_qc`
    (same step function object — bit-identical arithmetic)."""
    from ..decoders.minsum_qc import (
        qc_check_satisfied,
        qc_minsum_step,
    )

    from ..decoders.minsum_qc import qc_ragged_init

    def prep(rows):
        return rows.T.reshape(qc.nb, qc.z, -1)

    def init(ych):
        sdt = storage_dtype if storage_dtype is not None else ych.dtype
        return qc_ragged_init(qc, ych, sdt)

    return StreamDecoder(
        prep=prep,
        init=init,
        step=_upcast_step(
            qc_minsum_step(qc, variant, alpha, delta, storage_dtype)
        ),
        satisfied=lambda d: qc_check_satisfied(qc, d),
        hard=lambda d: d.reshape(qc.n, -1),
    )


def bp_qc_stream(
    qc: QCCode, max_llr: Optional[float] = None, storage_dtype=None
) -> StreamDecoder:
    """Stream adapter for :func:`..decoders.bp_qc.decode_bp_qc`.  Pool rows
    must be LLRs (``preprocess=llr_from_channel`` in
    :func:`simulate_stream`); ``prep`` applies the same ±max_llr input
    clamp as the batch decoder."""
    from ..decoders.bp import MAXLLR
    from ..decoders.bp_qc import qc_bp_step
    from ..decoders.minsum_qc import qc_check_satisfied

    ml = MAXLLR if max_llr is None else max_llr

    from ..decoders.minsum_qc import qc_ragged_init

    def prep(rows):
        return jnp.clip(rows.T, -ml, ml).reshape(qc.nb, qc.z, -1)

    def init(ych):
        sdt = storage_dtype if storage_dtype is not None else ych.dtype
        return qc_ragged_init(qc, ych, sdt)

    return StreamDecoder(
        prep=prep,
        init=init,
        step=_upcast_step(qc_bp_step(qc, ml, storage_dtype)),
        satisfied=lambda d: qc_check_satisfied(qc, d),
        hard=lambda d: d.reshape(qc.n, -1),
    )


def minsum_stream(
    code: Code,
    variant: str = "plain",
    alpha: float = 1.0,
    delta: float = 0.0,
    storage_dtype=None,
) -> StreamDecoder:
    """Stream adapter for the generic slot-array
    :func:`..decoders.minsum.decode_minsum`."""
    from ..decoders.base import check_satisfied
    from ..decoders.minsum import minsum_step

    def prep(rows):
        return rows.T

    def init(ych):
        sdt = storage_dtype if storage_dtype is not None else ych.dtype
        return jnp.repeat(ych, code.dv_max, axis=0).astype(sdt)

    return StreamDecoder(
        prep=prep,
        init=init,
        step=_upcast_step(
            minsum_step(code, variant, alpha, delta, storage_dtype)
        ),
        satisfied=lambda d: check_satisfied(code, d),
        hard=lambda d: d,
    )


def minsum_stratified_stream(
    sc,
    variant: str = "plain",
    alpha: float = 1.0,
    delta: float = 0.0,
    storage_dtype=None,
) -> StreamDecoder:
    """Stream adapter for
    :func:`..decoders.minsum_stratified.decode_minsum_stratified` (same
    step function object — bit-identical arithmetic).  This is the
    universal unstructured-alist fallback's stream path: codes that fail
    QC detection but color into strata keep `--stream` too."""
    from ..decoders.minsum_stratified import (
        stratified_check_satisfied,
        stratified_grid,
        stratified_init,
        stratified_minsum_step,
    )

    def prep(rows):
        return stratified_grid(sc, rows.T)

    def init(ych):
        sdt = storage_dtype if storage_dtype is not None else ych.dtype
        return stratified_init(sc, ych, sdt)

    def hard(d):
        return jnp.take(
            d.reshape(sc.kg * sc.w, d.shape[-1]), sc.pos_of_col, axis=0
        )

    return StreamDecoder(
        prep=prep,
        init=init,
        step=_upcast_step(
            stratified_minsum_step(sc, variant, alpha, delta,
                                   storage_dtype)
        ),
        satisfied=lambda d: stratified_check_satisfied(sc, d),
        hard=hard,
    )


def bp_stratified_stream(
    sc, max_llr: Optional[float] = None, storage_dtype=None
) -> StreamDecoder:
    """Stream adapter for
    :func:`..decoders.bp_stratified.decode_bp_stratified`.  Pool rows
    must be LLRs; ``prep`` applies the batch decoder's ±max_llr clamp
    before gathering into the group grid."""
    from ..decoders.bp import MAXLLR
    from ..decoders.bp_stratified import stratified_bp_step
    from ..decoders.minsum_stratified import (
        stratified_check_satisfied,
        stratified_grid,
        stratified_init,
    )

    ml = MAXLLR if max_llr is None else max_llr

    def prep(rows):
        return stratified_grid(sc, jnp.clip(rows.T, -ml, ml))

    def init(ych):
        sdt = storage_dtype if storage_dtype is not None else ych.dtype
        return stratified_init(sc, ych, sdt)

    def hard(d):
        return jnp.take(
            d.reshape(sc.kg * sc.w, d.shape[-1]), sc.pos_of_col, axis=0
        )

    return StreamDecoder(
        prep=prep,
        init=init,
        step=_upcast_step(stratified_bp_step(sc, ml, storage_dtype)),
        satisfied=lambda d: stratified_check_satisfied(sc, d),
        hard=hard,
    )


def _layered_stream(qc: QCCode, step, storage_dtype) -> StreamDecoder:
    """Shared layered-adapter construction: one stream iteration = one
    full layer sweep of the given factored step object, so the iteration
    count keeps the batched layered decoders' definition.  The layered
    state is (posterior tuple q, per-layer stored messages L); the
    channel term lives inside q, so refill re-initialization is
    q := ych, L := 0 (at ``storage_dtype``, or the compute dtype when
    None) and the step ignores ych.  An f16 pool's rows are upcast
    exactly at init — the posterior is carried at f32 like the batch
    decoders'."""
    from ..decoders.minsum_layered import layered_l0
    from ..decoders.minsum_qc import qc_check_satisfied

    def prep(rows):
        return rows.T.reshape(qc.nb, qc.z, -1)

    def init(ych):
        dt = jnp.promote_types(ych.dtype, jnp.float32)
        q = tuple(ych.astype(dt))
        sdt = storage_dtype if storage_dtype is not None else dt
        return (q, layered_l0(qc, ych.shape[-1], sdt, q[0]))

    return StreamDecoder(
        prep=prep,
        init=init,
        step=lambda qL, ych: step(qL),
        satisfied=lambda d: qc_check_satisfied(qc, d),
        hard=lambda d: d.reshape(qc.n, -1),
    )


def minsum_layered_qc_stream(
    qc: QCCode,
    variant: str = "plain",
    alpha: float = 1.0,
    delta: float = 0.0,
    storage_dtype=None,
) -> StreamDecoder:
    """Stream adapter for
    :func:`..decoders.minsum_layered.decode_minsum_layered_qc` (same
    step function object — bit-identical arithmetic); see
    :func:`_layered_stream`."""
    from ..decoders.minsum_layered import qc_minsum_layered_step

    return _layered_stream(
        qc,
        qc_minsum_layered_step(qc, variant, alpha, delta, storage_dtype),
        storage_dtype,
    )


def bp_layered_qc_stream(
    qc: QCCode, max_llr: Optional[float] = None
) -> StreamDecoder:
    """Stream adapter for
    :func:`..decoders.bp_layered.decode_bp_layered_qc` (same step
    function object — bit-identical arithmetic); see
    :func:`_layered_stream`.  Pool rows must be LLRs
    (``preprocess=llr_from_channel``); the batch decoder carries the
    UNclamped posterior (clamping only check-node input copies), so the
    prep applies no clamp.  BP's stored L rides the compute dtype (the
    batch decoder has no narrow-storage mode)."""
    from ..decoders.bp import MAXLLR
    from ..decoders.bp_layered import qc_bp_layered_step

    ml = MAXLLR if max_llr is None else max_llr
    return _layered_stream(qc, qc_bp_layered_step(qc, ml), None)


def ddbmp_qc_stream(qc: QCCode) -> StreamDecoder:
    """Stream adapter for :func:`..decoders.ddbmp.decode_ddbmp_qc` (same
    round function object — bit-identical arithmetic).  DD-BMP is
    deterministic, so it streams like the soft decoders; only its
    iteration-count conventions differ (``check_at_injection=False``,
    ``break_index=True`` — the batched decoder never checks the channel
    decisions and reports the 0-based break index,
    ``decodeDDBMP.cpp:202-204``).  Pool rows must be pre-quantized
    (``preprocess=quantize_no_zero`` as in the sweep)."""
    from ..decoders.ddbmp import qc_ddbmp_round
    from ..decoders.minsum_qc import qc_check_satisfied, qc_slot_plan

    cn_plan, vn_plan = qc_slot_plan(qc)

    def prep(rows):
        return rows.T.reshape(qc.nb, qc.z, -1)

    def init(ych):
        dt = jnp.promote_types(ych.dtype, jnp.float32)
        shape = (qc.nb, qc.dv_max) + ych.shape[1:]
        return jnp.broadcast_to(ych[:, None], shape).astype(dt)

    def step_fresh(mem, yb, fresh):
        # lazy re-initialization: the fresh-lane select runs at each
        # memory read site inside the shared round (see qc_ddbmp_round)
        # instead of materializing the merged 4-slot f32 state
        yf = yb.astype(jnp.promote_types(yb.dtype, jnp.float32))
        return qc_ddbmp_round(qc, cn_plan, vn_plan, mem, yf, fresh=fresh)

    return StreamDecoder(
        prep=prep,
        init=init,
        step=_upcast_step(
            lambda mem, yb: qc_ddbmp_round(qc, cn_plan, vn_plan, mem, yb)
        ),
        step_fresh=step_fresh,
        satisfied=lambda d: qc_check_satisfied(qc, d),
        hard=lambda d: d.reshape(qc.n, -1),
        # the round emits int8 ±1 decision planes (see qc_ddbmp_round);
        # keep the lane carry at int8 too (the latch merge + syndrome
        # move these planes every iterate)
        d_of=lambda t: jnp.asarray(t).astype(jnp.int8),
        check_at_injection=False,
        break_index=True,
    )


def _upcast_step(step):
    """Wrap a step so a reduced-precision (f16 pool) channel term is
    consumed at float32 — the conversion is exact and XLA fuses it into
    the term's consumers, so storing ych narrow halves its HBM traffic
    without touching arithmetic."""

    def wrapped(msgs, ych):
        return step(msgs, ych.astype(jnp.promote_types(ych.dtype,
                                                       jnp.float32)))

    return wrapped


def _sign8(x):
    """Posterior sign decision as int8 (±1), the sgn(0) = -1 form shared
    with run_flooding_soft's ``d_of`` (total > 0)."""
    return jnp.where(x > 0, 1, -1).astype(jnp.int8)


def _merge(mask_b, new, old):
    """Per-leaf select with a [B] mask broadcast over leading axes (batch
    rides last everywhere)."""
    return jax.tree.map(
        lambda nw, od: jnp.where(
            mask_b.reshape((1,) * (nw.ndim - 1) + (-1,)), nw, od
        ),
        new,
        old,
    )


def stream_init(dec: StreamDecoder, lanes: int, n: int, dtype=jnp.float32):
    """All-idle initial lane state: the first boundary of the first call
    fills every lane from the pool.  ``n`` is the pool row width (N for
    binary decoders); ``dtype`` must match the pool row dtype
    (``pool_dtype`` if set) so the carried ych keeps its layout."""
    rows = jnp.zeros((lanes, n), dtype)
    ych = dec.prep(rows)
    d_of = dec.d_of or _sign8
    return dict(
        msgs=dec.init(ych),
        fresh=jnp.zeros((lanes,), bool),
        ych=ych,
        d=d_of(ych),
        done=jnp.ones((lanes,), bool),
        idle=jnp.ones((lanes,), bool),
        iters=jnp.zeros((lanes,), jnp.int32),
        unc=jnp.zeros((lanes,), jnp.int32),
        gid=jnp.full((lanes,), -1, jnp.int32),
    )


def make_stream_call(
    dec: StreamDecoder,
    n: int,
    num_iterations: int,
    rounds: int,
    refill_every: int = 1,
    record: bool = False,
    rec_cap: int = 0,
    max_weight: Optional[int] = None,
    mesh=None,
    data_axis: str = "data",
):
    """Build the jitted persistent-state call.

    call(state, pool, pool_unc, pool_sat0, base) ->
        (state', acc, rec) — runs ``rounds`` boundary+iterate cycles
    (``rounds * refill_every`` decoder iterations).  ``state`` is donated.

    acc: on-device int32 counters/histograms for frames retired during the
    call (a frame is retired exactly once, at the first boundary after it
    converges or caps).  ``acc['consumed']`` = pool rows consumed; the
    caller advances its global frame counter by it — unconsumed rows are
    regenerated verbatim next call (pure function of frame index).

    With ``record=True``, per-retired-frame (gid, iters, errs) triples are
    scattered into ``rec`` arrays in retire order (first ``acc['rc']``
    entries valid, capacity ``rec_cap``; the extra trailing slot absorbs
    masked writes) — the hook the per-frame equality tests use.

    With ``mesh``, the call runs under ``jax.shard_map`` over the mesh's
    ``data_axis``: lanes and the pool shard across devices (batch is the
    LAST axis of every state leaf, pool rows the first), each device
    consumes its own gid window ``base + axis_index·F_local + k`` (frame
    channels stay pure functions of (seed, gid) — replayable), and the
    counters/histograms psum into replicated outputs.  This is the
    streaming replacement for the reference's per-process fan-out
    (SURVEY §2.6): one program, N devices, collectives between them.  In
    record mode rec leaves concatenate per device with a ``rc_local``
    leaf giving each device's valid count.  Drain semantics are per
    device (``ptr0`` = the LOCAL pool length).

    Counter width: int32 — safe while frames-per-call × n < 2**31 (a pool
    would not fit in HBM long before that bound matters).
    """
    T = num_iterations
    K = refill_every
    mw = n if max_weight is None else max_weight
    d_of = dec.d_of or _sign8

    def boundary(st, ptr, acc, rec, rc, pool, pool_unc, pool_sat0, base):
        d, done, idle, iters = st["d"], st["done"], st["idle"], st["iters"]
        if dec.errs_of is not None:
            errs = dec.errs_of(d)  # [B]
        else:
            hard = dec.hard(d)  # [N, B]
            errs = jnp.sum(hard != 1, axis=0, dtype=jnp.int32)  # [B]
        retire = (done | (iters >= T)) & ~idle
        if dec.break_index:
            # DD-BMP convention: satisfied frames report the 0-based
            # break index (updates executed minus one); capped report T
            iters = jnp.where(done, jnp.maximum(iters - 1, 0), iters)
        ri = retire.astype(jnp.int32)
        word = (errs > 0).astype(jnp.int32)
        acc = dict(
            acc,
            frames=acc["frames"] + jnp.sum(ri, dtype=jnp.int32),
            bit_errs=acc["bit_errs"] + jnp.sum(errs * ri, dtype=jnp.int32),
            word_errs=acc["word_errs"] + jnp.sum(ri * word, dtype=jnp.int32),
            iter_sum=acc["iter_sum"] + jnp.sum(iters * ri, dtype=jnp.int32),
            sat=acc["sat"] + jnp.sum(ri * done.astype(jnp.int32), dtype=jnp.int32),
            unc_sum=acc["unc_sum"] + jnp.sum(st["unc"] * ri, dtype=jnp.int32),
            iter_hist=acc["iter_hist"].at[jnp.clip(iters, 0, T)].add(ri),
            weight_hist=acc["weight_hist"]
            .at[jnp.clip(errs, 0, mw)]
            .add(ri * word),
        )
        if dec.errs2_of is not None:
            acc["errs2"] = acc["errs2"] + jnp.sum(
                dec.errs2_of(d) * ri, dtype=jnp.int32
            )
        if record:
            rrank = jnp.cumsum(ri, dtype=jnp.int32) - 1
            pos = rc + rrank
            valid = retire & (pos < rec_cap)
            p = jnp.where(valid, pos, rec_cap)
            rec = dict(
                gid=rec["gid"].at[p].set(st["gid"]),
                iters=rec["iters"].at[p].set(iters),
                errs=rec["errs"].at[p].set(errs),
            )
            rc = rc + jnp.sum(ri, dtype=jnp.int32)

        # refill retired + idle lanes from the pool, in lane order
        want = retire | idle
        ranks = jnp.cumsum(want, dtype=jnp.int32) - 1
        can = want & (ranks < pool.shape[0] - ptr)
        local = jnp.where(can, ptr + ranks, 0)
        rows = jnp.take(pool, local, axis=0)  # [B, R]
        ych_new = dec.prep(rows)
        st_new = dict(
            msgs=st["msgs"],  # re-initialized lazily at the next iterate
            fresh=can,
            ych=_merge(can, ych_new, st["ych"]),
            d=_merge(can, d_of(ych_new), st["d"]),
            done=jnp.where(can, jnp.take(pool_sat0, local), done)
            | (want & ~can),
            idle=want & ~can,
            iters=jnp.where(can, 0, iters),
            unc=jnp.where(can, jnp.take(pool_unc, local), st["unc"]),
            gid=jnp.where(can, base + ptr + ranks, st["gid"]),
        )
        ptr = ptr + jnp.sum(can, dtype=jnp.int32)
        return st_new, ptr, acc, rec, rc

    def iterate(st):
        # decision-only masking, as in run_flooding_soft: msgs always
        # advance; d/iters freeze once done (or capped).  Freshly refilled
        # lanes read init(ych) instead of their stale messages — selected
        # at the step INPUT so XLA fuses it into the first read instead of
        # materializing a full message-plane merge at the boundary (or at
        # each read site via the decoder's step_fresh hook).
        act = (~st["done"]) & (st["iters"] < T)
        if dec.step_fresh is not None:
            msgs, total = dec.step_fresh(
                st["msgs"], st["ych"], st["fresh"]
            )
        else:
            msgs_in = _merge(st["fresh"], dec.init(st["ych"]), st["msgs"])
            msgs, total = dec.step(msgs_in, st["ych"])
        d = _merge(act, d_of(total), st["d"])
        return dict(
            st,
            msgs=msgs,
            fresh=jnp.zeros_like(st["fresh"]),
            d=d,
            iters=st["iters"] + act.astype(jnp.int32),
            done=st["done"] | dec.satisfied(d),
        )

    def _impl(state, pool, pool_unc, pool_sat0, base, ptr0):
        # ptr0 pre-consumes the pool: ptr0 == pool size makes this a DRAIN
        # call (no refills; in-flight lanes retire into the counters then
        # idle).  Draining before reading final statistics removes the
        # drop bias of in-flight frames — they are enriched in slow/
        # failing frames, so discarding them skews FER low (measured ~9%
        # at GDBF T=100 geometries before the fix).
        from ..decoders.base import vma_like

        ref = state["iters"]
        ptr0 = vma_like(jnp.asarray(ptr0, jnp.int32), ref)
        # init carries derived from constants are vma-typed off a state
        # leaf (see decoders.base.vma_like): under shard_map the body's
        # masked updates make them data-varying, and while_loop requires
        # matching in/out types
        acc = dict(
            frames=jnp.int32(0),
            bit_errs=jnp.int32(0),
            word_errs=jnp.int32(0),
            iter_sum=jnp.int32(0),
            sat=jnp.int32(0),
            unc_sum=jnp.int32(0),
            iter_hist=jnp.zeros((T + 1,), jnp.int32),
            weight_hist=jnp.zeros((mw + 1,), jnp.int32),
        )
        if dec.errs2_of is not None:
            acc["errs2"] = jnp.int32(0)
        acc = jax.tree.map(lambda x: vma_like(x, ref), acc)
        rec = (
            dict(
                gid=jnp.full((rec_cap + 1,), -1, jnp.int32),
                iters=jnp.zeros((rec_cap + 1,), jnp.int32),
                errs=jnp.zeros((rec_cap + 1,), jnp.int32),
            )
            if record
            else None
        )
        rec = jax.tree.map(lambda x: vma_like(x, ref), rec)

        def round_cond(carry):
            r, st, *_ = carry
            # early exit once every lane is idle (pool exhausted and all
            # retired) — makes DRAIN calls cost ~T iterations instead of
            # the full rounds*K budget; never fires in normal calls
            return (r < rounds) & ((r == 0) | ~jnp.all(st["idle"]))

        def round_body(carry):
            r, st, ptr, acc, rec, rc = carry
            st, ptr, acc, rec, rc = boundary(
                st, ptr, acc, rec, rc, pool, pool_unc, pool_sat0, base
            )
            st = jax.lax.fori_loop(0, K, lambda _j, s: iterate(s), st)
            return r + 1, st, ptr, acc, rec, rc

        _r, st, ptr, acc, rec, rc = jax.lax.while_loop(
            round_cond,
            round_body,
            (
                jnp.int32(0), state, ptr0, acc, rec,
                vma_like(jnp.int32(0), ref),
            ),
        )
        acc = dict(acc, consumed=ptr - ptr0, rc=rc)
        return st, acc, rec

    if mesh is None:
        @functools.partial(jax.jit, donate_argnums=(0,))
        def call(state, pool, pool_unc, pool_sat0, base, ptr0=0):
            return _impl(state, pool, pool_unc, pool_sat0, base, ptr0)

        return call

    return _shard_call(
        _impl, mesh, data_axis, record, ("gid", "iters", "errs")
    )


def _shard_call(impl, mesh, data_axis, record, rec_fields):
    """Wrap a stream ``_impl`` in shard_map over the mesh's data axis.

    Lane state shards on its (last) batch axis, the pool on its (first)
    row axis; each device offsets its gid space by ``axis_index ×
    local_pool_len`` so frame ids never collide and stay pure functions
    of the index; counters psum into replicated outputs.  The jitted
    shard_map is cached per state tree-structure (specs depend on leaf
    ranks).  Extra positional args after ptr0 (the GDBF call's
    noise_root/sigma/cfg) are passed through replicated.
    """
    from jax.sharding import PartitionSpec as P

    def sharded(state, pool, pool_unc, pool_sat0, base, ptr0, *extra):
        di = jax.lax.axis_index(data_axis)
        local_base = base + di * pool.shape[0]
        st, acc, rec = impl(
            state, pool, pool_unc, pool_sat0, local_base, ptr0, *extra
        )
        if record:
            rec = dict(rec, rc_local=acc["rc"][None])
        acc = jax.tree.map(lambda v: jax.lax.psum(v, data_axis), acc)
        return st, acc, rec

    cache = {}

    def call(state, pool, pool_unc, pool_sat0, base, ptr0=0, *extra):
        sspec = jax.tree.map(_lane_spec(data_axis), state)
        key = (
            jax.tree.structure(sspec),
            jax.tree.structure(tuple(extra)),
        )
        if key not in cache:
            espec = jax.tree.map(lambda _x: P(), tuple(extra))
            in_specs = (
                sspec, P(data_axis), P(data_axis), P(data_axis), P(),
                P(), *espec,
            )
            rec_spec = (
                {f: P(data_axis) for f in rec_fields + ("rc_local",)}
                if record else None
            )
            f = jax.shard_map(
                sharded, mesh=mesh, in_specs=in_specs,
                out_specs=(sspec, P(), rec_spec),
            )
            cache[key] = jax.jit(f, donate_argnums=(0,))
        return cache[key](
            state, pool, pool_unc, pool_sat0,
            jnp.asarray(base, jnp.int32), jnp.asarray(ptr0, jnp.int32),
            *extra,
        )

    return call


def _lane_spec(data_axis):
    """Per-leaf PartitionSpec for lane state: batch is the LAST axis of
    every array leaf; scalar leaves (e.g. the NGDBFhw stream's global
    ring counter, which advances in lockstep on every device) are
    replicated."""
    from jax.sharding import PartitionSpec as P

    return lambda x: (
        P() if x.ndim == 0
        else P(*([None] * (x.ndim - 1) + [data_axis]))
    )


def mesh_setup(mesh, data_axis, lanes, pool_frames, default_pool, state):
    """Shared mesh plumbing for the simulate drivers: validate
    divisibility (rounding a DEFAULT-derived pool up to the axis size),
    shard the lane state, and return (nd, pool_frames, state,
    pool_out_shardings)."""
    from jax.sharding import NamedSharding

    nd = mesh.shape[data_axis]
    if default_pool:
        pool_frames = -(-pool_frames // nd) * nd  # round up to nd
    if lanes % nd or pool_frames % nd:
        raise ValueError(
            f"lanes ({lanes}) and pool_frames ({pool_frames}) must be "
            f"divisible by the {data_axis!r} axis size {nd}"
        )
    spec = _lane_spec(data_axis)
    state = jax.device_put(
        state,
        jax.tree.map(lambda x: NamedSharding(mesh, spec(x)), state),
    )
    from jax.sharding import PartitionSpec as P

    rows = NamedSharding(mesh, P(data_axis))
    return nd, pool_frames, state, (rows, rows, rows)


#: Default channel-pool byte budget (per simulate_stream* driver call).
#: Sized so the deep-FER geometries (lanes 16k, avg ~3 iterations) keep
#: long on-device calls: a smaller budget shrinks each call's iteration
#: count, and every call boundary costs a host round trip.  It was tuned
#: on the first target device (16 GB); re-tuning it for this one is open.
#: Override per run with ``pool_bytes=``.
DEFAULT_POOL_BYTES = 2**30


def pool_policy(
    lanes: int,
    refill_every: int,
    rounds_per_call,
    avg_iters_hint: float,
    row_bytes: int,
    pool_bytes=None,
    default_rounds: int = 64,
):
    """Derive ``(rounds_per_call, pool_frames)`` under a pool byte budget.

    The hint-based sizing wants ``lanes × iters_per_call / avg`` rows per
    call — at low average iterations (deep-FER operating points, avg ~3)
    that is GIGABYTES, and round 4 pushed a manual "cap rounds_per_call"
    workaround (docs/DESIGN.md).  This policy budgets pool BYTES instead:

      * ``rounds_per_call=None`` (auto): start from the driver's default
        round count and SHRINK it until the expected per-call consumption
        fits ``pool_bytes`` — smaller calls, same statistics (the counted
        frame set depends only on gid order + stop rule, never on call
        geometry; tests pin this).
      * explicit ``rounds_per_call``: honored; only the pool is capped
        (undersized pools idle lanes at the call tail — correct, slower).

    The pool is never sized below 2 lane widths (a refill boundary must
    be able to fill every lane), so the byte cap is best-effort at
    pathological budgets.  Returns (rounds_per_call, pool_frames).
    """
    if pool_bytes is None:
        pool_bytes = DEFAULT_POOL_BYTES
    auto = rounds_per_call is None
    r = default_rounds if auto else rounds_per_call
    hint = max(avg_iters_hint, 1.0)
    cap = max(2 * lanes, int(pool_bytes // max(row_bytes, 1)))
    want = lanes + int(lanes * r * refill_every / hint)
    if want > cap and auto:
        r = max(1, int((cap - lanes) * hint // (lanes * refill_every)))
        want = lanes + int(lanes * r * refill_every / hint)
    return r, min(want, cap)


# gid space is int32 (the pool index dtype).  Deep campaigns exhaust it —
# the round-4 deep-FER run alone consumed 1.7e9 of the 2.1e9 ids — so the
# drivers ROTATE the channel root key (fold_in) and reset base before an
# overflow: frames stay replayable from (seed, rotation, gid), and the
# rotated stream is iid fresh by the counter-based-RNG contract.
_GID_LIMIT = 2**31 - 1


def run_drain(call, state, pool_args, base, ptr0_local, take,
              num_steps, iters_per_call, extra=()):
    """Drain the in-flight lanes: repeat the compiled call with the pool
    pre-exhausted (``ptr0_local`` = local pool length) until every lane
    is idle, folding each call's counters through ``take``.

    The termination test is LANE IDLENESS, not zero retirements: a drain
    call whose iteration budget (rounds × refill_every) is below a
    lane's residual iterations retires nothing while work remains, so a
    ``frames == 0`` break would silently drop exactly the slow/failing
    frames the drain exists to count (round-4 review finding; the
    regression test pins a T >> budget drain).  The loop bound covers
    the worst case — every active lane progresses up to
    ``iters_per_call`` iterations per call, so ceil(T / iters_per_call)
    calls cap and retire everything.

    Shared by simulate_stream / simulate_stream_nb /
    simulate_stream_gdbf (``extra`` carries the GDBF call's
    noise_root/sigma/cfg, which precede ptr0 in its signature).
    """
    for _ in range(2 + num_steps // max(iters_per_call, 1)):
        if bool(jax.device_get(jnp.all(state["idle"]))):
            break
        state, acc, _rec = call(
            state, *pool_args, jnp.int32(base), *extra, ptr0_local
        )
        take(jax.device_get(acc))
    return state


def build_channel_pool(
    dec: StreamDecoder,
    root,
    base: int,
    pool_frames: int,
    n: int,
    sigma: float,
    preprocess=None,
    dtype=jnp.float32,
    pool_dtype=None,
):
    """[F, N] decoder-input rows for global frame ids base..base+F-1.

    Frame i's channel is a pure function of (root, i):
    ``y = 1 + sigma * normal(fold_in(root, i), [N])`` — the all-zero
    codeword, for which the reference's multiplicative and additive AWGN
    forms coincide (x = +1: ``x*(1+σn) == x+σn``, decodeBP.cpp:184 /
    LDPC_testbench.h:144-149).  ``preprocess`` maps raw samples to decoder
    input (LLR / quantizer), as in :func:`.montecarlo.simulate`.  The
    drivers run it compiled; replay a window the same way (``jax.jit``),
    since op-by-op evaluation rounds ``1 + sigma * n`` twice where the
    compiled program fuses it into one FMA.

    Returns (rows, uncoded [F] int32, sat0 [F] bool).  ``sat0`` is the
    iteration-0 syndrome of each frame, precomputed once here so lane
    refill needs no extra per-boundary syndrome pass.
    """
    gids = base + jnp.arange(pool_frames)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(root, gids)
    noise = jax.vmap(lambda kk: jax.random.normal(kk, (n,), dtype))(keys)
    y = (1.0 + sigma * noise).astype(dtype)
    # uncoded decision r = (y > 0 ? +1 : -1) vs c = +1 (montecarlo.simulate)
    unc = jnp.sum(y <= 0, axis=1, dtype=jnp.int32)
    rows = preprocess(y) if preprocess is not None else y
    if pool_dtype is not None:
        # reduced-precision pool (e.g. f16): the stored rows ARE the
        # channel realization the decoder sees (exactly upcast at the
        # step, _upcast_step) — halves pool memory, refill-gather and
        # ych traffic; statistically invisible (f16 channel rounding)
        rows = rows.astype(pool_dtype)
    if dec.check_at_injection:
        sat0 = dec.satisfied(_sign8(dec.prep(rows)))
    else:
        # DD-BMP convention: the batched decoder never checks the channel
        # decisions — every frame runs at least one update round
        sat0 = jnp.zeros((pool_frames,), bool)
    return rows, unc, sat0


def simulate_stream(
    code_n: int,
    dec: StreamDecoder,
    snr_db: float,
    rate: float,
    num_iterations: int,
    stop: Optional[StopRule] = None,
    lanes: int = 4096,
    refill_every: int = 1,
    rounds_per_call: Optional[int] = None,
    pool_frames: Optional[int] = None,
    avg_iters_hint: float = 8.0,
    seed: int = 0,
    preprocess=None,
    dtype=jnp.float32,
    pool_dtype=None,
    verbose: bool = False,
    max_calls: int = 100000,
    mesh=None,
    data_axis: str = "data",
    pool_bytes: Optional[int] = None,
) -> MCStats:
    """Monte-Carlo loop over the streaming driver (all-zero codewords).

    Same stopping semantics as :func:`.montecarlo.simulate`, evaluated
    between device calls.  After the stop rule fires, in-flight lanes are
    DRAINED (same compiled call with the pool pre-exhausted) so every
    injected frame is counted exactly once: a frame occupies a lane in
    proportion to its decode time, so in-flight frames are enriched in
    slow/failing frames and dropping them would bias FER low (measured
    ~9% at GDBF T=100 geometries).  With the drain, the counted set is an
    outcome-independent prefix of the (seed, index) frame sequence.

    ``pool_frames`` defaults to the expected per-call consumption
    (lanes × iterations / avg_iters_hint) + one lane width of slack,
    CAPPED at the ``pool_bytes`` budget (:func:`pool_policy`): with the
    default ``rounds_per_call=None`` the per-call round count shrinks to
    fit the budget (statistics are call-geometry-independent), with an
    explicit round count only the pool is capped; undersized pools just
    idle lanes at the call tail (correct, slower), oversized pools waste
    generation.

    ``mesh``: run the stream sharded over the mesh's ``data_axis``
    (``lanes`` and ``pool_frames`` are GLOBAL and must divide by the
    axis size).  Each device streams its own lanes against its own gid
    window of the pool; the per-call window advances by the full pool
    width, so a device's unconsumed gids are SKIPPED rather than reused
    — harmless (the skipped set depends only on aggregate consumption
    counts, never on an unexamined frame's own realization) and every
    counted frame remains replayable from (seed, gid).  Counters arrive
    psum-reduced; the stop rule sees global totals.
    """
    from ..channel.awgn import snr_to_sigma

    stop = stop or StopRule(min_word_errors=default_min_word_errors(code_n))
    sigma = float(snr_to_sigma(snr_db, rate))
    root = jax.random.key(seed)
    _default_pool = pool_frames is None
    row_bytes = code_n * jnp.dtype(pool_dtype or dtype).itemsize
    default_rounds = 64
    if pool_frames is None:
        rounds_per_call, pool_frames = pool_policy(
            lanes, refill_every, rounds_per_call, avg_iters_hint,
            row_bytes, pool_bytes, default_rounds=default_rounds,
        )
    elif rounds_per_call is None:
        rounds_per_call = default_rounds
    iters_per_call = rounds_per_call * refill_every
    state = stream_init(dec, lanes, code_n, pool_dtype or dtype)
    nd = 1
    pool_out = None
    if mesh is not None:
        nd, pool_frames, state, pool_out = mesh_setup(
            mesh, data_axis, lanes, pool_frames, _default_pool, state
        )
    call = make_stream_call(
        dec, code_n, num_iterations, rounds_per_call, refill_every,
        mesh=mesh, data_axis=data_axis,
    )

    def _pool_impl(base_, root_):
        # dec holds plain functions (not a pytree) — close over it
        return build_channel_pool(
            dec, root_, base_, pool_frames, code_n, sigma, preprocess,
            dtype, pool_dtype,
        )

    pool_fn = jax.jit(
        _pool_impl,
        **({} if pool_out is None else dict(out_shardings=pool_out)),
    )

    stats = MCStats(n=code_n)
    stats.iteration_hist = np.zeros(num_iterations + 1, np.int64)
    t0 = time.perf_counter()
    base = 0

    def take(a):
        stats.total_words += int(a["frames"])
        stats.total_bits += int(a["frames"]) * code_n
        stats.errors += int(a["bit_errs"])
        stats.word_errors += int(a["word_errs"])
        stats.total_iterations += int(a["iter_sum"])
        stats.satisfied_words += int(a["sat"])
        stats.uncoded_errors += int(a["unc_sum"])
        stats.iteration_hist += np.asarray(a["iter_hist"], np.int64)
        stats.error_weight_hist[: code_n] += np.asarray(
            a["weight_hist"][1:], np.int64
        )

    pool = unc = sat0 = None
    rotation = 0
    for ci in range(max_calls):
        if stop.done(stats.errors, stats.word_errors, stats.total_words):
            break
        if base > _GID_LIMIT - nd * pool_frames:
            # int32 gid space nearly exhausted (deep campaigns get here):
            # rotate the channel root and restart the index space —
            # frames stay replayable from (seed, rotation, gid)
            rotation += 1
            # fold value >= 2**31 cannot collide with any gid fold
            root = jax.random.fold_in(
                jax.random.key(seed), 2**31 + rotation
            )
            base = 0
        pool, unc, sat0 = pool_fn(jnp.int32(base), root)
        state, acc, _rec = call(state, pool, unc, sat0, jnp.int32(base))
        a = jax.device_get(acc)
        take(a)
        # sharded: the window advances by the full pool (per-device gid
        # ranges must not collide; unconsumed gids are skipped, see the
        # docstring).  Single device: reuse unconsumed rows.
        base += pool_frames if mesh is not None else int(a["consumed"])
        if verbose:
            print(stats.incremental_report())
    # drain: retire the in-flight lanes so every injected frame is counted
    # exactly once.  In-flight frames are enriched in slow/failing frames
    # (a frame occupies a lane in proportion to its decode time), so
    # dropping them biases FER low; draining restores the counted set to
    # an outcome-independent prefix of the (seed, index) frame sequence
    # (run_drain: same compiled call with the pool pre-exhausted).
    if pool is not None:
        state = run_drain(
            call, state, (pool, unc, sat0), base, pool_frames // nd,
            take, num_iterations, iters_per_call,
        )
    stats.wall_seconds = time.perf_counter() - t0
    return stats


# --------------------------------------------------------------- non-binary


def nb_qspa_stream(code, n0: float, q: int = 0,
                   storage_dtype=None) -> StreamDecoder:
    """Stream adapter for :func:`..decoders.nb_qspa.decode_nb_qspa`.

    Pool rows are the PRE-PREPPED max-normalized log priors flattened to
    ``[B, N*q]`` f32 (round 5): the boundary used to recompute symbol
    priors + log for the ENTIRE lane width at every refill boundary —
    exp/log over [N, q, B] per boundary, 32× per call at the default
    cadence — which is why the GF(8) stream row measured SLOWER than
    batched.  The pool builder (``prep_raw``) runs the same
    ``channel.nb.symbol_priors`` + log front-end as the batch decoder
    ONCE per frame at pool build, so per-frame results still equal a
    batch decode of the same bit-level channel rows; ``prep`` is now a
    pure reshape.  Decisions are int8 symbols (q ≤ 128, see
    nb_qspa_machine); the primary error metric is BIT errors (popcount
    of the symbol value for the all-zero codeword), the secondary
    (``errs2``) symbol errors.
    """
    from ..channel.nb import symbol_priors
    from ..decoders.nb_qspa import nb_qspa_machine

    q = q or code.q
    m_bits = q.bit_length() - 1
    M = nb_qspa_machine(code, q, jnp.float32, storage_dtype)

    def prep(rows):
        # rows [B, N*q] prepped log priors -> [N, q, B] (pure relayout)
        return jnp.moveaxis(rows.reshape(-1, code.n, q), 0, -1)

    def prep_raw(y):
        # bit-level samples [F, N*m] -> prepped pool rows [F, N*q]:
        # the batch decoder's exact front-end, run once per frame
        yb = y.astype(jnp.float32).reshape(-1, code.n, m_bits)
        pri = symbol_priors(yb, n0, q)  # [F, N, q]
        lp = M["log_of"](jnp.moveaxis(pri, 0, -1))  # [N, q, F]
        return jnp.moveaxis(lp, -1, 0).reshape(-1, code.n * q)

    def step(v2c, ych):
        c2v = M["cn_update"](v2c)
        return M["vn_update"](c2v, ych)

    def step_fresh(v2c, ych, fresh):
        # lazy fresh-lane re-init: select on the gathered CN rows
        # against a prior gather instead of materializing the merged
        # [N*dv_max, q, B] message plane (see cn_update)
        c2v = M["cn_update"](v2c, ych, fresh)
        return M["vn_update"](c2v, ych)

    def errs_of(d):  # bit errors vs the all-zero codeword
        acc = jnp.zeros(d.shape[-1], jnp.int32)
        for i in range(m_bits):
            acc = acc + jnp.sum((d >> i) & 1, axis=0, dtype=jnp.int32)
        return acc

    return StreamDecoder(
        prep=prep,
        init=M["init"],
        step=step,
        step_fresh=step_fresh,
        satisfied=M["syndrome_ok"],
        hard=lambda d: d,
        d_of=lambda total: M["decide"](total),
        errs_of=errs_of,
        errs2_of=lambda d: jnp.sum(d != 0, axis=0, dtype=jnp.int32),
        prep_raw=prep_raw,
    )


def build_channel_pool_nb(
    dec: StreamDecoder,
    root,
    base: int,
    pool_frames: int,
    n: int,
    q: int,
    sigma: float,
):
    """NB pool: per-frame bit-level AWGN for the all-zero codeword
    (all-+1 BPSK bits), PRE-PREPPED through the decoder's front-end to
    ``[F, N*q]`` f32 log-prior rows (``dec.prep_raw``), plus per-frame
    uncoded symbol errors and the iteration-0 syndrome."""
    m_bits = q.bit_length() - 1
    width = n * m_bits
    gids = base + jnp.arange(pool_frames)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(root, gids)
    noise = jax.vmap(
        lambda kk: jax.random.normal(kk, (width,), jnp.float32)
    )(keys)
    y = 1.0 + sigma * noise
    # pool rows are PRE-PREPPED log priors (f32; see nb_qspa_stream):
    # the symbol-prior front-end runs once per frame HERE instead of for
    # the whole lane width at every refill boundary.  pool_dtype is
    # ignored for NB (narrowing the log priors would change values vs a
    # batch decode of the same channel rows).
    rows = dec.prep_raw(y)
    ych = dec.prep(rows)
    d0 = dec.d_of(ych)  # [N, F] symbols
    unc = jnp.sum(d0 != 0, axis=0, dtype=jnp.int32)
    sat0 = dec.satisfied(d0)
    return rows, unc, sat0


def simulate_stream_nb(
    code,
    snr_db: float,
    num_iterations: int,
    rate: Optional[float] = None,
    stop: Optional[StopRule] = None,
    lanes: int = 512,
    refill_every: int = 1,
    rounds_per_call: Optional[int] = None,
    pool_frames: Optional[int] = None,
    avg_iters_hint: float = 6.0,
    seed: int = 0,
    storage_dtype=None,
    verbose: bool = False,
    max_calls: int = 100000,
    pool_bytes: Optional[int] = None,
):
    """NB Monte-Carlo over the streaming driver -> :class:`NBMCStats`.

    Same statistics semantics as :func:`.montecarlo_nb.simulate_nb` (bit
    errors drive the stop rule; word errors count frames with any symbol
    error) without the early-termination straggler tax.  Pool rows are
    pre-prepped f32 log priors (see :func:`nb_qspa_stream`) — there is
    no pool_dtype knob here (narrowing them would change values vs a
    batch decode of the same channel rows).
    """
    from ..channel.awgn import snr_to_n0
    from .montecarlo_nb import NBMCStats

    q = code.q
    m_bits = q.bit_length() - 1
    rate = rate if rate is not None else code.rate
    stop = stop or StopRule(min_word_errors=default_min_word_errors(code.n))
    n0 = float(snr_to_n0(snr_db, rate))
    sigma = float(np.sqrt(n0 / 2.0))
    root = jax.random.key(seed)
    # pool rows are PRE-PREPPED f32 log priors, width N*q (round 5 —
    # pool_dtype is ignored for NB, see build_channel_pool_nb)
    width = code.n * q
    default_rounds = 32
    if pool_frames is None:
        rounds_per_call, pool_frames = pool_policy(
            lanes, refill_every, rounds_per_call, avg_iters_hint,
            width * 4, pool_bytes, default_rounds=default_rounds,
        )
    elif rounds_per_call is None:
        rounds_per_call = default_rounds

    dec = nb_qspa_stream(code, n0, q, storage_dtype)
    state = stream_init(dec, lanes, width, jnp.float32)
    call = make_stream_call(
        dec, code.n, num_iterations, rounds_per_call, refill_every,
        max_weight=code.n * m_bits,
    )

    @jax.jit
    def pool_fn(base_, root_):
        return build_channel_pool_nb(
            dec, root_, base_, pool_frames, code.n, q, sigma
        )

    stats = NBMCStats(n=code.n, q=q)
    t0 = time.perf_counter()
    base = 0
    rotation = 0

    def take(a):
        stats.total_words += int(a["frames"])
        stats.total_symbols += int(a["frames"]) * code.n
        stats.total_bits += int(a["frames"]) * code.n * m_bits
        stats.bit_errors += int(a["bit_errs"])
        stats.symbol_errors += int(a["errs2"])
        stats.word_errors += int(a["word_errs"])
        stats.total_iterations += int(a["iter_sum"])
        stats.uncoded_symbol_errors += int(a["unc_sum"])

    pool = unc = sat0 = None
    for _ci in range(max_calls):
        if stop.done(stats.bit_errors, stats.word_errors,
                     stats.total_words):
            break
        if base > _GID_LIMIT - pool_frames:
            # rotate the gid space before int32 overflow (see simulate_stream)
            rotation += 1
            # fold value >= 2**31 cannot collide with any gid fold
            root = jax.random.fold_in(
                jax.random.key(seed), 2**31 + rotation
            )
            base = 0
        pool, unc, sat0 = pool_fn(jnp.int32(base), root)
        state, acc, _rec = call(state, pool, unc, sat0, jnp.int32(base))
        a = jax.device_get(acc)
        take(a)
        base += int(a["consumed"])
        if verbose:
            print(
                f"stream_nb: {stats.total_words} frames, "
                f"SER={stats.ser:.4g} BER={stats.ber:.4g}"
            )
    # drain in-flight lanes (run_drain: dropping them biases FER low —
    # they are enriched in slow/failing frames)
    if pool is not None:
        state = run_drain(
            call, state, (pool, unc, sat0), base, int(pool.shape[0]),
            take, num_iterations, rounds_per_call * refill_every,
        )
    stats.wall_seconds = time.perf_counter() - t0
    return stats
