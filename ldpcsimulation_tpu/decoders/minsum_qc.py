"""Gather-free min-sum decoder for quasi-cyclic codes.

Same arithmetic, slot order, and tie-breaking as :mod:`.minsum` (bit-exact
equivalence is tested), but the VN↔CN permutation is done with per-block
cyclic rolls whose offsets are compile-time constants (see
:mod:`..codes.qc`).  XLA lowers a static-shift roll to two contiguous
copies, so the decoder contains no dynamic gathers at all.

Message layout (``qc_ragged_init``): base-column planes of z×B circulant
rows, batch in lanes — the stacked ``[Nb, dv_max, z, B]`` array for
block-uniform codes, and a RAGGED tuple of ``[deg_j, z, B]`` arrays for
irregular ones.  The split is measured (round 4): dv_max-padded planes
cost real write traffic on irregular codes (2.3× padding on the DVB-S2
QC structure → +40% flooding throughput ragged; 3× on 802.11n, dv
profile {2,3,4,11} → +19%), while on regular codes the single stacked
array lowers better than Nb small leaves (the ragged carry measured
−17% on the flagship).  Plain QC blocks are all-or-nothing (no per-row
masking); the generalized structures of real standards — multi-edge block
pairs and single absent edges (DVB-S2 rate-1/2 under the q-row
interleave, :mod:`..codes.standards`) — are handled with static per-row
masks from :func:`qc_slot_plan`, keeping decisions bit-exact with the
generic slot-array decoder on the same expanded H.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.qc import QCCode
from .base import DecodeResult, run_flooding_soft, sgn_pos, storage_cast

__all__ = ["decode_minsum_qc", "qc_check_satisfied", "qc_cn_minsum",
           "qc_block_uniform", "qc_cn_minsum_slots", "qc_minsum_step",
           "qc_ragged_init",
           "qc_slot_plan"]


class _CNEntry:
    """One circulant as seen from CN block ``bi`` (static plan data).

    bj/vslot/shift: VN block, its slot index there, and the circulant
    shift.  cn_mask: [z] bool marking CN row offsets whose edge is absent
    (``minus_edges``) — masked reads use the neutral element (+inf: CN
    min-scans skip it, phi(+inf)=0 and sgn +1 for BP).  pair_sw: for the
    FIRST member of a same-(bi,bj) double circulant, the [z] bool mask of
    CN rows where the expanded alist orders the SECOND circulant's column
    first — the scan consumes row-wise swapped views so min-sum
    tie-breaking and BP fold order stay bit-exact with the generic
    decoder.  pair_second marks the second member.
    """

    __slots__ = ("bj", "vslot", "shift", "cn_mask", "pair_sw", "pair_second")

    def __init__(self, bj, vslot, shift):
        self.bj, self.vslot, self.shift = bj, vslot, shift
        self.cn_mask = None
        self.pair_sw = None
        self.pair_second = False


class _VNEntry:
    """One circulant as seen from VN block ``bj`` (static plan data).

    zero_mask: [z] bool of column offsets whose edge is absent — the c2v
    contribution is zeroed there (exact: x + 0.0 == x), matching the
    generic decoder's missing slot.  pair_sw/pair_second: as in _CNEntry
    but over column offsets, applied to the VN total's left-fold order.
    """

    __slots__ = ("bi", "shift", "zero_mask", "pair_sw", "pair_second")

    def __init__(self, bi, shift):
        self.bi, self.shift = bi, shift
        self.zero_mask = None
        self.pair_sw = None
        self.pair_second = False


@functools.lru_cache(maxsize=None)
def qc_slot_plan(qc: QCCode):
    """Static scan plan: (cn_plan[bi] -> [_CNEntry], vn_plan[bj] ->
    [_VNEntry]).

    Handles the generalized structures of real standards (multi-edge
    block pairs and single-edge defects, :class:`..codes.qc.QCCode`)
    while reducing to the plain single-edge plan when absent.  At most
    two circulants per (bi, bj) pair are supported.
    """
    z = qc.z
    minus = set(qc.minus_edges)

    vn_plan = []
    for bj in range(qc.nb):
        entries = [_VNEntry(bi, s) for bi, s in qc.vn_blocks[bj]]
        for k, e in enumerate(entries):
            if k + 1 < len(entries) and entries[k + 1].bi == e.bi:
                if k + 2 < len(entries) and entries[k + 2].bi == e.bi:
                    raise NotImplementedError(
                        ">2 circulants between one block pair"
                    )
                s1, s2 = e.shift, entries[k + 1].shift
                c = np.arange(z)
                e.pair_sw = ((c - s2) % z) < ((c - s1) % z)
                entries[k + 1].pair_second = True
        vn_plan.append(entries)

    for bi, bj, s, r in minus:
        for e in vn_plan[bj]:
            if e.bi == bi and e.shift == s:
                zm = np.zeros(z, bool) if e.zero_mask is None else e.zero_mask
                zm[(r + s) % z] = True
                e.zero_mask = zm
                break
        else:
            raise ValueError(f"minus edge {(bi, bj, s, r)} has no circulant")

    cn_plan = []
    for bi in range(qc.mb):
        entries = []
        for bj, s in qc.cn_blocks[bi]:
            vslot = next(
                k for k, (b2, s2) in enumerate(qc.vn_blocks[bj])
                if b2 == bi and s2 == s
            )
            entries.append(_CNEntry(bj, vslot, s))
        for k, e in enumerate(entries):
            if (
                k + 1 < len(entries)
                and entries[k + 1].bj == e.bj
                and not e.pair_second
            ):
                s1, s2 = e.shift, entries[k + 1].shift
                r = np.arange(z)
                e.pair_sw = ((r + s2) % z) < ((r + s1) % z)
                entries[k + 1].pair_second = True
        for mbi, mbj, ms, mr in minus:
            if mbi != bi:
                continue
            for e in entries:
                if e.bj == mbj and e.shift == ms:
                    cm = (
                        np.zeros(z, bool) if e.cn_mask is None else e.cn_mask
                    )
                    cm[mr] = True
                    e.cn_mask = cm
                    break
        cn_plan.append(entries)
    return cn_plan, vn_plan


def assert_layered_compatible(qc: QCCode):
    """The layered decoders handle pairs and defects but not a minus edge
    INSIDE a pair block (the block-parallel accumulate would need a third
    posterior term there); raise early with a clear message."""
    cn_plan, _ = qc_slot_plan(qc)
    for row in cn_plan:
        for e in row:
            if e.cn_mask is not None and (
                e.pair_sw is not None or e.pair_second
            ):
                raise NotImplementedError("minus edge inside a pair block")


def _swap_scan_views(entries, phys):
    """Row-wise swapped views in generic scan order (no-op without pairs)."""
    scan = list(phys)
    for t, e in enumerate(entries):
        if e.pair_sw is not None:
            sw = jnp.asarray(e.pair_sw)[:, None]
            scan[t] = jnp.where(sw, phys[t + 1], phys[t])
            scan[t + 1] = jnp.where(sw, phys[t], phys[t + 1])
    return scan


def _unswap_outputs(entries, outs):
    """Inverse of :func:`_swap_scan_views` on the scan outputs."""
    phys = list(outs)
    for t, e in enumerate(entries):
        if e.pair_sw is not None:
            sw = jnp.asarray(e.pair_sw)[:, None]
            phys[t] = jnp.where(sw, outs[t + 1], outs[t])
            phys[t + 1] = jnp.where(sw, outs[t], outs[t + 1])
    return phys


def _vn_fold(entries, accs, init=None):
    """Left-fold of a VN block's c2v contributions in the generic
    decoder's within-column slot order (pair swaps preserve the f32
    grouping), with absent (minus) edges contributing exact zeros.

    ``init``: optional seed term folded FIRST (used by decoders that pin
    the reference's ``sum = y[i]; sum += msg`` association, e.g. DD-BMP);
    min-sum/BP fold messages first and add the channel term last
    (see minsum.vn_update for the grouping rationale)."""
    vals = []
    for e, sa in zip(entries, accs):
        if e.zero_mask is not None:
            sa = jnp.where(
                jnp.asarray(e.zero_mask)[:, None], jnp.zeros_like(sa), sa
            )
        vals.append(sa)
    acc = init
    t = 0
    while t < len(vals):
        if entries[t].pair_sw is not None:
            sw = jnp.asarray(entries[t].pair_sw)[:, None]
            first = jnp.where(sw, vals[t + 1], vals[t])
            second = jnp.where(sw, vals[t], vals[t + 1])
            acc = first if acc is None else acc + first
            acc = acc + second
            t += 2
        else:
            acc = vals[t] if acc is None else acc + vals[t]
            t += 1
    return acc


def _v2c_slot(v2c, bj, s):
    """Read one [z, B] message plane from either carry layout.  The
    stacked array uses single-step indexing ``v2c[bj, s]`` — the chained
    ``v2c[bj][s]`` form materializes the intermediate [dv_max, z, B]
    slice and measured −23% on the flagship."""
    if isinstance(v2c, (tuple, list)):
        return v2c[bj][s]
    return v2c[bj, s]


def qc_cn_minsum_slots(qc: QCCode, v2c, variant="plain", alpha=1.0,
                       delta=0.0, int_scan=False):
    """CN update + variant post-op, returning c2v slot EXPRESSIONS in VN
    layout: ``slots[bj][s]`` is a ``[z, B]`` array for VN block ``bj``'s
    ``s``-th edge block.

    Returning the unstacked list lets the VN update consume the c2v values
    as fused expressions — XLA CSEs the shared slot between the total sum
    and the extrinsic subtraction, so the stacked ``[Nb, dv_max, z, B]``
    c2v buffer is never materialized in device memory.

    v2c: [Nb, dv_max, z, B].  Identical scan semantics to minsum_cn_update
    (<= last-min-wins).

    ``int_scan``: run the scan on the sign-magnitude INTEGER view of the
    messages (float ordering is monotone in the integer bit pattern for
    same-sign finite values, signs combine as XOR of sign bits) — the
    same selects/compares as the float scan bit for bit, candidate for
    cheaper integer issue (see :func:`_cn_scan_int`).  Plain variant only;
    requires -0.0-free inputs (``storage_cast`` canonicalizes).

    ``v2c`` may be the stacked ``[Nb, dv_max, z, B]`` array or the
    RAGGED tuple of per-block ``[deg_j, z, B]`` planes (round 4: the
    production carry — padded planes cost real write traffic on
    irregular codes, 2.3–3.3× on DVB-S2/802.11n).
    """
    z = qc.z
    dtype = v2c[0].dtype
    b = v2c[0].shape[-1]
    cn_plan, _ = qc_slot_plan(qc)
    inf = jnp.asarray(jnp.inf, dtype)
    if int_scan and variant != "plain":
        raise ValueError("int_scan supports the plain variant only")

    c2v_slots = [
        [None] * len(qc.vn_blocks[bj]) for bj in range(qc.nb)
    ]
    for bi in range(qc.mb):
        entries = cn_plan[bi]
        # CN-row-space views of incoming messages (static rolls); absent
        # (minus) edges read the scan-neutral +inf
        phys = []
        for e in entries:
            msg = jnp.roll(_v2c_slot(v2c, e.bj, e.vslot), -e.shift, axis=0)
            if e.cn_mask is not None:
                msg = jnp.where(jnp.asarray(e.cn_mask)[:, None], inf, msg)
            phys.append(msg)
        views = _swap_scan_views(entries, phys)
        if int_scan:
            outs = _cn_scan_int(views)
        else:
            min1 = jnp.full((z, b), inf, dtype)
            min2 = jnp.full((z, b), inf, dtype)
            minidx = jnp.full((z, b), -1, jnp.int32)
            sprod = jnp.ones((z, b), dtype)
            for t, msg in enumerate(views):
                a = jnp.abs(msg)
                sprod = sprod * sgn_pos(msg)
                is_min = a <= min1
                min2 = jnp.where(is_min, min1, jnp.where(a < min2, a, min2))
                minidx = jnp.where(is_min, t, minidx)
                min1 = jnp.where(is_min, a, min1)
            outs = []
            for t, msg in enumerate(views):
                mag = jnp.where(minidx == t, min2, min1)
                out = sprod * mag * sgn_pos(msg)
                if variant == "normalized":
                    out = out / alpha
                elif variant == "offset":
                    m2 = jnp.abs(out) - delta
                    out = jnp.where(
                        m2 > 0, sgn_pos(out) * m2, jnp.zeros_like(out)
                    )
                outs.append(out)
        outs = _unswap_outputs(entries, outs)
        for t, e in enumerate(entries):
            c2v_slots[e.bj][e.vslot] = jnp.roll(outs[t], e.shift, axis=0)
    return c2v_slots


def _cn_scan_int(views):
    """Sign-magnitude integer-view min-sum CN scan (VERDICT r3 item 7).

    For finite IEEE floats of one sign, value order is monotone in the
    raw bit pattern, so with ``v = bitcast(msg)``:

      * ``|msg|``           = ``v & 0x7fff…``  (clear sign bit)
      * ``a <= min1``       = integer compare of magnitude patterns
      * sign product        = XOR of sign bits (±1 muls become one xor)
      * ``sprod·mag·sgn(m)``= ``mag_bits | (sxor ^ sign_bits(m))``

    Bit-identical to the float scan (the scan only *selects* stored
    values; the sign algebra is exact) provided inputs are −0.0-free:
    ``sgn_pos(−0.0) = +1`` but the sign bit says negative, so
    ``storage_cast`` canonicalizes −0 → +0 on the f16 store.  +inf
    (absent-edge neutral) has magnitude pattern 0x7c00, above every
    finite value, exactly like the float scan.
    """
    dtype = views[0].dtype
    if dtype == jnp.float16:
        idt, inf_bits = jnp.int16, 0x7C00
    elif dtype == jnp.float32:
        idt, inf_bits = jnp.int32, 0x7F800000
    else:
        raise ValueError(f"int_scan: unsupported dtype {dtype}")
    nbits = jnp.finfo(dtype).bits
    sign_mask = idt(-(1 << (nbits - 1)))  # 0x8000… as signed
    mag_mask = idt((1 << (nbits - 1)) - 1)
    vs = [jax.lax.bitcast_convert_type(m, idt) for m in views]
    mags = [v & mag_mask for v in vs]
    signs = [v & sign_mask for v in vs]

    # +inf pattern init: matches the float scan's identity exactly
    # (including the absent-edge +inf neutral and degenerate dc=1 rows)
    min1 = jnp.full_like(mags[0], idt(inf_bits))
    min2 = jnp.full_like(mags[0], idt(inf_bits))
    minidx = jnp.full(mags[0].shape, -1, jnp.int32)
    sxor = jnp.zeros_like(signs[0])
    for t, a in enumerate(mags):
        sxor = sxor ^ signs[t]
        is_min = a <= min1
        min2 = jnp.where(is_min, min1, jnp.where(a < min2, a, min2))
        minidx = jnp.where(is_min, t, minidx)
        min1 = jnp.where(is_min, a, min1)
    outs = []
    for t in range(len(views)):
        mag = jnp.where(minidx == t, min2, min1)
        out_bits = mag | (sxor ^ signs[t])
        outs.append(jax.lax.bitcast_convert_type(out_bits, dtype))
    return outs


def qc_cn_minsum(qc: QCCode, v2c, variant="plain", alpha=1.0, delta=0.0):
    """CN update + variant post-op, returning c2v stacked in VN layout
    ``[Nb, dv_max, z, B]`` (missing irregular slots are zero)."""
    c2v_slots = qc_cn_minsum_slots(qc, v2c, variant, alpha, delta)
    z = qc.z
    b = v2c.shape[-1]
    zero = jnp.zeros((z, b), v2c.dtype)
    planes = []
    for bj in range(qc.nb):
        slots = list(c2v_slots[bj]) + [zero] * (
            qc.dv_max - len(c2v_slots[bj])
        )
        planes.append(jnp.stack(slots))
    return jnp.stack(planes)


def qc_check_satisfied(qc: QCCode, d):
    """d: [Nb, z, B] ±1 -> [B] all-checks-satisfied."""
    cn_plan, _ = qc_slot_plan(qc)
    ok = None
    for bi in range(qc.mb):
        prod = None
        for e in cn_plan[bi]:
            v = jnp.roll(d[e.bj], -e.shift, axis=0)
            if e.cn_mask is not None:  # absent edge: neutral factor
                v = jnp.where(
                    jnp.asarray(e.cn_mask)[:, None], jnp.ones_like(v), v
                )
            prod = v if prod is None else prod * v
        row_ok = jnp.all(prod > 0, axis=0)  # [B]
        ok = row_ok if ok is None else ok & row_ok
    return ok


def qc_minsum_step(
    qc: QCCode,
    variant: str = "plain",
    alpha: float = 1.0,
    delta: float = 0.0,
    storage_dtype=None,
    int_scan: bool = False,
):
    """The :func:`decode_minsum_qc` iteration as a pure function of
    (messages, channel term): ``step(v2c, yb) -> (v2c', totals)`` with
    ``yb`` the ``[Nb, z, B]`` channel-sample planes.

    Identical operations (and therefore bit-identical results) to the
    closure inside :func:`decode_minsum_qc` — factored out so drivers that
    REPLACE the channel term mid-decode (the streaming refill harness,
    :mod:`...harness.stream`) share one definition with the batch decoder.
    """
    _, vn_plan = qc_slot_plan(qc)
    dv_max = qc.dv_max

    def step(v2c, yb):
        """One flooding iteration.  Returns (v2c_new, totals).

        The c2v slots stay unstacked expressions: each is consumed by the
        per-block total (messages left-folded, channel term added last —
        the generic decoder's exact grouping, see minsum.vn_update) and
        by the extrinsic subtraction, which XLA CSEs into one fused
        computation with no materialized c2v buffer.  v2c is the RAGGED
        tuple of per-block [deg_j, z, B] planes — no dv_max zero-padding
        slots are ever written (they cost real traffic on irregular
        codes: 2.3× on DVB-S2 QC, 3× on 802.11n).
        """
        sdt = storage_dtype if storage_dtype is not None else yb.dtype
        slots = qc_cn_minsum_slots(
            qc, v2c, variant, alpha, delta, int_scan=int_scan
        )
        totals = []
        planes = []
        for bj in range(qc.nb):
            accs = [s.astype(yb.dtype) for s in slots[bj]]
            total = yb[bj] + _vn_fold(vn_plan[bj], accs)  # [z, B]
            totals.append(total)
            # int_scan reads raw sign bits, so −0.0 stores are
            # canonicalized to +0.0 (adding +0.0 is exact elsewhere)
            pl = [
                storage_cast(total - sa, sdt) + jnp.zeros((), sdt)
                if int_scan
                else storage_cast(total - sa, sdt)
                for sa in accs
            ]
            planes.append(jnp.stack(pl))
        if qc_block_uniform(qc):
            return jnp.stack(planes), jnp.stack(totals)
        return tuple(planes), jnp.stack(totals)

    return step


def qc_block_uniform(qc: QCCode) -> bool:
    """True when every VN block has exactly dv_max slots (regular
    profiles) — the stacked [Nb, dv_max, z, B] carry then has zero
    padding AND lowers measurably better than a tuple of per-block
    leaves (one fused plane op vs Nb small ones: the ragged carry cost
    the regular flagship 17% while winning 19–40% on irregular codes)."""
    return all(
        len(qc.vn_blocks[bj]) == qc.dv_max for bj in range(qc.nb)
    )


def qc_ragged_init(qc: QCCode, yb, sdt):
    """Initial v2c, every slot starting at the channel sample
    (initializeSymMessages, ``decodeMinSum.cpp:364-370``): the stacked
    ``[Nb, dv_max, z, B]`` array for block-uniform codes, else the
    ragged tuple of ``[deg_j, z, B]`` planes (no padding writes)."""
    if qc_block_uniform(qc):
        return jnp.broadcast_to(
            yb[:, None], (qc.nb, qc.dv_max) + yb.shape[1:]
        ).astype(sdt)
    return tuple(
        jnp.broadcast_to(
            yb[bj][None], (len(qc.vn_blocks[bj]),) + yb.shape[1:]
        ).astype(sdt)
        for bj in range(qc.nb)
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "qc",
        "num_iterations",
        "variant",
        "early_termination",
        "storage_dtype",
        "int_scan",
    ),
)
def decode_minsum_qc(
    qc: QCCode,
    y: jax.Array,
    num_iterations: int,
    variant: str = "plain",
    alpha: float = 1.0,
    delta: float = 0.0,
    early_termination: bool = False,
    storage_dtype=None,
    int_scan: bool = False,
) -> DecodeResult:
    """Batched flooding min-sum on a QC code.  y: [B, N].

    storage_dtype: optional narrower dtype (e.g. float16) for the message
    arrays.  CN min/sign is exact on the stored values and c2v magnitudes
    are copies of stored inputs (lossless), so the only rounding is the
    per-iteration v2c store after the f32 VN sum — a bandwidth/precision
    trade measured at ~1% BER effect for f16 at the 2 dB operating point
    (vs ~60% for doing all arithmetic in bf16).
    """
    y_t = jnp.asarray(y).T  # [N, B]
    n, b = y_t.shape
    assert n == qc.n, (n, qc.n)
    yb = y_t.reshape(qc.nb, qc.z, b)
    sdt = storage_dtype if storage_dtype is not None else y_t.dtype

    # initializeSymMessages: all slots start at the channel sample
    # (ragged per-block planes — no dv_max padding writes)
    v2c0 = qc_ragged_init(qc, yb, sdt)
    if int_scan:
        # canonicalize −0.0 (see step)
        v2c0 = jax.tree.map(lambda p: p + jnp.zeros((), sdt), v2c0)
    step_y = qc_minsum_step(qc, variant, alpha, delta, storage_dtype,
                            int_scan=int_scan)

    d, iters, done = run_flooding_soft(
        yb, v2c0, lambda v2c: step_y(v2c, yb),
        lambda d: qc_check_satisfied(qc, d),
        num_iterations, early_termination, b,
    )
    return DecodeResult(
        hard=d.reshape(n, b).T, iterations=iters, satisfied=done
    )
