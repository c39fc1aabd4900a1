"""Non-binary FFT-QSPA: GF(2^m) sum-product with Hadamard-domain checks.

This implements the *intent* of the reference's work-in-progress NB-LDPC
tree: ``SystemC/NB-LDPC/inc/nodes.h:240-287`` enumerates all dc-tuples over
GF(q) summing to each field element — the brute-force O(q^dc) check-node
convolution — and ``belief_propagation_old.py:76-167`` sketches the
Davey–MacKay GF(q) belief propagation this replaces.  The algorithm source
is Davey–MacKay (1998): because GF(2^m)'s additive group is (Z_2)^m, the
check constraint Σ h_e·x_e = 0 is a group convolution diagonalized by the
Walsh–Hadamard transform, turning O(q^dc) into O(dc·q·log q):

  CN:  per edge, rescale P_x by the edge coefficient (index permutation
       through the GF multiplication table), WHT, multiply the *other*
       edges' transforms (prefix/suffix, exact exclusion), inverse WHT,
       inverse-rescale.  For q ≤ 8 the rescale+WHT pair is fused into a
       single ±1 linear combination (see :func:`_wht_sign_tables`).
  VN:  product of channel prior and other edges' messages (log-domain
       prefix/suffix sums, max-normalized).

Messages between the updates are stored in the LOG domain (round 3): both
per-(slot, frame) normalizations reduce to max-subtractions by scale
invariance, and optional f16 message storage (measured SER-identical on
the real GF(4)/GF(8) codes at their waterfall points) halves the gather
traffic — see :func:`decode_nb_qspa`.
  Decision: argmax posterior; stop when the hard symbols satisfy every
       check (H·z = 0 over GF(q)), as in the prototype.

The reference's per-edge GF coefficients (``nvals/mvals`` in the NB alist,
``SystemC/NB-LDPC/src/alist.cpp:97-124``) live in ``Code.vn_coef`` /
``Code.cn_coef`` and drive the permutations — the piece the broken SystemC
checknode never wired up (coefficient TODO at ``inc/nodes.h:137``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.code import Code
from ..codes.gf import gf_tables
from .base import _mask_last

__all__ = ["NBDecodeResult", "decode_nb_qspa", "nb_qspa_machine", "wht"]


@dataclasses.dataclass
class NBDecodeResult:
    """symbols: [B, N] hard GF-symbol decisions; iterations/satisfied [B]."""

    symbols: jax.Array
    iterations: jax.Array
    satisfied: jax.Array


jax.tree_util.register_dataclass(
    NBDecodeResult,
    data_fields=["symbols", "iterations", "satisfied"],
    meta_fields=[],
)


def _gf2m_wht(x):
    """WHT over the last axis (len q = 2^m), bit-plane butterflies.

    Diagonalizes XOR-convolution: WHT(a ⊛ b) = WHT(a)·WHT(b) where
    (a ⊛ b)[k] = Σ_{i⊕j=k} a[i]b[j].  Self-inverse up to a factor q.

    The butterflies are exact in f32 and fuse into elementwise chains; a
    dense ±1 Sylvester-matrix product (``x @ H_q``) would need HIGHEST
    precision to stay exact, and which form is faster on a given device
    is a measurement.
    """
    q = x.shape[-1]
    m = q.bit_length() - 1
    assert 2 ** m == q
    shape = x.shape
    for i in range(m):
        x = x.reshape(shape[:-1] + (q >> (i + 1), 2, 1 << i))
        a = x[..., 0, :]
        b = x[..., 1, :]
        x = jnp.stack([a + b, a - b], axis=-2).reshape(shape)
    return x


def wht(x: jax.Array, axis: int = -1) -> jax.Array:
    """Public WHT along ``axis``; see :func:`_gf2m_wht`."""
    x = jnp.moveaxis(jnp.asarray(x), axis, -1)
    return jnp.moveaxis(_gf2m_wht(x), -1, axis)


# Fused coefficient-rescale + WHT (chip profile, round 3): the CN transform
# pair — permute the q axis by the edge coefficient, then WHT — was 5.9 ms
# of the 20.2 ms real-GF(4)-code iteration (take_along_axis gather 2.5 ms +
# butterfly WHT with its moveaxis transposes 3.4 ms, each way).  But the
# composition is itself a single ±1 linear map over the tiny q axis:
#
#   fwd:  WHT(P_h x)[w]   = Σ_a (-1)^pc(w & a) x[h^{-1}a]
#                         = Σ_c (-1)^pc(w & (h⊗c)) x[c]
#   inv:  (P_h' WHT s)[a] = Σ_c (-1)^pc((h⊗a) & c) s[c]
#
# so both sides become ONE fused elementwise pass: a q-term multiply-add
# unroll against constant [q, q, q] sign tables indexed by the (traced)
# per-slot coefficient — no gather, no transposes, q² mul-adds per
# lane element.  That is a win only while q² is small; for large q the
# butterfly's q·log q beats it, so the decoder gates on q ≤ _FUSED_QMAX
# (GF(64) measured faster on the butterfly path, see _gf2m_wht docstring).
_FUSED_QMAX = 8

#: Gather layout for the graph interleave (VERDICT r4 item 1 candidate):
#: False — row gathers over [slots, q, B] planes (q·B-wide rows);
#: True — one flattened take over [slots·q, B] with the q offset folded
#: into the index ([B]-wide rows).  Values are identical either way
#: (pinned by test_nb_qspa.test_flat_gather_layout_identical); the
#: default is whichever the chip measurement favors
#: (docs/profiling/nbgather.py).
FLAT_GATHER = False


@functools.lru_cache(maxsize=None)
def _wht_sign_tables(q: int):
    """Constant [q, q, q] f32 tables: fwd[h, w, c], inv[h, a, c] (above)."""
    mul_np, _ = gf_tables(q)
    idx = np.arange(q)
    pc = np.array([bin(i).count("1") for i in range(q)])
    par = np.where(pc[idx[:, None] & idx[None, :]] % 2 == 0, 1.0, -1.0)
    fwd = par[:, mul_np].transpose(1, 0, 2)  # fwd[h, w, c] = par[w, h⊗c]
    inv = par[mul_np]  # inv[h, a, c] = par[h⊗a, c]
    return (np.ascontiguousarray(fwd.astype(np.float32)),
            np.ascontiguousarray(inv.astype(np.float32)))


def _signed_combine(sgn, x):
    """y[s, w, b] = Σ_c sgn[s, w, c] · x[s, c, b], unrolled over c so XLA
    lowers it as one elementwise fusion (no dot, no gather)."""
    q = x.shape[1]
    acc = sgn[:, :, 0, None] * x[:, None, 0, :]
    for c in range(1, q):
        acc = acc + sgn[:, :, c, None] * x[:, None, c, :]
    return acc


def _class_combine(h_cn, x, tbl):
    """y[s, w, b] = Σ_c tbl[h_s, w, c] · x[s, c, b], per-class static form.

    ``tbl`` is a constant numpy [q, q, q] ±1 table; ``h_cn`` the traced
    per-slot coefficient.  Each coefficient class h ∈ {1..q−1} gets a
    compile-time-sign add/sub unroll (no per-slot sign tensor, no
    multiplies), selected by the traced class mask.  Measured 2.4× faster
    than the broadcast-multiply :func:`_signed_combine` on the real GF(4)
    (9000,6000) code — and bit-identical (same c-ascending accumulation
    order).  The q=2 case degenerates to the plain butterfly with zero
    selects.  Coefficient 0 never labels an edge; padding slots carry 1
    and are overwritten by the caller's mask.

    Only used for q ≤ 4: at q=8 the (q−1)-class × q² unroll measured 2×
    SLOWER than :func:`_signed_combine` (37.6 vs 18.2 ms/iteration on the
    real GF(8) code) — the select chain cannot amortize 7 full combines."""
    q = x.shape[1]

    def static_combine(h):
        cols = []
        for w in range(q):
            acc = None
            for c in range(q):
                t = x[:, c] if tbl[h, w, c] > 0 else -x[:, c]
                acc = t if acc is None else acc + t
            cols.append(acc)
        return jnp.stack(cols, axis=1)

    out = static_combine(1)
    for h in range(2, q):
        out = jnp.where((h_cn == h)[:, None, None], static_combine(h), out)
    return out


def nb_qspa_machine(code: Code, q: int, dtype=jnp.float32,
                    storage_dtype=None, flat_gather=None):
    """The FFT-QSPA kernels as pure functions of their inputs.

    Returns a dict of:
      * ``cn_update(v2c)``            — [slots_v, q, B] log → [slots_c, q, B]
      * ``vn_update(c2v, log_pri)``   — → (v2c log, log_post)
      * ``decide(log_post)``          — → [N, B] symbols (int8 for
        q ≤ 128 — exact; cast to int32 at the public result boundary)
      * ``syndrome_ok(symbols)``      — H·z == 0 over GF(q), [B] bool
      * ``init(log_pri)``             — initial v2c message planes

    Factored out of :func:`decode_nb_qspa` (identical operations — the
    batch decoder builds its loop from these) so drivers that replace the
    channel term mid-decode (the streaming refill harness) share one
    definition.  See the module docstring for the algorithm and the
    fused-combine gating.
    """
    mul_np, inv_np = gf_tables(q)
    mul = jnp.asarray(mul_np)
    inv = jnp.asarray(inv_np)
    sdtype = storage_dtype or dtype
    eps = jnp.asarray(1e-30, dtype)

    # static-shaped coefficient permutation tables (built from traced
    # coefficients via the constant multiplication table)
    h_cn = code.cn_coef.reshape(-1)  # [M*dc_max], 1 on padding
    pre_idx = mul[inv[h_cn]]  # [slots, q]: P_u[b] = P_x[h^-1 b]
    post_idx = mul[h_cn]  # [slots, q]: P_out[a] = P_s[h a]

    cn_gather = code.cn_from_vn.reshape(-1)
    vn_gather = code.vn_from_cn.reshape(-1)
    cn_vn_ids = code.cn_vn.reshape(-1)  # VN id per CN slot
    flat = FLAT_GATHER if flat_gather is None else flat_gather
    if flat:
        qoff = jnp.arange(q)[None, :]
        cn_idx_flat = (cn_gather[:, None] * q + qoff).reshape(-1)
        vn_idx_flat = (vn_gather[:, None] * q + qoff).reshape(-1)
        cn_vn_flat = (cn_vn_ids[:, None] * q + qoff).reshape(-1)

    def _take_rows(x, idx_rows, idx_flat, n_out):
        """Graph-interleave gather in the configured layout: row take
        over [slots, q, B] planes, or one flattened take over
        [slots*q, B] with the q offset folded into the index —
        identical values (pure relayout of the same elements)."""
        if flat:
            b = x.shape[-1]
            return jnp.take(
                x.reshape(-1, b), idx_flat, axis=0
            ).reshape(n_out, q, b)
        return jnp.take(x, idx_rows, axis=0)
    cn_mask = code.cn_mask.reshape(-1)[:, None, None]
    vn_mask = code.vn_mask.reshape(-1)[:, None, None]
    delta0 = jnp.zeros((q,), dtype).at[0].set(1.0)[None, :, None]

    if q <= _FUSED_QMAX:
        fwd_tbl, inv_tbl = _wht_sign_tables(q)
        if q <= 4:
            combine = functools.partial(_class_combine, h_cn)
            fwd_arg, inv_arg = fwd_tbl, inv_tbl
        else:
            combine = lambda x, sgn: _signed_combine(sgn, x)  # noqa: E731
            fwd_arg = jnp.take(jnp.asarray(fwd_tbl), h_cn, axis=0)
            inv_arg = jnp.take(jnp.asarray(inv_tbl), h_cn, axis=0)

    if q <= _FUSED_QMAX:
        # per-dc-column views of the coefficient classes / sign tables and
        # padding masks, for the column-major fused CN below
        if q <= 4:
            _hs = h_cn.reshape(code.m, code.dc_max)
            _fcomb = [
                (lambda t: lambda x: _class_combine(_hs[:, t], x, fwd_tbl))(t)
                for t in range(code.dc_max)
            ]
            _icomb = [
                (lambda t: lambda x: _class_combine(_hs[:, t], x, inv_tbl))(t)
                for t in range(code.dc_max)
            ]
        else:
            _fwd_s = fwd_arg.reshape(code.m, code.dc_max, q, q)
            _inv_s = inv_arg.reshape(code.m, code.dc_max, q, q)
            _fcomb = [
                (lambda t: lambda x: _signed_combine(_fwd_s[:, t], x))(t)
                for t in range(code.dc_max)
            ]
            _icomb = [
                (lambda t: lambda x: _signed_combine(_inv_s[:, t], x))(t)
                for t in range(code.dc_max)
            ]
        _mask_c = code.cn_mask  # [m, dc_max]

    def cn_update(v2c, log_pri=None, fresh=None):
        """v2c [N*dv_max, q, B] log-domain -> c2v [M*dc_max, q, B] log.

        ``fresh`` (with ``log_pri``): optional [B] bool — lanes whose
        messages must read as freshly initialized (every slot = the
        max-normalized log prior of its variable).  The select runs on
        the GATHERED rows against a gather of the [N, q, B] priors by
        the slot's VN id — identical values to merging
        ``init(log_pri)`` into v2c first (the streaming adapter's lazy
        init: the array-level merge materializes the full [N·dv_max,
        q, B] message plane each iterate)."""
        b = v2c.shape[-1]
        g = _take_rows(v2c, cn_gather, cn_idx_flat if flat else None,
                       code.m * code.dc_max)  # [M*dc_max, q, B]
        if fresh is not None:
            gi = _take_rows(
                log_pri.astype(sdtype), cn_vn_ids,
                cn_vn_flat if flat else None, code.m * code.dc_max,
            )  # init value per CN slot (= init(log_pri) gathered)
            g = jnp.where(fresh[None, None, :], gi, g)
        g = jnp.exp(g.astype(dtype))  # x-domain, ≤ 1 (max-normalized logs)
        if q <= _FUSED_QMAX:
            # fused coefficient-rescale + WHT (see _wht_sign_tables),
            # processed COLUMN-MAJOR over the dc axis: each column's
            # exclusion-product -> inverse-combine -> log -> f16 chain
            # fuses into its own output write, so the [m, dc, q, B]
            # exclusion stack and the second combine's input are never
            # materialized (round 4: -22% CN wall on the real GF(4) code).
            # A padding slot's contribution is delta0, whose transform is
            # all-ones under any coefficient.  Identical operations and
            # accumulation orders as the flat form — bit-exact.
            gs = g.reshape(code.m, code.dc_max, q, b)
            f = []
            for t in range(code.dc_max):
                ft = _fcomb[t](gs[:, t])
                f.append(
                    jnp.where(
                        _mask_c[:, t][:, None, None], ft, jnp.ones_like(ft)
                    )
                )
            # exact exclusion via prefix/suffix products over the dc axis
            ones = jnp.ones((code.m, q, b), dtype)
            pre = [ones]
            for t in range(code.dc_max - 1):
                pre.append(pre[-1] * f[t])
            suf = [ones]
            for t in range(code.dc_max - 1, 0, -1):
                suf.append(suf[-1] * f[t])
            suf.reverse()
            outs = []
            for t in range(code.dc_max):
                o = _icomb[t](pre[t] * suf[t])  # inv WHT · q + post-perm
                o = jnp.maximum(o, 0.0)
                outs.append(jnp.log(o + eps).astype(sdtype))
            return jnp.stack(outs, axis=1).reshape(
                code.m * code.dc_max, q, b
            )
        else:
            # coefficient rescale; padding slots become delta at 0 (the
            # additive identity — exactly a non-edge's contribution)
            g = jnp.take_along_axis(g, pre_idx[:, :, None], axis=1)
            g = jnp.where(cn_mask, g, delta0)
            f = _gf2m_wht(jnp.moveaxis(g, 1, -1))  # [slots, B, q]
            f = f.reshape(code.m, code.dc_max, b, q)
            # exact exclusion via prefix/suffix products over the dc axis
            ones = jnp.ones((code.m, b, q), dtype)
            pre = [ones]
            for t in range(code.dc_max - 1):
                pre.append(pre[-1] * f[:, t])
            suf = [ones]
            for t in range(code.dc_max - 1, 0, -1):
                suf.append(suf[-1] * f[:, t])
            suf.reverse()
            excl = jnp.stack(
                [pre[t] * suf[t] for t in range(code.dc_max)], axis=1
            )
            s = _gf2m_wht(excl.reshape(code.m * code.dc_max, b, q))
            s = jnp.moveaxis(s, -1, 1)  # [slots, q, B]; inv WHT * q
            out = jnp.take_along_axis(s, post_idx[:, :, None], axis=1)
        out = jnp.maximum(out, 0.0)  # clip tiny negative rounding residue
        # log-domain output, UNNORMALIZED: the per-(slot, frame) scale is
        # constant over q, so the VN's max-subtraction and the decision
        # argmax are both invariant to it — the old sum+divide here and
        # the softmax divide in vn_update were pure overhead.
        return jnp.log(out + eps).astype(sdtype)

    def vn_update(c2v, log_pri):
        """c2v [M*dc_max, q, B] log-domain -> (v2c log, log_post).

        Column-major over the dv axis for small q (round 4, same argument
        as cn_update): each slot's exclusion-sum -> max-normalize -> f16
        chain fuses into its own output write instead of materializing
        the [n, dv, q, B] stack.  Identical sums/orders — bit-exact.
        Large q keeps the stacked form (GF(64) measured 35% SLOWER on the
        per-slot chains — the wide-q stacked max/normalize vectorizes
        better than dv separate passes).
        """
        b = c2v.shape[-1]
        g = _take_rows(c2v, vn_gather, vn_idx_flat if flat else None,
                       code.n * code.dv_max)  # [N*dv_max, q, B]
        logg = jnp.where(vn_mask, g.astype(dtype), jnp.zeros((), dtype))
        logg = logg.reshape(code.n, code.dv_max, q, b)
        zeros = jnp.zeros((code.n, q, b), dtype)
        pre = [zeros]
        for s in range(code.dv_max - 1):
            pre.append(pre[-1] + logg[:, s])
        suf = [zeros]
        for s in range(code.dv_max - 1, 0, -1):
            suf.append(suf[-1] + logg[:, s])
        suf.reverse()
        if q <= _FUSED_QMAX:
            outs = []
            for s in range(code.dv_max):
                excl = log_pri + pre[s] + suf[s]
                # max-normalize (exp ≤ 1 at the CN) — no divide, see
                # cn_update
                excl = excl - jnp.max(excl, axis=1, keepdims=True)
                outs.append(excl.astype(sdtype))
            v2c = jnp.stack(outs, axis=1).reshape(
                code.n * code.dv_max, q, b
            )
        else:
            excl = jnp.stack(
                [log_pri + pre[s] + suf[s] for s in range(code.dv_max)],
                axis=1,
            )
            excl = excl - jnp.max(excl, axis=2, keepdims=True)
            v2c = excl.astype(sdtype).reshape(code.n * code.dv_max, q, b)
        log_post = log_pri + jnp.sum(logg, axis=1)
        return v2c, log_post

    # int8 symbol planes (q ≤ 128): the ET symbol latch and the
    # per-iteration syndrome gather move [N, B] / [slots, B] planes
    # every round — int8 quarters that traffic vs int32, exactly
    # (values are field elements 0..q-1).  Same change as DD-BMP's
    # round-5 int8 decision planes.
    sym_dt = jnp.int8 if q <= 128 else jnp.int32

    def decide(log_post):
        return jnp.argmax(log_post, axis=1).astype(sym_dt)  # [N, B]

    # GF(2^m) multiplication by the CONSTANT per-slot coefficient is
    # GF(2)-LINEAR over the symbol's bit planes: h·z bit j = ⊕_i
    # bit_i(z)·M_h[j,i] with M_h[j,i] = bit_j(h·2^i).  Evaluating it as m²
    # masked XORs of [slots, B] planes replaces a per-(slot,frame)
    # elementwise table gather that dominated the early-termination loop
    # (the per-iteration syndrome cost — measured ~6x the whole fixed-trip
    # iteration on the real GF(4) (9000,6000) code).
    m_bits = q.bit_length() - 1
    # built with jnp (h_cn = code.cn_coef is a traced pytree leaf); the
    # per-slot table gathers run ONCE per decode, outside the loop
    mcols = [mul[h_cn, 1 << i] for i in range(m_bits)]  # [slots] each
    mconst = jnp.stack(
        [
            jnp.stack([(mcols[i] >> j) & 1 for i in range(m_bits)], axis=-1)
            for j in range(m_bits)
        ],
        axis=-2,
    ).astype(sym_dt)  # [slots, m(out j), m(in i)] 0/1
    syn_mask = code.cn_mask.reshape(-1).astype(sym_dt)[:, None]

    def syndrome_ok(symbols):
        """H·z == 0 over GF(q) for each frame (bit-plane linear form)."""
        b = symbols.shape[-1]
        s = jnp.take(symbols, code.cn_vn.reshape(-1), axis=0)  # [slots, B]
        sbits = [(s >> i) & 1 for i in range(m_bits)]
        hs = jnp.zeros_like(s)
        for j in range(m_bits):
            bit = jnp.zeros_like(s)
            for i in range(m_bits):
                bit = jnp.bitwise_xor(bit, sbits[i] * mconst[:, j, i][:, None])
            hs = hs | (bit << j)
        hs = hs * syn_mask
        hs = hs.reshape(code.m, code.dc_max, b)
        acc = jnp.zeros((code.m, b), hs.dtype)
        for t in range(code.dc_max):
            acc = jnp.bitwise_xor(acc, hs[:, t])
        return jnp.all(acc == 0, axis=0)

    def init(log_pri):
        # log_of pre-normalizes, so init is a PLAIN broadcast — the
        # streaming driver's lazy init-select then fuses into the step's
        # first read instead of materializing the full message plane
        b = log_pri.shape[-1]
        return jnp.broadcast_to(
            log_pri.astype(sdtype)[:, None], (code.n, code.dv_max, q, b)
        ).reshape(code.n * code.dv_max, q, b)

    def log_of(pri):
        # max-normalized log priors: every consumer (VN extrinsics,
        # posterior argmax) is invariant to the per-(symbol, frame)
        # constant up to float rounding on near-ties, and the v2c init
        # needs exactly this normalization
        lp = jnp.log(pri + eps)
        return lp - jnp.max(lp, axis=1, keepdims=True)

    return dict(
        cn_update=cn_update,
        vn_update=vn_update,
        decide=decide,
        syndrome_ok=syndrome_ok,
        init=init,
        log_of=log_of,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_iterations", "early_termination", "q", "storage_dtype"
    ),
)
def decode_nb_qspa(
    code: Code,
    priors: jax.Array,
    num_iterations: int,
    q: int = 0,
    early_termination: bool = True,
    storage_dtype=None,
) -> NBDecodeResult:
    """Batched FFT-QSPA decode.

    priors: [B, N, q] channel symbol probabilities (see channel.nb).
    q: field order (defaults to code.q).
    storage_dtype: optional narrower dtype (e.g. float16) for the message
    planes between updates; arithmetic stays in the prior dtype.  Messages
    live in the LOG domain between updates (round 3): the CN's max-
    normalized log output is exactly what the VN sums, and both per-
    (slot, frame) normalizations (the CN sum+divide and the softmax's
    divide) drop out by scale invariance — every remaining normalization
    is a max-subtraction, and each side performs exactly one exp and one
    log per edge.  Log-domain values sit in [log eps, ~q·dc], where the
    f16 ulp (≤0.03) is the same regime as binary BP's clamped-LLR f16
    storage (decoders/bp.py).
    """
    q = q or code.q
    pri = jnp.moveaxis(jnp.asarray(priors), 0, -1)  # [N, q, B]
    n, qq, b = pri.shape
    assert qq == q and n == code.n
    dtype = pri.dtype
    M = nb_qspa_machine(code, q, dtype, storage_dtype)
    log_pri = M["log_of"](pri)
    decide = M["decide"]
    syndrome_ok = M["syndrome_ok"]
    v2c0 = M["init"](log_pri)

    def step(v2c):
        c2v = M["cn_update"](v2c)
        v2c, log_post = M["vn_update"](c2v, log_pri)
        return v2c, decide(log_post)

    sym0 = decide(log_pri)
    if not early_termination:
        def body(_, st):
            return step(st[0])

        _v2c, sym = jax.lax.fori_loop(
            0, num_iterations, body, (v2c0, sym0)
        )
        iters = jnp.full((b,), num_iterations, jnp.int32)
        done = syndrome_ok(sym)
    else:
        # Mask ONLY the int32 symbol carry: frames are independent along
        # the batch, so the q-vector message state of satisfied frames may
        # keep evolving — the latched symbols are what the decoder
        # returns.  Masking v2c cost a full message-state read+write per
        # iteration (same finding as run_flooding_soft for binary BP).
        done0 = syndrome_ok(sym0)
        iters0 = done0.astype(jnp.int32) * 0

        def cond(carry):
            t, _v2c, _sym, _iters, done = carry
            return (t < num_iterations) & ~jnp.all(done)

        def body(carry):
            t, v2c, sym, iters, done = carry
            v2c_new, sym_new = step(v2c)
            act = ~done
            sym = _mask_last(act, sym_new, sym)
            iters = jnp.where(act, t + 1, iters)
            done = done | syndrome_ok(sym)
            return (t + 1, v2c_new, sym, iters, done)

        _t, _v2c, sym, iters, done = jax.lax.while_loop(
            cond, body, (jnp.int32(0), v2c0, sym0, iters0, done0)
        )
    return NBDecodeResult(
        symbols=sym.T.astype(jnp.int32), iterations=iters, satisfied=done
    )
