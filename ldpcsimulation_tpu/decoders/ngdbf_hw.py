"""NGDBFhw: bit-accurate fixed-point NGDBF mirroring the 10GBASE-T ASIC model.

Behavioral reference: ``C_implementations/src/NGDBFhw.cpp`` (compiled
manually, driven by ``scripts/demo_NGDBFhw_802_3.sh``).  Defaults are the
802.3an operating point hard-coded at ``:48-57``:
R=0.8413, w=0.185, Ymax=1.625, noiseScale=0.95, θ0=−0.525, NQ=5.

Integer domain (``:174-179, 640-703``):
  * ``qmax = 2^NQ``, ``lmax = Ymax/(2w)``, ``NL = qmax − 1``.
  * Sample quantizer ``quantize(y) = sgn(y)·floor(|y|·NL/(2·lmax))`` with the
    GDBF sign convention sgn(0) = −1; samples are stored sign-magnitude
    packed and *unpacked* as odd integers ``±(2·mag + 1)``
    (``pack``/``unpack``, ``:653-683``) — both modeled here by
    :func:`hw_quantize_int` producing the unpacked integer directly.
  * ``theta = unpack(pack(quantize(2), +1))`` and ``Smult = round(NL/lmax)``
    (``:178-179``) — integers fixed by (NQ, Ymax, w).

Channel & noise (``:218-252``):
  * ``y = x(1 + σn)`` clipped multiplicatively to ±Ymax; ``y' =
    quantize(y/(2w))``.
  * A 2648-entry noise ring is refilled per frame with
    ``(σ·noiseScale·n − θ0)/(2w) − 1`` clipped to ±lmax, quantized.  Bit i
    at iteration t reads ring[i + qpointer]; qpointer advances once per
    executed iteration and wraps at ``len − N`` (``:356-358``) — noise
    samples are *reused* across iterations with stride-1 shifts, a hardware
    cost-saving correlation structure this decoder reproduces exactly.
  * The reference's ``qpointer`` persists across frames/phases; here it is
    per-frame state starting at ``qpointer0`` (the ring is refilled per
    frame either way, so only the starting offset differs — configurable).

Decode (``:280-373, 546-593``):
  * d ∈ {0,1}; syndrome ∈ {0,1} with 0 = satisfied; early break per phase
    when all checks pass (checked at iteration start).
  * ``E_i = (1−2d_i)·y'_i + Smult·Σ_j(1 − s_j) + q'_{i+ptr}``; flip when
    ``E_i <= theta``.
  * All ``maxPhases`` phases always run (no phase-loop break); each resets
    ``d`` to the channel decisions and continues the noise stream.  The
    result keeps the minimum error count and minimum iteration count across
    phases independently (``:365-372``) — modeling P parallel hardware
    decoders (the "hard" decision output here is the best phase's d).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp

from ..codes.code import Code
from .base import vma_like
from .dense_ops import DenseGraph, dense_sat_sum_per_vn, dense_syndrome01

__all__ = [
    "NGDBFHwConfig",
    "NGDBFHwResult",
    "hw_quantize_int",
    "decode_ngdbf_hw",
]


def _floor_int(x):
    """floor to int — Python int for plain numbers, int32 array for traced
    values (the distributed operating-point grid passes w/ymax per mesh
    slot, so the integer-domain constants derive on-device)."""
    if isinstance(x, (int, float)):
        return int(math.floor(x))
    return jnp.floor(x).astype(jnp.int32)


@dataclasses.dataclass(frozen=True)
class NGDBFHwConfig:
    """Registered as a JAX pytree: nq/ring_len/loop bounds are static
    metadata; the operating-point scalars (w, ymax, noise_scale, theta0)
    are pytree DATA — Python floats for single runs or traced arrays under
    the distributed operating-point grid (tools/sweep.py --distributed).
    The derived integer-domain constants (theta_int, smult) follow suit.
    """

    num_iterations: int = 600
    w: float = 0.185
    ymax: float = 1.625
    noise_scale: float = 0.95
    theta0: float = -0.525
    nq: int = 5
    max_phases: int = 1
    ring_len: int = 2648

    @property
    def lmax(self):
        return self.ymax / (2.0 * self.w)

    @property
    def nl(self) -> int:
        return 2 ** self.nq - 1

    @property
    def theta_int(self):
        """unpack(pack(quantize(2), +1)) — NGDBFhw.cpp:178."""
        mag = _floor_int(2.0 * self.nl / (2.0 * self.lmax))
        return 2 * mag + 1

    @property
    def smult(self):
        """round(NL/lmax) — NGDBFhw.cpp:179 (C round: half away from 0)."""
        return _floor_int(self.nl / self.lmax + 0.5)


jax.tree_util.register_dataclass(
    NGDBFHwConfig,
    data_fields=["w", "ymax", "noise_scale", "theta0"],
    meta_fields=["num_iterations", "nq", "max_phases", "ring_len"],
)


def hw_graph_ops(code: Code, qc=None, dense: Optional[DenseGraph] = None):
    """(syndrome01, satsum) graph operations for the NGDBFhw update,
    shared by the batch decoder and the streaming adapter.

    syndrome01(d {0,1} [N, B]) -> [M, B] {0,1}, 0 = satisfied
    (NGDBFhw.cpp:546-563); satsum(syn) -> [N, B] count of SATISFIED
    neighbor checks per variable (the Smult·Σ(1−s) term, ``:565-593``).
    """
    n = code.n

    def syndrome01(d):
        if dense is not None:
            return dense_syndrome01(dense, d)
        if qc is not None:
            from .qc_ops import qc_syndrome_bipolar

            return (1 - qc_syndrome_bipolar(qc, 1 - 2 * d)) // 2
        vals = jnp.take(
            1 - 2 * d, code.cn_vn.reshape(-1), axis=0
        ).reshape(code.m, code.dc_max, d.shape[-1])
        vals = jnp.where(
            code.cn_mask[:, :, None], vals, jnp.ones_like(vals)
        )
        prod = jnp.prod(vals, axis=1)
        return (1 - prod) // 2

    def satsum(syn):
        if dense is not None:
            return dense_sat_sum_per_vn(dense, syn)
        if qc is not None:
            from .qc_ops import qc_syndrome_sum_per_vn

            unsat = qc_syndrome_sum_per_vn(qc, syn)
            return (code.vn_deg[:, None] - unsat).astype(jnp.int32)
        sat_neighbors = jnp.take(
            1 - syn, code.vn_cn.reshape(-1), axis=0
        ).reshape(n, code.dv_max, syn.shape[-1])
        sat_neighbors = jnp.where(
            code.vn_mask[:, :, None],
            sat_neighbors,
            jnp.zeros_like(sat_neighbors),
        )
        return jnp.sum(sat_neighbors, axis=1)

    return syndrome01, satsum


def hw_quantize_int(x, nl: float, lmax: float):
    """quantize+pack+unpack fused: ±(2·floor(|x|·NL/(2·lmax)) + 1).

    Sign is the GDBF convention (x=0 → −1).  Input is expected pre-clipped
    to ±lmax so the magnitude fits NQ−1 bits.
    """
    x = jnp.asarray(x)
    mag = jnp.floor(jnp.abs(x) * nl / (2.0 * lmax)).astype(jnp.int32)
    sign = jnp.where(x > 0, 1, -1).astype(jnp.int32)
    return sign * (2 * mag + 1)


@dataclasses.dataclass
class NGDBFHwResult:
    """hard [B,N] ±1 bipolar, from the phase with least errors;
    iterations [B] = least iterations over phases; satisfied [B] = last
    phase's syndrome state; least_errors [B] vs the true codeword;
    qpointer [B] = the ring pointer at exit — the reference's ``qpointer``
    persists across frames (declared outside the frame loop,
    ``NGDBFhw.cpp:153``, wrapped only at ``:356-358``), so a run that
    reproduces that persistence feeds this back as the next frame's
    ``qpointer0`` (per batch lane; see harness/montecarlo.simulate's
    ``stateful_decode``)."""

    hard: jax.Array
    iterations: jax.Array
    satisfied: jax.Array
    least_errors: jax.Array
    qpointer: jax.Array


jax.tree_util.register_dataclass(
    NGDBFHwResult,
    data_fields=[
        "hard", "iterations", "satisfied", "least_errors", "qpointer"
    ],
    meta_fields=[],
)


@functools.partial(jax.jit, static_argnames=("qc",))
def decode_ngdbf_hw(
    code: Code,
    y: jax.Array,
    sigma: float,
    cfg: NGDBFHwConfig,
    key: jax.Array,
    true_bits: Optional[jax.Array] = None,
    qpointer0: Optional[jax.Array] = None,
    ring_noise: Optional[jax.Array] = None,
    dense: Optional[DenseGraph] = None,
    qc=None,
) -> NGDBFHwResult:
    """Batched fixed-point NGDBF decode.

    y: [B, N] raw channel samples (the decoder applies the reference's own
    clipping and quantization).  true_bits: [B, N] transmitted bits for the
    least-errors-across-phases selection (all-zero if None, the reference's
    default).  qpointer0: [B] initial ring offsets (0 if None).
    ring_noise: optional [ring_len, B] pre-drawn raw noise samples
    (σ·noiseScale·n) for replay/cross-validation; overrides the key draw.
    dense: optional :class:`.dense_ops.DenseGraph` of the SAME code —
    matmul graph ops (bit-identical; the path for the real 802.3an H,
    which has no circulant structure).
    qc: optional :class:`..codes.qc.QCCode` structure of the SAME code —
    static-roll graph ops (bit-identical; the fast path for QC codes too
    large for a dense H, e.g. DVB-S2-sized).  Mutually exclusive with
    ``dense``.
    """
    if dense is not None and (dense.n != code.n or dense.m != code.m):
        raise ValueError("dense graph does not match code dimensions")
    if qc is not None:
        if dense is not None:
            raise ValueError("pass either qc or dense, not both")
        if qc.n != code.n or qc.m != code.m:
            raise ValueError("qc structure does not match code dimensions")
    y_t = jnp.asarray(y, jnp.float32).T  # [N, B]
    n, b = y_t.shape
    T = cfg.num_iterations
    lmax, nl = cfg.lmax, cfg.nl
    theta = cfg.theta_int
    smult = cfg.smult
    ring_mod = cfg.ring_len - n
    if ring_mod <= 0:
        raise ValueError("ring_len must exceed code length")

    # channel clip + quantize (NGDBFhw.cpp:218-237)
    y_clip = jnp.where(
        jnp.abs(y_t) > cfg.ymax,
        y_t * (cfg.ymax / jnp.abs(y_t)),
        y_t,
    )
    r = jnp.where(y_clip > 0, 1, -1).astype(jnp.int32)
    d_init = (1 - r) // 2  # {0,1}
    yint = hw_quantize_int(y_clip / (2.0 * cfg.w), nl, lmax)  # [N, B] int32

    # noise ring (NGDBFhw.cpp:239-252), refilled once per frame
    if ring_noise is not None:
        qn = jnp.asarray(ring_noise, jnp.float32)
    else:
        qn = sigma * cfg.noise_scale * jax.random.normal(
            key, (cfg.ring_len, b), jnp.float32
        )
    qmod = (qn - cfg.theta0) / (2.0 * cfg.w) - 1.0
    qmod = jnp.clip(qmod, -lmax, lmax)
    qint = hw_quantize_int(qmod, nl, lmax)  # [ring_len, B] int32

    if true_bits is None:
        c_bits = jnp.zeros((n, b), jnp.int32)
    else:
        c_bits = jnp.asarray(true_bits, jnp.int32).T
    qptr0 = (
        jnp.zeros((b,), jnp.int32)
        if qpointer0 is None
        else jnp.asarray(qpointer0, jnp.int32)
    )

    row_iota = jax.lax.broadcasted_iota(jnp.int32, (n, b), 0)

    syndrome01, _satsum = hw_graph_ops(code, qc, dense)

    init = dict(
        d=d_init,
        qptr=vma_like(qptr0, d_init),
        frozen=vma_like(jnp.zeros((b,), bool), d_init),
        least_iters=vma_like(jnp.full((b,), T, jnp.int32), d_init),
        least_errs=vma_like(jnp.full((b,), n, jnp.int32), d_init),
        best_d=d_init,
        phase_iters=vma_like(jnp.full((b,), T, jnp.int32), d_init),
    )

    def phase_end(st):
        """Close out a phase: record least errors/iterations, keep best d."""
        errs = jnp.sum(st["d"] != c_bits, axis=0).astype(jnp.int32)
        better = errs < st["least_errs"]
        return dict(
            st,
            least_errs=jnp.where(better, errs, st["least_errs"]),
            best_d=jnp.where(better[None, :], st["d"], st["best_d"]),
            least_iters=jnp.minimum(st["least_iters"], st["phase_iters"]),
        )

    def body(s, st):
        it = s % T
        # phase start: reset d and per-phase bookkeeping
        is_start = it == 0

        def start_phase(st):
            st = jax.lax.cond(s > 0, phase_end, lambda x: x, st)
            return dict(
                st,
                d=d_init,
                frozen=vma_like(jnp.zeros((b,), bool), d_init),
                phase_iters=vma_like(jnp.full((b,), T, jnp.int32), d_init),
            )

        st = jax.lax.cond(is_start, start_phase, lambda x: x, st)

        syn = syndrome01(st["d"])  # [M, B]
        satisfied = jnp.all(syn == 0, axis=0)
        newly = ~st["frozen"] & satisfied
        phase_iters = jnp.where(newly, it, st["phase_iters"])
        frozen = st["frozen"] | satisfied
        act = ~frozen

        # symbol update (NGDBFhw.cpp:565-593)
        ssum = _satsum(syn)  # [N, B]
        if cfg.max_phases == 1 and qpointer0 is None:
            # Single phase: a frame's qpointer only diverges from the global
            # iteration count after it freezes, and frozen frames never use
            # their noise values — so ring access is an exact contiguous
            # slice (take_along_axis is ~40x more expensive here).
            qvals = jax.lax.dynamic_slice_in_dim(
                qint, it % ring_mod, n, axis=0
            )
        else:
            qidx = row_iota + st["qptr"][None, :]
            qvals = jnp.take_along_axis(qint, qidx, axis=0)
        e = (1 - 2 * st["d"]) * yint + ssum * smult + qvals
        flip = e <= theta
        d = jnp.where(act[None, :] & flip, 1 - st["d"], st["d"])

        # qpointer advances once per executed iteration (NGDBFhw.cpp:356-358)
        qptr = jnp.where(act, (st["qptr"] + 1) % ring_mod, st["qptr"])

        return dict(
            st,
            d=d,
            qptr=qptr,
            frozen=frozen,
            phase_iters=phase_iters,
        )

    st = jax.lax.fori_loop(0, cfg.max_phases * T, body, init)
    # `frozen` of the final phase == the reference's `satisfied` flag at exit
    # (true iff the last phase's inner loop broke on its syndrome check)
    satisfied = st["frozen"]
    st = phase_end(st)

    return NGDBFHwResult(
        hard=(1 - 2 * st["best_d"]).T,
        iterations=st["least_iters"],
        satisfied=satisfied,
        least_errors=st["least_errs"],
        qpointer=st["qptr"],
    )
