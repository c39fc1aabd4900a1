"""GDBF / NGDBF gradient-descent bit-flipping family.

One configuration dataclass replaces the reference's compile-time ``-D`` flag
matrix (``C_implementations/Makefile:24-56`` builds 9 binaries from
``decodeGDBF.cpp``/``RNGDBF.cpp``); see :data:`PRESETS` for the exact flag
sets of each reference binary.

Behavioral reference (``C_implementations/src/decodeGDBF.cpp``, and
``RNGDBF.cpp`` for redecode):
  * CN update (``:517-534``): bipolar syndrome product over each row of the
    current hard decisions; decode ends early when all checks are satisfied
    — the syndrome test runs at the *start* of each iteration
    (``:300-306``), so the reported iteration count is the loop index at
    break.
  * VN flip metric (``:536-560``): ``E_i = d_i·y_i + Σ_j w·s_j [+ q_i]``
    with ``w = alpha`` iff weight_syndromes (``:548-551``).
  * Parallel mode flips every ``E_i < θ_i`` (``:599-603``); sequential mode
    flips only the argmin (strict ``<`` scan → first minimum, ``:604-620``).
  * Threshold adaptation (``:612-617``): θ_i ← θ_i·λ when the bit did NOT
    flip; unchanged on flip.  In sequential mode the reference's transient
    ``flip`` flag is set for every *running-minimum candidate* during the
    scan — bits whose E beat all earlier bits — which this implementation
    reproduces with an exclusive prefix-min.
  * Mode switching (``:309-346,624-633``): objective
    ``f = Σ d_i·y_i + Σ s_j`` evaluated before and after the flip step
    (with the *stale* syndrome both times); if f did not improve, the frame
    drops permanently to sequential mode (``mu = 0``), active for
    ``it > Tswitch``.
  * Output smoothing (``:348-367``): within the last ``windowsize-1``
    iterations (``it > T − windowsize``), accumulate d; if the frame ends
    unsatisfied, output ``sign(Σd)`` with 0 → −1.
  * Stochastic variant (``quantizeProbabilities``, ``:562-597``): flip
    probability ``Φ((θ_i − E_i)/σ')`` snapped to the nearest of 8 hardware
    levels (squared distance, first minimum wins), then a Bernoulli draw.
  * Noise perturbation (``:318-333``): fresh per-bit per-iteration Gaussian
    ``σ' = σ·noiseScale`` (or uniform of matched variance), optional
    first-order noise shaping.
  * Redecode (``RNGDBF.cpp:277-404``): up to ``maxphase`` restarts from the
    channel hard decisions with fresh noise; iteration counts accumulate
    across phases; phase histogram recorded.

Decoder-internal noise correlation structures differ across the reference's
three NGDBF implementations (fresh per-bit here; a reused ring buffer in
``NGDBFhw.cpp:356-358``; a shift-register chain in SystemC ``decoder.h``) —
the latter two are modeled by :mod:`.ngdbf_hw`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..codes.code import Code
from ..codes.qc import QCCode
from .base import syndrome_from_hard, vma_like
from .dense_ops import (
    DenseGraph,
    dense_syndrome_bipolar,
    dense_syndrome_sum_per_vn,
)
from .qc_ops import qc_syndrome_bipolar, qc_syndrome_sum_per_vn

__all__ = ["GDBFConfig", "GDBFResult", "decode_gdbf", "PRESETS", "preset"]

# Hardware-realizable flip probabilities from AND/OR-combined Bernoulli
# streams (decodeGDBF.cpp:564-575; enumerated by prob_combinations.m).
PR_LEVELS = (0.0, 0.0625, 0.125, 0.25, 0.34375, 0.4106, 0.68359, 1.0)


@dataclasses.dataclass(frozen=True)
class GDBFConfig:
    """Configuration = the reference's -D flag set + argv scalars.

    Registered as a JAX pytree: the flag set and loop bounds are static
    metadata (they select the compiled program), while the five
    operating-point scalars (theta, noise_scale, lam, alpha, weight_ymax)
    are pytree DATA — they may be Python floats (single runs; one compile
    serves every value) or traced arrays (the distributed operating-point
    grid runs many parameter points concurrently, each mesh slot reading
    its own scalars — tools/sweep.py --distributed)."""

    num_iterations: int
    theta: float
    # flag: sequentialmode (mu = 0 from the start)
    sequential: bool = False
    # flag: modeswitching (+ Tswitch, a global fixed at 0 in the reference)
    mode_switching: bool = False
    t_switch: int = 0
    # flag: addNoise (+ uniformNoise / noiseShaping sub-flags)
    add_noise: bool = False
    uniform_noise: bool = False
    noise_shaping: bool = False
    noise_scale: float = 1.0
    # flag: thresholdAdaptation
    threshold_adaptation: bool = False
    lam: float = 0.991
    # flag: weightSyndromes
    weight_syndromes: bool = False
    alpha: float = 2.25
    # RNGDBF.cpp:564-566 kept the OLD weight semantics w = alpha*Ymax/dv_i
    # (per-node), which decodeGDBF.cpp:548-551 later replaced with the
    # global w = alpha (the "/*Ymax/dv" is commented out there).  The
    # redecode binary therefore weights differently from every other GDBF
    # binary at the same alpha; set legacy_weight for RNGDBF parity.
    legacy_weight: bool = False
    weight_ymax: float = 2.5
    # flag: outputSmoothing
    output_smoothing: bool = False
    window_size: int = 64
    # flag: quantizeProbabilities (stochastic NGDBF)
    quantize_probabilities: bool = False
    # redecode (RNGDBF.cpp): number of phases; 1 = plain single decode
    max_phases: int = 1


jax.tree_util.register_dataclass(
    GDBFConfig,
    data_fields=["theta", "noise_scale", "lam", "alpha", "weight_ymax"],
    meta_fields=[
        "num_iterations", "sequential", "mode_switching", "t_switch",
        "add_noise", "uniform_noise", "noise_shaping",
        "threshold_adaptation", "weight_syndromes", "legacy_weight",
        "output_smoothing", "window_size", "quantize_probabilities",
        "max_phases",
    ],
)


# The reference Makefile's binary -> flag-set registry
# (C_implementations/Makefile:24-56).
PRESETS = {
    "GDBF": dict(),
    "MGDBF": dict(mode_switching=True),
    "SGDBF": dict(sequential=True),
    "SMGDBF": dict(output_smoothing=True),
    "ATGDBF": dict(threshold_adaptation=True),
    "SATGDBF": dict(threshold_adaptation=True, output_smoothing=True),
    "MNGDBF": dict(
        add_noise=True, threshold_adaptation=True, weight_syndromes=True
    ),
    "SMNGDBF": dict(
        add_noise=True,
        threshold_adaptation=True,
        weight_syndromes=True,
        output_smoothing=True,
    ),
    "StochasticNGDBF": dict(quantize_probabilities=True, weight_syndromes=True),
    "RSMNGDBF": dict(
        add_noise=True,
        threshold_adaptation=True,
        weight_syndromes=True,
        output_smoothing=True,
        max_phases=7,
        legacy_weight=True,  # RNGDBF.cpp:566 (see GDBFConfig)
    ),
}


def preset(name: str, num_iterations: int, theta: float, **overrides) -> GDBFConfig:
    """Config matching a reference binary by name (e.g. "SMNGDBF")."""
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return GDBFConfig(num_iterations=num_iterations, theta=theta, **kw)


@dataclasses.dataclass
class GDBFResult:
    """hard [B,N] ±1; iterations [B] (accumulated across redecode phases);
    satisfied [B]; phases [B] (RNGDBF phase_hist source, = attempted phases);
    smoothing_used [B] (per-frame count of phases that entered the smoothing
    window — reference's ``smoothingUsed`` aggregates this)."""

    hard: jax.Array
    iterations: jax.Array
    satisfied: jax.Array
    phases: jax.Array
    smoothing_used: jax.Array


jax.tree_util.register_dataclass(
    GDBFResult,
    data_fields=["hard", "iterations", "satisfied", "phases", "smoothing_used"],
    meta_fields=[],
)


def _syndrome_sum_per_vn(code: Code, syn: jax.Array) -> jax.Array:
    """[M, B] bipolar syndromes -> [N, B] per-variable neighbor sums."""
    g = jnp.take(syn, code.vn_cn.reshape(-1), axis=0).reshape(
        code.n, code.dv_max, -1
    )
    g = jnp.where(code.vn_mask[:, :, None], g, jnp.zeros_like(g))
    return jnp.sum(g, axis=1)


def flip_decisions(cfg: GDBFConfig, e, thetas, mu, noise_sigma, rnum):
    """(flip, flip_for_adapt) masks from the flip metric ``e`` [N, B].

    The flip-rule block shared verbatim by the batched decoder and the
    streaming harness (``decodeGDBF.cpp:562-620``):

      * stochastic (``quantizeProbabilities``): flip probability
        ``Φ((θ_i − E_i)/σ')`` snapped to the nearest of the 8 hardware
        levels (squared distance, first minimum wins), Bernoulli via the
        caller-supplied uniforms ``rnum`` [N, B];
      * parallel mode: flip every ``E_i < θ_i``;
      * sequential mode (``mu == 0``): flip only the argmin (first
        minimum, strict ``<`` scan), with the reference's transient
        running-minimum candidate flags driving threshold adaptation
        (exclusive prefix-min).
    """
    dtype = e.dtype
    n, b = e.shape
    if cfg.quantize_probabilities:
        pcdf = jax.scipy.stats.norm.cdf((thetas - e) / noise_sigma)
        levels = jnp.asarray(PR_LEVELS, dtype)
        dist = (levels[None, None, :] - pcdf[:, :, None]) ** 2
        # strict < scan with min_dist initialized to 1 -> first minimum
        # wins, and a distance of exactly 1 keeps index 0
        lvl_idx = jnp.argmin(jnp.where(dist < 1.0, dist, 1.0), axis=-1)
        p_flip = levels[lvl_idx]
        flip = rnum < p_flip
        return flip, flip
    flip_par = e < thetas
    # sequential: argmin of E (first minimum, strict < scan)
    amin = jnp.argmin(e, axis=0)  # [B]
    one_hot = (
        jax.lax.broadcasted_iota(jnp.int32, (n, b), 0) == amin[None, :]
    )
    # transient running-minimum flags (exclusive prefix-min) drive
    # threshold adaptation in sequential mode
    run_min = jax.lax.associative_scan(jnp.minimum, e, axis=0)
    excl_min = jnp.concatenate(
        [jnp.full((1, b), jnp.inf, dtype), run_min[:-1]], axis=0
    )
    flip_seq_trans = e < excl_min
    is_par = (mu == 1)[None, :]
    flip = jnp.where(is_par, flip_par, one_hot)
    flip_for_adapt = jnp.where(is_par, flip_par, flip_seq_trans)
    return flip, flip_for_adapt


@functools.partial(jax.jit, static_argnames=("qc", "trace"))
def decode_gdbf(
    code: Code,
    yq: jax.Array,
    sigma: float,
    cfg: GDBFConfig,
    key: Optional[jax.Array] = None,
    perturbations: Optional[jax.Array] = None,
    qc: Optional[QCCode] = None,
    stoch_uniforms: Optional[jax.Array] = None,
    dense: Optional[DenseGraph] = None,
    trace: bool = False,
) -> GDBFResult:
    """Batched GDBF-family decode.

    yq: [B, N] channel samples, already saturated/quantized per the variant
    (the reference saturates then quantizes in main(), decodeGDBF.cpp:250-267).
    sigma: channel noise std-dev; internal perturbation uses sigma*noise_scale.
    key: RNG for perturbation / stochastic flips (required if the config uses
    randomness).
    perturbations: optional [max_phases*T, N, B] pre-drawn perturbation
    sequence (replay/trace tooling and exact cross-validation); overrides the
    on-the-fly draw, bypassing uniform/shaping transforms.
    qc: optional QC structure of the SAME code — switches the two graph
    operations (syndrome, per-VN syndrome sum) to static rolls
    (bit-identical, no dynamic gathers).
    dense: optional :class:`.dense_ops.DenseGraph` of the SAME code —
    switches the two graph operations to matmuls (bit-identical; the
    fast path for unstructured codes like the 802.3an RS-LDPC where no
    circulant structure exists).  Ignored when ``qc`` is given.
    stoch_uniforms: optional [max_phases*T, N, B] pre-drawn uniform(0,1)
    draws for the stochastic flip decisions (replay/cross-validation).
    trace: when True, run the full step budget under lax.scan and return
    ``(result, d_steps)`` with ``d_steps`` the [max_phases*T, N, B] ±1
    decision state after every step (tools/replay.py's O(T) trace source).
    """
    if qc is not None and (qc.n != code.n or qc.m != code.m):
        raise ValueError("qc structure does not match code dimensions")
    if dense is not None and (dense.n != code.n or dense.m != code.m):
        raise ValueError("dense graph does not match code dimensions")
    if (
        (cfg.add_noise and perturbations is None)
        or (cfg.quantize_probabilities and stoch_uniforms is None)
    ) and key is None:
        raise ValueError("this GDBF config needs an RNG key")
    if key is None:
        key = jax.random.key(0)

    y_t = jnp.asarray(yq).T  # [N, B]
    dtype = y_t.dtype
    n, b = y_t.shape
    T = cfg.num_iterations
    total_steps = cfg.max_phases * T
    noise_sigma = jnp.asarray(sigma * cfg.noise_scale, dtype)
    if cfg.weight_syndromes and cfg.legacy_weight:
        # RNGDBF.cpp:564-566: per-node w_i = alpha*Ymax/dv_i
        w = (
            cfg.alpha * cfg.weight_ymax / code.vn_deg.astype(dtype)
        )[:, None]
    else:
        w = jnp.asarray(cfg.alpha if cfg.weight_syndromes else 1.0, dtype)
    theta0 = jnp.asarray(cfg.theta, dtype)
    mu0 = jnp.int32(0 if cfg.sequential else 1)

    # Channel hard decisions: the reference takes sgn BEFORE quantization
    # (decodeGDBF.cpp:259-267 — r from the saturated y, then yq=quantize).
    # Quantizers with a zero level (quantize_round at small NQ) emit signed
    # zeros, so signbit recovers the pre-quantization sign exactly; a plain
    # y>0 test would misread +0.0 as negative and mis-init ~15% of bits.
    r = jnp.where(jnp.signbit(y_t), -1, 1).astype(jnp.int32)

    def fresh_phase_state():
        return dict(
            d=r,
            thetas=vma_like(jnp.full((n, b), theta0, dtype), r),
            dsum=vma_like(jnp.zeros((n, b), jnp.int32), r),
            mu=vma_like(jnp.full((b,), mu0, jnp.int32), r),
        )

    init = dict(
        step=jnp.int32(0),
        **fresh_phase_state(),
        noise_prev=vma_like(jnp.zeros((n, b), dtype), r),
        done=vma_like(jnp.zeros((b,), bool), r),
        iters=vma_like(jnp.full((b,), total_steps, jnp.int32), r),
        phases=vma_like(jnp.full((b,), cfg.max_phases, jnp.int32), r),
        smooth_used=vma_like(jnp.zeros((b,), jnp.int32), r),
        sat_at_exit=vma_like(jnp.zeros((b,), bool), r),
    )

    def cond(st):
        return (st["step"] < total_steps) & ~jnp.all(st["done"])

    def body(st):
        step = st["step"]
        phase = step // T
        it = step % T
        act = ~st["done"]  # [B]

        # --- phase start: reset per-phase state for active frames
        # (RNGDBF.cpp:280-308; for phase 0 this matches main()'s init)
        is_phase_start = it == 0
        def reset(cur, fresh):
            take = is_phase_start & act
            return jnp.where(
                take[None, :] if cur.ndim == 2 else take, fresh, cur
            )
        fresh = fresh_phase_state()
        d = reset(st["d"], fresh["d"])
        thetas = reset(st["thetas"], fresh["thetas"])
        dsum = reset(st["dsum"], fresh["dsum"])
        mu = reset(st["mu"], fresh["mu"])
        # smoothingUsed counting for the phase that just COMPLETED all T
        # iterations without satisfying (it == T > T - windowsize always):
        smooth_used = st["smooth_used"]
        if cfg.output_smoothing:
            completed_full_phase = is_phase_start & act & (phase > 0)
            smooth_used = smooth_used + completed_full_phase.astype(jnp.int32)

        # --- syndrome check at iteration start (decodeGDBF.cpp:300-306)
        if qc is not None:
            syn = qc_syndrome_bipolar(qc, d)  # [M, B] bipolar
        elif dense is not None:
            syn = dense_syndrome_bipolar(dense, d)
        else:
            syn = syndrome_from_hard(code, d)
        satisfied = jnp.all(syn > 0, axis=0)
        newly = act & satisfied
        iters = jnp.where(newly, step, st["iters"])
        phases = jnp.where(newly, phase + 1, st["phases"])
        if cfg.output_smoothing:
            smooth_used = smooth_used + (
                newly & (it > T - cfg.window_size)
            ).astype(jnp.int32)
        done = st["done"] | satisfied
        sat_at_exit = st["sat_at_exit"] | newly
        act = ~done

        # --- mode switching: f1 before flips (stale syndrome)
        syn_sum = jnp.sum(syn, axis=0).astype(dtype)  # [B]
        if cfg.mode_switching:
            f1 = jnp.sum(d.astype(dtype) * y_t, axis=0) + syn_sum

        # --- perturbation (fresh per bit per iteration)
        pert = jnp.zeros((n, b), dtype)
        noise_prev = st["noise_prev"]
        if cfg.add_noise:
            if perturbations is not None:
                pert = jax.lax.dynamic_index_in_dim(
                    perturbations, step, axis=0, keepdims=False
                )
            else:
                knoise = jax.random.fold_in(key, step)
                if cfg.uniform_noise:
                    u = jax.random.uniform(knoise, (n, b), dtype)
                    sample = (
                        jnp.sqrt(3.0).astype(dtype) * noise_sigma * 2.0 * (u - 0.5)
                    )
                else:
                    sample = noise_sigma * jax.random.normal(knoise, (n, b), dtype)
                if cfg.noise_shaping:
                    pert = sample - noise_prev
                    noise_prev = jnp.where(act[None, :], sample, noise_prev)
                else:
                    pert = sample

        # --- flip metric E_i (decodeGDBF.cpp:536-560)
        if qc is not None:
            syn_sum_vn = qc_syndrome_sum_per_vn(qc, syn.astype(dtype))
        elif dense is not None:
            syn_sum_vn = dense_syndrome_sum_per_vn(dense, syn)
        else:
            syn_sum_vn = _syndrome_sum_per_vn(code, syn)
        e = d.astype(dtype) * y_t + w * syn_sum_vn + pert

        # --- flip decisions (decodeGDBF.cpp:562-620, shared block)
        if cfg.quantize_probabilities:
            if stoch_uniforms is not None:
                rnum = jax.lax.dynamic_index_in_dim(
                    stoch_uniforms, step, axis=0, keepdims=False
                )
            else:
                kflip = jax.random.fold_in(jax.random.fold_in(key, step), 7)
                rnum = jax.random.uniform(kflip, (n, b), dtype)
        else:
            rnum = None
        flip, flip_for_adapt = flip_decisions(
            cfg, e, thetas, mu, noise_sigma, rnum
        )

        d = jnp.where(act[None, :] & flip, -d, d)

        # --- threshold adaptation (decodeGDBF.cpp:612-617)
        if cfg.threshold_adaptation:
            thetas = jnp.where(
                act[None, :] & ~flip_for_adapt, thetas * cfg.lam, thetas
            )

        # --- mode switch decision: f2 with new d, stale syndrome
        if cfg.mode_switching:
            f2 = jnp.sum(d.astype(dtype) * y_t, axis=0) + syn_sum
            drop = act & (it > cfg.t_switch) & (f1 >= f2)
            mu = jnp.where(drop, 0, mu)

        # --- output smoothing accumulation (decodeGDBF.cpp:348-354)
        if cfg.output_smoothing:
            in_window = it > T - cfg.window_size
            dsum = jnp.where(act[None, :] & in_window, dsum + d, dsum)

        return dict(
            step=step + 1,
            d=d,
            thetas=thetas,
            dsum=dsum,
            mu=mu,
            noise_prev=noise_prev,
            done=done,
            iters=iters,
            phases=phases,
            smooth_used=smooth_used,
            sat_at_exit=sat_at_exit,
        )

    if trace:
        # Instrumented mode: one lax.scan over the full step budget,
        # emitting the post-update decisions of every step (frozen frames
        # keep their state, matching the while_loop semantics exactly).
        # O(T) — replaces the old O(T²) re-decode-with-growing-caps trace.
        def scan_body(st, _):
            st2 = jax.lax.cond(cond(st), body, lambda s: s, st)
            return st2, st2["d"]

        st, d_steps = jax.lax.scan(scan_body, init, None, length=total_steps)
    else:
        st = jax.lax.while_loop(cond, body, init)

    d = st["d"]
    satisfied = st["sat_at_exit"]
    smooth_used = st["smooth_used"]
    if cfg.output_smoothing:
        # final phase of never-satisfied frames ran all T iterations
        smooth_used = smooth_used + (~satisfied).astype(jnp.int32)
        # apply smoothing to unsatisfied frames (decodeGDBF.cpp:358-367)
        d_smoothed = jnp.where(st["dsum"] > 0, 1, -1).astype(jnp.int32)
        d = jnp.where(~satisfied[None, :], d_smoothed, d)

    result = GDBFResult(
        hard=d.T,
        iterations=st["iters"],
        satisfied=satisfied,
        phases=st["phases"],
        smoothing_used=smooth_used,
    )
    if trace:
        return result, d_steps  # d_steps: [total_steps, N, B] ±1
    return result
