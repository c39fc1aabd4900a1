"""Deterministic frame replay with per-iteration traces.

Reference counterpart: the record/replay pair
``newstat.cpp`` (``recordRanState`` — GSL RNG state snapshots per frame,
``:783-791``) + ``replayGDBF.cpp`` (``loadRanState`` ``:771-779``, trace
files of decisions and check messages per iteration ``:316-373``).

Here replay needs no state files: every frame's channel noise is a pure
function of (seed, batch index, frame index), and the decoder's internal
randomness (GDBF perturbations / stochastic flip uniforms) is a pure
function of (batch decode key, iteration, frame index) — the original
batched decode draws ``[N, B]`` blocks per iteration
(``gdbf.py:326-343``), so :func:`replay_decoder_randomness` re-derives
the replayed frame's column from the SAME batch-shaped draws and injects
it via ``decode_gdbf``'s ``perturbations``/``stoch_uniforms`` arguments.
A B=1 re-decode with fresh draws would see different noise than the
frame saw inside its batch.  ``trace_gdbf`` re-runs a single frame
capturing the per-iteration decisions and bipolar syndromes — the data
``errtopng`` renders (``errtopng.cpp:28-110``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.code import Code
from ..decoders.base import syndrome_from_hard
from ..decoders.gdbf import GDBFConfig, decode_gdbf
from ..harness.montecarlo import draw_channel

__all__ = [
    "replay_channel",
    "replay_decoder_randomness",
    "trace_gdbf",
    "write_trace",
]


def replay_decoder_randomness(
    n: int,
    cfg: GDBFConfig,
    kdec: jax.Array,
    batch_size: int,
    frame_index: int,
    sigma: float,
    dtype=jnp.float32,
):
    """Re-derive one frame's decoder-internal random stream.

    Returns ``(perturbations, stoch_uniforms)`` shaped ``[steps, N, 1]``
    (or None where the config draws none), bit-identical to what column
    ``frame_index`` of a ``batch_size``-wide decode saw: the decoder draws
    ``[N, B]`` per iteration with ``knoise = fold_in(key, step)`` /
    ``kflip = fold_in(fold_in(key, step), 7)`` (gdbf.py:326-343, 368-371),
    so the batch shape is part of the stream and must be reproduced.
    Noise shaping (``pert_t = sample_t - sample_{t-1}`` while active) is
    applied here because the injection path bypasses it.
    """
    steps = cfg.max_phases * cfg.num_iterations
    ns = jnp.asarray(sigma * cfg.noise_scale, dtype)
    pert = None
    stoch = None
    if cfg.add_noise:

        @jax.jit
        def build_pert():
            def body(_, step):
                k = jax.random.fold_in(kdec, step)
                if cfg.uniform_noise:
                    u = jax.random.uniform(k, (n, batch_size), dtype)
                    s = jnp.sqrt(3.0).astype(dtype) * ns * 2.0 * (u - 0.5)
                else:
                    s = ns * jax.random.normal(k, (n, batch_size), dtype)
                return None, s[:, frame_index]

            _, cols = jax.lax.scan(body, None, jnp.arange(steps))
            return cols

        cols = build_pert()
        if cfg.noise_shaping:
            prev = jnp.concatenate(
                [jnp.zeros((1, n), dtype), cols[:-1]], axis=0
            )
            cols = cols - prev
        pert = cols[:, :, None]
    if cfg.quantize_probabilities:

        @jax.jit
        def build_stoch():
            def body(_, step):
                k = jax.random.fold_in(jax.random.fold_in(kdec, step), 7)
                u = jax.random.uniform(k, (n, batch_size), dtype)
                return None, u[:, frame_index]

            _, cols = jax.lax.scan(body, None, jnp.arange(steps))
            return cols

        stoch = build_stoch()[:, :, None]
    return pert, stoch


def replay_channel(
    code: Code,
    seed: int,
    batch_index: int,
    frame_index: int,
    batch_size: int,
    sigma: float,
    bits: Optional[np.ndarray] = None,
    awgn_form: str = "multiplicative",
):
    """Reproduce one frame's channel output exactly as simulate() drew it.

    Mirrors the key-folding scheme of harness.montecarlo.simulate: batch key
    = fold_in(key(seed), batch_index); channel key = split()[0].  The draw
    runs compiled, with sigma a constant, as in simulate()'s batch step
    (:func:`..harness.montecarlo.draw_channel`), so the row is bit-exact.
    """
    key = jax.random.fold_in(jax.random.key(seed), batch_index)
    if bits is None:
        bits = jnp.zeros((batch_size, code.n), jnp.uint8)
    y, kdec = jax.jit(draw_channel, static_argnums=(2, 3))(
        key, bits, sigma, awgn_form
    )
    return np.asarray(y[frame_index]), kdec


@dataclasses.dataclass
class GDBFTrace:
    """Per-iteration evolution of one frame's decode."""

    decisions: np.ndarray  # [T+1, N] ±1 (row 0 = channel decisions)
    syndromes: np.ndarray  # [T+1, M] ±1
    iterations: int
    satisfied: bool


def trace_gdbf(
    code: Code,
    yq: np.ndarray,
    sigma: float,
    cfg: GDBFConfig,
    key: jax.Array,
    perturbations: Optional[jax.Array] = None,
    stoch_uniforms: Optional[jax.Array] = None,
) -> GDBFTrace:
    """Decode one frame, capturing state after every iteration.

    One instrumented decode (``decode_gdbf(..., trace=True)`` runs the loop
    under ``lax.scan`` emitting every step's decisions) — O(T), so a DVB-S2
    SM-NGDBF T=700 trace costs one decode, not ~T²/2 re-decodes.
    Intermediate rows show raw decisions (output smoothing only rewrites
    the *final* output of unsatisfied frames, decodeGDBF.cpp:358-367).
    """
    y1 = jnp.asarray(yq)[None, :]
    res, d_steps = decode_gdbf(
        code, y1, sigma, cfg, key=key, trace=True,
        perturbations=perturbations, stoch_uniforms=stoch_uniforms,
    )
    satisfied = bool(res.satisfied[0])
    iterations = int(res.iterations[0])
    # executed update rounds: frozen-at-step `iterations` (break index) for
    # satisfied frames, the full budget otherwise
    rounds = iterations if satisfied else cfg.max_phases * cfg.num_iterations
    rows_d = [np.where(np.asarray(yq) > 0, 1, -1)]
    rows_d += list(np.asarray(d_steps[: max(rounds, 1), :, 0]))
    if cfg.output_smoothing and not satisfied:
        rows_d[-1] = np.asarray(res.hard)[0]  # smoothed final output
    rows_s = [
        np.asarray(syndrome_from_hard(code, jnp.asarray(d)[:, None]))[:, 0]
        for d in rows_d
    ]
    return GDBFTrace(
        decisions=np.stack(rows_d),
        syndromes=np.stack(rows_s),
        iterations=iterations,
        satisfied=satisfied,
    )


def write_trace(trace: GDBFTrace, path: str) -> None:
    """Text trace: one line of decisions then one of syndromes per
    iteration (the replayGDBF.cpp:316-373 format family)."""
    with open(path, "w") as f:
        for it in range(trace.decisions.shape[0]):
            f.write("d " + " ".join(map(str, trace.decisions[it])) + "\n")
            f.write("s " + " ".join(map(str, trace.syndromes[it])) + "\n")


def _main(argv=None):
    """CLI: replay one frame and write its decision/syndrome trace.

    python -m ldpcsimulation_tpu.tools.replay --code qc_1008_504 \
        --snr 3.25 --seed 0 --batch-index 2 --frame 17 --batch 1024 \
        --preset SMNGDBF -T 100 --theta -0.9 --out frame.trace
    """
    import argparse

    from ..channel.awgn import snr_to_sigma
    from ..channel.quantize import saturate
    from ..codes import build_code, load_alist
    from ..codes.library import NAMED_CODES, load_named_code
    from ..decoders.gdbf import PRESETS, preset

    p = argparse.ArgumentParser(prog="replay", description=_main.__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--code", choices=sorted(NAMED_CODES))
    src.add_argument("--alist")
    p.add_argument("--snr", type=float, required=True)
    p.add_argument("--rate", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch-index", type=int, required=True)
    p.add_argument("--frame", type=int, required=True)
    p.add_argument("--batch", type=int, required=True,
                   help="batch size of the original simulate() run")
    p.add_argument("--preset", choices=sorted(PRESETS), default="SMNGDBF")
    p.add_argument("-T", "--iterations", type=int, required=True)
    p.add_argument("--theta", type=float, default=-0.9)
    p.add_argument("--noise-scale", type=float, default=0.975)
    p.add_argument("--lam", type=float, default=0.988)
    p.add_argument("--alpha", type=float, default=0.75)
    p.add_argument("--window", type=int, default=64)
    p.add_argument("--ymax", type=float, default=2.5)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    code = (
        load_named_code(args.code)
        if args.code
        else build_code(load_alist(args.alist))
    )
    rate = args.rate if args.rate is not None else code.rate
    sigma = float(snr_to_sigma(args.snr, rate))
    y, kdec = replay_channel(
        code, args.seed, args.batch_index, args.frame, args.batch, sigma
    )
    yq = np.asarray(saturate(jnp.asarray(y), args.ymax))
    cfg = preset(
        args.preset, num_iterations=args.iterations, theta=args.theta,
        noise_scale=args.noise_scale, lam=args.lam, alpha=args.alpha,
        window_size=args.window,
    )
    # the original batched decode drew [N, batch] randomness per step;
    # replay the exact column this frame saw (gdbf.py batch-shape keying)
    pert, stoch = replay_decoder_randomness(
        code.n, cfg, kdec, args.batch, args.frame, sigma
    )
    tr = trace_gdbf(
        code, yq, sigma, cfg, key=kdec,
        perturbations=pert, stoch_uniforms=stoch,
    )
    write_trace(tr, args.out)
    print(
        f"frame ({args.seed},{args.batch_index},{args.frame}): "
        f"iterations={tr.iterations} satisfied={tr.satisfied} "
        f"trace -> {args.out}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
