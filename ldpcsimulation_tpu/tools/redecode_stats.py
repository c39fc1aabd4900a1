"""Per-frame redecode statistics: frame-specific error probability Pe(f).

Reference counterpart: ``newstat.cpp`` (binary ``redecodeStatistics``,
``Makefile:39-40``): for NF frames, snapshot the RNG state, decode the same
received frame NR times with fresh decoder noise, and log one row per frame
— ``framenum  outcome[0..NR-1]`` with each outcome the residual error
weight of that attempt (``newstat.cpp:432-436``).  The older
``redecodeStatistics.cpp`` is the same without state files.

This version: the channel realization of frame f is a pure function
of (seed, f), and the NR redecode attempts use keys folded from (seed, f,
attempt) — no state files, and all NR attempts of a frame run as one
batched decode.
"""

from __future__ import annotations

from typing import Optional, TextIO

import jax
import jax.numpy as jnp
import numpy as np

from ..channel.awgn import awgn, snr_to_sigma
from ..codes.code import Code
from ..decoders.gdbf import GDBFConfig, decode_gdbf

__all__ = ["redecode_statistics"]


def redecode_statistics(
    code: Code,
    cfg: GDBFConfig,
    snr_db: float,
    rate: Optional[float] = None,
    num_frames: int = 200,
    num_redecodes: int = 100,
    seed: int = 0,
    log: Optional[TextIO] = None,
) -> np.ndarray:
    """Returns outcomes [num_frames, num_redecodes]: error weight per
    attempt.  Defaults mirror ``scripts/redecode_statistics_802.3.sh``
    (NR=100, NF=200).  Writes reference-format rows to ``log`` if given.
    """
    rate = code.rate if rate is None else rate
    sigma = float(snr_to_sigma(snr_db, rate))
    root = jax.random.key(seed)

    @jax.jit
    def one_frame(kframe):
        kch, kdec = jax.random.split(kframe)
        y = awgn(kch, jnp.ones((1, code.n), jnp.float32), sigma)
        yb = jnp.broadcast_to(y, (num_redecodes, code.n))
        # each attempt gets its own decoder-noise stream; batch lanes are
        # distinguished by folding the attempt index server-side via the
        # decoder's per-(step) keys — pass a per-run key and let the batch
        # dimension see different noise by drawing [T, N, B] perturbations
        res = decode_gdbf(code, yb, sigma, cfg, key=kdec)
        return jnp.sum(res.hard != 1, axis=1)  # error weight per attempt

    outcomes = np.zeros((num_frames, num_redecodes), np.int64)
    for f in range(num_frames):
        kframe = jax.random.fold_in(root, f)
        outcomes[f] = np.asarray(one_frame(kframe))
        if log is not None:
            log.write(
                str(f) + "\t" + "\t".join(map(str, outcomes[f])) + "\n"
            )
    return outcomes


def _main(argv=None):
    """CLI: per-frame redecode statistics (redecodeStatistics analog).

    python -m ldpcsimulation_tpu.tools.redecode_stats --code qc_1008_504 \
        --snr 3.5 -T 300 --frames 200 --redecodes 100 --log out.log
    """
    import argparse
    import sys

    from ..codes import build_code, load_alist
    from ..codes.library import NAMED_CODES, load_named_code
    from ..decoders.gdbf import PRESETS, preset

    p = argparse.ArgumentParser(
        prog="redecode_stats", description=_main.__doc__
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--code", choices=sorted(NAMED_CODES))
    src.add_argument("--alist")
    p.add_argument("--snr", type=float, required=True)
    p.add_argument("--rate", type=float, default=None)
    p.add_argument("-T", "--iterations", type=int, required=True)
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--redecodes", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--preset", choices=sorted(PRESETS), default="SMNGDBF")
    p.add_argument("--theta", type=float, default=-0.9)
    p.add_argument("--noise-scale", type=float, default=0.975)
    p.add_argument("--lam", type=float, default=0.988)
    p.add_argument("--alpha", type=float, default=0.75)
    p.add_argument("--window", type=int, default=64)
    p.add_argument("--log", required=True)
    args = p.parse_args(argv)

    code = (
        load_named_code(args.code)
        if args.code
        else build_code(load_alist(args.alist))
    )
    cfg = preset(
        args.preset, num_iterations=args.iterations, theta=args.theta,
        noise_scale=args.noise_scale, lam=args.lam, alpha=args.alpha,
        window_size=args.window,
    )
    with open(args.log, "w") as f:
        out = redecode_statistics(
            code, cfg, snr_db=args.snr, rate=args.rate,
            num_frames=args.frames, num_redecodes=args.redecodes,
            seed=args.seed, log=f,
        )
    pe = (out > 0).mean(axis=1)
    print(
        f"{args.frames} frames x {args.redecodes} redecodes: mean Pe(f) = "
        f"{pe.mean():.4f}, frames with Pe>0: {(pe > 0).sum()}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
