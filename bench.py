"""Benchmark: decoded info bits/s on one GPU, min-sum T=10 on (1008, 504).

The BASELINE metric configuration (BASELINE.md): the full pipeline —
codeword batch, BPSK, AWGN at 2 dB Eb/N0, 10 fixed min-sum iterations,
hard-decision error counting — on one device.  The reference publishes no
throughput numbers (it never times anything).

Method:
  * one measured unit = a jitted "mega-step" that runs ``--rounds`` channel
    + decode + count rounds on device via ``lax.fori_loop``,
  * every call is synchronized by fetching its scalar result to the host,
  * the reported value uses the MINIMUM of ``--repeats`` calls with
    distinct RNG keys.

Without a GPU it exits with an error.  Prints ONE JSON line:
{"metric", "value", "unit", "device"}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import jax
import jax.numpy as jnp


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=32768)
    p.add_argument("--rounds", type=int, default=64,
                   help="channel+decode rounds per measured device call "
                        "(amortizes the per-call dispatch and sync)")
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--snr-db", type=float, default=2.0)
    p.add_argument("--repeats", type=int, default=8)
    p.add_argument("--fp32", action="store_true",
                   help="full-f32 messages (default: f16 storage, f32 math)")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args()

    from ldpcsimulation_tpu.runtime import enable_compile_cache, require_gpu

    dev = require_gpu()
    enable_compile_cache()

    from ldpcsimulation_tpu.channel.awgn import awgn, snr_to_sigma
    from ldpcsimulation_tpu.codes.library import load_named_qc
    from ldpcsimulation_tpu.decoders.minsum_qc import decode_minsum_qc

    # QC (1008,504) + gather-free decoder; f16 message storage with f32
    # arithmetic (decoders/minsum_qc.py)
    qc = load_named_qc("qc_1008_504")
    k = qc.n - qc.m  # 504 info bits per frame
    sigma = float(snr_to_sigma(args.snr_db, k / qc.n))
    b = args.batch
    sdt = None if args.fp32 else jnp.float16

    @jax.jit
    def megastep(key):
        def body(i, acc):
            kr = jax.random.fold_in(key, i)
            y = awgn(kr, jnp.ones((b, qc.n), jnp.float32), sigma)
            res = decode_minsum_qc(
                qc, y, num_iterations=args.iterations, storage_dtype=sdt
            )
            # float32 accumulator: the worst-case error count at large
            # --batch/--rounds exceeds int32 (32768*64*1008 = 2.11e9); this
            # is a --verbose diagnostic, so f32 rounding beats silent wrap.
            return acc + jnp.sum(res.hard != 1).astype(jnp.float32)
        return jax.lax.fori_loop(0, args.rounds, body, jnp.float32(0))

    key = jax.random.key(0)
    # warmup (compile) with a real host sync
    warm = int(megastep(key))
    times = []
    for i in range(args.repeats):
        t0 = time.perf_counter()
        errs = int(megastep(jax.random.fold_in(key, 1 + i)))
        times.append(time.perf_counter() - t0)
    dt = min(times)
    frames = b * args.rounds
    bits_per_s = frames * k / dt
    if args.verbose:
        ber = errs / (frames * qc.n)
        print(
            f"# device={jax.devices()[0]}, {frames} frames/call, "
            f"min {dt * 1e3:.0f} ms (median "
            f"{statistics.median(times) * 1e3:.0f}, max "
            f"{max(times) * 1e3:.0f}), BER={ber:.4g}, warm_errs={warm}",
            file=sys.stderr,
        )
    print(
        json.dumps(
            {
                "metric": (
                    "decoded info bits/s/device, min-sum T="
                    f"{args.iterations} on (1008,504) @ {args.snr_db} dB"
                ),
                "value": bits_per_s,
                "unit": "bits/s",
                "device": dev,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
