"""Example: compare decoder families on one code across an Eb/N0 grid.

Runs the flagship QC (1008,504) code through min-sum (flooding + layered),
sum-product BP, and SM-NGDBF at each SNR point and prints a BER/FER/avg-
iteration table.  Works on CPU or GPU (first compile per decoder is slow).

    python examples/compare_decoders.py --snr 2.0:3.0:0.5 --frames 4096
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp

from ldpcsimulation_tpu.channel import (
    llr_from_channel,
    saturate,
    snr_to_n0,
    snr_to_sigma,
)
from ldpcsimulation_tpu.codes.library import load_named_qc
from ldpcsimulation_tpu.decoders import (
    decode_bp_layered_qc,
    decode_bp_qc,
    decode_gdbf,
    decode_minsum_layered_qc,
    decode_minsum_qc,
    preset,
)
from ldpcsimulation_tpu.harness import StopRule, simulate
from ldpcsimulation_tpu.tools.sweep import _parse_snr


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--snr", default="2.0:3.0:0.5")
    p.add_argument("--frames", type=int, default=4096)
    p.add_argument("--batch", type=int, default=1024)
    args = p.parse_args()

    qc = load_named_qc("qc_1008_504")
    code = qc.to_code()
    stop = StopRule.fixed_frames(args.frames)

    def run(snr, decode_fn, preprocess=None):
        return simulate(
            code, decode_fn, snr_db=snr, stop=stop,
            batch_size=args.batch, preprocess=preprocess, seed=7,
        )

    print(f"{'decoder':26s} {'Eb/N0':>6s} {'BER':>10s} {'FER':>10s} {'iters':>6s}")
    for snr in _parse_snr(args.snr):
        n0 = float(snr_to_n0(snr, code.rate))
        sigma = float(snr_to_sigma(snr, code.rate))
        sm_cfg = preset(
            "SMNGDBF", num_iterations=300, theta=-0.9, noise_scale=0.975,
            lam=0.988, alpha=0.75, window_size=64,
        )
        rows = [
            ("min-sum T=10 (flooding)",
             run(snr, lambda y, k: decode_minsum_qc(
                 qc, y, 10, early_termination=True, storage_dtype=jnp.float16
             ))),
            ("min-sum T=10 (layered)",
             run(snr, lambda y, k: decode_minsum_layered_qc(
                 qc, y, 10, early_termination=True
             ))),
            ("BP T<=30 (flooding)",
             run(snr, lambda llr, k: decode_bp_qc(
                 qc, llr, 30, early_termination=True
             ), preprocess=lambda y: llr_from_channel(y, n0))),
            ("BP T<=30 (layered)",
             run(snr, lambda llr, k: decode_bp_layered_qc(
                 qc, llr, 30, early_termination=True
             ), preprocess=lambda y: llr_from_channel(y, n0))),
            ("SM-NGDBF T<=300",
             run(snr, lambda yq, k: decode_gdbf(
                 code, yq, sigma, sm_cfg, key=k, qc=qc
             ), preprocess=lambda y: saturate(y, 2.5))),
        ]
        for name, st in rows:
            print(
                f"{name:26s} {snr:6.2f} {st.ber:10.3e} {st.fer:10.3e} "
                f"{st.avg_iterations:6.1f}"
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
