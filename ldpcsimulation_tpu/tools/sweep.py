"""Experiment sweep runner — the CLI replacing the reference's bash grids.

The reference's entire experiment-orchestration layer is 17 bash scripts of
nested loops launching ``nohup ./bin/X … &`` per operating point
(``C_implementations/scripts/*.sh``, e.g.
``mngdbf_example_PEGReg504x1008.sh:43-59`` — a 5-deep sweep).  This runner
collapses that into one command: a cartesian grid over SNR and algorithm
parameters, each point simulated with the batched Monte-Carlo harness, and
one reference-format row appended to the log per point.

Examples:
    python -m ldpcsimulation_tpu.tools.sweep minsum \
        --code qc_1008_504 --snr 1.6:3.8:0.2 -T 8 --log ms.log
    python -m ldpcsimulation_tpu.tools.sweep gdbf --preset SMNGDBF \
        --alist PEGReg504x1008.alist --snr 2.0:4.0:0.25 -T 300 \
        --theta -0.9 --noise-scale 0.975 0.75 --lam 0.988 \
        --alpha 2.3 --window 64 --ymax 2.5 --log smngdbf.log
    python -m ldpcsimulation_tpu.tools.sweep bp --code peg_1008_504 \
        --snr 1.6:2.6:0.2 -T 100 --log bp.log
"""

from __future__ import annotations

import argparse
import itertools
import sys
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from ..channel.awgn import llr_from_channel, snr_to_n0, snr_to_sigma
from ..channel.quantize import quantize_no_zero, quantize_round, saturate
from ..codes import build_code, load_alist
from ..codes.library import NAMED_CODES, load_named_code
from ..decoders.bp import decode_bp
from ..decoders.ddbmp import decode_ddbmp, decode_ddbmp_qc
from ..decoders.gdbf import PRESETS, preset
from ..decoders.gdbf import decode_gdbf
from ..decoders.minsum import decode_minsum
from ..decoders.ngdbf_hw import NGDBFHwConfig, decode_ngdbf_hw
from ..harness import (
    StopRule,
    append_row,
    bp_log_row,
    default_min_word_errors,
    fmt,
    gdbf_log_row,
    minsum_log_row,
    ngdbfhw_log_row,
    simulate,
)
from ..harness.fixtures import load_codeword_file
from ..runtime import device_summary, enable_compile_cache

__all__ = ["main", "build_parser"]


def _grid_key(point) -> str:
    """Canonical resume key for one cartesian grid point (None -> '-')."""
    return "|".join("-" if v is None else fmt(v) for v in point)


def _mark_done(log: str, key: str) -> None:
    """Record a completed grid point in the '<log>.done' resume sidecar."""
    with open(log + ".done", "a") as f:
        f.write(key + "\n")


def _parse_snr(spec: str) -> List[float]:
    """"a:b:step" inclusive grid, or a single value, or comma list."""
    try:
        if ":" in spec:
            a, b, s = (float(x) for x in spec.split(":"))
            n = int(round((b - a) / s)) + 1
            if n < 1:
                raise SystemExit(
                    f"sweep: error: --snr range {spec!r} is empty "
                    "(end before start with a positive step?)"
                )
            return [round(a + i * s, 10) for i in range(n)]
        if "," in spec:
            return [float(x) for x in spec.split(",")]
        return [float(spec)]
    except ValueError:
        raise SystemExit(
            f"sweep: error: argument --snr: expected 'a:b:step', "
            f"'v1,v2,...' or a single dB value, got {spec!r}"
        )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sweep", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument(
        "decoder",
        choices=["bp", "minsum", "offsetminsum", "normalizedminsum",
                 "gdbf", "ddbmp", "ngdbfhw", "nbqspa"],
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--code", choices=sorted(NAMED_CODES), help="named code")
    src.add_argument("--alist", help="path to an alist file (binary or NB)")
    src.add_argument("--nb-random", metavar="N:M:DV:Q",
                     help="random GF(Q) regular code, e.g. 96:48:3:64")
    p.add_argument("--schedule", choices=["flooding", "layered"],
                   default="flooding",
                   help="min-sum schedule (layered needs a QC --code)")
    p.add_argument("--distributed", action="store_true",
                   help="run the FULL operating-point grid (SNR x every "
                        "multi-valued decoder parameter) concurrently on "
                        "the device mesh with psum-reduced statistics — "
                        "one compiled step, chunk rotations, adaptive "
                        "per-point stopping")
    p.add_argument("--rate", type=float, help="code rate R (default k/n)")
    p.add_argument("--snr", required=True, help="Eb/N0 grid 'a:b:step' dB")
    p.add_argument("-T", "--iterations", type=int, required=True)
    p.add_argument("--log", required=True, help="append-only result log")
    p.add_argument("--codewords", help="data.enc-style codeword file")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--min-errors", type=int, default=200)
    p.add_argument("--min-word-errors", type=int, default=None)
    p.add_argument("--early-termination", action="store_true")
    p.add_argument(
        "--stream", action="store_true",
        help="min-sum/BP (with --early-termination; QC, stratified, or "
             "--schedule layered QC codes), gdbf, nbqspa, ddbmp, ngdbfhw: run "
             "the streaming refill harness (persistent lanes + "
             "per-frame-keyed channel pool) instead of the batched masked "
             "loop — same per-frame statistics (bit-exact, "
             "tests/test_stream.py and test_stream_gdbf.py; GDBF decoder "
             "noise is keyed per (frame, step) instead of per (batch, "
             "step) — statistically identical, replayable by "
             "coordinates), no straggler tax.  All-zero codewords; "
             "lanes = --batch.",
    )
    p.add_argument(
        "--pool-bytes", type=int, default=None,
        help="--stream channel-pool byte budget (default 1 GiB): the "
             "per-call round count auto-shrinks so the hint-based pool "
             "sizing fits the budget (harness.stream.pool_policy) — "
             "replaces the round-4 'cap rounds_per_call by hand' "
             "workaround at low-average-iteration operating points",
    )
    p.add_argument(
        "--msg-dtype", choices=["f32", "f16"], default="f32",
        help="message STORAGE dtype (arithmetic stays f32); f16 is the "
             "benchmark precision mode, BER-identical to f32.  Applied "
             "uniformly to every min-sum route (generic, QC, layered, "
             "stratified) and to flooding BP (generic, QC) so results "
             "stay bit-comparable.",
    )
    p.add_argument("--verbose", action="store_true")
    # min-sum / ddbmp quantization
    p.add_argument("--ymax", type=float, nargs="+", default=[None])
    p.add_argument("--nq", type=float, nargs="+", default=[None],
                   help="quantizer levels (minsum/ddbmp) or bits (gdbf)")
    p.add_argument("--alpha", type=float, nargs="+", default=[None])
    p.add_argument("--delta", type=float, nargs="+", default=[None])
    # gdbf family
    p.add_argument("--preset", choices=sorted(PRESETS), default="SMNGDBF")
    p.add_argument("--theta", type=float, nargs="+", default=[None])
    p.add_argument("--noise-scale", type=float, nargs="+", default=[None])
    p.add_argument("--lam", type=float, nargs="+", default=[None])
    p.add_argument("--window", type=int, default=64)
    p.add_argument("--max-phases", type=int, default=None)
    p.add_argument(
        "--persistent-qpointer", action="store_true",
        help="NGDBFhw: carry the noise-ring pointer across frames per "
             "batch lane (NGDBFhw.cpp:153,356-358 exactness; default off "
             "— statistically invisible and slower, see decoder docs)",
    )
    p.add_argument("--uniform-noise", action="store_true",
                   help="variance-matched uniform perturbation noise "
                        "(the reference's -DUNIFORM NGDBF builds, e.g. "
                        "ngdbf_example_uniform_PEGReg504x1008.sh)")
    # ngdbfhw
    p.add_argument("--w", type=float, nargs="+", default=[None])
    p.add_argument("--theta0", type=float, nargs="+", default=[None])
    p.add_argument("--frames", type=int, default=10000,
                   help="fixed frame count for ngdbfhw")
    p.add_argument(
        "--itdist-biased", action="store_true",
        help="write the *_itdist.dat completion CDF with the reference's "
             "own running-mean estimator, bias included (NGDBFhw.cpp:"
             "419-421 never decays entries past a frame's completion) — "
             "drop-in diffable against archived reference .dat files; "
             "default is the unbiased complement-CDF (docs/VALIDATION.md "
             "documents the bias with a reproduction)",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="skip grid points already recorded in the '<log>.done' "
             "sidecar, keyed by the full operating-point tuple (the "
             "reference's interrupted-sweep recovery: append-only logs, "
             "idempotent rows); legacy sidecar-less logs resume by SNR "
             "column for SNR-only grids",
    )
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    enable_compile_cache()
    dev = device_summary()
    print(
        f"sweep: {dev['platform']} {dev['kind']} x{dev['count']}",
        file=sys.stderr,
    )

    qc = None
    strat = None
    if args.code:
        from ..codes.library import load_named_qc

        try:
            qc = load_named_qc(args.code)  # QC fast paths when available
        except KeyError:
            pass
        code = qc.to_code() if qc is not None else load_named_code(args.code)
        alist_name = args.code
    elif args.alist:
        alist = load_alist(args.alist)
        code = build_code(alist)
        alist_name = args.alist
        if code.q <= 2:
            # Auto-detect circulant-block structure in loaded matrices
            # (802.11n-style storage) and route to the gather-free QC
            # decoders.  Only the natural-order layout is auto-routed from
            # the CLI; permuted layouts are available via
            # codes.qc_detect.permuted_decoder in the library API.
            from ..codes.qc_detect import detect_qc

            det = detect_qc(alist)
            if (
                det is not None
                and (det.col_perm == np.arange(code.n)).all()
                and (det.row_perm == np.arange(code.m)).all()
            ):
                qc = det.qc
                print(
                    f"sweep: detected QC structure z={qc.z} "
                    f"({qc.mb}x{qc.nb} base) — using roll decoders",
                    file=sys.stderr,
                )
            if qc is None and args.decoder in (
                "minsum", "offsetminsum", "normalizedminsum", "bp", "ddbmp"
            ) and args.schedule != "layered":
                # Non-QC matrices get the stratified one-hot matmul
                # interleaver instead of the gather path whenever the
                # greedy row/column coloring is cheap enough (cost-gated
                # in detect_stratified) — the universal unstructured
                # fallback for the message-passing decoders; only those
                # routes pay for the host-side search.
                from ..codes.stratified import detect_stratified

                strat = detect_stratified(alist)
                if strat is not None:
                    print(
                        f"sweep: detected stratified structure "
                        f"({strat.mb}x{strat.h} strata, {strat.kg} column "
                        "groups) — using one-hot matmul decoders",
                        file=sys.stderr,
                    )
    else:
        from ..codes.construct import nb_regular

        n_, m_, dv_, q_ = (int(x) for x in args.nb_random.split(":"))
        code = build_code(nb_regular(n_, m_, dv_, q=q_, seed=args.seed))
        alist_name = f"nb_random_{args.nb_random}"
    rate = args.rate if args.rate is not None else code.rate
    codewords = (
        load_codeword_file(args.codewords, n=code.n)
        if args.codewords
        else None
    )
    if codewords is not None and code.q <= 2:
        # Fail fast if the fixture rows are not in the code's null space —
        # the classic trap is natural-order words against a column-
        # relabeled variant (e.g. dvbs2_1_2_qc): BER vs a non-codeword
        # "truth" is silently wrong.  A few syndrome products are cheap.
        from ..decoders.base import syndrome_from_hard

        probe = np.asarray(codewords[:4], np.int64)
        d = jnp.asarray(1 - 2 * probe.T, jnp.float32)  # bit->±1, [N, B]
        if bool((syndrome_from_hard(code, d) < 0).any()):
            raise SystemExit(
                f"sweep: error: {args.codewords}: rows are not codewords "
                f"of this H (column order mismatch? e.g. natural-order "
                f"DVB-S2 words require --code dvbs2_1_2, not dvbs2_1_2_qc)"
            )
    snrs = _parse_snr(args.snr)
    T = args.iterations
    mwe = (
        args.min_word_errors
        if args.min_word_errors is not None
        else default_min_word_errors(code.n)
    )
    stop = StopRule(
        min_bit_errors=args.min_errors,
        min_word_errors=mwe,
        max_frames=args.max_frames,
    )

    # Unstructured codes (no QC fast path) get the dense matmul graph ops for
    # the bit-flip decoders when H is small enough to pay off — this is how
    # the reference's own 802.3an RS-LDPC avoids the gather-bound path.
    dense = None
    if qc is None and args.decoder in ("gdbf", "ngdbfhw"):
        from ..decoders.dense_ops import DenseGraph, dense_worthwhile

        if dense_worthwhile(code):
            dense = DenseGraph.from_code(code)

    def run_point(snr, decode_fn, preprocess=None, stop_override=None,
                  carry0=None):
        return simulate(
            code,
            decode_fn,
            snr_db=snr,
            rate=rate,
            stop=stop_override or stop,
            batch_size=args.batch,
            seed=args.seed,
            preprocess=preprocess,
            codewords=codewords,
            verbose=args.verbose,
            decode_carry0=carry0,
        )

    if args.stream:
        if args.decoder not in (
            "minsum", "offsetminsum", "normalizedminsum", "bp",
            "gdbf", "nbqspa", "ddbmp", "ngdbfhw",
        ):
            raise SystemExit(
                "sweep: error: --stream supports min-sum, BP, gdbf, "
                "nbqspa, ddbmp and ngdbfhw"
            )
        if args.decoder == "ngdbfhw" and args.persistent_qpointer:
            raise SystemExit(
                "sweep: error: --stream ngdbfhw already chains ring "
                "offsets per frame (injection-time qpointer0); "
                "--persistent-qpointer is the batched-lane semantic"
            )
        if args.decoder not in ("gdbf", "nbqspa", "ddbmp", "ngdbfhw") and (
            not args.early_termination
        ):
            # gdbf/nbqspa/ddbmp always early-terminate (built in)
            raise SystemExit(
                "sweep: error: --stream requires --early-termination "
                "(fixed-trip decodes have no straggler tax to remove)"
            )
        if codewords is not None:
            raise SystemExit(
                "sweep: error: --stream simulates all-zero codewords"
            )
        if args.distributed:
            raise SystemExit(
                "sweep: error: --stream runs on one device in the CLI; "
                "--distributed is the batched operating-point grid "
                "engine (the library API shards a stream over a mesh: "
                "simulate_stream(mesh=...))"
            )
        if args.schedule == "layered" and args.decoder not in (
            "minsum", "offsetminsum", "normalizedminsum", "bp",
        ):
            raise SystemExit(
                "sweep: error: --schedule layered streams min-sum "
                "variants and BP only"
            )

    def run_stream_point(snr, sdec, preprocess=None):
        from ..harness.stream import simulate_stream

        return simulate_stream(
            code.n, sdec, snr, rate, T,
            stop=stop, lanes=args.batch, refill_every=2,
            seed=args.seed, preprocess=preprocess,
            pool_bytes=args.pool_bytes, verbose=args.verbose,
        )

    if args.distributed:
        return _run_distributed(
            args, code, qc, alist_name, snrs, rate, stop, T, codewords
        )

    rows = 0
    grid = list(
        itertools.product(
            snrs, args.ymax, args.nq, args.alpha, args.delta,
            args.theta, args.noise_scale, args.lam, args.w, args.theta0,
        )
    )
    # --resume keys completed points on the FULL operating-point tuple (SNR
    # plus every grid parameter), recorded in a "<log>.done" sidecar so the
    # reference log-row format stays untouched.  Legacy logs without a
    # sidecar resume by SNR column only when the grid is SNR-only —
    # otherwise skipping by SNR would silently drop unexplored parameter
    # combinations at an already-logged SNR.
    done_keys = set()
    if args.resume:
        try:
            with open(args.log + ".done") as f:
                done_keys.update(line.rstrip("\n") for line in f)
        except FileNotFoundError:
            snr_only = len({point[1:] for point in grid}) == 1
            if snr_only:
                by_snr = {fmt(point[0]): _grid_key(point) for point in grid}
                try:
                    with open(args.log) as f:
                        for line in f:
                            cols = line.split("\t")
                            if cols and cols[0] in by_snr:
                                done_keys.add(by_snr[cols[0]])
                except FileNotFoundError:
                    pass
            else:
                print(
                    "sweep: --resume found no sidecar "
                    f"{args.log}.done; multi-parameter grid will re-run "
                    "all points",
                    file=sys.stderr,
                )
    for point in grid:
        (snr, ymax, nq, alpha, delta, theta, nscale, lam, w, theta0) = point
        gkey = _grid_key(point)
        if args.resume and gkey in done_keys:
            rows += 1
            print(
                f"[{rows}/{len(grid)}] SNR={snr} point already logged, "
                "skipping",
                file=sys.stderr,
            )
            continue
        n0 = float(snr_to_n0(snr, rate))
        sigma = float(snr_to_sigma(snr, rate))
        if args.decoder == "bp":
            sdt = jnp.float16 if args.msg_dtype == "f16" else None
            if args.schedule == "layered":
                if qc is None:
                    raise SystemExit(
                        "sweep: error: --schedule layered requires a "
                        "QC-structured --code"
                    )
                from ..decoders.bp_layered import decode_bp_layered_qc

                dec = lambda llr, key: decode_bp_layered_qc(
                    qc, llr, T, early_termination=args.early_termination
                )
            elif qc is not None:
                from ..decoders.bp_qc import decode_bp_qc

                dec = lambda llr, key: decode_bp_qc(
                    qc, llr, T, early_termination=args.early_termination,
                    storage_dtype=sdt,
                )
            elif strat is not None:
                from ..decoders.bp_stratified import decode_bp_stratified

                dec = lambda llr, key: decode_bp_stratified(
                    strat, llr, T,
                    early_termination=args.early_termination,
                    storage_dtype=sdt,
                )
            else:
                dec = lambda llr, key: decode_bp(
                    code, llr, T, early_termination=args.early_termination,
                    storage_dtype=sdt,
                )
            if args.stream:
                from ..harness.stream import (
                    bp_layered_qc_stream,
                    bp_qc_stream,
                    bp_stratified_stream,
                )

                if args.schedule == "layered":
                    sdec = bp_layered_qc_stream(qc)
                elif qc is not None:
                    sdec = bp_qc_stream(qc, storage_dtype=sdt)
                elif strat is not None:
                    sdec = bp_stratified_stream(strat, storage_dtype=sdt)
                else:
                    raise SystemExit(
                        "sweep: error: --stream bp requires a QC or "
                        "stratifiable code (generic BP: batched path)"
                    )
                stats = run_stream_point(
                    snr, sdec,
                    preprocess=lambda y: llr_from_channel(y, n0),
                )
            else:
                stats = run_point(
                    snr, dec,
                    preprocess=lambda y: llr_from_channel(y, n0),
                )
            row = bp_log_row(snr, stats, T, alist_name)
        elif args.decoder in ("minsum", "offsetminsum", "normalizedminsum"):
            variant = {"minsum": "plain", "offsetminsum": "offset",
                       "normalizedminsum": "normalized"}[args.decoder]
            sdt = jnp.float16 if args.msg_dtype == "f16" else None
            pre = None
            if variant != "plain":
                ym = ymax if ymax is not None else 2.0
                nql = nq if nq is not None else 8.0
                pre = lambda y: quantize_no_zero(y, ym, nql)
            if args.schedule == "layered":
                if qc is None:
                    raise SystemExit(
                        "sweep: error: --schedule layered requires a "
                        "QC-structured --code"
                    )
                from ..decoders.minsum_layered import decode_minsum_layered_qc

                dec = lambda y, key: decode_minsum_layered_qc(
                    qc, y, T, variant=variant,
                    alpha=alpha if alpha is not None else 1.0,
                    delta=delta if delta is not None else 0.0,
                    early_termination=args.early_termination,
                    storage_dtype=sdt,
                )
            elif qc is not None:
                from ..decoders.minsum_qc import decode_minsum_qc

                dec = lambda y, key: decode_minsum_qc(
                    qc, y, T, variant=variant,
                    alpha=alpha if alpha is not None else 1.0,
                    delta=delta if delta is not None else 0.0,
                    early_termination=args.early_termination,
                    storage_dtype=sdt,
                )
            elif strat is not None:
                from ..decoders.minsum_stratified import (
                    decode_minsum_stratified,
                )

                dec = lambda y, key: decode_minsum_stratified(
                    strat, y, T, variant=variant,
                    alpha=alpha if alpha is not None else 1.0,
                    delta=delta if delta is not None else 0.0,
                    early_termination=args.early_termination,
                    storage_dtype=sdt,
                )
            else:
                dec = lambda y, key: decode_minsum(
                    code, y, T, variant=variant,
                    alpha=alpha if alpha is not None else 1.0,
                    delta=delta if delta is not None else 0.0,
                    early_termination=args.early_termination,
                    storage_dtype=sdt,
                )
            if args.stream:
                from ..harness.stream import (
                    minsum_layered_qc_stream,
                    minsum_qc_stream,
                    minsum_stratified_stream,
                    minsum_stream,
                )

                if args.schedule == "layered":
                    sdec = minsum_layered_qc_stream(
                        qc, variant=variant,
                        alpha=alpha if alpha is not None else 1.0,
                        delta=delta if delta is not None else 0.0,
                        storage_dtype=sdt,
                    )
                elif qc is not None:
                    sdec = minsum_qc_stream(
                        qc, variant=variant,
                        alpha=alpha if alpha is not None else 1.0,
                        delta=delta if delta is not None else 0.0,
                        storage_dtype=sdt,
                    )
                elif strat is not None:
                    sdec = minsum_stratified_stream(
                        strat, variant=variant,
                        alpha=alpha if alpha is not None else 1.0,
                        delta=delta if delta is not None else 0.0,
                        storage_dtype=sdt,
                    )
                else:
                    sdec = minsum_stream(
                        code, variant=variant,
                        alpha=alpha if alpha is not None else 1.0,
                        delta=delta if delta is not None else 0.0,
                        storage_dtype=sdt,
                    )
                stats = run_stream_point(snr, sdec, preprocess=pre)
            else:
                stats = run_point(snr, dec, preprocess=pre)
            row = minsum_log_row(
                snr, stats, T, alist_name,
                ymax=ymax if variant != "plain" else None,
                alpha=alpha if variant == "normalized" else None,
                delta=delta if variant == "offset" else None,
            )
        elif args.decoder == "gdbf":
            cfg = preset(
                args.preset,
                num_iterations=T,
                theta=theta if theta is not None else -0.9,
                **{
                    k: v
                    for k, v in dict(
                        noise_scale=nscale,
                        lam=lam,
                        alpha=alpha,
                        window_size=args.window,
                        max_phases=args.max_phases,
                        uniform_noise=args.uniform_noise or None,
                    ).items()
                    if v is not None
                },
            )
            def pre(y):
                out = y
                if ymax is not None:
                    out = saturate(out, ymax)
                if nq is not None:
                    out = quantize_round(out, ymax or 2.25, int(nq))
                return out
            if args.stream:
                from ..harness.stream_gdbf import simulate_stream_gdbf

                stats = simulate_stream_gdbf(
                    code, cfg, snr, rate=rate, stop=stop,
                    lanes=args.batch,
                    # boundary cadence: retire checks cost a syndrome +
                    # refill pass, so the family's large caps take a
                    # coarse cadence
                    refill_every=8 if T >= 64 else 2,
                    seed=args.seed, preprocess=pre, qc=qc, dense=dense,
                    pool_bytes=args.pool_bytes, verbose=args.verbose,
                )
            else:
                stats = run_point(
                    snr,
                    lambda yq, key: decode_gdbf(
                        code, yq, sigma, cfg, key=key, qc=qc, dense=dense
                    ),
                    preprocess=pre,
                )
            row = gdbf_log_row(
                snr, stats, T, cfg.theta, alist_name,
                noise_scale=cfg.noise_scale if cfg.add_noise or cfg.quantize_probabilities else None,
                nq=int(nq) if nq is not None else None,
                lam=cfg.lam if cfg.threshold_adaptation else None,
                alpha=cfg.alpha if cfg.weight_syndromes else None,
                smoothing_used=int(stats.extra.get("smoothing_used", 0))
                if cfg.output_smoothing else None,
                window_size=cfg.window_size if cfg.output_smoothing else None,
                ymax=ymax,
            )
        elif args.decoder == "ddbmp":
            ym = ymax if ymax is not None else 1.5
            nql = nq if nq is not None else 8.0
            if qc is not None:
                ddec = lambda yq, key: decode_ddbmp_qc(qc, yq, T)
            elif strat is not None:
                from ..decoders.ddbmp import decode_ddbmp_stratified

                ddec = lambda yq, key: decode_ddbmp_stratified(
                    strat, yq, T
                )
            else:
                ddec = lambda yq, key: decode_ddbmp(code, yq, T)
            if args.stream:
                from ..harness.stream import ddbmp_qc_stream

                if qc is None:
                    raise SystemExit(
                        "sweep: error: --stream ddbmp requires a QC code"
                    )
                stats = run_stream_point(
                    snr, ddbmp_qc_stream(qc),
                    preprocess=lambda y: quantize_no_zero(y, ym, nql),
                )
            else:
                stats = run_point(
                    snr,
                    ddec,
                    preprocess=lambda y: quantize_no_zero(y, ym, nql),
                )
            row = minsum_log_row(snr, stats, T, alist_name, ymax=ym)
        elif args.decoder == "nbqspa":
            if args.stream:
                from ..harness.stream import simulate_stream_nb

                nb_stats = simulate_stream_nb(
                    code, snr_db=snr, num_iterations=T, rate=rate,
                    stop=stop, lanes=args.batch, refill_every=1,
                    pool_bytes=args.pool_bytes, seed=args.seed,
                    storage_dtype=(
                        jnp.float16 if args.msg_dtype == "f16" else None
                    ),
                    verbose=args.verbose,
                )
            else:
                from ..harness.montecarlo_nb import simulate_nb

                nb_stats = simulate_nb(
                    code, snr_db=snr, num_iterations=T, rate=rate,
                    stop=stop, batch_size=args.batch, seed=args.seed,
                    early_termination=args.early_termination,
                    storage_dtype=(
                        jnp.float16 if args.msg_dtype == "f16" else None
                    ),
                )
            # NB row: SNR SER BER avgIters FER T alist
            row = "\t".join(
                fmt(v) for v in (
                    snr, nb_stats.ser, nb_stats.ber,
                    nb_stats.avg_iterations, nb_stats.fer, T,
                )
            ) + f"\t{alist_name}"
            append_row(args.log, row)
            _mark_done(args.log, gkey)
            rows += 1
            print(
                f"[{rows}/{len(grid)}] SNR={snr} SER={nb_stats.ser:.4g} "
                f"BER={nb_stats.ber:.4g} frames={nb_stats.total_words} "
                f"({nb_stats.wall_seconds:.1f}s)",
                file=sys.stderr,
            )
            continue
        elif args.decoder == "ngdbfhw":
            cfg = NGDBFHwConfig(
                num_iterations=T,
                w=w if w is not None else 0.185,
                ymax=ymax if ymax is not None else 1.625,
                noise_scale=nscale if nscale is not None else 0.95,
                theta0=theta0 if theta0 is not None else -0.525,
                max_phases=args.max_phases or 1,
                ring_len=max(2648, code.n + 600),
            )
            # NGDBFhw runs a fixed frame count (NGDBFhw.cpp:193)
            if args.stream:
                from ..harness.stream_ngdbfhw import simulate_stream_ngdbfhw

                stats = simulate_stream_ngdbfhw(
                    code, cfg, snr, rate=rate,
                    stop=StopRule.fixed_frames(args.frames),
                    lanes=args.batch, pool_bytes=args.pool_bytes,
                    refill_every=16, seed=args.seed, qc=qc, dense=dense,
                    verbose=args.verbose,
                )
            elif args.persistent_qpointer:
                # cross-frame ring-pointer persistence (NGDBFhw.cpp:153,
                # 356-358): each batch lane models one serial hardware
                # decoder; the pointer threads between batches via the
                # harness carry.  Per-lane offsets force the gathered ring
                # access path (statistically invisible, measurably slower
                # — see decoders/ngdbf_hw.py).
                import jax.numpy as _jnp

                stats = run_point(
                    snr,
                    lambda y, key, carry: (
                        lambda res: (res, res.qpointer)
                    )(
                        decode_ngdbf_hw(
                            code, y, sigma, cfg, key=key, dense=dense,
                            qc=qc, qpointer0=carry,
                        )
                    ),
                    stop_override=StopRule.fixed_frames(args.frames),
                    carry0=_jnp.zeros((args.batch,), _jnp.int32),
                )
            else:
                stats = run_point(
                    snr,
                    lambda y, key: decode_ngdbf_hw(
                        code, y, sigma, cfg, key=key, dense=dense, qc=qc
                    ),
                    stop_override=StopRule.fixed_frames(args.frames),
                )
            row = ngdbfhw_log_row(
                snr, stats, T, cfg.theta0, cfg.noise_scale, cfg.w,
                cfg.ymax, cfg.nq, cfg.max_phases, args.seed,
            )
            # iteration-completion CDF file (NGDBFhw.cpp:464-469); on a
            # multi-parameter grid the swept parameters join the filename
            # so points sharing an SNR don't clobber each other (same
            # convention as the --distributed route)
            suffix = "".join(
                f"_{nm}{val:g}"
                for nm, val in (("theta0", cfg.theta0),
                                ("w", cfg.w),
                                ("noise_scale", cfg.noise_scale),
                                ("ymax", cfg.ymax))
                if len(getattr(args, nm)) > 1
            )
            cdf = (
                stats.iteration_cdf_biased()
                if args.itdist_biased
                else stats.iteration_cdf()
            )
            with open(
                f"{args.log}_{snr:g}{suffix}_itdist.dat", "w"
            ) as f:
                for idx, v in enumerate(cdf):
                    f.write(f"{idx}\t{v:.6g}\n")
        append_row(args.log, row)
        _mark_done(args.log, gkey)
        rows += 1
        print(
            f"[{rows}/{len(grid)}] SNR={snr} BER={stats.ber:.4g} "
            f"FER={stats.fer:.4g} frames={stats.total_words} "
            f"({stats.wall_seconds:.1f}s)",
            file=sys.stderr,
        )
    return 0


def _run_distributed(
    args, code, qc, alist_name, snrs, rate, stop, T, codewords=None
):
    """--distributed: the FULL operating-point grid, concurrently on the
    device mesh.

    The mesh "snr" axis is a generic operating-point axis: each slot runs
    one (SNR, parameter…) tuple of the cartesian grid, with the decoder
    scalars (θ, λ, α, Ymax, noiseScale, w, θ0, quantizer Ymax/Nq) as
    TRACED per-slot inputs — ONE compiled step serves the whole grid in
    chunk rotations with adaptive per-point stopping
    (:func:`..parallel.montecarlo.simulate_grid`).  This replaces the
    reference's one-process-per-parameter-combination bash fan-out
    (``mngdbf_example_PEGReg504x1008.sh:44-59`` — a 2×4×6×9×3 = 1296-
    process sweep) with a single launch producing per-point log rows
    identical to single-device runs.
    """
    import dataclasses as _dc
    import itertools as _it

    import jax

    from ..parallel.mesh import make_mesh
    from ..parallel.montecarlo import simulate_grid

    if args.schedule == "layered" and (
        qc is None or args.decoder not in (
            "bp", "minsum", "offsetminsum", "normalizedminsum"
        )
    ):
        raise SystemExit(
            "sweep: error: --schedule layered with --distributed needs a "
            "QC-structured --code and a bp/min-sum decoder"
        )

    # Full cartesian grid in the SAME field order (and therefore the same
    # --resume keys) as the single-device route.
    fields = ("snr", "ymax", "nq", "alpha", "delta", "theta",
              "noise_scale", "lam", "w", "theta0")
    grid = list(_it.product(
        snrs, args.ymax, args.nq, args.alpha, args.delta,
        args.theta, args.noise_scale, args.lam, args.w, args.theta0,
    ))
    if args.resume:
        done = set()
        try:
            with open(args.log + ".done") as f:
                done.update(line.rstrip("\n") for line in f)
        except FileNotFoundError:
            pass
        grid = [pt for pt in grid if _grid_key(pt) not in done]
        if not grid:
            print("sweep: all points already done", file=sys.stderr)
            return 0

    nd = len(jax.devices())

    if args.decoder == "nbqspa":
        # NB path: SNR-only grid through its own driver (unchanged).
        from ..parallel.montecarlo_nb import simulate_nb_distributed

        if nd % len(snrs):
            raise SystemExit(
                f"sweep: error: --distributed nbqspa needs "
                f"len(snrs)={len(snrs)} to divide the device count ({nd})"
            )
        mesh = make_mesh(n_snr=len(snrs))
        nb_stats = simulate_nb_distributed(
            code, snrs, mesh, T, rate=rate, stop=stop,
            batch_per_device=args.batch, seed=args.seed,
            early_termination=args.early_termination,
            storage_dtype=jnp.float16 if args.msg_dtype == "f16" else None,
        )
        for snr, st in zip(snrs, nb_stats):
            row = "\t".join(
                fmt(v)
                for v in (snr, st.ser, st.ber, st.avg_iterations, st.fer, T)
            ) + f"\t{alist_name}"
            append_row(args.log, row)
            print(
                f"SNR={snr} SER={st.ser:.4g} BER={st.ber:.4g} "
                f"frames={st.total_words}",
                file=sys.stderr,
            )
        return 0

    # Per-decoder wiring: which grid fields become per-point traced
    # scalars (with their defaults), the decode/preprocess closures over
    # the traced point dict, and the per-point log-row builder.  A
    # multi-valued parameter the decoder cannot consume per-point is a
    # configuration error — erroring beats silently dropping grid points.
    multi = {
        nm: vals for nm, vals in zip(fields[1:], (
            args.ymax, args.nq, args.alpha, args.delta, args.theta,
            args.noise_scale, args.lam, args.w, args.theta0,
        )) if len(vals) > 1
    }

    def _reject_unsweepable(sweepable):
        bad = sorted(set(multi) - set(sweepable))
        if bad:
            raise SystemExit(
                f"sweep: error: --distributed {args.decoder} cannot sweep "
                f"{', '.join('--' + b.replace('_', '-') for b in bad)} "
                "per-point (not an operating-point scalar of this decoder)"
            )

    max_it = T

    defaults = {}
    if args.decoder == "bp":
        _reject_unsweepable(())
        param_names = ()
        bp_sdt = jnp.float16 if args.msg_dtype == "f16" else None

        if args.schedule == "layered":
            from ..decoders.bp_layered import decode_bp_layered_qc

            def dec(y, sigma, key, point):
                n0 = 2.0 * sigma * sigma
                return decode_bp_layered_qc(
                    qc, jnp.clip(4.0 * y / n0, -20.0, 20.0), T,
                    early_termination=args.early_termination,
                )
        else:
            def dec(y, sigma, key, point):
                n0 = 2.0 * sigma * sigma
                return decode_bp(
                    code, jnp.clip(4.0 * y / n0, -20.0, 20.0), T,
                    early_termination=args.early_termination,
                    storage_dtype=bp_sdt,
                )

        preprocess = None

        def row_fn(snr, st, pt):
            return bp_log_row(snr, st, T, alist_name)

    elif args.decoder in ("minsum", "offsetminsum", "normalizedminsum"):
        variant = {"minsum": "plain", "offsetminsum": "offset",
                   "normalizedminsum": "normalized"}[args.decoder]
        sdt = jnp.float16 if args.msg_dtype == "f16" else None
        if args.schedule == "layered":
            from ..decoders.minsum_layered import (
                decode_minsum_layered_qc as _dml,
            )

            def _ms_decode(y, alpha, delta):
                return _dml(
                    qc, y, T, variant=variant, alpha=alpha, delta=delta,
                    early_termination=args.early_termination,
                    storage_dtype=sdt,
                )
        else:
            def _ms_decode(y, alpha, delta):
                return decode_minsum(
                    code, y, T, variant=variant, alpha=alpha, delta=delta,
                    early_termination=args.early_termination,
                    storage_dtype=sdt,
                )
        if variant == "plain":
            _reject_unsweepable(())
            param_names = ()
            preprocess = None

            def dec(y, sigma, key, point):
                return _ms_decode(y, 1.0, 0.0)
        else:
            param_names = ("ymax", "nq", "alpha", "delta")
            _reject_unsweepable(param_names)

            def preprocess(y, point):
                return quantize_no_zero(y, point["ymax"], point["nq"])

            def dec(y, sigma, key, point):
                return _ms_decode(y, point["alpha"], point["delta"])

        defaults = dict(ymax=2.0, nq=8.0, alpha=1.0, delta=0.0)

        def row_fn(snr, st, pt):
            return minsum_log_row(
                snr, st, T, alist_name,
                ymax=pt["ymax"] if variant != "plain" else None,
                alpha=pt["alpha"] if variant == "normalized" else None,
                delta=pt["delta"] if variant == "offset" else None,
            )

    elif args.decoder == "gdbf":
        from ..channel.quantize import quantize_round as _qr
        from ..channel.quantize import saturate as _sat
        from ..decoders.gdbf import preset as _preset
        from ..decoders.dense_ops import DenseGraph, dense_worthwhile

        param_names = ("theta", "noise_scale", "lam", "alpha")
        sat_on = args.ymax[0] is not None
        if sat_on:
            param_names = param_names + ("ymax",)
        _reject_unsweepable(param_names)
        if len(args.nq) > 1:
            raise SystemExit(
                "sweep: error: --distributed gdbf cannot sweep --nq "
                "(quantizer bit-width is structural)"
            )
        gd_nq = args.nq[0]
        base_cfg = _preset(
            args.preset, num_iterations=T, theta=-0.9,
            **{k: v for k, v in dict(
                window_size=args.window,
                max_phases=args.max_phases,
                uniform_noise=args.uniform_noise or None,
            ).items() if v is not None},
        )
        max_it = T * base_cfg.max_phases
        dense = (
            DenseGraph.from_code(code)
            if qc is None and dense_worthwhile(code)
            else None
        )

        def preprocess(y, point):
            out = y
            if sat_on:
                out = _sat(out, point["ymax"])
            if gd_nq is not None:
                out = _qr(
                    out,
                    point["ymax"] if sat_on else 2.25,
                    int(gd_nq),
                )
            return out

        if not sat_on and gd_nq is None:
            preprocess = None

        def dec(y, sigma, key, point):
            cfg = _dc.replace(
                base_cfg, theta=point["theta"],
                noise_scale=point["noise_scale"], lam=point["lam"],
                alpha=point["alpha"],
            )
            return decode_gdbf(
                code, y, sigma, cfg, key=key, qc=qc, dense=dense
            )

        defaults = dict(
            theta=-0.9, noise_scale=base_cfg.noise_scale,
            lam=base_cfg.lam, alpha=base_cfg.alpha, ymax=None,
        )

        def row_fn(snr, st, pt):
            c = base_cfg
            return gdbf_log_row(
                snr, st, T, pt["theta"], alist_name,
                noise_scale=pt["noise_scale"]
                if c.add_noise or c.quantize_probabilities
                else None,
                nq=int(gd_nq) if gd_nq is not None else None,
                lam=pt["lam"] if c.threshold_adaptation else None,
                alpha=pt["alpha"] if c.weight_syndromes else None,
                smoothing_used=int(st.extra.get("smoothing_used", 0))
                if c.output_smoothing else None,
                window_size=c.window_size if c.output_smoothing else None,
                ymax=pt["ymax"] if sat_on else None,
            )

    elif args.decoder == "ddbmp":
        param_names = ("ymax", "nq")
        _reject_unsweepable(param_names)

        def preprocess(y, point):
            return quantize_no_zero(y, point["ymax"], point["nq"])

        def dec(y, sigma, key, point):
            if qc is not None:
                return decode_ddbmp_qc(qc, y, T)
            return decode_ddbmp(code, y, T)

        defaults = dict(ymax=1.5, nq=8.0)

        def row_fn(snr, st, pt):
            return minsum_log_row(snr, st, T, alist_name, ymax=pt["ymax"])

    elif args.decoder == "ngdbfhw":
        from ..decoders.dense_ops import DenseGraph, dense_worthwhile

        param_names = ("w", "ymax", "noise_scale", "theta0")
        _reject_unsweepable(param_names)
        # Same fixed-frame-count semantics as the non-distributed route
        # (NGDBFhw.cpp:193): --frames overrides the error-count stop rule
        # so distributed and single-device runs are statistically
        # comparable.
        stop = StopRule.fixed_frames(args.frames)
        hw_base = NGDBFHwConfig(
            num_iterations=T,
            max_phases=args.max_phases or 1,
            ring_len=max(2648, code.n + 600),
        )
        max_it = T * hw_base.max_phases
        hw_dense = (
            DenseGraph.from_code(code)
            if qc is None and dense_worthwhile(code)
            else None
        )

        def dec(y, sigma, key, point):
            cfg = _dc.replace(
                hw_base, w=point["w"], ymax=point["ymax"],
                noise_scale=point["noise_scale"], theta0=point["theta0"],
            )
            return decode_ngdbf_hw(
                code, y, sigma, cfg, key=key, dense=hw_dense, qc=qc
            )

        preprocess = None
        defaults = dict(
            w=0.185, ymax=1.625, noise_scale=0.95, theta0=-0.525
        )

        def row_fn(snr, st, pt):
            return ngdbfhw_log_row(
                snr, st, T, pt["theta0"], pt["noise_scale"], pt["w"],
                pt["ymax"], hw_base.nq, hw_base.max_phases, args.seed,
            )

    else:
        raise SystemExit(
            "sweep: error: --distributed supports bp, min-sum variants, "
            "gdbf, ddbmp, ngdbfhw, and nbqspa"
        )

    # grid tuples -> per-point parameter dicts (defaults fill Nones)
    points = []
    for pt in grid:
        vals = dict(zip(fields, pt))
        point = {"snr": vals["snr"]}
        for nm in param_names:
            v = vals[nm]
            point[nm] = float(defaults[nm] if v is None else v)
        points.append(point)

    # Every device is an operating-point slot; simulate_grid cycles the
    # unfinished points over the slots, so any grid size works on any
    # device count (no divisibility requirement).
    mesh = make_mesh(n_snr=nd)
    stats_list = simulate_grid(
        code, dec, points, mesh, max_iterations=max_it, rate=rate,
        stop=stop, batch_per_device=args.batch, seed=args.seed,
        preprocess=preprocess, param_names=param_names,
        codewords=codewords, verbose=args.verbose,
    )
    for pt, point, st in zip(grid, points, stats_list):
        snr = point["snr"]
        append_row(args.log, row_fn(snr, st, point))
        if args.decoder == "ngdbfhw":
            # iteration-completion CDF file (NGDBFhw.cpp:464-469); on a
            # multi-parameter grid the parameters join the filename so
            # points sharing an SNR don't clobber each other
            suffix = "".join(
                f"_{nm}{point[nm]:g}" for nm in param_names
                if len(getattr(args, nm)) > 1
            )
            cdf = (
                st.iteration_cdf_biased()
                if args.itdist_biased
                else st.iteration_cdf()
            )
            with open(
                f"{args.log}_{snr:g}{suffix}_itdist.dat", "w"
            ) as f:
                for idx, v in enumerate(cdf):
                    f.write(f"{idx}\t{v:.6g}\n")
        print(
            f"SNR={snr} "
            + " ".join(
                f"{nm}={point[nm]:g}" for nm in param_names
            )
            + (" " if param_names else "")
            + f"BER={st.ber:.4g} FER={st.fer:.4g} frames={st.total_words}",
            file=sys.stderr,
        )
        if args.resume:
            _mark_done(args.log, _grid_key(pt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
