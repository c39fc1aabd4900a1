"""Compile-and-run check of the Monte-Carlo main path on NVIDIA GPUs.

Drives channel -> decode -> error counting through the entry points users
call (``tools.sweep``, the stream harness, the device mesh) at real code
sizes, and compares the decoders with their plain references on the card:

  P0  device: platform, device kind, versions, compile cache, card name
  P1  flagship min-sum T=10 on qc_1008_504 through the sweep CLI
  P2  streaming vs batched early-terminating drivers; the reference stop rule
  P3  the real DVB-S2 rate-1/2 (64800,32400) code, flooding and layered
  P4  every decoder family and stream adapter, and the distributed grid step
  P5  comparisons with the plain references on the card
  P6  report: peak device bytes, compile and run seconds, device times

    python chip_smoke.py               # one card, P0-P6
    python chip_smoke.py --four-cards  # sharded stream + distributed grid

Everything runs in this one process: a JAX process reserves most of a
card's memory, so a second one on the same card would fail.  A failed
phase prints its error and the script exits 1 after the other phases ran.
The last line of standard output is one JSON object naming the device.
Without a GPU the script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import Callable, List, Tuple

import numpy as np

from ldpcsimulation_tpu.runtime import enable_compile_cache, require_gpu

#: BER of min-sum T=10 on qc_1008_504 at 2.0 dB, measured over 66M bits
#: (codes/library.py).  Frame errors are correlated, so the 3% bound is
#: wider than the binomial sigma of a 131072-frame run.
FLAGSHIP_BER = 2.40e-2


class CheckFailed(AssertionError):
    """A phase's result is wrong (as opposed to a crash)."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def check_rel(what: str, got: float, want: float, tol: float) -> None:
    rel = abs(got - want) / want
    check(
        math.isfinite(got) and rel <= tol,
        f"{what}: {got:.6g} vs {want:.6g} ({100 * rel:.2f}% > {100 * tol:g}%)",
    )


@dataclasses.dataclass(frozen=True)
class Widths:
    """Sizes of every phase.  The defaults are the real widths run on the
    card; the CPU tests pass tiny ones."""

    flagship_batch: int = 32768
    flagship_frames: int = 131072
    stream_lanes: int = 16384
    ber_tol: float = 0.03
    standard_code: str = "dvbs2_1_2_qc"
    standard_frames: int = 512
    frames: int = 4096  # frames (or stream lanes) per P4 family check
    generic: str = "peg_1008_504"
    qc: Tuple[str, ...] = ("qc_1008_504", "wifi_1944_972")
    #: PEG (n, m, dv, seed): the alist of the named highrate_2048_384 code
    highrate: Tuple[int, int, int, int] = (2048, 384, 6, 8)
    #: rs_ldpc (field bits, slopes, strata): the 802.3an (2048,384) layout
    rs: Tuple[int, int, int] = (6, 32, 6)
    ddbmp_code: str = "reg4_4000_2000"
    #: GF(q) random regular (n, m, dv, q) codes in the size class of the
    #: reference's GF(4) (9000,6000) and GF(8) (6000,4000) codes
    nb: Tuple[Tuple[int, int, int, int], ...] = (
        (9000, 6000, 3, 4), (6000, 4000, 3, 8),
    )
    compare_frames: int = 32768
    prior_frames: int = 256
    prior_symbols: int = 1000
    timing_reps: int = 20


class CompileClock:
    """Sums the backend compile seconds JAX reports, per compiling thread,
    for per-phase and per-program splits."""

    def __init__(self):
        import jax

        self._by_thread = collections.defaultdict(float)
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_kw) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            self._by_thread[threading.get_ident()] += duration

    @property
    def total(self) -> float:
        """Compile seconds of every thread."""
        return sum(self._by_thread.values())

    def mine(self) -> float:
        """Compile seconds of the calling thread."""
        return self._by_thread[threading.get_ident()]


def card_line() -> str:
    """Each card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return "; ".join(out.stdout.strip().splitlines())


def log(msg: str = "") -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ helpers


def run_sweep(log_dir: str, name: str, argv: List[str], clock: CompileClock):
    """``sweep.main(argv + --log)`` in this process.

    Returns (log rows split on tabs, frames per point from the progress
    lines, wall seconds, compile seconds)."""
    from ldpcsimulation_tpu.tools import sweep

    path = os.path.join(log_dir, f"{name}.log")
    err = io.StringIO()
    c0 = clock.mine()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            rc = sweep.main(argv + ["--log", path])
    except SystemExit as e:  # argument and routing errors of the CLI
        rc = e.code
    wall = time.perf_counter() - t0
    for line in err.getvalue().splitlines():
        log(f"    {line}")
    check(rc == 0, f"sweep {name} exited {rc}")
    with open(path) as f:
        rows = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    frames = [int(x) for x in re.findall(r"frames=(\d+)", err.getvalue())]
    return rows, frames, wall, clock.mine() - c0


def uncoded_ber(snr_db: float, rate: float) -> float:
    """BPSK hard-decision bit error rate at Eb/N0 = snr_db."""
    ebn0 = 10 ** (snr_db / 10)
    return 0.5 * math.erfc(math.sqrt(rate * ebn0))


def channel(seed: int, frames: int, n: int, snr_db: float, rate: float):
    """(y [frames, n] all-zero codeword samples, sigma, n0)."""
    import jax
    import jax.numpy as jnp

    from ldpcsimulation_tpu.channel import snr_to_n0

    n0 = float(snr_to_n0(snr_db, rate))
    sigma = math.sqrt(n0 / 2)
    y = 1.0 + sigma * jax.random.normal(
        jax.random.key(seed), (frames, n), jnp.float32
    )
    return y, sigma, n0


def bit_errors(hard) -> int:
    """Bit errors of ±1 decisions against the all-zero codeword."""
    import jax.numpy as jnp

    return int(jnp.sum(hard != 1))


# ----------------------------------------------------------------- phases


def phase_flagship(w: Widths, log_dir: str, clock: CompileClock,
                   card: str) -> dict:
    """P1: the flagship point through the sweep CLI; BER vs the 66M-bit
    measurement, and the rate this run reached."""
    rows, frames, wall, comp = run_sweep(log_dir, "p1", [
        "minsum", "--code", "qc_1008_504", "--snr", "2.0", "-T", "10",
        "--batch", str(w.flagship_batch), "--msg-dtype", "f16",
        "--max-frames", str(w.flagship_frames), "--min-errors", "10000000",
    ], clock)
    check(frames == [w.flagship_frames], f"P1 frames {frames}")
    ber = float(rows[0][1])
    log(f"  P1 BER {ber:.6g} over {frames[0]} frames "
        f"(reference {FLAGSHIP_BER:g}, bound {100 * w.ber_tol:g}%)")
    check_rel("P1 BER", ber, FLAGSHIP_BER, w.ber_tol)
    run_s = wall - comp
    log(f"  P1 rate on {card}: {frames[0] / run_s:.6g} frames/s, "
        f"{frames[0] * 504 / run_s:.6g} info bits/s "
        f"(sweep wall {wall:.3f} s less {comp:.3f} s backend compile; "
        "tracing, lowering and the host loop included; smoke reading, not "
        "a benchmark)")
    return {"ber": ber, "frames_per_s": frames[0] / run_s}


def phase_stream(w: Widths, log_dir: str, clock: CompileClock) -> dict:
    """P2: the stream driver against the batched early-terminating driver
    on the same point, and the reference stop rule (>=200 bit errors,
    >=20 word errors) with the adaptive stop and the drain."""
    point = [
        "minsum", "--code", "qc_1008_504", "--snr", "2.0", "-T", "10",
        "--early-termination", "--batch", str(w.stream_lanes),
        "--msg-dtype", "f16", "--max-frames", str(w.flagship_frames),
        "--min-errors", "10000000",
    ]
    srows, sframes, _, _ = run_sweep(
        log_dir, "p2_stream", point + ["--stream"], clock
    )
    brows, bframes, _, _ = run_sweep(log_dir, "p2_batched", point, clock)
    check(sframes[0] >= w.flagship_frames, f"P2 stream frames {sframes}")
    check(bframes == [w.flagship_frames], f"P2 batched frames {bframes}")
    s_ber, b_ber = float(srows[0][1]), float(brows[0][1])
    log(f"  P2 BER stream {s_ber:.6g} ({sframes[0]} frames), batched "
        f"{b_ber:.6g} ({bframes[0]} frames)")
    check_rel("P2 stream vs batched BER", s_ber, b_ber, w.ber_tol)

    rows, frames, _, _ = run_sweep(log_dir, "p2_stop", [
        "minsum", "--code", "qc_1008_504", "--snr", "2.4", "-T", "10",
        "--early-termination", "--stream", "--batch", str(w.stream_lanes),
        "--msg-dtype", "f16", "--min-errors", "200",
        "--min-word-errors", "20",
    ], clock)
    ber, fer = float(rows[0][1]), float(rows[0][3])
    errs = round(ber * frames[0] * 1008)
    werrs = round(fer * frames[0])
    log(f"  P2 stop rule at 2.4 dB: {errs} bit errors, {werrs} word errors "
        f"in {frames[0]} frames, BER {ber:.6g}")
    check(errs >= 200 and werrs >= 20, "P2 stop rule not met")
    return {"stream_ber": s_ber, "batched_ber": b_ber}


def phase_standard(w: Widths, log_dir: str, clock: CompileClock) -> dict:
    """P3: the real DVB-S2 rate-1/2 code, flooding and layered min-sum at
    T=10 and 30 through the sweep CLI, with each program's compile
    seconds.  At 2.0 dB every schedule decodes below the uncoded BER
    (below ~1.4 dB T<=50 does not).

    The four points run in four threads: tracing holds the interpreter
    lock, but XLA compiles the four programs at once, and these are the
    slowest compiles of the run."""
    from ldpcsimulation_tpu.tools import sweep

    snr = 2.0

    def point(schedule, t):
        name = f"p3_{schedule}_T{t}"
        path = os.path.join(log_dir, f"{name}.log")
        c0 = clock.mine()
        t0 = time.perf_counter()
        rc = sweep.main([
            "minsum", "--code", w.standard_code, "--snr", str(snr),
            "-T", str(t), "--schedule", schedule,
            "--batch", str(w.standard_frames), "--msg-dtype", "f16",
            "--max-frames", str(w.standard_frames),
            "--min-errors", "1000000000", "--log", path,
        ])
        wall = time.perf_counter() - t0
        check(rc == 0, f"sweep {name} exited {rc}")
        with open(path) as f:
            ber = float(f.readline().split("\t")[1])
        return name, ber, clock.mine() - c0, wall

    grid = [(s, t) for s in ("flooding", "layered") for t in (10, 30)]
    with concurrent.futures.ThreadPoolExecutor(len(grid)) as pool:
        results = list(pool.map(lambda st: point(*st), grid))
    out = {}
    for name, ber, comp, wall in results:
        log(f"  P3 {w.standard_code} {name[3:]}: BER {ber:.6g} over "
            f"{w.standard_frames} frames, compile {comp:.3f} s, "
            f"wall {wall:.3f} s (4 points at once)")
        check(0.0 <= ber < uncoded_ber(snr, 0.5), f"{name} BER {ber}")
        out[name] = {"ber": ber, "compile_s": comp}
    return out


def family_checks(w: Widths) -> List[Tuple[str, Callable[[], Tuple[int, int]]]]:
    """P4's checks: (name, fn) with fn() -> (decoded errors, uncoded errors)
    over the check's frames; a working decoder has fewer."""
    import jax
    import jax.numpy as jnp

    from ldpcsimulation_tpu.channel import llr_from_channel
    from ldpcsimulation_tpu.channel.nb import symbol_priors
    from ldpcsimulation_tpu.channel.quantize import (
        quantize_no_zero,
        quantize_round,
        saturate,
    )
    from ldpcsimulation_tpu.codes import build_code
    from ldpcsimulation_tpu.codes.construct import nb_regular, peg
    from ldpcsimulation_tpu.codes.library import load_named_code, load_named_qc
    from ldpcsimulation_tpu.codes.stratified import stratify
    from ldpcsimulation_tpu.decoders import (
        NGDBFHwConfig,
        SystemCNGDBFConfig,
        decode_bp,
        decode_bp_layered_qc,
        decode_bp_qc,
        decode_ddbmp,
        decode_gdbf,
        decode_minsum,
        decode_minsum_layered_qc,
        decode_minsum_qc,
        decode_nb_minsum,
        decode_nb_qspa,
        decode_ngdbf_hw,
        decode_ngdbf_systemc,
        preset,
    )
    from ldpcsimulation_tpu.decoders.bp_stratified import decode_bp_stratified
    from ldpcsimulation_tpu.decoders.ddbmp import decode_ddbmp_stratified
    from ldpcsimulation_tpu.decoders.dense_ops import DenseGraph
    from ldpcsimulation_tpu.decoders.minsum_stratified import (
        decode_minsum_stratified,
    )
    from ldpcsimulation_tpu.harness import stream as hs
    from ldpcsimulation_tpu.harness import stream_gdbf as hg
    from ldpcsimulation_tpu.harness import stream_ngdbfhw as hh

    f = w.frames
    key = jax.random.key(11)
    checks = []

    def add(name, fn):
        checks.append((name, fn))

    def unc(y):
        return int(jnp.sum(y <= 0))

    def bits(code, snr, decode, seed=1):
        """Decode all-zero frames at snr with decode(y, sigma, n0)."""
        y, sigma, n0 = channel(seed, f, code.n, snr, code.rate)
        return bit_errors(decode(y, sigma, n0).hard), unc(y)

    # generic slot-array gathers
    gen = load_named_code(w.generic)
    for et in (False, True):
        tag = " ET" if et else ""
        add(f"minsum{tag} {w.generic}", lambda et=et: bits(
            gen, 2.0, lambda y, s, n0: decode_minsum(
                gen, y, 10, early_termination=et)))
        add(f"bp{tag} {w.generic}", lambda et=et: bits(
            gen, 2.0, lambda y, s, n0: decode_bp(
                gen, llr_from_channel(y, n0), 10, early_termination=et)))

    # QC rolls, flooding and layered
    for name in w.qc:
        qc = load_named_qc(name)
        qcode = qc.to_code()
        add(f"minsum_qc f16 {name}", lambda qc=qc, c=qcode: bits(
            c, 2.0, lambda y, s, n0: decode_minsum_qc(
                qc, y, 10, storage_dtype=jnp.float16)))
        add(f"bp_qc f16 {name}", lambda qc=qc, c=qcode: bits(
            c, 2.0, lambda y, s, n0: decode_bp_qc(
                qc, llr_from_channel(y, n0), 10,
                storage_dtype=jnp.float16)))
        add(f"minsum layered {name}", lambda qc=qc, c=qcode: bits(
            c, 2.0, lambda y, s, n0: decode_minsum_layered_qc(qc, y, 10)))
        add(f"bp layered {name}", lambda qc=qc, c=qcode: bits(
            c, 2.0, lambda y, s, n0: decode_bp_layered_qc(
                qc, llr_from_channel(y, n0), 10)))

    # stratified one-hot (802.3an class) and dense matmul graph ops
    hn, hm, hdv, hseed = w.highrate
    h_alist = peg(hn, hm, hdv, seed=hseed)
    hcode = build_code(h_alist)
    sc = stratify(h_alist)
    dg = DenseGraph.from_code(hcode)
    h_snr = 5.0  # in the reference's 802.3an NGDBFhw range, 4.5-5.4 dB
    add("minsum_strat f16 highrate", lambda: bits(
        hcode, h_snr, lambda y, s, n0: decode_minsum_stratified(
            sc, y, 10, early_termination=True, storage_dtype=jnp.float16)))
    add("bp_strat highrate", lambda: bits(
        hcode, h_snr, lambda y, s, n0: decode_bp_stratified(
            sc, llr_from_channel(y, n0), 10, early_termination=True)))
    def ddbmp_strat():
        # The default quantizer (Ymax 1.5, 8 levels); DD-BMP decodes this
        # class at 6 dB, not at h_snr.  Greedy strata sum the accumulator
        # in another order than the generic decoder, so a frame near a
        # decision boundary may end differently (decoders/ddbmp.py): the
        # two decoders' word errors on the same frames must agree within
        # 3 sigma.  P5 holds contiguous strata to per-frame equality.
        y, _, _ = channel(1, f, hcode.n, 6.0, hcode.rate)
        yq = quantize_no_zero(y, 1.5, 8.0)
        a = decode_ddbmp_stratified(sc, yq, 50)
        b = decode_ddbmp(hcode, yq, 50)
        wa = int(jnp.sum(jnp.any(a.hard != 1, axis=1)))
        wb = int(jnp.sum(jnp.any(b.hard != 1, axis=1)))
        check(abs(wa - wb) <= 3 * math.sqrt(wa + wb),
              f"word errors stratified {wa} vs generic {wb}")
        return bit_errors(a.hard), unc(y)

    add("ddbmp_strat highrate", ddbmp_strat)
    for phases in (1, 3):
        cfg_hw = NGDBFHwConfig(num_iterations=200, max_phases=phases,
                               ring_len=max(2648, hcode.n + 600))
        add(f"ngdbf_hw dense {phases}ph highrate", lambda cfg=cfg_hw: bits(
            hcode, h_snr, lambda y, s, n0: decode_ngdbf_hw(
                hcode, y, s, cfg, key=key, dense=dg)))

    # GDBF family, gathers and QC ops
    qc0 = load_named_qc(w.qc[0])
    for label, code, qcx in ((w.generic, gen, None),
                             (w.qc[0], qc0.to_code(), qc0)):
        sm = preset("SMNGDBF", 100, -0.9, noise_scale=0.975, lam=0.988,
                    alpha=0.75, window_size=64)
        st = preset("StochasticNGDBF", 100, -0.9, noise_scale=0.975,
                    alpha=0.75)
        rd = preset("RSMNGDBF", 50, -0.9, noise_scale=0.975, lam=0.988,
                    alpha=0.75, window_size=32, max_phases=3)
        for tag, cfg in (("SM-NGDBF", sm), ("stochastic", st),
                         ("redecode", rd)):
            # the stochastic build reads saturated 3-bit samples
            pre = ((lambda y: quantize_round(saturate(y, 2.5), 2.5, 3))
                   if cfg.quantize_probabilities else (lambda y: y))
            add(f"gdbf {tag} {label}",
                lambda c=code, q=qcx, cfg=cfg, pre=pre: bits(
                    c, 3.5, lambda y, s, n0: decode_gdbf(
                        c, pre(y), s, cfg, key=key, qc=q)))
    add(f"ngdbf_systemc {w.generic}", lambda: bits(
        gen, 4.0, lambda y, s, n0: decode_ngdbf_systemc(
            gen, y, s, SystemCNGDBFConfig(100, -0.5), key=key)))

    # DD-BMP on the MacKay (4000,2000) class
    dcode = load_named_code(w.ddbmp_code)
    add(f"ddbmp {w.ddbmp_code}", lambda: bits(
        dcode, 3.9, lambda y, s, n0: decode_ddbmp(
            dcode, quantize_no_zero(y, 1.5, 8.0), 50)))

    # non-binary: FFT-QSPA (f32, log-f16), min-sum, min-max
    for nn, nm, ndv, q in w.nb:
        nbc = build_code(nb_regular(nn, nm, ndv, q=q, seed=1))
        mbits = q.bit_length() - 1
        snr_nb = 2.4

        def nb_errs(decode, nbc=nbc, mbits=mbits, q=q):
            rate = (nbc.n - nbc.m) / nbc.n
            yb, _, n0 = channel(3, f * nbc.n, mbits, snr_nb, rate)
            yb = yb.reshape(f, nbc.n, mbits)
            pri = symbol_priors(yb, n0, q)
            sym = decode(nbc, pri).symbols
            return (int(jnp.sum(sym != 0)),
                    int(jnp.sum(jnp.argmax(pri, axis=-1) != 0)))

        add(f"nb_qspa GF({q})", lambda e=nb_errs: e(
            lambda c, p: decode_nb_qspa(c, p, 10)))
        add(f"nb_qspa log-f16 GF({q})", lambda e=nb_errs: e(
            lambda c, p: decode_nb_qspa(c, p, 10,
                                        storage_dtype=jnp.float16)))
        add(f"nb_minsum GF({q})", lambda e=nb_errs: e(
            lambda c, p: decode_nb_minsum(c, p, 10)))
        add(f"nb_minmax GF({q})", lambda e=nb_errs: e(
            lambda c, p: decode_nb_minsum(c, p, 10, variant="minmax")))

    # the six stream adapters: one pool + one call each (GDBF also drains)
    def stream_call(sdec, code_n, snr, rate, pre=None, pool_dtype=None):
        sigma = channel_sigma(snr, rate)
        pool, unc_, sat0 = hs.build_channel_pool(
            sdec, jax.random.key(1), 0, 2 * f, code_n, sigma, pre,
            pool_dtype=pool_dtype,
        )
        state = hs.stream_init(sdec, f, code_n, pool_dtype or jnp.float32)
        call = hs.make_stream_call(sdec, code_n, 10, 12, 2)
        _, acc, _ = call(state, pool, unc_, sat0, jnp.int32(0))
        check(int(acc["frames"]) > 0, "stream retired no frame")
        return int(acc["bit_errs"]), int(acc["unc_sum"])

    add(f"stream minsum_qc f16 {w.qc[0]}", lambda: stream_call(
        hs.minsum_qc_stream(qc0, storage_dtype=jnp.float16), qc0.n, 2.0,
        0.5, pool_dtype=jnp.float16))
    add(f"stream layered f16 {w.qc[0]}", lambda: stream_call(
        hs.minsum_layered_qc_stream(qc0, storage_dtype=jnp.float16),
        qc0.n, 2.0, 0.5, pool_dtype=jnp.float16))
    add(f"stream ddbmp {w.qc[0]}", lambda: stream_call(
        hs.ddbmp_qc_stream(qc0), qc0.n, 3.9, 0.5,
        pre=lambda y: quantize_no_zero(y, 1.5, 8.0)))
    add("stream minsum_strat f16 highrate", lambda: stream_call(
        hs.minsum_stratified_stream(sc, storage_dtype=jnp.float16), hcode.n,
        h_snr, hcode.rate))

    def gdbf_stream():
        code = qc0.to_code()
        cfg = preset("SMNGDBF", 100, -0.9, noise_scale=0.975, lam=0.988,
                     alpha=0.75, window_size=64)
        sigma = channel_sigma(3.5, 0.5)
        pool, unc_, sat0 = hg.build_channel_pool_gdbf(
            code, jax.random.key(1), 0, 2 * f, sigma, qc=qc0
        )
        state = hg.gdbf_stream_init(code, cfg, f)
        call = hg.make_gdbf_stream_call(code, 12, 8, qc=qc0)
        state, acc, _ = call(state, pool, unc_, sat0, jnp.int32(0),
                             jax.random.key(2), sigma, cfg)
        # drain: the pool is pre-exhausted, lanes only retire
        _, acc2, _ = call(state, pool, unc_, sat0, jnp.int32(0),
                          jax.random.key(2), sigma, cfg, int(pool.shape[0]))
        check(int(acc["frames"]) > 0, "gdbf stream retired no frame")
        return (int(acc["bit_errs"]) + int(acc2["bit_errs"]),
                int(acc["unc_sum"]) + int(acc2["unc_sum"]))

    add(f"stream gdbf SM-NGDBF {w.qc[0]} (+drain)", gdbf_stream)

    def hw_stream():
        cfg = NGDBFHwConfig(num_iterations=200,
                            ring_len=max(2648, hcode.n + 600))
        sigma = channel_sigma(h_snr, hcode.rate)
        pool, unc_, sat0 = hh.build_channel_pool_hw(
            hcode, jax.random.key(1), 0, 2 * f, sigma, dense=dg
        )
        state = hh.hw_stream_init(hcode, cfg, f)
        call = hh.make_hw_stream_call(hcode, cfg, 12, 16, dense=dg)
        _, acc, _ = call(state, pool, unc_, sat0, jnp.int32(0),
                         jax.random.key(2), sigma)
        check(int(acc["frames"]) > 0, "ngdbfhw stream retired no frame")
        return int(acc["bit_errs"]), int(acc["unc_sum"])

    add("stream ngdbf_hw dense highrate", hw_stream)
    return checks


def channel_sigma(snr_db: float, rate: float) -> float:
    from ldpcsimulation_tpu.channel import snr_to_sigma

    return float(snr_to_sigma(snr_db, rate))


def phase_families(w: Widths, log_dir: str, clock: CompileClock) -> dict:
    """P4: compile and run every decoder family and stream adapter, then
    the operating-point grid step through ``sweep --distributed``."""
    failed = []
    out = {}
    for name, fn in family_checks(w):
        c0 = clock.total
        t0 = time.perf_counter()
        try:
            dec, unc = fn()
            check(0 <= dec <= unc, f"decoded {dec} > uncoded {unc} errors")
        except Exception as e:  # every family runs; failures are collected
            log(f"  FAIL {name}: {type(e).__name__}: {e}")
            failed.append(name)
            continue
        wall = time.perf_counter() - t0
        comp = clock.total - c0
        out[name] = (dec, unc)
        log(f"  ok   {name}: {dec} decoded vs {unc} uncoded errors "
            f"(compile {comp:.2f} s, wall {wall:.2f} s)")
    grid_step(w, log_dir, clock)
    check(not failed, f"{len(failed)} family checks failed: {failed}")
    return out


def grid_step(w: Widths, log_dir: str, clock: CompileClock) -> List[float]:
    """The operating-point grid step: two points through
    ``sweep --distributed`` on one card.  Returns their BERs."""
    rows, frames, _, comp = run_sweep(log_dir, "p4_grid", [
        "normalizedminsum", "--code", w.qc[0], "--snr", "2.0",
        "--alpha", "1.25", "1.5", "-T", "10", "--early-termination",
        "--distributed", "--batch", str(w.frames),
        "--max-frames", str(2 * w.frames), "--min-errors", "1000000000",
    ], clock)
    bers = [float(r[1]) for r in rows]
    log(f"  grid step, 2 points on 1 card: BER {bers}, frames {frames}, "
        f"compile {comp:.3f} s")
    check(len(rows) == 2 and all(0 <= b < uncoded_ber(2.0, 0.5)
                                 for b in bers), f"grid rows {rows}")
    return bers


def compare_qc_generic(w: Widths) -> int:
    """QC roll decoder vs the generic gather decoder on the same H, f32:
    frames whose decisions or iteration counts differ (expected 0)."""
    import jax.numpy as jnp

    from ldpcsimulation_tpu.codes.library import load_named_qc
    from ldpcsimulation_tpu.decoders import decode_minsum, decode_minsum_qc

    qc = load_named_qc(w.qc[0])
    y, _, _ = channel(21, w.compare_frames, qc.n, 2.0, 0.5)
    a = decode_minsum_qc(qc, y, 10, early_termination=True)
    b = decode_minsum(qc.to_code(), y, 10, early_termination=True)
    differ = jnp.any(a.hard != b.hard, axis=1) | (a.iterations != b.iterations)
    return int(jnp.sum(differ))


def compare_stratified_generic(w: Widths) -> Tuple[int, int]:
    """Stratified one-hot routing vs the generic gather decoder.

    Returns (interleaver mismatches, differing frames).  The one-hot
    einsums run at Precision.HIGHEST, so moving random f32 messages to
    the CN layout and back must be bit-exact (a TF32 dot would round the
    payloads): expected 0.  The decoders then agree frame by frame up to
    f32 rounding: greedy (non-contiguous) strata sum the VN messages in
    another order than the alist (decoders/minsum_stratified.py), so a
    frame whose posterior sits within rounding of a decision boundary may
    differ.  At the real widths (4096 frames, seed 22) 2 frames differ on
    the H100 and 4 on the CPU backend; bound: 6 frames.
    :func:`compare_rs_stratified` holds contiguous strata to 0."""
    import jax
    import jax.numpy as jnp

    from ldpcsimulation_tpu.codes import build_code
    from ldpcsimulation_tpu.codes.construct import peg
    from ldpcsimulation_tpu.codes.stratified import stratify
    from ldpcsimulation_tpu.decoders import decode_minsum
    from ldpcsimulation_tpu.decoders.minsum_stratified import (
        decode_minsum_stratified,
        stratified_to_cn,
        stratified_to_vn,
    )

    hn, hm, hdv, hseed = w.highrate
    alist = peg(hn, hm, hdv, seed=hseed)
    code = build_code(alist)
    sc = stratify(alist)
    x = jax.random.normal(jax.random.key(2),
                          (sc.mb, sc.kg, sc.w, w.frames), jnp.float32)
    x = jnp.where(sc.vn_valid[..., None], x, 0.0)
    back = stratified_to_vn(sc, stratified_to_cn(sc, x))
    mismatches = int(jnp.sum(back != x))

    y, _, _ = channel(22, w.frames, code.n, 4.0, code.rate)
    a = decode_minsum_stratified(sc, y, 10, early_termination=True)
    b = decode_minsum(code, y, 10, early_termination=True)
    differ = jnp.any(a.hard != b.hard, axis=1) | (a.iterations != b.iterations)
    return mismatches, int(jnp.sum(differ))


def compare_rs_stratified(w: Widths) -> Tuple[int, int]:
    """Stratified min-sum and DD-BMP (default quantizer, Ymax 1.5) vs the
    generic decoders on the RS-LDPC of the 802.3an layout: frames that
    differ, (min-sum, DD-BMP).  Contiguous strata sum in the alist's row
    order, so both are bit-exact: expected 0 and 0."""
    import jax.numpy as jnp

    from ldpcsimulation_tpu.channel.quantize import quantize_no_zero
    from ldpcsimulation_tpu.codes import build_code
    from ldpcsimulation_tpu.codes.construct import rs_ldpc
    from ldpcsimulation_tpu.codes.stratified import stratify
    from ldpcsimulation_tpu.decoders import decode_ddbmp, decode_minsum
    from ldpcsimulation_tpu.decoders.ddbmp import decode_ddbmp_stratified
    from ldpcsimulation_tpu.decoders.minsum_stratified import (
        decode_minsum_stratified,
    )

    alist = rs_ldpc(*w.rs)
    code = build_code(alist)
    sc = stratify(alist)

    def differ(a, b):
        d = jnp.any(a.hard != b.hard, axis=1) | (a.iterations != b.iterations)
        return int(jnp.sum(d))

    y, _, _ = channel(25, w.frames, code.n, 4.0, code.rate)
    ms = differ(decode_minsum_stratified(sc, y, 10, early_termination=True),
                decode_minsum(code, y, 10, early_termination=True))
    y, _, _ = channel(26, w.frames, code.n, 5.0, code.rate)
    yq = quantize_no_zero(y, 1.5, 8.0)
    dd = differ(decode_ddbmp_stratified(sc, yq, 50),
                decode_ddbmp(code, yq, 50))
    return ms, dd


def simulate_rows(code, snr_db: float, batch: int, batches: int,
                  seed: int) -> List[np.ndarray]:
    """The channel rows simulate()'s compiled batch step draws, taken by a
    host callback inside it (the decoder only takes hard decisions)."""
    import jax
    import jax.numpy as jnp

    from ldpcsimulation_tpu.decoders.base import DecodeResult
    from ldpcsimulation_tpu.harness.montecarlo import StopRule, simulate

    rows = []

    def capture(inp, key):
        jax.debug.callback(lambda v: rows.append(np.asarray(v)), inp,
                           ordered=True)
        b = inp.shape[0]
        return DecodeResult(hard=jnp.where(inp > 0, 1, -1),
                            iterations=jnp.zeros(b, jnp.int32),
                            satisfied=jnp.ones(b, bool))

    simulate(code, capture, snr_db,
             stop=StopRule.fixed_frames(batches * batch), batch_size=batch,
             seed=seed)
    jax.effects_barrier()
    return rows


def compare_replay_simulate(w: Widths) -> int:
    """tools.replay.replay_channel vs the rows simulate() drew on the card,
    flagship code and batch: replayed rows that differ in any bit
    (expected 0; both draws are compiled)."""
    from ldpcsimulation_tpu.channel import snr_to_n0
    from ldpcsimulation_tpu.codes.library import load_named_qc
    from ldpcsimulation_tpu.tools.replay import replay_channel

    code = load_named_qc(w.qc[0]).to_code()
    b, snr, seed = w.flagship_batch, 2.0, 27
    rows = simulate_rows(code, snr, b, 2, seed)
    check(len(rows) == 2, f"captured {len(rows)} batches")
    sigma = math.sqrt(float(snr_to_n0(snr, code.rate)) / 2.0)
    differ = 0
    for bi in range(2):
        for f in (0, b // 2, b - 1):
            y, _ = replay_channel(code, seed, bi, f, b, sigma)
            differ += int(np.any(y != rows[bi][f]))
    return differ


def compare_dense_gather(w: Widths) -> int:
    """NGDBFhw with dense 0/1 matmul graph ops vs gathers: frames that
    differ (expected 0: bf16 0/1 operands, exact f32 integer sums)."""
    import jax
    import jax.numpy as jnp

    from ldpcsimulation_tpu.codes import build_code
    from ldpcsimulation_tpu.codes.construct import peg
    from ldpcsimulation_tpu.decoders import NGDBFHwConfig, decode_ngdbf_hw
    from ldpcsimulation_tpu.decoders.dense_ops import DenseGraph

    hn, hm, hdv, hseed = w.highrate
    code = build_code(peg(hn, hm, hdv, seed=hseed))
    y, sigma, _ = channel(23, w.frames, code.n, 4.25, code.rate)
    cfg = NGDBFHwConfig(num_iterations=200, ring_len=max(2648, code.n + 600))
    key = jax.random.key(5)
    a = decode_ngdbf_hw(code, y, sigma, cfg, key=key,
                        dense=DenseGraph.from_code(code))
    b = decode_ngdbf_hw(code, y, sigma, cfg, key=key)
    differ = jnp.any(a.hard != b.hard, axis=1) | (a.iterations != b.iterations)
    return int(jnp.sum(differ))


def priors_reference(y_bits: np.ndarray, n0: float, q: int) -> np.ndarray:
    """float64 NumPy symbol priors: P(a) ∝ Π_b P(bit_b = a_b | y_b)."""
    llr = 4.0 * np.asarray(y_bits, np.float64) / n0
    logp0 = -np.logaddexp(0.0, -llr)  # log P(bit = 0)
    logp1 = -np.logaddexp(0.0, llr)
    m = q.bit_length() - 1
    patt = (np.arange(q)[:, None] >> np.arange(m)) & 1  # [q, m] LSB first
    logp = np.where(patt == 1, logp1[..., None, :], logp0[..., None, :]).sum(-1)
    logp -= logp.max(axis=-1, keepdims=True)
    p = np.exp(logp)
    return p / p.sum(axis=-1, keepdims=True)


def compare_symbol_priors(w: Widths, qs=(4, 8, 16, 64)) -> float:
    """channel.nb.symbol_priors vs float64 NumPy: the largest error in
    units of the tolerance; <= 1 passes.

    Tolerance rtol 1e-5, atol 1e-7: an f32 softmax of log-priors of
    magnitude ~20 carries ~20 ulp (1.6e-6 relative measured without any
    TF32), while an f32 dot run in TF32 errs by ~1e-3."""
    from ldpcsimulation_tpu.channel.nb import symbol_priors

    worst = 0.0
    for q in qs:
        mbits = q.bit_length() - 1
        y, _, n0 = channel(24 + q, w.prior_frames * w.prior_symbols, mbits,
                           2.0, 0.5)
        y = y.reshape(w.prior_frames, w.prior_symbols, mbits)
        got = np.asarray(symbol_priors(y, n0, q), np.float64)
        want = priors_reference(np.asarray(y), n0, q)
        err = np.abs(got - want) / (1e-7 + 1e-5 * np.abs(want))
        worst = max(worst, float(err.max()))
    return worst


def check_encoder(w: Widths) -> int:
    """Frames of a device-encoded batch with a nonzero syndrome, checked
    with a NumPy H (expected 0)."""
    from ldpcsimulation_tpu.codes.encode import make_encoder
    from ldpcsimulation_tpu.codes.library import load_named_code

    code = load_named_code(w.generic)
    enc = make_encoder(code)
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, (w.frames, enc.k), dtype=np.uint8)
    cw = np.asarray(enc.encode(info), np.int64)
    h = np.zeros((code.m, code.n), np.int64)
    cn_vn = np.asarray(code.cn_vn)
    mask = np.asarray(code.cn_mask)
    for r in range(code.m):
        h[r, cn_vn[r][mask[r]]] = 1
    return int(np.sum(np.any((cw @ h.T) % 2, axis=1)))


def phase_compare(w: Widths, log_dir: str, clock: CompileClock) -> dict:
    """P5: every comparison with its plain reference, each at its
    stated tolerance."""
    strat_mismatch, strat_differ = compare_stratified_generic(w)
    rs_minsum, rs_ddbmp = compare_rs_stratified(w)
    res = {
        "qc_vs_generic_frames_differ": compare_qc_generic(w),
        "stratified_interleaver_mismatches": strat_mismatch,
        "stratified_vs_generic_frames_differ": strat_differ,
        "rs_stratified_minsum_frames_differ": rs_minsum,
        "rs_stratified_ddbmp_frames_differ": rs_ddbmp,
        "dense_vs_gather_frames_differ": compare_dense_gather(w),
        "symbol_priors_err_over_tol": compare_symbol_priors(w),
        "encoder_frames_nonzero_syndrome": check_encoder(w),
        "replay_rows_differ": compare_replay_simulate(w),
    }
    point = ["minsum", "--code", w.qc[0], "--snr", "2.0", "-T", "10",
             "--batch", str(w.flagship_batch),
             "--max-frames", str(w.flagship_frames),
             "--min-errors", "10000000"]
    r32, _, _, _ = run_sweep(log_dir, "p5_f32", point + ["--msg-dtype", "f32"],
                             clock)
    r16, _, _, _ = run_sweep(log_dir, "p5_f16", point + ["--msg-dtype", "f16"],
                             clock)
    res["ber_f32"], res["ber_f16"] = float(r32[0][1]), float(r16[0][1])
    for k, v in res.items():
        log(f"  P5 {k}: {v:.6g}" if isinstance(v, float) else f"  P5 {k}: {v}")
    limits = {  # tolerances: see the compare_* docstrings
        "qc_vs_generic_frames_differ": 0,
        "stratified_interleaver_mismatches": 0,
        "stratified_vs_generic_frames_differ": 6,
        "rs_stratified_minsum_frames_differ": 0,
        "rs_stratified_ddbmp_frames_differ": 0,
        "dense_vs_gather_frames_differ": 0,
        "symbol_priors_err_over_tol": 1.0,
        "encoder_frames_nonzero_syndrome": 0,
        "replay_rows_differ": 0,
    }
    failed = [k for k, lim in limits.items() if res[k] > lim]
    check(not failed, f"P5 comparisons failed: {failed}")
    check_rel("P5 f16 vs f32 storage BER", res["ber_f16"], res["ber_f32"],
              w.ber_tol)
    return res


def time_on_device(fn, x, reps: int) -> float:
    """Seconds per application of fn, by the host clock over one jitted
    on-device loop of ``reps`` applications (median of 3 loops)."""
    import jax

    loop = jax.jit(lambda x0: jax.lax.fori_loop(0, reps, lambda i, c: fn(c),
                                                 x0))
    jax.block_until_ready(loop(x))  # compile
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(x))
        times.append(time.perf_counter() - t0)
    return sorted(times)[1] / reps


def phase_report(w: Widths, log_dir: str, clock: CompileClock,
                 card: str) -> dict:
    """P6 device times: XLA's channel generation at flagship width and the
    flagship min-sum check-node update (and whole iteration), f16 storage.
    These are the times a hand-written Hopper kernel has to beat."""
    import jax
    import jax.numpy as jnp

    from ldpcsimulation_tpu.codes.library import load_named_qc
    from ldpcsimulation_tpu.decoders.minsum_qc import (
        qc_cn_minsum_slots,
        qc_minsum_step,
        qc_ragged_init,
    )

    b = w.flagship_batch
    qc = load_named_qc("qc_1008_504")
    sigma = channel_sigma(2.0, 0.5)

    def gen(carry):
        k, acc = carry
        k, sub = jax.random.split(k)
        y = 1.0 + sigma * jax.random.normal(sub, (b, qc.n), jnp.float32)
        return k, acc + jnp.sum(y)

    t_ch = time_on_device(gen, (jax.random.key(0), jnp.float32(0)),
                          w.timing_reps)
    y, _, _ = channel(31, b, qc.n, 2.0, 0.5)
    yb = y.T.reshape(qc.nb, qc.z, b)
    v2c = qc_ragged_init(qc, yb, jnp.float16)
    step = qc_minsum_step(qc, storage_dtype=jnp.float16)

    def cn(v):
        slots = qc_cn_minsum_slots(qc, v)
        return jnp.stack([jnp.stack(s) for s in slots]).astype(jnp.float16)

    t_cn = time_on_device(cn, v2c, w.timing_reps)
    t_it = time_on_device(lambda v: step(v, yb)[0], v2c, w.timing_reps)
    mb = qc.n * b * 4 / 1e6
    log(f"  P6 on {card}: channel generation {b}x{qc.n} f32 "
        f"({mb:.1f} MB): {t_ch * 1e3:.4f} ms")
    log(f"  P6 on {card}: flagship CN update {b} frames f16: "
        f"{t_cn * 1e3:.4f} ms; whole min-sum iteration {t_it * 1e3:.4f} ms")
    return {"channel_ms": t_ch * 1e3, "cn_ms": t_cn * 1e3,
            "iteration_ms": t_it * 1e3}


# ------------------------------------------------------------- four cards


def four_card_stream(w: Widths, lanes_per_card: int = 8192) -> dict:
    """(a) the stream on a ("data",) mesh of every card, record=True: each
    retired frame's (iterations, errors) must equal a batch decode of its
    (seed, gid) row on card 0.

    Card 0 regenerates each pool window from (seed, gid) with the same
    compiled pool builder, unsharded; its rows must equal the stream's
    pool rows bit for bit (a wrong key fold or shard offset would change
    them), and their batch decode must match every retired frame."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ldpcsimulation_tpu.codes.library import load_named_qc
    from ldpcsimulation_tpu.decoders import decode_minsum_qc
    from ldpcsimulation_tpu.harness import stream as hs

    devs = jax.devices()
    nd = len(devs)
    mesh = Mesh(np.array(devs), ("data",))
    qc = load_named_qc(w.qc[0])
    t_cap = 10
    sigma = channel_sigma(2.0, 0.5)
    dec = hs.minsum_qc_stream(qc)
    root = jax.random.key(7)
    lanes = lanes_per_card * nd
    pool_frames = 2 * lanes
    rec_cap = (pool_frames + lanes) // nd
    call = hs.make_stream_call(dec, qc.n, t_cap, 8, 1, record=True,
                               rec_cap=rec_cap, mesh=mesh, data_axis="data")
    init = hs.stream_init(dec, lanes, qc.n)
    state = jax.device_put(init, jax.tree.map(
        lambda x: NamedSharding(mesh, P(*([None] * (x.ndim - 1) + ["data"]))),
        init))
    rows_sh = NamedSharding(mesh, P("data"))
    pool_fn = jax.jit(
        lambda b: hs.build_channel_pool(dec, root, b, pool_frames, qc.n,
                                        sigma),
        out_shardings=(rows_sh, rows_sh, rows_sh),
    )

    per_frame = {}

    def take(rec):
        r = jax.device_get(rec)
        seg = rec_cap + 1
        for d in range(nd):
            rc = int(r["rc_local"][d])
            lo = d * seg
            for g, it, er in zip(r["gid"][lo:lo + rc], r["iters"][lo:lo + rc],
                                 r["errs"][lo:lo + rc]):
                check(int(g) not in per_frame, f"frame {g} retired twice")
                per_frame[int(g)] = (int(it), int(er))

    t0 = time.perf_counter()
    base = 0
    pools = []
    for _ in range(2):
        pool, unc, sat0 = pool_fn(jnp.int32(base))
        pools.append(pool)
        state, _, rec = call(state, pool, unc, sat0, jnp.int32(base))
        take(rec)
        base += pool_frames
    for _ in range(2 + t_cap):  # drain until every lane is idle
        if bool(jax.device_get(jnp.all(state["idle"]))):
            break
        state, _, rec = call(state, pool, unc, sat0, jnp.int32(base),
                             pool_frames // nd)
        take(rec)
    wall = time.perf_counter() - t0
    check(bool(jax.device_get(jnp.all(state["idle"]))), "drain incomplete")

    regen = jax.jit(lambda b: hs.build_channel_pool(
        dec, root, b, pool_frames, qc.n, sigma)[0])
    differ = 0
    rows_differ = 0
    for wi in range(2):
        rows = regen(jnp.int32(wi * pool_frames))  # on card 0
        used = jax.device_put(pools[wi], rows.sharding)
        rows_differ += int(jnp.sum(jnp.any(rows != used, axis=1)))
        for c0 in range(0, pool_frames, lanes):
            res = decode_minsum_qc(qc, rows[c0:c0 + lanes], t_cap,
                                   early_termination=True)
            its = np.asarray(res.iterations)
            errs = np.asarray(jnp.sum(res.hard != 1, axis=1))
            for k in range(len(its)):
                g = wi * pool_frames + c0 + k
                if g in per_frame and per_frame[g] != (int(its[k]),
                                                       int(errs[k])):
                    differ += 1
    per_card = [sum(1 for g in per_frame
                    if (g % pool_frames) // (pool_frames // nd) == d)
                for d in range(nd)]
    log(f"  4-card stream: {len(per_frame)} retired frames "
        f"(per card {per_card}), {differ} differ from the card-0 batch "
        f"decode of their (seed, gid) rows; {rows_differ} of "
        f"{2 * pool_frames} regenerated rows differ from the stream's "
        f"pool rows; stream wall {wall:.3f} s")
    check(all(c > 0 for c in per_card), f"a card retired nothing {per_card}")
    check(rows_differ == 0, f"{rows_differ} regenerated rows differ")
    check(differ == 0, f"{differ} frames differ")
    return {"frames": len(per_frame), "differ": differ, "wall_s": wall,
            "rows_differ": rows_differ}


def four_card_grid(w: Widths, log_dir: str, clock: CompileClock,
                   word_errors: int = 80000,
                   max_frames: int = 8388608) -> dict:
    """(b) a 4-point ``sweep --distributed`` grid (normalized min-sum
    alpha {1.0, 1.25} x SNR {2.0, 2.4}) on every card, against the same
    points on card 0 alone.  Per-slot RNG streams fold in mesh
    coordinates, so the agreement is statistical: each point runs to
    ``word_errors`` word errors, which puts the BER bound at >4 sigma."""
    grid = ["normalizedminsum", "--code", w.qc[0], "--snr", "2.0,2.4",
            "--alpha", "1.0", "1.25", "-T", "10", "--early-termination",
            "--batch", str(w.flagship_batch), "--min-errors", "1",
            "--min-word-errors", str(word_errors),
            "--max-frames", str(max_frames)]
    drows, dframes, dwall, _ = run_sweep(log_dir, "four_grid",
                                         grid + ["--distributed"], clock)
    srows, sframes, swall, _ = run_sweep(log_dir, "one_grid", grid, clock)
    check(len(drows) == len(srows) == 4, "grid rows")
    worst = 0.0
    for d, s in zip(drows, srows):
        check(d[0] == s[0] and d[-2] == s[-2], f"row order {d} {s}")
        db, sb = float(d[1]), float(s[1])
        rel = abs(db - sb) / sb
        worst = max(worst, rel)
        log(f"  grid SNR {d[0]} alpha {d[-2]}: BER all cards {db:.6g} vs "
            f"card 0 {sb:.6g} ({100 * rel:.3f}%)")
    log(f"  grid wall: {dwall:.3f} s on all cards ({dframes} frames), "
        f"{swall:.3f} s on card 0 ({sframes} frames)")
    check(worst <= w.ber_tol, f"grid BER differs by {100 * worst:.3f}%")
    return {"worst_rel": worst, "wall_all_s": dwall, "wall_one_s": swall}


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded stream and the distributed "
                        "grid on four cards, against one card")
    args = p.parse_args(argv)

    import jax
    import jaxlib

    try:
        dev = require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    want = 4 if args.four_cards else 1
    if dev["count"] < want:
        print(f"chip_smoke: need {want} GPUs, have {dev['count']}",
              file=sys.stderr)
        return 1
    cache = enable_compile_cache()
    card = card_line()
    log(f"P0 device: {dev['platform']} {dev['kind']} x{dev['count']}; "
        f"jax {jax.__version__}, jaxlib {jaxlib.__version__}; "
        f"compile cache {cache}")
    log(f"P0 card: {card}")

    w = Widths()
    clock = CompileClock()
    phases = []
    failed = []
    with tempfile.TemporaryDirectory() as log_dir:
        if args.four_cards:
            todo = [("4a sharded stream", lambda: four_card_stream(w)),
                    ("4b distributed grid",
                     lambda: four_card_grid(w, log_dir, clock))]
        else:
            todo = [
                ("P1 flagship", lambda: phase_flagship(w, log_dir, clock,
                                                       card)),
                ("P2 stream", lambda: phase_stream(w, log_dir, clock)),
                ("P3 standard code", lambda: phase_standard(w, log_dir,
                                                            clock)),
                ("P4 families", lambda: phase_families(w, log_dir, clock)),
                ("P5 comparisons", lambda: phase_compare(w, log_dir, clock)),
                ("P6 device times", lambda: phase_report(w, log_dir, clock,
                                                         card)),
            ]
        for name, fn in todo:
            log(f"{name}:")
            c0 = clock.total
            t0 = time.perf_counter()
            try:
                fn()
                ok = True
            except Exception:  # report, go on, exit 1 at the end
                traceback.print_exc(file=sys.stdout)
                ok = False
                failed.append(name)
            wall = time.perf_counter() - t0
            comp = clock.total - c0
            phases.append((name, ok, comp, wall))
            log(f"{name}: {'ok' if ok else 'FAILED'} "
                f"(compile {comp:.3f} s, wall {wall:.3f} s)")

    peak = [d.memory_stats().get("peak_bytes_in_use", 0)
            for d in jax.devices()[:want]]
    log("P6 report (compile seconds are summed over threads; where they "
        "exceed the wall, the phase compiled programs at once):")
    for name, ok, comp, wall in phases:
        run = f"{wall - comp:9.3f} s" if wall >= comp else "overlapped"
        log(f"  {name:24s} {'ok' if ok else 'FAILED':6s} "
            f"compile {comp:9.3f} s  wall {wall:9.3f} s  run {run}")
    log(f"  peak device bytes in use: {peak}")
    log(f"card: {card}")
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
