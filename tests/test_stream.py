"""Streaming refill harness: per-frame bit-exact equality vs batch decoding.

The contract (harness/stream.py): scheduling frames through persistent
refilled lanes changes NOTHING per frame — decisions, iteration counts,
and every derived counter match a plain batched early-termination decode
of the same channel rows.  These tests drive the stream call directly with
``record=True`` and compare per-frame (iters, errs) against the batch
decoders, across refill cadences, multiple calls (in-flight frames crossing
call boundaries), and pool exhaustion (idle lanes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpcsimulation_tpu.channel.awgn import llr_from_channel, snr_to_n0, snr_to_sigma
from ldpcsimulation_tpu.codes.library import load_named_code
from ldpcsimulation_tpu.codes.qc import qc_peg
from ldpcsimulation_tpu.decoders.bp_qc import decode_bp_qc
from ldpcsimulation_tpu.decoders.minsum import decode_minsum
from ldpcsimulation_tpu.decoders.minsum_qc import decode_minsum_qc
from ldpcsimulation_tpu.harness.stream import (
    build_channel_pool,
    bp_qc_stream,
    make_stream_call,
    minsum_qc_stream,
    minsum_stream,
    simulate_stream,
    stream_init,
)
from ldpcsimulation_tpu.harness.montecarlo import StopRule


QC = qc_peg(8, 4, 3, z=16, seed=0)  # (128, 64)
SNR, RATE = 2.5, 0.5
SIGMA = float(snr_to_sigma(SNR, RATE))
N0 = float(snr_to_n0(SNR, RATE))
T = 12


def run_stream(dec, n, pools, lanes, rounds, refill_every, preprocess=None):
    """Drive the raw stream call over a list of (base, F) pools; return
    {gid: (iters, errs)} for every retired frame plus the summed counters."""
    root = jax.random.key(7)
    state = stream_init(dec, lanes, n)
    rec_cap = max(f for _b, f in pools) + lanes
    call = make_stream_call(
        dec, n, T, rounds, refill_every, record=True, rec_cap=rec_cap
    )
    per_frame = {}
    totals = dict(frames=0, bit_errs=0, iter_sum=0, word_errs=0)
    for base, f in pools:
        pool, unc, sat0 = build_channel_pool(
            dec, root, base, f, n, SIGMA, preprocess
        )
        state, acc, rec = call(state, pool, unc, sat0, jnp.int32(base))
        a = jax.device_get(acc)
        r = jax.device_get(rec)
        rc = int(a["rc"])
        assert rc <= rec_cap
        for g, it, er in zip(
            r["gid"][:rc], r["iters"][:rc], r["errs"][:rc]
        ):
            assert int(g) >= 0
            assert int(g) not in per_frame, "frame retired twice"
            per_frame[int(g)] = (int(it), int(er))
        for k in totals:
            totals[k] += int(a[k])
        # histograms must agree with the per-frame records
        ih = np.zeros(T + 1, np.int64)
        wh = np.zeros(n + 1, np.int64)
        for g, it, er in zip(r["gid"][:rc], r["iters"][:rc], r["errs"][:rc]):
            ih[int(it)] += 1
            if int(er) > 0:
                wh[int(er)] += 1
        np.testing.assert_array_equal(ih, np.asarray(a["iter_hist"]))
        np.testing.assert_array_equal(wh, np.asarray(a["weight_hist"]))
    assert totals["frames"] == len(per_frame)
    assert totals["bit_errs"] == sum(e for _i, e in per_frame.values())
    assert totals["iter_sum"] == sum(i for i, _e in per_frame.values())
    assert totals["word_errs"] == sum(
        1 for _i, e in per_frame.values() if e > 0
    )
    return per_frame


def reference_frames(dec, n, n_frames, decode_rows, preprocess=None):
    """Batch-decode the same per-frame channel rows; per-frame truth."""
    root = jax.random.key(7)
    rows, _unc, _sat0 = build_channel_pool(
        dec, root, 0, n_frames, n, SIGMA, preprocess
    )
    res = decode_rows(rows)
    hard = np.asarray(res.hard)
    iters = np.asarray(res.iterations)
    errs = (hard != 1).sum(axis=1)
    return {g: (int(iters[g]), int(errs[g])) for g in range(n_frames)}


def check_equal(per_frame, ref, min_covered):
    assert len(per_frame) >= min_covered
    for g, v in per_frame.items():
        assert ref[g] == v, (g, ref[g], v)


@pytest.mark.parametrize("refill_every", [1, 3])
def test_minsum_qc_stream_matches_batch(refill_every):
    dec = minsum_qc_stream(QC, storage_dtype=jnp.float16)
    ref = reference_frames(
        dec,
        QC.n,
        192,
        lambda rows: decode_minsum_qc(
            QC, rows, T, early_termination=True, storage_dtype=jnp.float16
        ),
    )
    # two calls with small pools: frames cross the call boundary in flight,
    # and the second pool exhausts mid-call (idle-lane path)
    per_frame = run_stream(
        dec, QC.n, [(0, 96), (96, 96)], lanes=32, rounds=30,
        refill_every=refill_every,
    )
    check_equal(per_frame, ref, min_covered=150)


def test_minsum_qc_stream_exhaustion_then_refill():
    # tiny pool forces most lanes idle; a later call revives them
    dec = minsum_qc_stream(QC)
    ref = reference_frames(
        dec, QC.n, 80,
        lambda rows: decode_minsum_qc(QC, rows, T, early_termination=True),
    )
    per_frame = run_stream(
        dec, QC.n, [(0, 16), (16, 64)], lanes=32, rounds=25, refill_every=1
    )
    check_equal(per_frame, ref, min_covered=60)


def test_bp_qc_stream_matches_batch():
    dec = bp_qc_stream(QC, storage_dtype=jnp.float16)
    pre = lambda y: llr_from_channel(y, N0)  # noqa: E731
    ref = reference_frames(
        dec, QC.n, 128,
        lambda rows: decode_bp_qc(
            QC, rows, T, early_termination=True, storage_dtype=jnp.float16
        ),
        preprocess=pre,
    )
    per_frame = run_stream(
        dec, QC.n, [(0, 128)], lanes=32, rounds=40, refill_every=2,
        preprocess=pre,
    )
    check_equal(per_frame, ref, min_covered=110)


def test_minsum_stratified_stream_matches_batch():
    """The universal unstructured fallback keeps --stream: per-frame
    equality vs decode_minsum_stratified on a synthetic irregular non-QC
    ensemble (the same construction the routing tests use)."""
    from ldpcsimulation_tpu.codes import build_code
    from ldpcsimulation_tpu.codes.stratified import detect_stratified
    from ldpcsimulation_tpu.decoders.minsum_stratified import (
        decode_minsum_stratified,
    )
    from ldpcsimulation_tpu.harness.stream import minsum_stratified_stream
    from .test_stratified import synthetic_irregular_stratified

    alist = synthetic_irregular_stratified(n=192, h=24, mb=4, seed=3)
    sc = detect_stratified(alist)
    assert sc is not None
    code = build_code(alist)
    dec = minsum_stratified_stream(sc, storage_dtype=jnp.float16)
    ref = reference_frames(
        dec, code.n, 96,
        lambda rows: decode_minsum_stratified(
            sc, rows, T, early_termination=True,
            storage_dtype=jnp.float16,
        ),
    )
    per_frame = run_stream(
        dec, code.n, [(0, 96)], lanes=24, rounds=40, refill_every=2
    )
    check_equal(per_frame, ref, min_covered=80)


def test_bp_stratified_stream_matches_batch():
    """BP on the stratified fallback: stream vs batched bit-exact (same
    step object; the ulp-tie caveat is only vs the GENERIC decoder)."""
    from ldpcsimulation_tpu.codes import build_code
    from ldpcsimulation_tpu.codes.stratified import detect_stratified
    from ldpcsimulation_tpu.decoders.bp_stratified import (
        decode_bp_stratified,
    )
    from ldpcsimulation_tpu.harness.stream import bp_stratified_stream
    from .test_stratified import synthetic_irregular_stratified

    alist = synthetic_irregular_stratified(n=192, h=24, mb=4, seed=3)
    sc = detect_stratified(alist)
    code = build_code(alist)
    dec = bp_stratified_stream(sc, storage_dtype=jnp.float16)
    pre = lambda y: llr_from_channel(y, N0)  # noqa: E731
    ref = reference_frames(
        dec, code.n, 96,
        lambda rows: decode_bp_stratified(
            sc, rows, T, early_termination=True,
            storage_dtype=jnp.float16,
        ),
        preprocess=pre,
    )
    per_frame = run_stream(
        dec, code.n, [(0, 96)], lanes=24, rounds=40, refill_every=2,
        preprocess=pre,
    )
    check_equal(per_frame, ref, min_covered=80)


@pytest.mark.parametrize("refill_every", [1, 3])
def test_minsum_layered_qc_stream_matches_batch(refill_every):
    """Row-layered min-sum through the stream driver: one stream
    iteration = one full layer sweep, per-frame (iters, errs) equal to
    the batched layered ET decoder, across refill cadences and frames
    crossing call boundaries (VERDICT r4 item 3)."""
    from ldpcsimulation_tpu.decoders.minsum_layered import (
        decode_minsum_layered_qc,
    )
    from ldpcsimulation_tpu.harness.stream import minsum_layered_qc_stream

    dec = minsum_layered_qc_stream(
        QC, variant="normalized", alpha=1.25, storage_dtype=jnp.float16
    )
    ref = reference_frames(
        dec, QC.n, 192,
        lambda rows: decode_minsum_layered_qc(
            QC, rows, T, variant="normalized", alpha=1.25,
            early_termination=True, storage_dtype=jnp.float16,
        ),
    )
    per_frame = run_stream(
        dec, QC.n, [(0, 96), (96, 96)], lanes=32, rounds=30,
        refill_every=refill_every,
    )
    check_equal(per_frame, ref, min_covered=150)


def test_bp_layered_qc_stream_matches_batch():
    from ldpcsimulation_tpu.decoders.bp_layered import decode_bp_layered_qc
    from ldpcsimulation_tpu.harness.stream import bp_layered_qc_stream

    dec = bp_layered_qc_stream(QC)
    pre = lambda y: llr_from_channel(y, N0)  # noqa: E731
    ref = reference_frames(
        dec, QC.n, 128,
        lambda rows: decode_bp_layered_qc(
            QC, rows, T, early_termination=True
        ),
        preprocess=pre,
    )
    per_frame = run_stream(
        dec, QC.n, [(0, 128)], lanes=32, rounds=40, refill_every=2,
        preprocess=pre,
    )
    check_equal(per_frame, ref, min_covered=110)


def test_minsum_layered_stream_f16_pool_matches_batch():
    """f16 pool rows on the layered path: the stored rows ARE the channel
    realization; the stream equals a batch layered decode of the same
    rows upcast to f32 (init upcasts the posterior exactly)."""
    from ldpcsimulation_tpu.decoders.minsum_layered import (
        decode_minsum_layered_qc,
    )
    from ldpcsimulation_tpu.harness.stream import minsum_layered_qc_stream

    dec = minsum_layered_qc_stream(QC, storage_dtype=jnp.float16)
    root = jax.random.key(7)
    F = 128
    rows, unc, sat0 = build_channel_pool(
        dec, root, 0, F, QC.n, SIGMA, None, pool_dtype=jnp.float16
    )
    res = decode_minsum_layered_qc(
        QC, rows.astype(jnp.float32), T, early_termination=True,
        storage_dtype=jnp.float16,
    )
    ref = {
        g: (int(np.asarray(res.iterations)[g]),
            int((np.asarray(res.hard)[g] != 1).sum()))
        for g in range(F)
    }
    state = stream_init(dec, 32, QC.n, jnp.float16)
    call = make_stream_call(dec, QC.n, T, 40, 1, record=True,
                            rec_cap=F + 32)
    state, acc, rec = call(state, rows, unc, sat0, jnp.int32(0))
    a, r = jax.device_get(acc), jax.device_get(rec)
    rc = int(a["rc"])
    assert rc >= 100
    for g, it, er in zip(r["gid"][:rc], r["iters"][:rc], r["errs"][:rc]):
        assert ref[int(g)] == (int(it), int(er)), int(g)


def test_minsum_generic_stream_matches_batch():
    code = load_named_code("peg_96_48")
    dec = minsum_stream(code, variant="normalized", alpha=1.25)
    ref = reference_frames(
        dec, code.n, 96,
        lambda rows: decode_minsum(
            code, rows, T, variant="normalized", alpha=1.25,
            early_termination=True,
        ),
    )
    per_frame = run_stream(
        dec, code.n, [(0, 96)], lanes=24, rounds=40, refill_every=1
    )
    check_equal(per_frame, ref, min_covered=80)


def test_simulate_stream_stats_match_per_frame_truth():
    """End-to-end wrapper: aggregate MCStats equal the batch-decoded truth
    over the frames the stream retired (stop rule honored)."""
    dec = minsum_qc_stream(QC)
    stats = simulate_stream(
        QC.n, dec, SNR, RATE, T,
        stop=StopRule(min_bit_errors=50, min_word_errors=5),
        lanes=32, rounds_per_call=16, refill_every=1, pool_frames=64,
        seed=0,
    )
    assert stats.total_words > 0
    assert stats.errors >= 50 and stats.word_errors >= 5
    # every counter internally consistent
    assert stats.total_bits == stats.total_words * QC.n
    assert stats.iteration_hist.sum() == stats.total_words
    assert int(
        (stats.iteration_hist * np.arange(T + 1)).sum()
    ) == stats.total_iterations
    assert stats.error_weight_hist.sum() == stats.word_errors
    # gid-level equality of the raw call against batch truth (seed 7 via
    # run_stream/reference_frames)
    f_total = stats.total_words + 96
    ref = reference_frames(
        dec, QC.n, f_total,
        lambda rows: decode_minsum_qc(QC, rows, T, early_termination=True),
    )
    per_frame = run_stream(
        dec, QC.n, [(0, f_total)], lanes=32, rounds=60, refill_every=1
    )
    for g, v in per_frame.items():
        assert ref[g] == v


def test_stream_uncoded_counter():
    """Uncoded error accumulation matches sign-counting on raw samples."""
    dec = minsum_qc_stream(QC)
    root = jax.random.key(7)
    rows, unc, _ = build_channel_pool(dec, root, 0, 64, QC.n, SIGMA)
    y = np.asarray(rows)
    np.testing.assert_array_equal(
        np.asarray(unc), (y <= 0).sum(axis=1).astype(np.int32)
    )


def test_minsum_qc_stream_f16_pool_matches_batch():
    """f16 pool rows: the stored rows ARE the channel realization (upcast
    exactly at the step), so the stream matches a batch decode of the
    same rows upcast to f32."""
    dec = minsum_qc_stream(QC, storage_dtype=jnp.float16)
    root = jax.random.key(7)
    F = 128
    rows, unc, sat0 = build_channel_pool(
        dec, root, 0, F, QC.n, SIGMA, None, pool_dtype=jnp.float16
    )
    assert rows.dtype == jnp.float16
    res = decode_minsum_qc(
        QC, rows.astype(jnp.float32), T, early_termination=True,
        storage_dtype=jnp.float16,
    )
    ref = {
        g: (int(np.asarray(res.iterations)[g]),
            int((np.asarray(res.hard)[g] != 1).sum()))
        for g in range(F)
    }
    state = stream_init(dec, 32, QC.n, jnp.float16)
    call = make_stream_call(dec, QC.n, T, 40, 1, record=True,
                            rec_cap=F + 32)
    state, acc, rec = call(state, rows, unc, sat0, jnp.int32(0))
    a, r = jax.device_get(acc), jax.device_get(rec)
    rc = int(a["rc"])
    assert rc >= 100
    for g, it, er in zip(r["gid"][:rc], r["iters"][:rc], r["errs"][:rc]):
        assert ref[int(g)] == (int(it), int(er)), int(g)


def test_nb_stream_matches_batch():
    """NB-QSPA through the stream driver: per-frame symbol decisions,
    iteration counts, and bit/symbol error counters equal a batch decode
    of the same channel rows (the NB ET row's straggler-tax fix)."""
    from ldpcsimulation_tpu.channel.nb import symbol_priors
    from ldpcsimulation_tpu.codes import build_code
    from ldpcsimulation_tpu.codes.construct import nb_regular
    from ldpcsimulation_tpu.decoders.nb_qspa import decode_nb_qspa
    from ldpcsimulation_tpu.harness.stream import (
        build_channel_pool_nb,
        nb_qspa_stream,
    )

    q = 4
    code = build_code(nb_regular(48, 24, 3, q=q, seed=2))
    m_bits = 2
    n0 = float(snr_to_n0(3.0, 0.5))
    sigma = float(np.sqrt(n0 / 2.0))
    T_nb = 15
    dec = nb_qspa_stream(code, n0, q, storage_dtype=jnp.float16)
    root = jax.random.key(7)
    F = 96
    rows, unc, sat0 = build_channel_pool_nb(
        dec, root, 0, F, code.n, q, sigma
    )
    assert rows.shape == (F, code.n * q)  # PRE-PREPPED log-prior rows
    # batch truth on the identical channel realization: regenerate the
    # bit-level samples by the same (root, gid) recipe the pool builder
    # used — decode_nb_qspa's own front-end then sees identical values
    # (the pool stores exactly log_of(symbol_priors(y)) at f32)
    gids = jnp.arange(F)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(root, gids)
    y = jax.vmap(
        lambda kk: jax.random.normal(kk, (code.n * m_bits,), jnp.float32)
    )(keys)
    y = (1.0 + sigma * y).reshape(F, code.n, m_bits)
    pri = symbol_priors(jnp.asarray(y), n0, q)
    res = decode_nb_qspa(
        code, pri, T_nb, early_termination=True,
        storage_dtype=jnp.float16,
    )
    syms = np.asarray(res.symbols)
    iters = np.asarray(res.iterations)
    bit_errs = sum(((syms >> i) & 1).sum(axis=1) for i in range(m_bits))

    from ldpcsimulation_tpu.harness.stream import (
        make_stream_call,
        stream_init,
    )

    state = stream_init(dec, 24, code.n * q)
    call = make_stream_call(
        dec, code.n, T_nb, 50, 1, record=True, rec_cap=F + 24,
        max_weight=code.n * m_bits,
    )
    state, acc, rec = call(state, rows, unc, sat0, jnp.int32(0))
    a, r = jax.device_get(acc), jax.device_get(rec)
    rc = int(a["rc"])
    assert rc >= 70
    sym_err_total = 0
    for g, it, er in zip(r["gid"][:rc], r["iters"][:rc], r["errs"][:rc]):
        g = int(g)
        assert (int(it), int(er)) == (int(iters[g]), int(bit_errs[g])), g
        sym_err_total += int((syms[g] != 0).sum())
    assert int(a["errs2"]) == sym_err_total


def test_simulate_stream_nb_end_to_end():
    from ldpcsimulation_tpu.codes import build_code
    from ldpcsimulation_tpu.codes.construct import nb_regular
    from ldpcsimulation_tpu.harness.stream import simulate_stream_nb

    code = build_code(nb_regular(48, 24, 3, q=4, seed=6))
    stats = simulate_stream_nb(
        code, snr_db=3.5, num_iterations=15,
        stop=StopRule(min_bit_errors=40, min_word_errors=4),
        lanes=24, rounds_per_call=20, pool_frames=64, seed=1,
    )
    assert stats.total_words > 0
    assert stats.bit_errors >= 40 and stats.word_errors >= 4
    assert stats.symbol_errors <= stats.bit_errors <= 2 * stats.symbol_errors
    assert stats.total_bits == 2 * stats.total_symbols
    assert 0 < stats.avg_iterations <= 15


@pytest.mark.parametrize("refill_every", [1, 3])
def test_ddbmp_qc_stream_matches_batch(refill_every):
    """DD-BMP streams with its own conventions (break-index iteration
    counts; no channel-decision check at injection): per-frame (iters,
    errs) equality vs decode_ddbmp_qc, including frames whose CHANNEL
    decisions already satisfy (the batched decoder still runs them)."""
    from ldpcsimulation_tpu.channel.quantize import quantize_no_zero
    from ldpcsimulation_tpu.decoders.ddbmp import decode_ddbmp_qc
    from ldpcsimulation_tpu.harness.stream import ddbmp_qc_stream

    dec = ddbmp_qc_stream(QC)
    pre = lambda y: quantize_no_zero(y, 1.5, 8.0)
    # higher SNR so some frames' channel decisions satisfy outright —
    # exercising the check_at_injection=False path
    root = jax.random.key(7)
    rows, _unc, sat0 = build_channel_pool(
        dec, root, 0, 192, QC.n, float(snr_to_sigma(5.0, 0.5)), pre
    )
    assert not bool(np.asarray(sat0).any())  # convention: never pre-done
    res = decode_ddbmp_qc(QC, rows, T)
    hard = np.asarray(res.hard)
    ref = {
        g: (int(np.asarray(res.iterations)[g]),
            int((hard[g] != 1).sum()))
        for g in range(192)
    }

    state = stream_init(dec, 32, QC.n)
    call = make_stream_call(dec, QC.n, T, 40, refill_every,
                            record=True, rec_cap=256)
    per_frame = {}
    for base, f in [(0, 96), (96, 96)]:
        pool, unc, s0 = build_channel_pool(
            dec, root, base, f, QC.n, float(snr_to_sigma(5.0, 0.5)), pre
        )
        state, acc, rec = call(state, pool, unc, s0, jnp.int32(base))
        a = jax.device_get(acc)
        r = jax.device_get(rec)
        for g, it, er in zip(r["gid"][: int(a["rc"])],
                             r["iters"][: int(a["rc"])],
                             r["errs"][: int(a["rc"])]):
            assert int(g) not in per_frame
            per_frame[int(g)] = (int(it), int(er))
    assert len(per_frame) >= 150
    for g, v in per_frame.items():
        assert ref[g] == v, (g, ref[g], v)
    # the reference convention: satisfied-at-channel frames report 0
    # after ONE update (not zero updates) — present in this ensemble
    assert any(v[0] == 0 for v in per_frame.values())


def _data_mesh():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), ("data",))


def test_sharded_stream_per_frame_matches_batch():
    """Mesh-sharded stream call (8 virtual devices): every retired frame's
    (iters, errs) equals a batch decode of its (seed, gid) channel row —
    per-device gid windows never collide and stay replayable."""
    mesh = _data_mesh()
    nd = mesh.shape["data"]
    dec = minsum_qc_stream(QC)
    root = jax.random.key(7)
    F, lanes, rec_cap = 256, 64, 512
    call = make_stream_call(
        dec, QC.n, T, 12, 1, record=True, rec_cap=rec_cap,
        mesh=mesh, data_axis="data",
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    shard_rows = NamedSharding(mesh, P("data"))
    state = jax.device_put(
        stream_init(dec, lanes, QC.n),
        jax.tree.map(
            lambda x: NamedSharding(
                mesh, P(*([None] * (x.ndim - 1) + ["data"]))
            ),
            stream_init(dec, lanes, QC.n),
        ),
    )
    pool_fn = jax.jit(
        lambda b: build_channel_pool(dec, root, b, F, QC.n, SIGMA),
        out_shardings=(shard_rows, shard_rows, shard_rows),
    )

    per_frame = {}
    pools = []
    base = 0
    for _call_i in range(2):
        pool, unc, sat0 = pool_fn(jnp.int32(base))
        pools.append(np.asarray(pool))
        state, acc, rec = call(state, pool, unc, sat0, base)
        r = jax.device_get(rec)
        seg = rec_cap + 1
        for d in range(nd):
            rc_d = int(r["rc_local"][d])
            for g, it, er in zip(
                r["gid"][d * seg:d * seg + rc_d],
                r["iters"][d * seg:d * seg + rc_d],
                r["errs"][d * seg:d * seg + rc_d],
            ):
                assert int(g) >= 0
                assert int(g) not in per_frame, "frame retired twice"
                per_frame[int(g)] = (int(it), int(er))
        base += F  # full-window advance (sharded semantics)
    # drain
    state, acc, rec = call(state, pool, unc, sat0, base, F // nd)
    r = jax.device_get(rec)
    seg = rec_cap + 1
    for d in range(nd):
        rc_d = int(r["rc_local"][d])
        for g, it, er in zip(
            r["gid"][d * seg:d * seg + rc_d],
            r["iters"][d * seg:d * seg + rc_d],
            r["errs"][d * seg:d * seg + rc_d],
        ):
            assert int(g) not in per_frame
            per_frame[int(g)] = (int(it), int(er))

    # ground truth: batch-decode the two gid windows, regenerated from
    # (seed, gid) on the default device by the same compiled pool builder
    regen = jax.jit(
        lambda b: build_channel_pool(dec, root, b, F, QC.n, SIGMA)[0]
    )
    ref = {}
    for w in range(2):
        rows = regen(jnp.int32(w * F))
        np.testing.assert_array_equal(np.asarray(rows), pools[w])
        res = decode_minsum_qc(QC, rows, T, early_termination=True)
        hard = np.asarray(res.hard)
        for k in range(F):
            ref[w * F + k] = (
                int(np.asarray(res.iterations)[k]),
                int((hard[k] != 1).sum()),
            )
    # window-advance semantics skip each device's unconsumed gids, so
    # coverage is below 2F; every device must have contributed
    assert len(per_frame) >= 250
    for d in range(nd):
        lo = d * (F // nd)
        assert any(lo <= g < lo + F // nd for g in per_frame), d
    for g, v in per_frame.items():
        assert ref[g] == v, (g, ref[g], v)


def test_sharded_simulate_stream_stats():
    """simulate_stream(mesh=...): psum'd global counters are
    self-consistent, deterministic across runs, and statistically match
    the single-device harness."""
    mesh = _data_mesh()
    dec = minsum_qc_stream(QC)
    kw = dict(
        stop=StopRule(min_bit_errors=0, min_word_errors=0,
                      max_frames=1500),
        lanes=128, rounds_per_call=16, refill_every=1, seed=3,
    )
    st1 = simulate_stream(QC.n, dec, SNR, RATE, T, mesh=mesh, **kw)
    st2 = simulate_stream(QC.n, dec, SNR, RATE, T, mesh=mesh, **kw)
    assert st1.total_words == st2.total_words
    assert st1.errors == st2.errors
    assert st1.word_errors == st2.word_errors
    np.testing.assert_array_equal(st1.iteration_hist, st2.iteration_hist)
    assert st1.total_words >= 1500
    assert st1.iteration_hist.sum() == st1.total_words

    st0 = simulate_stream(QC.n, dec, SNR, RATE, T, **kw)
    p = max(st0.ber, 1e-4)
    tol = 5.0 * np.sqrt(p * (1 - p) / st1.total_bits) + 0.2 * p
    assert abs(st1.ber - st0.ber) < tol, (st1.ber, st0.ber)


def test_sharded_layered_stream_stats():
    """Layered stream under shard_map (8 virtual devices): the tuple-of-
    tuples layered lane state shards on its last axis like any other
    (deterministic counters, consistent with the single-device run)."""
    from ldpcsimulation_tpu.harness.stream import minsum_layered_qc_stream

    mesh = _data_mesh()
    dec = minsum_layered_qc_stream(QC, variant="normalized", alpha=1.25)
    kw = dict(
        stop=StopRule(min_bit_errors=0, min_word_errors=0,
                      max_frames=800),
        lanes=64, rounds_per_call=8, refill_every=1, seed=4,
    )
    st1 = simulate_stream(QC.n, dec, SNR, RATE, T, mesh=mesh, **kw)
    st2 = simulate_stream(QC.n, dec, SNR, RATE, T, mesh=mesh, **kw)
    assert st1.total_words == st2.total_words >= 800
    assert st1.errors == st2.errors
    assert st1.iteration_hist.sum() == st1.total_words
    st0 = simulate_stream(QC.n, dec, SNR, RATE, T, **kw)
    p = max(st0.ber, 1e-4)
    tol = 5.0 * np.sqrt(p * (1 - p) / st1.total_bits) + 0.2 * p
    assert abs(st1.ber - st0.ber) < tol, (st1.ber, st0.ber)


def test_gid_rotation_before_int32_overflow(monkeypatch):
    """Deep campaigns exhaust the int32 gid space (the round-4 deep-FER
    run used 80% of it): the driver must rotate the channel root and
    reset base instead of overflowing.  Pin by shrinking the limit so a
    short run rotates, and assert statistics stay sane."""
    from ldpcsimulation_tpu.harness import stream as stream_mod

    dec = minsum_qc_stream(QC)
    monkeypatch.setattr(stream_mod, "_GID_LIMIT", 300)
    stats = simulate_stream(
        QC.n, dec, SNR, RATE, T,
        stop=StopRule(min_bit_errors=0, min_word_errors=0,
                      max_frames=600),
        lanes=32, rounds_per_call=8, refill_every=1, pool_frames=64,
        seed=6,
    )
    # several rotations were required to reach 600 frames with a 300-gid
    # space; counters must remain self-consistent
    assert stats.total_words >= 600
    assert stats.iteration_hist.sum() == stats.total_words
    assert stats.total_bits == stats.total_words * QC.n


def test_drain_outlasts_single_call_budget():
    """Review regression: a drain call whose iteration budget
    (rounds × refill) is far below a lane's residual iterations retires
    nothing on its first pass — run_drain must keep draining until all
    lanes are idle, not break on zero retirements."""
    dec = minsum_qc_stream(QC)
    kw = dict(
        # -20 dB: nothing converges, every frame runs the full T=20
        stop=StopRule(min_bit_errors=0, min_word_errors=0, max_frames=4),
        lanes=4, seed=2, refill_every=1,
    )
    small = simulate_stream(QC.n, dec, -20.0, RATE, 20,
                            rounds_per_call=2, **kw)
    big = simulate_stream(QC.n, dec, -20.0, RATE, 20,
                          rounds_per_call=32, **kw)
    # identical counted populations regardless of per-call budget
    assert small.total_words == big.total_words
    assert small.errors == big.errors
    assert small.iteration_hist.sum() == small.total_words
    # every counted frame ran the full cap (nothing converges at -20 dB)
    assert small.iteration_hist[20] == small.total_words



def test_pool_policy_budget():
    """pool_policy (VERDICT r4 item 6): the hint-based pool sizing is
    capped by a byte budget — auto mode shrinks the per-call round count
    to fit, explicit round counts keep their cadence with a capped pool,
    and generous geometries are untouched."""
    from ldpcsimulation_tpu.harness.stream import (
        DEFAULT_POOL_BYTES,
        pool_policy,
    )

    # deep-FER geometry (lanes 16k, avg 2.86, f16 rows): the raw hint
    # wants lanes*rounds*K/avg ~ 1.1M rows = 2.3 GB; the policy fits the
    # default 1 GiB budget by shrinking rounds
    row = 1008 * 2
    r, f = pool_policy(16384, 2, None, 2.86, row)
    assert f * row <= DEFAULT_POOL_BYTES
    assert 1 <= r < 64
    # explicit rounds: cadence honored, pool capped at the budget
    r2, f2 = pool_policy(16384, 2, 96, 2.86, row)
    assert r2 == 96 and f2 * row <= DEFAULT_POOL_BYTES
    # generous geometry: default rounds, hint sizing untouched
    r3, f3 = pool_policy(4096, 1, None, 8.0, 1008 * 4)
    assert r3 == 64
    assert f3 == 4096 + int(4096 * 64 / 8.0)
    # pathological budget: never below two lane widths
    r4, f4 = pool_policy(64, 1, None, 1.0, 10**6, pool_bytes=1)
    assert f4 >= 128
    # custom budget respected (above the 2-lane floor)
    r5, f5 = pool_policy(256, 1, None, 2.0, 1000, pool_bytes=2**20)
    assert f5 * 1000 <= 2**20
    assert f5 >= 2 * 256


def test_pool_budget_stats_equal_prefix_truth():
    """End-to-end with a TINY pool budget: the auto-shrunk call geometry
    changes only how many frames are counted, never their statistics —
    the aggregate counters equal a batch decode of the counted gid
    PREFIX (frames are consumed in gid order and the drain retires every
    injected frame)."""
    dec = minsum_qc_stream(QC)
    tiny = simulate_stream(
        QC.n, dec, SNR, RATE, T,
        stop=StopRule(min_bit_errors=0, min_word_errors=0,
                      max_frames=300),
        lanes=32, refill_every=1, seed=7,
        pool_bytes=QC.n * 4 * 80,  # ~80-frame pools
    )
    assert tiny.total_words >= 300
    ref = reference_frames(
        dec, QC.n, tiny.total_words,
        lambda rows: decode_minsum_qc(QC, rows, T, early_termination=True),
    )
    assert tiny.errors == sum(e for _i, e in ref.values())
    assert tiny.total_iterations == sum(i for i, _e in ref.values())
    assert tiny.word_errors == sum(1 for _i, e in ref.values() if e > 0)
    assert tiny.iteration_hist.sum() == tiny.total_words


def test_sweep_stream_cli(tmp_path):
    """--stream CLI route: min-sum QC and BP QC rows through the
    streaming harness, reference log-row format intact."""
    from ldpcsimulation_tpu.tools import sweep as sweep_mod

    for dec, extra in (
        ("minsum", []),
        ("bp", []),
    ):
        log = str(tmp_path / f"{dec}_stream.log")
        sweep_mod.main([
            dec, "--code", "qc_1008_504", "--snr", "2.0", "-T", "8",
            "--log", log, "--batch", "64", "--early-termination",
            "--stream", "--min-errors", "50", "--min-word-errors", "2",
            "--pool-bytes", str(2 * 1008 * 4 * 200),
            *extra,
        ])
        row = open(log).read().strip()
        assert row, dec
        assert len(row.split("\n")) == 1


def test_sweep_stream_cli_layered(tmp_path):
    """--schedule layered --stream: the layered stream adapters route
    through the CLI (VERDICT r4 item 3), reference log-row format
    intact."""
    from ldpcsimulation_tpu.tools import sweep as sweep_mod

    for dec in ("minsum", "bp"):
        log = str(tmp_path / f"{dec}_layered_stream.log")
        rc = sweep_mod.main([
            dec, "--code", "qc_1008_504", "--schedule", "layered",
            "--snr", "2.0", "-T", "8", "--log", log, "--batch", "64",
            "--early-termination", "--stream", "--min-errors", "50",
            "--min-word-errors", "2",
        ])
        assert rc == 0
        row = open(log).read().strip()
        assert row, dec
        assert len(row.split("\n")) == 1


def test_sweep_stream_rejects_bad_combos(tmp_path):
    from ldpcsimulation_tpu.tools import sweep as sweep_mod

    with pytest.raises(SystemExit):
        sweep_mod.main([
            "minsum", "--code", "qc_1008_504", "--snr", "2.0", "-T", "5",
            "--log", str(tmp_path / "x.log"), "--stream",
        ])  # no --early-termination
    with pytest.raises(SystemExit):
        sweep_mod.main([
            "minsum", "--code", "qc_1008_504", "--snr", "2.0", "-T", "5",
            "--log", str(tmp_path / "y.log"), "--stream",
            "--early-termination", "--distributed",
        ])  # --distributed is the batched grid engine


def test_sweep_stream_cli_gdbf_and_nbqspa(tmp_path):
    """--stream CLI routes for the round-4 additions: a GDBF preset
    (per-frame keyed decoder noise, harness/stream_gdbf.py) and NB-QSPA
    (harness/stream.py nb pool), reference log-row formats intact."""
    from ldpcsimulation_tpu.tools import sweep as sweep_mod

    log = str(tmp_path / "gdbf_stream.log")
    rc = sweep_mod.main([
        "gdbf", "--preset", "SMNGDBF", "--code", "qc_1008_504",
        "--snr", "3.5", "-T", "12", "--theta", "-0.7",
        "--noise-scale", "0.9", "--lam", "0.98", "--alpha", "0.8",
        "--window", "8", "--log", log, "--batch", "64",
        "--stream", "--max-frames", "128", "--min-errors", "1",
        "--min-word-errors", "1",
    ])
    assert rc == 0
    row = open(log).read().strip()
    assert row and len(row.split("\n")) == 1
    # smoothing_used column present (SMNGDBF row format)
    assert "qc_1008_504" in row

    log2 = str(tmp_path / "nb_stream.log")
    rc = sweep_mod.main([
        "nbqspa", "--nb-random", "24:12:3:4", "--snr", "2.5", "-T", "8",
        "--log", log2, "--batch", "64", "--stream",
        "--max-frames", "128", "--min-errors", "1",
        "--min-word-errors", "1",
    ])
    assert rc == 0
    row2 = open(log2).read().strip()
    assert row2 and len(row2.split("\n")) == 1

    # unstructured alist routing through the stratified stream adapter
    from ldpcsimulation_tpu.codes.alist import save_alist
    from .test_stratified import synthetic_irregular_stratified

    ap = tmp_path / "irr.alist"
    save_alist(synthetic_irregular_stratified(n=192, h=24, mb=4, seed=3),
               str(ap))
    log_s = str(tmp_path / "strat_stream.log")
    rc = sweep_mod.main([
        "minsum", "--alist", str(ap), "--snr", "3.0", "-T", "8",
        "--log", log_s, "--batch", "64", "--early-termination",
        "--stream", "--max-frames", "128", "--min-errors", "1",
        "--min-word-errors", "1",
    ])
    assert rc == 0
    assert open(log_s).read().strip()

    log3 = str(tmp_path / "ddbmp_stream.log")
    rc = sweep_mod.main([
        "ddbmp", "--code", "qc_1008_504", "--snr", "3.9", "-T", "10",
        "--log", log3, "--batch", "64", "--stream",
        "--max-frames", "128", "--min-errors", "1",
        "--min-word-errors", "1",
    ])
    assert rc == 0
    row3 = open(log3).read().strip()
    assert row3 and len(row3.split("\n")) == 1
