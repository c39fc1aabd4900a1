"""Tools layer: sweep CLI, replay/trace, error imaging, redecode stats."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpcsimulation_tpu.channel import snr_to_sigma
from ldpcsimulation_tpu.codes import make_regular_code, save_alist, peg
from ldpcsimulation_tpu.decoders.gdbf import preset
from ldpcsimulation_tpu.tools import (
    decisions_to_errors,
    error_count_trace,
    error_matrix_png,
    redecode_statistics,
    replay_channel,
    trace_gdbf,
    write_trace,
)
from ldpcsimulation_tpu.tools.sweep import _parse_snr, main as sweep_main


def test_parse_snr():
    assert _parse_snr("1.6:2.6:0.5") == [1.6, 2.1, 2.6]
    assert _parse_snr("2.0") == [2.0]
    assert _parse_snr("1,2,3") == [1.0, 2.0, 3.0]


def test_sweep_minsum_named_code(tmp_path):
    log = tmp_path / "ms.log"
    rc = sweep_main(
        [
            "minsum", "--code", "peg_96_48", "--snr", "3.0:4.0:1.0",
            "-T", "5", "--log", str(log), "--batch", "64",
            "--max-frames", "128", "--min-errors", "1",
            "--min-word-errors", "1",
        ]
    )
    assert rc == 0
    rows = log.read_text().strip().splitlines()
    assert len(rows) == 2  # two SNR points
    cols = rows[0].split("\t")
    assert cols[0] == "3" and cols[4] == "5" and cols[5] == "peg_96_48"


def test_sweep_gdbf_preset_and_alist(tmp_path):
    a = peg(48, 24, 3, seed=9)
    ap = tmp_path / "c.alist"
    save_alist(a, str(ap))
    log = tmp_path / "g.log"
    rc = sweep_main(
        [
            "gdbf", "--preset", "SMNGDBF", "--alist", str(ap),
            "--snr", "4.0", "-T", "20", "--theta", "-0.9",
            "--noise-scale", "0.9", "--lam", "0.98", "--alpha", "1.5",
            "--ymax", "2.5", "--window", "8",
            "--log", str(log), "--batch", "64", "--max-frames", "64",
            "--min-errors", "1", "--min-word-errors", "1",
        ]
    )
    assert rc == 0
    cols = log.read_text().strip().split("\t")
    # SNR BER avgIters WER totalBits totalWords T theta noiseScale lambda
    # alpha smoothingUsed ratio windowsize Ymax alist
    assert len(cols) == 16
    assert cols[6] == "20" and cols[7] == "-0.9"


def test_sweep_ngdbfhw_writes_itdist(tmp_path):
    log = tmp_path / "hw.log"
    rc = sweep_main(
        [
            "ngdbfhw", "--code", "peg_96_48", "--snr", "5.0",
            "-T", "30", "--w", "0.2", "--ymax", "2.0",
            "--noise-scale", "0.8", "--theta0", "-0.6",
            "--log", str(log), "--batch", "32", "--frames", "64",
        ]
    )
    assert rc == 0
    assert len(log.read_text().strip().split("\t")) == 16
    itdist = tmp_path / "hw.log_5_itdist.dat"
    assert itdist.exists()
    lines = itdist.read_text().strip().splitlines()
    v0 = float(lines[0].split("\t")[1])
    assert v0 == 1.0  # every frame uses >= 0 iterations


@pytest.fixture(scope="module")
def tcode():
    return make_regular_code(48, 24, 3, seed=4)


def test_replay_channel_deterministic(tcode):
    sigma = 0.5
    y1, k1 = replay_channel(tcode, seed=7, batch_index=3, frame_index=5,
                            batch_size=16, sigma=sigma)
    y2, _ = replay_channel(tcode, seed=7, batch_index=3, frame_index=5,
                           batch_size=16, sigma=sigma)
    np.testing.assert_array_equal(y1, y2)
    y3, _ = replay_channel(tcode, seed=7, batch_index=3, frame_index=6,
                           batch_size=16, sigma=sigma)
    assert (y1 != y3).any()


@pytest.mark.parametrize("awgn_form", ["multiplicative", "additive"])
def test_replay_channel_bit_exact_vs_simulate(tcode, awgn_form):
    """replay_channel returns the rows simulate()'s compiled batch step
    drew, to the last bit (an op-by-op draw rounds 1 + sigma*n twice)."""
    from ldpcsimulation_tpu.channel import snr_to_n0
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

    snr, seed, batch = 1.5, 7, 16
    simulate(tcode, capture, snr, stop=StopRule.fixed_frames(2 * batch),
             batch_size=batch, seed=seed, awgn_form=awgn_form)
    jax.effects_barrier()
    assert len(rows) == 2
    sigma = float(np.sqrt(float(snr_to_n0(snr, tcode.rate)) / 2.0))
    for b in range(2):
        for f in (0, 9, 15):
            y, _ = replay_channel(tcode, seed, b, f, batch, sigma,
                                  awgn_form=awgn_form)
            np.testing.assert_array_equal(y, rows[b][f])


def test_trace_gdbf_and_imaging(tcode, tmp_path, rng):
    sigma = float(snr_to_sigma(3.0, 0.5))
    yq = np.clip(1 + sigma * rng.normal(size=tcode.n), -2.5, 2.5)
    cfg = preset("MNGDBF", num_iterations=15, theta=-0.8, noise_scale=0.9,
                 alpha=1.5)
    tr = trace_gdbf(tcode, yq, sigma, cfg, key=jax.random.key(0))
    assert tr.decisions.shape[1] == tcode.n
    assert tr.syndromes.shape[1] == tcode.m
    assert tr.decisions.shape[0] == tr.syndromes.shape[0]
    # row 0 is the channel hard decision
    np.testing.assert_array_equal(tr.decisions[0], np.where(yq > 0, 1, -1))
    if tr.satisfied:
        assert (tr.syndromes[-1] == 1).all()
    tp = tmp_path / "t.trace"
    write_trace(tr, str(tp))
    assert tp.read_text().startswith("d ")
    # imaging
    errs = decisions_to_errors(tr.decisions, np.ones(tcode.n))
    png = tmp_path / "e.png"
    error_matrix_png(errs, str(png))
    assert png.stat().st_size > 100
    et = tmp_path / "e.err"
    error_count_trace(errs, str(et))
    assert len(et.read_text().splitlines()) == errs.shape[0]


def test_redecode_statistics(tcode, tmp_path):
    cfg = preset("SMNGDBF", num_iterations=25, theta=-0.8, noise_scale=0.9,
                 alpha=1.5, window_size=8)
    with open(tmp_path / "rs.log", "w") as f:
        out = redecode_statistics(
            tcode, cfg, snr_db=3.0, num_frames=6, num_redecodes=8,
            seed=11, log=f,
        )
    assert out.shape == (6, 8)
    rows = (tmp_path / "rs.log").read_text().strip().splitlines()
    assert len(rows) == 6
    assert rows[0].split("\t")[0] == "0"
    # attempts on the same frame must differ sometimes when noisy decode
    # fails (frame-specific Pe) — at least the outcomes are not all equal
    # across frames
    assert len({tuple(r) for r in out}) > 1


def test_msg_trace(tcode, rng):
    from ldpcsimulation_tpu.tools.msg_trace import trace_soft_decoder

    sigma = 0.7
    y = 1 + sigma * rng.normal(size=tcode.n)
    truth = np.ones(tcode.n)
    tr = trace_soft_decoder(tcode, y, truth, num_iterations=4,
                            algorithm="minsum")
    assert len(tr.decisions) == 4
    # message errors should not increase from iteration 1 to the last on a
    # decodable frame; at minimum shapes are sane
    assert tr.v2c_sign_errors[0].shape == (tcode.n, 3)
    assert tr.checks_with_errors[0].shape == (tcode.m,)
    # consistency: per-check error counts equal total v2c errors
    assert tr.checks_with_errors[-1].sum() == tr.v2c_sign_errors[-1].sum()
    tr_bp = trace_soft_decoder(tcode, 4 * y, truth, num_iterations=2,
                               algorithm="bp")
    assert len(tr_bp.decisions) == 2


def test_prob_combinations():
    from ldpcsimulation_tpu.tools.prob_combinations import (
        enumerate_probabilities,
        nearest_levels,
    )

    levels = enumerate_probabilities(max_bits=5, max_ops=3)
    assert 0.0 in levels and 1.0 in levels
    assert 0.0625 in levels and 0.25 in levels  # primitive streams
    # the stochastic-NGDBF hardware table values (decodeGDBF.cpp:564-575,
    # themselves rounded decimals) are realizable to their printed precision
    from ldpcsimulation_tpu.decoders.gdbf import PR_LEVELS

    for p in PR_LEVELS:
        snapped = nearest_levels([p], levels)[0][1]
        assert abs(snapped - p) < 5e-3, (p, snapped)


def test_sweep_nbqspa(tmp_path):
    log = tmp_path / "nb.log"
    rc = sweep_main(
        [
            "nbqspa", "--nb-random", "24:12:3:4", "--snr", "5.0",
            "-T", "10", "--log", str(log), "--batch", "16",
            "--max-frames", "32", "--min-errors", "1",
            "--min-word-errors", "1",
        ]
    )
    assert rc == 0
    cols = log.read_text().strip().split("\t")
    assert len(cols) == 7  # SNR SER BER avgIters FER T name
    assert cols[5] == "10"


def test_sweep_layered_schedule(tmp_path):
    log = tmp_path / "lay.log"
    rc = sweep_main(
        [
            "minsum", "--code", "qc_1008_504", "--schedule", "layered",
            "--snr", "3.0", "-T", "8", "--early-termination",
            "--log", str(log), "--batch", "32", "--max-frames", "32",
            "--min-errors", "1", "--min-word-errors", "1",
        ]
    )
    assert rc == 0
    assert len(log.read_text().strip().splitlines()) == 1


def test_sweep_distributed(tmp_path):
    log = tmp_path / "dist.log"
    rc = sweep_main(
        [
            "minsum", "--code", "peg_96_48", "--snr", "2.0,4.0",
            "-T", "5", "--early-termination", "--distributed",
            "--log", str(log), "--batch", "16",
            "--min-errors", "10", "--min-word-errors", "2",
            "--max-frames", "512",
        ]
    )
    assert rc == 0
    rows = log.read_text().strip().splitlines()
    assert len(rows) == 2
    ber_lo = float(rows[0].split("\t")[1])
    ber_hi = float(rows[1].split("\t")[1])
    assert ber_lo > ber_hi


def test_hw_trace_matches_decoder(rng, tmp_path):
    """The tracing reference loop must agree with the batched NGDBFhw
    decoder bit for bit (same ring, same frame)."""
    import io

    from ldpcsimulation_tpu.codes import build_code, peg
    from ldpcsimulation_tpu.decoders.ngdbf_hw import (
        NGDBFHwConfig,
        decode_ngdbf_hw,
    )
    from ldpcsimulation_tpu.tools.hw_trace import trace_ngdbf_hw

    a = peg(64, 16, 2, seed=31)
    code = build_code(a)
    cfg = NGDBFHwConfig(num_iterations=30, w=0.25, ymax=1.5,
                        noise_scale=0.9, theta0=-0.5, nq=5, ring_len=200)
    sigma = 0.35
    y = np.ones(code.n) * (1 + sigma * rng.normal(size=code.n))
    ring = rng.normal(0.0, sigma * cfg.noise_scale, size=cfg.ring_len)
    buf = io.StringIO()
    d_bits, iters, sat, _qp = trace_ngdbf_hw(code, y, sigma, cfg, ring, buf)
    res = decode_ngdbf_hw(
        code, jnp.asarray(y)[None, :], sigma, cfg,
        key=jax.random.key(0), ring_noise=jnp.asarray(ring)[:, None],
    )
    np.testing.assert_array_equal(1 - 2 * np.asarray(d_bits),
                                  np.asarray(res.hard)[0])
    assert iters == int(res.iterations[0])
    text = buf.getvalue()
    assert text.startswith("GLOBALS:")
    assert "CHANIN:" in text and "NOISE:" in text
    if iters > 0:
        assert "IT 0" in text and "\tE: " in text and "\tflip: " in text


def test_sweep_with_codeword_fixtures(tmp_path):
    """--codewords: data.enc-style fixture cycling through the CLI."""
    import jax as _jax

    from ldpcsimulation_tpu.codes import make_encoder, random_codewords
    from ldpcsimulation_tpu.harness.fixtures import save_codeword_file

    code = make_regular_code(96, 48, 3, seed=0)
    enc = make_encoder(code)
    cw = np.asarray(random_codewords(enc, _jax.random.key(9), 20))
    cwf = tmp_path / "data.enc"
    save_codeword_file(str(cwf), cw)
    log = tmp_path / "cw.log"
    rc = sweep_main(
        [
            "minsum", "--code", "peg_96_48", "--snr", "5.0", "-T", "8",
            "--early-termination", "--codewords", str(cwf),
            "--log", str(log), "--batch", "40", "--max-frames", "80",
            "--min-errors", "1", "--min-word-errors", "1",
        ]
    )
    assert rc == 0
    cols = log.read_text().strip().split("\t")
    assert float(cols[1]) < 0.05  # decodes real codewords at 5 dB


def test_sweep_distributed_gdbf(tmp_path):
    log = tmp_path / "dg.log"
    rc = sweep_main(
        [
            "gdbf", "--preset", "SMNGDBF", "--code", "peg_96_48",
            "--snr", "3.0,4.5", "-T", "30", "--theta", "-0.8",
            "--noise-scale", "0.9", "--lam", "0.98", "--alpha", "0.75",
            "--ymax", "2.5", "--distributed",
            "--log", str(log), "--batch", "16",
            "--min-errors", "10", "--min-word-errors", "2",
            "--max-frames", "1024",
        ]
    )
    assert rc == 0
    rows = log.read_text().strip().splitlines()
    assert len(rows) == 2
    assert float(rows[0].split("\t")[1]) >= float(rows[1].split("\t")[1])


def test_sweep_resume_multi_parameter_grid(tmp_path):
    """--resume keys completed points on the FULL operating-point tuple via
    the <log>.done sidecar: after a 1x2 (snr x ymax) run, adding a new ymax
    value must re-run only the new combinations (ADVICE r1)."""
    log = tmp_path / "ms.log"
    base = [
        "offsetminsum", "--code", "peg_96_48", "--snr", "3.0",
        "-T", "5", "--log", str(log), "--batch", "64",
        "--max-frames", "64", "--min-errors", "1",
        "--min-word-errors", "1", "--nq", "8", "--delta", "0.15",
    ]
    assert sweep_main(base + ["--ymax", "1.5", "2.0"]) == 0
    rows = log.read_text().strip().splitlines()
    assert len(rows) == 2
    done = (tmp_path / "ms.log.done").read_text().strip().splitlines()
    assert len(done) == 2 and len(set(done)) == 2
    # resume with a third ymax: the two logged points skip, one new row lands
    assert sweep_main(
        base + ["--ymax", "1.5", "2.0", "2.5", "--resume"]
    ) == 0
    rows = log.read_text().strip().splitlines()
    assert len(rows) == 3
    done = (tmp_path / "ms.log.done").read_text().strip().splitlines()
    assert len(done) == 3
    # resuming the identical grid is a full no-op
    assert sweep_main(
        base + ["--ymax", "1.5", "2.0", "2.5", "--resume"]
    ) == 0
    assert len(log.read_text().strip().splitlines()) == 3


def test_sweep_resume_legacy_snr_only_log(tmp_path):
    """A pre-sidecar log resumes by SNR column when the grid is SNR-only."""
    log = tmp_path / "ms.log"
    base = [
        "minsum", "--code", "peg_96_48", "-T", "5", "--log", str(log),
        "--batch", "64", "--max-frames", "64", "--min-errors", "1",
        "--min-word-errors", "1",
    ]
    assert sweep_main(base + ["--snr", "3.0"]) == 0
    (tmp_path / "ms.log.done").unlink()  # simulate a legacy log
    assert sweep_main(base + ["--snr", "3.0:4.0:1.0", "--resume"]) == 0
    rows = log.read_text().strip().splitlines()
    assert len(rows) == 2  # 3.0 skipped, only 4.0 ran
    assert rows[1].split("\t")[0] == "4"


def test_sweep_distributed_ddbmp_ngdbfhw(tmp_path):
    """--distributed covers the remaining binary decoders (VERDICT r1 #7)."""
    log1 = tmp_path / "dd.log"
    rc = sweep_main(
        [
            "ddbmp", "--code", "peg_96_48", "--snr", "3.0,5.0", "-T", "20",
            "--ymax", "1.5", "--nq", "8", "--distributed",
            "--log", str(log1), "--batch", "16",
            "--min-errors", "5", "--min-word-errors", "1",
            "--max-frames", "512",
        ]
    )
    assert rc == 0
    rows = log1.read_text().strip().splitlines()
    assert len(rows) == 2
    assert float(rows[0].split("\t")[1]) >= float(rows[1].split("\t")[1])

    log2 = tmp_path / "hw.log"
    rc = sweep_main(
        [
            "ngdbfhw", "--code", "peg_96_48", "--snr", "4.0,6.0", "-T", "30",
            "--distributed", "--log", str(log2), "--batch", "16",
            "--min-errors", "5", "--min-word-errors", "1",
            "--max-frames", "512",
        ]
    )
    assert rc == 0
    rows = log2.read_text().strip().splitlines()
    assert len(rows) == 2


def test_sweep_distributed_nbqspa(tmp_path):
    log = tmp_path / "nb.log"
    rc = sweep_main(
        [
            "nbqspa", "--nb-random", "24:12:3:8", "--snr", "3.0,6.0",
            "-T", "8", "--distributed", "--log", str(log), "--batch", "8",
            "--min-errors", "5", "--min-word-errors", "1",
            "--max-frames", "256",
        ]
    )
    assert rc == 0
    rows = log.read_text().strip().splitlines()
    assert len(rows) == 2
    # SER SNR ordering
    assert float(rows[0].split("\t")[1]) >= float(rows[1].split("\t")[1])


def test_errimage_merge_tools(tmp_path):
    """errtopng's shiftMatrix/mergeMatrices/main composition semantics
    (errtopng.cpp:28-110) — the multi-trace half missing in round 1."""
    from ldpcsimulation_tpu.tools.errimage import (
        compose_error_images,
        merge_matrices,
        read_matrix_file,
        shift_scale_matrix,
        write_matrix_file,
    )

    # shift(-1)*scale(-1): +1 (correct) -> 0, -1 (error) -> 2
    m = shift_scale_matrix(np.array([[1, -1], [-1, -1]]))
    np.testing.assert_array_equal(m, [[0, 2], [2, 2]])

    # merge: overlapping rows add, longer trace's tail appended verbatim
    a = np.array([[1.0, 2.0]])
    b = np.array([[10.0, 20.0], [30.0, 40.0]])
    np.testing.assert_array_equal(
        merge_matrices(a, b), [[11, 22], [30, 40]]
    )
    np.testing.assert_array_equal(
        merge_matrices(b, a), [[11, 22], [30, 40]]
    )
    np.testing.assert_array_equal(merge_matrices(np.zeros((0, 0)), a), a)

    # file roundtrip incl. the write_trace 'd'/'s' tagged format
    p1 = tmp_path / "t1.mat"
    write_matrix_file(str(p1), np.array([[1, -1, 1], [1, 1, 1]]))
    np.testing.assert_array_equal(
        read_matrix_file(str(p1)), [[1, -1, 1], [1, 1, 1]]
    )
    p2 = tmp_path / "t2.trace"
    p2.write_text("d 1 1 -1\ns 1 -1 1\nd 1 1 1\ns 1 1 1\n")
    np.testing.assert_array_equal(
        read_matrix_file(str(p2)), [[1, 1, -1], [1, 1, 1]]
    )

    # full composition: two traces -> merged png + per-trace .err history
    out = tmp_path / "merged"
    merged = compose_error_images(str(out), [str(p1), str(p2)])
    np.testing.assert_array_equal(merged, [[0, 2, 2], [0, 0, 0]])
    assert (tmp_path / "merged.png").exists()
    err_lines = (tmp_path / "merged.err").read_text().strip().splitlines()
    assert err_lines[0].split("\t") == ["2", "0"]  # trace1: 1 err, 0 err
    assert err_lines[1].split("\t") == ["2", "0"]


def test_trace_gdbf_single_decode_rows(tcode, rng):
    """O(T) trace: rows = channel + executed rounds; final row equals the
    decoder's output for the same frame."""
    import jax

    from ldpcsimulation_tpu.decoders.gdbf import decode_gdbf, preset
    from ldpcsimulation_tpu.tools.replay import trace_gdbf

    cfg = preset("SMNGDBF", num_iterations=25, theta=-0.7, alpha=0.9,
                 window_size=8)
    y = np.asarray(1.0 + 0.7 * rng.standard_normal(tcode.n), np.float32)
    key = jax.random.key(5)
    tr = trace_gdbf(tcode, y, 0.7, cfg, key=key)
    res = decode_gdbf(tcode, jnp.asarray(y)[None, :], 0.7, cfg, key=key)
    assert tr.satisfied == bool(res.satisfied[0])
    assert tr.iterations == int(res.iterations[0])
    if tr.satisfied:
        assert tr.decisions.shape[0] == max(tr.iterations, 1) + 1
        # frozen state == decoder output
        np.testing.assert_array_equal(
            tr.decisions[-1], np.asarray(res.hard)[0]
        )
    else:
        assert tr.decisions.shape[0] == cfg.num_iterations + 1
        np.testing.assert_array_equal(
            tr.decisions[-1], np.asarray(res.hard)[0]
        )


def test_sweep_autodetects_qc_alist(tmp_path, capsys):
    """An alist with circulant structure is auto-routed to the roll
    decoders (VERDICT r1 #2 detection half)."""
    from ldpcsimulation_tpu.codes.qc import qc_peg
    from ldpcsimulation_tpu.codes.alist import save_alist

    qc = qc_peg(12, 6, 3, z=8, seed=2)
    ap = tmp_path / "qc.alist"
    save_alist(qc.to_alist(), str(ap))
    log = tmp_path / "q.log"
    rc = sweep_main(
        [
            "minsum", "--alist", str(ap), "--snr", "4.0", "-T", "5",
            "--log", str(log), "--batch", "64", "--max-frames", "64",
            "--min-errors", "1", "--min-word-errors", "1",
        ]
    )
    assert rc == 0
    assert "detected QC structure z=8" in capsys.readouterr().err
    assert len(log.read_text().strip().splitlines()) == 1


def test_sweep_msg_dtype_f16_and_f32_rows(tmp_path):
    """--msg-dtype routes uniformly: both modes produce a valid row on the
    same grid point (f16 storage is the benchmark mode, BER-identical in
    distribution; this is a routing test, not a statistical one)."""
    rows = {}
    for mode in ("f32", "f16"):
        log = tmp_path / f"ms_{mode}.log"
        rc = sweep_main(
            [
                "minsum", "--code", "peg_96_48", "--snr", "4.0", "-T", "5",
                "--log", str(log), "--batch", "64", "--max-frames", "128",
                "--min-errors", "1", "--msg-dtype", mode,
            ]
        )
        assert rc == 0
        rows[mode] = log.read_text().strip().split("\t")
    # same schema, same SNR column; BER finite in both modes
    assert rows["f32"][0] == rows["f16"][0] == "4"
    assert 0.0 <= float(rows["f16"][1]) < 0.5


def test_sweep_distributed_ngdbfhw_fixed_frames(tmp_path):
    """--distributed ngdbfhw must honor the reference's fixed-frame-count
    stop rule (NGDBFhw.cpp:193): exactly --frames frames, same as the
    non-distributed route."""
    log = tmp_path / "hw_dist.log"
    rc = sweep_main(
        [
            "ngdbfhw", "--code", "peg_96_48", "--snr", "3.0", "-T", "5",
            "--log", str(log), "--batch", "8", "--frames", "128",
            "--distributed",
        ]
    )
    assert rc == 0
    cols = log.read_text().strip().split("\t")
    # ngdbfhw row schema: SNR errors frames BER avgIters FER ...
    # (frame totals advance in rounds of batch x devices = 64; 128 is
    # round-aligned so the fixed-frames rule stops exactly there, instead
    # of the error-count rule's data-dependent total)
    assert int(cols[2]) == 128


def test_sweep_gdbf_uniform_noise(tmp_path):
    """--uniform-noise maps the reference's -DUNIFORM NGDBF builds
    (variance-matched uniform perturbation) onto any GDBF preset."""
    log = tmp_path / "uni.log"
    rc = sweep_main(
        [
            "gdbf", "--preset", "SMNGDBF", "--uniform-noise",
            "--code", "peg_96_48", "--snr", "5.0", "-T", "20",
            "--theta", "-0.9", "--noise-scale", "1.0", "--lam", "0.97",
            "--alpha", "2.25", "--ymax", "2.5", "--log", str(log),
            "--batch", "64", "--max-frames", "128", "--min-errors", "1",
        ]
    )
    assert rc == 0
    assert log.read_text().strip()


def test_replay_reproduces_in_batch_gdbf_decode():
    """Replay fidelity: a frame traced via the CLI path (channel replay +
    replay_decoder_randomness injection) must reproduce the decode it had
    INSIDE its original batch exactly — the decoder draws [N, B]
    perturbations per iteration, so a naive B=1 re-decode sees different
    noise (the round-2 review finding)."""
    from ldpcsimulation_tpu.channel.awgn import snr_to_sigma
    from ldpcsimulation_tpu.channel.quantize import saturate
    from ldpcsimulation_tpu.codes import build_code, peg
    from ldpcsimulation_tpu.decoders.gdbf import decode_gdbf, preset
    from ldpcsimulation_tpu.harness.montecarlo import draw_channel
    from ldpcsimulation_tpu.tools.replay import (
        replay_channel,
        replay_decoder_randomness,
        trace_gdbf,
    )

    code = build_code(peg(96, 48, 3, seed=3))
    cfg = preset("SMNGDBF", num_iterations=30, theta=-0.8,
                 noise_scale=0.9, lam=0.98, alpha=0.9, window_size=8)
    sigma = float(snr_to_sigma(3.0, 0.5))
    seed, batch_index, B = 11, 2, 8

    # original batched decode, exactly as simulate() would run it: the
    # channel draw compiled, with sigma a constant
    root = jax.random.key(seed)
    key = jax.random.fold_in(root, batch_index)
    bits = jnp.zeros((B, code.n), jnp.uint8)
    y, kdec = jax.jit(draw_channel, static_argnums=(2,))(key, bits, sigma)
    yq = saturate(y, 2.5)
    batch_res = decode_gdbf(code, yq, sigma, cfg, key=kdec)

    for frame in (0, 5):
        y_f, kdec_r = replay_channel(code, seed, batch_index, frame, B, sigma)
        np.testing.assert_array_equal(y_f, np.asarray(y[frame]))
        pert, stoch = replay_decoder_randomness(
            code.n, cfg, kdec_r, B, frame, sigma
        )
        assert stoch is None  # SMNGDBF is not stochastic
        tr = trace_gdbf(
            code, np.asarray(saturate(jnp.asarray(y_f), 2.5)), sigma, cfg,
            key=kdec_r, perturbations=pert, stoch_uniforms=stoch,
        )
        assert tr.iterations == int(batch_res.iterations[frame])
        assert tr.satisfied == bool(batch_res.satisfied[frame])
        np.testing.assert_array_equal(
            tr.decisions[-1], np.asarray(batch_res.hard[frame])
        )


def test_sweep_parse_snr_reversed_range():
    with pytest.raises(SystemExit, match="empty"):
        _parse_snr("3.8:1.6:0.2")


def test_sweep_distributed_guards(tmp_path):
    base = ["minsum", "--code", "peg_96_48", "-T", "3",
            "--log", str(tmp_path / "x.log"), "--batch", "8",
            "--distributed"]
    with pytest.raises(SystemExit, match="layered"):
        sweep_main(base + ["--snr", "2.0", "--schedule", "layered"])
    # plain min-sum has no ymax: a multi-valued irrelevant parameter is a
    # configuration error, not a silently-duplicated grid axis
    with pytest.raises(SystemExit, match="cannot sweep --ymax"):
        sweep_main(base + ["--snr", "2.0", "--ymax", "1.5", "2.0"])
    # gdbf quantizer bit-width is structural: not sweepable per-point
    with pytest.raises(SystemExit, match="--nq"):
        sweep_main(["gdbf", "--code", "peg_96_48", "-T", "3",
                    "--log", str(tmp_path / "y.log"), "--batch", "8",
                    "--distributed", "--snr", "2.0", "--theta", "-0.8",
                    "--nq", "4", "5"])


def test_sweep_distributed_parameter_grid(tmp_path):
    """VERDICT r2 #1: --distributed runs a multi-parameter cartesian grid
    in ONE launch (the reference's mngdbf_example 5-deep nested bash sweep,
    ~1300 nohup processes — scripts/mngdbf_example_PEGReg504x1008.sh:44-59).
    2 SNR x 2 theta x 2 noise-scale x 2 alpha = 16 operating points on the
    8-device mesh; per-point rows must carry each point's own parameter
    values in the same column layout as single-device runs."""
    log = tmp_path / "grid.log"
    rc = sweep_main(
        [
            "gdbf", "--preset", "MNGDBF", "--code", "peg_96_48",
            "--snr", "3.0,4.0", "-T", "20",
            "--theta", "-0.8", "-0.6",
            "--noise-scale", "0.8", "1.0",
            "--alpha", "0.75", "1.0",
            "--lam", "0.98", "--ymax", "2.5",
            "--distributed", "--log", str(log), "--batch", "8",
            "--max-frames", "128",
            "--min-errors", "1000000", "--min-word-errors", "1000000",
        ]
    )
    assert rc == 0
    rows = [r.split("\t") for r in log.read_text().strip().splitlines()]
    assert len(rows) == 16
    # single-device reference row for column layout + parameter columns
    log_s = tmp_path / "single.log"
    assert sweep_main(
        [
            "gdbf", "--preset", "MNGDBF", "--code", "peg_96_48",
            "--snr", "3.0", "-T", "20", "--theta", "-0.8",
            "--noise-scale", "0.8", "--alpha", "0.75", "--lam", "0.98",
            "--ymax", "2.5", "--log", str(log_s), "--batch", "8",
            "--max-frames", "64",
            "--min-errors", "1000000", "--min-word-errors", "1000000",
        ]
    ) == 0
    cols_s = log_s.read_text().strip().split("\t")
    assert all(len(r) == len(cols_s) for r in rows)
    # every grid combination appears exactly once, with its own values
    # (gdbf row: SNR BER avgIters FER bits words T theta noiseScale lam
    #  alpha ymax alist — logging.gdbf_log_row)
    seen = {(r[0], r[7], r[8], r[10]) for r in rows}
    expect = {
        (f"{snr:g}", f"{th:g}", f"{ns:g}", f"{al:g}")
        for snr in (3.0, 4.0)
        for th in (-0.8, -0.6)
        for ns in (0.8, 1.0)
        for al in (0.75, 1.0)
    }
    assert seen == expect


def test_sweep_distributed_row_layout_matches_single_device(tmp_path):
    """Appending distributed and non-distributed rows of the same config
    to one log must yield a parseable file: identical column counts
    (round-2 review finding: distributed gdbf dropped the smoothing
    columns; offset/normalized min-sum dropped the quantizer and its
    Ymax column)."""
    common = ["--code", "peg_96_48", "--snr", "4.0", "-T", "15",
              "--batch", "16", "--max-frames", "64",
              "--min-errors", "1000000", "--min-word-errors", "1000000"]
    for decoder, extra in [
        ("gdbf", ["--preset", "SMNGDBF", "--theta", "-0.8",
                  "--noise-scale", "0.9", "--lam", "0.98",
                  "--alpha", "0.9", "--ymax", "2.5"]),
        ("offsetminsum", ["--ymax", "2.0", "--nq", "8",
                          "--delta", "0.25"]),
    ]:
        log_s = tmp_path / f"{decoder}_s.log"
        log_d = tmp_path / f"{decoder}_d.log"
        assert sweep_main([decoder, *common, *extra,
                           "--log", str(log_s)]) == 0
        assert sweep_main([decoder, *common, *extra, "--distributed",
                           "--log", str(log_d)]) == 0
        cols_s = log_s.read_text().strip().split("\t")
        cols_d = log_d.read_text().strip().split("\t")
        assert len(cols_s) == len(cols_d), (decoder, cols_s, cols_d)


def test_sweep_distributed_quantizes_variants(tmp_path):
    """Distributed offset/normalized min-sum must simulate the SAME
    channel as the non-distributed route (quantize_no_zero applied):
    with a very coarse quantizer the BER visibly differs from the
    unquantized channel, so equality of the distributed row's BER with a
    quantized single-device run (same seed protocol, huge frame budget,
    fixed frames) is a strong routing signal."""
    common = ["normalizedminsum", "--code", "peg_96_48", "--snr", "3.0",
              "-T", "8", "--alpha", "1.25", "--ymax", "1.0", "--nq", "2",
              "--batch", "16", "--max-frames", "128",
              "--min-errors", "1000000", "--min-word-errors", "1000000"]
    log_d = tmp_path / "d.log"
    assert sweep_main(common + ["--distributed", "--log", str(log_d)]) == 0
    ber_d = float(log_d.read_text().strip().split("\t")[1])
    # Nq=2 levels at Ymax=1 is brutally coarse: BER must be well above the
    # unquantized operating point (~5e-3 at 3 dB) — proves the quantizer
    # actually ran on the distributed path
    assert ber_d > 0.02, ber_d


def test_sweep_distributed_resume(tmp_path):
    log = tmp_path / "r.log"
    base = ["minsum", "--code", "peg_96_48", "--snr", "3.0,4.0", "-T", "3",
            "--log", str(log), "--batch", "8", "--max-frames", "32",
            "--min-errors", "1", "--min-word-errors", "1",
            "--distributed", "--resume"]
    assert sweep_main(base) == 0
    n_rows = len(log.read_text().strip().splitlines())
    assert n_rows == 2
    assert sweep_main(base) == 0  # second run: all points in the sidecar
    assert len(log.read_text().strip().splitlines()) == n_rows  # no dupes


def test_sweep_itdist_biased_format(tmp_path):
    """--itdist-biased writes the reference's file format byte-for-byte
    conventions (idx<TAB>value, C++ default 6-significant-digit doubles,
    num_iterations+1 lines) with the biased estimator's values."""
    log = tmp_path / "hw.log"
    rc = sweep_main(
        [
            "ngdbfhw", "--code", "peg_96_48", "--snr", "5.0",
            "-T", "30", "--w", "0.2", "--ymax", "2.0",
            "--noise-scale", "0.8", "--theta0", "-0.6",
            "--log", str(log), "--batch", "32", "--frames", "64",
            "--itdist-biased",
        ]
    )
    assert rc == 0
    lines = (tmp_path / "hw.log_5_itdist.dat").read_text().splitlines()
    assert len(lines) == 31  # T+1 entries, one per line
    import re

    for idx, line in enumerate(lines):
        m = re.fullmatch(r"(\d+)\t(\d+(?:\.\d+)?(?:e[+-]\d+)?)", line)
        assert m, line
        assert int(m.group(1)) == idx
        # C++ default ostream double formatting == %.6g
        assert m.group(2) == f"{float(m.group(2)):.6g}"
    assert lines[0] == "0\t1"  # every frame uses >= 0 iterations, exactly 1
    vals = [float(l.split("\t")[1]) for l in lines]
    assert all(a >= b - 1e-12 for a, b in zip(vals, vals[1:]))


def test_sweep_distributed_layered(tmp_path):
    """--schedule layered now runs under --distributed (the posterior-copy
    latency that motivated the old rejection is fixed by the per-block
    pytree state — docs/DESIGN.md); rows must match the single-device
    layered route's layout."""
    log = tmp_path / "dl.log"
    rc = sweep_main(
        [
            "minsum", "--code", "qc_1008_504", "--schedule", "layered",
            "--snr", "2.0,3.0", "-T", "6", "--early-termination",
            "--distributed", "--log", str(log), "--batch", "8",
            "--max-frames", "64",
            "--min-errors", "1000000", "--min-word-errors", "1000000",
        ]
    )
    assert rc == 0
    rows = log.read_text().strip().splitlines()
    assert len(rows) == 2
    assert float(rows[0].split("\t")[1]) > float(rows[1].split("\t")[1])
    # layered with a non-QC code still errors clearly
    with pytest.raises(SystemExit, match="layered"):
        sweep_main(
            ["minsum", "--code", "peg_96_48", "--schedule", "layered",
             "--snr", "2.0", "-T", "3", "--distributed",
             "--log", str(tmp_path / "x.log"), "--batch", "8"]
        )
