"""Non-binary FFT-QSPA tests: GF tables, WHT, GF(2) reduction to BP,
brute-force GF(4) check-node oracle, end-to-end GF(4)/GF(64) decodes."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpcsimulation_tpu.channel import awgn, snr_to_n0, snr_to_sigma
from ldpcsimulation_tpu.channel.nb import (
    bits_to_symbols,
    symbol_priors,
    symbols_to_bits,
)
from ldpcsimulation_tpu.codes import build_code, peg
from ldpcsimulation_tpu.codes.construct import nb_regular
from ldpcsimulation_tpu.codes.gf import gf_bits, gf_mul, gf_tables
from ldpcsimulation_tpu.decoders.bp import decode_bp
from ldpcsimulation_tpu.decoders.nb_qspa import decode_nb_qspa, wht


# ---------------------------------------------------------------- GF tables


@pytest.mark.parametrize("q", [2, 4, 8, 16, 64, 256])
def test_gf_field_axioms(q):
    mul, inv = gf_tables(q)
    # commutative, 1 is identity, 0 annihilates
    assert (mul == mul.T).all()
    assert (mul[1] == np.arange(q)).all()
    assert (mul[0] == 0).all()
    # every nonzero element invertible
    for a in range(1, q):
        assert mul[a, inv[a]] == 1
    # nonzero rows are permutations of 0..q-1
    for a in range(1, q):
        assert sorted(mul[a]) == list(range(q))


def test_gf_associativity_spot(rng):
    q = 64
    for _ in range(50):
        a, b, c = rng.integers(0, q, 3)
        assert gf_mul(q, gf_mul(q, a, b), c) == gf_mul(q, a, gf_mul(q, b, c))


# ---------------------------------------------------------------- WHT


@pytest.mark.parametrize("q", [2, 4, 8, 64])
def test_wht_diagonalizes_xor_convolution(q, rng):
    a = rng.normal(size=q)
    b = rng.normal(size=q)
    conv = np.zeros(q)
    for i, j in itertools.product(range(q), range(q)):
        conv[i ^ j] += a[i] * b[j]
    fa = np.asarray(wht(jnp.asarray(a)))
    fb = np.asarray(wht(jnp.asarray(b)))
    back = np.asarray(wht(jnp.asarray(fa * fb))) / q
    np.testing.assert_allclose(back, conv, atol=1e-9)


def test_wht_self_inverse(rng):
    x = rng.normal(size=(3, 16))
    xx = np.asarray(wht(wht(jnp.asarray(x)))) / 16
    np.testing.assert_allclose(xx, x, atol=1e-12)


# ---------------------------------------------------------------- channel


def test_symbol_bit_roundtrip():
    q = 16
    syms = jnp.arange(q)
    bits = symbols_to_bits(syms, q)
    back = bits_to_symbols(bits, q)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(syms))


def test_symbol_priors_clean_channel():
    q = 8
    n0 = 0.25
    syms = jnp.asarray([[3, 0, 7]])
    bits = symbols_to_bits(syms, q)
    y = (1 - 2 * bits).astype(jnp.float64)  # noiseless BPSK
    pri = np.asarray(symbol_priors(y, n0, q))
    assert pri.shape == (1, 3, q)
    np.testing.assert_allclose(pri.sum(-1), 1.0, atol=1e-9)
    assert (pri.argmax(-1) == np.asarray(syms)).all()


# ------------------------------------------------- GF(2) reduces to binary BP


def test_gf2_qspa_matches_binary_bp(rng):
    """Over GF(2), FFT-QSPA is sum-product BP: decisions must coincide."""
    a = peg(48, 24, 3, seed=5)
    code = build_code(a)
    snr, rate = 2.5, 0.5
    n0 = float(snr_to_n0(snr, rate))
    sigma = float(snr_to_sigma(snr, rate))
    b = 8
    y = np.ones((b, 48)) * (1 + sigma * rng.normal(size=(b, 48)))
    llr = np.clip(4 * y / n0, -30, 30)
    # NB path: priors from the same bit observations (m=1)
    pri = np.asarray(symbol_priors(jnp.asarray(y)[..., None], n0, 2))
    res_nb = decode_nb_qspa(
        code, jnp.asarray(pri), num_iterations=6, q=2, early_termination=False
    )
    res_bp = decode_bp(
        code, jnp.asarray(llr), num_iterations=6, max_llr=1e9
    )
    # symbols: 0 -> +1 bipolar
    nb_bipolar = 1 - 2 * np.asarray(res_nb.symbols)
    np.testing.assert_array_equal(nb_bipolar, np.asarray(res_bp.hard))


# ------------------------------------------------- brute-force CN oracle


def brute_force_cn(h_coefs, in_probs):
    """Exact check-node output by O(q^dc) enumeration (the reference
    SystemC LUT intent, NB-LDPC/inc/nodes.h:240-287)."""
    q = in_probs[0].shape[0]
    dc = len(h_coefs)
    outs = []
    for e in range(dc):
        out = np.zeros(q)
        others = [j for j in range(dc) if j != e]
        for combo in itertools.product(range(q), repeat=dc - 1):
            p = 1.0
            s = 0
            for j, xj in zip(others, combo):
                p *= in_probs[j][xj]
                s ^= int(gf_mul(q, h_coefs[j], xj))
            # h_e * x_e must equal s (characteristic 2)
            inv_he = int(
                np.where(gf_tables(q)[0][h_coefs[e]] == 1)[0][0]
            ) if False else None
            # x_e = h_e^{-1} * s
            mul, inv = gf_tables(q)
            xe = mul[inv[h_coefs[e]], s]
            out[xe] += p
        outs.append(out / out.sum())
    return outs


def test_cn_update_matches_brute_force(rng):
    """Single-check GF(4) code: FFT CN update == exhaustive enumeration."""
    from ldpcsimulation_tpu.codes.alist import Alist
    from ldpcsimulation_tpu.decoders.nb_qspa import _gf2m_wht  # noqa: F401

    q = 4
    h_coefs = [1, 2, 3]
    a = Alist(
        n=3, m=1,
        nlist=[[0], [0], [0]], mlist=[[0, 1, 2]],
        q=q, nvals=[[1], [2], [3]], mvals=[[1, 2, 3]],
    )
    code = build_code(a)
    probs = [rng.dirichlet(np.ones(q)) for _ in range(3)]
    # run one CN update by calling the decoder internals via a 1-iteration
    # decode with uniform... instead, reproduce via the public pieces:
    import ldpcsimulation_tpu.decoders.nb_qspa as nbq

    pri = jnp.asarray(np.stack(probs)[None])  # [1, 3, q]
    # one iteration, no ET: v2c init = priors, so c2v after CN equals the
    # brute-force output on the priors; VN then forms the posterior.
    res = decode_nb_qspa(code, pri, num_iterations=1, early_termination=False)
    # check the posterior decision against brute-force posterior
    outs = brute_force_cn(h_coefs, probs)
    post = [probs[e] * outs[e] for e in range(3)]
    expect = [int(np.argmax(p)) for p in post]
    np.testing.assert_array_equal(np.asarray(res.symbols)[0], expect)


# ------------------------------------------------- end-to-end


@pytest.mark.parametrize("q,snr", [(4, 4.0), (64, 6.0)])
def test_nb_decode_end_to_end(q, snr, rng):
    n_sym, m_sym = 48, 24
    a = nb_regular(n_sym, m_sym, 3, q=q, seed=2)
    code = build_code(a)
    m_bits = q.bit_length() - 1
    rate = 0.5
    n0 = float(snr_to_n0(snr, rate))
    sigma = float(snr_to_sigma(snr, rate))
    b = 16
    # all-zero codeword (0 symbols -> all-zero bits -> +1 BPSK)
    y = 1.0 + sigma * rng.normal(size=(b, n_sym, m_bits))
    pri = symbol_priors(jnp.asarray(y, jnp.float32), n0, q)
    res = decode_nb_qspa(code, pri, num_iterations=30)
    syms = np.asarray(res.symbols)
    frame_ok = (syms == 0).all(axis=1)
    assert frame_ok.mean() > 0.8, f"GF({q}) FER too high"
    assert np.asarray(res.satisfied)[frame_ok].all()
    assert np.asarray(res.iterations)[frame_ok].mean() < 30


def test_nb_uncoded_worse_than_decoded(rng):
    """Decoding must beat the raw symbol decisions."""
    q = 4
    a = nb_regular(48, 24, 3, q=q, seed=3)
    code = build_code(a)
    n0 = float(snr_to_n0(3.0, 0.5))
    sigma = float(snr_to_sigma(3.0, 0.5))
    y = 1.0 + sigma * rng.normal(size=(32, 48, 2))
    pri = symbol_priors(jnp.asarray(y, jnp.float32), n0, q)
    raw_errs = int((np.asarray(pri).argmax(-1) != 0).sum())
    res = decode_nb_qspa(code, pri, num_iterations=20)
    dec_errs = int((np.asarray(res.symbols) != 0).sum())
    assert dec_errs < raw_errs


def test_simulate_nb_gf4():
    from ldpcsimulation_tpu.codes import build_code
    from ldpcsimulation_tpu.harness.montecarlo import StopRule
    from ldpcsimulation_tpu.harness.montecarlo_nb import simulate_nb

    code = build_code(nb_regular(48, 24, 3, q=4, seed=6))
    stats = simulate_nb(
        code, snr_db=4.0, num_iterations=20,
        stop=StopRule.fixed_frames(64), batch_size=32, seed=1,
    )
    assert stats.total_words == 64
    assert stats.total_bits == 64 * 48 * 2
    assert stats.ser <= stats.uncoded_symbol_errors / stats.total_symbols
    assert stats.ber < 0.05
    assert 0 < stats.avg_iterations <= 20
    # decoded symbol errors never exceed bit errors x m and >= bit errs / m
    assert stats.bit_errors <= 2 * stats.symbol_errors


@pytest.mark.parametrize("q", [4, 8])
def test_fused_cn_matches_butterfly_and_f16(q, rng, monkeypatch):
    """The fused perm+WHT CN combines (both variants: the per-class static
    unroll for q<=4 and the sign-table broadcast for q<=8) and f16 message
    storage are DECISION-identical to the plain butterfly/f32 path on a
    noisy batch — symbols, iteration counts, and satisfied flags all match.
    Guards future edits to _wht_sign_tables/_class_combine/_signed_combine
    on any backend."""
    from ldpcsimulation_tpu.decoders import nb_qspa as nbq

    a = nb_regular(48, 24, 3, q=q, seed=4)
    code = build_code(a)
    m_bits = q.bit_length() - 1
    snr = 3.0 if q == 4 else 3.5
    n0 = float(snr_to_n0(snr, 0.5))
    sigma = float(snr_to_sigma(snr, 0.5))
    y = 1.0 + sigma * rng.normal(size=(24, 48, m_bits))
    pri = symbol_priors(jnp.asarray(y, jnp.float32), n0, q)

    def run(fused_qmax, storage):
        monkeypatch.setattr(nbq, "_FUSED_QMAX", fused_qmax)
        nbq.decode_nb_qspa.clear_cache()  # same static signature otherwise
        res = nbq.decode_nb_qspa(
            code, pri, num_iterations=25, early_termination=True,
            storage_dtype=storage,
        )
        return (
            np.asarray(res.symbols),
            np.asarray(res.iterations),
            np.asarray(res.satisfied),
        )

    base = run(8, None)
    butterfly = run(0, None)
    f16 = run(8, jnp.float16)
    butterfly_f16 = run(0, jnp.float16)
    nbq.decode_nb_qspa.clear_cache()
    # fused vs butterfly at MATCHED storage: the same algebra with a
    # different operation order — equal except for float near-ties
    # (observed 0 or 1 flipped symbols per ~1e3; a broken sign table
    # would flip decisions wholesale)
    for got, ref, name in [
        (butterfly, base, "butterfly/f32 vs fused/f32"),
        (butterfly_f16, f16, "butterfly/f16 vs fused/f16"),
    ]:
        mism = (got[0] != ref[0]).mean()
        assert mism < 0.005, f"{name}: {mism:.2%} symbols differ"
        assert abs(got[1].mean() - ref[1].mean()) < 0.5, name
        assert (got[2] == ref[2]).mean() > 0.99, name
    # f16 storage vs f32: decisions may flip on near-ties only — the
    # measured contract is SER-equivalence, not bit equality
    sym_delta = (f16[0] != base[0]).mean()
    assert sym_delta < 0.01, f"f16 changed {sym_delta:.2%} of symbols"
    assert abs((f16[0] != 0).mean() - (base[0] != 0).mean()) < 0.01
    # the batch is genuinely noisy: some frames need several iterations
    assert base[1].max() >= 3


def test_flat_gather_layout_identical():
    """The flattened [slots*q, B] gather layout is a pure relayout of
    the row gather — v2c/c2v planes and decisions must be IDENTICAL
    (VERDICT r4 item 1 layout candidate; the chip measurement picks the
    default)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ldpcsimulation_tpu.codes import build_code
    from ldpcsimulation_tpu.codes.construct import nb_regular
    from ldpcsimulation_tpu.channel.nb import symbol_priors
    from ldpcsimulation_tpu.decoders.nb_qspa import nb_qspa_machine

    for q in (4, 8):
        code = build_code(nb_regular(48, 24, 3, q=q, seed=5))
        m_bits = q.bit_length() - 1
        y = 1.0 + 0.8 * jax.random.normal(
            jax.random.key(3), (16, code.n, m_bits), jnp.float32
        )
        pri = jnp.moveaxis(symbol_priors(y, 1.2, q), 0, -1)
        outs = []
        for flat in (False, True):
            M = nb_qspa_machine(code, q, jnp.float32, jnp.float16,
                                flat_gather=flat)
            log_pri = M["log_of"](pri)
            v2c = M["init"](log_pri)
            for _ in range(3):
                c2v = M["cn_update"](v2c)
                v2c, post = M["vn_update"](c2v, log_pri)
            outs.append((np.asarray(v2c), np.asarray(post),
                         np.asarray(M["decide"](post))))
        for a, b in zip(outs[0], outs[1]):
            np.testing.assert_array_equal(a, b)
