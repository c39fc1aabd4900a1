"""Stratified block-permutation structure + one-hot matmul min-sum decoder.

Validates the structure invariants (strata, independent-set groups, H
round-trip) and bit-exact equivalence with the generic slot-array decoder
on the reference's real 802.3an ``802_3_H.alist`` — the code class this
path exists for (SURVEY §2.5; VERDICT round-1 item 2: exact-H perf gap).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpcsimulation_tpu.codes import build_code, load_alist
from ldpcsimulation_tpu.codes.construct import peg
from ldpcsimulation_tpu.codes.stratified import (
    StratifiedCode,
    detect_stratified,
    stratify,
)
from ldpcsimulation_tpu.decoders.minsum import decode_minsum
from ldpcsimulation_tpu.decoders.minsum_stratified import (
    decode_minsum_stratified,
    stratified_check_satisfied,
    stratified_to_cn,
    stratified_to_vn,
)

from .conftest import require_reference


@pytest.fixture(scope="module")
def ref_802_3():
    p = require_reference("C_implementations/codes/802_3/802_3_H.alist")
    alist = load_alist(p)
    return alist, build_code(alist), detect_stratified(alist)


def test_detects_802_3_structure(ref_802_3):
    alist, _code, sc = ref_802_3
    assert sc is not None
    # contiguous 64-row strata, one edge per column per stratum
    assert (sc.mb, sc.h) == (6, 64)
    assert np.asarray(sc.vn_valid).sum() == sc.num_edges == 12288
    assert sc.cost <= 2.0


def test_structure_reconstructs_h(ref_802_3):
    """The one-hot tensors + slot maps are exactly H, edge for edge."""
    alist, _code, sc = ref_802_3
    onehot = np.asarray(sc.onehot)
    col_slot = np.asarray(sc.col_slot)
    row_of = np.asarray(sc.row_of)
    edges = set()
    for b in range(sc.mb):
        for g in range(sc.kg):
            for c in range(sc.w):
                for r in np.nonzero(onehot[b, g, c])[0]:
                    col = col_slot[g, c]
                    row = row_of[b, r]
                    assert col >= 0 and row >= 0
                    edges.add((int(row), int(col)))
    want = {
        (r, c) for r, cols in enumerate(alist.mlist) for c in cols
    }
    assert edges == want
    # each one-hot row has at most one 1 (partial permutation)
    assert (onehot.sum(axis=3) <= 1).all()
    assert (onehot.sum(axis=2) <= 1).all()


def test_transforms_roundtrip(ref_802_3, rng):
    """to_cn followed by to_vn is the identity on valid slots (the block
    maps are partial permutations)."""
    _alist, _code, sc = ref_802_3
    x = jnp.asarray(
        rng.normal(size=(sc.mb, sc.kg, sc.w, 4)).astype(np.float32)
    )
    x = jnp.where(sc.vn_valid[..., None], x, 0.0)
    back = stratified_to_vn(sc, stratified_to_cn(sc, x))
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(),
        dict(variant="normalized", alpha=1.25),
        dict(variant="offset", delta=0.15),
        dict(early_termination=True),
        dict(storage_dtype=jnp.float16),
        dict(early_termination=True, storage_dtype=jnp.float16),
    ],
    ids=["plain", "normalized", "offset", "et", "f16", "et_f16"],
)
def test_bitexact_vs_generic_802_3(ref_802_3, rng, kwargs):
    """Same decisions and iteration counts as the generic decoder on the
    real 802.3an H — one-hot einsum interleaving is exact."""
    _alist, code, sc = ref_802_3
    y = (1.0 + 0.55 * rng.standard_normal((16, code.n))).astype(np.float32)
    r_gen = decode_minsum(code, y, 6, **kwargs)
    r_str = decode_minsum_stratified(sc, y, 6, **kwargs)
    np.testing.assert_array_equal(
        np.asarray(r_gen.hard), np.asarray(r_str.hard)
    )
    np.testing.assert_array_equal(
        np.asarray(r_gen.iterations), np.asarray(r_str.iterations)
    )
    np.testing.assert_array_equal(
        np.asarray(r_gen.satisfied), np.asarray(r_str.satisfied)
    )


def test_f16_deep_run_no_overflow_garbage(ref_802_3):
    """Regression: dv=6 min-sum messages grow ~x7/iteration, overflowing
    f16 by T=10.  Un-saturated stores turned inf into 0*inf=NaN inside the
    one-hot einsum and sign-inverted WHOLE frames (BER 0.11 vs 2e-4).
    With saturating storage_cast the stratified and generic f16
    paths stay bit-identical and frame-inversion-free at the deep
    operating point that originally triggered it."""
    _alist, code, sc = ref_802_3
    rng = np.random.default_rng(3)
    y = (1.0 + 0.4755 * rng.standard_normal((256, code.n))).astype(
        np.float32
    )
    r_gen = decode_minsum(code, y, 10, storage_dtype=jnp.float16)
    r_str = decode_minsum_stratified(sc, y, 10, storage_dtype=jnp.float16)
    hg, hs = np.asarray(r_gen.hard), np.asarray(r_str.hard)
    np.testing.assert_array_equal(hg, hs)
    # no garbage frames: f16 bit errors must be commensurate with f32
    r32 = decode_minsum(code, y, 10)
    err32 = (np.asarray(r32.hard) < 0).sum()
    err16 = (hs < 0).sum()
    assert err16 <= max(4 * err32, err32 + 64), (err16, err32)


def test_f16_channel_input_bit_exact_vs_generic(ref_802_3):
    """f16 CHANNEL inputs (storage None): the VN fold must run in the
    channel dtype exactly like the generic decoder (the round-4 step
    factoring briefly forced f32 — review regression guard)."""
    _alist, code, sc = ref_802_3
    rng = np.random.default_rng(5)
    y16 = (1.0 + 0.4755 * rng.standard_normal((128, code.n))).astype(
        np.float16
    )
    r_gen = decode_minsum(code, jnp.asarray(y16), 8)
    r_str = decode_minsum_stratified(sc, jnp.asarray(y16), 8)
    np.testing.assert_array_equal(
        np.asarray(r_gen.hard), np.asarray(r_str.hard)
    )
    np.testing.assert_array_equal(
        np.asarray(r_gen.iterations), np.asarray(r_str.iterations)
    )


def test_check_satisfied_matches_generic(ref_802_3, rng):
    from ldpcsimulation_tpu.decoders.base import check_satisfied

    _alist, code, sc = ref_802_3
    d_t = jnp.asarray(
        rng.choice([-1, 1], size=(code.n, 8)).astype(np.int32)
    )
    want = np.asarray(check_satisfied(code, d_t))
    safe = jnp.maximum(sc.col_slot, 0)
    d_grid = jnp.take(d_t, safe.reshape(-1), axis=0).reshape(
        sc.kg, sc.w, 8
    )
    got = np.asarray(stratified_check_satisfied(sc, d_grid))
    np.testing.assert_array_equal(got, want)
    # and a valid codeword (all-ones BPSK of the zero codeword) passes
    ones = jnp.ones((sc.kg, sc.w, 3), jnp.int32)
    assert np.asarray(stratified_check_satisfied(sc, ones)).all()


def test_last_min_tiebreak_matches_scan(ref_802_3):
    """Duplicate minima: the order-independent CN formulation must give
    min2 to the LAST minimum in alist order, like the reference scan."""
    _alist, code, sc = ref_802_3
    # integer-valued samples make exact duplicates likely
    rng = np.random.default_rng(7)
    y = rng.integers(-3, 4, size=(32, code.n)).astype(np.float32)
    y = np.where(y == 0, 1.0, y)  # keep sgn well-exercised but nonzero
    r_gen = decode_minsum(code, y, 4)
    r_str = decode_minsum_stratified(sc, y, 4)
    np.testing.assert_array_equal(
        np.asarray(r_gen.hard), np.asarray(r_str.hard)
    )


def test_stratify_rejects_bad_partitions(ref_802_3):
    alist, _code, _sc = ref_802_3
    # two conflicting columns forced into one group
    groups = [list(range(64 * g, 64 * (g + 1))) for g in range(32)]
    # columns 0 and its first row-neighbor share a row; put them together
    c0 = 0
    partner = next(c for c in alist.mlist[alist.nlist[0][0]] if c != c0)
    if partner not in groups[0]:
        groups[0][1], groups[partner // 64][partner % 64] = (
            partner,
            groups[0][1],
        )
    with pytest.raises(ValueError):
        stratify(alist, col_groups=groups)


def test_detect_rejects_random_codes():
    """PEG random codes have sparse strata — not worth the layout; they
    stay on the generic gather path."""
    alist = peg(120, 60, 3, seed=5)
    assert detect_stratified(alist) is None


def test_pytree_roundtrip(ref_802_3):
    _alist, _code, sc = ref_802_3
    leaves, treedef = jax.tree.flatten(sc)
    sc2 = jax.tree.unflatten(treedef, leaves)
    assert isinstance(sc2, StratifiedCode)
    assert (sc2.mb, sc2.h, sc2.kg, sc2.w) == (sc.mb, sc.h, sc.kg, sc.w)


def test_detect_rejects_oversized_without_allocation():
    """detect_stratified must reject a high-cost structure BEFORE
    materializing the one-hot tensor (the real DVB-S2 H would otherwise
    attempt a ~10.9 GiB allocation; here a synthetic high-cost code
    exercises the same pre-allocation gate)."""
    import resource

    from ldpcsimulation_tpu.codes import peg
    from ldpcsimulation_tpu.codes.stratified import detect_stratified

    # a random regular code stratifies with high cost (sparse strata)
    alist = peg(512, 256, 3, seed=7)
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    sc = detect_stratified(alist, max_cost=0.01)  # force rejection
    after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    assert sc is None
    # peak RSS must not have grown by a one-hot-tensor-sized amount
    assert after - before < 512 * 1024  # KiB on Linux => <512 MiB growth


# --------------------------------------------------------- universal fallback


def synthetic_irregular_stratified(
    n=512, h=64, mb=4, p_edge=0.9, seed=9
):
    """Synthetic IRREGULAR non-QC alist with dense row strata: each
    stratum assigns a shuffled round-robin of the columns to its rows,
    with each (column, stratum) edge kept with probability p_edge — dv is
    irregular (binomial), rows keep degree >= 2 (no degenerate
    inf-extrinsic checks), and no circulant structure exists, so greedy/
    contiguous strata detection is exercised."""
    from ldpcsimulation_tpu.codes.alist import Alist

    rng = np.random.default_rng(seed)
    m = h * mb
    nlist = [[] for _ in range(n)]
    mlist = [[] for _ in range(m)]
    for b in range(mb):
        perm = rng.permutation(n)
        for i, c in enumerate(perm):
            last_chance = not nlist[c] and b == mb - 1
            if rng.random() < p_edge or last_chance:
                r = b * h + (i % h)
                nlist[c].append(r)
                mlist[r].append(c)
    for c in range(n):
        nlist[c].sort()
    for r in range(m):
        mlist[r].sort()
        assert len(mlist[r]) >= 2, "degenerate row"
    return Alist(n=n, m=m, nlist=nlist, mlist=mlist)


@pytest.fixture(scope="module")
def irregular_sc():
    alist = synthetic_irregular_stratified()
    sc = detect_stratified(alist)
    return alist, build_code(alist), sc


def test_detect_irregular_fallback(irregular_sc):
    """An unstructured irregular alist (non-QC) routes stratified: the
    universal fallback (VERDICT r3 item 4)."""
    alist, _code, sc = irregular_sc
    assert sc is not None
    assert sc.cost <= 2.0
    # genuinely irregular
    assert len(set(alist.dv)) > 1
    # not QC
    from ldpcsimulation_tpu.codes.qc_detect import detect_qc

    assert detect_qc(alist) is None


def test_minsum_bitexact_on_irregular(irregular_sc, rng):
    alist, code, sc = irregular_sc
    y = rng.normal(0.3, 1.0, size=(16, code.n)).astype(np.float32)
    a = decode_minsum_stratified(sc, jnp.asarray(y), 8,
                                 early_termination=True)
    b = decode_minsum(code, jnp.asarray(y), 8, early_termination=True)
    np.testing.assert_array_equal(np.asarray(a.hard), np.asarray(b.hard))
    np.testing.assert_array_equal(
        np.asarray(a.iterations), np.asarray(b.iterations)
    )


def test_ddbmp_stratified_bitexact(irregular_sc, ref_802_3, rng):
    """DD-BMP stratified == generic, bit-exact (±1 messages + exact f32
    accumulator sums — order-free), on the irregular fallback code AND
    the real 802.3an H."""
    from ldpcsimulation_tpu.channel.quantize import quantize_no_zero
    from ldpcsimulation_tpu.decoders.ddbmp import (
        decode_ddbmp,
        decode_ddbmp_stratified,
    )

    for alist, code, sc in (irregular_sc, ref_802_3):
        y = 1.0 + 0.5 * rng.normal(size=(8, code.n))
        yq = quantize_no_zero(jnp.asarray(y, jnp.float32), 1.5, 8.0)
        a = decode_ddbmp_stratified(sc, yq, 12)
        b = decode_ddbmp(code, yq, 12)
        np.testing.assert_array_equal(
            np.asarray(a.hard), np.asarray(b.hard)
        )
        np.testing.assert_array_equal(
            np.asarray(a.iterations), np.asarray(b.iterations)
        )
        np.testing.assert_array_equal(
            np.asarray(a.satisfied), np.asarray(b.satisfied)
        )


def test_bp_stratified_statistical(irregular_sc, rng):
    """BP stratified vs generic: same algorithm reassociated (CN fold in
    group order) — decisions agree except on ulp-level near-ties."""
    from ldpcsimulation_tpu.channel.awgn import llr_from_channel, snr_to_n0
    from ldpcsimulation_tpu.decoders.bp import decode_bp
    from ldpcsimulation_tpu.decoders.bp_stratified import (
        decode_bp_stratified,
    )

    alist, code, sc = irregular_sc
    n0 = float(snr_to_n0(3.0, code.rate))
    y = 1.0 + np.sqrt(n0 / 2) * rng.normal(size=(32, code.n))
    llr = llr_from_channel(jnp.asarray(y, jnp.float32), n0)
    a = decode_bp_stratified(sc, llr, 10, early_termination=True)
    b = decode_bp(code, llr, 10, early_termination=True)
    agree = (np.asarray(a.hard) == np.asarray(b.hard)).mean()
    assert agree > 0.999, agree
    # satisfied frames decode to codewords in both
    frame_agree = (
        np.asarray(a.hard) == np.asarray(b.hard)
    ).all(axis=1).mean()
    assert frame_agree > 0.9
    assert abs(
        np.asarray(a.iterations).mean() - np.asarray(b.iterations).mean()
    ) < 1.0


def test_sweep_routes_stratified_for_bp_and_ddbmp(tmp_path, capsys):
    """CLI routing: an unstructured alist that fails QC detection lands on
    the stratified decoders for bp and ddbmp too."""
    from ldpcsimulation_tpu.codes.alist import save_alist
    from ldpcsimulation_tpu.tools import sweep as sweep_mod

    alist = synthetic_irregular_stratified()
    path = str(tmp_path / "irr.alist")
    save_alist(alist, path)
    for dec in ("bp", "ddbmp"):
        log = str(tmp_path / f"{dec}.log")
        sweep_mod.main([
            dec, "--alist", path, "--snr", "4.0", "-T", "5",
            "--log", log, "--batch", "64", "--max-frames", "64",
            "--min-errors", "0", "--min-word-errors", "0",
        ])
        err = capsys.readouterr().err
        assert "stratified structure" in err, (dec, err)
        assert open(log).read().strip()
