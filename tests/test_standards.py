"""Real standard tables (codes/standards.py): provenance verification.

Checks that the shipped 802.11n z=27 shift table and DVB-S2 rate-1/2
address table regenerate the reference's own matrices exactly (the 802.11n
files are truncated — the intact check-side lists fully determine H; see
standards.py docstring).
"""

import numpy as np
import pytest

from ldpcsimulation_tpu.codes import build_code, load_alist
from ldpcsimulation_tpu.codes.library import load_named_code, load_named_qc
from ldpcsimulation_tpu.codes.standards import (
    DVBS2_RATE12_ADDRESSES,
    WIFI_648_RATE12_Z27,
    dvbs2_rate12_alist,
    wifi_648_rate12,
    wifi_648_rate12_qc,
)
from tests.conftest import reference_path, require_reference


def _parse_ref_80211n(path):
    """Reconstruct H from the truncated reference alist's complete
    check-side lists; return (H, intact variable lists)."""
    toks = open(path).read().split()
    it = iter(toks)
    a, b = int(next(it)), int(next(it))  # stored transposed: 324 648
    next(it), next(it)
    awts = [int(next(it)) for _ in range(a)]
    bwts = [int(next(it)) for _ in range(b)]
    h = np.zeros((a, b), np.uint8)
    for i in range(a):
        for _ in range(awts[i]):
            h[i, int(next(it)) - 1] = 1
    rem = [int(t) for t in it]
    var_lists = []
    idx = 0
    for j in range(b):
        if idx + bwts[j] > len(rem):
            break
        var_lists.append(sorted(r - 1 for r in rem[idx : idx + bwts[j]]))
        idx += bwts[j]
    return h, var_lists


def test_wifi_648_table_matches_reference_file():
    p = require_reference("C_implementations/codes/802.11n/802.11n.alist")
    h_ref, var_lists = _parse_ref_80211n(p)
    code = wifi_648_rate12()
    assert code.n == 648 and code.m == 324
    h = np.zeros((code.m, code.n), np.uint8)
    cn_vn = np.asarray(code.cn_vn)
    cn_mask = np.asarray(code.cn_mask)
    for r in range(code.m):
        h[r, cn_vn[r][cn_mask[r]]] = 1
    np.testing.assert_array_equal(h, h_ref)
    # cross-check the intact variable-side lists too (636 of 648)
    assert len(var_lists) >= 630
    for j, lst in enumerate(var_lists):
        assert lst == sorted(np.flatnonzero(h_ref[:, j])), j


def test_wifi_648_structure():
    qc = wifi_648_rate12_qc()
    assert qc.z == 27 and qc.mb == 12 and qc.nb == 24
    base = np.array(WIFI_648_RATE12_Z27)
    # dual-diagonal accumulator on columns 13..23 (shift-0 pairs)
    for i in range(11):
        assert base[i, 13 + i] == 0 and base[i + 1, 13 + i] == 0
    # weight-3 encoding column 12
    col12 = base[:, 12]
    assert (col12 >= 0).sum() == 3


def test_dvbs2_table_matches_reference_file():
    p = require_reference("C_implementations/codes/dvbs2_1_2/dvbs2_1_2.alist")
    ref = load_alist(p)
    ours = dvbs2_rate12_alist()
    assert (ours.n, ours.m) == (ref.n, ref.m) == (64800, 32400)
    assert ours.mlist == ref.mlist
    assert ours.nlist == ref.nlist


def test_dvbs2_table_shape():
    assert len(DVBS2_RATE12_ADDRESSES) == 90
    weights = [len(r) for r in DVBS2_RATE12_ADDRESSES]
    assert weights[:36] == [8] * 36 and weights[36:] == [3] * 54


def test_named_codes_registered():
    qc = load_named_qc("wifi_648_324")
    assert qc.n == 648
    code = load_named_code("wifi_648_324")
    assert code.n == 648 and code.m == 324
    hr = load_named_code("highrate_4376_282")
    assert hr.n == 4376 and hr.m == 282
    assert abs(hr.rate - 0.9356) < 2e-3


def test_wifi_648_decodes():
    """The real 802.11n code decodes all-zero + noise with QC min-sum."""
    import jax
    import jax.numpy as jnp

    from ldpcsimulation_tpu.decoders.minsum_qc import decode_minsum_qc

    qc = wifi_648_rate12_qc()
    key = jax.random.key(0)
    y = 1.0 + 0.55 * jax.random.normal(key, (64, qc.n), jnp.float32)
    res = decode_minsum_qc(qc, y, 20, early_termination=True)
    hard = np.asarray(res.hard)
    assert (hard == 1).mean() > 0.995  # nearly all frames fully corrected


def test_dvbs2_qc_structure_edge_exact():
    """The generalized z=360 QC form of the real DVB-S2 code expands to
    exactly H[row_perm][:, col_perm] (multi-edge blocks + corner defect)."""
    from ldpcsimulation_tpu.codes.standards import dvbs2_rate12_qc

    det = dvbs2_rate12_qc()
    qc = det.qc
    assert qc.z == 360 and qc.mb == 90 and qc.nb == 180
    assert len(qc.extra_edges) == 8
    assert qc.minus_edges == ((0, 179, 359, 0),)
    exp = qc.to_alist()
    ref = dvbs2_rate12_alist()
    back = {
        (int(det.row_perm[r]), int(det.col_perm[c]))
        for r, lst in enumerate(exp.mlist)
        for c in lst
    }
    orig = {(r, c) for r, lst in enumerate(ref.mlist) for c in lst}
    assert back == orig


def test_dvbs2_qc_ops_bit_exact():
    """Roll-based syndrome ops on the generalized DVB-S2 QC structure
    match the generic gather ops on the same (permuted) H exactly."""
    import jax.numpy as jnp

    from ldpcsimulation_tpu.codes.standards import dvbs2_rate12_qc
    from ldpcsimulation_tpu.decoders.base import syndrome_from_hard
    from ldpcsimulation_tpu.decoders.gdbf import _syndrome_sum_per_vn
    from ldpcsimulation_tpu.decoders.qc_ops import (
        qc_syndrome_bipolar,
        qc_syndrome_sum_per_vn,
    )

    det = dvbs2_rate12_qc()
    qc = det.qc
    code = build_code(qc.to_alist())
    rng = np.random.default_rng(5)
    d = jnp.asarray(rng.choice([-1, 1], size=(code.n, 4)), jnp.int32)
    syn_qc = np.asarray(qc_syndrome_bipolar(qc, d))
    syn_gen = np.asarray(syndrome_from_hard(code, d))
    np.testing.assert_array_equal(syn_qc, syn_gen)
    ss_qc = np.asarray(qc_syndrome_sum_per_vn(qc, jnp.asarray(syn_gen)))
    ss_gen = np.asarray(_syndrome_sum_per_vn(code, jnp.asarray(syn_gen)))
    np.testing.assert_array_equal(ss_qc, ss_gen)


def test_generalized_qc_message_decoders_bit_exact():
    """Multi-edge pairs + a minus edge through the message-passing QC
    decoders: bit-exact vs the generic slot-array decoders on the same
    expanded H (per-row swap masks preserve the generic scan/fold order;
    absent edges read the +inf neutral)."""
    import jax.numpy as jnp

    from ldpcsimulation_tpu.codes.qc import build_qc_code_edges
    from ldpcsimulation_tpu.decoders.bp import decode_bp
    from ldpcsimulation_tpu.decoders.bp_qc import decode_bp_qc
    from ldpcsimulation_tpu.decoders.minsum import decode_minsum
    from ldpcsimulation_tpu.decoders.minsum_qc import decode_minsum_qc

    z = 5
    edges = [(0, 0, 1), (0, 0, 3), (0, 1, 0), (0, 2, 2),
             (1, 0, 2), (1, 1, 2), (1, 2, 4)]
    qc = build_qc_code_edges(edges, z, 2, 3, minus_edges=((1, 2, 4, 1),))
    assert qc.extra_edges and qc.minus_edges
    code = build_code(qc.to_alist())
    rng = np.random.default_rng(0)
    y = jnp.asarray(rng.normal(size=(64, qc.n)).astype(np.float32))

    for T in (1, 3, 7):
        a = decode_minsum_qc(qc, y, T, early_termination=True)
        b = decode_minsum(code, y, T, early_termination=True)
        np.testing.assert_array_equal(np.asarray(a.hard), np.asarray(b.hard))
        np.testing.assert_array_equal(
            np.asarray(a.iterations), np.asarray(b.iterations)
        )
        a = decode_bp_qc(qc, y, T)
        b = decode_bp(code, y, T)
        np.testing.assert_array_equal(np.asarray(a.hard), np.asarray(b.hard))
    for var, kw in (
        ("normalized", dict(alpha=1.25)),
        ("offset", dict(delta=0.15)),
    ):
        a = decode_minsum_qc(qc, y, 4, variant=var, **kw)
        b = decode_minsum(code, y, 4, variant=var, **kw)
        np.testing.assert_array_equal(np.asarray(a.hard), np.asarray(b.hard))


def test_dvbs2_message_qc_bit_exact_spot():
    """The REAL DVB-S2 structure through decode_minsum_qc matches the
    generic decoder bit-exactly (tiny batch/T: the full structure compiles
    slowly on CPU)."""
    import jax.numpy as jnp

    from ldpcsimulation_tpu.codes.standards import dvbs2_rate12_qc
    from ldpcsimulation_tpu.decoders.minsum import decode_minsum
    from ldpcsimulation_tpu.decoders.minsum_qc import decode_minsum_qc

    qc = dvbs2_rate12_qc().qc
    code = build_code(qc.to_alist())
    rng = np.random.default_rng(1)
    y = jnp.asarray(
        rng.normal(loc=1.0, scale=0.8, size=(2, qc.n)).astype(np.float32)
    )
    a = decode_minsum_qc(qc, y, 2)
    b = decode_minsum(code, y, 2)
    np.testing.assert_array_equal(np.asarray(a.hard), np.asarray(b.hard))


def test_generalized_qc_random_structures_bit_exact():
    """Property test: random generalized QC structures (random shifts incl.
    0, random multi-edge pairs, random minus edges incl. row 0 and z-1)
    stay bit-exact with the generic decoders."""
    import jax.numpy as jnp

    from ldpcsimulation_tpu.codes.qc import build_qc_code_edges
    from ldpcsimulation_tpu.decoders.bp import decode_bp
    from ldpcsimulation_tpu.decoders.bp_qc import decode_bp_qc
    from ldpcsimulation_tpu.decoders.minsum import decode_minsum
    from ldpcsimulation_tpu.decoders.minsum_qc import decode_minsum_qc

    rng = np.random.default_rng(2024)
    for trial in range(6):
        z = int(rng.integers(3, 9))
        mb, nb = 3, 5
        edges = []
        used = set()
        # base single edges: every CN/VN block touched at least twice
        for bi in range(mb):
            cols = rng.choice(nb, size=3, replace=False)
            for bj in cols:
                s = int(rng.integers(0, z))
                if (bi, int(bj), s) not in used:
                    used.add((bi, int(bj), s))
                    edges.append((bi, int(bj), s))
        # ensure every VN block has degree >= 1
        touched = {bj for _, bj, _ in edges}
        for bj in range(nb):
            if bj not in touched:
                s = int(rng.integers(0, z))
                edges.append((0, bj, s))
                used.add((0, bj, s))
        # add 1-2 multi-edge pairs (second shift distinct; never a triple)
        for _ in range(int(rng.integers(1, 3))):
            bi, bj, s = edges[int(rng.integers(0, len(edges)))]
            if sum(1 for (a, b2, _) in edges if (a, b2) == (bi, bj)) != 1:
                continue
            s2 = int((s + rng.integers(1, z)) % z)
            if (bi, bj, s2) not in used:
                used.add((bi, bj, s2))
                edges.append((bi, bj, s2))
        # a minus edge on a NON-pair circulant at an extreme row
        minus = ()
        singles = [
            (bi, bj, s) for (bi, bj, s) in edges
            if sum(1 for (a, b2, _) in edges if (a, b2) == (bi, bj)) == 1
        ]
        if singles:
            bi, bj, s = singles[int(rng.integers(0, len(singles)))]
            r = int(rng.choice([0, z - 1, int(rng.integers(0, z))]))
            minus = ((bi, bj, s, r),)
        qc = build_qc_code_edges(edges, z, mb, nb, minus_edges=minus)
        code = build_code(qc.to_alist())
        y = jnp.asarray(
            rng.normal(0.3, 1.0, size=(32, qc.n)).astype(np.float32)
        )
        a = decode_minsum_qc(qc, y, 5, early_termination=True)
        b = decode_minsum(code, y, 5, early_termination=True)
        np.testing.assert_array_equal(
            np.asarray(a.hard), np.asarray(b.hard),
            err_msg=f"trial {trial} minsum z={z} minus={minus}",
        )
        np.testing.assert_array_equal(
            np.asarray(a.iterations), np.asarray(b.iterations)
        )
        a = decode_bp_qc(qc, y, 4)
        b = decode_bp(code, y, 4)
        np.testing.assert_array_equal(
            np.asarray(a.hard), np.asarray(b.hard),
            err_msg=f"trial {trial} bp z={z} minus={minus}",
        )


def test_dvbs2_encoder_satisfies_all_checks():
    """The O(E) IRA encoder (standards.dvbs2_rate12_encode) produces words
    in the null space of the REAL rate-1/2 H: every one of the 32400
    parity checks is satisfied for random information words, and the
    encoding is systematic (info bits pass through untouched)."""
    import numpy as np

    from ldpcsimulation_tpu.codes.standards import (
        dvbs2_rate12_alist,
        dvbs2_rate12_encode,
    )

    rng = np.random.default_rng(3)
    info = rng.integers(0, 2, (2, 32400), dtype=np.uint8)
    cw = dvbs2_rate12_encode(info)
    assert cw.shape == (2, 64800)
    np.testing.assert_array_equal(cw[:, :32400], info)
    al = dvbs2_rate12_alist()
    # vectorized syndrome over all rows (mlist is ragged; flatten once)
    rows = np.concatenate(
        [np.full(len(cs), r) for r, cs in enumerate(al.mlist)]
    )
    cols = np.concatenate([np.asarray(cs) for cs in al.mlist])
    syn = np.zeros((al.m, 2), np.uint8)
    np.bitwise_xor.at(syn, rows, cw.T[cols])
    assert not syn.any()
    # different info -> different parity (the accumulator is injective)
    cw2 = dvbs2_rate12_encode(1 - info)
    assert (cw2[:, 32400:] != cw[:, 32400:]).any()


def test_wifi_1944_structure_and_invariants():
    """The z=81 table has no reference file to diff against (the repo
    ships none); every structural invariant the standard imposes is
    asserted instead — see codes/standards.py module docstring."""
    from ldpcsimulation_tpu.codes.standards import (
        WIFI_1944_RATE12_Z81,
        wifi_1944_rate12,
        wifi_1944_rate12_qc,
    )

    base = np.array(WIFI_1944_RATE12_Z81)
    assert base.shape == (12, 24)
    assert base.max() < 81 and base.min() == -1
    # dual-diagonal accumulator on columns 13..23 (shift-0 pairs)
    for i in range(11):
        assert base[i, 13 + i] == 0 and base[i + 1, 13 + i] == 0
        assert (base[:, 13 + i] >= 0).sum() == 2
    assert (base[:, 23] >= 0).sum() == 2
    # weight-3 encoding column 12: equal first/last shifts, 0 mid-entry
    # (same invariant as the verified z=27 table's 26/0/26)
    rows12 = np.flatnonzero(base[:, 12] >= 0)
    assert len(rows12) == 3
    assert base[rows12[0], 12] == base[rows12[2], 12] != 0
    assert base[rows12[1], 12] == 0
    qc = wifi_1944_rate12_qc()
    assert qc.z == 81 and qc.mb == 12 and qc.nb == 24
    code = wifi_1944_rate12()
    assert code.n == 1944 and code.m == 972

    # expanded H: full GF(2) rank and girth 6 (no 4-cycles)
    from ldpcsimulation_tpu.codes.encode import gf2_rref

    h = np.zeros((code.m, code.n), np.uint8)
    cn_vn = np.asarray(code.cn_vn)
    cn_mask = np.asarray(code.cn_mask)
    for r in range(code.m):
        h[r, cn_vn[r][cn_mask[r]]] = 1
    # column/row degree profile of the base table (sanity-pins the table)
    info_w = sorted((base[:, :12] >= 0).sum(axis=0).tolist())
    assert info_w == [3] * 7 + [4] * 2 + [11] * 3
    # 87 edges total: info 62 + weight-3 col 3 + accumulator 22
    assert sorted((base >= 0).sum(axis=1).tolist()) == [7] * 9 + [8] * 3
    assert (base >= 0).sum() == 87
    overlaps = h.astype(np.int32) @ h.T.astype(np.int32)
    np.fill_diagonal(overlaps, 0)
    assert overlaps.max() <= 1, "4-cycle found"
    _rref, pivots, _perm = gf2_rref(h)
    assert len(pivots) == 972, f"rank {len(pivots)} != 972"


@pytest.mark.parametrize("which", ["z27", "z81"])
def test_wifi_dual_diagonal_encoder(which):
    """wifi_encode produces valid codewords (H·c = 0) on both standard
    tables — on z=27 this cross-validates the encoding recipe against the
    reference-verified H, which then vouches for the z=81 path."""
    from ldpcsimulation_tpu.codes.standards import (
        WIFI_648_RATE12_Z27,
        WIFI_1944_RATE12_Z81,
        wifi_648_rate12,
        wifi_1944_rate12,
        wifi_encode,
    )

    if which == "z27":
        base, z, code = WIFI_648_RATE12_Z27, 27, wifi_648_rate12()
    else:
        base, z, code = WIFI_1944_RATE12_Z81, 81, wifi_1944_rate12()
    rng = np.random.default_rng(5)
    info = rng.integers(0, 2, size=(4, 12 * z), dtype=np.uint8)
    cw = wifi_encode(base, z, info)
    assert cw.shape == (4, 24 * z)
    np.testing.assert_array_equal(cw[:, : 12 * z], info)
    h = np.zeros((code.m, code.n), np.uint8)
    cn_vn = np.asarray(code.cn_vn)
    cn_mask = np.asarray(code.cn_mask)
    for r in range(code.m):
        h[r, cn_vn[r][cn_mask[r]]] = 1
    syn = (h @ cw.T) % 2
    assert not syn.any(), "encoder output violates H"


def test_wifi_1944_qc_bitexact_vs_generic():
    """QC roll decoder == generic slot-array decoder on the real z=81 H
    (full decode outputs)."""
    import jax
    import jax.numpy as jnp

    from ldpcsimulation_tpu.channel import awgn, snr_to_sigma
    from ldpcsimulation_tpu.codes.standards import (
        wifi_1944_rate12,
        wifi_1944_rate12_qc,
    )
    from ldpcsimulation_tpu.decoders.minsum import decode_minsum
    from ldpcsimulation_tpu.decoders.minsum_qc import decode_minsum_qc

    qc = wifi_1944_rate12_qc()
    code = wifi_1944_rate12()
    sigma = float(snr_to_sigma(1.8, 0.5))
    y = awgn(jax.random.key(2), jnp.ones((8, code.n)), sigma)
    a = decode_minsum_qc(qc, y, 6, early_termination=True)
    b = decode_minsum(code, y, 6, early_termination=True)
    np.testing.assert_array_equal(np.asarray(a.hard), np.asarray(b.hard))
    np.testing.assert_array_equal(
        np.asarray(a.iterations), np.asarray(b.iterations)
    )
    np.testing.assert_array_equal(
        np.asarray(a.satisfied), np.asarray(b.satisfied)
    )
