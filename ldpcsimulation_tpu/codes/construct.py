"""Native LDPC code constructions.

The reference ships its parity-check matrices as data files (PEG-constructed
MacKay-format alists under ``C_implementations/codes/``).  This framework can
*load* any such alist (:mod:`.alist`) but is also self-contained: it can
construct equivalent codes from scratch, so no external fixture is required
for tests or benchmarks.

Constructions provided:
  * :func:`peg` — Progressive Edge Growth (Hu, Eleftheriou, Arnold 2005):
    greedy girth-maximizing placement; this is the same family of construction
    that produced the reference's ``PEGReg504x1008`` code.
  * :func:`random_regular` — random (dv, dc)-regular ensemble (Gallager-style
    edge interleaver), cheap for very large N.
  * :func:`qc_expand` — quasi-cyclic expansion of a base/prototype matrix of
    circulant shifts (IEEE 802.11n/802.3an-style codes).
  * :func:`rs_ldpc` — the Reed-Solomon-based construction behind 802.3an
    (Djurdjevic et al.): contiguous row strata of permutation blocks.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .alist import Alist
from .code import Code, build_code

__all__ = [
    "peg",
    "random_regular",
    "qc_expand",
    "rs_ldpc",
    "make_regular_code",
    "nb_regular",
]


def peg(
    n: int,
    m: int,
    dv: int | Sequence[int],
    seed: int = 0,
    backend: str = "auto",
) -> Alist:
    """Progressive-Edge-Growth construction of an (n, m) binary LDPC code.

    For each variable node (in order) and each of its ``dv`` edges: the first
    edge goes to a minimum-degree check; subsequent edges BFS the current
    subgraph from the variable and connect to a check at maximum distance
    (preferring unreachable checks), breaking ties by minimum current check
    degree, then by seeded random choice.

    Deterministic given (n, m, dv, seed, backend).  Returns an
    :class:`Alist` whose per-node adjacency is ascending within each column.

    backend: "python" | "native" | "auto" — "native" uses the C++ tier
    (ldpcsimulation_tpu.native, ~25x faster, independent RNG stream);
    "auto" picks native for n > 2000 when the library is buildable.
    """
    if isinstance(dv, int) and backend in ("native", "auto"):
        from .. import native as _native

        if backend == "native" or (n > 2000 and _native.available()):
            return _native.peg_native(n, m, dv, seed=seed)
    rng = np.random.default_rng(seed)
    dv_list = [dv] * n if isinstance(dv, int) else list(dv)
    if len(dv_list) != n:
        raise ValueError("dv sequence must have length n")

    check_deg = np.zeros(m, dtype=np.int64)
    nlist: List[List[int]] = [[] for _ in range(n)]
    # adjacency for BFS: check -> set of variables, variable -> list of checks
    check_vars: List[List[int]] = [[] for _ in range(m)]

    for v in range(n):
        for e in range(dv_list[v]):
            if e == 0:
                # lowest-degree check, ties broken randomly
                cands = np.flatnonzero(check_deg == check_deg.min())
            else:
                # BFS from v over the bipartite graph built so far
                dist = np.full(m, -1, dtype=np.int64)
                seen_v = np.zeros(n, dtype=bool)
                seen_v[v] = True
                frontier = list(nlist[v])
                depth = 0
                for c in frontier:
                    dist[c] = 0
                while frontier:
                    nxt: List[int] = []
                    for c in frontier:
                        for v2 in check_vars[c]:
                            if not seen_v[v2]:
                                seen_v[v2] = True
                                for c2 in nlist[v2]:
                                    if dist[c2] < 0:
                                        dist[c2] = depth + 1
                                        nxt.append(c2)
                    frontier = nxt
                    depth += 1
                unreached = np.flatnonzero(dist < 0)
                if unreached.size:
                    cands = unreached
                else:
                    far = dist.max()
                    cands = np.flatnonzero(dist == far)
                    # exclude direct neighbors (dist 0) if any alternative
                    cands = cands[dist[cands] > 0] if far > 0 else cands
                # among candidates, minimum degree
                dmin = check_deg[cands].min()
                cands = cands[check_deg[cands] == dmin]
            c = int(rng.choice(cands))
            nlist[v].append(c)
            check_vars[c].append(v)
            check_deg[c] += 1
        nlist[v].sort()

    mlist: List[List[int]] = [[] for _ in range(m)]
    for v in range(n):
        for c in nlist[v]:
            mlist[c].append(v)
    for c in range(m):
        mlist[c].sort()
    return Alist(n=n, m=m, nlist=nlist, mlist=mlist)


def random_regular(n: int, m: int, dv: int, seed: int = 0) -> Alist:
    """Random (dv, dc)-regular ensemble via a shuffled edge interleaver.

    Requires n*dv divisible by m.  Double edges are resolved by local swaps;
    girth is whatever the ensemble gives (fine for throughput benchmarks,
    use :func:`peg` when coding performance matters).
    """
    if (n * dv) % m:
        raise ValueError(f"n*dv={n*dv} not divisible by m={m}")
    dc = n * dv // m
    rng = np.random.default_rng(seed)
    for _attempt in range(50):
        sockets = rng.permutation(np.repeat(np.arange(m), dc))
        cols = np.repeat(np.arange(n), dv)
        # Resolve duplicate (v, c) pairs by reshuffling the clashing sockets.
        ok = True
        for _ in range(200):
            pairs = cols * m + sockets
            order = np.argsort(pairs, kind="stable")
            dup = np.flatnonzero(np.diff(pairs[order]) == 0)
            if dup.size == 0:
                ok = True
                break
            ok = False
            clash = order[dup]
            partners = rng.integers(0, n * dv, size=clash.size)
            # Swap one pair at a time: a vectorized fancy-index swap is NOT a
            # permutation when partners repeat or hit clash itself (numpy
            # last-write-wins drops a socket), which silently breaks check
            # degree regularity.
            for i, j in zip(clash, partners):
                sockets[i], sockets[j] = sockets[j], sockets[i]
        if ok:
            break
    if not ok:
        raise RuntimeError("failed to remove parallel edges")
    nlist: List[List[int]] = [[] for _ in range(n)]
    mlist: List[List[int]] = [[] for _ in range(m)]
    for v, c in zip(cols, sockets):
        nlist[int(v)].append(int(c))
        mlist[int(c)].append(int(v))
    for v in range(n):
        nlist[v].sort()
    for c in range(m):
        mlist[c].sort()
    return Alist(n=n, m=m, nlist=nlist, mlist=mlist)


#: primitive polynomials of GF(2^k); bit i is the coefficient of x^i
_PRIMITIVE_POLY = {2: 0b111, 3: 0b1011, 4: 0b10011, 5: 0b100101,
                   6: 0b1000011, 7: 0b10001001, 8: 0b100011101}


def rs_ldpc(field_bits: int = 6, slopes: int = 32, strata: int = 6) -> Alist:
    """Reed-Solomon-based LDPC code, the construction behind 802.3an
    (Djurdjevic, Xu, Abdel-Ghaffar, Lin 2003).

    Over GF(h), h = 2**field_bits, the column of slope a < ``slopes`` and
    intercept b has its stratum-i edge at row ``i*h + (a*x_i + b)`` with
    x_i = alpha**i.  Each stratum is a contiguous block of h rows holding
    one edge of every column, and two columns share at most one row
    (girth >= 6): dv = ``strata``, dc = ``slopes``.  The defaults give the
    (2048, 384) dv=6 dc=32 layout of the 802.3an H.
    """
    h = 1 << field_bits
    if field_bits not in _PRIMITIVE_POLY or slopes > h or strata >= h:
        raise ValueError(f"need field_bits in {sorted(_PRIMITIVE_POLY)}, "
                         f"slopes <= {h}, strata < {h}")
    exp = np.zeros(h - 1, np.int64)
    log = np.zeros(h, np.int64)
    v = 1
    for i in range(h - 1):
        exp[i], log[v] = v, i
        v <<= 1
        if v & h:
            v ^= _PRIMITIVE_POLY[field_bits]
    n, m = slopes * h, strata * h
    b = np.arange(h)
    nlist: List[List[int]] = [[] for _ in range(n)]
    mlist: List[List[int]] = [[] for _ in range(m)]
    for a in range(slopes):
        for i in range(strata):  # a * alpha**i in GF(h)
            ax = 0 if a == 0 else int(exp[(log[a] + i) % (h - 1)])
            for bb, r in zip(b, i * h + (ax ^ b)):
                nlist[a * h + int(bb)].append(int(r))
                mlist[int(r)].append(a * h + int(bb))
    for r in range(m):
        mlist[r].sort()
    return Alist(n=n, m=m, nlist=nlist, mlist=mlist)


def qc_expand(base: np.ndarray, z: int) -> Alist:
    """Expand a quasi-cyclic prototype matrix into an Alist.

    ``base`` is an integer matrix where entry -1 denotes an all-zero z×z
    block and entry s ≥ 0 denotes the identity cyclically right-shifted by s.
    This is the 802.11n / 802.16e / 5G-NR style description; the real
    802.11n rate-1/2 z=27 table (recovered from the reference's truncated
    alist) is provided in :mod:`.standards`, alongside the DVB-S2 rate-1/2
    address table.
    """
    mb, nb = base.shape
    n, m = nb * z, mb * z
    nlist: List[List[int]] = [[] for _ in range(n)]
    mlist: List[List[int]] = [[] for _ in range(m)]
    for bi in range(mb):
        for bj in range(nb):
            s = int(base[bi, bj])
            if s < 0:
                continue
            s %= z
            for r in range(z):
                row = bi * z + r
                col = bj * z + (r + s) % z
                mlist[row].append(col)
                nlist[col].append(row)
    for v in range(n):
        nlist[v].sort()
    for c in range(m):
        mlist[c].sort()
    return Alist(n=n, m=m, nlist=nlist, mlist=mlist)


def nb_regular(
    n: int, m: int, dv: int, q: int, seed: int = 0, method: str = "peg"
) -> Alist:
    """Non-binary regular LDPC over GF(q): binary PEG/random structure with
    uniformly random nonzero GF coefficients per edge.

    The reference's NB codes (``SystemC/NB-LDPC/codes/GF{2,4,8}``) are
    sparse structures with per-edge field values in the same "N M q" alist
    dialect this produces.
    """
    a = peg(n, m, dv, seed=seed) if method == "peg" else random_regular(
        n, m, dv, seed=seed
    )
    rng = np.random.default_rng(seed + 0x9E3779B9)
    nvals = [
        [int(rng.integers(1, q)) for _ in rows] for rows in a.nlist
    ]
    val_of = {
        (i, j): v
        for j, (rows, vv) in enumerate(zip(a.nlist, nvals))
        for i, v in zip(rows, vv)
    }
    mvals = [
        [val_of[(i, j)] for j in cols] for i, cols in enumerate(a.mlist)
    ]
    return Alist(
        n=a.n, m=a.m, nlist=a.nlist, mlist=a.mlist, q=q,
        nvals=nvals, mvals=mvals,
    )


def make_regular_code(
    n: int, m: int, dv: int, seed: int = 0, method: str = "peg"
) -> Code:
    """One-stop (n, m) regular code -> :class:`Code`."""
    if method == "peg":
        a = peg(n, m, dv, seed=seed)
    elif method == "random":
        a = random_regular(n, m, dv, seed=seed)
    else:
        raise ValueError(f"unknown method {method!r}")
    return build_code(a)
