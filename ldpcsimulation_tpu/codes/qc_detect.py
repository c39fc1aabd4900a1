"""Auto-detect quasi-cyclic structure in loaded parity-check matrices.

The reference stores every code as a flat alist even when the underlying
standard is block-circulant (802.11n, 802.16e; SURVEY §2.5).  QC codes
route to the gather-free roll decoders (:mod:`..decoders.minsum_qc`
etc.) instead of the generic gather path.  This module recovers the
structure from the expanded H:

  * candidate expansion factors z: divisors of gcd(n, m), largest first;
  * candidate row/column orderings: contiguous blocks (the natural QC
    layout) and the q-interleave ``i -> (i mod q)·z + i div q`` (the
    DVB-S2-style storage where block membership is ``i mod q``);
  * a layout is accepted only if EVERY nonzero z×z block is a single
    cyclic shift of the identity, verified edge-exactly.

Detection is sparse (O(E) per candidate) and exact: the returned
:class:`DetectedQC` satisfies ``expand(qc) == H[row_perm][:, col_perm]``
as an edge set, which the unit tests assert.  Codes whose blocks are sums
of shifts or general permutations (DVB-S2's accumulator corner, 802.3an's
RS permutations) are rejected — they take the dense-matmul path
(:mod:`..decoders.dense_ops`) instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .alist import Alist
from .qc import QCCode, build_qc_code

__all__ = ["DetectedQC", "detect_qc", "permuted_decoder"]


@dataclasses.dataclass(frozen=True)
class DetectedQC:
    """QC structure of a loaded H, up to row/column relabeling.

    ``qc`` expands to exactly ``H[row_perm][:, col_perm]``.  Rows are
    checks (relabeling is statistically invisible); columns are variables,
    so decoders run in the permuted order — :func:`permuted_decoder` wraps
    the in/out mapping.
    """

    qc: QCCode
    row_perm: np.ndarray  # [M] original row index per permuted position
    col_perm: np.ndarray  # [N] original column index per permuted position

    @property
    def inv_col_perm(self) -> np.ndarray:
        return np.argsort(self.col_perm)


def _edge_arrays(alist: Alist) -> Tuple[np.ndarray, np.ndarray]:
    rows = []
    cols = []
    for r, lst in enumerate(alist.mlist):
        rows.append(np.full(len(lst), r, np.int64))
        cols.append(np.asarray(lst, np.int64))
    return np.concatenate(rows), np.concatenate(cols)


def _maps(size: int, z: int) -> List[Tuple[str, Optional[np.ndarray]]]:
    """Candidate index relabelings: position -> (block, offset) codomain.

    Returns (name, perm) where perm[i] is the PERMUTED position of
    original index i; None denotes identity (contiguous blocks).
    """
    q = size // z
    out: List[Tuple[str, Optional[np.ndarray]]] = [("contig", None)]
    if 1 < q < size:
        i = np.arange(size)
        # block = i mod q, offset = i div q (DVB-S2-style interleave)
        out.append(("interleave", (i % q) * z + i // q))
    return out


def _try_layout(
    rows: np.ndarray,
    cols: np.ndarray,
    m: int,
    n: int,
    z: int,
    rmap: Optional[np.ndarray],
    cmap: Optional[np.ndarray],
) -> Optional[np.ndarray]:
    """If every block is a single circulant under the maps, return the
    [mb, nb] shift base matrix (−1 for zero blocks)."""
    pr = rows if rmap is None else rmap[rows]
    pc = cols if cmap is None else cmap[cols]
    mb, nb = m // z, n // z
    bi, ri = pr // z, pr % z
    bj, cj = pc // z, pc % z
    key = bi * nb + bj
    shift = (cj - ri) % z
    order = np.argsort(key, kind="stable")
    k = key[order]
    s = shift[order]
    # block boundaries
    uniq, start, cnt = np.unique(k, return_index=True, return_counts=True)
    if (cnt != z).any():
        return None
    # all shifts within a block equal
    first = s[start]
    if not (s == np.repeat(first, cnt)).all():
        return None
    # full circulant check: offsets ri within each block must be all-distinct
    # (z edges, one per row, shift constant => one per column too)
    r_sorted = ri[order]
    for st in start:
        if len(np.unique(r_sorted[st : st + z])) != z:
            return None
    base = np.full((mb, nb), -1, np.int64)
    base[uniq // nb, uniq % nb] = first
    return base


def detect_qc(
    alist: Alist,
    z_candidates: Optional[Sequence[int]] = None,
    min_z: int = 4,
    max_candidates: Optional[int] = None,
) -> Optional[DetectedQC]:
    """Detect circulant-block structure; None if no exact layout found.

    Candidates are every divisor z of gcd(n, m) with z >= min_z whose
    block grid could hold the edge set (num_edges % z == 0 — each full
    circulant contributes exactly z edges), largest first.  All surviving
    divisors are tried: truncating the list can silently miss the true z
    of a highly composite gcd and route a genuine QC code to the gather
    path.  ``max_candidates`` remains as an explicit opt-in bound.
    """
    n, m = alist.n, alist.m
    if getattr(alist, "q", 0) and alist.q > 2:
        return None  # non-binary alists keep their own decoders
    rows, cols = _edge_arrays(alist)
    g = math.gcd(n, m)
    if z_candidates is None:
        num_edges = len(rows)
        z_candidates = sorted(
            (
                d
                for d in range(min_z, g + 1)
                if g % d == 0 and num_edges % d == 0
            ),
            reverse=True,
        )
        if max_candidates is not None:
            z_candidates = z_candidates[:max_candidates]
    for z in z_candidates:
        for rname, rmap in _maps(m, z):
            for cname, cmap in _maps(n, z):
                base = _try_layout(rows, cols, m, n, z, rmap, cmap)
                if base is None:
                    continue
                qc = build_qc_code(base, z)
                # perm arrays: permuted position p holds original index
                # perm_of_original[i] = p  =>  original_at[p] = argsort
                row_perm = (
                    np.arange(m) if rmap is None else np.argsort(rmap)
                )
                col_perm = (
                    np.arange(n) if cmap is None else np.argsort(cmap)
                )
                return DetectedQC(qc=qc, row_perm=row_perm, col_perm=col_perm)
    return None


def permuted_decoder(det: DetectedQC, decode_fn):
    """Wrap a QC decoder so it accepts/returns natural-order frames.

    decode_fn(y_qc [B, N], key) -> result with .hard [B, N] (QC order).
    The wrapper permutes the input columns in and the hard decisions back
    out; one static gather per decode, amortized over all iterations.
    """
    import dataclasses as _dc

    import jax.numpy as jnp

    col = jnp.asarray(det.col_perm)
    inv = jnp.asarray(det.inv_col_perm)

    def fn(y, key):
        res = decode_fn(jnp.take(y, col, axis=1), key)
        return _dc.replace(res, hard=jnp.take(res.hard, inv, axis=1))

    return fn
