"""Stratified block-permutation structure: one-hot matmul interleavers.

Some reference codes are neither circulant nor QC-relabelable but still
highly structured: the 802.3an RS-LDPC ``802_3_H.alist`` (2048 cols, 384
rows) has *row strata* — every column has exactly one edge in each
contiguous 64-row block (`C_implementations/codes/802_3/802_3_H.alist`;
the RS construction disperses each code symbol over a 64-row stratum).
Its 64x64 blocks are NOT single circulants (``qc_detect`` correctly
rejects them), so message passing on this H otherwise takes the generic
gather path.

This module exploits the weaker structure that *does* hold:

  * rows partition into ``mb`` strata such that every column has at most
    one edge per stratum (contiguous blocks for 802.3an; greedy row
    coloring otherwise);
  * columns partition into ``kg`` groups that are independent sets of the
    column conflict graph (no two group members share any row) — found by
    capacity-bounded greedy coloring.

Within one (stratum, group) pair the edges then form a partial
permutation: each group column touches at most one stratum row and each
stratum row at most one group column.  The VN->CN interleaver therefore
factors into ``mb * kg`` static partial-permutation matrices, applied as
ONE batched one-hot einsum (a matrix product).  Because every output is a
single-term sum (one 1.0 per one-hot row), the matmul moves f16/f32
message payloads *exactly* under ``Precision.HIGHEST`` — verified by the
bit-exact equivalence tests against the generic decoder.  No dynamic
gathers remain on the iteration path.

This design has no reference analog (the reference treats
802.3an as an unstructured alist and pays the ``find()`` scan per edge,
``decodeMinSum.cpp:527-536``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .alist import Alist

__all__ = ["StratifiedCode", "stratify", "detect_stratified"]


@dataclasses.dataclass(frozen=True)
class StratifiedCode:
    """Stratified interleaver companion to :class:`Code`.  A JAX pytree.

    Layouts (B = batch, always last):
      * VN grid   ``[kg, w, B]``   — columns scattered into groups
        (``col_slot`` maps grid slot -> original column, -1 = padding).
      * VN slots  ``[mb, kg, w, B]`` — one message per (stratum, column).
      * CN slots  ``[mb, h, kg, B]`` — one message per (row, group); a
        row's edges occupy ``kg`` slots with ``cn_valid`` masking.

    ``onehot[mb, kg, w, h]`` is the forward interleaver: entry
    ``(b, g, c, r) = 1`` iff grid column ``(g, c)`` has its stratum-``b``
    edge at stratum row ``r``.  The reverse move is the same tensor
    contracted on ``h``.  ``cn_rank`` carries each edge's position in the
    row's alist order so decoders can reproduce order-sensitive reference
    semantics (min-sum's last-minimum tie-break) without scanning in that
    order.
    """

    # --- static metadata ---
    n: int
    m: int
    mb: int  # number of row strata
    h: int   # stratum height (padded)
    kg: int  # number of column groups
    w: int   # group width (padded)
    num_edges: int

    # --- arrays (pytree leaves) ---
    col_slot: jax.Array   # [kg, w] int32: original column, -1 pad
    pos_of_col: jax.Array  # [N] int32: flat grid position g*w + c of column
    row_of: jax.Array     # [mb, h] int32: original row, -1 pad
    onehot: jax.Array     # [mb, kg, w, h] float32
    vn_valid: jax.Array   # [mb, kg, w] bool
    cn_valid: jax.Array   # [mb, h, kg] bool
    cn_rank: jax.Array    # [mb, h, kg] int32 (alist slot order; -1 pad)

    @property
    def cost(self) -> float:
        """Slot-traffic overhead vs ideal edge arrays (1.0 = perfect)."""
        return (self.mb * self.kg * self.w + self.mb * self.h * self.kg) / (
            2.0 * self.num_edges
        )

    def __repr__(self) -> str:
        return (
            f"StratifiedCode(n={self.n}, m={self.m}, strata={self.mb}x{self.h},"
            f" groups={self.kg}x{self.w}, cost={self.cost:.2f})"
        )


jax.tree_util.register_dataclass(
    StratifiedCode,
    data_fields=[
        "col_slot",
        "pos_of_col",
        "row_of",
        "onehot",
        "vn_valid",
        "cn_valid",
        "cn_rank",
    ],
    meta_fields=["n", "m", "mb", "h", "kg", "w", "num_edges"],
)


def _contiguous_strata(alist: Alist) -> Optional[List[List[int]]]:
    """Largest h | m whose contiguous h-row blocks give each column <=1
    edge per block (the 802.3an layout).  None if no useful h works.

    Only *dense* strata qualify (mb <= 2*dv_max): every m has the
    degenerate h=1 solution (48 one-row strata for a (96,48) code), whose
    near-empty slot grid is wasteful (cost ~dc/2).  Historically h=1
    einsums also crashed the compiler of the first target device; the
    rule stays because of the cost.  Sparse cases fall back to greedy
    coloring."""
    m = alist.m
    dv_max = alist.dv_max
    for h in sorted((d for d in range(1, m + 1) if m % d == 0), reverse=True):
        if not dv_max <= m // h <= 2 * dv_max:
            continue  # strata must be dense: mb within [dv_max, 2*dv_max]
        seen = np.zeros((alist.n,), np.int64)
        ok = True
        for b in range(m // h):
            seen[:] = 0
            for r in range(b * h, (b + 1) * h):
                for c in alist.mlist[r]:
                    if seen[c]:
                        ok = False
                        break
                    seen[c] = 1
                if not ok:
                    break
            if not ok:
                break
        if ok:
            return [list(range(b * h, (b + 1) * h)) for b in range(m // h)]
    return None


def _greedy_row_strata(alist: Alist) -> List[List[int]]:
    """Greedy coloring of the row conflict graph (rows sharing a column)."""
    m = alist.m
    adj: List[set] = [set() for _ in range(m)]
    for rows in alist.nlist:
        for a in rows:
            adj[a].update(rows)
    for a in range(m):
        adj[a].discard(a)
    order = sorted(range(m), key=lambda r: -len(adj[r]))
    color = [-1] * m
    for r in order:
        used = {color[o] for o in adj[r] if color[o] >= 0}
        k = 0
        while k in used:
            k += 1
        color[r] = k
    strata: List[List[int]] = [[] for _ in range(max(color) + 1)]
    for r, k in enumerate(color):
        strata[k].append(r)
    return strata


def _rs_exact_col_groups(
    alist: Alist, row_strata: Sequence[Sequence[int]]
) -> Optional[List[List[int]]]:
    """Recover an *exact* equitable column partition for permutation-array
    codes (802.3an RS-LDPC class) — ``n/h`` groups of exactly ``h``
    columns, each an exact cover of all rows (zero padding, cost 1.0).

    The RS-LDPC construction behind 802.3an (Djurdjevic et al.; the
    reference ships it as an unstructured alist,
    ``C_implementations/codes/802_3/802_3_H.alist``) makes H a dense array
    of h×h permutation blocks: column ``(a, b)`` over GF(h) has its
    stratum-``i`` edge at row ``a·x_i + b``.  Columns of equal slope ``a``
    form the exact groups.  Slopes are not observable after the file's
    row/column relabeling, but a same-slope *consistency relation* is:
    for columns c, c' and strata i≠j, the "crossover" column with rows
    ``(r_i(c'), r_j(c))`` has slope ``a + (b+b')/(x_i+x_j)``, identical
    (char 2) to the mirrored crossover at ``(r_i(c), r_j(c'))`` — so
    either both exist in H or neither does.  Different-slope pairs pass
    each stratum-pair test with probability ~1/2, so ``C(mb,2)`` strata
    give a ~2^-C(mb,2) false-positive rate; a mutual-neighbor filter
    removes the stragglers and connected components are the groups.
    Returns None (caller falls back to greedy coloring) if the structure
    does not hold.
    """
    n, m = alist.n, alist.m
    mb = len(row_strata)
    if mb < 4 or n > 8192 or n % (m // mb) or m % mb:
        return None  # need >=6 pair-tests; O(n^2) arrays must stay small
    h = m // mb
    if any(len(s) != h for s in row_strata):
        return None
    stratum_of = np.full(m, -1, np.int64)
    rowpos = np.full(m, -1, np.int64)
    for b, s in enumerate(row_strata):
        for i, r in enumerate(s):
            stratum_of[r] = b
            rowpos[r] = i

    # Per-column stratum-row tuple; requires exactly one edge per stratum.
    R = np.full((n, mb), -1, np.int64)
    for c in range(n):
        rows = alist.nlist[c]
        if len(rows) != mb:
            return None
        for r in rows:
            b = stratum_of[r]
            if R[c, b] >= 0:
                return None
            R[c, b] = rowpos[r]

    exists = np.zeros((mb, mb, h, h), bool)
    for i in range(mb):
        for j in range(mb):
            exists[i, j, R[:, i], R[:, j]] = True

    conflict = np.zeros((n, n), bool)
    for i in range(mb):
        conflict |= R[:, i][:, None] == R[:, i][None, :]

    passing = ~conflict
    for i in range(mb):
        for j in range(i + 1, mb):
            E = exists[i, j]
            passing &= E[R[:, i][None, :], R[:, j][:, None]] == (
                E[R[:, i][:, None], R[:, j][None, :]]
            )

    # True groupmates share ~h-2 passing-neighbors; false positives ~0.
    P = passing.astype(np.float32)  # float matmul: BLAS, ~50x int32
    strong = passing & ((P @ P.T) >= h // 2)

    color = np.full(n, -1, np.int64)
    k = 0
    for c in range(n):
        if color[c] >= 0:
            continue
        stack = [c]
        color[c] = k
        while stack:
            u = stack.pop()
            for v in np.nonzero(strong[u])[0]:
                if color[v] < 0:
                    color[v] = int(k)
                    stack.append(int(v))
        k += 1
    if k != n // h or (np.bincount(color) != h).any():
        return None
    groups = [np.nonzero(color == g)[0].tolist() for g in range(k)]
    for grp in groups:  # each group must cover every row exactly once
        rows = [r for c in grp for r in alist.nlist[c]]
        if len(set(rows)) != m:
            return None
    return groups


def _greedy_col_groups(alist: Alist, cap: int) -> List[List[int]]:
    """Capacity-bounded greedy coloring of the column conflict graph
    (columns sharing a row conflict); each color class is an independent
    set, so every (stratum, group) block is a partial permutation."""
    n = alist.n
    adj: List[set] = [set() for _ in range(n)]
    for cols in alist.mlist:
        for a in cols:
            adj[a].update(cols)
    for a in range(n):
        adj[a].discard(a)
    order = sorted(range(n), key=lambda c: -len(adj[c]))
    color = [-1] * n
    counts: dict = {}
    for c in order:
        used = {color[o] for o in adj[c] if color[o] >= 0}
        k = 0
        while k in used or counts.get(k, 0) >= cap:
            k += 1
        color[c] = k
        counts[k] = counts.get(k, 0) + 1
    groups: List[List[int]] = [[] for _ in range(max(color) + 1)]
    for c, k in enumerate(color):
        groups[k].append(c)
    return groups


def stratify(
    alist: Alist,
    row_strata: Optional[Sequence[Sequence[int]]] = None,
    col_groups: Optional[Sequence[Sequence[int]]] = None,
    cap: Optional[int] = None,
    max_cost: Optional[float] = None,
) -> StratifiedCode:
    """Build the stratified interleaver structure for a binary alist.

    ``row_strata``/``col_groups`` override the automatic search (they must
    satisfy the <=1-edge-per-stratum-column / independent-set invariants,
    which are verified here).  ``max_cost`` rejects (ValueError) structures
    whose slot-traffic overhead exceeds the bound *before* the one-hot
    tensor is materialized.
    """
    if getattr(alist, "q", 0) and alist.q > 2:
        raise ValueError("stratified structure is for binary codes")
    n, m = alist.n, alist.m

    if row_strata is None:
        row_strata = _contiguous_strata(alist) or _greedy_row_strata(alist)
    row_strata = [list(s) for s in row_strata]
    mb = len(row_strata)
    h = max(len(s) for s in row_strata)

    if col_groups is None:
        col_groups = _rs_exact_col_groups(alist, row_strata)
        if col_groups is None:
            if cap is None:
                cap = max(64, h)
            col_groups = _greedy_col_groups(alist, cap)
    col_groups = [list(g) for g in col_groups]
    kg = len(col_groups)
    w = max(len(g) for g in col_groups)

    stratum_of = np.full(m, -1, np.int64)
    rowpos = np.full(m, -1, np.int64)
    for b, s in enumerate(row_strata):
        for i, r in enumerate(s):
            stratum_of[r] = b
            rowpos[r] = i
    group_of = np.full(n, -1, np.int64)
    colpos = np.full(n, -1, np.int64)
    for g, grp in enumerate(col_groups):
        for i, c in enumerate(grp):
            group_of[c] = g
            colpos[c] = i
    if (stratum_of < 0).any() or (group_of < 0).any():
        raise ValueError("strata/groups must cover all rows/columns")

    col_slot = np.full((kg, w), -1, np.int32)
    for g, grp in enumerate(col_groups):
        col_slot[g, : len(grp)] = grp
    pos_of_col = (group_of * w + colpos).astype(np.int32)
    row_of = np.full((mb, h), -1, np.int32)
    for b, s in enumerate(row_strata):
        row_of[b, : len(s)] = s

    # Bound cost/size BEFORE materializing the one-hot tensor: the cost
    # formula needs only the slot-grid dims and the edge count, and a
    # structure that will be rejected anyway (or whose one-hot would not
    # fit in host memory) must not trigger a multi-GiB allocation first.
    edges = sum(len(cols) for cols in alist.mlist)
    slot_cost = (mb * kg * w + mb * h * kg) / (2.0 * max(edges, 1))
    if max_cost is not None and slot_cost > max_cost:
        raise ValueError(
            f"stratified slot cost {slot_cost:.2f} exceeds max_cost "
            f"{max_cost:.2f}"
        )
    if mb * kg * w * h > 1 << 30:  # 4 GiB of f32 one-hot
        raise ValueError(
            f"stratified one-hot tensor {mb}x{kg}x{w}x{h} is too large"
        )

    onehot = np.zeros((mb, kg, w, h), np.float32)
    vn_valid = np.zeros((mb, kg, w), bool)
    cn_valid = np.zeros((mb, h, kg), bool)
    cn_rank = np.full((mb, h, kg), -1, np.int32)
    num_edges = 0
    for r, cols in enumerate(alist.mlist):
        b, i = stratum_of[r], rowpos[r]
        for t, c in enumerate(cols):
            g, j = group_of[c], colpos[c]
            if vn_valid[b, g, j]:
                raise ValueError(
                    f"column {c} has two edges in row stratum {b} — "
                    "invalid strata"
                )
            if cn_valid[b, i, g]:
                raise ValueError(
                    f"row {r} has two edges in column group {g} — "
                    "groups are not independent sets"
                )
            onehot[b, g, j, i] = 1.0
            vn_valid[b, g, j] = True
            cn_valid[b, i, g] = True
            cn_rank[b, i, g] = t
            num_edges += 1

    return StratifiedCode(
        n=n,
        m=m,
        mb=mb,
        h=h,
        kg=kg,
        w=w,
        num_edges=num_edges,
        col_slot=jnp.asarray(col_slot),
        pos_of_col=jnp.asarray(pos_of_col),
        row_of=jnp.asarray(row_of),
        onehot=jnp.asarray(onehot),
        vn_valid=jnp.asarray(vn_valid),
        cn_valid=jnp.asarray(cn_valid),
        cn_rank=jnp.asarray(cn_rank),
    )


def detect_stratified(
    alist: Alist, max_cost: float = 2.0
) -> Optional[StratifiedCode]:
    """Return the stratified structure if its slot overhead is worth it.

    Only codes whose strata are *dense* (mb close to dv) pay off; random
    codes (PEG, MacKay) produce sparse strata and stay on the generic
    path.  ``max_cost`` bounds the slot-traffic overhead (1.0 = perfect;
    802.3an achieves exactly 1.0 via the RS exact partition).
    """
    if getattr(alist, "q", 0) and alist.q > 2:
        return None
    if alist.n * alist.m == 0:
        return None
    try:
        sc = stratify(alist, max_cost=max_cost)
    except (ValueError, MemoryError):
        return None
    if sc.cost > max_cost:
        return None
    return sc
