"""`Code`: the Tanner-graph representation (padded slot arrays).

The reference indexes H through ragged dual adjacency lists and recomputes a
reverse edge lookup with a linear ``find()`` on *every message update*
(``C_implementations/src/decodeMinSum.cpp:527-536`` — O(dc·dv) per edge).  This
design precomputes everything once, as dense padded arrays:

  * **VN-slot layout** — messages from variable nodes live in a
    ``[N * dv_max]`` flat array; slot ``(v, s)`` maps to flat index
    ``v * dv_max + s``, in the alist's per-column file order.
  * **CN-slot layout** — messages from check nodes live in ``[M * dc_max]``;
    slot ``(c, t)`` maps to ``c * dc_max + t``, in per-row file order.
  * ``cn_from_vn[c, t]`` / ``vn_from_cn[v, s]`` are the static gather
    permutations between the two layouts: one `take` replaces every
    ``find()``.

Padding slots are masked (``*_mask``); their gather indices point at slot 0
and must be neutralized by the consumer (e.g. +inf magnitude for min
reductions, 0 for sums, +1 for sign products).

Batched decoders keep messages as ``[slots, B]`` arrays — the Monte-Carlo
batch is the last (contiguous) dimension, so a graph gather moves
contiguous batch vectors.
"""

from __future__ import annotations

import dataclasses
from typing import List

import jax
import numpy as np

from .alist import Alist, from_dense

__all__ = ["Code", "build_code", "code_from_dense"]


@dataclasses.dataclass(frozen=True)
class Code:
    """Immutable Tanner graph in padded slot form.  A JAX pytree.

    Static metadata (``n``, ``m``, degree caps, edge count, ``q``) is part of
    the pytree treedef, so each distinct code shape gets its own jit cache
    entry with fully static array shapes.
    """

    # --- static metadata (aux data) ---
    n: int  # variables (columns)
    m: int  # checks (rows)
    dv_max: int
    dc_max: int
    num_edges: int
    q: int  # 0 or 2 => binary; >2 => GF(q)

    # --- arrays (pytree leaves) ---
    vn_cn: jax.Array  # [N, dv_max] int32: check index per VN slot (0 if pad)
    vn_mask: jax.Array  # [N, dv_max] bool
    vn_deg: jax.Array  # [N] int32
    cn_vn: jax.Array  # [M, dc_max] int32: variable index per CN slot
    cn_mask: jax.Array  # [M, dc_max] bool
    cn_deg: jax.Array  # [M] int32
    cn_from_vn: jax.Array  # [M, dc_max] int32: flat VN-slot feeding CN slot
    vn_from_cn: jax.Array  # [N, dv_max] int32: flat CN-slot feeding VN slot
    # Non-binary only ([..] int32 GF coefficients per edge; all-ones if binary)
    vn_coef: jax.Array  # [N, dv_max]
    cn_coef: jax.Array  # [M, dc_max]

    @property
    def k(self) -> int:
        """Nominal information length (assumes full-rank H)."""
        return self.n - self.m

    @property
    def rate(self) -> float:
        return self.k / self.n

    def true_k(self) -> int:
        """Rank-aware information length n − rank(H).

        The reference's ``802_3_H.alist`` ships 384 rows of rank 325, so the
        nominal ``k``/``rate`` understate the real code there (the reference
        scripts hard-code rate 0.8413 for the same reason).  Computed by
        GF(2) elimination on first use and cached on the instance.
        """
        cached = self.__dict__.get("_true_k")
        if cached is None:
            from .encode import gf2_rref

            h = np.zeros((self.m, self.n), np.uint8)
            cn_vn = np.asarray(self.cn_vn)
            cn_mask = np.asarray(self.cn_mask)
            rows = np.repeat(np.arange(self.m), self.dc_max)
            keep = cn_mask.reshape(-1)
            h[rows[keep], cn_vn.reshape(-1)[keep]] = 1
            _, pivots, _ = gf2_rref(h)
            cached = self.n - len(pivots)
            object.__setattr__(self, "_true_k", cached)
        return cached

    def true_rate(self) -> float:
        """Rank-aware code rate ``true_k() / n`` (see :meth:`true_k`)."""
        return self.true_k() / self.n

    @property
    def vn_slots(self) -> int:
        return self.n * self.dv_max

    @property
    def cn_slots(self) -> int:
        return self.m * self.dc_max

    def __repr__(self) -> str:  # keep reprs short in logs
        base = f"Code(n={self.n}, m={self.m}, dv_max={self.dv_max}, dc_max={self.dc_max}, E={self.num_edges}"
        if self.q > 2:
            base += f", q={self.q}"
        return base + ")"


jax.tree_util.register_dataclass(
    Code,
    data_fields=[
        "vn_cn",
        "vn_mask",
        "vn_deg",
        "cn_vn",
        "cn_mask",
        "cn_deg",
        "cn_from_vn",
        "vn_from_cn",
        "vn_coef",
        "cn_coef",
    ],
    meta_fields=["n", "m", "dv_max", "dc_max", "num_edges", "q"],
)


def build_code(a: Alist) -> Code:
    """Build the padded slot representation from a parsed alist.

    Slot order within each node follows the alist file order exactly — the
    reference's min-sum tie-break (`decodeMinSum.cpp:428-437`, last minimum
    wins the 2nd-min slot) and its trace tools are order-sensitive.
    """
    n, m = a.n, a.m
    dv_max, dc_max = a.dv_max, a.dc_max

    vn_cn = np.zeros((n, dv_max), dtype=np.int32)
    vn_mask = np.zeros((n, dv_max), dtype=bool)
    cn_vn = np.zeros((m, dc_max), dtype=np.int32)
    cn_mask = np.zeros((m, dc_max), dtype=bool)
    vn_coef = np.ones((n, dv_max), dtype=np.int32)
    cn_coef = np.ones((m, dc_max), dtype=np.int32)

    for v, rows in enumerate(a.nlist):
        for s, c in enumerate(rows):
            vn_cn[v, s] = c
            vn_mask[v, s] = True
            if a.nvals is not None:
                vn_coef[v, s] = a.nvals[v][s]
    for c, cols in enumerate(a.mlist):
        for t, v in enumerate(cols):
            cn_vn[c, t] = v
            cn_mask[c, t] = True
            if a.mvals is not None:
                cn_coef[c, t] = a.mvals[c][t]

    # Reverse maps: for edge (v, c), which slot index does the other side use?
    # Parallel edges are not expected (H is 0/1 per position); duplicate
    # entries would silently overwrite, so guard.
    vn_slot_of = {}
    for v, rows in enumerate(a.nlist):
        for s, c in enumerate(rows):
            if (v, c) in vn_slot_of:
                raise ValueError(f"parallel edge ({v},{c}) in alist")
            vn_slot_of[(v, c)] = s
    cn_slot_of = {}
    for c, cols in enumerate(a.mlist):
        for t, v in enumerate(cols):
            if (v, c) in cn_slot_of:
                raise ValueError(f"parallel edge ({v},{c}) in alist")
            cn_slot_of[(v, c)] = t

    cn_from_vn = np.zeros((m, dc_max), dtype=np.int32)
    for c, cols in enumerate(a.mlist):
        for t, v in enumerate(cols):
            cn_from_vn[c, t] = v * dv_max + vn_slot_of[(v, c)]
    vn_from_cn = np.zeros((n, dv_max), dtype=np.int32)
    for v, rows in enumerate(a.nlist):
        for s, c in enumerate(rows):
            vn_from_cn[v, s] = c * dc_max + cn_slot_of[(v, c)]

    return Code(
        n=n,
        m=m,
        dv_max=dv_max,
        dc_max=dc_max,
        num_edges=a.num_edges,
        q=a.q,
        vn_cn=jax.numpy.asarray(vn_cn),
        vn_mask=jax.numpy.asarray(vn_mask),
        vn_deg=jax.numpy.asarray(np.array(a.dv, dtype=np.int32)),
        cn_vn=jax.numpy.asarray(cn_vn),
        cn_mask=jax.numpy.asarray(cn_mask),
        cn_deg=jax.numpy.asarray(np.array(a.dc, dtype=np.int32)),
        cn_from_vn=jax.numpy.asarray(cn_from_vn),
        vn_from_cn=jax.numpy.asarray(vn_from_cn),
        vn_coef=jax.numpy.asarray(vn_coef),
        cn_coef=jax.numpy.asarray(cn_coef),
    )


def code_from_dense(h: np.ndarray, q: int = 0) -> Code:
    """Convenience: dense H (rows=checks) -> Code."""
    return build_code(from_dense(h, q=q))


def code_to_alist(code: Code) -> Alist:
    """Inverse of :func:`build_code` (for serialization)."""
    vn_cn = np.asarray(code.vn_cn)
    vn_mask = np.asarray(code.vn_mask)
    cn_vn = np.asarray(code.cn_vn)
    cn_mask = np.asarray(code.cn_mask)
    nlist: List[List[int]] = [
        [int(vn_cn[v, s]) for s in range(code.dv_max) if vn_mask[v, s]]
        for v in range(code.n)
    ]
    mlist: List[List[int]] = [
        [int(cn_vn[c, t]) for t in range(code.dc_max) if cn_mask[c, t]]
        for c in range(code.m)
    ]
    nvals = mvals = None
    if code.q > 2:
        vn_coef = np.asarray(code.vn_coef)
        cn_coef = np.asarray(code.cn_coef)
        nvals = [
            [int(vn_coef[v, s]) for s in range(code.dv_max) if vn_mask[v, s]]
            for v in range(code.n)
        ]
        mvals = [
            [int(cn_coef[c, t]) for t in range(code.dc_max) if cn_mask[c, t]]
            for c in range(code.m)
        ]
    return Alist(
        n=code.n, m=code.m, nlist=nlist, mlist=mlist,
        q=code.q if code.q > 2 else 0, nvals=nvals, mvals=mvals,
    )
