"""GF(2) linear algebra and systematic LDPC encoding.

The reference relies on MacKay/Neal's offline tools (``.pchk``/``.gen`` files,
``SystemC/NGDBF/codes/PegReg/gen-*`` scripts) plus the vendored
``cm_inversion`` GF(2) LU inversion (``C_implementations/src/r.cpp``,
``inc/r.h:88-176``) to produce the pre-encoded ``data.enc`` codeword
fixtures.  This module is the native equivalent: reduce H over GF(2), build a
systematic encoder, and batch-encode random information words on device (an
int32 matrix product reduced mod 2).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .code import Code, code_to_alist

__all__ = ["gf2_rref", "Encoder", "make_encoder", "random_codewords"]


def gf2_rref(h: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reduced row echelon form of a 0/1 matrix over GF(2).

    Returns (rref, pivot_cols, free_cols).  rank == len(pivot_cols); rows of
    rref beyond the rank are zero.
    """
    a = (np.asarray(h, dtype=np.uint8) & 1).copy()
    m, n = a.shape
    pivots = []
    r = 0
    for c in range(n):
        if r >= m:
            break
        rows = np.flatnonzero(a[r:, c]) + r
        if rows.size == 0:
            continue
        if rows[0] != r:
            a[[r, rows[0]]] = a[[rows[0], r]]
        # eliminate everywhere else in this column
        hit = np.flatnonzero(a[:, c])
        hit = hit[hit != r]
        a[hit] ^= a[r]
        pivots.append(c)
        r += 1
    pivot_cols = np.array(pivots, dtype=np.int64)
    free_cols = np.setdiff1d(np.arange(n), pivot_cols)
    return a, pivot_cols, free_cols


@dataclasses.dataclass
class Encoder:
    """Systematic GF(2) encoder for a parity-check matrix H.

    Information bits occupy ``free_cols`` (length k = n - rank(H)); parity
    bits occupy ``pivot_cols`` and are ``parity = info @ gen_t mod 2`` where
    ``gen_t[k, rank]`` is derived from the RREF of H.  ``encode`` assembles
    the full n-bit codeword (H @ cw == 0 mod 2 by construction).
    """

    n: int
    k: int
    rank: int
    pivot_cols: jax.Array  # [rank] int32
    free_cols: jax.Array  # [k] int32
    gen_t: jax.Array  # [k, rank] uint8: parity = info @ gen_t (mod 2)

    def encode(self, info: jax.Array) -> jax.Array:
        """info: [..., k] bits -> codeword [..., n] bits (uint8)."""
        info = jnp.asarray(info, jnp.uint8)
        # mod-2 matmul; accumulate in int32 (exact) then reduce mod 2
        parity = (
            jnp.matmul(
                info.astype(jnp.int32),
                self.gen_t.astype(jnp.int32),
                preferred_element_type=jnp.int32,
            )
            % 2
        ).astype(jnp.uint8)
        cw = jnp.zeros(info.shape[:-1] + (self.n,), jnp.uint8)
        cw = cw.at[..., self.free_cols].set(info)
        cw = cw.at[..., self.pivot_cols].set(parity)
        return cw


jax.tree_util.register_dataclass(
    Encoder,
    data_fields=["pivot_cols", "free_cols", "gen_t"],
    meta_fields=["n", "k", "rank"],
)


def make_encoder(code: Code) -> Encoder:
    """Build a systematic encoder from a Code (dense RREF; one-time setup).

    For each pivot row r with pivot column p_r, RREF gives
    ``x[p_r] = sum_f rref[r, f] * x[f] (mod 2)`` over free columns f.
    """
    h = code_to_alist(code).to_dense()
    h = (h != 0).astype(np.uint8)
    rref, pivot_cols, free_cols = gf2_rref(h)
    rank = len(pivot_cols)
    k = code.n - rank
    # gen[rank, k]: parity r depends on info bits (free cols)
    gen = rref[:rank][:, free_cols]  # [rank, k]
    return Encoder(
        n=code.n,
        k=k,
        rank=rank,
        pivot_cols=jnp.asarray(pivot_cols, jnp.int32),
        free_cols=jnp.asarray(free_cols, jnp.int32),
        gen_t=jnp.asarray(gen.T, jnp.uint8),
    )


def random_codewords(
    encoder: Encoder, key: jax.Array, batch: int
) -> jax.Array:
    """[batch, n] random codewords (uniform information bits)."""
    info = jax.random.bernoulli(key, 0.5, (batch, encoder.k)).astype(jnp.uint8)
    return encoder.encode(info)
