"""Non-binary channel front-end: GF(2^m) symbols over bit-BPSK/AWGN.

Model (matching the Davey–MacKay prototype the reference's NB tree builds
on, ``SystemC/NB-LDPC/belief_propagation_old.py:59-74``): each GF(2^m)
symbol is transmitted as its m bits, BPSK-modulated, through AWGN.  Bit
posteriors combine into a probability vector over the q field elements per
symbol.  The prototype's bit likelihood ``1/(1 + exp(2|y|/σ²))`` is the
standard AWGN bit posterior; here it is computed in the log domain and
normalized per symbol.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..codes.gf import gf_bits

__all__ = ["symbols_to_bits", "bits_to_symbols", "symbol_priors"]


def symbols_to_bits(symbols: jax.Array, q: int) -> jax.Array:
    """[..., N] field elements -> [..., N, m] bits (LSB first)."""
    m = q.bit_length() - 1
    shifts = jnp.arange(m, dtype=symbols.dtype)
    return (symbols[..., None] >> shifts) & 1


def bits_to_symbols(bits: jax.Array, q: int) -> jax.Array:
    m = q.bit_length() - 1
    weights = (2 ** jnp.arange(m)).astype(jnp.int32)
    return jnp.sum(bits.astype(jnp.int32) * weights, axis=-1)


def symbol_priors(y_bits: jax.Array, n0, q: int) -> jax.Array:
    """Bit-level channel samples -> normalized symbol probabilities.

    y_bits: [..., N, m] AWGN outputs of BPSK bits (bit b -> 1-2b).
    Returns [..., N, q] with rows summing to 1.
    """
    llr = 4.0 * y_bits / n0  # bit LLR, log(P0/P1)
    # log P(bit=0) = -softplus(-llr); log P(bit=1) = -softplus(llr)
    logp0 = -jax.nn.softplus(-llr)
    logp1 = -jax.nn.softplus(llr)
    patt = jnp.asarray(gf_bits(q), bool)  # [q, m]
    # log prior of symbol a = sum over its m bits of the matching bit
    # posterior: a select and a sum, not a dot, so every backend computes
    # it in full f32 (a GPU may run an f32 dot in TF32)
    logp = jnp.sum(
        jnp.where(patt, logp1[..., None, :], logp0[..., None, :]), axis=-1
    )
    return jax.nn.softmax(logp, axis=-1)
