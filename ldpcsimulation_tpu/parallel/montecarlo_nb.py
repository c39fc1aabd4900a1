"""Mesh-parallel Monte-Carlo for non-binary GF(q) codes.

NB counterpart of :mod:`.mesh`/:mod:`.montecarlo`: the (snr × data) mesh
runs FFT-QSPA decoding of all-zero codewords with per-device RNG streams
(fold-in of mesh coordinates) and psum-reduces symbol/bit/word error
counters across devices.  Replaces the reference's never-finished NB harness
(SystemC/NB-LDPC) at mesh scale.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..channel.awgn import snr_to_n0
from ..channel.nb import symbol_priors, symbols_to_bits
from ..codes.code import Code
from ..decoders.nb_qspa import decode_nb_qspa
from ..harness.montecarlo import StopRule, default_min_word_errors
from ..harness.montecarlo_nb import NBMCStats

__all__ = ["make_nb_counters_step", "simulate_nb_distributed"]


def make_nb_counters_step(
    code: Code,
    mesh,
    sigmas: Sequence[float],
    n0s: Sequence[float],
    num_iterations: int,
    batch_per_device: int,
    early_termination: bool = True,
    dtype=jnp.float32,
    storage_dtype=None,
):
    """Jitted distributed NB Monte-Carlo step.

    Returns step(root_key) -> dict of [n_snr] psum-reduced counters.
    """
    n_snr = mesh.shape["snr"]
    n_data = mesh.shape["data"]
    if len(sigmas) != n_snr:
        raise ValueError(f"need {n_snr} sigmas for the snr axis")
    q = code.q
    m_bits = q.bit_length() - 1
    sig_arr = jnp.asarray(list(sigmas), dtype)
    n0_arr = jnp.asarray(list(n0s), dtype)
    b = batch_per_device

    def local_step(root_key, sigma, n0):
        si = jax.lax.axis_index("snr")
        di = jax.lax.axis_index("data")
        key = jax.random.fold_in(jax.random.fold_in(root_key, si), di)
        sigma = sigma.reshape(())
        n0 = n0.reshape(())
        y = 1.0 + sigma * jax.random.normal(key, (b, code.n, m_bits), dtype)
        pri = symbol_priors(y, n0, q)
        res = decode_nb_qspa(
            code, pri, num_iterations, early_termination=early_termination,
            storage_dtype=storage_dtype,
        )
        sym_errs = jnp.sum(res.symbols != 0, axis=1)
        bits = symbols_to_bits(res.symbols, q)
        counters = dict(
            symbol_errors=jnp.sum(sym_errs).astype(jnp.int32),
            bit_errors=jnp.sum(bits != 0).astype(jnp.int32),
            uncoded_symbol_errors=jnp.sum(
                jnp.argmax(pri, axis=-1) != 0
            ).astype(jnp.int32),
            word_errors=jnp.sum(sym_errs > 0).astype(jnp.int32),
            words=jnp.int32(b),
            iteration_sum=jnp.sum(res.iterations.astype(jnp.int32)),
        )
        return jax.tree.map(
            lambda t: jax.lax.psum(t, axis_name="data")[None], counters
        )

    out_specs = dict(
        symbol_errors=P("snr"),
        bit_errors=P("snr"),
        uncoded_symbol_errors=P("snr"),
        word_errors=P("snr"),
        words=P("snr"),
        iteration_sum=P("snr"),
    )

    @jax.jit
    def step(root_key):
        return jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(), P("snr"), P("snr")),
            out_specs=out_specs,
        )(root_key, sig_arr, n0_arr)

    step.batch_global = b * n_data
    step.n_snr = n_snr
    return step


def simulate_nb_distributed(
    code: Code,
    snrs_db: Sequence[float],
    mesh,
    num_iterations: int,
    rate: Optional[float] = None,
    stop: Optional[StopRule] = None,
    batch_per_device: int = 64,
    seed: int = 0,
    early_termination: bool = True,
    max_batches: int = 100000,
    storage_dtype=None,
) -> List[NBMCStats]:
    """All SNR points of an NB sweep concurrently on the mesh."""
    q = code.q
    if q < 4:
        raise ValueError("simulate_nb_distributed expects a GF(q>2) code")
    m_bits = q.bit_length() - 1
    rate = rate if rate is not None else code.rate
    stop = stop or StopRule(min_word_errors=default_min_word_errors(code.n))
    n0s = [float(snr_to_n0(s, rate)) for s in snrs_db]
    sigmas = [float(np.sqrt(v / 2.0)) for v in n0s]
    step = make_nb_counters_step(
        code,
        mesh,
        sigmas=sigmas,
        n0s=n0s,
        num_iterations=num_iterations,
        batch_per_device=batch_per_device,
        early_termination=early_termination,
        storage_dtype=storage_dtype,
    )
    stats = [NBMCStats(n=code.n, q=q) for _ in snrs_db]
    root = jax.random.key(seed)
    t0 = time.perf_counter()
    for batch_idx in range(max_batches):
        if all(
            stop.done(s.bit_errors, s.word_errors, s.total_words)
            for s in stats
        ):
            break
        out = jax.device_get(step(jax.random.fold_in(root, batch_idx)))
        for i, s in enumerate(stats):
            s.symbol_errors += int(out["symbol_errors"][i])
            s.bit_errors += int(out["bit_errors"][i])
            s.uncoded_symbol_errors += int(out["uncoded_symbol_errors"][i])
            s.word_errors += int(out["word_errors"][i])
            s.total_words += int(out["words"][i])
            s.total_symbols += int(out["words"][i]) * code.n
            s.total_bits += int(out["words"][i]) * code.n * m_bits
            s.total_iterations += int(out["iteration_sum"][i])
    dt = time.perf_counter() - t0
    for s in stats:
        s.wall_seconds = dt
    return stats
