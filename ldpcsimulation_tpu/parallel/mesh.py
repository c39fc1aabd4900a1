"""Device-mesh Monte-Carlo parallelism.

The reference's entire parallelism story is bash `nohup … &` fan-out: one OS
process per (SNR × parameter) operating point with time-seeded RNGs, merged
by appending to shared log files (SURVEY §2.6;
``C_implementations/scripts/bp_example_PEGReg504x1008.sh:24-28``).  The
replacement here is a 2-D device mesh:

  * axis ``"snr"`` — the operating-point axis.  Each slot runs one point of
    the experiment grid: an (SNR, decoder-parameter…) tuple.  The point's
    scalars (sigma plus any decoder parameters) are TRACED per-slot inputs,
    so one compiled program serves every chunk of an arbitrarily large
    cartesian grid — the reference's 5-deep nested bash sweeps
    (``mngdbf_example_PEGReg504x1008.sh:44-59``, ~1300 processes) become
    chunk rotations of a single XLA executable
    (:func:`..parallel.montecarlo.simulate_grid`).
  * axis ``"data"`` — the Monte-Carlo frame batch,

with per-device RNG streams derived by folding the device's mesh coordinates
into the root key (replacing time-seeded processes), and error counters
reduced with ``jax.lax.psum`` across devices (replacing log-file merging).  The
stop rule is evaluated on the psum-reduced counters — one decision for all
devices, replacing each process's local while-loop test.

Multi-host: call :func:`init_distributed` first (wraps
``jax.distributed.initialize``); the same mesh code then spans all hosts'
devices and the psums cross the hosts' interconnect.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..channel.awgn import awgn, bpsk
from ..codes.code import Code

__all__ = [
    "init_distributed",
    "make_mesh",
    "make_counters_step",
    "make_grid_step",
    "BatchCounters",
]


def init_distributed(**kwargs) -> None:
    """Initialize multi-host JAX (``jax.distributed.initialize`` wrapper).

    Pass the usual coordinator kwargs (``coordinator_address``,
    ``num_processes``, ``process_id``, ...) for an explicit cluster, or
    nothing to let JAX auto-detect (cluster environment variables).
    Idempotent: a second call on an already-initialized cluster is a no-op.
    Failures propagate — a cluster that cannot form is an error, not
    something to silently run single-host over.
    """
    if jax.distributed.is_initialized():
        return
    jax.distributed.initialize(**kwargs)


def make_mesh(
    n_snr: int = 1, devices: Optional[Sequence] = None
) -> Mesh:
    """2-D ("snr", "data") mesh over the available devices.

    n_snr must divide the device count; the remaining factor becomes the
    data axis.  n_snr=1 gives pure Monte-Carlo batch parallelism.
    """
    devices = list(devices if devices is not None else jax.devices())
    nd = len(devices)
    if nd % n_snr:
        raise ValueError(f"{nd} devices not divisible by n_snr={n_snr}")
    arr = np.array(devices).reshape(n_snr, nd // n_snr)
    return Mesh(arr, axis_names=("snr", "data"))


# A counters dict (one distributed step's output) has keys: errors,
# uncoded_errors, word_errors, iteration_sum, satisfied_words — each
# [n_snr] int32 — plus error_weight_hist [n_snr, N+1], iteration_hist
# [n_snr, T+1], and (when the decoder reports it) smoothing_used [n_snr].
# Frame/bit totals are NOT device counters: they are deterministic
# (batch_global per snr point per step) and int32 psums of bit counts
# would overflow at pod scale (batch * N * devices > 2^31) — the step
# exposes them as step.batch_global / step.bits_global instead.
BatchCounters = dict


def make_grid_step(
    code: Code,
    decode_fn: Callable,
    mesh: Mesh,
    batch_per_device: int,
    max_iterations: int,
    param_names: Tuple[str, ...] = (),
    preprocess: Optional[Callable] = None,
    awgn_form: str = "multiplicative",
    dtype=jnp.float32,
    codewords=None,
):
    """Build the jitted operating-point-grid Monte-Carlo step.

    The mesh "snr" axis is the operating-point axis: each slot receives its
    own sigma and its own value of every name in ``param_names`` as TRACED
    scalars, so the returned step is compiled once and re-invoked with any
    assignment of grid points to slots (the replacement for the
    reference's one-process-per-parameter-combination bash fan-out).

    decode_fn(samples [b, N], sigma_scalar, key, point) -> DecodeResult-like
    with .hard [b, N], .iterations [b], .satisfied [b]; ``point`` is a dict
    {name: traced scalar} over param_names.  preprocess(y, point) if given.

    Returns step(root_key, bits [S, B_global, N], sigmas [S],
    params {name: [S]}, round_idx) -> BatchCounters, where S = the mesh
    "snr" axis size and B_global = batch_per_device * mesh.data_size.

    All statistics are reduced on-device (histograms included) via psum over
    the "data" axis, so the host traffic per step is O(N) regardless of
    batch — multi-host friendly.
    """
    n_snr = mesh.shape["snr"]
    n_data = mesh.shape["data"]
    n = code.n
    param_names = tuple(param_names)
    # int32 error counters cannot overflow as long as the per-step global
    # bit count fits: errors <= bits always
    if batch_per_device * n_data * n > 2**31 - 1:
        raise ValueError(
            f"per-step bits {batch_per_device * n_data * n} exceed int32; "
            "reduce batch_per_device (throughput comes from more steps)"
        )
    cw = None if codewords is None else jnp.asarray(codewords, jnp.uint8)

    def local_step(root_key, bits, sigma, pvals, round_idx):
        """Runs per device on its [1, b, N] slice of frames."""
        bits = bits[0]  # drop the sharded-to-singleton snr axis
        # per-device RNG stream: fold mesh coordinates into the root key
        si = jax.lax.axis_index("snr")
        di = jax.lax.axis_index("data")
        key = jax.random.fold_in(jax.random.fold_in(root_key, si), di)
        kch, kdec = jax.random.split(key)
        sigma = sigma.reshape(())
        point = {nm: pvals[nm].reshape(()) for nm in param_names}
        if cw is not None:
            # cycle the fixture exactly like the single-device harness:
            # global frame position -> row (mod L), advancing every round
            bpd = bits.shape[0]
            base = round_idx * (n_data * bpd) + di * bpd
            idx = (base + jnp.arange(bpd)) % cw.shape[0]
            bits = cw[idx]
        x = bpsk(bits).astype(dtype)
        y = awgn(kch, x, sigma, form=awgn_form, dtype=dtype)
        r = jnp.where(y > 0, 1, -1).astype(jnp.int32)
        c = x.astype(jnp.int32)
        inp = preprocess(y, point) if preprocess is not None else y
        res = decode_fn(inp, sigma, kdec, point)
        frame_errs = jnp.sum(res.hard != c, axis=1).astype(jnp.int32)
        uncoded = jnp.sum(r != c, axis=1).astype(jnp.int32)
        counters = dict(
            errors=jnp.sum(frame_errs),
            uncoded_errors=jnp.sum(uncoded),
            word_errors=jnp.sum(frame_errs > 0),
            iteration_sum=jnp.sum(res.iterations.astype(jnp.int32)),
            satisfied_words=jnp.sum(res.satisfied.astype(jnp.int32)),
            # Histograms are scatter-add bincounts: O(B) work and no
            # O(B·(N+1)) one-hot intermediate (at DVB-S2 scale the one-hot
            # is ~10⁸ compare-reduce lanes per step).  `mode="drop"` makes
            # out-of-range values vanish exactly like an out-of-range
            # one_hot row does, so counters are bit-identical to the old
            # one-hot formulation (tests/test_parallel.py).
            error_weight_hist=jnp.zeros(n + 1, jnp.int32)
            .at[frame_errs]
            .add(1, mode="drop"),
            iteration_hist=jnp.zeros(max_iterations + 1, jnp.int32)
            .at[res.iterations]
            .add(1, mode="drop"),
        )
        su = getattr(res, "smoothing_used", None)
        if su is not None:
            counters["smoothing_used"] = jnp.sum(su.astype(jnp.int32))
        # reduce over the Monte-Carlo data axis (a collective), then add a
        # leading singleton that shard_map stacks along the snr axis
        counters = jax.tree.map(
            lambda t: jax.lax.psum(t, axis_name="data")[None], counters
        )
        return counters

    out_specs = dict(
        errors=P("snr"),
        uncoded_errors=P("snr"),
        word_errors=P("snr"),
        iteration_sum=P("snr"),
        satisfied_words=P("snr"),
        error_weight_hist=P("snr", None),
        iteration_hist=P("snr", None),
    )
    # Does this decoder report smoothing_used?  Resolve statically (the
    # out_specs pytree must match the output dict) via an abstract trace.
    probe = jax.eval_shape(
        lambda k: decode_fn(
            jnp.zeros((batch_per_device, n), dtype),
            jnp.asarray(0.5, dtype),
            k,
            {nm: jnp.zeros((), dtype) for nm in param_names},
        ),
        jax.random.key(0),
    )
    if getattr(probe, "smoothing_used", None) is not None:
        out_specs["smoothing_used"] = P("snr")

    pspec = {nm: P("snr") for nm in param_names}

    @jax.jit
    def step(root_key, bits, sigmas, params, round_idx=0):
        out = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(), P("snr", "data"), P("snr"), pspec, P()),
            out_specs=out_specs,
        )(
            root_key,
            bits,
            jnp.asarray(sigmas, dtype),
            {nm: jnp.asarray(params[nm], dtype) for nm in param_names},
            jnp.asarray(round_idx, jnp.int32),
        )
        return out

    step.batch_global = batch_per_device * n_data
    step.bits_global = batch_per_device * n_data * n
    step.n_snr = n_snr
    return step


def make_counters_step(
    code: Code,
    decode_fn: Callable,
    mesh: Mesh,
    sigmas: Sequence[float],
    batch_per_device: int,
    max_iterations: int,
    preprocess: Optional[Callable] = None,
    awgn_form: str = "multiplicative",
    dtype=jnp.float32,
    codewords=None,
):
    """Fixed-operating-point wrapper over :func:`make_grid_step`.

    decode_fn(samples [b, N], sigma_scalar, key) -> DecodeResult-like with
    .hard [b, N], .iterations [b], .satisfied [b].

    Returns step(root_key [uint32 key], bits [S, B_global, N]) ->
    BatchCounters, where S = len(sigmas) must equal the mesh "snr" axis size
    and B_global = batch_per_device * mesh.data_size.  Counters are
    bit-identical to the grid step's (same RNG fold order, same ops).
    """
    n_snr = mesh.shape["snr"]
    if len(sigmas) != n_snr:
        raise ValueError(f"need {n_snr} sigmas for the snr axis")
    sigmas_arr = jnp.asarray(list(sigmas), dtype)
    gstep = make_grid_step(
        code,
        lambda y, sigma, key, point: decode_fn(y, sigma, key),
        mesh,
        batch_per_device=batch_per_device,
        max_iterations=max_iterations,
        param_names=(),
        preprocess=(
            None if preprocess is None else (lambda y, point: preprocess(y))
        ),
        awgn_form=awgn_form,
        dtype=dtype,
        codewords=codewords,
    )

    def step(root_key, bits, round_idx=0):
        return gstep(root_key, bits, sigmas_arr, {}, round_idx)

    step.batch_global = gstep.batch_global
    step.bits_global = gstep.bits_global
    step.n_snr = n_snr
    return step
