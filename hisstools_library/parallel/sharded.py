"""Mesh-sharded multichannel partitioned convolution.

The scaling story (SURVEY.md §5): channels shard like data parallelism; the time
axis shards into contiguous hop ranges (sequence parallelism) with halo exchange of
raw input samples between devices. Each partitioned section with FFT size N (hop H = N/2,
P partitions) needs a left halo of ``(P + 1) * H`` input samples — the overlap half
of the first local frame plus the frequency-domain delay-line history — after which
every device computes its output shard entirely locally: batched rFFT over local
hops, lag-MAC against the (replicated) partition spectra, batched riFFT.

The N-to-mono channel reduction (NToMonoConvolve.cpp:35-43) becomes a ``psum`` over
the channel axis (see :func:`n_to_one_offline`).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core.types import Split
from ..fft import api as fft_api
from ..models import mono as mono_mod
from ..models import partitioned as part
from ..models import time_domain as td
from .halo import left_halo
from .mesh import BLOCK_AXIS, CHANNEL_AXIS


def _section_local(spectra: Split, x_local: jax.Array, fft_size: int,
                   backend: Optional[str] = None) -> jax.Array:
    """Local shard of one uniform section's output. ``x_local``: (..., L_loc) with
    L_loc a multiple of the hop. Runs inside shard_map over BLOCK_AXIS."""
    h = fft_size >> 1
    p = spectra.shape[-2]
    lead = x_local.shape[:-1]
    L = x_local.shape[-1]
    t_loc = L // h

    # Halo: (P + 1) hops of raw input history from the left neighbours.
    halo = (p + 1) * h
    x_ext = left_halo(x_local, halo, axis=x_local.ndim - 1, axis_name=BLOCK_AXIS)
    t_ext = t_loc + p
    blocks = x_ext.reshape(*lead, t_ext + 1, h)

    # Frames for local hops tau in [-P, t_loc): frame tau = x[(tau-1)h : (tau+1)h].
    frames = jnp.concatenate([blocks[..., :-1, :], blocks[..., 1:, :]], axis=-1)
    X = Split(*fft_api.rfft(frames, backend=backend))  # (..., t_ext, bins)

    # Y_t = sum_p X_{t-1-p} Hhat_p ; X_{local tau} sits at ext index tau + P,
    # so the P halo rows are exactly the MAC window's history rows.
    acc_re, acc_im = part.lag_mac(X.re, X.im, spectra.re, spectra.im, t_loc)

    y = fft_api.rifft(acc_re, acc_im, backend=backend) * (1.0 / (4.0 * fft_size))
    return y[..., h:].reshape(*lead, L)


def _validate_sharded_shape(mesh: Mesh, scheme: mono_mod.PartitionScheme,
                            x: jax.Array) -> None:
    """Fail early with a clear message instead of a reshape error deep inside
    the per-shard section code."""
    blocks = mesh.shape[BLOCK_AXIS]
    channels = mesh.shape[CHANNEL_AXIS]
    quantum = blocks * (scheme.sizes[-1] >> 1)
    if x.shape[-1] % quantum:
        raise ValueError(
            f"signal length {x.shape[-1]} must be a multiple of "
            f"block-axis x largest hop = {blocks} x {scheme.sizes[-1] >> 1} "
            f"= {quantum}; pad the signal first")
    if x.ndim >= 2 and x.shape[0] % channels:
        raise ValueError(
            f"channel count {x.shape[0]} must be divisible by the channel "
            f"mesh axis ({channels})")


def _head_local(taps: jax.Array, x_local: jax.Array) -> jax.Array:
    """Local shard of the time-domain head output (halo = taps - 1 samples)."""
    t = taps.shape[-1]
    if t == 0:
        return jnp.zeros_like(x_local)
    x_ext = left_halo(x_local, t - 1, axis=x_local.ndim - 1, axis_name=BLOCK_AXIS)
    return td.fir_offline(x_ext, taps)[..., t - 1:]


def _section_local_direct(spec: Split, x_local: jax.Array) -> jax.Array:
    """Small section as a direct FIR over the halo-extended shard
    (taps shared with mono's path; halo = taps - 1 raw samples)."""
    taps = mono_mod.section_taps_from_spectra(spec)
    t_total = taps.shape[-1]
    x_ext = left_halo(x_local, t_total - 1, axis=x_local.ndim - 1,
                      axis_name=BLOCK_AXIS)
    return td.fir_offline(x_ext, taps)[..., t_total - 1:].astype(x_local.dtype)


def _scheme_local(ir: mono_mod.MonoIR, scheme_sizes: Tuple[int, ...],
                  x_local: jax.Array, backend: Optional[str] = None) -> jax.Array:
    out = jnp.zeros_like(x_local)
    if ir.head_taps.shape[-1]:
        out = out + _head_local(ir.head_taps, x_local)
    for spec, fft_size in zip(ir.spectra, scheme_sizes):
        if mono_mod._direct_eligible(fft_size, spec.shape[-2]):
            out = out + _section_local_direct(spec, x_local)
        else:
            out = out + _section_local(spec, x_local, fft_size, backend=backend)
    return out


def scheme_offline_sharded(mesh: Mesh, scheme: mono_mod.PartitionScheme,
                           ir: mono_mod.MonoIR, x: jax.Array,
                           backend: Optional[str] = None) -> jax.Array:
    """Multichannel scheme convolution sharded (channel x block) over the mesh.

    ``x``: (C, L) with C divisible by the channel-axis size and L divisible by
    ``block_size * block-axis size``. IR spectra are replicated (they are shared
    state, like weights under pure data parallelism). Returns y with the same
    sharding as x.
    """
    sizes = tuple(plan.fft_size for plan in scheme.sections())
    _validate_sharded_shape(mesh, scheme, x)
    fn = partial(_scheme_local, scheme_sizes=sizes, backend=backend)

    def local(ir_local, x_local):
        return fn(ir_local, x_local=x_local)

    shard_fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(CHANNEL_AXIS), P(CHANNEL_AXIS, BLOCK_AXIS)),
        out_specs=P(CHANNEL_AXIS, BLOCK_AXIS)
    )
    return shard_fn(ir, x)


def n_to_one_offline(mesh: Mesh, scheme: mono_mod.PartitionScheme,
                     ir: mono_mod.MonoIR, x: jax.Array,
                     backend: Optional[str] = None) -> jax.Array:
    """N-input -> mono pipeline: each input channel convolves with its IR, the
    channel sum reduces with ``psum`` over the channel axis (the sharded analogue
    of NToMonoConvolve's accumulate loop). x: (N, L) -> (L,)."""
    sizes = tuple(plan.fft_size for plan in scheme.sections())
    _validate_sharded_shape(mesh, scheme, x)

    def local(ir_local, x_local):
        y = _scheme_local(ir_local, sizes, x_local, backend=backend)
        return jax.lax.psum(jnp.sum(y, axis=0), CHANNEL_AXIS)

    shard_fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(CHANNEL_AXIS), P(CHANNEL_AXIS, BLOCK_AXIS)),
        out_specs=P(BLOCK_AXIS)
    )
    return shard_fn(ir, x)


def _chan_specs(tree):
    """PartitionSpecs for an IR/state pytree in channel-parallel streaming.

    Invariant: every non-scalar leaf of MonoIR/MonoState/MonoStreamState is
    CHANNEL-MAJOR (leading dim = channels); scalar leaves (ring positions,
    phase/pos counters) replicate. A future leaf that is per-section 1-D
    (no channel dim) would be silently mis-sharded here — keep new state
    leaves channel-major or extend this helper."""
    return jax.tree.map(
        lambda l: P() if jnp.ndim(l) == 0 else P(CHANNEL_AXIS), tree)


def scheme_stream_sharded(mesh: Mesh, ir: mono_mod.MonoIR,
                          state: mono_mod.MonoState, x: jax.Array,
                          backend: Optional[str] = None
                          ) -> Tuple[mono_mod.MonoState, jax.Array]:
    """Channel-data-parallel STREAMING step over the mesh's channel axis.

    The real-time engine is sequential in time by nature, so streaming shards
    only channels: each device advances its channel shard's state through
    mono.process (batched hop advance inside) with no cross-device
    communication at all — the serving-at-scale configuration (C channels
    spread over the channel axis; the block axis is unused here).

    ``ir``/``state``: leading channel dim divisible by the channel-axis size;
    ``x``: (C, L) with L a multiple of the scheme's block size.
    """
    def local(ir_local, state_local, x_local):
        return mono_mod.process(ir_local, state_local, x_local,
                                backend=backend)

    shard_fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(_chan_specs(ir), _chan_specs(state), P(CHANNEL_AXIS)),
        out_specs=(_chan_specs(state), P(CHANNEL_AXIS))
    )
    return shard_fn(ir, state, x)


def scheme_stream_any_sharded(mesh: Mesh, ir: mono_mod.MonoIR,
                              state: mono_mod.MonoStreamState, x: jax.Array,
                              backend: Optional[str] = None
                              ) -> Tuple[mono_mod.MonoStreamState, jax.Array]:
    """Channel-data-parallel SAMPLE-GRANULAR streaming over the mesh.

    The serving-at-scale form of :func:`mono_mod.process_any`: real audio
    callbacks arrive at arbitrary block sizes (the reference's RW-counter main
    loop, PartitionedConvolve.cpp:243-385, exists exactly for this), and each
    device advances its channel shard's sub-hop state — staging windows,
    output stores, hop phase — independently; the per-section ``phase``/``pos``
    counters are scalars and replicate. No cross-device communication.

    ``ir``/``state``: leading channel dim divisible by the channel-axis size;
    ``x``: (C, B) with ANY B >= 1.
    """
    def local(ir_local, state_local, x_local):
        return mono_mod.process_any(ir_local, state_local, x_local,
                                    backend=backend)

    shard_fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(_chan_specs(ir), _chan_specs(state), P(CHANNEL_AXIS)),
        out_specs=(_chan_specs(state), P(CHANNEL_AXIS))
    )
    return shard_fn(ir, state, x)
