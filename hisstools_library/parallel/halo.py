"""Halo exchange primitives for time-sharded overlap-save convolution.

When the time axis shards into contiguous hop ranges, each device needs state that
lives on its left neighbour:

- the final ``H`` input samples (the ``prev`` block of the first local frame — the
  overlap half of overlap-save), and
- the final ``P`` hop-spectra (the frequency-domain delay line tail feeding the
  partition MAC).

Both are ring shifts along the ``block`` mesh axis — ``ppermute``. This is
the context-parallel halo pattern; the reference's dual staging buffers
(PartitionedConvolve.cpp:304-305) are the single-device degenerate case.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def shift_from_left(x: jax.Array, axis_name: str, fill=0.0, hops: int = 1) -> jax.Array:
    """Each device receives the array of the device ``hops`` to its left; the first
    ``hops`` devices receive ``fill``.

    A single ``ppermute`` step (non-cyclic: zeros encode "no signal before t=0").
    """
    n = jax.lax.axis_size(axis_name)
    if hops >= n:
        return jnp.full_like(x, fill)
    perm = [(i, i + hops) for i in range(n - hops)]
    shifted = jax.lax.ppermute(x, axis_name, perm)
    idx = jax.lax.axis_index(axis_name)
    return jnp.where(idx < hops, jnp.full_like(x, fill), shifted)


def left_halo(x: jax.Array, halo: int, axis: int, axis_name: str) -> jax.Array:
    """Concatenate the left neighbour's trailing ``halo`` slices onto the front of
    ``x`` along ``axis``; the first device gets zeros. Works for halos larger than
    the local extent by chaining ring steps (static count)."""
    local = x.shape[axis]
    n = jax.lax.axis_size(axis_name)
    pieces = []
    remaining = halo
    hops = 1
    # Gather from progressively further-left neighbours until the halo is covered
    # (or the ring is exhausted — beyond device 0 everything is zero history).
    while remaining > 0 and hops <= n - 1:
        take = min(remaining, local)
        tail = jax.lax.slice_in_dim(x, local - take, local, axis=axis)
        pieces.insert(0, shift_from_left(tail, axis_name, hops=hops))
        remaining -= take
        hops += 1
    if remaining > 0:
        pad_shape = list(x.shape)
        pad_shape[axis] = remaining
        pieces.insert(0, jnp.zeros(pad_shape, x.dtype))
    return jnp.concatenate(pieces + [x], axis=axis)
