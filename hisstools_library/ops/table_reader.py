"""Table reading with fractional positions, edge behaviours and interpolation.

JAX counterpart of /root/reference/TableReader.hpp. The reference composes
edge behaviour through template adaptors stacked over a fetcher
(TableReader.hpp:46-167) and reads in SIMD batches; here the whole read is one
vectorised gather pipeline: position split (floor/fract), edge index mapping as
closed-form jnp index math, a single ``take`` per interpolation point, then the
polynomial interpolator from :mod:`.interpolation`.

Edge modes (TableReader.hpp:10 + adaptors):

- ``ZeroPad``     out-of-range reads are 0
- ``Extend``      clamp to the edge samples
- ``Wrap``        periodic
- ``Fold``        reflect without repeating the edge samples
- ``Mirror``      reflect repeating the edge samples
- ``Extrapolate`` linear/cubic extrapolation beyond the ends
  (positions are constrained as in the reference adaptor, :130-149)

``bound=True`` additionally clamps positions to [0, limit] before the split
(table_fetcher_bound, :153-167; limit is size-1 except Wrap's size).
"""

from __future__ import annotations

import enum
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .interpolation import (FOUR_POINT, InterpType, cubic_lagrange_interp,
                            linear_interp)


class EdgeMode(enum.Enum):
    ZeroPad = 0
    Extend = 1
    Wrap = 2
    Fold = 3
    Mirror = 4
    Extrapolate = 5


def _edge_indices(idx: jax.Array, size: int, edges: EdgeMode):
    """Map raw indices to in-range table indices; returns (mapped_idx, zero_mask).

    Closed forms reproduce the adaptors in TableReader.hpp:46-167.
    """
    if edges == EdgeMode.ZeroPad:
        valid = (idx >= 0) & (idx < size)
        return jnp.clip(idx, 0, size - 1), ~valid
    if edges == EdgeMode.Extend:
        return jnp.clip(idx, 0, size - 1), None
    if edges == EdgeMode.Wrap:
        return jnp.mod(idx, size), None
    if edges == EdgeMode.Fold:
        fold_size = (size - 1) * 2 if size > 1 else 1
        m = jnp.mod(jnp.abs(idx), fold_size)
        return jnp.where(m > size - 1, fold_size - m, m), None
    if edges == EdgeMode.Mirror:
        m = jnp.mod(jnp.where(idx < 0, -(idx + 1), idx), size * 2)
        return jnp.where(m > size - 1, (size * 2 - 1) - m, m), None
    raise ValueError(edges)


def _extrapolate_ends(table: jax.Array, interp: InterpType):
    """Precompute the extrapolated end values (table_fetcher_extrapolate::prepare,
    TableReader.hpp:130-149)."""
    size = table.shape[-1]
    if size >= 4 and interp not in (InterpType.None_, InterpType.Linear):
        lo = cubic_lagrange_interp(-2.0, table[..., 0], table[..., 1],
                                   table[..., 2], table[..., 3])
        hi = cubic_lagrange_interp(-2.0, table[..., -1], table[..., -2],
                                   table[..., -3], table[..., -4])
    elif size >= 2:
        lo = linear_interp(-1.0, table[..., 0], table[..., 1])
        hi = linear_interp(-1.0, table[..., -1], table[..., -2])
    else:
        lo = hi = table[..., 0] if size > 0 else jnp.zeros(table.shape[:-1], table.dtype)
    return lo, hi


def table_read(table: jax.Array, positions: jax.Array, mul=1.0,
               interp: InterpType = InterpType.Linear,
               edges: EdgeMode = EdgeMode.ZeroPad,
               bound: bool = False,
               scale: float = 1.0) -> jax.Array:
    """Read ``table`` at fractional ``positions`` (reference table_read_edges,
    TableReader.hpp:387-399). ``mul * scale`` multiplies the output (the fetcher's
    scale field, :22-42)."""
    size = table.shape[-1]
    pos = positions
    n_points = 0 if interp == InterpType.None_ else (2 if interp == InterpType.Linear else 4)

    extrapolate = edges == EdgeMode.Extrapolate
    if bound:
        limit = size if edges == EdgeMode.Wrap else size - 1
        pos = jnp.clip(pos, 0, limit)
    if extrapolate:
        # Constrain as the adaptor's split does (:138-143).
        hi = size - (2 if n_points else 1)
        pos_c = jnp.clip(pos, 0, hi)
        idx0 = jnp.floor(pos_c).astype(jnp.int32)
        fract = (pos - idx0.astype(pos.dtype)).astype(table.dtype)
    else:
        idx0 = jnp.floor(pos).astype(jnp.int32)
        fract = (pos - jnp.floor(pos)).astype(table.dtype)

    # End values depend only on (table, interp): computed once, not per tap
    # (cubic fetches 4 offsets; eager callers would redo the ends each time).
    lo_v, hi_v = _extrapolate_ends(table, interp) if extrapolate else (None, None)

    def fetch(offset: int) -> jax.Array:
        idx = idx0 + offset
        if extrapolate:
            inr = jnp.clip(idx, 0, size - 1)
            v = jnp.take(table, inr, axis=-1)
            v = jnp.where(idx < 0, lo_v, v)
            v = jnp.where(idx >= size, hi_v, v)
            return v
        mapped, zero_mask = _edge_indices(idx, size, edges)
        v = jnp.take(table, mapped, axis=-1)
        if zero_mask is not None:
            v = jnp.where(zero_mask, jnp.zeros_like(v), v)
        return v

    if interp == InterpType.None_:
        out = fetch(0)
    elif interp == InterpType.Linear:
        out = linear_interp(fract, fetch(0), fetch(1))
    else:
        out = FOUR_POINT[interp](fract, fetch(-1), fetch(0), fetch(1), fetch(2))

    total = mul * scale
    if isinstance(total, (int, float)) and total == 1.0:
        return out
    return out * jnp.asarray(total, out.dtype)
