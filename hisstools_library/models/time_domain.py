"""Zero-latency time-domain FIR head.

JAX counterpart of ``HISSTools::TimeDomainConvolve``
(/root/reference/HIRT_Multichannel_Convolution/TimeDomainConvolve.cpp). The
reference stores the impulse reversed+padded and runs a SIMD dot product per output
sample over a dual-copy circular input buffer (:100-163); here the same math is one
``lax.conv_general_dilated`` (grouped/depthwise over channels) at HIGHEST precision,
and streaming state is an explicit carry of the last
``taps - 1`` input samples.

The 2044-tap limit (TimeDomainConvolve.cpp:64) is kept as the default maximum for
scheme parity; arbitrary lengths are allowed when used standalone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.errors import ConvolveError, ConvolveException

MAX_TAPS = 2044


def make_taps(ir: np.ndarray, offset: int = 0, length: int = 0,
              max_taps: int = MAX_TAPS) -> np.ndarray:
    """Extract the head taps ``ir[offset : offset + min(len - offset, length or max)]``
    (reference TimeDomainConvolve::set, :69-87). Host-side (numpy)."""
    ir = np.asarray(ir)
    n = ir.shape[-1]
    if n <= offset:
        return np.zeros(ir.shape[:-1] + (0,), ir.dtype)
    take = min(n - offset, length if length else max_taps)
    return ir[..., offset:offset + take]


def _causal_fir(x: jax.Array, h: jax.Array) -> jax.Array:
    """y[n] = sum_j h[j] x[n - j], per leading-dim channel, same length as x.

    ``x``: (..., L); ``h``: (..., T) with identical leading dims (or both 1-D).
    Implemented as a depthwise grouped convolution at HIGHEST precision.
    """
    taps = h.shape[-1]
    if taps == 0:
        return jnp.zeros_like(x)
    lead = x.shape[:-1]
    L = x.shape[-1]
    C = int(np.prod(lead)) if lead else 1
    xr = x.reshape(1, C, L)
    hb = jnp.broadcast_to(h, lead + (taps,)) if lead else h
    hr = jnp.flip(hb, axis=-1).reshape(C, 1, taps)
    y = jax.lax.conv_general_dilated(
        xr, hr,
        window_strides=(1,),
        padding=[(taps - 1, 0)],
        feature_group_count=C,
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return y.reshape(*lead, L)


def fir_offline(x: jax.Array, h: jax.Array) -> jax.Array:
    """Causal FIR of the whole signal: y[n] = sum_j h[j] x[n - j], len(y) == len(x)
    — the streaming engine's steady-state output (no warm-up truncation)."""
    return _causal_fir(x, h)


class TimeDomainConvolve:
    """Streaming FIR head with functional state.

    State is the last ``taps - 1`` input samples; ``process`` is pure and jittable.
    """

    def __init__(self, offset: int = 0, length: int = 0, max_taps: int = MAX_TAPS):
        if length > max_taps:
            raise ConvolveException(ConvolveError.TIME_LENGTH_OUT_OF_RANGE,
                                    f"length {length} > {max_taps}")
        self.offset = offset
        self.length = length
        self.max_taps = max_taps
        self.taps: Optional[jax.Array] = None

    def set(self, ir, dtype=jnp.float32) -> ConvolveError:
        """Load the impulse head (reference :69-87)."""
        ir_np = np.asarray(ir)
        self.taps = jnp.asarray(
            make_taps(ir_np, self.offset, self.length, self.max_taps), dtype)
        too_long = (not self.length) and (ir_np.shape[-1] - self.offset) > self.max_taps
        return ConvolveError.TIME_IMPULSE_TOO_LONG if too_long else ConvolveError.NONE

    def init_state(self, batch_shape=(), dtype=jnp.float32) -> jax.Array:
        taps = int(self.taps.shape[-1]) if self.taps is not None else 1
        return jnp.zeros(batch_shape + (max(taps - 1, 1),), dtype)

    @staticmethod
    def process(taps: jax.Array, state: jax.Array, x: jax.Array
                ) -> Tuple[jax.Array, jax.Array]:
        """One streaming block: returns (new_state, y) with y the causal FIR output.

        ``taps``: (..., T); ``state``: (..., >= T-1) previous input tail;
        ``x``: (..., B).
        """
        t = taps.shape[-1]
        if t == 0:
            return state, jnp.zeros_like(x)
        if t > 1 and state.shape[-1] < t - 1:
            # A state built before set() installed longer taps would silently
            # shorten the output (tail slice under-fills the history window).
            raise ValueError(f"state holds {state.shape[-1]} samples but "
                             f"{t} taps need {t - 1}; rebuild with init_state()"
                             " after set()")
        tail = state[..., -(t - 1):] if t > 1 else state[..., :0]
        ext = jnp.concatenate([tail, x], axis=-1)
        y = _causal_fir(ext, taps)[..., (t - 1):]
        keep = max(t - 1, 1)
        new_state = ext[..., -keep:]
        return new_state, y
