"""Windowed STFT analysis and resynthesis.

The reference composes this from its parts — window generation (WindowFunctions),
zip/unzip + rFFT framing (HISSTools_FFT), per-bin spectral ops (SpectralFunctions)
— as HIRT and the plugins do. Here the composition is provided directly, batched
over channels and frames, with the library's packed-spectrum convention so every
``ir_*`` op applies per frame unchanged.

- :func:`stft`  — frame, window, rfft -> packed Split (..., frames, N/2)
- :func:`istft` — rifft, synthesis window, overlap-add with COLA normalisation
  (least-squares inversion: divide by the summed squared window)

When the hop divides the FFT size, framing is m = N/hop shifted hop-block
slices instead of a gather on a (T, N) index map, and overlap-add is m shifted
block adds instead of a scatter-add; XLA fuses the window multiplies into the
producer of the FFT's input and the consumer of its output.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Split
from ..fft import api as fft_api


def num_frames(length: int, fft_size: int, hop: int) -> int:
    return max(0, 1 + (length - fft_size) // hop) if length >= fft_size else 0


def _frame_blocks(x: jax.Array, fft_size: int, hop: int, t: int) -> jax.Array:
    """(..., L) -> (..., T, N) overlapping frames via m shifted hop-block
    slices (requires hop | fft_size and hop | L)."""
    m = fft_size // hop
    lead = x.shape[:-1]
    blocks = x.reshape(*lead, x.shape[-1] // hop, hop)
    return jnp.concatenate([blocks[..., k:k + t, :] for k in range(m)],
                           axis=-1)


def stft(x: jax.Array, window, fft_size: int, hop: int,
         pad: bool = True, boundary: bool = False,
         backend: Optional[str] = None) -> Split:
    """Packed STFT. ``x``: (..., L); ``window``: host or device array of
    ``fft_size`` samples (e.g. ``windows.hann(N-1)`` — N points). With ``pad`` the
    signal is zero-padded so every sample is covered by a whole frame; with
    ``boundary`` it is additionally padded by ``fft_size - hop`` on the left so
    edge samples get full window coverage (pass the same flag to :func:`istft`)."""
    w64 = np.asarray(window, np.float64)[:fft_size]
    w = jnp.asarray(w64, x.dtype)
    L = x.shape[-1]
    if boundary:
        lead_pad = fft_size - hop
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(lead_pad, lead_pad)])
        L = x.shape[-1]
    if pad:
        total = int(np.ceil(max(L - fft_size, 0) / hop)) * hop + fft_size
        if total > L:
            x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, total - L)])
        L = total
    t = num_frames(L, fft_size, hop)
    if fft_size % hop == 0 and L % hop == 0 and t > 0:
        frames = _frame_blocks(x, fft_size, hop, t)
    else:
        starts = np.arange(t) * hop
        idx = starts[:, None] + np.arange(fft_size)[None, :]
        frames = x[..., idx]
    return Split(*fft_api.rfft(frames * w, backend=backend))


def istft(spec: Split, window, hop: int, length: Optional[int] = None,
          boundary: bool = False, backend: Optional[str] = None,
          eps: float = 1e-10) -> jax.Array:
    """Least-squares inverse STFT: synthesis-windowed overlap-add divided by the
    overlapped squared-window envelope (exact for any window/hop with full
    coverage)."""
    bins = spec.shape[-1]
    n = bins * 2
    t = spec.shape[-2]
    w64 = np.asarray(window, np.float64)[:n]
    w = jnp.asarray(w64, spec.dtype)

    frames = fft_api.rifft(spec.re, spec.im, backend=backend) * (0.5 / n)
    frames = frames * w  # synthesis window

    total = (t - 1) * hop + n
    lead = frames.shape[:-2]
    starts = np.arange(t) * hop
    if n % hop == 0:
        # Overlap-add as m shifted block adds: output block b receives
        # frames[b - k][k*hop : (k+1)*hop] for k = 0..m-1.
        m = n // hop
        parts = frames.reshape(lead + (t, m, hop))
        tb = t + m - 1
        pads = [(0, 0)] * len(lead) + [(0, 0), (0, 0)]
        y = jnp.zeros(lead + (tb, hop), frames.dtype)
        for k in range(m):
            y = y + jnp.pad(parts[..., k, :],
                            pads[:-2] + [(k, m - 1 - k), (0, 0)])
        y = y.reshape(lead + (total,))
    else:
        # General hop: scatter-add on a static index map.
        idx = starts[:, None] + np.arange(n)[None, :]  # (T, N)
        y = jnp.zeros(lead + (total,), frames.dtype)
        y = y.at[..., idx.reshape(-1)].add(frames.reshape(lead + (t * n,)))

    # COLA normalisation envelope (host-side, static).
    env = np.zeros(total)
    wsq = w64 * w64
    for s in starts:
        env[s:s + n] += wsq
    env = np.maximum(env, eps)
    y = y / jnp.asarray(env, frames.dtype)
    if boundary:
        lead_pad = n - hop
        y = y[..., lead_pad:]
    if length is not None:
        y = y[..., :length]
    return y


def stft_roundtrip_scale_check() -> Tuple[float, float]:
    """The forward x2 packing and the 0.5/N inverse cancel: documented identity."""
    return 2.0, 0.5
