"""FFT-based convolution / correlation of arbitrary-length signals with edge modes.

JAX equivalent of ``spectral_processor<T>``
(/root/reference/SpectralProcessor.hpp:12-682). The reference manages setups and
scratch allocations; here every operation is a pure function — sizes are static
Python ints (from array shapes), so the edge-mode "arrange" scatter logic
(SpectralProcessor.hpp:445-538) compiles to static slices and adds.

Supports all five edge modes (SpectralProcessor.hpp:23):

- ``Linear``     : full linear result, length ``s1 + s2 - 1``
- ``Wrap``       : circular result, length ``max``; tail wraps to the head
- ``WrapCentre`` : circular with the wrap centred
- ``Fold``       : the larger input's edges are reflected (no repeat of the edge
                   sample) before convolving; output length ``max``
- ``FoldRepeat`` : as Fold but the edge sample repeats

Scaling matches the reference exactly: real path ``0.25/N``
(SpectralProcessor.hpp:643), complex path ``1/N`` (:573), ``change_phase``
``0.5/N`` (:207).
"""

from __future__ import annotations

import enum
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Split
from ..fft import api as fft_api
from . import spectral


class EdgeMode(enum.Enum):
    Linear = 0
    Wrap = 1
    WrapCentre = 2
    Fold = 3
    FoldRepeat = 4


def calc_fft_size_log2(size: int) -> int:
    """Ceiling log2 (reference SpectralProcessor.hpp:230-241)."""
    if size <= 0:
        return 0
    return (size - 1).bit_length() if size > 1 else 0


class _OpSizes:
    """Size bookkeeping for a binary op (reference op_sizes,
    SpectralProcessor.hpp:323-354)."""

    def __init__(self, size1: int, size2: int, mode: EdgeMode):
        self.mode = mode
        self.size1 = size1
        self.size2 = size2
        self.min = min(size1, size2)
        self.max = max(size1, size2)
        self.linear = size1 + size2 - 1
        self.fold_copy = self.max + ((self.min >> 1) << 1)
        calc = self.linear if not self.fold_mode else self.fold_copy + self.min - 1
        self.fft_log2 = calc_fft_size_log2(calc)
        self.fft = 1 << self.fft_log2

    @property
    def fold_mode(self) -> bool:
        return self.mode in (EdgeMode.Fold, EdgeMode.FoldRepeat)


def convolved_size(size1: int, size2: int, mode: EdgeMode) -> int:
    """Output length of :func:`convolve` (reference calc_conv_corr_size,
    SpectralProcessor.hpp:546-557)."""
    if not size1 or not size2:
        return 0
    s = _OpSizes(size1, size2, mode)
    return s.linear if mode == EdgeMode.Linear else s.max


correlated_size = convolved_size


def required_fft_size(size1: int, size2: int) -> int:
    if not size1 or not size2:
        return 0
    return _OpSizes(size1, size2, EdgeMode.Linear).fft


# -----------------------------------------------------------------------------
# Folding edge preparation
# -----------------------------------------------------------------------------

def _fold_pad(x: jax.Array, fold_size: int, repeat: bool) -> jax.Array:
    """Reflect ``fold_size`` samples of each edge around the signal (reference
    fold/copy_fold, SpectralProcessor.hpp:358-372). ``repeat`` includes the edge
    sample itself in the reflection."""
    if fold_size == 0:
        return x
    off = 0 if repeat else 1
    left = jnp.flip(x[..., off:fold_size + off], axis=-1)
    n = x.shape[-1]
    right = jnp.flip(x[..., n - fold_size - off:n - off], axis=-1)
    return jnp.concatenate([left, x, right], axis=-1)


# -----------------------------------------------------------------------------
# Arrange: scatter the circular result into the requested edge layout
# -----------------------------------------------------------------------------

def _arrange_convolve(full: jax.Array, s: _OpSizes) -> jax.Array:
    """Reference arrange_convolve (SpectralProcessor.hpp:445-481)."""
    min_m1 = s.min - 1
    if s.mode == EdgeMode.Linear:
        return full[..., : s.linear]
    if s.mode == EdgeMode.Wrap:
        out = full[..., : s.max]
        return out.at[..., :min_m1].add(full[..., s.max : s.linear])
    if s.mode == EdgeMode.WrapCentre:
        wrapped = min_m1 >> 1
        out = full[..., wrapped : wrapped + s.max]
        out = out.at[..., : min_m1 - wrapped].add(full[..., s.max + wrapped : s.linear])
        out = out.at[..., s.max - wrapped : s.max].add(full[..., :wrapped])
        return out
    # Fold / FoldRepeat
    return full[..., min_m1 : min_m1 + s.max]


def _arrange_correlate(full: jax.Array, s: _OpSizes) -> jax.Array:
    """Reference arrange_correlate (SpectralProcessor.hpp:483-538)."""
    s2m1 = s.size2 - 1
    fft = s.fft
    if s.mode == EdgeMode.Linear:
        head = full[..., : s.size1]
        tail = full[..., fft - s2m1 : fft] if s2m1 else head[..., :0]
        return jnp.concatenate([head, tail], axis=-1)
    if s.mode == EdgeMode.Wrap:
        head = full[..., : s.size1]
        if s.size2 > s.size1:
            zeros = jnp.zeros_like(full[..., : s.size2 - s.size1])
            out = jnp.concatenate([head, zeros], axis=-1)
        else:
            out = head[..., : s.max]
        if s2m1:
            out = out.at[..., s.max - s2m1 : s.max].add(full[..., fft - s2m1 : fft])
        return out
    if s.mode == EdgeMode.WrapCentre:
        wrapped1 = (s.min - 1) >> 1
        wrapped2 = min(s2m1, s.max - wrapped1)
        wrapped3 = s2m1 - wrapped2
        offset = 0 if wrapped3 else s.max - (s2m1 + wrapped1)
        out = jnp.zeros(full.shape[:-1] + (s.max,), full.dtype)
        out = out.at[..., : s.size1 - wrapped1].set(full[..., wrapped1 : s.size1])
        if wrapped1:
            out = out.at[..., s.max - wrapped1 : s.max].set(full[..., :wrapped1])
        if wrapped2:
            out = out.at[..., offset : offset + wrapped2].add(full[..., fft - wrapped2 : fft])
        if wrapped3:
            out = out.at[..., s.max - wrapped3 : s.max].add(
                full[..., fft - wrapped2 - wrapped3 : fft - wrapped2])
        return out
    # Fold / FoldRepeat
    if s.size1 >= s.size2:
        return full[..., : s.max]
    head = full[..., :1]
    tail = full[..., fft - (s.max - 1) : fft]
    return jnp.concatenate([head, tail], axis=-1)


# -----------------------------------------------------------------------------
# Real binary ops
# -----------------------------------------------------------------------------

def _binary_op_real(x1: jax.Array, x2: jax.Array, mode: EdgeMode, correlate_op: bool,
                    backend: Optional[str]) -> jax.Array:
    n1 = x1.shape[-1]
    n2 = x2.shape[-1]
    if convolved_size(n1, n2, mode) == 0:
        return jnp.zeros(x1.shape[:-1] + (0,), x1.dtype)
    if n1 == 1 and n2 == 1:
        return x1 * x2

    s = _OpSizes(n1, n2, mode)
    if s.fold_mode:
        fold_size = s.min >> 1
        repeat = mode == EdgeMode.FoldRepeat
        if n1 >= n2:
            x1 = _fold_pad(x1, fold_size, repeat)
        else:
            x2 = _fold_pad(x2, fold_size, repeat)

    X1 = Split(*fft_api.rfft_padded(x1, s.fft, backend=backend))
    X2 = Split(*fft_api.rfft_padded(x2, s.fft, backend=backend))
    scale = 0.25 / s.fft
    if correlate_op:
        P = spectral.ir_correlate_real(X1, X2, scale)
    else:
        P = spectral.ir_convolve_real(X1, X2, scale)
    full = fft_api.rifft(P.re, P.im, backend=backend)
    arrange = _arrange_correlate if correlate_op else _arrange_convolve
    return arrange(full, s)


def convolve(x1: jax.Array, x2: jax.Array, mode: EdgeMode = EdgeMode.Linear,
             backend: Optional[str] = None) -> jax.Array:
    """FFT convolution of real signals with edge handling
    (reference spectral_processor::convolve, SpectralProcessor.hpp:169-172)."""
    return _binary_op_real(x1, x2, mode, correlate_op=False, backend=backend)


def correlate(x1: jax.Array, x2: jax.Array, mode: EdgeMode = EdgeMode.Linear,
              backend: Optional[str] = None) -> jax.Array:
    """FFT cross-correlation c[m] = sum_n x1[n+m] x2[n] of real signals —
    the reference convention X1 * conj(X2) (spectral_processor::correlate,
    SpectralProcessor.hpp:181-184; correlate functor :265-272)."""
    return _binary_op_real(x1, x2, mode, correlate_op=True, backend=backend)


# -----------------------------------------------------------------------------
# Complex binary ops
# -----------------------------------------------------------------------------

def _pad_to(x: jax.Array, n: int) -> jax.Array:
    cur = x.shape[-1]
    if cur == n:
        return x
    if cur > n:
        return x[..., :n]
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - cur)])


def _binary_op_complex(z1: Split, z2: Split, mode: EdgeMode, correlate_op: bool,
                       backend: Optional[str]) -> Split:
    n1 = max(z1.re.shape[-1], z1.im.shape[-1])
    n2 = max(z2.re.shape[-1], z2.im.shape[-1])
    if convolved_size(n1, n2, mode) == 0:
        empty = jnp.zeros(z1.re.shape[:-1] + (0,), z1.dtype)
        return Split(empty, empty)
    if n1 == 1 and n2 == 1:
        from ..core.types import cmul, cmul_conj
        return (cmul_conj if correlate_op else cmul)(z1, z2)

    s = _OpSizes(n1, n2, mode)
    r1, i1 = _pad_to(z1.re, n1), _pad_to(z1.im, n1)
    r2, i2 = _pad_to(z2.re, n2), _pad_to(z2.im, n2)
    if s.fold_mode:
        fold_size = s.min >> 1
        repeat = mode == EdgeMode.FoldRepeat
        if n1 >= n2:
            r1 = _fold_pad(r1, fold_size, repeat)
            i1 = _fold_pad(i1, fold_size, repeat)
        else:
            r2 = _fold_pad(r2, fold_size, repeat)
            i2 = _fold_pad(i2, fold_size, repeat)

    fr1, fi1 = fft_api.fft(_pad_to(r1, s.fft), _pad_to(i1, s.fft), backend=backend)
    fr2, fi2 = fft_api.fft(_pad_to(r2, s.fft), _pad_to(i2, s.fft), backend=backend)
    scale = 1.0 / s.fft
    if correlate_op:
        P = spectral.ir_correlate_complex(Split(fr1, fi1), Split(fr2, fi2), scale)
    else:
        P = spectral.ir_convolve_complex(Split(fr1, fi1), Split(fr2, fi2), scale)
    gr, gi = fft_api.ifft(P.re, P.im, backend=backend)
    # Unscaled inverse == N * IDFT, and scale folded above gives the circular result.
    arrange = _arrange_correlate if correlate_op else _arrange_convolve
    return Split(arrange(gr, s), arrange(gi, s))


def convolve_complex(z1: Split, z2: Split, mode: EdgeMode = EdgeMode.Linear,
                     backend: Optional[str] = None) -> Split:
    """Complex-signal convolution (reference SpectralProcessor.hpp:164-167)."""
    return _binary_op_complex(z1, z2, mode, correlate_op=False, backend=backend)


def correlate_complex(z1: Split, z2: Split, mode: EdgeMode = EdgeMode.Linear,
                      backend: Optional[str] = None) -> Split:
    """Complex-signal correlation (reference SpectralProcessor.hpp:176-179)."""
    return _binary_op_complex(z1, z2, mode, correlate_op=True, backend=backend)


# -----------------------------------------------------------------------------
# Phase manipulation
# -----------------------------------------------------------------------------

def change_phase(x: jax.Array, phase: float, time_multiplier: float = 1.0,
                 zero_center: bool = False, backend: Optional[str] = None) -> jax.Array:
    """Convert a signal to minimum/linear/maximum/mixed phase.

    Reference spectral_processor::change_phase (SpectralProcessor.hpp:188-208):
    rfft (zero-padded to ``next_pow2(round(size * time_multiplier))``) -> ir_phase ->
    rifft scaled by ``0.5/N``. Returns the full FFT-size signal.
    """
    size = x.shape[-1]
    if size == 1:
        return x
    fft_log2 = calc_fft_size_log2(int(round(size * time_multiplier)))
    n = 1 << fft_log2
    X = Split(*fft_api.rfft_padded(x, n, backend=backend))
    Y = spectral.ir_phase(X, n, phase, zero_center, backend=backend)
    y = fft_api.rifft(Y.re, Y.im, backend=backend)
    return y * x.dtype.type(0.5 / n)
