"""Spectral IR functions — the per-bin HIRT toolbox math.

JAX equivalents of the ``ir_*`` free-function family
(/root/reference/SpectralFunctions.hpp:364-436). All functions operate on *packed*
split spectra (:class:`~hisstools_library.core.types.Split`, N/2 bins, DC in
``re[0]``, Nyquist in ``im[0]``) and are pure/vectorised — the reference's
``real_operation`` DC/Nyquist special-casing (SpectralFunctions.hpp:63-129) becomes
lane-0 handling on the packed planes.

``fft_size`` below always refers to the *full* transform size N (= 2 x bins), as in
the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Split, cmul, cmul_conj, packed_mul, packed_mul_conj
from ..fft import api as fft_api

# Reference floors log-power at -300 dB (SpectralFunctions.hpp:176-184).
_MIN_POWER = 10.0 ** (-300.0 / 10.0)


def _bin_index(nbins: int, dtype) -> jax.Array:
    return jnp.arange(nbins, dtype=dtype)


# -----------------------------------------------------------------------------
# Simple per-bin ops
# -----------------------------------------------------------------------------

def ir_copy(s: Split) -> Split:
    """Identity (reference ir_copy, SpectralFunctions.hpp:364-368)."""
    return Split(s.re, s.im)


def ir_time_reverse(s: Split) -> Split:
    """Complex conjugate = time reversal (SpectralFunctions.hpp:386-389).

    DC/Nyquist are real and pass through unchanged — on the packed layout the
    conjugate of the imag plane must skip lane 0 (the packed Nyquist).
    """
    im = jnp.concatenate([s.im[..., :1], -s.im[..., 1:]], axis=-1)
    return Split(s.re, im)


def ir_spike(nbins: int, fft_size: int, spike_position: float, dtype=jnp.float32) -> Split:
    """Pure-delay spectrum: bin k = e^{-2 pi i k position / N}
    (reference impl::spike, SpectralFunctions.hpp:231-247). The Nyquist lane stores
    cos(theta * N/2); imaginary parts of DC/Nyquist are dropped."""
    theta = -2.0 * math.pi * spike_position / float(fft_size)
    k = np.arange(nbins, dtype=np.float64)
    re = np.cos(theta * k)
    im = np.sin(theta * k)
    im[0] = math.cos(theta * (fft_size >> 1))
    re[0] = 1.0
    return Split(jnp.asarray(re, dtype), jnp.asarray(im, dtype))


def ir_delay(s: Split, fft_size: int, delay: float) -> Split:
    """Per-bin phase rotation by ``delay`` samples (impl::delay_calc,
    SpectralFunctions.hpp:249-263). ``delay == 0`` is a copy."""
    if delay == 0.0:
        return ir_copy(s)
    theta = -2.0 * math.pi * delay / float(fft_size)
    nbins = s.shape[-1]
    k = np.arange(nbins, dtype=np.float64)
    rot = Split(jnp.asarray(np.cos(theta * k), s.dtype), jnp.asarray(np.sin(theta * k), s.dtype))
    out = cmul(s, rot)
    # DC: rotation is identity; Nyquist: multiply by cos(theta * N/2), imag dropped.
    nyq_rot = math.cos(theta * (fft_size >> 1))
    re = jnp.concatenate([s.re[..., :1], out.re[..., 1:]], axis=-1)
    im = jnp.concatenate([s.im[..., :1] * s.dtype.type(nyq_rot), out.im[..., 1:]], axis=-1)
    return Split(re, im)


def _amplitude(s: Split, alternate_sign: bool) -> Split:
    """|X| per bin with optional (-1)^k (impl::amplitude[_linear],
    SpectralFunctions.hpp:149-165). DC/Nyquist amplitudes are |re[0]| / |im[0]|;
    for the alternating variant the Nyquist sign is (-1)^(N/2) = +1 (N/2 even for
    N >= 4 powers of two... the reference indexes the Nyquist functor at i = N/2)."""
    nbins = s.shape[-1]
    mag = jnp.sqrt(s.re * s.re + s.im * s.im)
    dc = jnp.abs(s.re[..., :1])
    nyq = jnp.abs(s.im[..., :1])
    if alternate_sign:
        k = np.arange(nbins)
        signs = jnp.asarray(np.where(k & 1, -1.0, 1.0), s.dtype)
        mag = mag * signs
        # Nyquist functor index is N/2 = nbins: sign = (-1)^nbins
        if nbins & 1:
            nyq = -nyq
    re = jnp.concatenate([dc, mag[..., 1:]], axis=-1)
    im = jnp.concatenate([nyq, jnp.zeros_like(mag[..., 1:])], axis=-1)
    return Split(re, im)


def log_power(s: Split) -> Split:
    """0.5 * log(max(|X|^2, 1e-30)) into the real plane (impl::log_power,
    SpectralFunctions.hpp:176-184); DC/Nyquist use their real packed values."""
    p = s.re * s.re + s.im * s.im
    dc = s.re[..., :1] ** 2
    nyq = s.im[..., :1] ** 2
    body = 0.5 * jnp.log(jnp.maximum(p[..., 1:], s.dtype.type(_MIN_POWER)))
    dc_l = 0.5 * jnp.log(jnp.maximum(dc, s.dtype.type(_MIN_POWER)))
    nyq_l = 0.5 * jnp.log(jnp.maximum(nyq, s.dtype.type(_MIN_POWER)))
    re = jnp.concatenate([dc_l, body], axis=-1)
    im = jnp.concatenate([nyq_l, jnp.zeros_like(body)], axis=-1)
    return Split(re, im)


# -----------------------------------------------------------------------------
# Minimum phase machinery
# -----------------------------------------------------------------------------

def minimum_phase_components(s: Split, fft_size: int, backend: Optional[str] = None) -> Split:
    """Cepstral-domain components C with exp(C) = minimum-phase spectrum.

    Reference impl::minimum_phase_components (SpectralFunctions.hpp:283-336):
    log power spectrum -> inverse real FFT (cepstrum) -> causal fold (doubling
    implicit in the forward rfft's x2 scale; samples 0 and N/2 halved, upper half
    zeroed, all scaled 1/N) -> forward real FFT.
    """
    n = fft_size
    lp = log_power(s)
    cep = fft_api.rifft(lp.re, lp.im, backend=backend)  # length n
    scale = 1.0 / n
    w = np.zeros(n, np.float64)
    w[0] = 0.5 * scale
    w[1:n // 2] = scale
    w[n // 2] = 0.5 * scale
    cep = cep * jnp.asarray(w, cep.dtype)
    re, im = fft_api.rfft(cep, backend=backend)
    return Split(re, im)


def _complex_exponential(c: Split, conjugate: bool) -> Split:
    """exp(re + i im) per bin (impl::complex_exponential[_conjugate],
    SpectralFunctions.hpp:186-204); DC/Nyquist = exp(real packed value)."""
    amp = jnp.exp(c.re)
    sgn = -1.0 if conjugate else 1.0
    re = amp * jnp.cos(c.im)
    im = sgn * amp * jnp.sin(c.im)
    dc = jnp.exp(c.re[..., :1])
    nyq = jnp.exp(c.im[..., :1])
    return Split(
        jnp.concatenate([dc, re[..., 1:]], axis=-1),
        jnp.concatenate([nyq, im[..., 1:]], axis=-1),
    )


def _phase_interpolate(c: Split, fft_size: int, phase: float, zero_center: bool) -> Split:
    """Morph between minimum (phase=0), linear (0.5) and maximum (1.0) phase
    (impl::phase_interpolate, SpectralFunctions.hpp:206-229). Anything over linear
    induces a -1 sample delay to avoid wraparound."""
    delay_factor = 0.0 if phase <= 0.5 else 1.0 / float(fft_size)
    phase = min(1.0, max(0.0, phase))
    min_factor = 1.0 - 2.0 * phase
    lin_factor = 0.0 if zero_center else -2.0 * math.pi * (phase - delay_factor)

    nbins = c.shape[-1]
    k = jnp.asarray(np.arange(nbins, dtype=np.float64), c.dtype)
    amp = jnp.exp(c.re)
    ph = c.dtype.type(lin_factor) * k + c.dtype.type(min_factor) * c.im
    re = amp * jnp.cos(ph)
    im = amp * jnp.sin(ph)
    dc = jnp.exp(c.re[..., :1])  # cos(0) = 1
    nyq_ph = lin_factor * (fft_size >> 1)
    nyq = jnp.exp(c.im[..., :1]) * c.dtype.type(math.cos(nyq_ph))
    return Split(
        jnp.concatenate([dc, re[..., 1:]], axis=-1),
        jnp.concatenate([nyq, im[..., 1:]], axis=-1),
    )


def ir_phase(s: Split, fft_size: int, phase: float, zero_center: bool = False,
             backend: Optional[str] = None) -> Split:
    """Phase manipulation of a packed spectrum (reference ir_phase,
    SpectralFunctions.hpp:391-412): phase 0.5 -> amplitude (linear phase unless
    ``zero_center``); otherwise the minimum-phase cepstral transform followed by
    complex exponential / conjugate / interpolation."""
    if phase == 0.5:
        return _amplitude(s, alternate_sign=not zero_center)
    c = minimum_phase_components(s, fft_size, backend=backend)
    if phase == 1.0 and zero_center:
        return _complex_exponential(c, conjugate=True)
    if phase == 0.0:
        return _complex_exponential(c, conjugate=False)
    return _phase_interpolate(c, fft_size, phase, zero_center)


# -----------------------------------------------------------------------------
# Binary ops (convolution / correlation in frequency domain)
# -----------------------------------------------------------------------------

def ir_convolve_complex(a: Split, b: Split, scale=1.0) -> Split:
    """Per-bin complex multiply with scale (SpectralFunctions.hpp:414-418)."""
    out = cmul(a, b)
    return out * scale if scale != 1.0 else out


def ir_convolve_real(a: Split, b: Split, scale=1.0) -> Split:
    """Packed real-spectrum multiply, DC/Nyquist independent
    (SpectralFunctions.hpp:420-424)."""
    return packed_mul(a, b, scale)


def ir_correlate_complex(a: Split, b: Split, scale=1.0) -> Split:
    """a * conj(b) per bin (SpectralFunctions.hpp:426-430)."""
    out = cmul_conj(a, b)
    return out * scale if scale != 1.0 else out


def ir_correlate_real(a: Split, b: Split, scale=1.0) -> Split:
    """Packed real-spectrum correlation (SpectralFunctions.hpp:432-436)."""
    return packed_mul_conj(a, b, scale)
