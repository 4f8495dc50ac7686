"""FFT public API with HISSTools/vDSP-compatible packing and scaling.

This is the JAX counterpart of the reference C API
(/root/reference/HISSTools_FFT/HISSTools_FFT.h:87-369). The reference exposes
create/destroy setup + in-place transforms over split-complex pointers; here the
equivalent surface is a set of pure functions over arrays (split-complex layout,
batched over any leading axes). "Setup" (twiddle tables,
HISSTools_FFT_Core.h:414-448) has no user-facing role — plans/twiddles are cached
per-size inside the matmul backend and baked into the compiled XLA program.

Conventions (bit-compatible with the reference; see SURVEY.md §3.5):

- ``fft(re, im)``      : unscaled DFT of a complex signal.
- ``ifft(re, im)``     : **unscaled** inverse (N x the textbook IDFT), the reference
                         implements this as an FFT with the planes swapped
                         (HISSTools_FFT_Core.h:1341-1346).
- ``rfft(x)``          : real FFT of size N -> N/2 packed bins, scaled **x2** vs the
                         textbook DFT; DC in ``re[0]``, Nyquist packed in ``im[0]``
                         (HISSTools_FFT_Core.h:934-988).
- ``rifft(re, im)``    : unscaled inverse of the packed layout such that
                         ``rifft(rfft(x)) == 2 * N * x``.
- ``zip/unzip``        : interleave <-> split conversions (HISSTools_FFT.h:295-369).

Scale factors downstream therefore match the reference exactly: ``1/(4N)`` in
partitioned convolution (PartitionedConvolve.cpp:232-241), ``0.25/N`` in real
spectral binary ops (SpectralProcessor.hpp:643), ``0.5/N`` in ``change_phase``
(SpectralProcessor.hpp:207).

Backends: ``"xla"`` (the default) lowers to XLA's FFT, which the GPU backend
hands to cuFFT; ``"matmul"`` evaluates the transform as (four-step) DFT matrix
products at ``Precision.HIGHEST`` (:mod:`fft.matmul_fft`), the single-device core
of the mesh-sharded transform (:mod:`parallel.fft_sharded`).

Precision / float64: the reference offers f32 and f64 overloads
(HISSTools_FFT.h:87-369). Both backends accept float64 arrays wherever JAX runs
with ``jax_enable_x64`` (the configuration the test-suite oracles use). The
double-float mode (:mod:`fft.df64` — ``rfft_df64``/``rifft_df64``/``fft_df64``)
carries every value as an (hi, lo) f32 pair through compensated (Dekker)
arithmetic for ~280-295 dB round trips without x64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.types import Split

# Max size parity with the reference: setups up to 2^28 (HISSTools_FFT.h:87-98).
MAX_FFT_SIZE_LOG2 = 28

BACKENDS = ("xla", "matmul")

_DEFAULT_BACKEND: Optional[str] = None  # None = "xla"


def set_default_backend(name: Optional[str]) -> None:
    """Set the process-wide default FFT backend ("xla" or "matmul"), or None
    to restore the default ("xla")."""
    global _DEFAULT_BACKEND
    if name is not None:
        _check_backend(name)
    _DEFAULT_BACKEND = name


def get_default_backend() -> Optional[str]:
    return _DEFAULT_BACKEND


def _check_backend(name: str) -> str:
    if name not in BACKENDS:
        raise ValueError(f"unknown FFT backend {name!r}; expected one of "
                         f"{BACKENDS}")
    return name


def _resolve(backend: Optional[str]) -> str:
    if backend is not None:
        return _check_backend(backend)
    return _DEFAULT_BACKEND or "xla"


def _log2_size(n: int) -> int:
    if n <= 0:
        # bit_length()-1 would be -1 and `1 << -1` raises a bare
        # "negative shift count" before the real message below.
        raise ValueError(f"FFT size must be a positive power of two, got {n}")
    log2n = n.bit_length() - 1
    if (1 << log2n) != n:
        raise ValueError(f"FFT size must be a power of two, got {n}")
    if log2n > MAX_FFT_SIZE_LOG2:
        raise ValueError(f"FFT size 2^{log2n} exceeds max 2^{MAX_FFT_SIZE_LOG2}")
    return log2n


# -----------------------------------------------------------------------------
# Complex transforms (split layout, unscaled like the reference)
# -----------------------------------------------------------------------------

def fft(re: jax.Array, im: jax.Array, backend: Optional[str] = None) -> Tuple[jax.Array, jax.Array]:
    """Unscaled complex DFT along the last axis (reference hisstools_fft)."""
    n = re.shape[-1]
    _log2_size(n)
    if _resolve(backend) == "matmul":
        from . import matmul_fft
        return matmul_fft.fft_split(re, im, inverse=False)
    z = jnp.fft.fft(jax.lax.complex(re, im), axis=-1)
    return jnp.real(z).astype(re.dtype), jnp.imag(z).astype(re.dtype)


def ifft(re: jax.Array, im: jax.Array, backend: Optional[str] = None) -> Tuple[jax.Array, jax.Array]:
    """Unscaled inverse complex DFT (= N x IDFT). Reference hisstools_ifft, which is
    an FFT with real/imag planes swapped (HISSTools_FFT_Core.h:1341-1346)."""
    # DFT(swap(z)) then swap back == N * IDFT(z)
    fr, fi = fft(im, re, backend=backend)
    return fi, fr


# -----------------------------------------------------------------------------
# Real transforms with vDSP packing
# -----------------------------------------------------------------------------

def rfft(x: jax.Array, backend: Optional[str] = None) -> Tuple[jax.Array, jax.Array]:
    """Real FFT of size N -> packed N/2-bin split spectrum (x2 scale, Nyquist in im[0]).

    Equivalent of in-place ``hisstools_rfft`` on pre-zipped data
    (HISSTools_FFT.cpp:123-131). For the out-of-place zero-padding overload use
    :func:`rfft_padded`.
    """
    n = x.shape[-1]
    _log2_size(n)
    if n == 1:
        raise ValueError("rfft requires N >= 2")
    if _resolve(backend) == "matmul":
        from . import matmul_fft
        return matmul_fft.rfft_packed(x)
    z = jnp.fft.rfft(x, axis=-1)  # N/2 + 1 bins
    re = 2.0 * jnp.real(z).astype(x.dtype)
    im = 2.0 * jnp.imag(z).astype(x.dtype)
    # Pack Nyquist (purely real) into im[0]; drop the explicit Nyquist bin.
    im = jnp.concatenate([re[..., -1:], im[..., 1:-1]], axis=-1)
    re = re[..., :-1]
    return re, im


def rfft_padded(x: jax.Array, fft_size: int, backend: Optional[str] = None) -> Tuple[jax.Array, jax.Array]:
    """Zero-pad the signal to ``fft_size`` then :func:`rfft`.

    Equivalent of the out-of-place ``hisstools_rfft`` overload
    (HISSTools_FFT.h:180-208) which zero-pads ``in_length`` samples to the FFT size.
    """
    n = x.shape[-1]
    if n > fft_size:
        x = x[..., :fft_size]
    elif n < fft_size:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, fft_size - n)]
        x = jnp.pad(x, pad)
    return rfft(x, backend=backend)


def rifft(re: jax.Array, im: jax.Array, backend: Optional[str] = None) -> jax.Array:
    """Unscaled inverse of the packed real spectrum: ``rifft(rfft(x)) == 2N x``.

    Reference ``hisstools_rifft`` (HISSTools_FFT.h:244-282). Given packed values
    interpreted as ``Z``, returns ``N * IDFT(unpack(Z))``.
    """
    nbins = re.shape[-1]
    n = nbins * 2
    _log2_size(n)
    if _resolve(backend) == "matmul":
        from . import matmul_fft
        return matmul_fft.rifft_packed(re, im)
    dtype = re.dtype
    dc = re[..., :1]
    nyq = im[..., :1]
    body_re = re[..., 1:]
    body_im = im[..., 1:]
    full_re = jnp.concatenate([dc, body_re, nyq], axis=-1)
    full_im = jnp.concatenate([jnp.zeros_like(dc), body_im, jnp.zeros_like(nyq)], axis=-1)
    z = jax.lax.complex(full_re, full_im)
    # rifft(Z) = N * IDFT_hermitian(Z): numpy irfft includes the 1/N, so multiply by
    # N. Round trip: rfft gives 2X, irfft(2X) = 2x, * N = 2Nx — matching the
    # reference identity rifft(rfft(x)) == 2N x.
    y = jnp.fft.irfft(z, n=n, axis=-1) * float(n)
    return y.astype(dtype)


# -----------------------------------------------------------------------------
# zip / unzip (interleaved <-> split conversions)
# -----------------------------------------------------------------------------

def unzip(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Even samples -> re, odd samples -> im (reference hisstools_unzip,
    HISSTools_FFT.h:333-345). Input length must be even."""
    return x[..., 0::2], x[..., 1::2]


def zip_split(re: jax.Array, im: jax.Array) -> jax.Array:
    """Interleave split planes back to a single array (reference hisstools_zip,
    HISSTools_FFT.h:357-369)."""
    return jnp.stack([re, im], axis=-1).reshape(*re.shape[:-1], re.shape[-1] * 2)


def unzip_zero(x: jax.Array, fft_size: int) -> Tuple[jax.Array, jax.Array]:
    """Unzip ``min(len, fft_size)`` samples into an fft_size/2 split buffer, zero
    padding the remainder (reference hisstools_unzip_zero, HISSTools_FFT.h:295-321;
    core unzip_zero HISSTools_FFT_Core.h:1258-1287). Handles odd input lengths by
    zeroing the dangling imaginary slot."""
    n = x.shape[-1]
    take = min(n, fft_size)
    x = x[..., :take]
    if take < fft_size:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, fft_size - take)]
        x = jnp.pad(x, pad)
    return unzip(x)


# -----------------------------------------------------------------------------
# Convenience: packed <-> standard complex-bin conversion helpers
# -----------------------------------------------------------------------------

def pack_spectrum(re_full: jax.Array, im_full: jax.Array) -> Split:
    """(N/2+1)-bin textbook spectrum -> packed N/2-bin Split with the 2x scale."""
    re = 2.0 * re_full
    im = 2.0 * im_full
    im = jnp.concatenate([re[..., -1:], im[..., 1:-1]], axis=-1)
    return Split(re[..., :-1], im)


def unpack_spectrum(s: Split) -> Tuple[jax.Array, jax.Array]:
    """Packed N/2-bin Split -> (N/2+1)-bin textbook spectrum (undo the 2x scale)."""
    dc = s.re[..., :1]
    nyq = s.im[..., :1]
    re = jnp.concatenate([dc, s.re[..., 1:], nyq], axis=-1) * 0.5
    zeros = jnp.zeros_like(dc)
    im = jnp.concatenate([zeros, s.im[..., 1:], zeros], axis=-1) * 0.5
    return re, im
