"""Matrix-multiply FFT backend: DFTs evaluated as dense matrix products.

The reference FFT kernel (/root/reference/HISSTools_FFT/HISSTools_FFT_Core.h) is a
radix-4/radix-2 split-complex in-place pipeline vectorised with CPU SIMD. This
backend instead uses the four-step (Bailey) factorisation, where each step is a
dense matrix multiply against a precomputed DFT matrix with the twiddle multiply
fused by XLA. It is the local core of the mesh-sharded transform
(parallel/fft_sharded.py) and the ``backend="matmul"`` choice of fft/api.py.

For a complex FFT of size N = N1*N2 (both powers of two):

  1. view x as A[n1, n2]            (n = n1*N2 + n2)
  2. B[k1, n2] = sum_n1 A[n1, n2] * W_N1^(n1 k1)        -- matmul over N1
  3. C[k1, n2] = B[k1, n2] * W_N^(k1 n2)                 -- twiddle (elementwise)
  4. D[k1, k2] = sum_n2 C[k1, n2] * W_N2^(n2 k2)        -- matmul over N2
  5. X[k1 + N1*k2] = D[k1, k2]                           -- transpose + reshape

Real transforms use the same half-size complex trick as the reference
(``pass_real_trig_table``, HISSTools_FFT_Core.h:934-988): pack even/odd samples as a
complex signal of size N/2, transform, then recombine with conjugate-symmetric
twiddles. Twiddles and DFT matrices are generated in float64 and cast (the reference
does the same: f64 cos/sin cast to T, HISSTools_FFT_Core.h:437-444).

All arithmetic is split-complex (two real planes) — no complex dtypes touch the
host, and matmuls run with ``Precision.HIGHEST`` so float32 accuracy is preserved.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Sizes at or below this use a single dense DFT matmul; above, four-step recursion.
_DIRECT_MAX = 1024

# Host-precomputed f64-sourced twiddle tables are baked into the jitted program
# as constants. Beyond this many elements per plane (16 MB at f32) they are
# generated in-graph from integer iotas instead, so that no program carries
# hundreds of MB of constants (an m = 2^23 core's dense tables are ~300 MB).
# The in-graph angles use exact int32 products, costing only ~1-2 extra f32
# ulps at the largest sizes.
_TABLE_CONST_MAX_ELEMS = 1 << 22

_PRECISION = jax.lax.Precision.HIGHEST


@lru_cache(maxsize=64)
def _dft_matrix(n: int, dtype_name: str, inverse: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(Fr, Fi) with F[j, k] = exp(-+2i pi j k / n), computed in float64."""
    j = np.arange(n, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(j, j) / float(n)
    sign = 1.0 if inverse else -1.0
    fr = np.cos(ang)
    fi = sign * np.sin(ang)
    return fr.astype(dtype_name), fi.astype(dtype_name)


@lru_cache(maxsize=64)
def _twiddle(n1: int, n2: int, dtype_name: str, inverse: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Four-step twiddle T[k1, n2] = exp(-+2i pi k1 n2 / (n1 n2)) in float64."""
    k1 = np.arange(n1, dtype=np.float64)[:, None]
    m2 = np.arange(n2, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k1 * m2 / float(n1 * n2)
    sign = 1.0 if inverse else -1.0
    return np.cos(ang).astype(dtype_name), (sign * np.sin(ang)).astype(dtype_name)


def _twiddle_graph(n1: int, n2: int, dtype, inverse: bool):
    """Four-step twiddle computed in-graph (no baked constant): the index
    product k1*n2' < n1*n2 <= 2^28 is exact in int32, so the only rounding is
    the int->float conversion and the sin/cos themselves."""
    k1 = jnp.arange(n1, dtype=jnp.int32)[:, None]
    m2 = jnp.arange(n2, dtype=jnp.int32)[None, :]
    idx = (k1 * m2).astype(dtype)
    ang = idx * jnp.asarray(2.0 * np.pi / float(n1 * n2), dtype)
    sign = 1.0 if inverse else -1.0
    return jnp.cos(ang), sign * jnp.sin(ang)


def _twiddle_factors(n1: int, n2: int, dtype, inverse: bool):
    if n1 * n2 <= _TABLE_CONST_MAX_ELEMS:
        twr, twi = _twiddle(n1, n2, jnp.dtype(dtype).name, inverse)
        return jnp.asarray(twr), jnp.asarray(twi)
    return _twiddle_graph(n1, n2, dtype, inverse)


def _split_factors(n: int) -> Tuple[int, int]:
    log2n = n.bit_length() - 1
    n1 = 1 << ((log2n + 1) // 2)
    return n1, n // n1


def _cmatmul(ar, ai, fr, fi):
    """(ar + i ai) @ (fr + i fi) via four real matmuls at HIGHEST precision
    (full f32 products; a TF32 product would keep ~3 decimal digits)."""
    rr = jnp.matmul(ar, fr, precision=_PRECISION)
    ii = jnp.matmul(ai, fi, precision=_PRECISION)
    ri = jnp.matmul(ar, fi, precision=_PRECISION)
    ir = jnp.matmul(ai, fr, precision=_PRECISION)
    return rr - ii, ri + ir


def fft_split(re: jax.Array, im: jax.Array, inverse: bool = False) -> Tuple[jax.Array, jax.Array]:
    """Unscaled complex (i)DFT along the last axis, split layout.

    Forward matches the reference ``hisstools_fft``; inverse is the unscaled
    conjugate transform (N x IDFT), matching ``hisstools_ifft``.
    """
    n = re.shape[-1]
    dt = re.dtype.name
    if n <= _DIRECT_MAX:
        fr, fi = _dft_matrix(n, dt, inverse)
        return _cmatmul(re, im, jnp.asarray(fr), jnp.asarray(fi))

    n1, n2 = _split_factors(n)
    lead = re.shape[:-1]
    ar = re.reshape(*lead, n1, n2)
    ai = im.reshape(*lead, n1, n2)

    # Step 1: DFT over n1 (the second-to-last axis) -> move it last for the matmul.
    # Factors beyond the dense-matrix cap recurse (a 2^14 dense DFT matrix would
    # be a multi-GB baked constant); recursion bounds every dense factor at
    # _DIRECT_MAX so constants stay small at ANY supported size.
    ar_t = jnp.swapaxes(ar, -1, -2)  # (..., n2, n1)
    ai_t = jnp.swapaxes(ai, -1, -2)
    if n1 > _DIRECT_MAX:
        br, bi = fft_split(ar_t, ai_t, inverse)  # (..., n2, k1)
    else:
        f1r, f1i = _dft_matrix(n1, dt, inverse)
        br, bi = _cmatmul(ar_t, ai_t, jnp.asarray(f1r), jnp.asarray(f1i))
    br = jnp.swapaxes(br, -1, -2)  # (..., k1, n2)
    bi = jnp.swapaxes(bi, -1, -2)

    # Step 2: twiddle.
    twr, twi = _twiddle_factors(n1, n2, re.dtype, inverse)
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr

    # Step 3: DFT over n2 (last axis).
    if n2 > _DIRECT_MAX:
        dr, di = fft_split(cr, ci, inverse)  # (..., k1, k2)
    else:
        f2r, f2i = _dft_matrix(n2, dt, inverse)
        dr, di = _cmatmul(cr, ci, jnp.asarray(f2r), jnp.asarray(f2i))

    # Step 4: X[k1 + n1*k2] -> lay out as [k2, k1] then flatten.
    xr = jnp.swapaxes(dr, -1, -2).reshape(*lead, n)
    xi = jnp.swapaxes(di, -1, -2).reshape(*lead, n)
    return xr, xi


@lru_cache(maxsize=64)
def _half_twiddle(m: int, dtype_name: str) -> Tuple[np.ndarray, np.ndarray]:
    """W_N^k = exp(-2 i pi k / N) for k = 0..m-1 where N = 2m (float64 source)."""
    k = np.arange(m, dtype=np.float64)
    ang = np.pi * k / float(m)  # 2 pi k / (2 m)
    return np.cos(ang).astype(dtype_name), (-np.sin(ang)).astype(dtype_name)


def _half_twiddle_factors(m: int, dtype):
    """Half twiddles as device arrays; in-graph beyond the baked-constant cap
    (same remote-compiler body-size rationale as _twiddle_factors)."""
    if m <= _TABLE_CONST_MAX_ELEMS:
        twr, twi = _half_twiddle(m, jnp.dtype(dtype).name)
        return jnp.asarray(twr), jnp.asarray(twi)
    k = jnp.arange(m, dtype=jnp.int32).astype(dtype)
    ang = k * jnp.asarray(np.pi / float(m), dtype)
    return jnp.cos(ang), -jnp.sin(ang)


def rfft_packed(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Real FFT -> packed N/2-bin spectrum with the reference's x2 scale.

    Same decomposition as the reference real path: complex FFT at N/2 over zipped
    even/odd samples, then the real<->complex conversion pass
    (HISSTools_FFT_Core.h:1350-1360 + :934-988).
    """
    n = x.shape[-1]
    m = n // 2
    zr = x[..., 0::2]
    zi = x[..., 1::2]
    Zr, Zi = fft_split(zr, zi, inverse=False)

    # conj(Z[(m - k) % m]) for k = 0..m-1
    Zr_rev = jnp.concatenate([Zr[..., :1], jnp.flip(Zr[..., 1:], axis=-1)], axis=-1)
    Zi_rev = -jnp.concatenate([Zi[..., :1], jnp.flip(Zi[..., 1:], axis=-1)], axis=-1)

    # Even/odd split-spectra: Ze = (Z + conj(Zrev))/2 ; Zo = (Z - conj(Zrev))/(2i)
    ze_r = 0.5 * (Zr + Zr_rev)
    ze_i = 0.5 * (Zi + Zi_rev)
    zo_r = 0.5 * (Zi - Zi_rev)
    zo_i = -0.5 * (Zr - Zr_rev)

    twr, twi = _half_twiddle_factors(m, x.dtype)
    # X[k] = Ze[k] + W^k * Zo[k], packed with x2 scale: P = 2X
    xr = ze_r + (zo_r * twr - zo_i * twi)
    xi = ze_i + (zo_r * twi + zo_i * twr)
    pr = 2.0 * xr
    pi = 2.0 * xi
    # DC and Nyquist: X[0] = ReZ0 + ImZ0, X[m] = ReZ0 - ImZ0 (both real)
    dc = 2.0 * (Zr[..., :1] + Zi[..., :1])
    nyq = 2.0 * (Zr[..., :1] - Zi[..., :1])
    pr = jnp.concatenate([dc, pr[..., 1:]], axis=-1)
    pi = jnp.concatenate([nyq, pi[..., 1:]], axis=-1)
    return pr, pi


def rifft_packed(re: jax.Array, im: jax.Array) -> jax.Array:
    """Inverse of :func:`rfft_packed` with the unscaled convention:
    ``rifft_packed(rfft_packed(x)) == 2 N x``."""
    m = re.shape[-1]

    # Work at the packed scale (X' = 2X): output needs a final factor of 2, because
    # z = IDFT_m(Z) = ifft_unscaled(Z)/m and y = 2N * IDFT_N = 4 * ifft_unscaled/..
    # combined with X' = 2X this reduces to: out = 2 * Re/Im(ifft_unscaled(Z')).
    xr = re
    xi = im
    # conj(X'[m - k]) for k = 0..m-1 (X'[m] = Nyquist = im[0], real)
    xr_rev = jnp.concatenate([im[..., :1], jnp.flip(xr[..., 1:], axis=-1)], axis=-1)
    xi_rev = jnp.concatenate([jnp.zeros_like(im[..., :1]), -jnp.flip(xi[..., 1:], axis=-1)], axis=-1)
    # X'[0] is real (DC): zero the packed Nyquist out of the imag plane
    xr0 = xr
    xi0 = jnp.concatenate([jnp.zeros_like(xi[..., :1]), xi[..., 1:]], axis=-1)

    ze_r = 0.5 * (xr0 + xr_rev)
    ze_i = 0.5 * (xi0 + xi_rev)
    do_r = 0.5 * (xr0 - xr_rev)
    do_i = 0.5 * (xi0 - xi_rev)

    twr, twi = _half_twiddle_factors(m, re.dtype)
    # Zo = conj(W^k) * (X - conj(Xrev))/2 ; conj(W) = (twr, -twi)
    zo_r = do_r * twr + do_i * twi
    zo_i = -do_r * twi + do_i * twr

    # Z = Ze + i Zo
    Zr = ze_r - zo_i
    Zi = ze_i + zo_r

    wr, wi = fft_split(Zr, Zi, inverse=True)  # unscaled inverse (m x IDFT)
    # Interleave: y[2k] = Re, y[2k+1] = Im, final scale 2 (see note above).
    y = jnp.stack([wr, wi], axis=-1).reshape(*re.shape[:-1], m * 2)
    return 2.0 * y
