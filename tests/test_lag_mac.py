"""The partition lag MAC (models.partitioned.lag_mac) and the FastFIR
offline engine, against float64 numpy references."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hisstools_library.models import partitioned
from hisstools_library.models.offline import FastFIR, fast_fir, choose_fft_size


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def test_mac_bin0_packing(rng):
    # DC/Nyquist lane must use the two real products, not the complex multiply.
    fft_size = 256
    h = fft_size >> 1
    L = h * 4
    # DC-heavy signal + IR makes bin-0 errors visible.
    x = (np.abs(rng.standard_normal((1, L))) + 1.0).astype(np.float32)
    ir = (np.abs(rng.standard_normal((1, 3 * h))) + 1.0).astype(np.float32)
    spec = partitioned.impulse_spectra(ir, fft_size, offset=h, dtype=jnp.float32)
    y = partitioned.PartitionedConvolve.process_offline(spec, jnp.asarray(x))
    masked = np.zeros_like(ir[0], np.float64)
    masked[h:] = ir[0, h:]
    ref = np.convolve(x[0].astype(np.float64), masked)[:L]
    assert snr_db(ref, np.asarray(y)[0]) > 100


def test_fast_fir_matches_convolve(rng):
    L = 4000
    x = rng.standard_normal(L)
    ir = rng.standard_normal(2500)
    y = fast_fir(jnp.asarray(x), ir, fft_size=1024)
    ref = np.convolve(x, ir)[:L]
    assert snr_db(ref, y) > 180


def test_fast_fir_batched_and_prepared(rng):
    L = 2048
    x = rng.standard_normal((3, L))
    ir = rng.standard_normal((3, 900))
    eng = FastFIR(ir, fft_size=512, dtype=jnp.float64)
    y = np.asarray(eng(jnp.asarray(x)))
    for c in range(3):
        assert snr_db(np.convolve(x[c], ir[c])[:L], y[c]) > 180


def test_fast_fir_short_signal_long_ir(rng):
    # IR longer than the signal
    L = 500
    x = rng.standard_normal(L)
    ir = rng.standard_normal(5000)
    y = fast_fir(jnp.asarray(x), ir, fft_size=2048)
    ref = np.convolve(x, ir)[:L]
    assert snr_db(ref, y) > 180


def test_choose_fft_size_bounds():
    assert choose_fft_size(480000) == 1 << 16  # sweep optimum for 10 s IR
    assert 32 <= choose_fft_size(10) <= 1 << 17
    assert choose_fft_size(10_000_000) == 1 << 17


def lag_mac64(xp_re, xp_im, h_re, h_im, t):
    """float64 numpy lag loop: Y_j = sum_p X[j + P-1-p] * H[p], with the packed
    DC/Nyquist lane (index 0) multiplied as two independent reals."""
    p = h_re.shape[-2]
    acc_re = np.zeros(xp_re.shape[:-2] + (t, xp_re.shape[-1]))
    acc_im = np.zeros_like(acc_re)
    for lag in range(p):
        ar = xp_re[..., p - 1 - lag:p - 1 - lag + t, :]
        ai = xp_im[..., p - 1 - lag:p - 1 - lag + t, :]
        br = h_re[..., lag:lag + 1, :]
        bi = h_im[..., lag:lag + 1, :]
        re = ar * br - ai * bi
        im = ar * bi + ai * br
        re[..., 0] = ar[..., 0] * br[..., 0]
        im[..., 0] = ai[..., 0] * bi[..., 0]
        acc_re += re
        acc_im += im
    return acc_re, acc_im


MAC_SHAPES = [  # (lead, T, P, K)
    ((), 1, 1, 8),
    ((2,), 7, 4, 16),
    ((3,), 1, 59, 32),
    ((2, 3), 5, 15, 64),
    ((1,), 16, 17, 8),
    ((4,), 3, 33, 16),
]


@pytest.mark.parametrize("chunk", [1, 3, partitioned._MAC_CHUNK, 64])
@pytest.mark.parametrize("shape", MAC_SHAPES, ids=str)
def test_lag_mac_matches_numpy_loop(rng, shape, chunk):
    """Every chunking of the MAC (chunk 1: per-lag loop; chunk >= P: one
    static sum; otherwise fori_loop over unrolled chunks plus a static
    remainder) equals the float64 lag loop, DC/Nyquist lane included."""
    lead, t, p, k = shape
    xr, xi = (rng.standard_normal(lead + (t + p, k)) for _ in range(2))
    hr, hi = (rng.standard_normal(lead + (p, k)) for _ in range(2))
    ref_re, ref_im = lag_mac64(xr, xi, hr, hi, t)
    got_re, got_im = partitioned.lag_mac(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(hr), jnp.asarray(hi),
        t, chunk)
    assert got_re.shape == lead + (t, k)
    np.testing.assert_allclose(np.asarray(got_re), ref_re, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(got_im), ref_im, rtol=1e-12,
                               atol=1e-12)
    # f32, the engines' dtype: within f32 rounding of the float64 loop.
    f32 = [jnp.asarray(a, jnp.float32) for a in (xr, xi, hr, hi)]
    r32, i32 = partitioned.lag_mac(*f32, t, chunk)
    assert snr_db(ref_re, r32) > 120 and snr_db(ref_im, i32) > 120


def test_lag_mac_broadcasts_shared_spectra(rng):
    """One IR's spectra (P, K) against a multichannel window (C, T+P, K)."""
    t, p, k = 4, 3, 16
    xr, xi = (rng.standard_normal((2, t + p, k)) for _ in range(2))
    hr, hi = (rng.standard_normal((p, k)) for _ in range(2))
    got = partitioned.lag_mac(jnp.asarray(xr), jnp.asarray(xi),
                              jnp.asarray(hr), jnp.asarray(hi), t)
    ref = lag_mac64(xr, xi, np.broadcast_to(hr, (2, p, k)),
                    np.broadcast_to(hi, (2, p, k)), t)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), r, rtol=1e-12, atol=1e-12)


def conv64(x, ir, length):
    n = 1 << int(np.ceil(np.log2(x.shape[-1] + ir.shape[-1] - 1)))
    y = np.fft.irfft(np.fft.rfft(x, n) * np.fft.rfft(ir, n), n)
    return y[..., :length]


@pytest.mark.parametrize("log2n", range(12, 18))
def test_fast_fir_f32_parity(rng, log2n):
    """FastFIR in f32 at N = 2^12..2^17 (the offline engine's range) against
    a float64 FFT convolution: several partitions, a signal that is not a
    whole number of hops, two channels."""
    n = 1 << log2n
    h = n // 2
    L = 3 * h + 123
    x = rng.standard_normal((2, L)).astype(np.float32)
    ir = (rng.standard_normal((2, 2 * h + 77))
          * np.exp(-np.arange(2 * h + 77) / h)).astype(np.float32)
    y = fast_fir(jnp.asarray(x), ir, fft_size=n)
    assert y.shape == (2, L) and y.dtype == jnp.float32
    assert snr_db(conv64(x, ir, L), y) > 120
