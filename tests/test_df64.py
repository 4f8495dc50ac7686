"""Double-float (df64) FFT — on-device ~280 dB transforms (fft/df64.py).

Closes the last numeric delta to the reference's float64 overloads
(HISSTools_FFT.h:87-369, ~300 dB round trips) from f32 arithmetic. The
oracle is numpy float64; the df64 result is recombined hi+lo on the host."""

import numpy as np
import pytest

from hisstools_library.fft import df64


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(
        np.sum(ref * ref) / max(d, 1e-300))


def test_selfcheck_compensation_survives_compilation():
    """Catastrophic-cancellation guard: if the compiler folded any TwoSum /
    TwoProd error term the result collapses to f32 (~1e-7)."""
    assert df64.selfcheck() < 1e-10


@pytest.mark.parametrize("n", [16, 256, 4096])
def test_rfft_df64_vs_f64_oracle(rng, n):
    x = rng.standard_normal(n).astype(np.float32)
    re_h, re_l, im_h, im_l = df64.rfft_df64(x)
    re = df64.dd_to_f64(re_h, re_l)
    im = df64.dd_to_f64(im_h, im_l)
    z = np.fft.rfft(x.astype(np.float64))
    ref_re = 2 * z.real
    ref_im = np.concatenate([ref_re[-1:], 2 * z.imag[1:-1]])
    assert snr_db(ref_re[:-1], re) > 180
    assert snr_db(ref_im, im) > 180


@pytest.mark.parametrize("n", [64, 1024, 16384])
def test_rifft_rfft_identity(rng, n):
    """rifft(rfft(x)) == 2N x — the library identity (fft/api.py) at df64
    precision (>=180 dB target; measured ~282-295)."""
    x = rng.standard_normal(n).astype(np.float32)
    y_h, y_l = df64.rifft_df64(*df64.rfft_df64(x))
    y = df64.dd_to_f64(y_h, y_l)
    assert snr_db(2.0 * n * x.astype(np.float64), y) > 180


def test_batched_and_f64_input(rng):
    x = rng.standard_normal((3, 512))  # float64: split hi/lo host-side
    re_h, re_l, im_h, im_l = df64.rfft_df64(x)
    re = df64.dd_to_f64(re_h, re_l)
    z = np.fft.rfft(x)
    assert snr_db(2 * z.real[..., :-1], re) > 180
    y = df64.dd_to_f64(*df64.rifft_df64(re_h, re_l, im_h, im_l))
    assert snr_db(2.0 * 512 * x, y) > 180


def test_fft_df64_complex_and_unscaled_inverse(rng):
    """Complex forward matches np.fft; inverse follows the library's
    UNSCALED convention (N x IDFT, fft/api.ifft)."""
    n = 1024
    re = rng.standard_normal(n).astype(np.float32)
    im = rng.standard_normal(n).astype(np.float32)
    z = np.zeros_like(re)
    fr_h, fr_l, fi_h, fi_l = df64.fft_df64(re, z, im, z)
    ref = np.fft.fft(re.astype(np.float64) + 1j * im.astype(np.float64))
    assert snr_db(ref.real, df64.dd_to_f64(fr_h, fr_l)) > 180
    assert snr_db(ref.imag, df64.dd_to_f64(fi_h, fi_l)) > 180
    br_h, br_l, bi_h, bi_l = df64.fft_df64(fr_h, fr_l, fi_h, fi_l,
                                           inverse=True)
    assert snr_db(n * re.astype(np.float64), df64.dd_to_f64(br_h, br_l)) > 180
    assert snr_db(n * im.astype(np.float64), df64.dd_to_f64(bi_h, bi_l)) > 180


def test_dd_arithmetic_basics():
    a_h, a_l = df64.dd_from_f64(np.array([1.0 / 3.0]))
    b_h, b_l = df64.dd_from_f64(np.array([np.pi]))
    s = df64.dd_to_f64(*df64.dd_add(a_h, a_l, b_h, b_l))
    p = df64.dd_to_f64(*df64.dd_mul(a_h, a_l, b_h, b_l))
    np.testing.assert_allclose(s, 1.0 / 3.0 + np.pi, rtol=1e-14)
    np.testing.assert_allclose(p, np.pi / 3.0, rtol=1e-14)
