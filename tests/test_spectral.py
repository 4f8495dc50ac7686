"""Spectral processor and ir_* tests against independent numpy oracles.

Covers: convolution/correlation with all 5 edge modes (real + complex), phase
manipulation (minimum / linear / maximum / interpolated — the IR_Manipulation_Tester
configurations), delay, spike, time reversal.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from hisstools_library.core.types import Split
from hisstools_library.fft import api as fft_api
from hisstools_library.ops import spectral, spectral_processor as sp

EM = sp.EdgeMode


# -- oracles -------------------------------------------------------------------

def circular_scatter(lin, out_len, shift):
    """out[(i - shift) mod out_len] += lin[i] — oracle for Wrap/WrapCentre."""
    out = np.zeros(out_len, lin.dtype)
    for i, v in enumerate(lin):
        out[(i - shift) % out_len] += v
    return out


def fold_pad(x, fold, repeat):
    off = 0 if repeat else 1
    left = x[off:fold + off][::-1]
    right = x[len(x) - fold - off:len(x) - off][::-1]
    return np.concatenate([left, x, right])


def convolve_oracle(x1, x2, mode):
    lin = np.convolve(x1, x2)
    mn, mx = min(len(x1), len(x2)), max(len(x1), len(x2))
    if mode == EM.Linear:
        return lin
    if mode == EM.Wrap:
        return circular_scatter(lin, mx, 0)
    if mode == EM.WrapCentre:
        return circular_scatter(lin, mx, (mn - 1) >> 1)
    # Fold modes: reflect the larger input's edges, then take the centre
    fold = mn >> 1
    rep = mode == EM.FoldRepeat
    if len(x1) >= len(x2):
        x1 = fold_pad(x1, fold, rep)
    else:
        x2 = fold_pad(x2, fold, rep)
    lin = np.convolve(x1, x2)
    return lin[mn - 1: mn - 1 + mx]


def brute_circular_correlate(x1, x2, fft):
    """circ[m] = sum_n x1[(n+m) % fft] x2[n] computed directly in the time domain
    (the reference correlate functor is X1 * conj(X2): positive lags shift x1
    forward, SpectralFunctions.hpp:265-272)."""
    a = np.zeros(fft)
    b = np.zeros(fft)
    a[: len(x1)] = x1
    b[: len(x2)] = x2
    return np.array([np.dot(np.roll(a, -m), b) for m in range(fft)])


def correlate_oracle(x1, x2, mode):
    """Time-domain (no FFT) oracle reproducing the reference arrangement semantics
    (arrange_correlate, SpectralProcessor.hpp:483-538)."""
    s1, s2 = len(x1), len(x2)
    mn, mx = min(s1, s2), max(s1, s2)
    fold = mn >> 1
    rep = mode == EM.FoldRepeat
    s = sp._OpSizes(s1, s2, mode)
    a, b = np.asarray(x1, float), np.asarray(x2, float)
    if s.fold_mode:
        if s1 >= s2:
            a = fold_pad(a, fold, rep)
        else:
            b = fold_pad(b, fold, rep)
    circ = brute_circular_correlate(a, b, s.fft)
    s2m1 = s2 - 1
    if mode == EM.Linear:
        return np.concatenate([circ[:s1], circ[s.fft - s2m1:] if s2m1 else circ[:0]])
    if mode == EM.Wrap:
        out = np.zeros(mx)
        out[:s1] = circ[:s1]
        if s2m1:
            out[mx - s2m1:] += circ[s.fft - s2m1:]
        return out
    if mode == EM.WrapCentre:
        w1 = (mn - 1) >> 1
        w2 = min(s2m1, mx - w1)
        w3 = s2m1 - w2
        off = 0 if w3 else mx - (s2m1 + w1)
        out = np.zeros(mx)
        out[: s1 - w1] = circ[w1:s1]
        if w1:
            out[mx - w1:] = circ[:w1]
        if w2:
            out[off: off + w2] += circ[s.fft - w2:]
        if w3:
            out[mx - w3:] += circ[s.fft - w2 - w3: s.fft - w2]
        return out
    # Fold / FoldRepeat
    if s1 >= s2:
        return circ[:mx]
    return np.concatenate([circ[:1], circ[s.fft - (mx - 1):]])


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


# -- convolution / correlation --------------------------------------------------

SIZE_PAIRS = [(64, 64), (100, 37), (37, 100), (257, 31), (8, 200)]


@pytest.mark.parametrize("mode", list(EM))
@pytest.mark.parametrize("sizes", SIZE_PAIRS)
def test_convolve_real(rng, mode, sizes):
    n1, n2 = sizes
    x1 = rng.standard_normal(n1)
    x2 = rng.standard_normal(n2)
    out = sp.convolve(jnp.asarray(x1), jnp.asarray(x2), mode)
    ref = convolve_oracle(x1, x2, mode)
    assert out.shape[-1] == sp.convolved_size(n1, n2, mode) == len(ref)
    assert snr_db(ref, out) > 200  # float64 on CPU


@pytest.mark.parametrize("mode", list(EM))
@pytest.mark.parametrize("sizes", SIZE_PAIRS)
def test_correlate_real(rng, mode, sizes):
    n1, n2 = sizes
    x1 = rng.standard_normal(n1)
    x2 = rng.standard_normal(n2)
    out = sp.correlate(jnp.asarray(x1), jnp.asarray(x2), mode)
    ref = correlate_oracle(x1, x2, mode)
    assert out.shape[-1] == len(ref)
    assert snr_db(ref, out) > 200


def test_correlate_orientation():
    """Regression: correlate conjugates the SECOND operand (X1 * conj(X2)).

    With the flipped orientation (conj(X1) * X2) the deep negative lags of a
    longer-first-input correlation are dropped by arrange_correlate and zeros
    are emitted: [-1,-1,0,0,5,-1] instead of [-1,-1,-1,-1,5,-1]."""
    out = np.asarray(sp.correlate(jnp.asarray([1.0, 2.0, 3.0, 4.0, 5.0]),
                                  jnp.asarray([1.0, -1.0]), EM.Linear))
    assert np.allclose(out, [-1.0, -1.0, -1.0, -1.0, 5.0, -1.0], atol=1e-6)


@pytest.mark.parametrize("mode", [EM.Linear, EM.Wrap, EM.WrapCentre])
@pytest.mark.parametrize("sizes", [(64, 64), (100, 37)])
def test_convolve_complex(rng, mode, sizes):
    n1, n2 = sizes
    z1 = rng.standard_normal(n1) + 1j * rng.standard_normal(n1)
    z2 = rng.standard_normal(n2) + 1j * rng.standard_normal(n2)
    out = sp.convolve_complex(Split(jnp.asarray(z1.real), jnp.asarray(z1.imag)),
                              Split(jnp.asarray(z2.real), jnp.asarray(z2.imag)), mode)
    lin = np.convolve(z1, z2)
    mn, mx = min(n1, n2), max(n1, n2)
    if mode == EM.Linear:
        ref = lin
    else:
        shift = 0 if mode == EM.Wrap else (mn - 1) >> 1
        ref = np.array([0j] * mx)
        for i, v in enumerate(lin):
            ref[(i - shift) % mx] += v
    assert snr_db(ref.real, out.re) > 190
    assert snr_db(ref.imag, out.im) > 190


@pytest.mark.parametrize("sizes", [(64, 64), (100, 37)])
def test_correlate_complex_linear(rng, sizes):
    n1, n2 = sizes
    z1 = rng.standard_normal(n1) + 1j * rng.standard_normal(n1)
    z2 = rng.standard_normal(n2) + 1j * rng.standard_normal(n2)
    out = sp.correlate_complex(Split(jnp.asarray(z1.real), jnp.asarray(z1.imag)),
                               Split(jnp.asarray(z2.real), jnp.asarray(z2.imag)),
                               EM.Linear)
    # Reference convention (X1 * conj(X2)): c[m] = sum_n z1[n+m] conj(z2[n])
    full = np.convolve(z1, np.conj(z2[::-1]))
    lag = lambda m: full[m + n2 - 1] if -(n2 - 1) <= m <= n1 - 1 else 0.0
    ref = np.array([lag(m) for m in range(n1)] + [lag(m) for m in range(-(n2 - 1), 0)])
    assert snr_db(ref.real, out.re) > 190
    assert snr_db(ref.imag, out.im) > 190


def test_single_sample_special_case(rng):
    out = sp.convolve(jnp.asarray([2.0]), jnp.asarray([3.0]), EM.Linear)
    assert np.allclose(np.asarray(out), [6.0])


# -- ir_* ops -------------------------------------------------------------------

def test_ir_spike_is_delay():
    n = 256
    s = spectral.ir_spike(n // 2, n, spike_position=10.0, dtype=jnp.float64)
    # A spike spectrum times 1 == spectrum of delta at position 10, textbook scale 1x
    # (the reference builds it unscaled: |bin| = 1).
    re, im = fft_api.unpack_spectrum(Split(s.re * 2.0, s.im * 2.0))
    y = np.fft.irfft(np.asarray(re) + 1j * np.asarray(im), n)
    ref = np.zeros(n)
    ref[10] = 1.0
    assert snr_db(ref, y) > 200


def test_ir_delay_rotates(rng):
    n = 128
    x = rng.standard_normal(n)
    X = Split(*fft_api.rfft(jnp.asarray(x)))
    Y = spectral.ir_delay(X, n, delay=5.0)
    y = np.asarray(fft_api.rifft(Y.re, Y.im)) / (2 * n)
    ref = np.roll(x, 5)
    assert snr_db(ref, y) > 150


def test_ir_time_reverse(rng):
    n = 128
    x = rng.standard_normal(n)
    X = Split(*fft_api.rfft(jnp.asarray(x)))
    Y = spectral.ir_time_reverse(X)
    y = np.asarray(fft_api.rifft(Y.re, Y.im)) / (2 * n)
    # conj spectrum = x[-n mod N] = x[0], x[N-1], ..., x[1]
    ref = np.concatenate([x[:1], x[1:][::-1]])
    assert snr_db(ref, y) > 200


# -- phase manipulation (IR_Manipulation_Tester configurations) ------------------

def minphase_oracle_exp(a, n):
    """h[n] = a^n is minimum phase for |a| < 1."""
    return a ** np.arange(n)


def test_change_phase_linear(rng):
    n = 64
    x = rng.standard_normal(n)
    y = np.asarray(sp.change_phase(jnp.asarray(x), phase=0.5))
    # linear phase == irfft(|X| * (-1)^k), N-point
    X = np.fft.rfft(x, n)
    signs = (-1.0) ** np.arange(n // 2 + 1)
    ref = np.fft.irfft(np.abs(X) * signs, n)
    assert snr_db(ref, y) > 200
    # and it is symmetric about N/2
    assert snr_db(ref, ref[::-1].take(np.arange(-1, n - 1))) > 100


def test_change_phase_zero_centre_amplitude(rng):
    n = 64
    x = rng.standard_normal(n)
    y = np.asarray(sp.change_phase(jnp.asarray(x), phase=0.5, zero_center=True))
    X = np.fft.rfft(x, n)
    ref = np.fft.irfft(np.abs(X), n)
    assert snr_db(ref, y) > 200


def test_change_phase_preserves_magnitude(rng):
    n = 256
    x = rng.standard_normal(n)
    for phase in (0.0, 0.1, 0.5, 0.9, 1.0):
        y = np.asarray(sp.change_phase(jnp.asarray(x), phase=phase))
        # Exact phases preserve magnitude to numerical precision; interpolated
        # (mixed) phases incur slight time-aliasing (the reference's -1 sample
        # delay guard bounds but does not remove it) — ~55-60 dB is inherent.
        bound = 90.0 if phase in (0.0, 0.5, 1.0) else 50.0
        assert snr_db(np.abs(np.fft.rfft(x, n)), np.abs(np.fft.rfft(y))) > bound, phase


def test_minimum_phase_of_minphase_signal_is_identity():
    # An exponential decay is already minimum phase: change_phase(0.0) reproduces it.
    n = 128
    x = minphase_oracle_exp(0.7, n)
    y = np.asarray(sp.change_phase(jnp.asarray(x), phase=0.0))
    assert snr_db(x, y[:n]) > 90
    assert np.abs(y[n:]).max() < 1e-10 if len(y) > n else True


def test_maximum_phase_is_reversed_minimum_phase():
    n = 128
    x = minphase_oracle_exp(0.6, n)
    ymax = np.asarray(sp.change_phase(jnp.asarray(x), phase=1.0, zero_center=True))
    ymin = np.asarray(sp.change_phase(jnp.asarray(x), phase=0.0))
    # max phase = time-reverse of min phase (circularly)
    ref = np.concatenate([ymin[:1], ymin[1:][::-1]])
    assert snr_db(ref, ymax) > 90


def test_change_phase_single_sample():
    y = sp.change_phase(jnp.asarray([3.0]), phase=0.0)
    assert np.allclose(np.asarray(y), [3.0])


def test_ir_convolve_correlate_functions(rng):
    """Direct checks of the ir_* binary functors on packed real spectra and
    split-complex bins (SpectralFunctions.hpp:414-436): time-domain oracles
    through the public FFT, including the packed DC/Nyquist lane."""
    n = 256
    a = rng.standard_normal(n)
    b = rng.standard_normal(n)
    A = Split(*fft_api.rfft(jnp.asarray(a)))
    B = Split(*fft_api.rfft(jnp.asarray(b)))
    # Circular convolution; the gains cancel exactly: packed spectra are
    # 2X each, so the 0.25/n scale gives P = X1X2/n, and rifft(P) =
    # 2n * ifft(P/2) = ifft(X1X2) — the documented real-op scale
    # (SpectralProcessor.hpp:643) under the repo's packed convention.
    C = spectral.ir_convolve_real(A, B, scale=0.25 / n)
    y = np.asarray(fft_api.rifft(C.re, C.im))
    ref = np.real(np.fft.ifft(np.fft.fft(a) * np.fft.fft(b)))
    assert snr_db(ref, y) > 200
    # correlate: c[m] = sum a[(n+m) % N] b[n]  (X1 * conj(X2))
    D = spectral.ir_correlate_real(A, B, scale=0.25 / n)
    y = np.asarray(fft_api.rifft(D.re, D.im))
    ref = np.real(np.fft.ifft(np.fft.fft(a) * np.conj(np.fft.fft(b))))
    assert snr_db(ref, y) > 200
    # complex functors against direct bin math
    z1 = Split(jnp.asarray(rng.standard_normal(8)), jnp.asarray(rng.standard_normal(8)))
    z2 = Split(jnp.asarray(rng.standard_normal(8)), jnp.asarray(rng.standard_normal(8)))
    cc = spectral.ir_convolve_complex(z1, z2, scale=2.0)
    zz = 2.0 * ((np.asarray(z1.re) + 1j * np.asarray(z1.im)) *
                (np.asarray(z2.re) + 1j * np.asarray(z2.im)))
    assert snr_db(zz.real, cc.re) > 200 and snr_db(zz.imag, cc.im) > 200
    rr = spectral.ir_correlate_complex(z1, z2)
    ww = ((np.asarray(z1.re) + 1j * np.asarray(z1.im)) *
          np.conj(np.asarray(z2.re) + 1j * np.asarray(z2.im)))
    assert snr_db(ww.real, rr.re) > 200 and snr_db(ww.imag, rr.im) > 200
