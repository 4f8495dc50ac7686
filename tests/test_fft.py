"""FFT parity tests against numpy float64 oracles.

Mirrors the reference FFT_Tester (- Test/FFT_Tester/FFT_Tester/main.cpp): size sweeps
over all transforms, zip/unzip round-trip exactness, plus convention checks (packing,
scaling) that the reference only documents implicitly through downstream scale
factors.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from hisstools_library import fft

SIZES = [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 1 << 14]
BACKENDS = ["xla", "matmul"]


def packed_oracle(x):
    """Reference packing: 2x spectrum, N/2 bins, Nyquist in im[0] (float64)."""
    X = np.fft.rfft(x, axis=-1)
    re = 2.0 * X.real
    im = 2.0 * X.imag
    im = np.concatenate([re[..., -1:], im[..., 1:-1]], axis=-1)
    return re[..., :-1], im


def snr_db(ref, test):
    err = np.asarray(test, np.float64) - ref
    denom = np.sum(err * err)
    if denom == 0:
        return np.inf
    return 10.0 * np.log10(np.sum(ref * ref) / denom)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", SIZES)
def test_rfft_matches_packed_oracle(rng, backend, n):
    x = rng.standard_normal((3, n)).astype(np.float32)
    re, im = fft.rfft(jnp.asarray(x), backend=backend)
    ore, oim = packed_oracle(x.astype(np.float64))
    scale = np.abs(ore).max()
    assert np.abs(np.asarray(re) - ore).max() / scale < 2e-5
    assert np.abs(np.asarray(im) - oim).max() / scale < 2e-5


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", SIZES)
def test_rfft_rifft_roundtrip_is_2N(rng, backend, n):
    x = rng.standard_normal((2, n)).astype(np.float32)
    re, im = fft.rfft(jnp.asarray(x), backend=backend)
    y = fft.rifft(re, im, backend=backend)
    assert snr_db(2.0 * n * x.astype(np.float64), y) > 100.0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", SIZES)
def test_complex_fft_unscaled(rng, backend, n):
    zr = rng.standard_normal((2, n)).astype(np.float32)
    zi = rng.standard_normal((2, n)).astype(np.float32)
    fr, fi = fft.fft(jnp.asarray(zr), jnp.asarray(zi), backend=backend)
    Z = np.fft.fft(zr.astype(np.float64) + 1j * zi.astype(np.float64), axis=-1)
    scale = np.abs(Z).max()
    assert np.abs(np.asarray(fr) - Z.real).max() / scale < 2e-5
    assert np.abs(np.asarray(fi) - Z.imag).max() / scale < 2e-5


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [8, 256, 4096])
def test_complex_ifft_is_unscaled_inverse(rng, backend, n):
    zr = rng.standard_normal((n,)).astype(np.float32)
    zi = rng.standard_normal((n,)).astype(np.float32)
    fr, fi = fft.fft(jnp.asarray(zr), jnp.asarray(zi), backend=backend)
    gr, gi = fft.ifft(fr, fi, backend=backend)
    # fft then unscaled ifft = N * identity (reference convention: no 1/N anywhere)
    assert snr_db(n * zr.astype(np.float64), gr) > 100.0
    assert snr_db(n * zi.astype(np.float64), gi) > 100.0


def test_zip_unzip_roundtrip_exact(rng):
    # The reference's only hard-FAIL correctness test (FFT_Tester main.cpp:202-250).
    for n in [2, 8, 64, 1024, 1 << 16]:
        x = rng.standard_normal((n,)).astype(np.float32)
        re, im = fft.unzip(jnp.asarray(x))
        y = fft.zip_split(re, im)
        assert np.array_equal(np.asarray(y), x)
        assert np.array_equal(np.asarray(re), x[0::2])
        assert np.array_equal(np.asarray(im), x[1::2])


def test_unzip_zero_pads(rng):
    x = rng.standard_normal((10,)).astype(np.float32)
    re, im = fft.unzip_zero(jnp.asarray(x), 32)
    assert re.shape[-1] == 16 and im.shape[-1] == 16
    assert np.array_equal(np.asarray(re)[:5], x[0::2])
    assert np.all(np.asarray(re)[5:] == 0)
    assert np.all(np.asarray(im)[5:] == 0)


def test_rfft_padded(rng):
    x = rng.standard_normal((100,)).astype(np.float32)
    re, im = fft.rfft_padded(jnp.asarray(x), 256)
    xp = np.zeros(256, np.float64)
    xp[:100] = x
    ore, oim = packed_oracle(xp)
    assert np.abs(np.asarray(re) - ore).max() < 1e-4
    assert np.abs(np.asarray(im) - oim).max() < 1e-4


def test_pack_unpack_spectrum_roundtrip(rng):
    from hisstools_library.core.types import Split
    x = rng.standard_normal((64,)).astype(np.float32)
    re, im = fft.rfft(jnp.asarray(x))
    fr, fi = fft.unpack_spectrum(Split(re, im))
    X = np.fft.rfft(x.astype(np.float64))
    assert np.abs(np.asarray(fr) - X.real).max() < 1e-4
    assert np.abs(np.asarray(fi) - X.imag).max() < 1e-4
    s2 = fft.pack_spectrum(fr, fi)
    assert np.abs(np.asarray(s2.re) - np.asarray(re)).max() < 1e-5


@pytest.mark.parametrize("n", [1 << 16, 1 << 18])
def test_large_sizes_matmul(rng, n):
    # Crash-sweep analogue of FFT_Tester crash_test for large sizes (2^16..2^18).
    x = rng.standard_normal((n,)).astype(np.float32)
    re, im = fft.rfft(jnp.asarray(x), backend="matmul")
    y = fft.rifft(re, im, backend="matmul")
    assert snr_db(2.0 * n * x.astype(np.float64), y) > 90.0


def test_matmul_fft_recursive_factors(rng, monkeypatch):
    """Factors beyond _DIRECT_MAX recurse instead of building dense DFT
    matrices, and twiddles beyond _TABLE_CONST_MAX_ELEMS are generated
    in-graph — both exercised here at a small size by lowering the caps
    (no multi-hundred-MB constant tables at >= 2^23)."""
    from hisstools_library.fft import matmul_fft as mf
    monkeypatch.setattr(mf, "_DIRECT_MAX", 16)
    monkeypatch.setattr(mf, "_TABLE_CONST_MAX_ELEMS", 64)
    n = 4096
    z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    fr, fi = mf.fft_split(jnp.asarray(z.real), jnp.asarray(z.imag))
    ref = np.fft.fft(z)
    assert snr_db(ref.real, fr) > 200.0
    assert snr_db(ref.imag, fi) > 200.0
    wr, wi = mf.fft_split(fr, fi, inverse=True)  # unscaled inverse: n * z
    assert snr_db(n * z.real, wr) > 200.0
    # f32 in-graph tables stay accurate
    fr32, fi32 = mf.fft_split(jnp.asarray(z.real, jnp.float32),
                              jnp.asarray(z.imag, jnp.float32))
    assert snr_db(ref.real, fr32) > 100.0


def test_matmul_rfft_ingraph_half_twiddle(rng, monkeypatch):
    from hisstools_library.fft import matmul_fft as mf
    monkeypatch.setattr(mf, "_TABLE_CONST_MAX_ELEMS", 64)
    n = 1024
    x = rng.standard_normal((n,))
    re, im = mf.rfft_packed(jnp.asarray(x))
    ore, oim = packed_oracle(x)
    assert snr_db(ore, re) > 200.0
    assert snr_db(oim, im) > 200.0
    y = mf.rifft_packed(re, im)
    assert snr_db(2.0 * n * x, y) > 200.0


def test_float64_path(rng):
    # f64 parity path (the reference supports double throughout).
    n = 1024
    x = rng.standard_normal((n,)).astype(np.float64)
    re, im = fft.rfft(jnp.asarray(x))
    ore, oim = packed_oracle(x)
    assert np.abs(np.asarray(re) - ore).max() < 1e-9
    y = fft.rifft(re, im)
    assert snr_db(2.0 * n * x, y) > 200.0


def test_rfft_2pow24_ingraph_twiddles(rng):
    """n=2^24: the core FFT (m=2^23) exceeds _TABLE_CONST_MAX_ELEMS, so the
    four-step twiddles are generated in-graph instead of baked as a >100 MB
    constant. Verifies the int32-iota angle path holds >100 dB at real scale."""
    from hisstools_library.fft import matmul_fft
    n = 1 << 24
    x = rng.standard_normal(n).astype(np.float32)
    re, im = matmul_fft.rfft_packed(jnp.asarray(x))
    ref = np.fft.rfft(x.astype(np.float64))
    pre = 2.0 * ref[: n // 2].real.copy()
    pim = np.concatenate([[2.0 * ref[n // 2].real], 2.0 * ref[1: n // 2].imag])
    assert snr_db(pre, re) > 100.0
    assert snr_db(pim, im) > 100.0
    y = matmul_fft.rifft_packed(re, im)
    assert snr_db(2.0 * n * x.astype(np.float64), y) > 100.0


def test_backend_default_roundtrip():
    """set_default_backend/get_default_backend steer rfft and restore."""
    from hisstools_library.fft import api
    old = api.get_default_backend()
    try:
        api.set_default_backend("matmul")
        chosen = api.get_default_backend()
        assert chosen == "matmul"
        x = jnp.asarray(np.ones(64, np.float32))
        re, im = fft.rfft(x)  # runs through the matmul backend
        assert float(re[0]) == 128.0  # DC lane: 2 * sum(x)
    finally:
        api.set_default_backend(old)


@pytest.mark.parametrize("call", ["rfft", "rifft", "fft", "ifft",
                                  "set_default_backend"])
def test_unknown_backend_raises(call):
    """Only "xla" and "matmul" exist; "pallas" (or any other name) raises
    instead of falling back."""
    x = jnp.zeros((2, 64), jnp.float32)
    fn = {
        "rfft": lambda: fft.rfft(x, backend="pallas"),
        "rifft": lambda: fft.rifft(x[..., :32], x[..., :32],
                                   backend="pallas"),
        "fft": lambda: fft.fft(x, x, backend="pallas"),
        "ifft": lambda: fft.ifft(x, x, backend="pallas"),
        "set_default_backend": lambda: fft.set_default_backend("pallas"),
    }[call]
    with pytest.raises(ValueError, match="unknown FFT backend"):
        fn()


def test_default_backend_is_xla_on_every_platform():
    from hisstools_library.fft import api
    assert api.get_default_backend() is None
    assert api._resolve(None) == "xla"
    assert api._resolve("matmul") == "matmul"


@pytest.mark.parametrize("n", [1 << 15, 1 << 16, 1 << 17, 1 << 18])
def test_xla_f32_large_roundtrip(rng, n):
    """The default path in the engines' dtype at the engines' section and
    offline sizes: f32 forward within the transform floor of the float64
    oracle, and the round trip."""
    x = rng.standard_normal((2, n)).astype(np.float32)
    re, im = fft.rfft(jnp.asarray(x))
    ore, oim = packed_oracle(x.astype(np.float64))
    assert snr_db(ore, re) > 120.0 and snr_db(oim, im) > 120.0
    y = fft.rifft(re, im)
    assert snr_db(2.0 * n * x.astype(np.float64), y) > 120.0
