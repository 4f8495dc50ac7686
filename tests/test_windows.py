"""Window function tests.

Mirrors the reference Window_Tester (- Test/Window_Tester/Window_Tester/main.cpp):
randomized partial-range == full-range property (check_symmetry, :92-118), symmetry
scans (check_window, :120-145), plus external oracles (scipy) the reference lacks.
"""

import numpy as np
import pytest
import scipy.signal.windows as sw

from hisstools_library.ops import windows
from hisstools_library.ops.windows import Params


def gen64(name, N, begin=0, end=None, params=Params()):
    import jax.numpy as jnp
    return np.asarray(windows.generate(name, N, begin, end, params, dtype=jnp.float64))


def test_hann_matches_scipy():
    N = 1024
    w = gen64("hann", N)
    assert w.shape == (N + 1,)
    ref = sw.hann(N + 1, sym=True)
    assert np.abs(w - ref).max() < 1e-12


def test_blackman_matches_scipy():
    N = 512
    w = gen64("blackman", N)
    ref = sw.blackman(N + 1, sym=True)
    assert np.abs(w - ref).max() < 1e-12


def test_kaiser_matches_scipy():
    N = 777
    beta = 8.5
    w = gen64("kaiser", N, params=Params(a0=beta))
    ref = sw.kaiser(N + 1, beta, sym=True)
    assert np.abs(w - ref).max() < 1e-9


@pytest.mark.parametrize("beta", [30.0, 40.0, 60.0])
def test_kaiser_high_beta_matches_scipy(beta):
    # Round-2 weakness: the fixed 60-term I0 series silently degraded above
    # beta ~ 24. The term count is now derived from beta (reference iterates to
    # epsilon per element, WindowFunctions.hpp:193-207).
    N = 512
    w = gen64("kaiser", N, params=Params(a0=beta))
    ref = sw.kaiser(N + 1, beta, sym=True)
    # Relative error: high-beta tails are ~1e-40, absolute comparison is vacuous.
    assert np.abs(w - ref).max() / ref.max() < 1e-9
    denom = np.maximum(np.abs(ref), 1e-300)
    assert (np.abs(w - ref) / denom).max() < 1e-6


def test_hamming_reference_alpha():
    # The reference deliberately uses 0.54 (not 25/46) — WindowFunctions.hpp:244-250.
    w = gen64("hamming", 100)
    assert abs(w[0] - (0.54 - 0.46)) < 1e-14
    assert abs(w[50] - 1.0) < 1e-14


def test_tukey_matches_scipy():
    N = 400
    alpha = 0.4
    w = gen64("tukey", N, params=Params(a0=alpha))
    ref = sw.tukey(N + 1, alpha, sym=True)
    assert np.abs(w - ref).max() < 1e-12


@pytest.mark.parametrize("name", [n for n in windows.WINDOW_NAMES
                                  if n not in ("trapezoid", "sine_taper")])
def test_symmetry(name):
    # check_window's full symmetry scan (Window_Tester main.cpp:120-145)
    N = 256
    p = Params(a0=0.5, a1=0.75) if name in ("tukey",) else Params(a0=4.0)
    w = gen64(name, N, params=p)
    assert np.abs(w - w[::-1]).max() < 1e-12, f"{name} not symmetric"


@pytest.mark.parametrize("name", ["hann", "kaiser", "blackman_harris_92dB",
                                  "parzen", "triangle", "welch", "sine", "tukey",
                                  "stanford_flat_top", "trapezoid"])
def test_partial_range_matches_full(rng, name):
    # check_symmetry analogue: [begin, end) generation == slice of full generation
    # (Window_Tester main.cpp:92-118), randomized.
    N = 2048
    p = Params(a0=3.0, a1=0.8, exponent=1.0)
    full = gen64(name, N, params=p)
    for _ in range(24):
        begin = int(rng.integers(0, N))
        end = int(rng.integers(begin, N + 2))
        part = gen64(name, N, begin, end, params=p)
        ref = full[begin:min(end, N + 1)]
        assert part.shape == ref.shape
        if ref.size:
            assert np.abs(part - ref).max() < 1e-12


@pytest.mark.parametrize("exponent", [0.5, 1.0, 2.0, 3.0, 4.0, 7.0, 1.7])
def test_exponent_paths(exponent):
    N = 64
    w = gen64("hann", N, params=Params(exponent=exponent))
    base = sw.hann(N + 1, sym=True)
    assert np.abs(w - base ** exponent).max() < 1e-12


def test_indexed_generator():
    gen = windows.indexed_generator()
    idx = gen.names.index("hann")
    import jax.numpy as jnp
    w = np.asarray(gen(idx, 128, dtype=jnp.float64))
    assert np.abs(w - sw.hann(129, sym=True)).max() < 1e-12


def test_sine_taper_rounds_order():
    # a0 is rounded to the nearest integer taper (WindowFunctions.hpp:476-482)
    w1 = gen64("sine_taper", 100, params=Params(a0=2.4))
    w2 = gen64("sine_taper", 100, params=Params(a0=2.0))
    assert np.array_equal(w1, w2)


def test_rect_and_edges():
    w = gen64("rect", 16)
    assert np.all(w == 1.0)
    w = gen64("triangle", 16)
    assert w[0] == 0.0 and w[8] == 1.0 and w[16] == 0.0
