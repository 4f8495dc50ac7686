"""Tests for RNG (CMWC parity + distributions) and MemorySwap concurrency."""

import math
import threading
import time

import numpy as np
import pytest
import scipy.stats

from hisstools_library.utils import CMWC, MemorySwap, RandomGenerator, ltqnorm


# -- CMWC ---------------------------------------------------------------------------

def cmwc_oracle_steps(seed_vec, n):
    """Direct big-int reimplementation of the CMWC recurrence for cross-checking."""
    lag, a = 32, 987655670
    state = list(seed_vec)
    inc, carry = lag - 1, 123
    out = []
    for _ in range(n):
        i = (inc + 1) & (lag - 1)
        t = a * state[i] + carry
        c = t >> 32
        x = (t + c) & 0xFFFFFFFF
        if x < c:
            x += 1
            c += 1
        state[i] = (0xFFFFFFFE - x) & 0xFFFFFFFF
        inc, carry = i, c
        out.append(state[i])
    return out


def test_cmwc_matches_recurrence():
    seed = list(range(1, 33))
    g = CMWC(np.array(seed, np.uint64))
    got = [g() for _ in range(200)]
    assert got == cmwc_oracle_steps(seed, 200)


def test_cmwc_deterministic_and_distinct_seeds():
    s1 = CMWC(np.arange(32, dtype=np.uint64))
    s2 = CMWC(np.arange(32, dtype=np.uint64))
    s3 = CMWC(np.arange(1, 33, dtype=np.uint64))
    a = [s1() for _ in range(50)]
    assert a == [s2() for _ in range(50)]
    assert a != [s3() for _ in range(50)]


def test_rand_int_range():
    g = RandomGenerator(seed_vector=np.arange(32, dtype=np.uint64))
    vals = [g.rand_int(10) for _ in range(2000)]
    assert min(vals) == 0 and max(vals) == 10
    vals = [g.rand_int_range(5, 8) for _ in range(200)]
    assert all(5 <= v <= 8 for v in vals)


def test_rand_double_uniformity():
    g = RandomGenerator(seed_vector=np.arange(32, dtype=np.uint64))
    vals = np.array([g.rand_double() for _ in range(5000)])
    assert 0.0 <= vals.min() and vals.max() <= 1.0
    assert abs(vals.mean() - 0.5) < 0.02
    # KS test against uniform should not reject at alpha = 1e-3
    assert scipy.stats.kstest(vals, "uniform").pvalue > 1e-3


def test_gaussians():
    g = RandomGenerator(seed_vector=np.arange(32, dtype=np.uint64))
    vals = np.array([g.rand_gaussian(2.0, 3.0) for _ in range(4000)])
    assert abs(vals.mean() - 2.0) < 0.2
    assert abs(vals.std() - 3.0) < 0.2


def test_ltqnorm_matches_scipy():
    for p in [1e-6, 0.01, 0.2, 0.5, 0.8, 0.99, 1 - 1e-6]:
        assert abs(ltqnorm(p) - scipy.stats.norm.ppf(p)) < 2e-8
    assert ltqnorm(0.0) == -math.inf
    assert ltqnorm(1.0) == math.inf


def test_windowed_gaussian_range():
    g = RandomGenerator(seed_vector=np.arange(32, dtype=np.uint64))
    vals = [g.rand_windowed_gaussian(0.5, 0.2) for _ in range(500)]
    assert all(0.0 <= v <= 1.0 for v in vals)
    assert abs(np.mean(vals) - 0.5) < 0.05


# -- MemorySwap -----------------------------------------------------------------------

def test_attempt_nonblocking_while_held():
    ms = MemorySwap(value=np.zeros(4), size=4)
    h = ms.access()
    assert h.valid()
    h2 = ms.attempt()
    assert not h2.valid()  # audio thread never blocks
    h.release()
    h3 = ms.attempt()
    assert h3.valid() and h3.get_size() == 4
    h3.release()


def test_swap_and_grow():
    freed = []
    ms = MemorySwap(value="old", size=2, free=freed.append)
    with ms.swap("new", 5) as h:
        assert h.get() == "new" and h.get_size() == 5
    assert freed == ["old"]
    with ms.grow(lambda n: f"alloc{n}", 3) as h:
        assert h.get() == "new"  # 5 >= 3: no realloc
    with ms.grow(lambda n: f"alloc{n}", 9) as h:
        assert h.get() == "alloc9" and h.get_size() == 9
    assert freed == ["old", "new"]


def test_loader_vs_audio_thread():
    ms = MemorySwap(value=np.zeros(16), size=16)
    stop = threading.Event()
    misses = [0]
    hits = [0]

    def audio():
        while not stop.is_set():
            h = ms.attempt()
            if h.valid():
                _ = h.get().sum()
                hits[0] += 1
                h.release()
            else:
                misses[0] += 1

    def loader():
        for i in range(50):
            with ms.swap(np.full(16, float(i)), 16):
                time.sleep(0.0002)

    at = threading.Thread(target=audio)
    at.start()
    loader()
    stop.set()
    at.join()
    assert hits[0] > 0  # audio thread made progress
    with ms.access() as h:
        assert h.get()[0] == 49.0


def test_equal_exact_size_semantics():
    """equal() reallocates on ANY size mismatch including shrinks
    (std::not_equal_to, MemorySwap.h:209-212) — the reference's
    MonoConvolve::resize tests `getSize() == length` and would get a stale
    oversized value from grow-only behaviour. grow() only grows
    (std::greater, :204-207)."""
    freed = []
    ms = MemorySwap(value="v8", size=8, free=freed.append)
    with ms.equal(lambda n: f"alloc{n}", 8) as h:
        assert h.get() == "v8" and h.get_size() == 8  # exact: no realloc
    with ms.equal(lambda n: f"alloc{n}", 4) as h:  # shrink: must realloc
        assert h.get() == "alloc4" and h.get_size() == 4
    assert freed == ["v8"]
    with ms.grow(lambda n: f"alloc{n}", 2) as h:  # grow never shrinks
        assert h.get() == "alloc4" and h.get_size() == 4
    with ms.grow(lambda n: f"alloc{n}", 16) as h:
        assert h.get() == "alloc16" and h.get_size() == 16
    # Handle variants under a held lock behave identically
    h = ms.access()
    h.equal(lambda n: f"h{n}", 6)
    assert h.get() == "h6" and h.get_size() == 6
    h.grow(lambda n: f"h{n}", 3)
    assert h.get_size() == 6
    h.release()


def _cache_config():
    import jax
    return jax.config.jax_compilation_cache_dir


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that is the cache and no code sets
    another directory."""
    import jax

    from hisstools_library.utils import profiling
    before = _cache_config()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert profiling.enable_compile_cache() == str(tmp_path)
        assert _cache_config() == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("stale", [None, "HISSTOOLS_JAX_CACHE"])
def test_compile_cache_fixed_path_without_env(monkeypatch, tmp_path, stale):
    """Without it, the cache is the fixed <checkout>/.jax_cache; the old
    HISSTOOLS_JAX_CACHE variable no longer moves it."""
    import os

    import jax

    from hisstools_library.utils import profiling
    before = _cache_config()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    if stale:
        monkeypatch.setenv(stale, str(tmp_path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        got = profiling.enable_compile_cache()
        assert got == os.path.join(root, ".jax_cache")
        assert _cache_config() == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
