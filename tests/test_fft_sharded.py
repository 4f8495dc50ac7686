"""Mesh-sharded four-step FFT (parallel/fft_sharded.py).

Oracle: numpy float64 FFT. The distributed transform must match the
single-chip path bitwise-closely (same f64-sourced tables, same matmul core),
stay sharded end-to-end (contiguous chunks in and out), and be invariant to
the mesh factorisation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from hisstools_library.fft import api as fft_api
from hisstools_library.parallel import mesh as mesh_mod
from hisstools_library.parallel.fft_sharded import (
    convolve_sharded, fft_sharded, real_sharded_eligible, rfft_sharded,
    rifft_sharded, sharded_eligible)


def _mesh(d):
    return mesh_mod.make_mesh(channel=1, block=d)


def _put(mesh, x):
    return jax.device_put(jnp.asarray(x),
                          NamedSharding(mesh, P(mesh_mod.BLOCK_AXIS)))


@pytest.mark.parametrize("n", [1 << 10, 1 << 13, 1 << 16])
def test_forward_matches_numpy_f64(n, rng):
    mesh = _mesh(8)
    xr = rng.standard_normal(n)
    xi = rng.standard_normal(n)
    fr, fi = jax.jit(lambda a, b: fft_sharded(mesh, a, b))(
        _put(mesh, xr), _put(mesh, xi))
    ref = np.fft.fft(xr + 1j * xi)
    got = np.asarray(fr) + 1j * np.asarray(fi)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 1e-12


def test_inverse_roundtrip_and_scaling(rng):
    """ifft(fft(x)) == N * x (unscaled pair, fft/api.fft conventions)."""
    n = 1 << 12
    mesh = _mesh(8)
    xr = rng.standard_normal(n)
    xi = rng.standard_normal(n)
    fr, fi = jax.jit(lambda a, b: fft_sharded(mesh, a, b))(
        _put(mesh, xr), _put(mesh, xi))
    br, bi = jax.jit(lambda a, b: fft_sharded(mesh, a, b, inverse=True))(
        fr, fi)
    np.testing.assert_allclose(np.asarray(br) / n, xr, atol=1e-12)
    np.testing.assert_allclose(np.asarray(bi) / n, xi, atol=1e-12)


def test_matches_single_chip_path(rng):
    """Same tables, same core: sharded == fft_api.fft to f32 roundoff."""
    n = 1 << 14
    mesh = _mesh(8)
    xr = rng.standard_normal(n).astype(np.float32)
    xi = rng.standard_normal(n).astype(np.float32)
    fr, fi = jax.jit(lambda a, b: fft_sharded(mesh, a, b))(
        _put(mesh, xr), _put(mesh, xi))
    rr, ri = fft_api.fft(jnp.asarray(xr), jnp.asarray(xi), backend="matmul")
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    got = np.asarray(fr) + 1j * np.asarray(fi)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 1e-5


def test_output_stays_sharded(rng):
    n = 1 << 12
    mesh = _mesh(8)
    fr, fi = jax.jit(lambda a, b: fft_sharded(mesh, a, b))(
        _put(mesh, rng.standard_normal(n)), _put(mesh, rng.standard_normal(n)))
    assert len(fr.sharding.device_set) == 8
    # contiguous-chunk layout: each shard holds n/8 consecutive elements
    shard = next(iter(fr.addressable_shards))
    assert shard.data.shape == (n // 8,)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_mesh_size_invariance(d, rng):
    n = 1 << 12
    xr = rng.standard_normal(n)
    xi = rng.standard_normal(n)
    mesh = _mesh(d)
    fr, fi = jax.jit(lambda a, b: fft_sharded(mesh, a, b))(
        _put(mesh, xr), _put(mesh, xi))
    ref = np.fft.fft(xr + 1j * xi)
    got = np.asarray(fr) + 1j * np.asarray(fi)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-12


def test_single_device_fallback(rng):
    n = 256
    mesh = _mesh(1)
    xr = rng.standard_normal(n)
    xi = rng.standard_normal(n)
    fr, fi = fft_sharded(mesh, jnp.asarray(xr), jnp.asarray(xi))
    ref = np.fft.fft(xr + 1j * xi)
    assert np.linalg.norm((np.asarray(fr) + 1j * np.asarray(fi)) - ref) \
        / np.linalg.norm(ref) < 1e-12


@pytest.mark.parametrize("n", [1 << 8, 1 << 12, 1 << 15])
def test_rfft_sharded_matches_packed_api(n, rng):
    """Packed layout parity (DC in re[0], Nyquist in im[0], x2 forward)."""
    mesh = _mesh(8)
    x = rng.standard_normal(n)
    pr, pi = jax.jit(lambda a: rfft_sharded(mesh, a))(_put(mesh, x))
    rr, ri = fft_api.rfft(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(pr), np.asarray(rr),
                               atol=1e-10 * n)
    np.testing.assert_allclose(np.asarray(pi), np.asarray(ri),
                               atol=1e-10 * n)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_rifft_roundtrip_2n_scaling(d, rng):
    """rifft_sharded(rfft_sharded(x)) == 2 N x — the package-wide packed
    convention every downstream scale factor depends on."""
    n = 1 << 12
    mesh = _mesh(d)
    x = rng.standard_normal(n)
    pr, pi = jax.jit(lambda a: rfft_sharded(mesh, a))(_put(mesh, x))
    y = jax.jit(lambda a, b: rifft_sharded(mesh, a, b))(pr, pi)
    np.testing.assert_allclose(np.asarray(y) / (2 * n), x, atol=1e-12)


def test_rfft_sharded_f32_snr(rng):
    n = 1 << 14
    mesh = _mesh(8)
    x = rng.standard_normal(n).astype(np.float32)
    pr, pi = jax.jit(lambda a: rfft_sharded(mesh, a))(_put(mesh, x))
    rr, ri = fft_api.rfft(jnp.asarray(x).astype(jnp.float64))
    ref = np.concatenate([np.asarray(rr), np.asarray(ri)])
    got = np.concatenate([np.asarray(pr), np.asarray(pi)]).astype(np.float64)
    snr = 10 * np.log10((ref ** 2).sum() / ((got - ref) ** 2).sum())
    assert snr > 110, snr


@pytest.mark.parametrize("d", [1, 4, 8])
def test_convolve_sharded_matches_np(d, rng):
    """Distributed spectral convolution vs np.convolve (full linear)."""
    mesh = _mesh(d)
    x = rng.standard_normal(20000)
    h = rng.standard_normal(3000)
    y = jax.jit(lambda a, b: convolve_sharded(mesh, a, b))(
        jnp.asarray(x), jnp.asarray(h))
    ref = np.convolve(x, h)
    assert y.shape == ref.shape
    assert np.abs(np.asarray(y) - ref).max() / np.abs(ref).max() < 1e-11


def test_eligibility():
    assert sharded_eligible(1 << 12, 8)
    assert not sharded_eligible(1 << 12, 3)      # non-pow2 devices
    assert not sharded_eligible((1 << 12) + 4, 8)  # non-pow2 size
    assert not sharded_eligible(1 << 5, 8)       # n2 < d
    assert real_sharded_eligible(1 << 12, 8)
    assert not real_sharded_eligible(1 << 5, 8)
    mesh = _mesh(8)
    with pytest.raises(ValueError):
        fft_sharded(mesh, jnp.zeros(32), jnp.zeros(32))
    with pytest.raises(ValueError):
        fft_sharded(mesh, jnp.zeros((2, 4096)), jnp.zeros((2, 4096)))


def test_convolve_sharded_non_pow2_mesh_raises():
    """A non-power-of-two block axis can never satisfy real_sharded_eligible;
    convolve_sharded must raise instead of searching FFT sizes forever."""
    mesh = mesh_mod.make_mesh(devices=jax.devices()[:3], channel=1, block=3)
    with pytest.raises(ValueError, match="power-of-two"):
        convolve_sharded(mesh, jnp.zeros(1000), jnp.zeros(100))
