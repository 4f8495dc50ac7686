"""Multi-device sharding tests on the 8-device virtual CPU mesh.

Validates that the (channel x block) sharded convolution equals the single-device
engine bit-for-bit semantics (same math, different partitioning), that halo
exchange reconstructs overlap-save boundaries, and that the N-to-mono psum
reduction matches the accumulate loop.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from hisstools_library.models import mono
from hisstools_library.models.mono import PartitionScheme
from hisstools_library.parallel import (
    BLOCK_AXIS, CHANNEL_AXIS, left_halo, make_mesh, n_to_one_offline,
    scheme_offline_sharded, shift_from_left,
)


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def test_mesh_shapes():
    mesh = make_mesh(channel=4, block=2)
    assert mesh.shape == {"channel": 4, "block": 2}
    mesh = make_mesh()
    assert mesh.shape["channel"] == 8


def test_shift_from_left():
    mesh = make_mesh(channel=1, block=8)
    x = jnp.arange(8.0).reshape(8, 1)

    def f(x_local):
        return shift_from_left(x_local, BLOCK_AXIS)

    y = jax.shard_map(f, mesh=mesh, in_specs=P(BLOCK_AXIS, None),
                      out_specs=P(BLOCK_AXIS, None))(x)
    assert np.allclose(np.asarray(y).ravel(), [0, 0, 1, 2, 3, 4, 5, 6])


@pytest.mark.parametrize("halo", [3, 16, 40])
def test_left_halo_reconstructs(halo):
    # Gathering `halo` left samples on each shard must reproduce zero-padded
    # global indexing.
    mesh = make_mesh(channel=1, block=4)
    L = 64
    x = jnp.arange(float(L))

    def f(x_local):
        return left_halo(x_local, halo, axis=0, axis_name=BLOCK_AXIS)

    y = jax.shard_map(f, mesh=mesh, in_specs=P(BLOCK_AXIS),
                      out_specs=P(BLOCK_AXIS))(x)
    y = np.asarray(y).reshape(4, -1)
    loc = L // 4
    xg = np.concatenate([np.zeros(halo + loc), np.arange(float(L))])
    for d in range(4):
        start = d * loc
        ref = xg[start + loc: start + loc + halo + loc]
        ref = np.concatenate([np.zeros(max(0, halo - start)),
                              np.arange(float(max(0, start - halo)), start),
                              np.arange(float(start), start + loc)])[-(halo + loc):]
        assert np.allclose(y[d], ref), d


SCHEME = PartitionScheme((32, 128), zero_latency=True)


def test_sharded_scheme_matches_single_device(rng):
    mesh = make_mesh(channel=4, block=2)
    C = 8
    L = 64 * 2 * 4  # multiple of largest hop * block axis
    x = rng.standard_normal((C, L))
    irs = rng.standard_normal((C, 300))
    ir = mono.prepare_ir(SCHEME, irs, dtype=jnp.float64)
    y = scheme_offline_sharded(mesh, SCHEME, ir, jnp.asarray(x))
    y = np.asarray(y)
    for c in range(C):
        ref = np.convolve(x[c], irs[c])[:L]
        assert snr_db(ref, y[c]) > 180, c


def test_sharded_matches_offline_engine(rng):
    mesh = make_mesh(channel=2, block=4)
    C = 4
    L = 64 * 4 * 2
    x = rng.standard_normal((C, L))
    irs = rng.standard_normal((C, 256))
    ir = mono.prepare_ir(SCHEME, irs, dtype=jnp.float64)
    y_sharded = np.asarray(scheme_offline_sharded(mesh, SCHEME, ir, jnp.asarray(x)))
    y_single = np.asarray(mono.process_offline(ir, jnp.asarray(x)))
    assert snr_db(y_single, y_sharded) > 250


def test_n_to_one_psum(rng):
    mesh = make_mesh(channel=4, block=2)
    N = 4
    L = 64 * 2 * 3
    x = rng.standard_normal((N, L))
    irs = rng.standard_normal((N, 200))
    ir = mono.prepare_ir(SCHEME, irs, dtype=jnp.float64)
    y = np.asarray(n_to_one_offline(mesh, SCHEME, ir, jnp.asarray(x)))
    ref = sum(np.convolve(x[i], irs[i])[:L] for i in range(N))
    assert snr_db(ref, y) > 180


def test_long_ir_halo_beyond_one_device(rng):
    # IR long enough that the partition history spans several block shards.
    scheme = PartitionScheme((32,), zero_latency=True)  # single section, hop 16
    mesh = make_mesh(channel=1, block=8)
    L = 16 * 8 * 2  # 2 hops per device
    x = rng.standard_normal(L)
    irs = rng.standard_normal(16 * 30)  # ~29 partitions -> halo spans ~15 devices
    ir = mono.prepare_ir(scheme, irs, dtype=jnp.float64)
    y = np.asarray(scheme_offline_sharded(mesh, scheme, ir, jnp.asarray(x)[None, :]))
    ref = np.convolve(x, irs)[:L]
    assert snr_db(ref, y[0]) > 180


def test_sharded_f32_section_matches_single_device(rng):
    """f32 sharded section (halo frames, lag MAC, riFFT per shard) ==
    single-device engine."""
    mesh = make_mesh(channel=2, block=4)
    scheme = PartitionScheme((4096,), zero_latency=False)
    hop = 2048
    C, L = 4, hop * 4 * 2   # 2 hops per block shard
    x = rng.standard_normal((C, L)).astype(np.float32)
    irs = (rng.standard_normal((C, 3 * hop + 100)) * 0.2).astype(np.float32)
    ir = mono.prepare_ir(scheme, irs, dtype=jnp.float32)

    y_sharded = scheme_offline_sharded(mesh, scheme, ir, jnp.asarray(x))
    y_single = mono.process_offline(ir, jnp.asarray(x))
    assert snr_db(y_single, y_sharded) > 90.0


def test_mesh_shape_invariance(rng):
    """The sharded result is mesh-layout independent: 8x1, 4x2, 2x4, 1x8
    meshes all reproduce the single-device output."""
    scheme = PartitionScheme((512,), zero_latency=False)
    hop = 256
    C, L = 8, hop * 8
    x = rng.standard_normal((C, L)).astype(np.float32)
    irs = (rng.standard_normal((C, 1000)) * 0.2).astype(np.float32)
    ir = mono.prepare_ir(scheme, irs, offline_tail=False)
    y_ref = np.asarray(mono.process_offline(ir, jnp.asarray(x)), np.float64)

    for ch, blk in ((8, 1), (4, 2), (2, 4), (1, 8)):
        mesh = make_mesh(channel=ch, block=blk)
        y = scheme_offline_sharded(mesh, scheme, ir, jnp.asarray(x))
        assert snr_db(y_ref, y) > 100.0, (ch, blk)


def test_sharded_streaming_channel_parallel(rng):
    """Channel-data-parallel streaming step == single-device streaming,
    including the carried state across two calls."""
    from hisstools_library.parallel import scheme_stream_sharded

    mesh = make_mesh(channel=8, block=1)
    scheme = PartitionScheme((64, 256), zero_latency=True)
    blk = 128
    C = 8
    irs = (rng.standard_normal((C, 600)) * 0.3).astype(np.float32)
    ir = mono.prepare_ir(scheme, irs, offline_tail=False)
    x1 = jnp.asarray(rng.standard_normal((C, blk * 2)).astype(np.float32))
    x2 = jnp.asarray(rng.standard_normal((C, blk * 2)).astype(np.float32))

    s_ref = mono.init_state(scheme, ir, batch_shape=(C,))
    s_ref, ya_ref = mono.process(ir, s_ref, x1)
    _, yb_ref = mono.process(ir, s_ref, x2)

    s_sh = mono.init_state(scheme, ir, batch_shape=(C,))
    s_sh, ya = scheme_stream_sharded(mesh, ir, s_sh, x1)
    _, yb = scheme_stream_sharded(mesh, ir, s_sh, x2)
    assert snr_db(np.asarray(ya_ref, np.float64), ya) > 110.0
    assert snr_db(np.asarray(yb_ref, np.float64), yb) > 110.0


def test_make_mesh_rejects_non_dividing_inference():
    """Inferring the other axis from a non-dividing factor would silently
    idle devices (block=3 on 8 devices -> 2x3 mesh, 2 idle)."""
    import pytest as _pytest
    with _pytest.raises(ValueError):
        make_mesh(block=3)
    with _pytest.raises(ValueError):
        make_mesh(channel=5)
    assert make_mesh(block=2).devices.size == 8


def test_sharded_streaming_sample_granular(rng):
    """Sample-granular (ANY callback size) streaming under the channel mesh is
    BIT-IDENTICAL to single-device process_any, including the carried sub-hop
    state across a ragged callback sequence (serving at scale with real
    callback sizes)."""
    from hisstools_library.parallel import scheme_stream_any_sharded

    mesh = make_mesh(channel=8, block=1)
    scheme = PartitionScheme((64, 256), zero_latency=True)
    C = 8
    irs = (rng.standard_normal((C, 600)) * 0.3).astype(np.float32)
    ir = mono.prepare_ir(scheme, irs, offline_tail=False)
    blocks = [37, 100, 1, 64, 333]
    xs = [jnp.asarray(rng.standard_normal((C, b)).astype(np.float32))
          for b in blocks]

    s_ref = mono.init_stream_state(scheme, ir, batch_shape=(C,))
    outs_ref = []
    for x in xs:
        s_ref, y = mono.process_any(ir, s_ref, x)
        outs_ref.append(np.asarray(y))

    s_sh = mono.init_stream_state(scheme, ir, batch_shape=(C,))
    for x, y_ref in zip(xs, outs_ref):
        s_sh, y = scheme_stream_any_sharded(mesh, ir, s_sh, x)
        np.testing.assert_array_equal(y_ref, np.asarray(y))
