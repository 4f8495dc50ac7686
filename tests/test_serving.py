"""IR hot-swap under a running stream (StreamingServer + MemorySwap).

Reference semantics under test (MonoConvolve.cpp:179-201, 118-140;
MemorySwap.h:174-212): the audio thread never blocks — it emits silence for
exactly the blocks during which the loader holds the IR lock; a completed swap
resets the engine state; capacity growth is the only recompile point.
"""

import threading
import time

import numpy as np
import pytest

import jax.numpy as jnp

from hisstools_library.models.mono import PartitionScheme
from hisstools_library.utils.serving import StreamingServer


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def make_server(channels=2):
    return StreamingServer(channels, capacity=256,
                           scheme=PartitionScheme((32, 64), True),
                           dtype=jnp.float32)


def test_serving_basic_parity(rng):
    srv = make_server()
    irs = rng.standard_normal((2, 200)).astype(np.float32)
    srv.set_ir(irs)
    L = 600
    x = rng.standard_normal((2, L)).astype(np.float32)
    outs = []
    i = 0
    for b in [64, 480, 33, 100]:
        b = min(b, L - i)
        if b <= 0:
            break
        y, live = srv.process(x[:, i:i + b])
        assert live
        outs.append(np.asarray(y))
        i += b
    y = np.concatenate(outs, axis=-1)
    for c in range(2):
        assert snr_db(np.convolve(x[c].astype(np.float64),
                                  irs[c].astype(np.float64))[:i], y[c]) > 90


def test_serving_swap_resets_and_uses_new_ir(rng):
    srv = make_server()
    ir1 = rng.standard_normal((2, 150)).astype(np.float32)
    ir2 = rng.standard_normal((2, 220)).astype(np.float32)
    srv.set_ir(ir1)
    x1 = rng.standard_normal((2, 256)).astype(np.float32)
    y1, live = srv.process(x1)
    assert live
    # Swap mid-stream; state resets, so post-swap output is the convolution of
    # ONLY the post-swap samples with the new IR (reference set() -> reset()).
    srv.set_ir(ir2)
    x2 = rng.standard_normal((2, 256)).astype(np.float32)
    y2, live = srv.process(x2)
    assert live
    for c in range(2):
        ref1 = np.convolve(x1[c].astype(np.float64),
                           ir1[c].astype(np.float64))[:256]
        ref2 = np.convolve(x2[c].astype(np.float64),
                           ir2[c].astype(np.float64))[:256]
        assert snr_db(ref1, np.asarray(y1)[c]) > 90
        assert snr_db(ref2, np.asarray(y2)[c]) > 90


def test_serving_silence_while_locked(rng):
    srv = make_server()
    irs = rng.standard_normal((2, 100)).astype(np.float32)
    srv.set_ir(irs)
    x = rng.standard_normal((2, 64)).astype(np.float32)
    y, live = srv.process(x)
    assert live and np.isfinite(np.asarray(y)).all()

    # Loader holds the lock: the audio thread must get silence, not block.
    handle = srv._swap.access()
    t0 = time.monotonic()
    y, live = srv.process(x)
    dt = time.monotonic() - t0
    handle.release()
    assert not live
    assert np.array_equal(np.asarray(y), np.zeros_like(x))
    assert dt < 0.1  # non-blocking

    # Stream resumes after release (same IR version -> state kept).
    y, live = srv.process(x)
    assert live


def test_serving_threaded_swap_smoke(rng):
    """Loader thread swaps IRs while the audio thread streams: no deadlock,
    every live block is finite, at least one swap lands."""
    srv = make_server()
    srv.set_ir(rng.standard_normal((2, 100)).astype(np.float32))
    stop = threading.Event()
    versions = []

    def loader():
        for k in range(3):
            versions.append(
                srv.set_ir(rng.standard_normal((2, 120)).astype(np.float32)))
            time.sleep(0.01)
        stop.set()

    th = threading.Thread(target=loader)
    th.start()
    x = rng.standard_normal((2, 64)).astype(np.float32)
    lives = []
    while not stop.is_set():
        y, live = srv.process(x)
        lives.append(live)
        if live:
            assert np.isfinite(np.asarray(y)).all()
    th.join()
    assert len(versions) == 3
    assert any(lives)


def test_serving_capacity_zero_does_not_hang(rng):
    """Regression: capacity=0 used to loop forever (0*2 == 0) in the grow loop."""
    srv = make_server()
    srv.set_ir(rng.standard_normal((2, 100)).astype(np.float32), capacity=0)
    assert srv.capacity >= 100


def test_serving_capacity_growth(rng):
    srv = make_server()
    srv.set_ir(rng.standard_normal((2, 100)).astype(np.float32))
    assert srv.capacity == 256
    srv.set_ir(rng.standard_normal((2, 700)).astype(np.float32))
    assert srv.capacity == 1024  # doubled past the requested length
    x = rng.standard_normal((2, 128)).astype(np.float32)
    y, live = srv.process(x)
    assert live and np.isfinite(np.asarray(y)).all()


def test_locked_block_silence_keeps_server_dtype(rng):
    """Blocks emitted while the loader holds the lock are silence in the
    SERVER's dtype — a float64 numpy callback block must not flip the output
    stream's dtype on swap boundaries."""
    import jax.numpy as jnp
    srv = make_server()
    srv.set_ir(rng.standard_normal((2, 64)).astype(np.float32))
    blk64 = np.zeros((2, 64), np.float64)
    y_live, live = srv.process(blk64[:, :64])
    assert live and y_live.dtype == jnp.float32
    h = srv._swap.access()  # loader holds the cell -> audio path sees locked
    try:
        y_locked, live = srv.process(blk64[:, :64])
    finally:
        h.release()
    assert not live
    assert y_locked.dtype == jnp.float32
    assert np.all(np.asarray(y_locked) == 0.0)
