"""Multichannel Convolver routing tests (reference Convolver/NToMonoConvolve)."""

import numpy as np
import pytest

import jax.numpy as jnp

from hisstools_library.models import multichannel as mc
from hisstools_library.models.mono import PartitionScheme


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


SCHEME = PartitionScheme((32, 128), zero_latency=True)


def test_n2m_routing(rng):
    N, M, L, IRL = 3, 2, 64 * 6, 200
    conv = mc.Convolver(N, M, scheme=SCHEME)
    irs = rng.standard_normal((M, N, IRL))
    assert conv.set_all(irs).name == "NONE"
    conv.prepare(dtype=jnp.float64)
    state = conv.init_state(dtype=jnp.float64)
    x = rng.standard_normal((N, L))
    state, y = conv.process(state, jnp.asarray(x))
    assert y.shape == (M, L)
    for o in range(M):
        ref = sum(np.convolve(x[i], irs[o, i])[:L] for i in range(N))
        assert snr_db(ref, np.asarray(y)[o]) > 180


def test_parallel_routing(rng):
    C, L, IRL = 4, 64 * 4, 150
    conv = mc.Convolver(C, scheme=SCHEME)  # parallel N x N
    irs = rng.standard_normal((C, IRL))
    conv.set_all(irs)
    conv.prepare(dtype=jnp.float64)
    state = conv.init_state(dtype=jnp.float64)
    x = rng.standard_normal((C, L))
    state, y = conv.process(state, jnp.asarray(x))
    for c in range(C):
        assert snr_db(np.convolve(x[c], irs[c])[:L], np.asarray(y)[c]) > 180


def test_per_pair_set_and_clear(rng):
    N, M, L = 2, 2, 64 * 4
    conv = mc.Convolver(N, M, scheme=SCHEME)
    ir = rng.standard_normal(100)
    assert conv.set(0, 1, ir).name == "NONE"
    assert conv.set(5, 0, ir).name == "IN_CHAN_OUT_OF_RANGE"
    assert conv.set(0, 5, ir).name == "OUT_CHAN_OUT_OF_RANGE"
    conv.prepare(dtype=jnp.float64)
    state = conv.init_state(dtype=jnp.float64)
    x = rng.standard_normal((N, L))
    _, y = conv.process(state, jnp.asarray(x))
    assert np.allclose(np.asarray(y)[0], 0.0)  # out 0 has no IR
    assert snr_db(np.convolve(x[0], ir)[:L], np.asarray(y)[1]) > 180
    # clear and verify silence
    conv.clear()
    conv.prepare(dtype=jnp.float64)
    state = conv.init_state(dtype=jnp.float64)
    _, y = conv.process(state, jnp.asarray(x))
    assert np.allclose(np.asarray(y), 0.0)


def test_parallel_requires_matching_channels(rng):
    conv = mc.Convolver(2, scheme=SCHEME)
    assert conv.set(0, 1, np.ones(10)).name == "IN_CHAN_OUT_OF_RANGE"


def test_offline_equals_streaming(rng):
    N, M, L = 2, 3, 64 * 5
    conv = mc.Convolver(N, M, scheme=SCHEME)
    conv.set_all(rng.standard_normal((M, N, 90)))
    conv.prepare(dtype=jnp.float64)
    state = conv.init_state(dtype=jnp.float64)
    x = rng.standard_normal((N, L))
    _, ys = conv.process(state, jnp.asarray(x))
    yo = conv.process_offline(jnp.asarray(x))
    assert snr_db(np.asarray(ys), yo) > 250


def test_clear_per_pair_validation(rng):
    """N2M clear takes BOTH channels (reference Convolver::clear overloads,
    Convolver.cpp:51-75); a lone channel used to index the bank with None
    (numpy newaxis) and silently zero the wrong IRs."""
    N, M, L = 3, 2, 64 * 3
    conv = mc.Convolver(N, M, scheme=SCHEME)
    irs = rng.standard_normal((M, N, 80))
    conv.set_all(irs)
    with pytest.raises(ValueError):
        conv.clear(in_chan=1)
    with pytest.raises(ValueError):
        conv.clear(out_chan=1)
    assert conv.clear(5, 0).name == "IN_CHAN_OUT_OF_RANGE"
    assert conv.clear(0, 5).name == "OUT_CHAN_OUT_OF_RANGE"
    # the failed clears left the bank untouched
    assert conv.clear(1, 0).name == "NONE"
    conv.prepare(dtype=jnp.float64)
    state = conv.init_state(dtype=jnp.float64)
    x = rng.standard_normal((N, L))
    _, y = conv.process(state, jnp.asarray(x))
    ref0 = np.convolve(x[0], irs[0, 0])[:L] + np.convolve(x[2], irs[0, 2])[:L]
    assert snr_db(ref0, np.asarray(y)[0]) > 180  # pair (in 1, out 0) cleared
    ref1 = sum(np.convolve(x[i], irs[1, i])[:L] for i in range(N))
    assert snr_db(ref1, np.asarray(y)[1]) > 180  # out 1 untouched


def test_clear_parallel_single_channel(rng):
    C, L = 3, 64 * 3
    conv = mc.Convolver(C, scheme=SCHEME)
    irs = rng.standard_normal((C, 80))
    conv.set_all(irs)
    assert conv.clear(1).name == "NONE"  # parallel: one channel is a pair
    assert conv.clear(0, 1).name == "IN_CHAN_OUT_OF_RANGE"  # mismatched pair
    conv.prepare(dtype=jnp.float64)
    state = conv.init_state(dtype=jnp.float64)
    x = rng.standard_normal((C, L))
    _, y = conv.process(state, jnp.asarray(x))
    assert np.allclose(np.asarray(y)[1], 0.0)
    assert snr_db(np.convolve(x[0], irs[0])[:L], np.asarray(y)[0]) > 180


def test_set_no_resize_clamps(rng):
    """resize=False loads the IR clamped to capacity AND reports the
    truncation (reference MonoConvolve.cpp:117-139 semantics)."""
    L = 64 * 4
    conv = mc.Convolver(2, scheme=SCHEME, max_length=96)
    ir = rng.standard_normal(200)
    assert conv.set(0, 0, ir, resize=False).name == "MEM_ALLOC_TOO_SMALL"
    assert conv.set(1, 1, ir[:50], resize=False).name == "NONE"
    conv.prepare(dtype=jnp.float64)
    state = conv.init_state(dtype=jnp.float64)
    x = rng.standard_normal((2, L))
    _, y = conv.process(state, jnp.asarray(x))
    assert snr_db(np.convolve(x[0], ir[:96])[:L], np.asarray(y)[0]) > 180
    # set_all follows the same contract
    conv2 = mc.Convolver(2, scheme=SCHEME, max_length=96)
    assert conv2.set_all(rng.standard_normal((2, 200)),
                         resize=False).name == "MEM_ALLOC_TOO_SMALL"
    assert conv2._bank_len == 96


def test_prepare_lazy_offline_tail(rng):
    """prepare() defaults to the lazy offline tail (same contract as
    MonoConvolve.set): no tail until the first process_offline call, then
    identical output to an eagerly-prepared bank."""
    C, L = 2, 64 * 4
    irs = rng.standard_normal((C, 500))
    x = rng.standard_normal((C, L))
    conv = mc.Convolver(C, scheme=SCHEME)
    conv.set_all(irs)
    conv.prepare(dtype=jnp.float64)
    assert conv.ir.tail is None  # lazy: streaming prep pays no tail cost
    y = conv.process_offline(jnp.asarray(x))
    assert conv.ir.tail is not None
    conv_eager = mc.Convolver(C, scheme=SCHEME)
    conv_eager.set_all(irs)
    conv_eager.prepare(dtype=jnp.float64, offline_tail=True)
    assert conv_eager.ir.tail is not None
    y_eager = conv_eager.process_offline(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(y), np.asarray(y_eager))
    for c in range(C):
        assert snr_db(np.convolve(x[c], irs[c])[:L], np.asarray(y)[c]) > 180


def test_resize_reserves_capacity(rng):
    """Convolver.resize reserves capacity so a later set(resize=False)
    succeeds at that length (reference Convolver::resize, Convolver.cpp:102-112)."""
    conv = mc.Convolver(2, 2, scheme=SCHEME, max_length=64)
    assert conv.resize(0, 1, 500).name == "NONE"
    assert conv.set(0, 1, rng.standard_normal(500), resize=False).name == "NONE"
    assert conv.resize(5, 0, 10).name == "IN_CHAN_OUT_OF_RANGE"
    assert conv.resize(0, 5, 10).name == "OUT_CHAN_OUT_OF_RANGE"
    par = mc.Convolver(2, scheme=SCHEME)
    assert par.resize(0, 1, 10).name == "IN_CHAN_OUT_OF_RANGE"
    assert par.resize(1, 1, 10).name == "NONE"


def test_set_and_clear_reject_negative_channels(rng):
    conv = mc.Convolver(3, 2, scheme=SCHEME)
    ir = rng.standard_normal(50)
    assert conv.set(-1, 0, ir).name == "IN_CHAN_OUT_OF_RANGE"
    assert conv.set(0, -1, ir).name == "OUT_CHAN_OUT_OF_RANGE"
    assert conv.clear(-1, 0).name == "IN_CHAN_OUT_OF_RANGE"
    assert conv.resize(-1, 0, 10).name == "IN_CHAN_OUT_OF_RANGE"


def test_clear_parallel_out_chan_alone(rng):
    """In parallel mode either channel argument alone names the channel."""
    conv = mc.Convolver(3, scheme=SCHEME)
    conv.set_all(rng.standard_normal((3, 60)))
    assert conv.clear(out_chan=1).name == "NONE"
    assert np.allclose(conv._bank[1], 0.0)
    assert not np.allclose(conv._bank[0], 0.0)
