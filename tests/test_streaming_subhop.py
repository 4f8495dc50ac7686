"""Sub-hop streaming parity: arbitrary callback block sizes.

The reference processes ANY ``numSamples`` per audio callback — the RW-counter
main loop stages partial hops and fires FFTs only on hop boundaries
(/root/reference/HIRT_Multichannel_Convolution/PartitionedConvolve.cpp:243-385,
``tillNextFFT`` sizing :298-300; Convolver.cpp:138-154). These tests stream
randomized odd-sized block sequences (1..N samples) through the sample-granular
engine (StreamState / step_any / process_any) and assert parity against
``np.convolve`` float64 oracles for all three latency presets, plus
equivalence with the hop-aligned throughput path and checkpoint/resume.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hisstools_library.models import mono, multichannel, partitioned
from hisstools_library.models.mono import LatencyMode, PartitionScheme


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


def stream_blocks(step, state, x, blocks):
    """Drive ``step(state, block) -> (state, y)`` over a block-size schedule."""
    outs = []
    i = 0
    bi = 0
    n = len(x)
    while i < n:
        b = min(blocks[bi % len(blocks)], n - i)
        bi += 1
        state, y = step(state, jnp.asarray(x[i:i + b]))
        outs.append(np.asarray(y))
        i += b
    return state, np.concatenate(outs)


# -- uniform section ---------------------------------------------------------------

def test_uniform_step_any_random_blocks(rng):
    fft_size, h = 128, 64
    ir = rng.standard_normal(500)
    spec = partitioned.impulse_spectra(ir, fft_size, offset=h, dtype=jnp.float64)
    pc = partitioned.PartitionedConvolve(fft_size, offset=h)
    pc.spectra = spec
    state = pc.init_stream_state(dtype=jnp.float64)
    L = 2000
    x = rng.standard_normal(L)
    sizes = [int(b) for b in rng.integers(1, 200, size=40)]
    _, y = stream_blocks(
        lambda s, b: partitioned.PartitionedConvolve.step_any(spec, s, b),
        state, x, sizes)
    masked = np.zeros_like(ir)
    masked[h:] = ir[h:]
    ref = np.convolve(x, masked)[:L]
    assert snr_db(ref, y) > 250


def test_uniform_step_any_equals_aligned_step(rng):
    """Hop-sized blocks through step_any == the aligned per-hop step."""
    fft_size, h = 64, 32
    ir = rng.standard_normal(300)
    spec = partitioned.impulse_spectra(ir, fft_size, offset=h, dtype=jnp.float64)
    pc = partitioned.PartitionedConvolve(fft_size, offset=h)
    pc.spectra = spec
    x = rng.standard_normal(h * 10)

    st_a = pc.init_state(dtype=jnp.float64)
    st_s = pc.init_stream_state(dtype=jnp.float64)
    for t in range(10):
        blk = jnp.asarray(x[t * h:(t + 1) * h])
        st_a, ya = partitioned.PartitionedConvolve.step(spec, st_a, blk)
        st_s, ys = partitioned.PartitionedConvolve.step_any(spec, st_s, blk)
        np.testing.assert_allclose(np.asarray(ya), np.asarray(ys),
                                   rtol=1e-12, atol=1e-12)


def test_stream_from_aligned_continues_bit_identically(rng):
    fft_size, h = 64, 32
    ir = rng.standard_normal(400)
    spec = partitioned.impulse_spectra(ir, fft_size, offset=h, dtype=jnp.float64)
    pc = partitioned.PartitionedConvolve(fft_size, offset=h)
    pc.spectra = spec
    L = h * 12
    x = rng.standard_normal(L)

    # Full run through the sample-granular engine.
    st = pc.init_stream_state(dtype=jnp.float64)
    _, y_full = stream_blocks(
        lambda s, b: partitioned.PartitionedConvolve.step_any(spec, s, b),
        st, x, [13, 51, 7])

    # Aligned for the first half, lifted mid-stream, odd blocks after.
    split = h * 6
    st_a = pc.init_state(dtype=jnp.float64)
    st_a, y1 = partitioned.PartitionedConvolve.process(spec, st_a,
                                                       jnp.asarray(x[:split]))
    st_s = partitioned.PartitionedConvolve.stream_from_aligned(spec, st_a)
    _, y2 = stream_blocks(
        lambda s, b: partitioned.PartitionedConvolve.step_any(spec, s, b),
        st_s, x[split:], [13, 51, 7])
    y_mixed = np.concatenate([np.asarray(y1), y2])
    assert snr_db(y_full, y_mixed) > 250


def test_stream_to_aligned_roundtrip(rng):
    """On a hop boundary the stream state projects back to the aligned form."""
    fft_size, h = 64, 32
    ir = rng.standard_normal(256)
    spec = partitioned.impulse_spectra(ir, fft_size, offset=h, dtype=jnp.float64)
    pc = partitioned.PartitionedConvolve(fft_size, offset=h)
    pc.spectra = spec
    L = h * 8
    x = rng.standard_normal(L + h * 4)

    st_s = pc.init_stream_state(dtype=jnp.float64)
    st_s, y1 = partitioned.PartitionedConvolve.step_any(spec, st_s,
                                                        jnp.asarray(x[:L]))
    assert int(st_s.phase) == 0
    st_a = partitioned.PartitionedConvolve.stream_to_aligned(st_s)
    _, y2 = partitioned.PartitionedConvolve.process(spec, st_a,
                                                    jnp.asarray(x[L:]))

    st_ref = pc.init_stream_state(dtype=jnp.float64)
    _, y_ref = partitioned.PartitionedConvolve.step_any(spec, st_ref,
                                                        jnp.asarray(x))
    got = np.concatenate([np.asarray(y1), np.asarray(y2)])
    assert snr_db(np.asarray(y_ref), got) > 250


# -- latency schemes ---------------------------------------------------------------

@pytest.mark.parametrize("sizes", [(32, 128), (32, 64, 256), (32, 64, 128, 512)])
def test_zero_latency_any_blocks(rng, sizes):
    scheme = PartitionScheme(sizes, zero_latency=True)
    ir = rng.standard_normal(sizes[-1] + 333)
    mir = mono.prepare_ir(scheme, ir, dtype=jnp.float64, offline_tail=False)
    st = mono.init_stream_state(scheme, mir, dtype=jnp.float64)
    L = (sizes[-1] >> 1) * 6
    x = rng.standard_normal(L)
    sizes_seq = [1, 7, 64, 333, 480, 100, 3, 512]
    _, y = stream_blocks(lambda s, b: mono.process_any(mir, s, b), st, x,
                         sizes_seq)
    ref = np.convolve(x, ir)[:L]
    assert snr_db(ref, y) > 250


@pytest.mark.parametrize("zero_latency", [False])
@pytest.mark.parametrize("sizes", [(32, 128), (64, 256, 1024)])
def test_latency_scheme_any_blocks(rng, sizes, zero_latency):
    """Short/Medium-style schemes: delayed-conv oracle under odd blocks."""
    scheme = PartitionScheme(sizes, zero_latency=zero_latency)
    lat = scheme.latency
    ir = rng.standard_normal(sizes[-1] + 100)
    mir = mono.prepare_ir(scheme, ir, dtype=jnp.float64, offline_tail=False)
    st = mono.init_stream_state(scheme, mir, dtype=jnp.float64)
    L = (sizes[-1] >> 1) * 6
    x = rng.standard_normal(L)
    _, y = stream_blocks(lambda s, b: mono.process_any(mir, s, b), st, x,
                         [17, 480, 64, 3, 129])
    full = np.convolve(x, ir)
    ref = np.concatenate([np.zeros(lat), full])[:L]
    assert snr_db(ref, y) > 250


def test_reference_zero_preset_64_sample_callbacks(rng):
    """The acceptance case: the reference's Zero preset (TD head +
    256/1024/4096/16384) must accept small callbacks (64 samples) — a
    zero-latency convolver that can't is not zero-latency in practice."""
    scheme = PartitionScheme.from_latency(LatencyMode.Zero)
    ir = rng.standard_normal(20000)
    mir = mono.prepare_ir(scheme, ir, dtype=jnp.float64, offline_tail=False)
    st = mono.init_stream_state(scheme, mir, dtype=jnp.float64)
    L = 8192 * 2 + 4096  # crosses two big-section boundaries
    x = rng.standard_normal(L)
    step = jax.jit(lambda s, b: mono.process_any(mir, s, b))
    _, y = stream_blocks(step, st, x, [64, 480, 333])
    ref = np.convolve(x, ir)[:L]
    assert snr_db(ref, y) > 250


def test_stream_state_checkpoint_resume(rng):
    scheme = PartitionScheme((32, 64, 256), zero_latency=True)
    ir = rng.standard_normal(600)
    mir = mono.prepare_ir(scheme, ir, dtype=jnp.float64, offline_tail=False)
    L = 1500
    x = rng.standard_normal(L)

    st = mono.init_stream_state(scheme, mir, dtype=jnp.float64)
    _, y_full = stream_blocks(lambda s, b: mono.process_any(mir, s, b), st, x,
                              [97, 33, 250])

    st = mono.init_stream_state(scheme, mir, dtype=jnp.float64)
    st, y1 = mono.process_any(mir, st, jnp.asarray(x[:777]))
    leaves, treedef = jax.tree_util.tree_flatten(st)
    st2 = jax.tree_util.tree_unflatten(treedef, [np.asarray(l) for l in leaves])
    _, y2 = stream_blocks(lambda s, b: mono.process_any(mir, s, b), st2,
                          x[777:], [97, 33, 250])
    got = np.concatenate([np.asarray(y1), y2])
    assert snr_db(y_full, got) > 250


# -- multichannel ------------------------------------------------------------------

def test_convolver_process_any_parallel(rng):
    conv = multichannel.Convolver(3, scheme=PartitionScheme((32, 128), True))
    irs = rng.standard_normal((3, 200))
    conv.set_all(irs)
    conv.prepare(dtype=jnp.float64)
    st = conv.init_stream_state(dtype=jnp.float64)
    L = 700
    x = rng.standard_normal((3, L))
    outs = []
    i = 0
    for b in [13, 64, 100, 7, 480, 36]:
        if i >= L:
            break
        b = min(b, L - i)
        st, y = conv.process_any(st, jnp.asarray(x[:, i:i + b]))
        outs.append(np.asarray(y))
        i += b
    while i < L:
        b = min(99, L - i)
        st, y = conv.process_any(st, jnp.asarray(x[:, i:i + b]))
        outs.append(np.asarray(y))
        i += b
    y = np.concatenate(outs, axis=-1)
    for c in range(3):
        ref = np.convolve(x[c], irs[c])[:L]
        assert snr_db(ref, y[c]) > 250


def test_convolver_process_any_n2m(rng):
    conv = multichannel.Convolver(2, 2, scheme=PartitionScheme((32, 64), True))
    irs = rng.standard_normal((2, 2, 150))
    conv.set_all(irs)
    conv.prepare(dtype=jnp.float64)
    st = conv.init_stream_state(dtype=jnp.float64)
    L = 600
    x = rng.standard_normal((2, L))
    outs = []
    i = 0
    for b in [31, 64, 200, 5, 300]:
        b = min(b, L - i)
        if b <= 0:
            break
        st, yb = conv.process_any(st, jnp.asarray(x[:, i:i + b]))
        outs.append(np.asarray(yb))
        i += b
    y = np.concatenate(outs, axis=-1)
    for o in range(2):
        ref = sum(np.convolve(x[n], irs[o, n])[:i] for n in range(2))
        assert snr_db(ref, y[o][:i]) > 250


def test_per_channel_reset(rng):
    conv = multichannel.Convolver(2, scheme=PartitionScheme((32, 64), True))
    irs = rng.standard_normal((2, 100))
    conv.set_all(irs)
    conv.prepare(dtype=jnp.float64)
    st = conv.init_state(dtype=jnp.float64)
    x1 = rng.standard_normal((2, 128))
    st, _ = conv.process(st, jnp.asarray(x1))
    st = conv.reset(in_chan=0, state=st)
    x2 = rng.standard_normal((2, 128))
    _, y = conv.process(st, jnp.asarray(x2))
    # channel 0 behaves as freshly reset; channel 1 keeps its history
    fresh = conv.init_state(dtype=jnp.float64)
    _, y_fresh = conv.process(fresh, jnp.asarray(x2))
    np.testing.assert_allclose(np.asarray(y[0]), np.asarray(y_fresh[0]),
                               rtol=1e-12, atol=1e-12)
    assert not np.allclose(np.asarray(y[1]), np.asarray(y_fresh[1]))


# -- f32 sample-granular sections ---------------------------------------------------

def _f64_conv(x, ir, length):
    n = 1 << int(np.ceil(np.log2(x.shape[-1] + ir.shape[-1] - 1)))
    y = np.fft.irfft(np.fft.rfft(x, n) * np.fft.rfft(ir, n), n)
    return y[..., :length]


@pytest.mark.parametrize("fft_size", [64, 128, 256, 512, 1024])
def test_step_any_section_f32(rng, fft_size):
    """One f32 section fed ragged callbacks (below, at and above its hop)
    matches the float64 convolution of its IR window, delayed by the hop."""
    h = fft_size >> 1
    ir = rng.standard_normal((3, 3 * h + 11)).astype(np.float32)
    spec = partitioned.impulse_spectra(ir, fft_size, offset=h,
                                       dtype=jnp.float32)
    pc = partitioned.PartitionedConvolve(fft_size, offset=h)
    pc.spectra = spec
    L = h * 8 + 45
    x = rng.standard_normal((3, L)).astype(np.float32)
    st = pc.init_stream_state((3,), dtype=jnp.float32)
    ys, i = [], 0
    for b in [64, 480, 333, 100, 7] * 20:
        b = min(b, L - i)
        if b <= 0:
            break
        st, y = partitioned.PartitionedConvolve.step_any(
            spec, st, jnp.asarray(x[:, i:i + b]))
        ys.append(np.asarray(y))
        i += b
    masked = np.zeros_like(ir, np.float64)
    masked[:, h:] = ir[:, h:]
    ref = _f64_conv(x.astype(np.float64), masked, L)
    assert snr_db(ref, np.concatenate(ys, -1)) > 120, fft_size


def test_scheme_f32_ragged_callbacks(rng):
    """Full zero-latency scheme in f32 through process_any with ragged
    callbacks."""
    scheme = PartitionScheme((64, 256, 1024), zero_latency=True)
    ir = rng.standard_normal(1500).astype(np.float32)
    mir = mono.prepare_ir(scheme, ir, dtype=jnp.float32, offline_tail=False)
    st = mono.init_stream_state(scheme, mir, dtype=jnp.float32)
    L = 512 * 5
    x = rng.standard_normal(L).astype(np.float32)
    _, y = stream_blocks(
        lambda s, b: mono.process_any(mir, s, b), st, x, [31, 480, 64, 3, 129])
    ref = np.convolve(x.astype(np.float64), ir.astype(np.float64))[:L]
    assert snr_db(ref, y) > 120
