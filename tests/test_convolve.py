"""Convolution engine parity tests vs direct numpy convolution.

Covers time-domain FIR parity and uniform + non-uniform partitioned
convolution parity: the streaming scan engine, the
offline batched engine, and the zero/short/medium latency schemes must all equal
``np.convolve`` to float64 precision on CPU (SNR targets far beyond the 80 dB
production bound).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hisstools_library.core.types import Split
from hisstools_library.models import mono, partitioned, time_domain as td
from hisstools_library.models.mono import LatencyMode, PartitionScheme


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


# -- time domain -----------------------------------------------------------------

def test_td_offline_matches_convolve(rng):
    x = rng.standard_normal(1000)
    h = rng.standard_normal(64)
    y = td.fir_offline(jnp.asarray(x), jnp.asarray(h))
    ref = np.convolve(x, h)[:1000]
    assert snr_db(ref, y) > 200


def test_td_streaming_matches_offline(rng):
    x = rng.standard_normal(1024)
    h = rng.standard_normal(33)
    taps = jnp.asarray(h)
    conv = td.TimeDomainConvolve()
    conv.taps = taps
    state = conv.init_state(dtype=jnp.float64)
    outs = []
    for i in range(0, 1024, 128):
        state, y = td.TimeDomainConvolve.process(taps, state, jnp.asarray(x[i:i + 128]))
        outs.append(np.asarray(y))
    y = np.concatenate(outs)
    ref = np.convolve(x, h)[:1024]
    assert snr_db(ref, y) > 200


def test_td_batched_channels(rng):
    x = rng.standard_normal((4, 500))
    h = rng.standard_normal((4, 16))
    y = np.asarray(td.fir_offline(jnp.asarray(x), jnp.asarray(h)))
    for c in range(4):
        assert snr_db(np.convolve(x[c], h[c])[:500], y[c]) > 200


def test_make_taps_offset_window(rng):
    ir = rng.standard_normal(300)
    taps = td.make_taps(ir, offset=100, length=50)
    assert np.array_equal(taps, ir[100:150])


# -- uniform partitioned -----------------------------------------------------------

@pytest.mark.parametrize("fft_size,ir_len", [(64, 96), (128, 64), (256, 1000)])
def test_partitioned_streaming_parity(rng, fft_size, ir_len):
    h = fft_size >> 1
    L = h * 12
    x = rng.standard_normal(L)
    ir = rng.standard_normal(ir_len + h)
    # Engine with offset == hop: output equals conv with the IR window in place.
    spec = partitioned.impulse_spectra(ir, fft_size, offset=h, length=ir_len,
                                       dtype=jnp.float64)
    pc = partitioned.PartitionedConvolve(fft_size, offset=h, length=ir_len)
    pc.spectra = spec
    state = pc.init_state(dtype=jnp.float64)
    state, y = partitioned.PartitionedConvolve.process(spec, state, jnp.asarray(x))
    masked = np.zeros_like(ir)
    masked[h:h + ir_len] = ir[h:h + ir_len]
    ref = np.convolve(x, masked)[:L]
    assert snr_db(ref, y) > 180


def test_partitioned_offline_equals_streaming(rng):
    fft_size = 128
    h = 64
    L = h * 9
    x = rng.standard_normal(L)
    ir = rng.standard_normal(500)
    spec = partitioned.impulse_spectra(ir, fft_size, offset=h, dtype=jnp.float64)
    pc = partitioned.PartitionedConvolve(fft_size, offset=h)
    pc.spectra = spec
    state = pc.init_state(dtype=jnp.float64)
    _, y_stream = partitioned.PartitionedConvolve.process(spec, state, jnp.asarray(x))
    y_off = partitioned.PartitionedConvolve.process_offline(spec, jnp.asarray(x))
    assert snr_db(np.asarray(y_stream), y_off) > 250


def test_partitioned_state_is_checkpointable(rng):
    # Streaming state is a pytree: split the stream, round-trip the state through
    # flatten/unflatten (serialisation), and get identical results.
    fft_size = 64
    h = 32
    x = rng.standard_normal(h * 8)
    ir = rng.standard_normal(200)
    spec = partitioned.impulse_spectra(ir, fft_size, offset=h, dtype=jnp.float64)
    pc = partitioned.PartitionedConvolve(fft_size, offset=h)
    pc.spectra = spec
    state = pc.init_state(dtype=jnp.float64)
    _, y_all = partitioned.PartitionedConvolve.process(spec, state, jnp.asarray(x))

    state = pc.init_state(dtype=jnp.float64)
    state, y1 = partitioned.PartitionedConvolve.process(spec, state, jnp.asarray(x[:h * 3]))
    leaves, treedef = jax.tree_util.tree_flatten(state)
    state2 = jax.tree_util.tree_unflatten(treedef, [np.asarray(l) for l in leaves])
    _, y2 = partitioned.PartitionedConvolve.process(spec, state2, jnp.asarray(x[h * 3:]))
    assert snr_db(np.asarray(y_all), np.concatenate([np.asarray(y1), np.asarray(y2)])) > 250


# -- non-uniform schemes -----------------------------------------------------------

@pytest.mark.parametrize("sizes", [(32, 128), (32, 64, 256), (32, 64, 128, 512)])
def test_zero_latency_scheme_exact(rng, sizes):
    scheme = PartitionScheme(sizes, zero_latency=True)
    big_hop = sizes[-1] >> 1
    L = big_hop * 6
    ir_len = sizes[-1] + 333
    x = rng.standard_normal(L)
    ir = rng.standard_normal(ir_len)
    mir = mono.prepare_ir(scheme, ir, dtype=jnp.float64)
    state = mono.init_state(scheme, mir, dtype=jnp.float64)
    _, y = mono.process(mir, state, jnp.asarray(x))
    ref = np.convolve(x, ir)[:L]
    assert snr_db(ref, y) > 180


def test_zero_latency_offline_matches(rng):
    scheme = PartitionScheme((32, 64, 128, 512), zero_latency=True)
    L = 256 * 8
    x = rng.standard_normal(L)
    ir = rng.standard_normal(900)
    mir = mono.prepare_ir(scheme, ir, dtype=jnp.float64)
    y = mono.process_offline(mir, jnp.asarray(x))
    ref = np.convolve(x, ir)[:L]
    assert snr_db(ref, y) > 180


@pytest.mark.parametrize("sizes", [(32, 128), (32, 64, 256)])
def test_short_latency_scheme_is_delayed_conv(rng, sizes):
    scheme = PartitionScheme(sizes, zero_latency=False)
    lat = scheme.latency
    assert lat == sizes[0] >> 1
    big_hop = sizes[-1] >> 1
    L = big_hop * 6
    x = rng.standard_normal(L)
    ir = rng.standard_normal(sizes[-1])
    mir = mono.prepare_ir(scheme, ir, dtype=jnp.float64)
    state = mono.init_state(scheme, mir, dtype=jnp.float64)
    _, y = mono.process(mir, state, jnp.asarray(x))
    full = np.convolve(x, ir)
    ref = np.concatenate([np.zeros(lat), full])[:L]
    assert snr_db(ref, y) > 180


def test_reference_presets():
    # MonoConvolve.cpp:26-31 presets
    z = PartitionScheme.from_latency(LatencyMode.Zero)
    assert z.sizes == (256, 1024, 4096, 16384) and z.zero_latency and z.latency == 0
    s = PartitionScheme.from_latency(LatencyMode.Short)
    assert s.sizes == (256, 1024, 4096, 16384) and s.latency == 128
    m = PartitionScheme.from_latency(LatencyMode.Medium)
    assert m.sizes == (1024, 4096, 16384) and m.latency == 512


def test_scheme_section_windows():
    # Section coverage: TD [0,128), A=256 covers [128,512), B covers [512,2048),
    # C covers [2048,8192), D covers the rest (SURVEY.md §3.2 derivation).
    scheme = PartitionScheme.from_latency(LatencyMode.Zero)
    plans = scheme.sections()
    assert [(p.fft_size, p.offset, p.length) for p in plans] == [
        (256, 128, 384), (1024, 512, 1536), (4096, 2048, 6144), (16384, 8192, 0)]


def test_scheme_validation():
    from hisstools_library.core.errors import ConvolveException
    with pytest.raises(ConvolveException):
        PartitionScheme((100, 200), True)  # non power of two
    with pytest.raises(ConvolveException):
        PartitionScheme((16, 64), True)  # below 2^5
    with pytest.raises(ConvolveException):
        PartitionScheme((64, 32), True)  # not increasing


def test_mono_batched_channels(rng):
    scheme = PartitionScheme((32, 128), zero_latency=True)
    L = 64 * 4
    x = rng.standard_normal((3, L))
    ir = rng.standard_normal((3, 200))
    mir = mono.prepare_ir(scheme, ir, dtype=jnp.float64)
    state = mono.init_state(scheme, mir, batch_shape=(3,), dtype=jnp.float64)
    _, y = mono.process(mir, state, jnp.asarray(x))
    for c in range(3):
        assert snr_db(np.convolve(x[c], ir[c])[:L], np.asarray(y)[c]) > 180


def test_mono_convolve_class_api(rng):
    mc = mono.MonoConvolve(max_length=4096, scheme=PartitionScheme((32, 128), True))
    ir = rng.standard_normal(300)
    assert mc.set(ir, dtype=jnp.float64).name == "NONE"
    st = mc.init_state(dtype=jnp.float64)
    x = rng.standard_normal(mc.block_size * 4)
    st, y = mc.process(st, jnp.asarray(x))
    assert snr_db(np.convolve(x, ir)[:len(x)], y) > 180


def test_offline_tail_matches_sectioned(rng):
    """prepare_ir's offline tail (large sections re-partitioned at the
    throughput-optimal FFT size + realignment shift) == the per-section
    engine, for a long IR where the tail actually builds."""
    import jax.numpy as jnp
    from hisstools_library.models import mono
    from hisstools_library.models.mono import LatencyMode, PartitionScheme

    scheme = PartitionScheme.from_latency(LatencyMode.Zero)
    L = 65536
    ir_len = 200000
    ir = (rng.standard_normal(ir_len) * np.exp(-np.arange(ir_len) / 30000)
          ).astype(np.float32) * 0.1
    x = rng.standard_normal((1, L)).astype(np.float32)

    with_tail = mono.prepare_ir(scheme, ir[None])
    assert with_tail.tail is not None and with_tail.tail_shift > 0
    without = mono.prepare_ir(scheme, ir[None], offline_tail=False)
    y_tail = np.asarray(mono.process_offline(with_tail, jnp.asarray(x)))
    y_ref = np.asarray(mono.process_offline(without, jnp.asarray(x)),
                       np.float64)
    err = y_tail - y_ref
    snr = 10 * np.log10((y_ref * y_ref).sum() / max((err * err).sum(), 1e-300))
    assert snr > 90.0

    # Short-latency scheme (nonzero latency folded into the shift) too.
    scheme_s = PartitionScheme.from_latency(LatencyMode.Short)
    wt = mono.prepare_ir(scheme_s, ir[None])
    assert wt.tail is not None
    y_t = np.asarray(mono.process_offline(wt, jnp.asarray(x)))
    y_r = np.asarray(mono.process_offline(
        mono.prepare_ir(scheme_s, ir[None], offline_tail=False),
        jnp.asarray(x)), np.float64)
    err = y_t - y_r
    snr = 10 * np.log10((y_r * y_r).sum() / max((err * err).sum(), 1e-300))
    assert snr > 90.0


def test_process_block_matches_step_scan(rng):
    """The batched multi-hop advance == scanning step() hop by hop, including
    state carry across calls and a non-trivial starting ring position."""
    import jax
    import jax.numpy as jnp
    from hisstools_library.core.types import Split
    from hisstools_library.models import partitioned as part

    fft_size, h = 256, 128
    ir = (rng.standard_normal(900) * 0.3).astype(np.float32)  # P = 7 + pad
    spec = part.impulse_spectra(ir[None], fft_size, 0, 0)
    spec1 = Split(spec.re[0], spec.im[0])
    x = rng.standard_normal((2, h * 11)).astype(np.float32)
    P = spec1.shape[-2]

    def fresh_state():
        from hisstools_library.core.types import Split as S
        return part.PartitionedState(
            prev=jnp.zeros((2, h), jnp.float32),
            ring=S(jnp.zeros((2, P, h), jnp.float32),
                   jnp.zeros((2, P, h), jnp.float32)),
            pos=jnp.zeros((), jnp.int32))

    # Reference: pure step scan (advance a few hops first so pos != 0).
    st_a = fresh_state()
    outs = []
    for j in range(11):
        st_a, y = part.PartitionedConvolve.step(
            spec1, st_a, jnp.asarray(x[:, j * h:(j + 1) * h]))
        outs.append(np.asarray(y))
    y_scan = np.concatenate(outs, axis=-1)

    # Batched: warm up 3 hops via step (pos = 3), then one process_block.
    st_b = fresh_state()
    for j in range(3):
        st_b, y = part.PartitionedConvolve.step(
            spec1, st_b, jnp.asarray(x[:, j * h:(j + 1) * h]))
    st_b, y_blk = part.PartitionedConvolve.process_block(
        spec1, st_b, jnp.asarray(x[:, 3 * h:]))
    y_mixed = np.concatenate([y_scan[:, :3 * h], np.asarray(y_blk)], axis=-1)

    ref = y_scan.astype(np.float64)
    d = y_mixed - ref
    snr = 10 * np.log10((ref * ref).sum() / max((d * d).sum(), 1e-300))
    assert snr > 110.0

    # And the state continues identically: one more step from both.
    nxt = jnp.asarray(rng.standard_normal((2, h)).astype(np.float32))
    _, ya = part.PartitionedConvolve.step(spec1, st_a, nxt)
    _, yb = part.PartitionedConvolve.step(spec1, st_b, nxt)
    da = np.asarray(ya, np.float64) - np.asarray(yb, np.float64)
    ra = np.asarray(ya, np.float64)
    assert 10 * np.log10((ra * ra).sum() / max((da * da).sum(), 1e-300)) > 110.0


def test_scheme_for_latency_budget(rng):
    """Latency-budget scheme selection: presets below 1024, a single uniform
    section above (hop == N/2 must fit the budget; larger budgets cap at
    2^17)."""
    from hisstools_library.models.mono import PartitionScheme
    assert PartitionScheme.for_latency_budget(0).zero_latency
    assert PartitionScheme.for_latency_budget(127).zero_latency
    assert PartitionScheme.for_latency_budget(128).latency == 128
    assert PartitionScheme.for_latency_budget(512).latency == 512
    for budget in (1024, 1500, 8192, 100000, 1 << 20):
        s = PartitionScheme.for_latency_budget(budget)
        assert s.latency <= budget
        assert len(s.sizes) == 1
        assert s.sizes[0] <= 1 << 17
    # parity: the budget-8192 engine is a delayed exact convolution
    s = PartitionScheme.for_latency_budget(8192)
    ir = rng.standard_normal(20000)
    mir = mono.prepare_ir(s, ir, dtype=jnp.float64, offline_tail=False)
    st = mono.init_state(s, mir, dtype=jnp.float64)
    L = (s.sizes[0] >> 1) * 3
    x = rng.standard_normal(L)
    _, y = mono.process(mir, st, jnp.asarray(x))
    lat = s.latency
    ref = np.concatenate([np.zeros(lat), np.convolve(x, ir)])[:L]
    assert snr_db(ref, y) > 180


def test_lazy_tail_attach_matches_eager(rng):
    """MonoConvolve.set() defers the offline tail; the first process_offline
    must attach ONLY the tail (same result as eager prepare_ir, bitwise) and
    release the host IR copy it was holding."""
    ir = rng.standard_normal((2, 20000)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((2, 32768)), jnp.float32)

    conv = mono.MonoConvolve(latency=LatencyMode.Zero)
    conv.set(ir)
    assert conv.ir.tail is None and conv._ir_host is not None
    y_lazy = conv.process_offline(x)
    assert conv.ir.tail is not None
    assert conv._ir_host is None  # host copy released after the tail build

    scheme = PartitionScheme.from_latency(LatencyMode.Zero)
    eager = mono.prepare_ir(scheme, ir, conv.max_length, jnp.float32, None,
                            offline_tail=True)
    y_eager = mono.process_offline(eager, x)
    assert float(jnp.abs(y_lazy - y_eager).max()) == 0.0


def test_partitioned_set_clamps_to_max_length(rng):
    """An IR longer than max_length flags MEM_ALLOC_TOO_SMALL AND convolves
    only the first max_length taps (reference PartitionedConvolve.cpp:195-199
    clamps alongside the error)."""
    from hisstools_library.core.errors import ConvolveError
    eng = partitioned.PartitionedConvolve(256, max_length=300, length=1000)
    ir = rng.standard_normal(1000).astype(np.float32)
    err = eng.set(ir)
    assert err == ConvolveError.MEM_ALLOC_TOO_SMALL
    ref = partitioned.PartitionedConvolve(256, max_length=300)
    assert ref.set(ir[:300]) == ConvolveError.NONE
    assert eng.num_partitions == ref.num_partitions
    x = jnp.asarray(rng.standard_normal((1, 1024)), jnp.float32)
    s1, y1 = partitioned.PartitionedConvolve.process(
        eng.spectra, eng.init_state((1,)), x)
    s2, y2 = partitioned.PartitionedConvolve.process(
        ref.spectra, ref.init_state((1,)), x)
    assert float(jnp.abs(y1 - y2).max()) == 0.0


def test_validate_fft_size_zero_raises_convolve_error():
    from hisstools_library.core.errors import ConvolveException
    for bad in (0, -4):
        with pytest.raises(ConvolveException):
            partitioned.validate_fft_size(bad)


def test_scheme_rejects_more_than_four_sizes():
    """sections() builds plans for at most A<B<C<D (reference setPartitions,
    MonoConvolve.cpp:203-258); a 5th size used to be silently dropped,
    mis-covering the IR (measured rel err ~1.2 on the streamed output)."""
    from hisstools_library.core.errors import ConvolveException
    with pytest.raises(ConvolveException):
        mono.PartitionScheme((64, 128, 256, 512, 1024), zero_latency=True)
    # 4 sizes remain exactly covered end-to-end
    rng = np.random.default_rng(7)
    scheme = mono.PartitionScheme((64, 128, 256, 512), zero_latency=True)
    ir = rng.standard_normal(1500)
    mir = mono.prepare_ir(scheme, ir, dtype=jnp.float64, offline_tail=False)
    st = mono.init_stream_state(scheme, mir, (), jnp.float64)
    L = 2048
    x = rng.standard_normal(L)
    st, y = mono.process_any(mir, st, jnp.asarray(x))
    ref = np.convolve(x, ir)[:L]
    err = np.abs(np.asarray(y) - ref).max() / np.abs(ref).max()
    assert err < 1e-12


def test_mono_set_no_resize_clamps(rng):
    """request_resize=False loads the IR truncated to max_length alongside
    MEM_ALLOC_TOO_SMALL (reference MonoConvolve.cpp:117-139); it used to
    build and convolve the full over-length IR."""
    scheme = PartitionScheme((32, 128), zero_latency=True)
    conv = mono.MonoConvolve(max_length=200, scheme=scheme)
    ir = rng.standard_normal(500)
    assert conv.set(ir, dtype=jnp.float64,
                    request_resize=False).name == "MEM_ALLOC_TOO_SMALL"
    assert conv.length == 200
    L = 1024
    x = rng.standard_normal(L)
    st = conv.init_state(dtype=jnp.float64)
    _, y = conv.process(st, jnp.asarray(x))
    ref = np.convolve(x, ir[:200])[:L]
    assert np.abs(np.asarray(y) - ref).max() / np.abs(ref).max() < 1e-12
    # prepare_ir honours max_length directly too (it was a dead parameter)
    mir = mono.prepare_ir(scheme, ir, max_length=200, dtype=jnp.float64,
                          offline_tail=False)
    st2 = mono.init_state(scheme, mir, (), jnp.float64)
    _, y2 = mono.process(mir, st2, jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(y), np.asarray(y2))
