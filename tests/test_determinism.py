"""Determinism: same inputs -> bitwise-identical outputs.

The reference's concurrency-safety story is lock discipline (MemorySwap +
thread_lock); the functional equivalent per SURVEY.md §5 is proving that
repeated evaluation is bitwise reproducible — no nondeterministic reduction
orders or uninitialised memory anywhere in the engines.
"""

import numpy as np

import jax
import jax.numpy as jnp

from hisstools_library.models import mono
from hisstools_library.models.mono import PartitionScheme
from hisstools_library.models.offline import FastFIR


def _bitwise_equal(a, b):
    return np.array_equal(np.asarray(a).view(np.uint32),
                          np.asarray(b).view(np.uint32))


def test_offline_chain_bitwise_reproducible(rng):
    ir = (rng.standard_normal(9000) * 0.2).astype(np.float32)
    x = rng.standard_normal((2, 20000)).astype(np.float32)
    eng = FastFIR(ir[None], fft_size=4096)
    f = jax.jit(FastFIR.apply)
    y1 = f(eng.spectra, jnp.asarray(x))
    y2 = f(eng.spectra, jnp.asarray(x))
    assert _bitwise_equal(y1, y2)


def test_streaming_scan_bitwise_reproducible(rng):
    scheme = PartitionScheme((64, 256), zero_latency=True)
    blk = 128
    ir = mono.prepare_ir(scheme, (rng.standard_normal((2, 500)) * 0.3
                                  ).astype(np.float32), offline_tail=False)
    x = jnp.asarray(rng.standard_normal((2, blk * 6)).astype(np.float32))
    f = jax.jit(mono.process)
    s0 = mono.init_state(scheme, ir, batch_shape=(2,))
    _, y1 = f(ir, s0, x)
    _, y2 = f(ir, s0, x)
    assert _bitwise_equal(y1, y2)


def test_sharded_bitwise_reproducible(rng):
    from hisstools_library.parallel import make_mesh, scheme_offline_sharded

    mesh = make_mesh(channel=2, block=4)
    scheme = PartitionScheme((4096,), zero_latency=False)
    ir = mono.prepare_ir(scheme, (rng.standard_normal((4, 5000)) * 0.2
                                  ).astype(np.float32), offline_tail=False)
    x = jnp.asarray(rng.standard_normal((4, 2048 * 8)).astype(np.float32))
    y1 = scheme_offline_sharded(mesh, scheme, ir, x)
    y2 = scheme_offline_sharded(mesh, scheme, ir, x)
    assert _bitwise_equal(y1, y2)


def test_checkpoint_resume_bitexact(rng):
    """Restarting the scan from a saved (checkpointed) state pytree continues
    bitwise-identically — checkpoint/resume per SURVEY.md §5."""
    scheme = PartitionScheme((64, 256), zero_latency=True)
    blk = 128
    ir = mono.prepare_ir(scheme, (rng.standard_normal(700) * 0.3
                                  ).astype(np.float32)[None],
                         offline_tail=False)
    x = rng.standard_normal((1, blk * 8)).astype(np.float32)
    f = jax.jit(mono.process)

    s = mono.init_state(scheme, ir, batch_shape=(1,))
    s, y_a = f(ir, s, jnp.asarray(x[:, :blk * 4]))

    # "Checkpoint": round-trip the state pytree through host numpy.
    leaves, treedef = jax.tree_util.tree_flatten(s)
    restored = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(np.asarray(l)) for l in leaves])

    _, y_b1 = f(ir, s, jnp.asarray(x[:, blk * 4:]))
    _, y_b2 = f(ir, restored, jnp.asarray(x[:, blk * 4:]))
    assert _bitwise_equal(y_b1, y_b2)


def test_long_stream_no_snr_drift(rng):
    """Late-stream SNR equals early-stream SNR after hundreds of hops
    (SURVEY §7 'hard part': long IRs accumulating f32 error across thousands
    of partition firings) — the functional state has no error feedback, so
    accuracy is stationary. Probed at 1200 hops (~135 dB both ends); pinned
    here at 400 hops."""
    import jax
    from hisstools_library.models import mono
    from hisstools_library.models.mono import PartitionScheme

    scheme = PartitionScheme((32, 128, 512), zero_latency=True)
    ir = (rng.standard_normal(2000) *
          np.exp(-np.arange(2000) / 600)).astype(np.float32)
    mir = mono.prepare_ir(scheme, ir, dtype=jnp.float32, offline_tail=False)
    st = mono.init_state(scheme, mir, (), jnp.float32)
    hop, T = 256, 400
    x = rng.standard_normal(T * hop).astype(np.float32)
    step = jax.jit(lambda s, b: mono.process(mir, s, b))
    first = last = None
    for j in range(T):
        st, y = step(st, jnp.asarray(x[j * hop:(j + 1) * hop]))
        if j == 4:
            first = (j, np.asarray(y))
        if j == T - 1:
            last = (j, np.asarray(y))
    ref = np.convolve(x.astype(np.float64), ir.astype(np.float64))

    def snr(j, y):
        r = ref[j * hop:(j + 1) * hop]
        d = y.astype(np.float64) - r
        return 10 * np.log10((r * r).sum() / max((d * d).sum(), 1e-300))

    s_first, s_last = snr(*first), snr(*last)
    assert s_first > 120.0 and s_last > 120.0
    assert abs(s_first - s_last) < 15.0  # stationary accuracy, no drift
