"""Two-tier block-collapsed streaming (mono.MonoBlockState).

The Zero preset's final section MACs the whole far IR at its own hop — the
dominant cost of a long-IR stream. The two-tier path
re-chunks the IR beyond G partitions at hop G*h (mono._process_block_two_tier)
while preserving the scheme's output exactly and the hand-off to the
per-section / sample-granular paths. Reference analogue: the non-uniform
section ladder itself (MonoConvolve.cpp:26-31)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hisstools_library.models import mono
from hisstools_library.models.mono import LatencyMode, PartitionScheme


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(
        np.sum(ref * ref) / max(d, 1e-300))


SCHEME = PartitionScheme((32, 64, 128, 256), zero_latency=True)
IR_LEN = 4096          # far hop 1024 (choose_fft_size -> 2048), P2 = 3


def _prep(rng, scheme=SCHEME, ir_len=IR_LEN, batch=()):
    shape = batch + (ir_len,)
    ir = rng.standard_normal(shape) * np.exp(
        -np.arange(ir_len) / (ir_len / 3.0))
    mir = mono.prepare_ir(scheme, ir, dtype=jnp.float64, offline_tail=False)
    assert mir.far is not None
    return ir, mir


def test_far_tier_built_and_shaped(rng):
    ir, mir = _prep(rng)
    h = mir.spectra[-1].shape[-1]
    h2 = mir.far.shape[-1]
    assert h2 % h == 0 and h2 // h >= 2
    # coverage: block0 [0,h) + near [h, g*h) + far [g*h, end) for zero latency
    g = h2 // h
    p2 = mir.far.shape[-2]
    assert (p2 - 1) * h2 < IR_LEN - h2 <= p2 * h2


@pytest.mark.parametrize("mode", [LatencyMode.Zero, LatencyMode.Short])
def test_two_tier_matches_oracle_and_per_section(rng, mode):
    """Carried two-tier state over several blocks == np.convolve (delayed by
    the scheme latency) == the per-section MonoState path."""
    sizes = (32, 64, 128, 256)
    scheme = PartitionScheme(sizes, zero_latency=(mode == LatencyMode.Zero))
    ir, mir = _prep(rng, scheme)
    lat = scheme.latency
    h2 = mir.far.shape[-1]
    L = h2 * 3
    st2 = mono.init_block_state(scheme, mir, dtype=jnp.float64)
    st_ref = mono.init_state(scheme, mir, dtype=jnp.float64)
    ys, ys_ref = [], []
    xs = []
    for _ in range(3):
        x = rng.standard_normal(L)
        xs.append(x)
        st2, y = mono.process(mir, st2, jnp.asarray(x))
        st_ref, y_ref = mono.process(mir, st_ref, jnp.asarray(x))
        ys.append(np.asarray(y))
        ys_ref.append(np.asarray(y_ref))
    y = np.concatenate(ys)
    y_ref = np.concatenate(ys_ref)
    xfull = np.concatenate(xs)
    full = np.convolve(xfull, ir)
    oracle = np.concatenate([np.zeros(lat), full])[:len(y)]
    assert snr_db(oracle, y) > 180
    assert snr_db(y_ref, y) > 180


def test_two_tier_batched_channels(rng):
    ir, mir = _prep(rng, batch=(3,))
    h2 = mir.far.shape[-1]
    L = h2 * 2
    st = mono.init_block_state(SCHEME, mir, (3,), jnp.float64)
    x = rng.standard_normal((3, L))
    st, y1 = mono.process(mir, st, jnp.asarray(x))
    x2 = rng.standard_normal((3, L))
    _, y2 = mono.process(mir, st, jnp.asarray(x2))
    y = np.concatenate([np.asarray(y1), np.asarray(y2)], axis=-1)
    for c in range(3):
        ref = np.convolve(np.concatenate([x[c], x2[c]]), ir[c])[:2 * L]
        assert snr_db(ref, y[c]) > 180


def test_two_tier_rejects_non_far_hop_blocks(rng):
    _, mir = _prep(rng)
    st = mono.init_block_state(SCHEME, mir, dtype=jnp.float64)
    h = mir.spectra[-1].shape[-1]
    with pytest.raises(ValueError):
        mono.process(mir, st, jnp.zeros(h))  # final hop, not far hop


def test_init_block_state_requires_far(rng):
    from hisstools_library.core.errors import ConvolveException
    scheme = PartitionScheme((32, 128), zero_latency=True)
    ir = rng.standard_normal(500)  # too short for a far tier past o2
    mir = mono.prepare_ir(scheme, ir, dtype=jnp.float64, offline_tail=False)
    assert mir.far is None
    with pytest.raises(ConvolveException):
        mono.init_block_state(scheme, mir, dtype=jnp.float64)


def test_handoff_to_per_section_continues_exactly(rng):
    """Two-tier blocks, then aligned_state_from_block -> per-section process:
    the continuation equals a per-section run from the start."""
    ir, mir = _prep(rng)
    h2 = mir.far.shape[-1]
    L = h2 * 2
    st2 = mono.init_block_state(SCHEME, mir, dtype=jnp.float64)
    st_ref = mono.init_state(SCHEME, mir, dtype=jnp.float64)
    for _ in range(3):
        x = rng.standard_normal(L)
        st2, _ = mono.process(mir, st2, jnp.asarray(x))
        st_ref, _ = mono.process(mir, st_ref, jnp.asarray(x))
    lifted = mono.aligned_state_from_block(mir, st2)
    xq = rng.standard_normal(L)
    _, y_cont = mono.process(mir, lifted, jnp.asarray(xq))
    _, y_ref = mono.process(mir, st_ref, jnp.asarray(xq))
    assert snr_db(np.asarray(y_ref), np.asarray(y_cont)) > 250


def test_handoff_to_process_any_continues_exactly(rng):
    """stream_state_from_block -> process_any over ragged callbacks equals the
    per-section streaming run (the real-time hand-off the collapsed path
    promises)."""
    ir, mir = _prep(rng)
    h2 = mir.far.shape[-1]
    L = h2 * 2
    st2 = mono.init_block_state(SCHEME, mir, dtype=jnp.float64)
    st_ref = mono.init_state(SCHEME, mir, dtype=jnp.float64)
    for _ in range(3):
        x = rng.standard_normal(L)
        st2, _ = mono.process(mir, st2, jnp.asarray(x))
        st_ref, _ = mono.process(mir, st_ref, jnp.asarray(x))
    ss = mono.stream_state_from_block(mir, st2)
    ss_ref = mono.stream_state_from_aligned(mir, st_ref)
    for blk in (17, 64, 200, 333):
        xq = rng.standard_normal(blk)
        ss, y = mono.process_any(mir, ss, jnp.asarray(xq))
        ss_ref, y_ref = mono.process_any(mir, ss_ref, jnp.asarray(xq))
        assert snr_db(np.asarray(y_ref), np.asarray(y)) > 250, blk


def test_block_state_from_hist_roundtrip(rng):
    """Lifting raw history into a two-tier state continues identically to a
    two-tier run over that same history."""
    ir, mir = _prep(rng)
    h = mir.spectra[-1].shape[-1]
    h2 = mir.far.shape[-1]
    s_rows = None
    st2 = mono.init_block_state(SCHEME, mir, dtype=jnp.float64)
    s_rows = st2.hist.shape[-2]
    need = s_rows * h
    # feed exactly `need` samples so the whole history window is real input
    n_blocks = -(-need // h2)
    xs = rng.standard_normal(n_blocks * h2)
    run = st2
    i = 0
    while i < len(xs):
        run, _ = mono.process(mir, run, jnp.asarray(xs[i:i + h2]))
        i += h2
    hist = xs[-need:]
    lifted = mono.block_state_from_hist(mir, jnp.asarray(hist))
    xq = rng.standard_normal(h2)
    _, y_a = mono.process(mir, run, jnp.asarray(xq))
    _, y_b = mono.process(mir, lifted, jnp.asarray(xq))
    assert snr_db(np.asarray(y_a), np.asarray(y_b)) > 250


def test_convolver_block_state_parallel(rng):
    """multichannel.Convolver drives the two-tier path per channel."""
    from hisstools_library.models import multichannel

    conv = multichannel.Convolver(2, scheme=SCHEME)
    irs = rng.standard_normal((2, IR_LEN)) * 0.3
    conv.set_all(irs)
    conv.prepare(dtype=jnp.float64)
    st = conv.init_block_state(dtype=jnp.float64)
    h2 = conv.ir.far.shape[-1]
    x = rng.standard_normal((2, h2 * 2))
    st, y = conv.process(st, jnp.asarray(x))
    for c in range(2):
        ref = np.convolve(x[c], irs[c])[:x.shape[-1]]
        assert snr_db(ref, np.asarray(y)[c]) > 180


def test_block_state_checkpoint_roundtrip(rng, tmp_path):
    """MonoBlockState serialises through the checkpoint layer and resumes
    identically (SURVEY §5 checkpoint/resume applies to the new state type)."""
    from hisstools_library.utils import checkpoint

    ir, mir = _prep(rng)
    h2 = mir.far.shape[-1]
    st = mono.init_block_state(SCHEME, mir, dtype=jnp.float64)
    x1 = rng.standard_normal(h2)
    st, _ = mono.process(mir, st, jnp.asarray(x1))
    path = tmp_path / "blockstate.npz"
    checkpoint.save_npz(str(path), {"state": st})
    loaded = checkpoint.restore_npz(str(path), {"state": st})["state"]
    x2 = rng.standard_normal(h2)
    _, y_a = mono.process(mir, st, jnp.asarray(x2))
    _, y_b = mono.process(mir, loaded, jnp.asarray(x2))
    np.testing.assert_array_equal(np.asarray(y_a), np.asarray(y_b))


def test_two_tier_f32(rng):
    """The f32 two-tier path matches the float64 oracle at f32 accuracy."""
    ir, mir0 = _prep(rng)
    mir = mono.prepare_ir(SCHEME, ir, dtype=jnp.float32, offline_tail=False)
    h2 = mir.far.shape[-1]
    L = h2 * 2
    st = mono.init_block_state(SCHEME, mir, dtype=jnp.float32)
    x = rng.standard_normal(L).astype(np.float32)
    st, y1 = mono.process(mir, st, jnp.asarray(x))
    x2 = rng.standard_normal(L).astype(np.float32)
    _, y2 = mono.process(mir, st, jnp.asarray(x2))
    y = np.concatenate([np.asarray(y1), np.asarray(y2)])
    ref = np.convolve(np.concatenate([x, x2]).astype(np.float64),
                      np.asarray(ir, np.float64))[:2 * L]
    assert snr_db(ref, y) > 90
