"""STFT analysis/resynthesis and the IR measurement pipeline."""

import numpy as np
import pytest

import jax.numpy as jnp

from hisstools_library.core.types import Split
from hisstools_library.models import pipeline
from hisstools_library.ops import stft as stft_mod
from hisstools_library.ops import windows


def snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / d)


@pytest.mark.parametrize("win,hop", [("hann", 256), ("hann", 128),
                                     ("kaiser", 256), ("sine", 341)])
def test_stft_istft_roundtrip(rng, win, hop):
    n = 1024
    L = 8192
    x = rng.standard_normal(L)
    p = windows.Params(a0=8.0) if win == "kaiser" else windows.Params()
    w = np.asarray(windows.generate(win, n - 1, params=p, dtype=jnp.float64))
    S = stft_mod.stft(jnp.asarray(x), w, n, hop, boundary=True)
    y = stft_mod.istft(S, w, hop, length=L, boundary=True)
    assert snr_db(x, y) > 140


def test_stft_batched_channels(rng):
    n, hop, L = 512, 128, 4096
    x = rng.standard_normal((3, L))
    w = np.asarray(windows.hann(n - 1, dtype=jnp.float64))
    S = stft_mod.stft(jnp.asarray(x), w, n, hop, boundary=True)
    assert S.shape[:1] == (3,)
    y = stft_mod.istft(S, w, hop, length=L, boundary=True)
    for c in range(3):
        assert snr_db(x[c], np.asarray(y)[c]) > 140


def test_stft_bin_content(rng):
    # A pure bin-centred sinusoid concentrates in the right STFT bin.
    n, hop = 512, 256
    k = 20
    t = np.arange(4096)
    x = np.cos(2 * np.pi * k * t / n)
    w = np.asarray(windows.hann(n - 1, dtype=jnp.float64))
    S = stft_mod.stft(jnp.asarray(x), w, n, hop)
    mag = np.hypot(np.asarray(S.re), np.asarray(S.im))[3]  # a middle frame
    assert mag.argmax() == k


def test_stft_spectral_op_composability(rng):
    # ir_* ops apply per frame: delaying every frame by D samples shifts the
    # resynthesis circularly within frames - smoke test via amplitude invariance.
    from hisstools_library.ops import spectral
    n, hop, L = 256, 64, 2048
    x = rng.standard_normal(L)
    w = np.asarray(windows.hann(n - 1, dtype=jnp.float64))
    S = stft_mod.stft(jnp.asarray(x), w, n, hop, boundary=True)
    S2 = spectral.ir_time_reverse(spectral.ir_time_reverse(S))
    y = stft_mod.istft(S2, w, hop, length=L, boundary=True)
    assert snr_db(x, y) > 140


# -- pipeline --------------------------------------------------------------------

def test_deconvolve_recovers_ir(rng):
    # measured = conv(excitation, h): deconvolution recovers h.
    L = 2048
    exc = rng.standard_normal(L)
    h_true = np.zeros(256)
    h_true[:64] = rng.standard_normal(64) * np.exp(-np.arange(64) / 16)
    measured = np.convolve(exc, h_true)  # full linear convolution
    h = pipeline.ir_deconvolve(jnp.asarray(measured), jnp.asarray(exc),
                               regularization=1e-12)
    assert snr_db(h_true, np.asarray(h)[:256]) > 100


def test_deconvolve_multichannel(rng):
    L = 1024
    exc = rng.standard_normal(L)
    hs = rng.standard_normal((3, 32))
    measured = np.stack([np.convolve(exc, hs[c]) for c in range(3)])
    h = pipeline.ir_deconvolve(jnp.asarray(measured), jnp.asarray(exc),
                               regularization=1e-12)
    for c in range(3):
        assert snr_db(hs[c], np.asarray(h)[c, :32]) > 100


def test_find_peaks_sinusoids():
    n = 4096
    t = np.arange(n)
    x = (1.0 * np.sin(2 * np.pi * 440 * t / 48000)
         + 0.5 * np.sin(2 * np.pi * 1000 * t / 48000)
         + 0.25 * np.sin(2 * np.pi * 3500 * t / 48000))
    spec = np.abs(np.fft.rfft(x * np.hanning(n)))[:n // 2]
    freqs, amps = pipeline.find_peaks(jnp.asarray(spec), 3, bin_hz=48000 / n)
    f = np.sort(np.asarray(freqs))
    assert abs(f[0] - 440) < 12
    assert abs(f[1] - 1000) < 12
    assert abs(f[2] - 3500) < 12
    # amplitude ordering follows the components
    order = np.argsort(-np.asarray(amps))
    assert abs(np.asarray(freqs)[order[0]] - 440) < 12


def test_full_pipeline_runs(rng):
    L = 4096
    exc = rng.standard_normal(L)
    h_true = np.exp(-np.arange(128) / 16.0)
    measured = np.stack([np.convolve(exc, h_true) for _ in range(4)])
    res = pipeline.run_ir_pipeline(jnp.asarray(measured), jnp.asarray(exc),
                                   sample_rate=48000.0, n_peaks=8)
    assert snr_db(h_true, res.impulse[:128]) > 40
    assert res.smoothed_amp.shape == (res.impulse.shape[-1] // 2,)
    assert np.all(np.isfinite(res.smoothed_amp))
    assert res.peak_freqs.shape == (8,)
    # tracker advanced without error
    assert res.tracker_state.freq.shape == (8,)


def test_frames_pipeline_tracks_partials(rng):
    """Multi-frame config-5 chain: deconvolve -> STFT -> per-frame smooth /
    peaks -> on-device tracking scan. A 3-mode decaying IR must produce
    tracks near the mode frequencies that persist across frames."""
    import hisstools_library.models.partial_tracker as pt_mod
    L = 1 << 14
    fs = 48000.0
    exc = rng.standard_normal(L)
    t = np.arange(2048)
    modes = (1000.0, 5000.0, 12000.0)
    h_true = sum(np.sin(2 * np.pi * f * t / fs) * np.exp(-t / 800.0)
                 for f in modes)
    measured = np.stack([np.convolve(exc, h_true) for _ in range(2)])
    res = pipeline.run_ir_pipeline_frames(
        jnp.asarray(measured, jnp.float32), jnp.asarray(exc, jnp.float32),
        sample_rate=fs, n_peaks=8, regularization=1e-9,
        stft_size=1024, stft_hop=512)
    frames = res.track_freqs.shape[0]
    assert frames > 4
    assert res.track_states.shape == res.track_freqs.shape
    # impulse parity with the single-frame pipeline's deconvolution
    ref = pipeline.run_ir_pipeline(jnp.asarray(measured, jnp.float32),
                                   jnp.asarray(exc, jnp.float32),
                                   regularization=1e-9, n_peaks=8)
    assert snr_db(ref.impulse, res.impulse) > 80
    # early frames (IR still ringing) must track each mode within a bin
    early = res.track_freqs[:4]
    early_active = res.track_states[:4] != pt_mod.OFF
    for f in modes:
        near = np.abs(early - f) < fs / 1024
        assert np.any(near & early_active), f
    # pads must not start 0 Hz tracks (same property as the 1-frame path)
    assert not np.any((res.track_states != pt_mod.OFF)
                      & (res.track_freqs == 0.0))


def test_pipeline_with_phase_reshape(rng):
    L = 2048
    exc = rng.standard_normal(L)
    h_true = np.exp(-np.arange(64) / 8.0)
    measured = np.stack([np.convolve(exc, h_true) for _ in range(2)])
    res = pipeline.run_ir_pipeline(jnp.asarray(measured), jnp.asarray(exc),
                                   phase=0.0, n_peaks=4)
    assert np.all(np.isfinite(res.impulse))


def test_pipeline_no_phantom_zero_tracks(rng):
    """find_peaks pads absent slots with freq=0/amp=0; those pads must not
    start tracks (they used to: 13/16 bogus 0 Hz STARTs on a 3-peak IR)."""
    import hisstools_library.models.partial_tracker as pt_mod
    L = 4096
    exc = rng.standard_normal(L)
    # A narrow 3-mode IR: only a handful of genuine spectral peaks.
    t = np.arange(256)
    h_true = sum(np.sin(2 * np.pi * f * t / 48000.0) * np.exp(-t / 40.0)
                 for f in (1000.0, 5000.0, 12000.0))
    measured = np.stack([np.convolve(exc, h_true) for _ in range(2)])
    res = pipeline.run_ir_pipeline(jnp.asarray(measured), jnp.asarray(exc),
                                   sample_rate=48000.0, n_peaks=16)
    st = res.tracker_state
    active = np.asarray(st.state) != pt_mod.OFF
    zero_freq_active = active & (np.asarray(st.freq) == 0.0)
    assert not np.any(zero_freq_active)


def test_stft_helpers():
    from hisstools_library.ops import stft as stft_mod
    # un-padded frame count: 1 + (L - N) // hop
    assert stft_mod.num_frames(1024, 256, 128) == 1 + (1024 - 256) // 128
    fwd, inv = stft_mod.stft_roundtrip_scale_check()
    assert np.isfinite(fwd) and np.isfinite(inv)
