"""End-to-end multichannel IR measurement pipeline.

Composes the framework the way HIRT composes the reference library: excitation
deconvolution -> N-to-mono reduction -> spectral smoothing -> phase reshaping ->
spectral peak finding -> sinusoidal partial tracking.

- :func:`ir_deconvolve` — regularised spectral division
  ``H = Y * conj(X) / (|X|^2 + eps)`` on packed spectra (the HIRT deconvolution
  core built from the reference's per-bin machinery: correlate + amplitude
  regularisation; SpectralFunctions.hpp provides the pieces, HIRT the recipe).
- :func:`find_peaks` — local spectral maxima with parabolic (quadratic-log)
  interpolation of frequency and amplitude, top-K by amplitude, fully vectorised.
- :class:`IRPipeline` / :func:`run_ir_pipeline` — the full chain, jittable up to
  the (host-orchestrated) tracker loop.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Split, cmul_conj
from ..fft import api as fft_api
from ..ops import smoothing, spectral, spectral_processor as sp
from . import partial_tracker as pt


def ir_deconvolve(measured: jax.Array, excitation: jax.Array,
                  regularization: float = 1e-4,
                  backend: Optional[str] = None) -> jax.Array:
    """Deconvolve the excitation from a measured response.

    Both inputs are time signals (..., L); the result is the impulse response at
    the common FFT size (next pow2 of the longer input), computed as
    ``irfft( Y conj(X) / (|X|^2 + reg * max|X|^2) )``.
    """
    n1 = measured.shape[-1]
    n2 = excitation.shape[-1]
    fft_log2 = sp.calc_fft_size_log2(max(n1, n2))
    n = 1 << fft_log2

    Y = Split(*fft_api.rfft_padded(measured, n, backend=backend))
    X = Split(*fft_api.rfft_padded(excitation, n, backend=backend))

    # Work on unpacked full spectra to keep DC/Nyquist handling transparent.
    yr, yi = fft_api.unpack_spectrum(Y)
    xr, xi = fft_api.unpack_spectrum(X)
    power = xr * xr + xi * xi
    floor = regularization * jnp.max(power, axis=-1, keepdims=True)
    denom = power + floor
    num = cmul_conj(Split(yr, yi), Split(xr, xi))
    H = fft_api.pack_spectrum(num.re / denom, num.im / denom)
    h = fft_api.rifft(H.re, H.im, backend=backend) * (0.5 / n)
    return h


def find_peaks(amp_spectrum: jax.Array, n_peaks: int, bin_hz: float = 1.0,
               min_amp: float = 0.0) -> Tuple[jax.Array, jax.Array]:
    """Top-K local maxima of an amplitude spectrum with parabolic interpolation.

    Returns (freqs, amps) of shape (..., n_peaks); absent peaks have amp 0.
    Parabolic refinement runs in the log-amplitude domain (standard quadratic
    peak interpolation).
    """
    a = amp_spectrum
    left = a[..., :-2]
    mid = a[..., 1:-1]
    right = a[..., 2:]
    is_peak = (mid > left) & (mid >= right) & (mid > min_amp)

    la = jnp.log(jnp.maximum(a, 1e-30))
    alpha = la[..., :-2]
    beta = la[..., 1:-1]
    gamma = la[..., 2:]
    denom = alpha - 2 * beta + gamma
    delta = jnp.where(jnp.abs(denom) > 1e-12,
                      0.5 * (alpha - gamma) / jnp.where(denom == 0, 1.0, denom),
                      0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    interp_amp = jnp.exp(beta - 0.25 * (alpha - gamma) * delta)
    bin_idx = jnp.arange(1, a.shape[-1] - 1, dtype=a.dtype)

    score = jnp.where(is_peak, mid, -jnp.inf)
    order = jnp.argsort(-score, axis=-1)[..., :n_peaks]
    freqs = jnp.take_along_axis(bin_idx + delta, order, axis=-1) * bin_hz
    amps = jnp.take_along_axis(jnp.where(is_peak, interp_amp, 0.0), order, axis=-1)
    amps = jnp.where(jnp.take_along_axis(is_peak, order, axis=-1), amps, 0.0)
    freqs = jnp.where(amps > 0, freqs, 0.0)
    return freqs, amps


@functools.lru_cache(maxsize=8)
def _chain_jit(sample_rate: float, regularization: float,
               smooth_widths: Tuple[float, float], kernel_key: tuple,
               n_peaks: int, phase: Optional[float], backend: Optional[str]):
    """One jitted device program for the whole measurable chain (deconvolve ->
    mono -> amplitude -> smooth -> peaks) instead of one dispatch per op;
    the tracker stays host-side."""
    kernel = np.asarray(kernel_key, np.float64)

    def fn(measured, excitation):
        h = ir_deconvolve(measured, excitation, regularization,
                          backend=backend)
        h_mono = jnp.mean(h, axis=0) if h.ndim > 1 else h
        if phase is not None:
            h_mono = sp.change_phase(h_mono, phase, backend=backend)
        n = h_mono.shape[-1]
        H = Split(*fft_api.rfft(h_mono, backend=backend))
        amp = jnp.sqrt(H.re * H.re + H.im * H.im) * 0.5  # undo the x2 packing
        # Restore the true DC magnitude from the packed lane.
        amp = amp.at[..., 0].set(jnp.abs(H.re[..., 0]) * 0.5)
        smoothed = smoothing.smooth(amp, kernel, smooth_widths[0],
                                    smooth_widths[1], symmetric=True,
                                    edges=smoothing.EdgeMode.Extend,
                                    backend=backend)
        freqs, amps = find_peaks(smoothed, n_peaks, bin_hz=sample_rate / n)
        return h_mono, smoothed, freqs, amps

    return jax.jit(fn)


@functools.lru_cache(maxsize=8)
def _frames_chain_jit(sample_rate: float, regularization: float,
                      smooth_widths: Tuple[float, float], kernel_key: tuple,
                      n_peaks: int, stft_size: int, stft_hop: int,
                      config: pt.TrackerConfig, start_threshold: float,
                      phase: Optional[float], backend: Optional[str]):
    """The multi-frame config-5 chain as ONE device program.

    Deconvolve -> mono -> (optional phase reshape) -> STFT -> per-frame
    amplitude -> variable-width smooth (batched over frames) -> per-frame
    peaks -> partial tracking via ``lax.scan`` of :func:`partial_tracker.process`
    — the on-device analogue of HIRT's frame loop feeding
    ``partial_tracker::process`` (reference PartialTracker.hpp:224-289 driven
    per frame as in - Test/Peak_Tester/Peak_Tester/main.cpp:29-49). Nothing
    leaves the device between stages; the tracker's greedy assignment loop
    runs inside the scan."""
    from ..ops import windows

    kernel = np.asarray(kernel_key, np.float64)
    win = np.asarray(windows.hann(stft_size - 1, dtype=jnp.float64))

    def fn(measured, excitation):
        h = ir_deconvolve(measured, excitation, regularization,
                          backend=backend)
        h_mono = jnp.mean(h, axis=0) if h.ndim > 1 else h
        if phase is not None:
            h_mono = sp.change_phase(h_mono, phase, backend=backend)

        from ..ops import stft as stft_mod
        S = stft_mod.stft(h_mono, win, stft_size, stft_hop, backend=backend)
        amp = jnp.sqrt(S.re * S.re + S.im * S.im) * 0.5     # (F, K)
        amp = amp.at[..., 0].set(jnp.abs(S.re[..., 0]) * 0.5)
        smoothed = smoothing.smooth(amp, kernel, smooth_widths[0],
                                    smooth_widths[1], symmetric=True,
                                    edges=smoothing.EdgeMode.Extend,
                                    backend=backend)
        freqs, amps = find_peaks(smoothed, n_peaks,
                                 bin_hz=sample_rate / stft_size)  # (F, P)
        n_valid = jnp.sum(amps > 0.0, axis=-1)                    # (F,)

        st0 = pt.TrackerState.init(config.max_tracks, freqs.dtype)

        def step(st, frame):
            f, a, nv = frame
            st, chg = pt.process(config, st, f, a, nv, start_threshold)
            return st, (st.freq, st.amp, st.state)

        _, (tf, ta, ts) = jax.lax.scan(step, st0, (freqs, amps, n_valid))
        return h_mono, smoothed, freqs, amps, tf, ta, ts

    return jax.jit(fn)


@dataclasses.dataclass
class IRFramesResult:
    impulse: np.ndarray          # deconvolved mono IR (time domain)
    smoothed_amp: np.ndarray     # (frames, bins) smoothed amplitude spectra
    peak_freqs: np.ndarray       # (frames, n_peaks) Hz
    peak_amps: np.ndarray        # (frames, n_peaks)
    track_freqs: np.ndarray      # (frames, n_tracks) Hz per tracked partial
    track_amps: np.ndarray       # (frames, n_tracks)
    track_states: np.ndarray     # (frames, n_tracks) OFF/START/CONTINUE/SWITCH


def run_ir_pipeline_frames(measured: jax.Array, excitation: jax.Array,
                           sample_rate: float = 48000.0,
                           regularization: float = 1e-4,
                           smooth_widths: Tuple[float, float] = (1.0, 63.0),
                           smooth_kernel=None,
                           n_peaks: int = 16,
                           n_tracks: Optional[int] = None,
                           stft_size: int = 1024,
                           stft_hop: int = 512,
                           tracker_config: Optional[pt.TrackerConfig] = None,
                           start_threshold: float = 0.0,
                           phase: Optional[float] = None,
                           backend: Optional[str] = None) -> IRFramesResult:
    """Config-5 pipeline over STFT frames with on-device partial tracking.

    Unlike :func:`run_ir_pipeline` (single whole-IR frame, host tracker), the
    whole multi-frame chain — deconvolution, per-frame smoothing/peaks and the
    sinusoidal tracking scan — is one jitted device program; only the final
    results transfer to the host."""
    from ..ops import windows

    if smooth_kernel is None:
        smooth_kernel = np.asarray(windows.hann(127, dtype=jnp.float64))[63:]
    if tracker_config is None:
        tracker_config = pt.TrackerConfig(
            max_peaks=n_peaks, max_tracks=n_tracks or n_peaks)
    fn = _frames_chain_jit(
        float(sample_rate), float(regularization),
        (float(smooth_widths[0]), float(smooth_widths[1])),
        tuple(np.asarray(smooth_kernel, np.float64).tolist()),
        int(n_peaks), int(stft_size), int(stft_hop), tracker_config,
        float(start_threshold), phase, backend)
    h, sm, f, a, tf, ta, ts = jax.device_get(fn(measured, excitation))
    return IRFramesResult(h, sm, f, a, tf, ta, ts)


@dataclasses.dataclass
class IRPipelineResult:
    impulse: np.ndarray          # deconvolved mono IR (time domain)
    smoothed_amp: np.ndarray     # smoothed amplitude spectrum
    peak_freqs: np.ndarray       # (n_peaks,) Hz
    peak_amps: np.ndarray        # (n_peaks,)
    tracker_state: pt.TrackerState


def run_ir_pipeline(measured: jax.Array, excitation: jax.Array,
                    sample_rate: float = 48000.0,
                    regularization: float = 1e-4,
                    smooth_widths: Tuple[float, float] = (1.0, 63.0),
                    smooth_kernel=None,
                    n_peaks: int = 16,
                    tracker: Optional[pt.PartialTracker] = None,
                    phase: Optional[float] = None,
                    backend: Optional[str] = None) -> IRPipelineResult:
    """The config-5 chain: deconvolve (per input channel) -> sum to mono ->
    smooth the amplitude spectrum -> find peaks -> advance the partial tracker.

    ``measured``: (N, L) multichannel capture; ``excitation``: (L_e,) the stimulus.
    ``phase``: optionally reshape the IR phase (0 = minimum, 0.5 = linear, ...)
    through :func:`spectral.ir_phase` before analysis.
    """
    from ..ops import windows

    if smooth_kernel is None:
        smooth_kernel = np.asarray(windows.hann(127, dtype=jnp.float64))[63:]
    fn = _chain_jit(float(sample_rate), float(regularization),
                    (float(smooth_widths[0]), float(smooth_widths[1])),
                    tuple(np.asarray(smooth_kernel, np.float64).tolist()),
                    int(n_peaks), phase, backend)
    # One batched device->host transfer instead of one per array.
    h_np, sm_np, f_np, a_np = jax.device_get(fn(measured, excitation))

    if tracker is None:
        tracker = pt.PartialTracker(n_peaks, n_peaks, dtype=jnp.float64)
    # find_peaks pads absent slots with freq=0/amp=0; feeding those through
    # with start_threshold=0.0 would start a bogus 0 Hz track per pad slot,
    # so only the genuine peaks reach the tracker.
    a64 = np.asarray(a_np, np.float64)
    n_valid = int(np.count_nonzero(a64 > 0.0))
    tracker.process(np.asarray(f_np, np.float64)[:n_valid], a64[:n_valid],
                    start_threshold=0.0)

    return IRPipelineResult(
        impulse=h_np,
        smoothed_amp=sm_np,
        peak_freqs=f_np,
        peak_amps=a_np,
        tracker_state=tracker.state,
    )
