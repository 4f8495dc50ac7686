"""Benchmark harness: convolved samples/s/chip on the flagship workload.

Workload: 128 parallel channels, 10 s impulse response at 48 kHz, float32
partitioned convolution on one chip.

Modes (BENCH_MODE env):
- ``fast`` (default): uniform partitioned overlap-save (FastFIR) — the
  offline/throughput configuration (the reference's offline path is
  spectral_processor's single big FFT; uniform partitioning is its
  memory-bounded equivalent).
- ``scheme``: the zero-latency non-uniform scheme (TD head + 256/1024/4096/16384,
  the reference kLatencyZero preset, MonoConvolve.cpp:26-31) — the real-time-
  capable engine, batched offline.
- ``stream``: hop-aligned streaming (8192-sample blocks, batched hop advance).
- ``latency``: per-callback latency of the sample-granular streaming path
  (process_any, ANY block size — BENCH_BLOCK env, default 256): a chain of
  sequentially-dependent jitted steps, one sync at the end, reporting
  ms/block. The reference's whole design goal (MonoConvolve.cpp:26-31) is
  bounded per-callback latency; this is its measurement.
- ``fft``: 1024-pt real FFT/iFFT round-trip (- Test/FFT_Tester
  matched_size_test analogue).
- ``stft``: Hann-windowed STFT analysis/resynthesis.
- ``tdfir``: 64-tap time-domain FIR.
- ``pipeline``: IR measurement chain (deconvolve + smooth + partial track;
  IR_Manipulation_Tester + Peak_Tester analogue).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} where value is
convolved channel-samples per second per chip and vs_baseline is the real-time
factor against the workload's native rate (128 ch x 48 kHz) — the reference
publishes no absolute numbers, so real-time headroom is the meaningful
normalised figure.
"""

import json
import os
import sys
import time
from functools import partial

import numpy as np


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _time_chain(fn, n_iters: int, rounds: int = 3):
    """Slope-timed seconds/iteration: time dispatch chains of N and 2N
    (one sync each) and take the slope, so the fixed dispatch and sync cost
    cancels (the same methodology as the headline/latency benches). Returns
    (sec/iter, (chain_N_sec, chain_2N_sec))."""
    import jax

    def chain_best(k: int) -> float:
        best = np.inf
        for _ in range(rounds):
            t0 = time.time()
            out = None
            for _ in range(k):
                out = fn()
            jax.block_until_ready(out)
            best = min(best, time.time() - t0)
        return best

    t_n = chain_best(n_iters)
    t_2n = chain_best(2 * n_iters)
    return (t_2n - t_n) / n_iters, (t_n, t_2n)


def emit(metric: str, value: float, unit: str, vs_baseline: float):
    print(json.dumps({
        "metric": metric,
        "value": round(value, 1),
        "unit": unit,
        "vs_baseline": round(vs_baseline, 3),
    }))


def run_latency(channels: int, fs: int, irs, backend: str):
    """Per-callback latency of the sample-granular streaming engine
    (BENCH_MODE=latency): M sequentially-dependent process_any steps, one
    sync; reports ms/block. BENCH_BLOCK sets the callback size (any value)."""
    import jax
    import jax.numpy as jnp
    from hisstools_library.models import mono
    from hisstools_library.models.mono import LatencyMode, PartitionScheme

    block = int(os.environ.get("BENCH_BLOCK", "256"))
    scheme = PartitionScheme.from_latency(LatencyMode.Zero)
    big_hop = scheme.sizes[-1] >> 1
    # Enough blocks that every section (incl. the 8192-hop one) fires several
    # times inside the timed chain.
    m = max(2 * big_hop // block, 16)

    t0 = time.time()
    ir = mono.prepare_ir(scheme, irs, dtype=jnp.float32, offline_tail=False)
    jax.block_until_ready(ir.head_taps)
    log(f"latency: zero scheme {scheme.sizes}, block {block}, chain {m} steps; "
        f"IR prepared in {time.time() - t0:.2f}s")

    rng = np.random.default_rng(1)
    blocks = [jnp.asarray(rng.standard_normal((channels, block)), jnp.float32)
              for _ in range(8)]

    step = jax.jit(
        lambda i, s, xx: mono.process_any(i, s, xx, backend=backend),
        donate_argnums=(1,))

    def chain(steps: int):
        s = mono.init_stream_state(scheme, ir, (channels,))
        y = None
        for k in range(steps):
            s, y = step(ir, s, blocks[k % len(blocks)])
        return y

    t0 = time.time()
    jax.block_until_ready(chain(2 * m))
    log(f"compile+first chain {time.time() - t0:.2f}s")

    # Time chains of M and 2M steps and take the SLOPE: the fixed
    # sync/dispatch cost cancels, leaving the per-block cost.
    def best_of(steps: int, rounds: int = 3) -> float:
        best = np.inf
        for _ in range(rounds):
            t0 = time.time()
            jax.block_until_ready(chain(steps))
            best = min(best, time.time() - t0)
        return best

    t1 = best_of(m)
    t2 = best_of(2 * m)
    per_block = (t2 - t1) / m
    log(f"chain({m}) {t1 * 1e3:.1f} ms, chain({2 * m}) {t2 * 1e3:.1f} ms "
        f"-> slope {per_block * 1e3:.3f} ms/block "
        f"(fixed overhead {max(0.0, t1 - m * per_block) * 1e3:.1f} ms)")

    # Device-side per-block cost via ONE lax.scan (no per-callback dispatch),
    # same two-length slope methodology.
    xs_scan = jnp.stack([blocks[k % len(blocks)] for k in range(2 * m)], axis=0)

    @partial(jax.jit, static_argnums=(3,))
    def scan_chain(i, s0, xs, steps):
        def body(s, xb):
            s, y = mono.process_any(i, s, xb, backend=backend)
            return s, y[..., :1]
        return jax.lax.scan(body, s0, xs[:steps])

    def scan_best(steps: int, rounds: int = 3) -> float:
        best = np.inf
        for _ in range(rounds):
            s0 = mono.init_stream_state(scheme, ir, (channels,))
            t0 = time.time()
            jax.block_until_ready(scan_chain(ir, s0, xs_scan, steps)[1])
            best = min(best, time.time() - t0)
        return best

    t0 = time.time()
    scan_best(m, 1)
    scan_best(2 * m, 1)
    log(f"scan compile+first {time.time() - t0:.2f}s")
    s1 = scan_best(m)
    s2 = scan_best(2 * m)
    scan_block = (s2 - s1) / m
    log(f"device-only (lax.scan slope) {scan_block * 1e3:.3f} ms/block")
    rt = (block / fs) / per_block
    log(f"per-block latency {per_block * 1e3:.3f} ms for {block} samples "
        f"({channels}ch); budget {block / fs * 1e3:.3f} ms -> {rt:.1f}x real time")
    emit(f"streaming per-block latency ({channels}ch, {block}-sample callbacks, "
         f"zero-latency scheme)", per_block * 1e3, "ms/block", rt)


def run_fft(backend: str):
    """1024-pt real FFT/iFFT round trip (FFT_Tester
    matched_size_test analogue, batched — the shape convolution engines use)."""
    import jax
    import jax.numpy as jnp
    from hisstools_library.fft import api as fft_api

    n = int(os.environ.get("BENCH_FFT_SIZE", "1024"))
    batch = int(os.environ.get("BENCH_FFT_BATCH", "8192"))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)

    fwd = jax.jit(lambda xx: fft_api.rifft(
        *fft_api.rfft(xx, backend=backend), backend=backend))
    jax.block_until_ready(fwd(x))
    best, (t_n, t_2n) = _time_chain(lambda: fwd(x), 20)
    log(f"fft roundtrip n={n} batch={batch}: chains {t_n*1e3:.1f}/{t_2n*1e3:.1f}"
        f" ms -> slope {best*1e3:.3f} ms/pass")
    roundtrips = batch / best
    y = fwd(x)
    snr = _snr(np.asarray(x, np.float64) * 2 * n, np.asarray(y, np.float64))
    log(f"round-trip SNR vs 2Nx: {snr:.1f} dB")
    emit(f"real FFT round-trips/s (N={n}, batch {batch})", roundtrips,
         "roundtrips/s", roundtrips * n / 48000.0)


def run_stft(channels: int, fs: int, backend: str):
    """Hann-windowed STFT analysis/resynthesis."""
    import jax
    import jax.numpy as jnp
    from hisstools_library.ops import stft as stft_mod
    from hisstools_library.ops import windows

    n, hop = 1024, 512
    sig_len = int(float(os.environ.get("BENCH_SIG_SECONDS", "10")) * fs)
    sig_len = (sig_len // hop) * hop
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((channels, sig_len)), jnp.float32)
    w = np.asarray(windows.hann(n - 1, dtype=jnp.float64), np.float32)

    def roundtrip(xx):
        S = stft_mod.stft(xx, w, n, hop, boundary=True, backend=backend)
        return stft_mod.istft(S, w, hop, length=sig_len, boundary=True,
                              backend=backend)

    fwd = jax.jit(roundtrip)
    jax.block_until_ready(fwd(x))
    best, (t_n, t_2n) = _time_chain(lambda: fwd(x), 5)
    log(f"stft roundtrip {channels}ch x {sig_len}: chains "
        f"{t_n*1e3:.1f}/{t_2n*1e3:.1f} ms -> slope {best*1e3:.2f} ms/pass")
    y = fwd(x)
    snr = _snr(np.asarray(x[0], np.float64), np.asarray(y[0], np.float64))
    log(f"analysis/resynthesis SNR: {snr:.1f} dB")
    sps = channels * sig_len / best
    emit(f"STFT analysis+resynthesis samples/s ({channels}ch, N={n}, hop {hop})",
         sps, "samples/s/chip", sps / (channels * fs))


def run_tdfir(channels: int, fs: int, backend: str):
    """64-tap time-domain FIR (TimeDomainConvolve parity)."""
    import jax
    import jax.numpy as jnp
    from hisstools_library.models import time_domain as td

    taps = int(os.environ.get("BENCH_TAPS", "64"))
    sig_len = int(float(os.environ.get("BENCH_SIG_SECONDS", "10")) * fs)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((channels, sig_len)), jnp.float32)
    h = jnp.asarray(rng.standard_normal((channels, taps)), jnp.float32)

    fwd = jax.jit(td.fir_offline)
    jax.block_until_ready(fwd(x, h))
    best, (t_n, t_2n) = _time_chain(lambda: fwd(x, h), 10)
    log(f"td fir {taps} taps {channels}ch x {sig_len}: chains "
        f"{t_n*1e3:.1f}/{t_2n*1e3:.1f} ms -> slope {best*1e3:.2f} ms/pass")
    y = fwd(x, h)
    k = min(sig_len, 1 << 15)
    ref = np.convolve(np.asarray(x[0], np.float64),
                      np.asarray(h[0], np.float64))[:k]
    snr = _snr(ref, np.asarray(y[0][:k], np.float64))
    log(f"SNR vs float64 direct conv: {snr:.1f} dB")
    sps = channels * sig_len / best
    emit(f"time-domain FIR samples/s ({channels}ch, {taps} taps)", sps,
         "samples/s/chip", sps / (channels * fs))


def run_pipeline(fs: int, backend: str):
    """IR measurement pipeline — deconvolve the measured
    sweep response, STFT it, smooth each frame's amplitude spectrum and track
    partials across frames, all in ONE device program
    (IR_Manipulation_Tester + Peak_Tester analogue; the tracker scan is the
    on-device form of the reference's per-frame process loop,
    PartialTracker.hpp:224-289)."""
    import jax
    import jax.numpy as jnp
    from hisstools_library.models import partial_tracker as pt
    from hisstools_library.models.pipeline import _frames_chain_jit
    from hisstools_library.ops import windows
    from hisstools_library.utils.debug_stages import deconv_oracle64

    sig_len = 1 << 17
    rng = np.random.default_rng(0)
    t = np.arange(sig_len) / fs
    exc = np.sin(2 * np.pi * (20.0 * (1000.0 ** (t / t[-1]))) * t)
    ir_true = rng.standard_normal(4096) * np.exp(-np.arange(4096) / 4800.0)
    # Keep the FULL convolution: truncating the measurement cuts the sweep's
    # tail response and caps the recoverable SNR at ~29 dB regardless of the
    # pipeline's accuracy (158 dB is recoverable in f64 with the full
    # capture).
    measured = np.convolve(exc, ir_true)

    # regularization 1e-9: the default 1e-4 is sized for noisy real-world
    # captures; this synthetic capture is noiseless.
    reg = 1e-9
    n_peaks = 16
    kernel = np.asarray(windows.hann(127, dtype=jnp.float64))[63:]
    cfg = pt.TrackerConfig(max_peaks=n_peaks, max_tracks=n_peaks)
    fn = _frames_chain_jit(float(fs), reg, (1.0, 63.0),
                           tuple(kernel.tolist()), n_peaks, 1024, 512, cfg,
                           0.0, None, backend)

    md = jnp.asarray(measured, jnp.float32)
    ed = jnp.asarray(exc, jnp.float32)
    out0 = fn(md, ed)
    jax.block_until_ready(out0[0])
    best, (t_n, t_2n) = _time_chain(lambda: fn(md, ed), 5)
    log(f"ir frames pipeline ({sig_len} samples): chains "
        f"{t_n*1e3:.1f}/{t_2n*1e3:.1f} ms -> slope {best*1e3:.2f} ms/pass")

    h32, sm, pf, pa, tf, ta, ts = jax.device_get(out0)
    h64 = deconv_oracle64(measured, exc, reg)
    s = _snr(h64[:len(h32)], np.asarray(h32, np.float64))
    log(f"deconvolved IR SNR vs f64 pipeline: {s:.1f} dB")
    s_true = _snr(ir_true[:2048], np.asarray(h32[:2048], np.float64))
    active = int((ts > 0).any(axis=-1).sum())
    log(f"(vs true IR: {s_true:.1f} dB; {tf.shape[0]} frames tracked, "
        f"{active} with active partials)")
    pps = sig_len / best
    emit("IR measurement pipeline samples/s (deconvolve+smooth+track)", pps,
         "samples/s/chip", pps / fs)


def _snr(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = np.sum(err * err)
    return np.inf if d == 0 else 10 * np.log10(np.sum(ref * ref) / max(d, 1e-300))


def main():
    if os.environ.get("BENCH_MODE", "fast") == "all":
        # Full config matrix, one JSON line per config, in sequential child
        # processes: one process at a time holds the card, and per-mode
        # global state stays isolated. The persistent compile cache keeps
        # re-inits cheap. This parent never initialises JAX.
        import subprocess
        rc = 0
        for m in ("fast", "stream", "fft", "stft", "tdfir", "pipeline"):
            env = dict(os.environ, BENCH_MODE=m)
            log(f"=== BENCH_MODE={m} ===")
            r = subprocess.run([sys.executable, os.path.abspath(__file__)],
                               env=env)
            rc = rc or r.returncode
        sys.exit(rc)

    import jax
    import jax.numpy as jnp

    from hisstools_library.utils.profiling import enable_compile_cache
    enable_compile_cache()

    from hisstools_library.models import mono
    from hisstools_library.models.mono import LatencyMode, PartitionScheme
    from hisstools_library.models.offline import FastFIR

    mode = os.environ.get("BENCH_MODE", "fast")
    channels = int(os.environ.get("BENCH_CHANNELS", "128"))
    fs = int(os.environ.get("BENCH_FS", "48000"))
    ir_seconds = float(os.environ.get("BENCH_IR_SECONDS", "10"))
    sig_seconds = float(os.environ.get("BENCH_SIG_SECONDS", "10"))
    iters = int(os.environ.get("BENCH_ITERS", "5"))

    scheme = PartitionScheme.from_latency(LatencyMode.Zero)
    hop = scheme.sizes[-1] >> 1

    ir_len = int(ir_seconds * fs)
    sig_len = int(np.ceil(sig_seconds * fs / hop)) * hop
    if mode == "stream":
        sig_len = hop * 16  # chain of real-time blocks per timed dispatch

    log(f"bench[{mode}]: {channels}ch, IR {ir_len} samples, signal {sig_len} "
        f"samples, device {jax.devices()[0]}")

    rng = np.random.default_rng(0)
    irs = (rng.standard_normal((channels, ir_len)) *
           np.exp(-np.arange(ir_len) / (0.5 * fs))).astype(np.float32)
    x = rng.standard_normal((channels, sig_len)).astype(np.float32)

    backend = os.environ.get("BENCH_FFT_BACKEND") or None  # None = "xla"
    if mode == "latency":
        return run_latency(channels, fs, irs, backend)
    if mode == "fft":
        return run_fft(backend)
    if mode == "stft":
        return run_stft(channels, fs, backend)
    if mode == "tdfir":
        return run_tdfir(channels, fs, backend)
    if mode == "pipeline":
        return run_pipeline(fs, backend)
    t0 = time.time()
    if mode == "fast":
        eng = FastFIR(irs, dtype=jnp.float32, backend=backend)
        spectra = eng.spectra
        jax.block_until_ready(spectra.re)
        log(f"FastFIR fft_size {eng.fft_size}, partitions {spectra.shape[-2]}, "
            f"fft backend {backend}; IR prepared in {time.time() - t0:.2f}s")
        fwd = jax.jit(lambda s, x: FastFIR.apply(s, x, backend=backend))
        ir = spectra
    elif mode == "stream":
        # Real-time streaming engine with carried state. Default: the Zero
        # preset (latency-bounded far below the block size) through the
        # TWO-TIER block path (near ring + far ring at the offline-optimal
        # hop + zero-delay term — mono._process_block_two_tier). BENCH_SCHEME=
        # matched picks the throughput-optimal scheme for the block-size
        # latency budget instead (PartitionScheme.for_latency_budget);
        # BENCH_TIER=single forces the round-3 single-tier collapsed path.
        if os.environ.get("BENCH_SCHEME", "") == "matched":
            scheme = PartitionScheme.for_latency_budget(hop)
        ir = mono.prepare_ir(scheme, irs, dtype=jnp.float32, offline_tail=False)
        jax.block_until_ready(ir.head_taps)
        two_tier = (ir.far is not None
                    and os.environ.get("BENCH_TIER", "") != "single")
        log(f"streaming scheme {scheme.sizes}, block {hop}, "
            f"{'two-tier' if two_tier else 'single-tier'}")
        if two_tier:
            state0 = mono.init_block_state(scheme, ir, batch_shape=(channels,))
        else:
            state0 = mono.init_state(scheme, ir, batch_shape=(channels,))
        # Donate the carried state: real streaming consumes it every block,
        # and donation lets XLA update the two-tier raw-history ring in place
        # instead of copying ~(P+1)*hop samples per channel per block.
        step = jax.jit(lambda i, s, xx: mono.process(i, s, xx, backend=backend),
                       donate_argnums=(1,))
        carried = {"s": state0}

        def fwd(i, xx, _step=step, _c=carried):
            _c["s"], y = _step(i, _c["s"], xx)
            return y
    else:
        ir = mono.prepare_ir(scheme, irs, dtype=jnp.float32)
        jax.block_until_ready(ir.head_taps)
        log(f"scheme {scheme.sizes} IR spectra prepared in {time.time() - t0:.2f}s "
            f"(partitions: {[s.shape[-2] for s in ir.spectra]})")
        fwd = jax.jit(lambda i, xx: mono.process_offline(i, xx, backend=backend))
    xd = jnp.asarray(x)

    t0 = time.time()
    y = fwd(ir, xd)
    jax.block_until_ready(y)
    log(f"compile+first run {time.time() - t0:.2f}s")

    # Steady-state timing with the two-length SLOPE: timing chains of N and
    # 2N and taking the slope cancels the fixed dispatch/sync cost.
    def chain_best(k: int) -> float:
        best_t = np.inf
        for _ in range(3):
            t0 = time.time()
            out = None
            for _ in range(k):
                out = fwd(ir, xd)
            jax.block_until_ready(out)
            best_t = min(best_t, time.time() - t0)
        return best_t

    t_n = chain_best(iters)
    t_2n = chain_best(2 * iters)
    best = (t_2n - t_n) / iters
    log(f"chain({iters}) {t_n * 1e3:.1f} ms, chain({2 * iters}) {t_2n * 1e3:.1f} ms"
        f" -> {best * 1e3:.2f} ms/pass (slope)")

    total_samples = channels * sig_len
    sps = total_samples / best
    realtime_factor = sps / (channels * fs)

    # Sanity: SNR vs float64 oracle on a short prefix of one channel
    # (delayed by the scheme latency — nonzero for matched/Short/Medium).
    lat = scheme.latency
    check_len = min(sig_len - lat, 1 << 16)
    ref = np.convolve(x[0].astype(np.float64),
                      irs[0].astype(np.float64))[:check_len]
    err = np.asarray(y[0][lat:lat + check_len], np.float64) - ref
    snr = 10 * np.log10(np.sum(ref * ref) / max(np.sum(err * err), 1e-300))
    log(f"SNR vs float64 direct conv (ch0, {check_len} samples, "
        f"latency {lat}): {snr:.1f} dB")

    tag = "" if mode == "fast" else f", {mode}"
    print(json.dumps({
        "metric": f"convolved samples/s/chip (128ch x 10s IR partitioned "
                  f"convolve{tag})",
        "value": round(sps, 1),
        "unit": "samples/s/chip",
        "vs_baseline": round(realtime_factor, 3),
    }))


if __name__ == "__main__":
    main()
