#!/usr/bin/env python3
"""Smoke test of the library on an NVIDIA GPU: every main path at full width.

One process drives the library's main paths through their public entry points
at the flagship workload — 128 channels, a 10 s impulse response at 48 kHz
(480,000 taps with exponential decay) and 10 s of signal in float32, all made
from a seed — and checks each against a float64 numpy reference:

  fft       fft.rfft/rifft/fft/ifft batched over 2^7..2^20, 1-D round trips at
            2^24 and 2^28, the matmul backend at 2^16, df64's self-check and a
            df64 round trip at 2^16
  offline   FastFIR and mono.process_offline (Zero preset, offline tail)
  stream    multichannel.Convolver.process (3 blocks of 8192, state carried)
            and mono.process on the two-tier block state (2 far hops)
  callback  mono.process_any with 64-, 256- and ragged 333-sample callbacks
  serving   utils.serving.StreamingServer before and after an IR hot swap
  analysis  STFT/ISTFT round trip, 64-tap time-domain FIR, IR pipeline

Each check prints one line: its name, SNR, floor and the floor's reason, the
compile time and one steady wall time (taken after block_until_ready). The
last line, printed only when every check passed, is a JSON object naming the
device. With no GPU, or after any failure, the script exits non-zero without
it. Nothing falls back to the CPU.

    python chip_smoke.py          # all phases on one card
    python chip_smoke.py --four   # only the sharded path, on four cards
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# Floors against float64 numpy references.
FFT_FLOOR = 120.0
FFT_REASON = "f32 transform vs float64"
ENGINE_FLOOR = 100.0
ENGINE_REASON = "f32 engine vs float64 convolution"
DF64_FLOOR = 200.0
DF64_REASON = "double-float arithmetic, ~2^-48 per op"
# The sharded FFT is a recursive four-step of dense f32 DFT matmuls with
# twiddle angles generated in f32 in-graph; at 2^27 on an H100 its round trip
# measured 118.4 dB against 120.7 dB for its forward vs cuFFT.
SHARDED_FFT_FLOOR = 110.0
SHARDED_FFT_REASON = "f32 four-step DFT matmuls, in-graph f32 twiddles"
# The single card runs the same per-channel arithmetic as each shard; only
# summation order (psum) and per-shape algorithm choices can differ.
SHARD_REL = 1e-5
SHARD_REASON = "same arithmetic, reduction order and per-shape plans differ"


@dataclasses.dataclass(frozen=True)
class Config:
    """Workload sizes. FULL is the flagship deployment; TINY runs on a CPU."""
    channels: int = 128
    fs: int = 48000
    ir_len: int = 480000
    sig_len: int = 480000
    scheme_sizes: tuple = (256, 1024, 4096, 16384)  # the Zero preset
    fft_log2: tuple = tuple(range(7, 21))
    fft_batch_elems: int = 1 << 22
    big_log2: tuple = (24, 28)
    matmul_log2: int = 16
    df64_log2: int = 16
    stream_blocks: int = 3
    callbacks: tuple = (64, 256, 333)
    trace_callbacks: int = 8
    serve_callback: int = 256
    serve_callbacks: int = 40
    stft: tuple = (1024, 512)
    fir_taps: int = 64
    pipeline_len: int = 1 << 17
    pipeline_ir: int = 4096
    oracle_channels: int = 2
    four_sig_len: int = 60 * 48000
    four_fft_log2: int = 27
    four_conv_ir: int = 1 << 20
    four_devices: int = 4


FULL = Config()
TINY = Config(channels=4, ir_len=3000, sig_len=4096,
              scheme_sizes=(32, 64, 128, 256), fft_log2=(7, 8, 9),
              fft_batch_elems=1 << 12, big_log2=(12,), matmul_log2=10,
              df64_log2=8, callbacks=(5, 16, 33), trace_callbacks=2,
              serve_callback=16, serve_callbacks=20, stft=(256, 128),
              pipeline_len=1 << 12, pipeline_ir=256, four_sig_len=4096,
              four_fft_log2=12, four_conv_ir=256)


class CheckFailed(AssertionError):
    pass


class Report:
    """Prints one line per check and raises on a check below its floor."""

    @staticmethod
    def _emit(line: str) -> None:
        print(line, flush=True)

    def info(self, line: str) -> None:
        self._emit("  " + line)

    def snr(self, name, value, floor, reason, compile_s, steady_s) -> None:
        ok = value >= floor
        self._emit(f"{name:<36} SNR {value:7.1f} dB  floor {floor:5.1f} dB "
                   f"({reason})  compile {compile_s:8.3f} s  "
                   f"steady {steady_s * 1e3:10.3f} ms"
                   + ("" if ok else "  FAILED"))
        if not ok:
            raise CheckFailed(f"{name}: {value:.1f} dB < {floor} dB")

    def below(self, name, value, limit, reason, compile_s=0.0,
              steady_s=0.0) -> None:
        ok = value <= limit
        self._emit(f"{name:<36} value {value:.3e} <= {limit:.0e} ({reason})  "
                   f"compile {compile_s:8.3f} s  steady {steady_s * 1e3:10.3f} ms"
                   + ("" if ok else "  FAILED"))
        if not ok:
            raise CheckFailed(f"{name}: {value:.3e} > {limit:.0e}")


# -- float64 references ---------------------------------------------------------

def snr_db(ref, test) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    d = float((err * err).sum())
    return float("inf") if d == 0.0 else 10.0 * np.log10(
        float((ref * ref).sum()) / d)


def packed_rfft64(x):
    """float64 packed rFFT (x2 scale, DC in re[0], Nyquist in im[0])."""
    z = np.fft.rfft(np.asarray(x, np.float64), axis=-1)
    re, im = 2.0 * z.real, 2.0 * z.imag
    return re[..., :-1], np.concatenate([re[..., -1:], im[..., 1:-1]], axis=-1)


def conv64(x, ir, length):
    """float64 FFT convolution of matching (..., L) rows, first ``length``."""
    x = np.asarray(x, np.float64)
    ir = np.asarray(ir, np.float64)
    n = 1 << int(np.ceil(np.log2(x.shape[-1] + ir.shape[-1] - 1)))
    y = np.fft.irfft(np.fft.rfft(x, n) * np.fft.rfft(ir, n), n)
    return y[..., :length]


class Workload:
    """IRs and signal from a seed, and the float64 reference of the first
    ``oracle_channels`` channels."""

    def __init__(self, cfg: Config, seed: int = 0):
        rng = np.random.default_rng(seed)
        decay = np.exp(-np.arange(cfg.ir_len) / (0.5 * cfg.fs))
        self.cfg = cfg
        self.irs = (rng.standard_normal((cfg.channels, cfg.ir_len))
                    * decay).astype(np.float32)
        self.x = rng.standard_normal((cfg.channels, cfg.sig_len)
                                     ).astype(np.float32)
        k = cfg.oracle_channels
        self._ref = conv64(self.x[:k], self.irs[:k], cfg.sig_len)

    def ref(self, length: int) -> np.ndarray:
        return self._ref[:, :length]

    def scheme(self):
        from hisstools_library.models.mono import PartitionScheme
        return PartitionScheme(self.cfg.scheme_sizes, zero_latency=True)


# -- timing ---------------------------------------------------------------------

def compile_fn(fn, *args, donate_argnums=()):
    """(compiled executable, seconds to lower and compile)."""
    import jax
    t0 = time.perf_counter()
    exe = jax.jit(fn, donate_argnums=donate_argnums).lower(*args).compile()
    return exe, time.perf_counter() - t0


def run_twice(exe, *args):
    """Warm call, then one timed call; (output, steady seconds)."""
    import jax
    jax.block_until_ready(exe(*args))
    t0 = time.perf_counter()
    out = exe(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def peak_bytes(device) -> str:
    stats = device.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "not reported" if peak is None else f"{peak / 2**30:.2f} GiB"


def memory_line(exe) -> str:
    ma = exe.memory_analysis()
    if ma is None:
        return "memory_analysis: not reported"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "memory_analysis: " + ", ".join(
        f"{f.replace('_size_in_bytes', '')} {getattr(ma, f) / 2**30:.2f} GiB"
        for f in fields if getattr(ma, f, None) is not None)


# -- phases ---------------------------------------------------------------------

def phase_fft(cfg: Config, rep: Report, data: Workload) -> None:
    import jax
    import jax.numpy as jnp

    from hisstools_library import fft
    from hisstools_library.fft import df64

    rng = np.random.default_rng(1)
    for lg in cfg.fft_log2:
        n = 1 << lg
        b = max(1, cfg.fft_batch_elems // n)
        x = rng.standard_normal((b, n)).astype(np.float32)
        y = rng.standard_normal((b, n)).astype(np.float32)
        xd, yd = jnp.asarray(x), jnp.asarray(y)
        tag = f"2^{lg} x{b}"

        exe, c = compile_fn(fft.rfft, xd)
        (re, im), t = run_twice(exe, xd)
        ore, oim = packed_rfft64(x)
        rep.snr(f"fft.rfft {tag}", min(snr_db(ore, re), snr_db(oim, im)),
                FFT_FLOOR, FFT_REASON, c, t)
        exe, c = compile_fn(fft.rifft, re, im)
        back, t = run_twice(exe, re, im)
        rep.snr(f"fft.rifft(rfft) {tag}", snr_db(2.0 * n * x, back),
                FFT_FLOOR, FFT_REASON + ", round trip", c, t)

        exe, c = compile_fn(fft.fft, xd, yd)
        (fr, fi), t = run_twice(exe, xd, yd)
        z = np.fft.fft(x.astype(np.float64) + 1j * y, axis=-1)
        rep.snr(f"fft.fft {tag}", min(snr_db(z.real, fr), snr_db(z.imag, fi)),
                FFT_FLOOR, FFT_REASON, c, t)
        exe, c = compile_fn(fft.ifft, fr, fi)
        (gr, gi), t = run_twice(exe, fr, fi)
        rep.snr(f"fft.ifft(fft) {tag}",
                min(snr_db(n * x, gr), snr_db(n * y, gi)),
                FFT_FLOOR, FFT_REASON + ", round trip", c, t)

    # 1-D sizes too large for a host reference: round trips against 2N x
    # (real) and N z (complex), with the error reduced on the device.
    for lg in cfg.big_log2:
        n = 1 << lg
        key = jax.random.PRNGKey(lg)
        xr = jax.random.normal(key, (n,), jnp.float32)
        xi = jax.random.normal(jax.random.fold_in(key, 1), (n,), jnp.float32)

        def real_rt(a):
            e = fft.rifft(*fft.rfft(a)) * (1.0 / (2 * n)) - a
            return jnp.sum(a * a), jnp.sum(e * e)

        def complex_rt(a, b):
            gr, gi = fft.ifft(*fft.fft(a, b))
            er, ei = gr * (1.0 / n) - a, gi * (1.0 / n) - b
            return jnp.sum(a * a + b * b), jnp.sum(er * er + ei * ei)

        exe, c = compile_fn(real_rt, xr)
        (s, e), t = run_twice(exe, xr)
        rep.snr(f"fft.rifft(rfft) 2^{lg} 1-D", 10 * np.log10(float(s) / float(e)),
                FFT_FLOOR, FFT_REASON + ", round trip", c, t)
        exe, c = compile_fn(complex_rt, xr, xi)
        (s, e), t = run_twice(exe, xr, xi)
        rep.snr(f"fft.ifft(fft) 2^{lg} 1-D", 10 * np.log10(float(s) / float(e)),
                FFT_FLOOR, FFT_REASON + ", round trip", c, t)
        del xr, xi

    n = 1 << cfg.matmul_log2
    x = rng.standard_normal((16, n)).astype(np.float32)
    xd = jnp.asarray(x)
    exe, c = compile_fn(lambda a: fft.rfft(a, backend="matmul"), xd)
    (re, im), t = run_twice(exe, xd)
    ore, oim = packed_rfft64(x)
    rep.snr(f"fft.rfft matmul 2^{cfg.matmul_log2} x16",
            min(snr_db(ore, re), snr_db(oim, im)), FFT_FLOOR,
            FFT_REASON + ", HIGHEST-precision DFT matmuls", c, t)

    t0 = time.perf_counter()
    err = df64.selfcheck()
    rep.below("df64.selfcheck rel err", err, 1e-10,
              "compensated sums kept by the compiler", time.perf_counter() - t0)
    n = 1 << cfg.df64_log2
    x = rng.standard_normal((1, n)).astype(np.float32)
    exe, c = compile_fn(lambda a: df64.rifft_df64(*df64.rfft_df64(a)),
                        jnp.asarray(x))
    (yh, yl), t = run_twice(exe, jnp.asarray(x))
    rep.snr(f"df64 rifft(rfft) 2^{cfg.df64_log2}",
            snr_db(2.0 * n * x.astype(np.float64), df64.dd_to_f64(yh, yl)),
            DF64_FLOOR, DF64_REASON, c, t)


def phase_offline(cfg: Config, rep: Report, data: Workload) -> None:
    import jax
    import jax.numpy as jnp

    from hisstools_library.models import mono
    from hisstools_library.models.offline import FastFIR

    k = cfg.oracle_channels
    xd = jnp.asarray(data.x)
    eng = FastFIR(data.irs, dtype=jnp.float32)
    jax.block_until_ready(eng.spectra)
    exe, c = compile_fn(FastFIR.apply, eng.spectra, xd)
    y, t = run_twice(exe, eng.spectra, xd)
    rep.snr(f"offline.FastFIR {cfg.channels}ch", snr_db(data.ref(cfg.sig_len),
                                                       y[:k]),
            ENGINE_FLOOR, ENGINE_REASON, c, t)
    rep.info(f"FastFIR N={eng.fft_size} hop={eng.hop} "
             f"P={eng.spectra.shape[-2]}; {memory_line(exe)}")
    del y, eng, exe

    conv = mono.MonoConvolve(max_length=cfg.ir_len, scheme=data.scheme())
    conv.set(data.irs, offline_tail=True)
    jax.block_until_ready(conv.ir)
    exe, c = compile_fn(mono.process_offline, conv.ir, xd)
    y, t = run_twice(exe, conv.ir, xd)
    rep.snr(f"offline.mono.process_offline {cfg.channels}ch",
            snr_db(data.ref(cfg.sig_len), y[:k]), ENGINE_FLOOR, ENGINE_REASON,
            c, t)
    rep.info(f"mono.process_offline: {memory_line(exe)}")
    rep.info(f"peak_bytes_in_use after offline: "
             f"{peak_bytes(jax.devices()[0])}")


def phase_stream(cfg: Config, rep: Report, data: Workload) -> None:
    import jax
    import jax.numpy as jnp

    from hisstools_library.models import mono, multichannel

    k = cfg.oracle_channels
    scheme = data.scheme()
    conv = multichannel.Convolver(num_ins=cfg.channels, scheme=scheme)
    conv.set_all(data.irs)
    ir = conv.prepare(offline_tail=False)
    xd = jnp.asarray(data.x)

    def stream(step, state, block, count, name):
        exe, c = compile_fn(step, ir, state, xd[:, :block], donate_argnums=(1,))
        outs, times = [], []
        for j in range(count):
            xb = xd[:, j * block:(j + 1) * block]
            jax.block_until_ready(xb)
            t0 = time.perf_counter()
            state, y = exe(ir, state, xb)
            jax.block_until_ready(y)
            times.append(time.perf_counter() - t0)
            outs.append(np.asarray(y[:k]))
        got = np.concatenate(outs, axis=-1)
        rep.snr(name, snr_db(data.ref(count * block), got), ENGINE_FLOOR,
                ENGINE_REASON, c, times[-1])

    b = conv.block_size
    stream(lambda i, s, xx: multichannel.process(i, s, xx, True),
           conv.init_state(), b, cfg.stream_blocks,
           f"stream.Convolver.process {cfg.stream_blocks}x{b}")
    h2 = ir.far.shape[-1]
    stream(lambda i, s, xx: mono.process(i, s, xx),
           mono.init_block_state(scheme, ir, (cfg.channels,)), h2, 2,
           f"stream.mono.process two-tier 2x{h2}")


def device_kernel_counts(trace_dir: str):
    """(kernel events on the GPU planes' stream lines, {line: events}) of the
    profiler trace under ``trace_dir``; (None, {}) when it holds no GPU plane."""
    import jax

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        return None, {}
    data = jax.profiler.ProfileData.from_file(paths[0])
    per_line = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            per_line[f"{plane.name}/{line.name}"] = sum(1 for _ in line.events)
    kernels = sum(v for key, v in per_line.items() if "Stream" in key)
    return (kernels if per_line else None), per_line


def phase_callback(cfg: Config, rep: Report, data: Workload) -> None:
    import jax
    import jax.numpy as jnp

    from hisstools_library.models import mono

    k = cfg.oracle_channels
    scheme = data.scheme()
    ir = mono.prepare_ir(scheme, data.irs, dtype=jnp.float32,
                         offline_tail=False)
    xd = jnp.asarray(data.x)
    big_hop = scheme.sizes[-1] >> 1
    # The largest section fires at every big_hop boundary: cover two.
    want = 2 * big_hop + big_hop // 8
    step = lambda i, s, xx: mono.process_any(i, s, xx)
    for cb in cfg.callbacks:
        count = -(-want // cb)
        state = mono.init_stream_state(scheme, ir, (cfg.channels,))
        exe, c = compile_fn(step, ir, state, xd[:, :cb], donate_argnums=(1,))
        blocks = [xd[:, j * cb:(j + 1) * cb] for j in range(count)]
        jax.block_until_ready(blocks)
        outs, times = [], []
        for xb in blocks:
            t0 = time.perf_counter()
            state, y = exe(ir, state, xb)
            jax.block_until_ready(y)
            times.append(time.perf_counter() - t0)
            outs.append(y[:k])
        got = np.concatenate([np.asarray(o) for o in outs], axis=-1)
        rep.snr(f"callback.process_any {count}x{cb}",
                snr_db(data.ref(count * cb), got), ENGINE_FLOOR, ENGINE_REASON,
                c, float(np.median(times)))

        if cb == cfg.callbacks[1]:
            with tempfile.TemporaryDirectory() as d:
                jax.profiler.start_trace(d)
                for xb in blocks[:cfg.trace_callbacks]:
                    state, y = exe(ir, state, xb)
                    jax.block_until_ready(y)
                jax.profiler.stop_trace()
                kernels, per_line = device_kernel_counts(d)
            per_cb = ("not measured (no GPU plane in the trace)"
                      if kernels is None
                      else f"{kernels / cfg.trace_callbacks:.1f}")
            rep.info(f"kernels launched per {cb}-sample callback: {per_cb}; "
                     f"trace lines {per_line}")


def phase_serving(cfg: Config, rep: Report, data: Workload) -> None:
    import jax.numpy as jnp

    from hisstools_library.utils.serving import StreamingServer

    k = cfg.oracle_channels
    cb, count = cfg.serve_callback, cfg.serve_callbacks
    cap = 1 << int(np.ceil(np.log2(cfg.ir_len)))
    srv = StreamingServer(cfg.channels, capacity=cap, scheme=data.scheme())
    xd = jnp.asarray(data.x)
    irs_b = np.roll(data.irs, 1, axis=0)  # a different IR on every channel

    def serve(start, ir_bank, version, name):
        outs, times = [], []
        for j in range(count):
            xb = xd[:, start + j * cb:start + (j + 1) * cb]
            t0 = time.perf_counter()
            y, live = srv.process(xb)
            y = np.asarray(y[:k])
            times.append(time.perf_counter() - t0)
            if not live:
                raise CheckFailed(f"{name}: callback {j} not live")
            outs.append(y)
        got = np.concatenate(outs, axis=-1)
        seg = data.x[:k, start:start + count * cb]
        ref = conv64(seg, ir_bank[:k], count * cb)
        rep.snr(f"{name} v{version} {count}x{cb}", snr_db(ref, got),
                ENGINE_FLOOR, ENGINE_REASON, times[0],
                float(np.median(times[1:])))

    v1 = srv.set_ir(data.irs)
    serve(0, data.irs, v1, "serving.process")
    v2 = srv.set_ir(irs_b)
    if v2 != v1 + 1:
        raise CheckFailed(f"serving: swap reported version {v2}, not {v1 + 1}")
    serve(count * cb, irs_b, v2, "serving.process after set_ir")


def phase_analysis(cfg: Config, rep: Report, data: Workload) -> None:
    import jax.numpy as jnp

    from hisstools_library.models import partial_tracker as pt
    from hisstools_library.models import time_domain as td
    from hisstools_library.models.pipeline import _frames_chain_jit
    from hisstools_library.ops import stft as stft_mod
    from hisstools_library.ops import windows
    from hisstools_library.utils.debug_stages import deconv_oracle64

    k = cfg.oracle_channels
    n, hop = cfg.stft
    length = (cfg.sig_len // hop) * hop
    w = np.asarray(windows.hann(n - 1, dtype=jnp.float32))
    xd = jnp.asarray(data.x[:, :length])

    def roundtrip(a):
        s = stft_mod.stft(a, w, n, hop, boundary=True)
        return stft_mod.istft(s, w, hop, length=length, boundary=True)

    exe, c = compile_fn(roundtrip, xd)
    y, t = run_twice(exe, xd)
    rep.snr(f"analysis.stft/istft {cfg.channels}ch N={n} hop={hop}",
            snr_db(data.x[:k, :length], y[:k]), FFT_FLOOR,
            FFT_REASON + ", round trip", c, t)

    rng = np.random.default_rng(2)
    taps = rng.standard_normal((cfg.channels, cfg.fir_taps)).astype(np.float32)
    hd, xd = jnp.asarray(taps), jnp.asarray(data.x)
    exe, c = compile_fn(td.fir_offline, xd, hd)
    y, t = run_twice(exe, xd, hd)
    ref = np.stack([np.convolve(data.x[i].astype(np.float64),
                                taps[i].astype(np.float64))[:cfg.sig_len]
                    for i in range(k)])
    rep.snr(f"analysis.fir_offline {cfg.fir_taps} taps", snr_db(ref, y[:k]),
            ENGINE_FLOOR, ENGINE_REASON, c, t)

    # The IR-measurement chain on a noiseless synthetic sweep capture.
    tt = np.arange(cfg.pipeline_len) / cfg.fs
    exc = np.sin(2 * np.pi * (20.0 * (1000.0 ** (tt / tt[-1]))) * tt)
    ir_true = (rng.standard_normal(cfg.pipeline_ir)
               * np.exp(-np.arange(cfg.pipeline_ir) / 4800.0))
    measured = np.convolve(exc, ir_true)
    reg, n_peaks = 1e-9, 16
    kernel = np.asarray(windows.hann(127, dtype=jnp.float32), np.float64)[63:]
    fn = _frames_chain_jit(float(cfg.fs), reg, (1.0, 63.0),
                           tuple(kernel.tolist()), n_peaks, n, hop,
                           pt.TrackerConfig(max_peaks=n_peaks,
                                            max_tracks=n_peaks),
                           0.0, None, None)
    md = jnp.asarray(measured, jnp.float32)
    ed = jnp.asarray(exc, jnp.float32)
    exe, c = compile_fn(fn, md, ed)
    out, t = run_twice(exe, md, ed)
    h32 = np.asarray(out[0], np.float64)
    h64 = deconv_oracle64(measured, exc, reg)[:len(h32)]
    rep.snr(f"analysis.ir_pipeline {cfg.pipeline_len} samples",
            snr_db(h64, h32), ENGINE_FLOOR,
            "f32 regularised deconvolution vs float64", c, t)


PHASES = (phase_fft, phase_offline, phase_stream, phase_callback,
          phase_serving, phase_analysis)


class FourSetup:
    """What the four-device phases share: the devices, a one-device mesh, a
    60 s signal, the prepared IR and the float64 reference."""

    def __init__(self, cfg: Config, data: Workload):
        import jax
        import jax.numpy as jnp

        from hisstools_library.models import mono
        from hisstools_library.parallel import make_mesh

        self.devs = jax.devices()[:cfg.four_devices]
        self.nd = len(self.devs)
        self.one = make_mesh(devices=self.devs[:1], channel=1, block=1)
        self.chan = make_mesh(devices=self.devs, channel=self.nd, block=1)
        self.scheme = data.scheme()
        self.big_hop = self.scheme.sizes[-1] >> 1
        quantum = self.nd * self.big_hop
        self.length = -(-cfg.four_sig_len // quantum) * quantum
        self.rng = np.random.default_rng(3)
        x = self.rng.standard_normal((cfg.channels, self.length)
                                     ).astype(np.float32)
        self.xd = jnp.asarray(x)
        self.ir = mono.prepare_ir(self.scheme, data.irs, dtype=jnp.float32,
                                  offline_tail=False)
        k = cfg.oracle_channels
        self.ref = conv64(x[:k], data.irs[:k], self.length)


def _four(cfg: Config, data: Workload) -> FourSetup:
    if getattr(data, "four", None) is None:
        data.four = FourSetup(cfg, data)
    return data.four


def _compare(rep: Report, name, sharded, single) -> None:
    """The sharded result against the same call on one device."""
    sharded = np.asarray(sharded)
    single = np.asarray(single)
    rel = float(np.max(np.abs(sharded.astype(np.float64) - single))
                / max(float(np.max(np.abs(single))), 1e-30))
    same = bool(np.array_equal(sharded, single))
    rep.below(f"{name} vs 1 card", rel, SHARD_REL,
              "bit-identical" if same else SHARD_REASON)


def phase_four_offline(cfg: Config, rep: Report, data: Workload) -> None:
    """scheme_offline_sharded on 1xN and 2x(N/2) meshes and n_to_one_offline
    on Nx1, each against float64 and against the same call on one device."""
    import jax

    from hisstools_library.parallel import (make_mesh, n_to_one_offline,
                                            scheme_offline_sharded)

    f = _four(cfg, data)
    k = cfg.oracle_channels
    offline = []
    for ch, blk in ((1, f.nd), (2, f.nd // 2)):
        mesh = make_mesh(devices=f.devs, channel=ch, block=blk)
        fn = lambda i, a, m=mesh: scheme_offline_sharded(m, f.scheme, i, a)
        exe, c = compile_fn(fn, f.ir, f.xd)
        y, t = run_twice(exe, f.ir, f.xd)
        name = f"four.scheme_offline_sharded {ch}x{blk}"
        rep.snr(name, snr_db(f.ref, y[:k]), ENGINE_FLOOR, ENGINE_REASON, c, t)
        offline.append((name, np.asarray(y[:k])))
        del y
    exe, c = compile_fn(
        lambda i, a: n_to_one_offline(f.chan, f.scheme, i, a), f.ir, f.xd)
    y_n1, t = run_twice(exe, f.ir, f.xd)
    y_n1 = np.asarray(y_n1)
    rep.info(f"four.n_to_one_offline {f.nd}x1: compile {c:.3f} s, "
             f"steady {t * 1e3:.3f} ms")
    rep.info("peak_bytes_in_use per card after the sharded runs: " + ", ".join(
        f"{d.id}: {peak_bytes(d)}" for d in f.devs))

    y1 = jax.jit(lambda i, a: scheme_offline_sharded(f.one, f.scheme, i, a))(
        f.ir, f.xd)
    for name, got in offline:
        _compare(rep, name, got, y1[:k])
    del y1
    _compare(rep, f"four.n_to_one_offline {f.nd}x1", y_n1, jax.jit(
        lambda i, a: n_to_one_offline(f.one, f.scheme, i, a))(f.ir, f.xd))


def phase_four_stream(cfg: Config, rep: Report, data: Workload) -> None:
    """scheme_stream_sharded (3 hop-aligned blocks) and
    scheme_stream_any_sharded (8 callbacks) on Nx1, against float64 and
    against the same calls on one device."""
    import jax

    from hisstools_library.models import mono
    from hisstools_library.parallel import (scheme_stream_any_sharded,
                                            scheme_stream_sharded)

    f = _four(cfg, data)
    k = cfg.oracle_channels

    def stream_run(mesh, fn, state, blocks):
        ys, times = [], []
        for xb in blocks:
            t0 = time.perf_counter()
            state, y = fn(mesh, f.ir, state, xb)
            jax.block_until_ready(y)
            times.append(time.perf_counter() - t0)
            ys.append(np.asarray(y))
        return np.concatenate(ys, axis=-1), times

    cb = cfg.callbacks[1]
    runs = (
        ("scheme_stream_sharded", scheme_stream_sharded, mono.init_state,
         f.big_hop, 3),
        ("scheme_stream_any_sharded", scheme_stream_any_sharded,
         mono.init_stream_state, cb, 8))
    for name, fn, init, block, count in runs:
        fn = jax.jit(fn, static_argnums=0)
        blocks = [f.xd[:, j * block:(j + 1) * block] for j in range(count)]
        name = f"four.{name} {f.nd}x1 {count}x{block}"
        got, times = stream_run(
            f.chan, fn, init(f.scheme, f.ir, (cfg.channels,)), blocks)
        rep.snr(name, snr_db(f.ref[:, :count * block], got[:k]),
                ENGINE_FLOOR, ENGINE_REASON, times[0], times[-1])
        single, _ = stream_run(
            f.one, fn, init(f.scheme, f.ir, (cfg.channels,)), blocks)
        _compare(rep, name, got, single)


def phase_four_fft(cfg: Config, rep: Report, data: Workload) -> None:
    """rfft_sharded, rifft_sharded and convolve_sharded over a 1xN mesh at
    2^four_fft_log2, against one device's cuFFT path."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from hisstools_library.core.types import Split, packed_mul
    from hisstools_library.fft import api as fft_api
    from hisstools_library.parallel import (BLOCK_AXIS, convolve_sharded,
                                            make_mesh, rfft_sharded,
                                            rifft_sharded)

    f = _four(cfg, data)
    n = 1 << cfg.four_fft_log2
    tag = f"2^{cfg.four_fft_log2}"
    mesh_f = make_mesh(devices=f.devs, channel=1, block=f.nd)
    xh = f.rng.standard_normal(n).astype(np.float32)
    xf = jax.device_put(xh, NamedSharding(mesh_f, PartitionSpec(BLOCK_AXIS)))
    xf1 = jnp.asarray(xh)

    exe, c = compile_fn(lambda a: rfft_sharded(mesh_f, a), xf)
    (sr, si), t = run_twice(exe, xf)
    r1, i1 = jax.jit(fft_api.rfft)(xf1)
    rep.snr(f"four.rfft_sharded {tag} vs 1-card rfft",
            min(snr_db(r1, sr), snr_db(i1, si)), SHARDED_FFT_FLOOR,
            SHARDED_FFT_REASON + " vs cuFFT", c, t)
    del r1, i1
    exe, c = compile_fn(lambda a, b: rifft_sharded(mesh_f, a, b), sr, si)
    back, t = run_twice(exe, sr, si)
    err = jax.jit(lambda a, b: (jnp.sum(a * a),
                                jnp.sum((b * (1.0 / (2 * n)) - a) ** 2)))
    s, e = err(xf1, np.asarray(back))
    rep.snr(f"four.rifft_sharded(rfft) {tag}", 10 * np.log10(float(s) / float(e)),
            SHARDED_FFT_FLOOR, SHARDED_FFT_REASON + ", round trip", c, t)
    del sr, si, back

    lh = cfg.four_conv_ir
    xa = jnp.asarray(xh[:n - lh + 1])  # output length n: one transform size
    ha = jnp.asarray(f.rng.standard_normal(lh)
                     * np.exp(-np.arange(lh) / 24000.0), jnp.float32)
    exe, c = compile_fn(lambda a, b: convolve_sharded(mesh_f, a, b), xa, ha)
    yc, t = run_twice(exe, xa, ha)

    def conv_one(a, b):
        p = packed_mul(Split(*fft_api.rfft_padded(a, n)),
                       Split(*fft_api.rfft_padded(b, n)))
        return fft_api.rifft(p.re, p.im) * (0.25 / n)

    rep.snr(f"four.convolve_sharded {tag} vs 1-card",
            snr_db(jax.jit(conv_one)(xa, ha), yc), SHARDED_FFT_FLOOR,
            SHARDED_FFT_REASON + " vs cuFFT", c, t)


PHASES_FOUR = (phase_four_offline, phase_four_stream, phase_four_fft)


def run_phases(cfg: Config, phases, data: Workload = None) -> list:
    """Run each phase; return the names of those that failed. A failure is
    printed with its traceback and the next phase still runs."""
    data = data or Workload(cfg)
    rep = Report()
    failed = []
    for phase in phases:
        name = phase.__name__.replace("phase_", "")
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            phase(cfg, rep, data)
        except Exception:  # reported, and the run fails at the end
            traceback.print_exc()
            print(f"== {name} FAILED", flush=True)
            failed.append(name)
        else:
            print(f"== {name} ok in {time.perf_counter() - t0:.1f} s",
                  flush=True)
    return failed


def card_lines() -> list:
    """`nvidia-smi --query-gpu=name,power.limit` lines, [] without the tool."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line for line in out.stdout.splitlines() if line.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path, on four GPUs")
    args = ap.parse_args(argv)

    for line in card_lines():
        print(line, flush=True)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform} devices only",
              file=sys.stderr)
        return 1
    need = FULL.four_devices if args.four else 1
    if len(devices) < need:
        print(f"--four needs {need} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 1

    from hisstools_library.utils.profiling import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    failed = run_phases(FULL, PHASES_FOUR if args.four else PHASES)
    if failed:
        print(f"failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
