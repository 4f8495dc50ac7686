#!/usr/bin/env python
"""Convolve an audio file with an impulse response on the GPU (or CPU).

The end-user workflow the reference library serves (HIRT: apply a measured room
IR / reverb to a recording) as a command-line tool over this framework's full
stack: audio-file I/O (io/audio_file.py) -> partitioned convolution engine
(models/offline.py) -> audio-file output.

    python tools/convolve_wav.py input.wav ir.wav output.wav
    python tools/convolve_wav.py input.wav ir.wav out.wav --wet 0.4 --engine scheme

Channels: a mono IR applies to every input channel; a multichannel IR applies
channel-per-channel (counts must then match). The tail (len(ir)-1 samples) is
rendered unless --trim. Output is peak-normalised only if it would clip
(--normalize forces it).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

# Allow running as a script from anywhere (tools/ is not the package root).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _pcm_format(name: str):
    """--pcm choice -> PCMFormat (one mapping for both output paths)."""
    from hisstools_library.io import PCMFormat
    return {"int16": PCMFormat.Int16, "int24": PCMFormat.Int24,
            "float32": PCMFormat.Float32}[name]


def read_wav(path):
    from hisstools_library.io import IAudioFile, get_error_string

    with IAudioFile(path) as f:
        if f.get_is_error():
            msgs = "; ".join(get_error_string(e) for e in f.get_errors())
            raise SystemExit(f"{path}: {msgs}")
        data = f.read_interleaved()            # (frames, channels) float
        return np.asarray(data, np.float32).T, f.sampling_rate


def write_wav(path, x, sr, pcm="float32"):
    from hisstools_library.io import FileType, OAudioFile

    fmt = _pcm_format(pcm)
    with OAudioFile(path, FileType.WAVE, fmt, x.shape[0], float(sr)) as f:
        f.write_interleaved(np.asarray(x, np.float64).T)


def stream_convolve(args):
    """Constant-memory streaming path: AudioBlockReader (native prefetch
    loader + native codec when available) -> carried-state zero-latency
    scheme engine -> incremental OAudioFile writes. Memory use is bounded by
    the block size regardless of file length."""
    import jax
    import jax.numpy as jnp
    from hisstools_library.io import FileType, OAudioFile
    from hisstools_library.io.streaming import AudioBlockReader
    from hisstools_library.models import mono
    from hisstools_library.models.mono import LatencyMode, PartitionScheme

    ir, ir_sr = read_wav(args.ir)
    scheme = PartitionScheme.from_latency(LatencyMode.Zero)  # zero delay
    hop = scheme.sizes[-1] >> 1
    block = -(-args.block // hop) * hop

    reader = AudioBlockReader(args.input, block, dtype=np.float32)
    sr, cx = reader.sampling_rate, reader.channels
    if abs(sr - ir_sr) > 1e-6:
        print(f"warning: sample-rate mismatch ({sr} vs {ir_sr}); "
              "convolving anyway", file=sys.stderr)
    if ir.shape[0] == 1 and cx > 1:
        ir = np.broadcast_to(ir, (cx, ir.shape[1]))
    elif ir.shape[0] != cx and ir.shape[0] > 1:
        raise SystemExit(f"channel mismatch: input {cx}, IR {ir.shape[0]}")

    prep = mono.prepare_ir(scheme, ir, dtype=jnp.float32, offline_tail=False)
    state = mono.init_state(scheme, prep, batch_shape=(cx,))
    step = jax.jit(lambda i, s, b: mono.process(i, s, b))

    fmt = _pcm_format(args.pcm)
    total_in = reader.frames
    tail = 0 if args.trim else ir.shape[1] - 1
    out_len = total_in + tail
    t0 = time.time()
    written = 0
    peak = 0.0
    with OAudioFile(args.output, FileType.WAVE, fmt, cx, float(sr)) as out:
        def emit(y, limit):
            nonlocal written, peak
            take = min(limit, out_len - written)
            if take <= 0:
                return
            yb = np.asarray(y)[:, :take]
            peak = max(peak, float(np.abs(yb).max()))
            out.write_interleaved(yb.astype(np.float64).T)
            written += take

        for xb in reader:
            xb = xb.T  # (channels, frames)
            if xb.shape[-1] % hop:
                xb = np.pad(xb, ((0, 0), (0, hop - xb.shape[-1] % hop)))
            state, y = step(prep, state, jnp.asarray(xb))
            # Zero latency: engine output position == file position, so the
            # hop-padding samples carry real tail output — emit them all
            # (emit caps at out_len).
            emit(y, y.shape[-1])
        zeros = jnp.zeros((cx, block), jnp.float32)
        while written < out_len:
            state, y = step(prep, state, zeros)
            emit(y, block)
    reader.close()
    dt = time.time() - t0
    rate = cx * out_len / max(dt, 1e-9) / (cx * sr)
    print(f"streamed {cx} ch x {out_len} frames in {dt:.2f}s "
          f"({rate:.0f}x real-time incl. IO; block {block}, peak {peak:.3f}"
          f"{', CLIPPED' if peak > 1.0 and args.pcm != 'float32' else ''})",
          file=sys.stderr)
    print(f"wrote {args.output}", file=sys.stderr)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input")
    ap.add_argument("ir")
    ap.add_argument("output")
    ap.add_argument("--engine", choices=("fast", "scheme"), default="fast",
                    help="fast = fused uniform-partition offline engine; "
                         "scheme = zero-latency non-uniform scheme (reference "
                         "kLatencyZero semantics)")
    ap.add_argument("--wet", type=float, default=1.0,
                    help="wet/dry mix: 1.0 = fully convolved")
    ap.add_argument("--trim", action="store_true",
                    help="cut the output at the input length (no reverb tail)")
    ap.add_argument("--normalize", action="store_true",
                    help="always peak-normalise to -1 dBFS")
    ap.add_argument("--pcm", choices=("int16", "int24", "float32"),
                    default="float32")
    ap.add_argument("--stream", action="store_true",
                    help="constant-memory streaming: read/convolve/write in "
                         "blocks (native prefetching loader when available); "
                         "input files of any length. --wet/--normalize are "
                         "whole-signal options and unavailable here")
    ap.add_argument("--block", type=int, default=1 << 16,
                    help="streaming block size in frames (rounded up to the "
                         "engine hop)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU")
    args = ap.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from hisstools_library.utils.profiling import enable_compile_cache
    enable_compile_cache()

    if args.stream:
        if args.wet != 1.0 or args.normalize:
            raise SystemExit("--stream does not support --wet/--normalize "
                             "(whole-signal operations)")
        return stream_convolve(args)

    x, sr = read_wav(args.input)
    ir, ir_sr = read_wav(args.ir)
    if abs(sr - ir_sr) > 1e-6:
        print(f"warning: sample-rate mismatch ({sr} vs {ir_sr}); "
              "convolving anyway", file=sys.stderr)

    cx, L = x.shape
    cir = ir.shape[0]
    if cir == 1 and cx > 1:
        ir = np.broadcast_to(ir, (cx, ir.shape[1]))
    elif cir != cx and cir > 1:
        raise SystemExit(f"channel mismatch: input {cx}, IR {cir}")

    out_len = L if args.trim else L + ir.shape[1] - 1
    pad = out_len - L
    xs = np.pad(x, ((0, 0), (0, pad))).astype(np.float32)

    t0 = time.time()
    if args.engine == "fast":
        from hisstools_library.models.offline import fast_fir
        y = fast_fir(jnp.asarray(xs), ir)
    else:
        from hisstools_library.models import mono
        from hisstools_library.models.mono import LatencyMode, PartitionScheme
        scheme = PartitionScheme.from_latency(LatencyMode.Zero)
        hop = scheme.sizes[-1] >> 1
        if xs.shape[-1] % hop:
            xs = np.pad(xs, ((0, 0), (0, hop - xs.shape[-1] % hop)))
        prep = mono.prepare_ir(scheme, ir, dtype=jnp.float32)
        y = mono.process_offline(prep, jnp.asarray(xs))
    y = np.asarray(y)[:, :out_len]
    dt = time.time() - t0
    rate = cx * out_len / max(dt, 1e-9) / (cx * sr)
    print(f"convolved {cx} ch x {out_len} frames in {dt:.2f}s "
          f"({rate:.0f}x real-time incl. transfers)", file=sys.stderr)

    if args.wet != 1.0:
        dry = np.pad(x, ((0, 0), (0, pad)))
        y = args.wet * y + (1.0 - args.wet) * dry

    peak = float(np.abs(y).max()) or 1.0
    if args.normalize or peak > 1.0:
        y = y * (10 ** (-1 / 20) / peak)
        print(f"normalised (peak was {peak:.3f})", file=sys.stderr)

    write_wav(args.output, y, sr, args.pcm)
    print(f"wrote {args.output}", file=sys.stderr)


if __name__ == "__main__":
    main()
