"""Streamed audio-file reading (io/streaming.py) + the native async loader.

Parity model: AudioBlockReader must reproduce IAudioFile.read_interleaved
bit-exactly, block by block, through both the pure-Python path and the native
loader+codec path (reference work-loop semantics, IAudioFile.cpp:619-690).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

from hisstools_library.io import (FileType, IAudioFile, OAudioFile,
                                      PCMFormat)
from hisstools_library.io.streaming import AudioBlockReader
from hisstools_library.utils import native_rt

_NATIVE = native_rt.available()
_PATHS = [False] + ([True] if _NATIVE else [])


def _write(tmp_path, name, x, file_type=FileType.WAVE,
           fmt=PCMFormat.Float32, sr=48000.0):
    path = str(tmp_path / name)
    with OAudioFile(path, file_type, fmt, x.shape[0], sr) as f:
        f.write_interleaved(x.T)
    return path


@pytest.mark.parametrize("native", _PATHS)
@pytest.mark.parametrize("fmt,ftype", [
    (PCMFormat.Int16, FileType.WAVE),
    (PCMFormat.Int24, FileType.WAVE),
    (PCMFormat.Float32, FileType.WAVE),
    (PCMFormat.Float64, FileType.WAVE),
    (PCMFormat.Int16, FileType.AIFF),   # big-endian path
])
def test_block_reader_parity(tmp_path, native, fmt, ftype, rng):
    x = (0.4 * rng.standard_normal((3, 23456)))
    path = _write(tmp_path, "t.wav" if ftype == FileType.WAVE else "t.aif",
                  x, ftype, fmt)
    with IAudioFile(path) as f:
        full = f.read_interleaved()
    with AudioBlockReader(path, 4096, native=native, dtype=np.float64) as r:
        blocks = list(r)
        assert len(blocks) == len(r)
    assert blocks[-1].shape[0] == 23456 % 4096  # short final block
    y = np.concatenate(blocks, axis=0)
    np.testing.assert_array_equal(y, full)


@pytest.mark.skipif(not _NATIVE, reason="native runtime unavailable")
def test_file_loader_backpressure(tmp_path, rng):
    """A byte ring much smaller than the file forces loader backpressure;
    the stream must still arrive intact and in order."""
    payload = rng.integers(0, 256, size=200_000, dtype=np.uint8).tobytes()
    path = str(tmp_path / "blob.bin")
    with open(path, "wb") as f:
        f.write(b"HDR!" + payload)
    ring = native_rt.ByteRing(1 << 12)  # 4 KiB ring vs 200 KB stream
    loader = native_rt.FileLoader(path, 4, len(payload), ring,
                                  chunk_bytes=1 << 10)
    import time
    got = []
    n = 0
    deadline = time.time() + 30
    while n < len(payload) and time.time() < deadline:
        c = ring.read(3000)
        if c:
            got.append(c)
            n += len(c)
        else:
            time.sleep(0.0002)
    stats = loader.join()
    assert n == len(payload)
    assert b"".join(got) == payload
    assert stats["bytes_read"] == len(payload)
    assert stats["io_errors"] == 0


@pytest.mark.skipif(not _NATIVE, reason="native runtime unavailable")
def test_file_loader_bad_path(tmp_path):
    ring = native_rt.ByteRing(1 << 10)
    with pytest.raises(OSError):
        native_rt.FileLoader(str(tmp_path / "missing.bin"), 0, 10, ring)


def _load_cli():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "convolve_wav", os.path.join(root, "tools", "convolve_wav.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_convolve_wav_stream_matches_offline(tmp_path, rng):
    """CLI --stream (AudioBlockReader -> carried-state engine -> incremental
    writes) must match the whole-signal fast engine."""
    cli = _load_cli()
    x = (0.1 * rng.standard_normal((2, 20000)))
    ir = (0.05 * rng.standard_normal((2, 1200)) *
          np.exp(-np.arange(1200) / 300.0))
    pin = _write(tmp_path, "in.wav", x)
    pir = _write(tmp_path, "ir.wav", ir)
    pstream = str(tmp_path / "out_stream.wav")
    pfast = str(tmp_path / "out_fast.wav")
    cli.main([pin, pir, pstream, "--stream", "--block", "8192", "--cpu"])
    cli.main([pin, pir, pfast, "--cpu"])
    a = IAudioFile(pstream).read_interleaved().T
    b = IAudioFile(pfast).read_interleaved().T
    assert a.shape == b.shape == (2, 20000 + 1200 - 1)
    snr = 10 * np.log10((b ** 2).sum() / max(((a - b) ** 2).sum(), 1e-300))
    assert snr > 90, snr


@pytest.mark.parametrize("native", _PATHS)
def test_block_reader_truncated_file(tmp_path, native, rng):
    """A file cut mid-frame (header still claims the full length) must yield
    the whole frames that exist — never raise from a partial-frame decode."""
    x = 0.4 * rng.standard_normal((2, 5000))
    path = _write(tmp_path, "t.wav", x, FileType.WAVE, PCMFormat.Int16)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 4003)  # not a multiple of the 4-byte frame
    with AudioBlockReader(path, 1024, native=native, dtype=np.float64) as r:
        blocks = list(r)
    y = np.concatenate(blocks, axis=0) if blocks else np.zeros((0, 2))
    assert 0 < y.shape[0] < 5000
    assert y.shape[1] == 2
    with IAudioFile(path) as f:
        full = f.read_interleaved()
    np.testing.assert_array_equal(y, full[:y.shape[0]])
