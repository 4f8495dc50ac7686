"""Malformed-audio-file robustness: IAudioFile must flag errors, never crash.

The reference surfaces misuse through error flags without throwing on the
audio path (BaseAudioFile.h:46-64, getErrorString BaseAudioFile.cpp:92-118);
the reader here must uphold the same contract against arbitrary on-disk
garbage: every parse either yields a readable file or sets error flags, and
read_interleaved never raises.
"""

import numpy as np
import pytest

from hisstools_library.io import (Error, FileType, IAudioFile, OAudioFile,
                                      PCMFormat, get_error_string)


def _valid_file(tmp_path, ftype, name):
    x = (0.1 * np.sin(np.arange(300) / 10.0))[None, :]
    path = str(tmp_path / name)
    with OAudioFile(path, ftype, PCMFormat.Int16, 1, 48000.0) as f:
        f.write_interleaved(x.T)
    return path, open(path, "rb").read()


def _check(path):
    """The robustness contract: open + read never raise."""
    f = IAudioFile(path)
    if not f.get_is_error():
        data = f.read_interleaved()
        assert data.ndim == 2
    else:
        for e in f.get_errors():
            assert isinstance(get_error_string(e), str)
    f.close()
    return f


@pytest.mark.parametrize("case,mutate,expect", [
    ("empty", lambda b: b"", Error.FILE_BAD_FORMAT),
    ("short", lambda b: b[:8], Error.FILE_BAD_FORMAT),
    ("bad_magic", lambda b: b"XXXX" + b[4:], Error.FILE_UNKNOWN_FORMAT),
    ("bad_subtype", lambda b: b[:8] + b"QQQQ" + b[12:],
     Error.FILE_UNKNOWN_FORMAT),
    ("truncated_header", lambda b: b[:20], Error.FILE_BAD_FORMAT),
    ("zero_channels", lambda b: b[:22] + b"\x00\x00" + b[24:],
     Error.FILE_BAD_FORMAT),
    ("bad_bit_depth", lambda b: b[:34] + b"\x07\x00" + b[36:],
     Error.FILE_UNSUPPORTED_PCM_FORMAT),
    ("oversized_chunk", lambda b: b[:16] + b"\xff\xff\xff\x7f" + b[20:],
     Error.FILE_BAD_FORMAT),
])
def test_crafted_wave_corruptions(tmp_path, case, mutate, expect):
    _, raw = _valid_file(tmp_path, FileType.WAVE, "ok.wav")
    p = str(tmp_path / f"{case}.wav")
    with open(p, "wb") as fh:
        fh.write(mutate(raw))
    f = _check(p)
    assert expect in f.get_errors(), (case, f.get_errors())


def test_truncated_data_reads_available_frames(tmp_path):
    """A data chunk shorter than the header claims degrades gracefully:
    whatever frames exist are returned (reference work-loop semantics)."""
    path, raw = _valid_file(tmp_path, FileType.WAVE, "ok.wav")
    p = str(tmp_path / "trunc.wav")
    with open(p, "wb") as fh:
        fh.write(raw[: len(raw) // 2])
    f = IAudioFile(p)
    assert not f.get_is_error()
    data = f.read_interleaved()
    assert 0 < data.shape[0] < 300


@pytest.mark.parametrize("ftype,name", [(FileType.WAVE, "f.wav"),
                                        (FileType.AIFC, "f.aifc")])
def test_random_corruption_fuzz(tmp_path, ftype, name, rng):
    """200 random single/multi-byte corruptions + truncations per format:
    the open/read contract must hold for every one."""
    _, raw = _valid_file(tmp_path, ftype, name)
    for trial in range(200):
        buf = bytearray(raw)
        for _ in range(int(rng.integers(1, 5))):
            pos = int(rng.integers(0, len(buf)))
            buf[pos] = int(rng.integers(0, 256))
        if rng.random() < 0.3:
            buf = buf[: int(rng.integers(0, len(buf)))]
        p = str(tmp_path / f"fuzz_{trial}{name[-5:]}")
        with open(p, "wb") as fh:
            fh.write(bytes(buf))
        _check(p)


def test_zero_channel_aiff_flags(tmp_path):
    _, raw = _valid_file(tmp_path, FileType.AIFF, "ok.aif")
    # COMM channel count lives right after the chunk header; find it.
    idx = raw.index(b"COMM") + 8
    buf = raw[:idx] + b"\x00\x00" + raw[idx + 2:]
    p = str(tmp_path / "zc.aif")
    with open(p, "wb") as fh:
        fh.write(buf)
    f = _check(p)
    assert Error.FILE_BAD_FORMAT in f.get_errors()
