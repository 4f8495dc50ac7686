"""Audio file I/O tests: round-trips across formats, cross-checked with scipy,
plus 80-bit extended float parity."""

import numpy as np
import pytest
import scipy.io.wavfile

from hisstools_library.io import (
    Endianness, FileType, IAudioFile, OAudioFile, PCMFormat,
    double_to_extended, extended_to_double)


def make_signal(rng, frames, channels):
    return np.clip(rng.standard_normal((frames, channels)) * 0.3, -0.999, 0.999)


TOL = {
    PCMFormat.Int8: 2 ** -7,
    PCMFormat.Int16: 2 ** -15,
    PCMFormat.Int24: 2 ** -23,
    PCMFormat.Int32: 2 ** -30,
    PCMFormat.Float32: 1e-7,
    PCMFormat.Float64: 0.0,
}


@pytest.mark.parametrize("fmt", list(PCMFormat))
@pytest.mark.parametrize("ftype,endian", [
    (FileType.WAVE, Endianness.Little),
    (FileType.WAVE, Endianness.Big),
    (FileType.AIFC, Endianness.Big),
])
def test_roundtrip(tmp_path, rng, fmt, ftype, endian):
    path = str(tmp_path / "t.bin")
    x = make_signal(rng, 277, 3)
    with OAudioFile(path, ftype, fmt, 3, 44100.0, endian) as out:
        assert not out.get_is_error(), out.get_errors()
        out.write_interleaved(x)
    with IAudioFile(path) as inp:
        assert not inp.get_is_error(), inp.get_errors()
        assert inp.channels == 3
        assert inp.frames == 277
        assert inp.sampling_rate == 44100.0
        assert inp.pcm_format == fmt
        y = inp.read_interleaved()
    assert y.shape == x.shape
    assert np.abs(y - x).max() <= TOL[fmt] * 1.01


def test_wave_scipy_interop_write(tmp_path, rng):
    # Our WAVE output must read correctly with scipy.
    path = str(tmp_path / "t.wav")
    x = make_signal(rng, 100, 2)
    with OAudioFile(path, FileType.WAVE, PCMFormat.Int16, 2, 48000.0) as out:
        out.write_interleaved(x)
    sr, y = scipy.io.wavfile.read(path)
    assert sr == 48000
    assert np.abs(y / 32768.0 - x).max() < 2 ** -15 * 1.01


def test_wave_scipy_interop_read(tmp_path, rng):
    # And scipy's WAVE output must read correctly with us.
    path = str(tmp_path / "t.wav")
    x = (make_signal(rng, 64, 1)[:, 0] * 32767).astype(np.int16)
    scipy.io.wavfile.write(path, 22050, x)
    with IAudioFile(path) as inp:
        assert inp.sampling_rate == 22050.0
        assert inp.channels == 1
        y = inp.read_channel(0)
    assert np.abs(y - x / 32768.0).max() < 1e-9


def test_float32_wave_scipy(tmp_path, rng):
    path = str(tmp_path / "t.wav")
    x = make_signal(rng, 50, 1).astype(np.float32)
    scipy.io.wavfile.write(path, 8000, x)
    with IAudioFile(path) as inp:
        assert inp.pcm_format == PCMFormat.Float32
        y = inp.read_interleaved()
    assert np.abs(y[:, 0] - x[:, 0].astype(np.float64)).max() < 1e-7


def test_seek_and_partial_reads(tmp_path, rng):
    path = str(tmp_path / "t.wav")
    x = make_signal(rng, 200, 2)
    with OAudioFile(path, FileType.WAVE, PCMFormat.Float64, 2, 96000.0) as out:
        out.write_interleaved(x)
    with IAudioFile(path) as inp:
        inp.seek(50)
        y = inp.read_interleaved(25)
        assert np.array_equal(y, x[50:75])
        assert inp.get_position() == 75
        y2 = inp.read_interleaved(1000)  # clamped to remaining
        assert y2.shape[0] == 125


def test_write_channel_rmw(tmp_path, rng):
    path = str(tmp_path / "t.wav")
    x = make_signal(rng, 80, 3)
    with OAudioFile(path, FileType.WAVE, PCMFormat.Float64, 3, 44100.0) as out:
        out.write_interleaved(x)
        out.seek(0)
        newch = make_signal(rng, 80, 1)[:, 0]
        out.write_channel(1, newch)
    with IAudioFile(path) as inp:
        y = inp.read_interleaved()
    assert np.allclose(y[:, 0], x[:, 0])
    assert np.allclose(y[:, 1], newch)
    assert np.allclose(y[:, 2], x[:, 2])


@pytest.mark.parametrize("value", [44100.0, 48000.0, 22050.5, 96000.0, 8000.0, 1.0])
def test_extended_float_roundtrip(value):
    assert extended_to_double(double_to_extended(value)) == value


def test_extended_float_zero():
    assert extended_to_double(double_to_extended(0.0)) == 0.0


def test_bad_file_errors(tmp_path):
    path = str(tmp_path / "bad.wav")
    with open(path, "wb") as f:
        f.write(b"not an audio file at all....")
    inp = IAudioFile(path)
    assert inp.get_is_error()
    inp2 = IAudioFile(str(tmp_path / "missing.wav"))
    assert inp2.get_is_error()


def test_error_strings():
    from hisstools_library.io import Error, extract_errors_from_flags, get_error_string
    flags = int(Error.FILE_BAD_FORMAT | Error.AIFC_WRONG_VERSION)
    errs = extract_errors_from_flags(flags)
    assert Error.FILE_BAD_FORMAT in errs and Error.AIFC_WRONG_VERSION in errs
    assert get_error_string(Error.FILE_BAD_FORMAT) == "file bad format"


def test_aifc_mono_float64(tmp_path, rng):
    path = str(tmp_path / "t.aifc")
    x = make_signal(rng, 33, 1)
    with OAudioFile(path, FileType.AIFC, PCMFormat.Float64, 1, 44100.0) as out:
        out.write_interleaved(x)
    with IAudioFile(path) as inp:
        assert inp.file_type == FileType.AIFC
        y = inp.read_interleaved()
    assert np.array_equal(y, x)


def test_odd_data_chunk_pad_byte(tmp_path):
    """Odd-sized PCM data must be followed by the IFF pad byte the declared
    RIFF/FORM sizes account for (reference putPadByte, OAudioFile.cpp:494)."""
    import os
    import struct
    path = str(tmp_path / "odd.wav")
    with OAudioFile(path, FileType.WAVE, PCMFormat.Int8, 1, 44100.0) as f:
        f.write_interleaved(np.zeros((3, 1)))
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        riff_size = struct.unpack("<I", fh.read(8)[4:])[0]
    assert size == riff_size + 8  # declared size matches the actual file
    with IAudioFile(path) as f:
        assert f.frames == 3 and not f.get_is_error()


def test_zero_frame_aiff_without_ssnd(tmp_path):
    """An AIFF with numSampleFrames == 0 and no SSND chunk is legal (SSND is
    required only when frames > 0) — must read cleanly as 0 frames."""
    import struct
    comm = struct.pack(">HIH", 1, 0, 16) + double_to_extended(44100.0)
    body = b"AIFF" + b"COMM" + struct.pack(">I", len(comm)) + comm
    path = str(tmp_path / "empty.aif")
    with open(path, "wb") as fh:
        fh.write(b"FORM" + struct.pack(">I", len(body)) + body)
    with IAudioFile(path) as f:
        assert not f.get_is_error(), f.get_errors()
        assert f.frames == 0 and f.channels == 1
        assert f.read_interleaved().shape[0] == 0


@pytest.mark.parametrize("fmt,ftype", [
    (PCMFormat.Int8, FileType.WAVE),    # uint8 offset-then-round path
    (PCMFormat.Int16, FileType.WAVE),
    (PCMFormat.Int16, FileType.AIFF),
])
def test_half_lsb_rounds_away_from_zero(tmp_path, fmt, ftype):
    """Exact half-LSB samples encode with C round() semantics (half away from
    zero, reference inputToU32/inputToU8) — np.round/nearbyint tie-to-even
    would store them 1 LSB low."""
    bits = {PCMFormat.Int8: 8, PCMFormat.Int16: 16}[fmt]
    scale = 1 << (bits - 1)
    x = np.array([[0.5 / scale], [1.5 / scale], [-0.5 / scale]])
    name = "half.wav" if ftype == FileType.WAVE else "half.aif"
    path = str(tmp_path / name)
    with OAudioFile(path, ftype, fmt, 1, 48000.0) as f:
        f.write_interleaved(x)
    with IAudioFile(path) as f:
        y = f.read_interleaved()
    got = np.round(y[:, 0] * scale).astype(int)
    # round-half-away: +0.5 -> 1, +1.5 -> 2, -0.5 -> -1... except the WAVE
    # uint8 path offsets BEFORE rounding (reference inputToU8), where
    # -0.5 + 128 = 127.5 rounds away from zero to 128, i.e. 0 after decode.
    expect_neg = 0 if fmt == PCMFormat.Int8 and ftype == FileType.WAVE else -1
    assert got.tolist() == [1, 2, expect_neg], got


def test_write_file_type_none_produces_valid_aifc(tmp_path, rng):
    """FileType.NONE writes an AIFC container (reference OAudioFile.cpp:55-64:
    AIFF maps to AIFC and every non-WAVE header is big-endian). It used to
    write an AIFC header over a little-endian payload — silent byte-swapped
    corruption with no error flag."""
    path = str(tmp_path / "none.aiff")
    x = rng.uniform(-0.9, 0.9, (64, 2)).astype(np.float64)
    with OAudioFile(path, FileType.NONE, PCMFormat.Int16, 2, 48000.0) as f:
        assert f.file_type == FileType.AIFC
        assert f.audio_endianness == Endianness.Big
        f.write_interleaved(x)
    with IAudioFile(path) as f:
        assert not f.error_flags
        y = f.read_interleaved()
    assert np.abs(y - x).max() < 2.0 ** -15


def test_read_raw_matches_decoded(tmp_path, rng):
    """read_raw returns the file's own PCM bytes (reference readRaw,
    IAudioFile.h:48): decoding them manually equals read_interleaved, and
    the position advances identically."""
    path = str(tmp_path / "raw.wav")
    x = rng.uniform(-0.9, 0.9, (50, 2))
    with OAudioFile(path, FileType.WAVE, PCMFormat.Int16, 2, 48000.0) as f:
        f.write_interleaved(x)
    with IAudioFile(path) as f:
        f.seek(10)
        raw = f.read_raw(20)
        assert len(raw) == 20 * f.frame_byte_count
        assert f.get_position() == 30
        ints = np.frombuffer(raw, "<i2").astype(np.float64) / 32768.0
        f.seek(10)
        dec = f.read_interleaved(20)
        np.testing.assert_allclose(ints.reshape(20, 2), dec, atol=0)


def test_raw_copy_roundtrip(tmp_path, rng):
    """read_raw -> write_raw copies a file bit-exactly without decoding
    (the reference readRaw/writeRaw pairing, IAudioFile.h:48 / OAudioFile.h:30)."""
    src_p, dst_p = str(tmp_path / "src.wav"), str(tmp_path / "dst.wav")
    x = rng.uniform(-0.9, 0.9, (123, 2))
    with OAudioFile(src_p, FileType.WAVE, PCMFormat.Int24, 2, 44100.0) as f:
        f.write_interleaved(x)
    with IAudioFile(src_p) as src, \
            OAudioFile(dst_p, FileType.WAVE, PCMFormat.Int24, 2, 44100.0) as dst:
        while True:
            raw = src.read_raw(32)
            if not raw:
                break
            dst.write_raw(raw)
        with pytest.raises(ValueError):
            dst.write_raw(b"x")  # not a whole frame
    with IAudioFile(src_p) as a, IAudioFile(dst_p) as b:
        assert b.frames == a.frames
        np.testing.assert_array_equal(a.read_interleaved(), b.read_interleaved())
