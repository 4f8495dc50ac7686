"""Native C++ PCM codec: build, load, and bit-exact parity with the numpy path."""

import numpy as np
import pytest

from hisstools_library.io import audio_file as af
from hisstools_library.io import native_codec


@pytest.fixture(scope="module")
def lib():
    lib = native_codec.load()
    if lib is None:
        pytest.skip("native codec unavailable (no g++?)")
    return lib


def test_version(lib):
    assert lib.ht_codec_version() == 1


@pytest.mark.parametrize("fmt", list(af.PCMFormat))
@pytest.mark.parametrize("little", [True, False])
def test_native_matches_numpy(lib, rng, fmt, little):
    x = np.clip(rng.standard_normal(1000) * 0.4, -0.999, 0.999)
    endian = af.Endianness.Little if little else af.Endianness.Big
    # encode parity
    old = af.USE_NATIVE_CODEC
    try:
        af.USE_NATIVE_CODEC = False
        raw_np = af._encode_pcm(x, fmt, endian)
        af.USE_NATIVE_CODEC = True
        raw_nat = native_codec.encode_pcm(x, fmt.value, little)
        assert raw_nat == raw_np, f"{fmt} encode mismatch"
        # decode parity
        af.USE_NATIVE_CODEC = False
        dec_np = af._decode_pcm(raw_np, fmt, endian)
        dec_nat = native_codec.decode_pcm(raw_np, fmt.value, little)
        assert np.array_equal(dec_np, dec_nat), f"{fmt} decode mismatch"
    finally:
        af.USE_NATIVE_CODEC = old


def test_native_wave_uint8(lib, rng):
    x = np.clip(rng.standard_normal(500) * 0.5, -0.999, 0.992)
    raw = native_codec.encode_pcm(x, af.PCMFormat.Int8.value, True, wave_uint8=True)
    dec = native_codec.decode_pcm(raw, af.PCMFormat.Int8.value, True, wave_uint8=True)
    assert np.abs(dec - x).max() <= 2 ** -7 * 1.01
    # bytes really are offset-unsigned
    b = np.frombuffer(raw, np.uint8)
    assert b.min() >= 0 and (b > 128).any() and (b < 128).any()


def test_file_roundtrip_through_native(lib, tmp_path, rng):
    # Full write/read through the file layer with the native codec active.
    path = str(tmp_path / "t.wav")
    x = np.clip(rng.standard_normal((128, 2)) * 0.4, -0.99, 0.99)
    with af.OAudioFile(path, af.FileType.WAVE, af.PCMFormat.Int24, 2, 48000.0) as o:
        o.write_interleaved(x)
    with af.IAudioFile(path) as i:
        y = i.read_interleaved()
    assert np.abs(y - x).max() <= 2 ** -23 * 1.01
