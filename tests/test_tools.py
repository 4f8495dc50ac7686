"""End-to-end test of the convolve_wav CLI tool: WAV in -> engine -> WAV out."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))


def test_convolve_wav_cli(tmp_path, rng):
    import convolve_wav
    from hisstools_library.io import (FileType, IAudioFile, OAudioFile,
                                          PCMFormat)

    sr = 48000.0
    x = (0.3 * rng.standard_normal(20000)).astype(np.float64)
    ir = (rng.standard_normal(3000) * np.exp(-np.arange(3000) / 1000) * 0.1)
    sig_p = str(tmp_path / "sig.wav")
    ir_p = str(tmp_path / "ir.wav")
    out_p = str(tmp_path / "out.wav")
    with OAudioFile(sig_p, FileType.WAVE, PCMFormat.Float32, 1, sr) as f:
        f.write_interleaved(x[:, None])
    with OAudioFile(ir_p, FileType.WAVE, PCMFormat.Float32, 1, sr) as f:
        f.write_interleaved(ir[:, None])

    convolve_wav.main([sig_p, ir_p, out_p])

    with IAudioFile(out_p) as f:
        y = np.asarray(f.read_interleaved(), np.float64)[:, 0]
    ref = np.convolve(x, ir)
    assert len(y) == len(ref)
    if np.abs(ref).max() > 1.0:
        ref = ref * (10 ** (-1 / 20) / np.abs(ref).max())
    err = y - ref
    snr = 10 * np.log10((ref * ref).sum() / (err * err).sum())
    assert snr > 90.0


def test_convolve_wav_cli_scheme_engine(tmp_path, rng):
    import convolve_wav
    from hisstools_library.io import (FileType, IAudioFile, OAudioFile,
                                          PCMFormat)

    sr = 44100.0
    x = (0.2 * rng.standard_normal((2, 9000))).astype(np.float64)
    ir = (rng.standard_normal(2000) * 0.05)
    sig_p = str(tmp_path / "sig.wav")
    ir_p = str(tmp_path / "ir.wav")
    out_p = str(tmp_path / "out.wav")
    with OAudioFile(sig_p, FileType.WAVE, PCMFormat.Float32, 2, sr) as f:
        f.write_interleaved(x.T)
    with OAudioFile(ir_p, FileType.WAVE, PCMFormat.Float32, 1, sr) as f:
        f.write_interleaved(ir[:, None])

    convolve_wav.main([sig_p, ir_p, out_p, "--engine", "scheme", "--trim"])

    with IAudioFile(out_p) as f:
        y = np.asarray(f.read_interleaved(), np.float64).T
    assert y.shape == (2, 9000)
    ref = np.stack([np.convolve(x[i], ir)[:9000] for i in range(2)])
    if np.abs(ref).max() > 1.0:
        ref = ref * (10 ** (-1 / 20) / np.abs(ref).max())
    err = y - ref
    snr = 10 * np.log10((ref * ref).sum() / (err * err).sum())
    assert snr > 90.0
