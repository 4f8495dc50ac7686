"""Streamed audio-file reading: constant-memory block iteration.

The reference reads PCM synchronously on the caller's thread in 1024-frame
work-loop chunks (/root/reference/AudioFile/IAudioFile.cpp:619-690). For a
serving/data-loading host this module provides the framework's version:

- :class:`AudioBlockReader` — iterate ``(frames_per_block, channels)`` float
  blocks of any audio file (WAVE/AIFF/AIFC, every PCM format audio_file.py
  reads) without ever holding the whole file in memory;
- when the native runtime is available, a NATIVE background thread
  (native/rt_runtime.cpp ``ht_loader_*``) prefetches raw PCM into a lock-free
  byte ring and the NATIVE codec (hisstools_codec.cpp) decodes each block —
  disk latency stays off the consumer thread;
- pure-Python fallback otherwise (positioned ``read_interleaved`` calls).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from .audio_file import FileType, IAudioFile, PCMFormat
from . import native_codec

_CODEC_FMT = {
    PCMFormat.Int8: 0, PCMFormat.Int16: 1, PCMFormat.Int24: 2,
    PCMFormat.Int32: 3, PCMFormat.Float32: 4, PCMFormat.Float64: 5,
}


class AudioBlockReader:
    """Constant-memory block iterator over an audio file.

    ``for block in AudioBlockReader(path, 8192): ...`` yields
    ``(frames, channels)`` float arrays (the final block may be shorter).
    ``native=None`` auto-selects the native loader+codec path when both
    native libraries are available; ``False`` forces the Python fallback.
    """

    def __init__(self, path: str, frames_per_block: int = 8192,
                 dtype=np.float32, native: Optional[bool] = None,
                 ring_blocks: int = 8):
        self.path = path
        self.frames_per_block = int(frames_per_block)
        self.dtype = dtype
        self.file = IAudioFile(path)
        if self.file.get_is_error():
            raise OSError(f"{path}: {self.file.get_errors()}")
        self.channels = self.file.channels
        self.frames = self.file.frames
        self.sampling_rate = self.file.sampling_rate
        self._block_bytes = self.frames_per_block * self.file.frame_byte_count
        if native is None:
            native = native_codec.available() and self._native_rt_available()
        elif native:
            if not (native_codec.available() and self._native_rt_available()):
                raise RuntimeError("native loader requested but unavailable")
        self._native = bool(native)

    @staticmethod
    def _native_rt_available() -> bool:
        from ..utils import native_rt
        return native_rt.available()

    def __len__(self) -> int:
        return -(-self.frames // self.frames_per_block)

    def _decode(self, raw: bytes) -> np.ndarray:
        # A truncated file can deliver a partial frame (or even a partial
        # sample) in the final chunk; trim to whole frames so the decoders'
        # frombuffer/reshape never raise — "yield what we have" semantics.
        fbc = self.file.frame_byte_count
        raw = raw[:(len(raw) // fbc) * fbc]
        if not raw:
            return np.zeros((0, self.channels), self.dtype)
        wave_uint8 = (self.file.file_type == FileType.WAVE
                      and self.file.pcm_format == PCMFormat.Int8)
        little = self.file.audio_endianness.name == "Little"
        x = None
        if self._native:
            x = native_codec.decode_pcm(raw, _CODEC_FMT[self.file.pcm_format],
                                        little, wave_uint8)
        if x is None:  # codec missing or unexpected failure: numpy decode
            from .audio_file import _decode_pcm
            x = _decode_pcm(raw, self.file.pcm_format,
                            self.file.audio_endianness, np.float64, wave_uint8)
        frames = x.size // self.channels
        return x.reshape(frames, self.channels).astype(self.dtype)

    def _iter_native(self) -> Iterator[np.ndarray]:
        import time
        from ..utils import native_rt

        total_bytes = self.frames * self.file.frame_byte_count
        ring = native_rt.ByteRing(max(2 * self._block_bytes,
                                      8 * (1 << 16)))
        loader = native_rt.FileLoader(self.path, self.file.pcm_offset,
                                      total_bytes, ring)
        try:
            delivered = 0
            while delivered < total_bytes:
                want = min(self._block_bytes, total_bytes - delivered)
                chunks = []
                got = 0
                while got < want:
                    c = ring.read(want - got)
                    if c:
                        chunks.append(c)
                        got += len(c)
                    elif loader.finished() and ring.readable() == 0:
                        break  # truncated file / IO error: yield what we have
                    else:
                        time.sleep(0.0002)
                if not got:
                    break
                delivered += got
                block = self._decode(b"".join(chunks))
                if block.shape[0]:
                    yield block
        finally:
            loader.join()

    def _iter_python(self) -> Iterator[np.ndarray]:
        self.file.seek(0)
        while True:
            x = self.file.read_interleaved(self.frames_per_block,
                                           dtype=np.float64)
            if x.shape[0] == 0:
                return
            yield x.astype(self.dtype)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self._iter_native() if self._native else self._iter_python()

    def close(self):
        self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
