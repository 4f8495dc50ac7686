"""Profiling and roofline accounting helpers.

The reference has no in-library tracing (SURVEY.md §5) — its test drivers carry
ad-hoc wall-clock timers. Here the equivalents are:

- :func:`enable_compile_cache` — JAX's persistent compilation cache at one rule.
- :class:`Timer` — wall-clock timing that waits for the device
  (``jax.block_until_ready``) before it stops.
- :func:`trace` — context manager around ``jax.profiler`` for XLA-level traces.
- :func:`convolve_roofline` — analytic bytes/flops model of the partitioned-convolve
  hot loop. No peak rate is assumed here; a measurement supplies the device's.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


def enable_compile_cache(min_compile_secs: float = 0.5) -> str:
    """Enable JAX's persistent compilation cache and return its directory:
    ``$JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself, and no other
    directory is set here), else the fixed ``<checkout>/.jax_cache`` (the path
    is part of the cache key, so it must not move between runs). Call before
    the first jit in entry points; the library itself never sets
    process-global config."""
    import jax

    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache:
        cache = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return cache


class Timer:
    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, out=None) -> float:
        """Seconds since :meth:`start`, after waiting for ``out`` (any pytree
        of device arrays) to be computed."""
        if out is not None:
            import jax
            jax.block_until_ready(out)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def best(self) -> float:
        return min(self.times)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times)


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace around a block, written under ``log_dir``."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class Roofline:
    flops: float
    bytes: float

    def time_bound(self, peak_flops: float, peak_bw: float) -> float:
        """Speed-of-light seconds on hardware with the given peaks."""
        return max(self.flops / peak_flops, self.bytes / peak_bw)

    def fraction_of_peak(self, measured_seconds: float, peak_flops: float,
                         peak_bw: float) -> float:
        return self.time_bound(peak_flops, peak_bw) / measured_seconds


def convolve_roofline(channels: int, signal_len: int, fft_size: int,
                      num_partitions: int, dtype_bytes: int = 4) -> Roofline:
    """Bytes/flops of one uniform section's offline pass: batched rFFT + lag MAC +
    batched riFFT, assuming ideal fusion (each spectrum read once per MAC pass and
    the accumulator kept on-chip)."""
    h = fft_size // 2
    t = signal_len // h
    bins = h
    # FFTs: 2 x (T frames x 5 N log2 N flops), spectra bytes in/out
    fft_flops = 2 * channels * t * 5.0 * fft_size * np.log2(fft_size)
    # MAC: 8 flops per complex multiply-add per bin per partition
    mac_flops = channels * t * num_partitions * bins * 8.0
    # Ideal traffic: X once, H once, Y once (+ input/output samples)
    traffic = dtype_bytes * channels * (
        2 * t * bins            # X spectra write+...
        + 2 * num_partitions * bins   # H read
        + 2 * t * bins          # Y spectra
        + 2 * signal_len        # raw in + out
    )
    return Roofline(fft_flops + mac_flops, traffic)
