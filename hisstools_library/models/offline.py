"""Offline (non-real-time) FIR convolution at maximum throughput.

The reference's non-uniform scheme exists to bound *latency* on a sample-streaming
CPU; offline IR processing in the reference goes through a single big FFT
(spectral_processor::convolve). Here the offline form of long FIR convolution is
**uniform partitioned overlap-save with look-ahead**: one PartitionedConvolve
section at a large FFT size with IR offset 0, whose inherent one-hop delay is
removed by shifting the output left (free offline). This keeps peak memory
bounded (unlike one giant FFT): batched rFFT over every hop, the partition lag
MAC, batched riFFT.

Use :class:`FastFIR` when the same IR convolves many signals (spectra prepared
once), or :func:`fast_fir` for one-shot use.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Split
from . import partitioned as part


def choose_fft_size(ir_len: int) -> int:
    """Pick the uniform FFT size balancing FFT cost (~log N per sample) against
    partition-MAC cost (~IR/N per sample): about eight partitions, N = 2^16 for
    a 10 s IR at 48 kHz, bounded to 2^11..2^17. The rule has not been re-swept
    on the GPU; a benchmark sweep may move it."""
    target = max(ir_len // 8, 2048)
    n = 1 << max(int(np.ceil(np.log2(target))), 11)
    return int(min(max(n, 1 << part.MIN_FFT_SIZE_LOG2), 1 << 17))


class FastFIR:
    """Uniform partitioned offline convolver with prepared spectra."""

    def __init__(self, ir, fft_size: Optional[int] = None, dtype=jnp.float32,
                 backend: Optional[str] = None):
        from ..utils import debug_stages
        ir = np.asarray(ir)
        self.ir_len = ir.shape[-1]
        self.fft_size = fft_size or choose_fft_size(self.ir_len)
        self.hop = self.fft_size >> 1
        self.spectra = part.impulse_spectra(ir, self.fft_size, 0, 0, dtype, backend)
        self.backend = backend
        # Host IR copy kept only when per-stage debugging is on (the report
        # needs the raw taps for its float64 oracles).
        self._ir_debug = ir if debug_stages.enabled() else None

    def __call__(self, x: jax.Array) -> jax.Array:
        """conv(x, ir)[: len(x)] — the steady-state causal convolution.

        When jitting, wrap :meth:`apply` and pass ``self.spectra`` as an argument
        (a closure would bake the spectra into the program as constants)."""
        if self._ir_debug is not None:
            from ..utils import debug_stages
            debug_stages.maybe_report(self._ir_debug, x, self.fft_size,
                                      self.backend, "FastFIR")
        return self.apply(self.spectra, x, backend=self.backend)

    @staticmethod
    def apply(spectra: Split, x: jax.Array,
              backend: Optional[str] = None) -> jax.Array:
        """Pure function: uniform-partitioned offline convolution with look-ahead."""
        h = spectra.shape[-1]
        L = x.shape[-1]
        pad = [(0, 0)] * (x.ndim - 1) + [(0, h)]
        xp = jnp.pad(x, pad)
        y = part.PartitionedConvolve.process_offline(spectra, xp,
                                                     backend=backend)
        # The o=0 engine emits conv delayed by one hop; shift left (look-ahead).
        return y[..., h:h + L]


def fast_fir(x: jax.Array, ir, fft_size: Optional[int] = None,
             dtype=None, backend: Optional[str] = None) -> jax.Array:
    """One-shot offline convolution: conv(x, ir)[: len(x)]."""
    dtype = dtype or x.dtype
    eng = FastFIR(ir, fft_size, dtype, backend)
    return eng(x)
