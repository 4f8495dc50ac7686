"""Real-time serving loop: IR hot-swap under a running stream.

The reference's RT-safety story (the reason MemorySwap + ThreadLocks exist):

- the audio thread calls ``MonoConvolve::process`` which ``attempt()``s the
  swappable IR buffer and **emits silence** while the loader holds it
  (/root/reference/HIRT_Multichannel_Convolution/MonoConvolve.cpp:179-201);
- the loader thread prepares and installs a new IR under the blocking lock
  (``MemorySwap::equal``, MonoConvolve.cpp:118-140, MemorySwap.h:174-212),
  growing the allocation only when capacity is exceeded;
- after a swap the engine state is reset (MonoConvolve.cpp:136).

JAX counterpart: device compute is functional, so the swappable value is
the prepared ``MonoIR`` pytree and the "allocation capacity" is the *padded IR
length* (fixed pytree shapes -> the jitted step is reused across swaps with no
recompile; growing past capacity recompiles, exactly the reference's
reallocation cost). The audio thread's step is non-blocking on the lock and
sample-granular (any callback size, models/mono.process_any).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import mono
from ..models.mono import PartitionScheme, LatencyMode
from .memory_swap import MemorySwap


@dataclasses.dataclass
class _PreparedIR:
    """What the loader installs: the device pytree + an identity stamp."""
    ir: mono.MonoIR
    version: int
    capacity: int


class StreamingServer:
    """Two-thread serving harness around the sample-granular streaming engine.

    Audio thread: :meth:`process` — never blocks; silence while the loader
    holds the IR, state reset on the first block after a swap.
    Loader thread: :meth:`set_ir` — prepares the new IR *outside* the lock
    (device transforms of the padded IR), installs it under the lock.
    """

    def __init__(self, channels: int, capacity: int = 1 << 16,
                 latency: LatencyMode = LatencyMode.Zero,
                 scheme: Optional[PartitionScheme] = None,
                 dtype=jnp.float32, backend: Optional[str] = None,
                 native: Optional[bool] = None):
        self.scheme = scheme if scheme is not None else \
            PartitionScheme.from_latency(latency)
        self.channels = channels
        self.capacity = capacity
        self.dtype = dtype
        self.backend = backend
        # The swap cell's lock lives in native memory when the native runtime
        # is available (native/rt_runtime.cpp — the reference's C++
        # MemorySwap/ThreadLocks counterpart, usable from non-Python audio
        # threads); the pure-Python cell is the fallback. ``native`` forces
        # either choice.
        from . import native_rt
        use_native = native_rt.available() if native is None else native
        self._swap = (native_rt.NativeMemorySwap() if use_native
                      else MemorySwap())
        self._version = 0
        self._version_lock = threading.Lock()
        # Audio-thread-local (single consumer): current state + the IR version
        # it was built for.
        self._state: Optional[mono.MonoStreamState] = None
        self._state_version = -1
        self._step = jax.jit(
            lambda ir, s, x: mono.process_any(ir, s, x, backend=self.backend),
            donate_argnums=(1,))

    # -- loader thread --------------------------------------------------------

    def set_ir(self, ir, capacity: Optional[int] = None) -> int:
        """Prepare and install a new IR bank; returns its version stamp.

        ``ir``: (channels, L) host array. Preparation (rFFT of every partition)
        runs outside the lock so the audio thread is blocked only for the
        pointer swap — the reference's allocation-outside/swap-inside
        discipline (MemorySwap.h:15-17: memory is freed in the swapping
        thread)."""
        ir = np.asarray(ir)
        if ir.ndim == 1:
            ir = np.broadcast_to(ir, (self.channels, ir.shape[-1]))
        if ir.shape[0] != self.channels:
            raise ValueError(f"IR bank has {ir.shape[0]} channels, "
                             f"server has {self.channels}")
        length = ir.shape[-1]
        cap = capacity if capacity is not None else self.capacity
        cap = max(cap, 1)
        while cap < length:  # grow capacity (recompile on next process)
            cap *= 2
        padded = np.zeros((self.channels, cap), ir.dtype)
        padded[:, :length] = ir
        prepared_ir = mono.prepare_ir(self.scheme, padded, dtype=self.dtype,
                                      backend=self.backend, offline_tail=False)
        # Finish EVERY prepared array before installing the swap, so the audio
        # thread's first post-swap block does not queue behind the
        # per-partition rFFTs; loader-thread latency is off the hot path.
        jax.block_until_ready(prepared_ir)
        with self._version_lock:
            self._version += 1
            version = self._version
        self.capacity = cap
        self._swap.swap(_PreparedIR(prepared_ir, version, cap), cap).release()
        return version

    # -- audio thread ---------------------------------------------------------

    def process(self, block) -> Tuple[jax.Array, bool]:
        """One audio callback of ANY length: returns (output, live).

        ``live`` is False when the loader held the lock — the output is
        silence for exactly that block (reference MonoConvolve.cpp:181-183) and
        the stream resumes (with reset state, as after the reference's
        set->reset) once the swap completes. The returned array is a device
        array whose computation is dispatched but not synced — the callback
        never blocks on the device either."""
        # Convert at the edge, as the reference's double overload does
        # (Convolver.cpp:156-183): the engine runs in self.dtype regardless
        # of what the callback feeds (float64 numpy is numpy's default).
        block = jnp.asarray(block, self.dtype)
        with self._swap.attempt() as handle:
            prepared = handle.get()
            if prepared is None:
                return jnp.zeros(block.shape, self.dtype), False
            if prepared.version != self._state_version:
                # First block after a swap (or first block ever): fresh state.
                self._state = mono.init_stream_state(
                    self.scheme, prepared.ir, (self.channels,), self.dtype)
                self._state_version = prepared.version
            self._state, y = self._step(prepared.ir, self._state, block)
            return y, True

    def latency_samples(self) -> int:
        return self.scheme.latency
