"""Multichannel N-in / M-out convolution routing.

JAX counterpart of ``HISSTools::Convolver`` + ``NToMonoConvolve``
(/root/reference/HIRT_Multichannel_Convolution/Convolver.cpp, NToMonoConvolve.cpp).
The reference loops over output channels, each summing N per-input MonoConvolves
into one output with temp-buffer accumulation (NToMonoConvolve.cpp:35-43). Here the
(out x in) matrix of convolvers is a single batched engine: IR spectra carry leading
dims ``(M, N)``, the input broadcasts across the output axis, and the N-to-mono
reduction is one ``sum`` over the input axis — which under `shard_map` becomes a
``psum`` over the channel mesh axis (see parallel/).

Two routing modes, as in the reference (Convolver.cpp:5-41):

- **N2M**: every input convolves into every output through IR[out, in].
- **Parallel**: N independent channels, IR[c] applied to input c.

The reference's double-precision overload converts to float at the edges
(Convolver.cpp:156-183); here dtype is a parameter throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.errors import ConvolveError, ConvolveException
from . import mono
from .mono import LatencyMode, PartitionScheme


class Convolver:
    """N x M (or parallel N x N) convolution matrix.

    IRs are set per (in, out) pair host-side; processing is pure/jittable over the
    prepared pytree. ``process(state, ins)``: ins (N, L) -> outs (M, L).
    """

    def __init__(self, num_ins: int, num_outs: Optional[int] = None,
                 latency: LatencyMode = LatencyMode.Zero,
                 scheme: Optional[PartitionScheme] = None,
                 max_length: int = 16384):
        parallel = num_outs is None
        num_ins = max(1, num_ins)
        self.parallel = parallel
        self.num_ins = num_ins
        self.num_outs = num_ins if parallel else max(1, num_outs)
        self.scheme = scheme if scheme is not None else PartitionScheme.from_latency(latency)
        self.max_length = max_length
        # Host-side IR bank: (M, N, L) zero-padded numpy; parallel mode stores (C, L).
        self._bank: Optional[np.ndarray] = None
        self._bank_len = 0
        self.ir: Optional[mono.MonoIR] = None

    # -- IR management (host-side) ------------------------------------------------

    def _ensure_bank(self, length: int):
        shape = ((self.num_ins, length) if self.parallel
                 else (self.num_outs, self.num_ins, length))
        if self._bank is None or length > self._bank_len:
            bank = np.zeros(shape, np.float64)
            if self._bank is not None and self._bank_len:
                bank[..., :self._bank_len] = self._bank
            self._bank = bank
            self._bank_len = length

    def resize(self, in_chan: int, out_chan: int, length: int) -> ConvolveError:
        """Reserve capacity for a coming IR (reference Convolver::resize,
        Convolver.cpp:102-112). The reference grows one MonoConvolve's final
        section; here all pairs share one batched engine, so the bank-wide
        capacity grows — a superset reservation with the same observable
        contract (the pair can subsequently take a ``length``-tap IR with
        resize=False)."""
        if self.parallel and in_chan != out_chan:
            return ConvolveError.IN_CHAN_OUT_OF_RANGE
        if not 0 <= out_chan < self.num_outs:
            return ConvolveError.OUT_CHAN_OUT_OF_RANGE
        if not 0 <= in_chan < self.num_ins:
            return ConvolveError.IN_CHAN_OUT_OF_RANGE
        self.max_length = max(self.max_length, int(length))
        return ConvolveError.NONE

    def set(self, in_chan: int, out_chan: int, ir, resize: bool = True) -> ConvolveError:
        """Load one IR (reference Convolver::set, Convolver.cpp:114-134). For
        parallel mode pass in_chan == out_chan. Call prepare() afterwards."""
        if self.parallel:
            if in_chan != out_chan:
                return ConvolveError.IN_CHAN_OUT_OF_RANGE
        if not 0 <= out_chan < self.num_outs:
            return ConvolveError.OUT_CHAN_OUT_OF_RANGE
        if not 0 <= in_chan < self.num_ins:
            return ConvolveError.IN_CHAN_OUT_OF_RANGE
        ir = np.asarray(ir, np.float64)
        err = ConvolveError.NONE
        if ir.shape[-1] > self.max_length:
            if resize:
                self.max_length = ir.shape[-1]
            else:
                # Reference semantics: load clamped to capacity AND report
                # the truncation (MonoConvolve.cpp:117-139 via Convolver::set).
                err = ConvolveError.MEM_ALLOC_TOO_SMALL
                ir = ir[..., :self.max_length]
        n = ir.shape[-1]
        self._ensure_bank(max(self._bank_len, n, 1))
        if self.parallel:
            self._bank[in_chan, :] = 0.0
            self._bank[in_chan, :n] = ir
        else:
            self._bank[out_chan, in_chan, :] = 0.0
            self._bank[out_chan, in_chan, :n] = ir
        self.ir = None  # invalidate prepared spectra
        return err

    def set_all(self, irs, resize: bool = True) -> ConvolveError:
        """Bulk-load the whole IR bank: (C, L) for parallel or (M, N, L) for N2M."""
        irs = np.asarray(irs, np.float64)
        want = (self.num_ins,) if self.parallel else (self.num_outs, self.num_ins)
        if irs.shape[:-1] != want:
            raise ConvolveException(ConvolveError.IN_CHAN_OUT_OF_RANGE,
                                    f"bank shape {irs.shape} != {want + ('L',)}")
        err = ConvolveError.NONE
        if irs.shape[-1] > self.max_length:
            if resize:
                self.max_length = irs.shape[-1]
            else:  # load clamped + report, as in set()
                err = ConvolveError.MEM_ALLOC_TOO_SMALL
                irs = irs[..., :self.max_length]
        self._bank = irs.copy()
        self._bank_len = irs.shape[-1]
        self.ir = None
        return err

    def clear(self, in_chan: Optional[int] = None, out_chan: Optional[int] = None,
              resize: bool = True) -> ConvolveError:
        """Zero one IR or the whole bank (reference Convolver::clear, :51-75:
        the no-channel overload clears every pair; the per-pair overload takes
        BOTH channels). Parallel mode requires in_chan == out_chan, like set.
        Channel validation happens whether or not a bank exists yet."""
        if in_chan is None and out_chan is None:
            if self._bank is not None:
                self._bank[...] = 0.0
        else:
            if self.parallel:
                # In parallel mode both arguments name the same channel —
                # either one alone is unambiguous.
                if out_chan is None:
                    out_chan = in_chan
                if in_chan is None:
                    in_chan = out_chan
                if in_chan != out_chan:
                    return ConvolveError.IN_CHAN_OUT_OF_RANGE
            elif in_chan is None or out_chan is None:
                # One channel of an N2M pair alone does not name an IR —
                # indexing with None would silently hit the wrong bank row.
                raise ValueError("N2M clear needs both in_chan and out_chan "
                                 "(or neither, to clear the whole bank)")
            if not 0 <= in_chan < self.num_ins:
                return ConvolveError.IN_CHAN_OUT_OF_RANGE
            if not 0 <= out_chan < self.num_outs:
                return ConvolveError.OUT_CHAN_OUT_OF_RANGE
            if self._bank is not None:
                if self.parallel:
                    self._bank[in_chan, :] = 0.0
                else:
                    self._bank[out_chan, in_chan, :] = 0.0
        self.ir = None
        return ConvolveError.NONE

    def prepare(self, dtype=jnp.float32, backend: Optional[str] = None,
                offline_tail: Optional[bool] = None) -> mono.MonoIR:
        """Build the device-resident spectra pytree from the host bank.

        ``offline_tail``: None (default) = lazy — the throughput-optimal
        offline tail (an extra full-BANK transform + ~bank-sized device
        memory that streaming never reads) attaches on the first
        :meth:`process_offline` call; True builds it eagerly; False never
        (same contract as :meth:`mono.MonoConvolve.set`)."""
        if self._bank is None:
            self._ensure_bank(1)
        self._tail_lazy = offline_tail is None
        self._dtype = dtype
        self._backend = backend
        self.ir = mono.prepare_ir(self.scheme, self._bank, dtype=dtype,
                                  backend=backend,
                                  offline_tail=bool(offline_tail))
        return self.ir

    # -- processing ----------------------------------------------------------------

    @property
    def block_size(self) -> int:
        return self.scheme.sizes[-1] >> 1

    def init_state(self, dtype=jnp.float32) -> mono.MonoState:
        if self.ir is None:
            self.prepare(dtype)
        batch = (self.num_ins,) if self.parallel else (self.num_outs, self.num_ins)
        return mono.init_state(self.scheme, self.ir, batch, dtype)

    def process(self, state: mono.MonoState, ins: jax.Array,
                backend: Optional[str] = None) -> Tuple[mono.MonoState, jax.Array]:
        """ins: (N, L) -> outs (M, L) [parallel: (C, L) -> (C, L)]; streaming."""
        return process(self.ir, state, ins, self.parallel, backend=backend)

    def init_block_state(self, dtype=jnp.float32) -> mono.MonoBlockState:
        """Two-tier hop-aligned block state (mono.init_block_state): requires
        a far-tier IR (long enough for the far hop); :meth:`process` blocks
        must be multiples of ``ir.far.shape[-1]`` samples."""
        if self.ir is None:
            self.prepare(dtype)
        batch = (self.num_ins,) if self.parallel else (self.num_outs,
                                                       self.num_ins)
        return mono.init_block_state(self.scheme, self.ir, batch, dtype)

    def init_stream_state(self, dtype=jnp.float32) -> mono.MonoStreamState:
        """Fresh sample-granular state for :meth:`process_any`."""
        if self.ir is None:
            self.prepare(dtype)
        batch = (self.num_ins,) if self.parallel else (self.num_outs, self.num_ins)
        return mono.init_stream_state(self.scheme, self.ir, batch, dtype)

    def process_any(self, state: mono.MonoStreamState, ins: jax.Array,
                    backend: Optional[str] = None
                    ) -> Tuple[mono.MonoStreamState, jax.Array]:
        """Streaming step accepting ANY block length (reference
        Convolver::process takes arbitrary numSamples, Convolver.cpp:138-154)."""
        return process_any(self.ir, state, ins, self.parallel, backend=backend)

    def process_offline(self, ins: jax.Array,
                        backend: Optional[str] = None) -> jax.Array:
        if (self.ir is not None and self.ir.tail is None
                and getattr(self, "_tail_lazy", False)):
            # First offline use of a lazily-prepared bank: attach ONLY the
            # missing throughput tail (the section spectra are already built;
            # the host bank is retained by this class, so no extra copy).
            tail, shift = mono._make_offline_tail(self.scheme, self._bank,
                                                  self._dtype, self._backend)
            self.ir = mono.MonoIR(self.ir.head_taps, self.ir.spectra,
                                  tail, shift, self.ir.block0, self.ir.far)
        return process_offline(self.ir, ins, self.parallel, backend=backend)

    def reset(self, *, in_chan: Optional[int] = None,
              out_chan: Optional[int] = None,
              state: Optional[mono.MonoState] = None,
              dtype=jnp.float32) -> mono.MonoState:
        """Streaming-state reset (reference Convolver::reset, :80-104).

        With no channel arguments returns a fresh full state. With channel
        arguments (and the current ``state``) zeroes only that channel's
        history, matching the reference's per-channel reset semantics.
        Keyword-only: the pre-round-2 signature was ``reset(dtype)``, so a
        positional argument would silently bind a dtype to ``in_chan``."""
        if in_chan is None and out_chan is None:
            return self.init_state(dtype)
        if state is None:
            raise ConvolveException(ConvolveError.MEM_UNAVAILABLE,
                                    "per-channel reset needs the current state")
        if self.parallel:
            if in_chan is None or in_chan >= self.num_ins:
                raise ConvolveException(ConvolveError.IN_CHAN_OUT_OF_RANGE,
                                        str(in_chan))
            idx = (in_chan,)
        else:
            if out_chan is None or out_chan >= self.num_outs:
                raise ConvolveException(ConvolveError.OUT_CHAN_OUT_OF_RANGE,
                                        str(out_chan))
            if in_chan is None or in_chan >= self.num_ins:
                raise ConvolveException(ConvolveError.IN_CHAN_OUT_OF_RANGE,
                                        str(in_chan))
            idx = (out_chan, in_chan)
        return reset_channel(state, idx)


# -- pure functions ---------------------------------------------------------------

def reset_channel(state, idx: Tuple[int, ...]):
    """Zero one channel's streaming history in a state pytree.

    ``idx`` indexes the batch prefix — ``(chan,)`` for parallel routing or
    ``(out_chan, in_chan)`` for N2M. Scalar leaves (the shared ring position)
    are untouched: a zeroed ring is a fresh engine at any slot position, so the
    reset channel restarts exactly like a new state while others keep phase
    (reference Convolver::reset resets one MonoConvolve, Convolver.cpp:80-104)."""
    return jax.tree_util.tree_map(
        lambda leaf: leaf if leaf.ndim == 0 else leaf.at[idx].set(0), state)

def process(ir: mono.MonoIR, state: mono.MonoState, ins: jax.Array,
            parallel: bool, backend: Optional[str] = None
            ) -> Tuple[mono.MonoState, jax.Array]:
    """Streaming multichannel step. N2M: ir leading dims (M, N), ins (N, L) ->
    (M, L) via sum over the input axis (reference NToMonoConvolve accumulate loop).
    Parallel: ir leading dim (C,), ins (C, L) -> (C, L)."""
    if parallel:
        return mono.process(ir, state, ins, backend=backend)
    m = ir.head_taps.shape[0]
    ins_b = jnp.broadcast_to(ins[None], (m,) + ins.shape)
    new_state, y = mono.process(ir, state, ins_b, backend=backend)
    return new_state, jnp.sum(y, axis=-2)


def process_any(ir: mono.MonoIR, state: mono.MonoStreamState, ins: jax.Array,
                parallel: bool, backend: Optional[str] = None
                ) -> Tuple[mono.MonoStreamState, jax.Array]:
    """Sample-granular multichannel step: any block length, same routing as
    :func:`process`."""
    if parallel:
        return mono.process_any(ir, state, ins, backend=backend)
    m = ir.head_taps.shape[0]
    ins_b = jnp.broadcast_to(ins[None], (m,) + ins.shape)
    new_state, y = mono.process_any(ir, state, ins_b, backend=backend)
    return new_state, jnp.sum(y, axis=-2)


def process_offline(ir: mono.MonoIR, ins: jax.Array, parallel: bool,
                    backend: Optional[str] = None) -> jax.Array:
    if parallel:
        return mono.process_offline(ir, ins, backend=backend)
    m = ir.head_taps.shape[0]
    ins_b = jnp.broadcast_to(ins[None], (m,) + ins.shape)
    y = mono.process_offline(ir, ins_b, backend=backend)
    return jnp.sum(y, axis=-2)
