"""Uniform partitioned overlap-save FFT convolution — the framework's hot engine.

JAX counterpart of ``HISSTools::PartitionedConvolve``
(/root/reference/HIRT_Multichannel_Convolution/PartitionedConvolve.cpp). The
reference is a stateful sample-streaming engine: a rolling ring of input spectra
(the frequency-domain delay line), per-hop rFFT -> complex MAC across partitions ->
riFFT overlap-save, with deferred-partition scheduling to amortise MAC cost across
the hop (:316-348). On an accelerator the amortised scheduling is irrelevant (all
partitions are processed in one batched pass), and the engine becomes:

- **streaming**: a pure ``step`` carried through ``lax.scan`` whose state pytree is
  exactly the reference's streaming state made explicit (previous input block +
  spectra ring + ring position — cf. PartitionedConvolve.h:62-81). Checkpointing
  falls out for free (the state is a serialisable pytree).
- **offline**: all hop spectra computed in one batched rFFT, the partition MAC as a
  lag-accumulation over HBM-resident spectra (a P-tap frequency-domain FIR along the
  hop axis), and one batched riFFT — no sequential dependency at all.

Semantics (derived from the reference's buffer mechanics, SURVEY.md §3.1): a section
with FFT size N (hop H = N/2) holding IR chunk taps ``ir[o + p*H + j]`` emits tap
``(o + p*H + j)`` at delay ``(H - o) + (o + p*H + j)`` — i.e. the engine output is
``conv(x, ir[o:o+len])`` delayed by ``H - o`` samples. With the scheme offsets of
MonoConvolve (each section's offset equals its own hop) the composite is exact.

Scaling: output = irfft-accumulated spectra x ``1/(4N)`` — the reference's
``scaleStore`` factor (PartitionedConvolve.cpp:232-241) compensating the x2 forward
scale on both operands.

MIN/MAX FFT sizes 2^5..2^20 as in the reference (PartitionedConvolve.h:18-19).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.errors import ConvolveError, ConvolveException
from ..core.types import Split, packed_mul
from ..fft import api as fft_api

MIN_FFT_SIZE_LOG2 = 5
MAX_FFT_SIZE_LOG2 = 20


def validate_fft_size(fft_size: int) -> int:
    if fft_size < 1:
        # Guard before the shift: fft_size=0 gives log2n=-1 and `1 << -1`
        # raises a raw ValueError instead of the ConvolveError code.
        raise ConvolveException(ConvolveError.FFT_SIZE_OUT_OF_RANGE, str(fft_size))
    log2n = fft_size.bit_length() - 1
    if (1 << log2n) != fft_size:
        raise ConvolveException(ConvolveError.FFT_SIZE_NON_POWER_OF_TWO, str(fft_size))
    if log2n < MIN_FFT_SIZE_LOG2 or log2n > MAX_FFT_SIZE_LOG2:
        raise ConvolveException(ConvolveError.FFT_SIZE_OUT_OF_RANGE, str(fft_size))
    return log2n


def impulse_spectra(ir, fft_size: int, offset: int = 0, length: int = 0,
                    dtype=jnp.float32, backend: Optional[str] = None) -> Split:
    """Chop ``ir[offset : offset + length]`` into H-sample chunks, zero-pad each to
    the FFT size and rFFT into the partition spectra (reference
    PartitionedConvolve::set, :173-225).

    ``ir``: (..., L) array. Returns packed Split of shape (..., P, N/2).
    """
    validate_fft_size(fft_size)
    h = fft_size >> 1
    ir = np.asarray(ir)
    n = ir.shape[-1]
    take = 0 if n <= offset else n - offset
    if length:
        take = min(take, length)
    chunk = ir[..., offset:offset + take]
    p = max(1, -(-take // h))  # at least one (zero) partition
    padded = np.zeros(ir.shape[:-1] + (p * h,), np.float64)
    padded[..., :take] = chunk
    frames = padded.reshape(ir.shape[:-1] + (p, h))
    frames = np.concatenate([frames, np.zeros_like(frames)], axis=-1)  # zero-pad to N
    re, im = fft_api.rfft(jnp.asarray(frames, dtype), backend=backend)
    return Split(re, im)


# Lags summed per step of the partition MAC's loop. Inside a chunk the lags are
# unrolled, so XLA emits the chunk as one fusion that reads the accumulator
# once; a chunk of 1 is the plain per-lag loop (one accumulator pass per lag).
# Measured on an H100 (tools/mac_ab.py, 128 channels): chunk 2 was the fastest,
# or within 4% of it, at the offline (P=15: 6.5 ms against 12.7 ms for chunk
# 1), far-tier (P=14) and collapsed Zero-preset (P=59) shapes. Larger chunks
# and a full static unroll were no faster: the fused window reads still come
# from device memory once per lag.
_MAC_CHUNK = 2


def lag_mac(xp_re, xp_im, h_re, h_im, t: int, chunk: int = _MAC_CHUNK):
    """Partition MAC over zero-padded spectra: ``Y_j = sum_p X_{j+P-1-p} H_p``.

    ``xp_*``: (..., T+P, K) spectra whose first P rows are the history (zeros
    offline, the carried ring when streaming); ``h_*``: (..., P, K). Returns
    packed-correct (..., T, K) accumulations (DC/Nyquist lane multiplied as
    two reals, core.types.packed_mul). Lags are summed in order 0..P-1:
    lag 0, then chunks of ``chunk`` statically unrolled lags inside a
    ``fori_loop`` over chunks, so long IRs (P in the hundreds) keep a bounded
    program size.
    """
    p = h_re.shape[-2]
    hop_axis = xp_re.ndim - 2

    def lag_term(lag):
        start = p - 1 - lag
        xs = Split(
            jax.lax.dynamic_slice_in_dim(xp_re, start, t, axis=hop_axis),
            jax.lax.dynamic_slice_in_dim(xp_im, start, t, axis=hop_axis))
        hp = Split(jax.lax.dynamic_slice_in_dim(h_re, lag, 1, axis=-2),
                   jax.lax.dynamic_slice_in_dim(h_im, lag, 1, axis=-2))
        return packed_mul(xs, hp)

    def add_lag(acc, lag):
        prod = lag_term(lag)
        return acc[0] + prod.re, acc[1] + prod.im

    def add_chunk(c, acc):
        for j in range(chunk):
            acc = add_lag(acc, 1 + c * chunk + j)
        return acc

    # Lag 0 starts the sum, so the carry has the products' dtype and (inside
    # shard_map) their varying mesh axes.
    first = lag_term(0)
    acc = (first.re, first.im)
    n_chunks = (p - 1) // chunk
    if n_chunks > 1:
        acc = jax.lax.fori_loop(0, n_chunks, add_chunk, acc)
    elif n_chunks == 1:
        acc = add_chunk(0, acc)
    for lag in range(1 + n_chunks * chunk, p):
        acc = add_lag(acc, lag)
    return acc


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PartitionedState:
    """Streaming state (the reference's internal buffers made explicit:
    PartitionedConvolve.h:62-81)."""

    prev: jax.Array   # (..., H)      previous input block
    ring: Split       # (..., P, N/2) frequency-domain delay line of input spectra
    pos: jax.Array    # ()            int32 ring write position (t mod P)

    def tree_flatten(self):
        return (self.prev, self.ring, self.pos), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class StreamState:
    """Sample-granular streaming state for arbitrary callback block sizes.

    The reference's RW-counter main loop (PartitionedConvolve.cpp:243-385)
    stages partial hops in dual input copies, doles output out of the last
    iFFT's store, and fires the FFT only when the counter crosses a hop
    boundary (the ``tillNextFFT`` sizing, :298-300). This pytree is that
    machinery made explicit and functional:

    - ``win``:     last N consumed input samples (the staging copies),
    - ``out_buf``: the H-sample output store for the current hop period,
    - ``phase``:   samples consumed since the last hop boundary (RW counter
                   mod hop),
    - ``ring``/``pos``: the frequency-domain delay line, exactly as in
      :class:`PartitionedState`.
    """

    win: jax.Array      # (..., N)
    out_buf: jax.Array  # (..., H)
    phase: jax.Array    # ()  int32
    ring: Split         # (..., P, N/2)
    pos: jax.Array      # ()  int32

    def tree_flatten(self):
        return (self.win, self.out_buf, self.phase, self.ring, self.pos), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


class PartitionedConvolve:
    """Configuration holder + pure processing functions for one uniform section."""

    def __init__(self, fft_size: int, max_length: int = 0, offset: int = 0,
                 length: int = 0):
        validate_fft_size(fft_size)
        self.fft_size = fft_size
        self.hop = fft_size >> 1
        self.offset = offset
        self.length = length
        self.max_length = max_length
        self.spectra: Optional[Split] = None

    def set(self, ir, dtype=jnp.float32, backend: Optional[str] = None) -> ConvolveError:
        err = ConvolveError.NONE
        ir = np.asarray(ir)
        if self.max_length:
            avail = max(0, ir.shape[-1] - self.offset)
            want = min(avail, self.length) if self.length else avail
            if want > self.max_length:
                err = ConvolveError.MEM_ALLOC_TOO_SMALL
        length = self.length if self.length else (self.max_length or 0)
        if self.max_length and length:
            # Convolve only what fits, like the reference (it clamps to
            # mMaxImpulseLength alongside the error, PartitionedConvolve.cpp
            # :195-199) — otherwise the error path builds MORE partitions
            # than the declared capacity implies.
            length = min(length, self.max_length)
        self.spectra = impulse_spectra(ir, self.fft_size, self.offset, length,
                                       dtype, backend)
        return err

    @property
    def num_partitions(self) -> int:
        return 0 if self.spectra is None else self.spectra.shape[-2]

    def init_state(self, batch_shape=(), dtype=jnp.float32) -> PartitionedState:
        p = max(self.num_partitions, 1)
        bins = self.hop
        return PartitionedState(
            prev=jnp.zeros(batch_shape + (self.hop,), dtype),
            ring=Split.zeros(batch_shape + (p, bins), dtype),
            pos=jnp.zeros((), jnp.int32),
        )

    def init_stream_state(self, batch_shape=(), dtype=jnp.float32) -> StreamState:
        p = max(self.num_partitions, 1)
        return StreamState(
            win=jnp.zeros(batch_shape + (self.fft_size,), dtype),
            out_buf=jnp.zeros(batch_shape + (self.hop,), dtype),
            phase=jnp.zeros((), jnp.int32),
            ring=Split.zeros(batch_shape + (p, self.hop), dtype),
            pos=jnp.zeros((), jnp.int32),
        )

    # -- pure functions -------------------------------------------------------

    @staticmethod
    def _emit(spectra: Split, ring: Split, pos: jax.Array,
              backend: Optional[str] = None) -> jax.Array:
        """Output store for the hop period starting now: MAC across partitions
        with :meth:`step`'s slot mapping (slot ``pos - 1`` = newest spectrum),
        riFFT, keep the overlap-save half, 1/(4N) scale."""
        p = spectra.shape[-2]
        h = spectra.shape[-1]
        n = 2 * h
        lags = (pos - 1 - jnp.arange(p, dtype=jnp.int32)) % p
        h_re = jnp.take(spectra.re, lags, axis=-2)
        h_im = jnp.take(spectra.im, lags, axis=-2)
        prod = packed_mul(ring, Split(h_re, h_im))
        acc = Split(jnp.sum(prod.re, axis=-2), jnp.sum(prod.im, axis=-2))
        y = fft_api.rifft(acc.re, acc.im, backend=backend) * (1.0 / (4.0 * n))
        return y[..., h:]

    @staticmethod
    def _fire(spectra: Split, ring: Split, pos: jax.Array, frame: jax.Array,
              backend: Optional[str] = None):
        """Hop-boundary work (reference PartitionedConvolve.cpp:352-377):
        rFFT the completed [prev|cur] frame into the ring, then compute the
        next hop period's output store."""
        p = spectra.shape[-2]
        xre, xim = fft_api.rfft(frame, backend=backend)
        ring = Split(
            jax.lax.dynamic_update_index_in_dim(ring.re, xre, pos, -2),
            jax.lax.dynamic_update_index_in_dim(ring.im, xim, pos, -2))
        pos = (pos + 1) % p
        out = PartitionedConvolve._emit(spectra, ring, pos, backend)
        return ring, pos, out

    @staticmethod
    def stream_from_aligned(spectra: Split, state: PartitionedState,
                            backend: Optional[str] = None) -> StreamState:
        """Lift a hop-aligned state into the sample-granular form (phase 0).

        The output store is precomputed from the current ring — exactly what
        the next :meth:`step` would emit — so streaming continues bit-
        identically from the hop boundary. The ring is slot-normalised to
        pos == 0 (oldest-first), an equivalent state under the generic slot
        mapping."""
        win = jnp.concatenate([jnp.zeros_like(state.prev), state.prev], axis=-1)
        out_buf = PartitionedConvolve._emit(spectra, state.ring, state.pos,
                                            backend)
        ring = PartitionedConvolve._slot_normalise(state.ring, state.pos)
        return StreamState(win, out_buf, jnp.zeros((), jnp.int32),
                           ring, jnp.zeros((), jnp.int32))

    @staticmethod
    def _slot_normalise(ring: Split, pos: jax.Array) -> Split:
        """Reorder ring slots oldest-first (the pos == 0 layout): slot
        (pos + k) mod P holds the spectrum of age P - k (see step())."""
        p = ring.shape[-2]
        order = (pos + jnp.arange(p, dtype=jnp.int32)) % p
        return Split(jnp.take(ring.re, order, axis=-2),
                     jnp.take(ring.im, order, axis=-2))

    @staticmethod
    def stream_to_aligned(state: StreamState) -> PartitionedState:
        """Project back to the hop-aligned form. Only valid on a hop boundary
        (``phase == 0``) — between boundaries there is no aligned equivalent."""
        h = state.out_buf.shape[-1]
        return PartitionedState(prev=state.win[..., h:], ring=state.ring,
                                pos=state.pos)

    @staticmethod
    def step_any(spectra: Split, state: StreamState, x: jax.Array,
                 backend: Optional[str] = None
                 ) -> Tuple[StreamState, jax.Array]:
        """Process ANY block length — the reference's main loop semantics
        (PartitionedConvolve.cpp:243-385): stage input, dole out the output
        store, fire FFT/MAC/iFFT only when a hop boundary is crossed.

        ``x``: (..., L) with any L >= 1 (static per jit specialisation; the
        boundary phase is dynamic). With phase p, the number of boundary
        crossings is k = (p + L) // H — either L // H or L // H + 1 — so the
        block runs ``L // H`` unconditional firings plus at most one
        ``lax.cond`` firing; between boundaries no transform work happens,
        matching the reference's ``tillNextFFT`` scheduling."""
        h = spectra.shape[-1]
        n = 2 * h
        L = x.shape[-1]
        kfloor = L // h
        rem = L % h
        phase = state.phase
        k = (phase + L) // h                       # dynamic crossing count
        buf = jnp.concatenate([state.win, x], axis=-1)      # (..., N + L)
        ring, pos = state.ring, state.pos

        ys = []
        for j in range(kfloor + (1 if rem else 0)):
            start = h - phase + j * h
            frame = jax.lax.dynamic_slice_in_dim(buf, start, n, axis=-1)
            if j < kfloor:
                ring, pos, y = PartitionedConvolve._fire(
                    spectra, ring, pos, frame, backend)
            else:
                # The trailing partial hop may or may not complete this block.
                ring, pos, y = jax.lax.cond(
                    j < k,
                    lambda r, q, f: PartitionedConvolve._fire(
                        spectra, r, q, f, backend),
                    lambda r, q, f: (r, q, jnp.zeros_like(f[..., :h])),
                    ring, pos, frame)
            ys.append(y)

        outcat = jnp.concatenate([state.out_buf] + ys, axis=-1)
        out = jax.lax.dynamic_slice_in_dim(outcat, phase, L, axis=-1)
        new_out = jax.lax.dynamic_slice_in_dim(outcat, k * h, h, axis=-1)
        new_state = StreamState(
            win=buf[..., -n:],
            out_buf=new_out,
            phase=phase + L - k * h,
            ring=ring,
            pos=pos,
        )
        return new_state, out

    @staticmethod
    def step(spectra: Split, state: PartitionedState, block: jax.Array,
             backend: Optional[str] = None) -> Tuple[PartitionedState, jax.Array]:
        """One hop: emit from the current ring (spectra X_{t-1}..X_{t-P}), then
        insert X_t. ``block`` is exactly H samples."""
        h = block.shape[-1]
        p = spectra.shape[-2]

        # MAC across partitions + riFFT + 1/(4N) + overlap-save half: _emit
        # owns the slot mapping (before insertion, slot s holds
        # X_{t-1-((pos-1-s) mod P)} because the write position is pos = t mod P).
        out = PartitionedConvolve._emit(spectra, state.ring, state.pos, backend)

        # Insert X_t at slot pos = t mod P.
        xre, xim = fft_api.rfft(jnp.concatenate([state.prev, block], axis=-1),
                                backend=backend)
        re = jax.lax.dynamic_update_index_in_dim(state.ring.re, xre, state.pos, -2)
        im = jax.lax.dynamic_update_index_in_dim(state.ring.im, xim, state.pos, -2)
        new_state = PartitionedState(
            prev=block,
            ring=Split(re, im),
            pos=(state.pos + 1) % p,
        )
        return new_state, out

    @staticmethod
    def process(spectra: Split, state: PartitionedState, x: jax.Array,
                backend: Optional[str] = None) -> Tuple[PartitionedState, jax.Array]:
        """Stream a signal whose length is a multiple of the hop.

        Semantically identical to scanning :meth:`step` hop by hop, but all
        hops advance in one batched pass (:meth:`process_block`) — a
        sequential per-hop scan is dispatch-latency bound (a small section
        runs dozens of sub-hops per outer block)."""
        return PartitionedConvolve.process_block(spectra, state, x,
                                                 backend=backend)

    @staticmethod
    def process_block(spectra: Split, state: PartitionedState, x: jax.Array,
                      backend: Optional[str] = None,
                      lag0: Optional[Split] = None,
                      assume_pos0: bool = False
                      ) -> Tuple[PartitionedState, jax.Array]:
        """Advance the streaming engine by all of ``x``'s hops at once.

        The reference advances one hop per audio callback
        (PartitionedConvolve::process); here the whole block's spectra batch
        through one rFFT, the ring history joins them as the leading rows of
        the lag-MAC window (exactly the zero-pad rows of the offline path,
        but carrying real state), and one riFFT emits every hop. The returned
        state is slot-normalised (pos = 0) — an equivalent state under
        :meth:`step`'s ``(pos - 1 - s) mod P`` slot mapping.

        ``lag0``: optional (..., 1, K) packed spectrum multiplied with the
        CURRENT hop's own spectrum and added to each hop's accumulation —
        the zero-delay partition Y_t += X_t * lag0 that the standard engine
        (one-hop delay, IR offset = hop) has no slot for. mono.process uses
        it to collapse a whole non-uniform scheme into this single engine at
        block granularity (see mono._process_block_collapsed).

        ``assume_pos0``: static promise that ``state.pos == 0`` (states from
        init or a previous process_block — the mono block paths' invariant).
        Skips the slot-normalise ``lax.cond``, whose identity branch still
        costs a full ring copy in XLA."""
        h = spectra.shape[-1]
        n = 2 * h
        p = spectra.shape[-2]
        L = x.shape[-1]
        if L % h:
            raise ValueError(f"signal length {L} not a multiple of hop {h}")
        if L == 0:
            return state, jnp.zeros_like(x)
        t = L // h
        lead = x.shape[:-1]
        blocks = x.reshape(*lead, t, h)

        # Ring history ordered oldest-first: slot (pos + k) mod P holds the
        # spectrum of age P - k (see step()'s slot mapping). The reorder
        # gather only executes when pos != 0 (a state produced by step());
        # init/process_block states are already normalised and the gather is
        # a strided row walk over the whole ring.

        def _normalise(planes):
            s = PartitionedConvolve._slot_normalise(Split(*planes), state.pos)
            return (s.re, s.im)

        if assume_pos0:
            hist_re, hist_im = state.ring.re, state.ring.im
        else:
            hist_re, hist_im = jax.lax.cond(
                state.pos == 0, lambda planes: planes, _normalise,
                (state.ring.re, state.ring.im))

        # Frames [hop_{j-1} | hop_j] with hop_{-1} = carried previous block.
        prev_rows = jnp.concatenate(
            [state.prev[..., None, :], blocks[..., :-1, :]], axis=-2)
        frames = jnp.concatenate([prev_rows, blocks], axis=-1)
        xre, xim = fft_api.rfft(frames, backend=backend)      # (..., T, K)

        # The ring history joins the new spectra as the MAC window's leading
        # rows; the newest P rows are the next state's ring.
        xp_re = jnp.concatenate([hist_re, xre], axis=-2)      # (..., P+T, K)
        xp_im = jnp.concatenate([hist_im, xim], axis=-2)
        h_re = jnp.broadcast_to(spectra.re, lead + spectra.re.shape[-2:])
        h_im = jnp.broadcast_to(spectra.im, lead + spectra.im.shape[-2:])
        acc_re, acc_im = lag_mac(xp_re, xp_im, h_re, h_im, t)
        new_ring = Split(xp_re[..., -p:, :], xp_im[..., -p:, :])

        if lag0 is not None:
            # Zero-delay partition: each hop's own spectrum times lag0
            # (a plain packed product with no window; XLA fuses it into the
            # accumulation).
            prod = packed_mul(Split(xre, xim), lag0)
            acc_re = acc_re + prod.re
            acc_im = acc_im + prod.im

        y = fft_api.rifft(acc_re, acc_im, backend=backend) * (1.0 / (4.0 * n))
        out = y[..., h:]

        # New state: newest P spectra, slot-normalised to pos = 0.
        new_state = PartitionedState(
            prev=blocks[..., -1, :],
            ring=new_ring,
            pos=jnp.zeros((), jnp.int32),
        )
        return new_state, out.reshape(*lead, L)

    @staticmethod
    def process_offline(spectra: Split, x: jax.Array,
                        backend: Optional[str] = None) -> jax.Array:
        """Whole-signal path with no sequential dependency: batched rFFT over all
        hops, P-lag MAC along the hop axis, batched riFFT. Returns the same output
        as streaming from a fresh state (length = len(x), includes the engine's
        one-hop delay)."""
        h = spectra.shape[-1]
        n = 2 * h
        p = spectra.shape[-2]
        L = x.shape[-1]
        if L % h:
            pad = h - (L % h)
            x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
        t = x.shape[-1] // h
        blocks = x.reshape(*x.shape[:-1], t, h)
        prev = jnp.concatenate(
            [jnp.zeros_like(blocks[..., :1, :]), blocks[..., :-1, :]], axis=-2)
        frames = jnp.concatenate([prev, blocks], axis=-1)  # (..., T, N)
        X = Split(*fft_api.rfft(frames, backend=backend))  # (..., T, N/2)

        # Y_t = sum_p X_{t-1-p} Hhat_p : lag-accumulate along the hop axis.
        lags = min(p, t)
        pad_shape = X.re.shape[:-2] + (lags,) + X.re.shape[-1:]
        xp_re = jnp.concatenate([jnp.zeros(pad_shape, X.re.dtype), X.re], axis=-2)
        xp_im = jnp.concatenate([jnp.zeros(pad_shape, X.im.dtype), X.im], axis=-2)
        acc_re, acc_im = lag_mac(
            xp_re, xp_im, spectra.re[..., :lags, :], spectra.im[..., :lags, :],
            t)

        y = fft_api.rifft(acc_re, acc_im, backend=backend) * (1.0 / (4.0 * n))
        out = y[..., h:]  # (..., T, H)
        return out.reshape(*out.shape[:-2], t * h)[..., :L]
