"""Non-uniform partitioned convolution schemes — zero/short/medium latency.

JAX counterpart of ``HISSTools::MonoConvolve``
(/root/reference/HIRT_Multichannel_Convolution/MonoConvolve.cpp). The reference
chains an optional time-domain head with up to four partitioned sections of
increasing FFT size; section boundaries follow ``setPartitions`` (:203-258):

- sizes A < B < C < D validated in 2^5..2^20,
- zero-latency: TD head covers ``ir[0 : A/2]``; with latency, offsets start at 0,
- each non-final section covers ``(next - size)/2`` samples starting at the running
  offset; the final section covers the remainder,
- presets (MonoConvolve.cpp:26-31): Zero = TD + 256/1024/4096/16384,
  Short = 256/1024/4096/16384 (latency A/2 = 128), Medium = 1024/4096/16384.

Here the scheme is a static plan (host-side dataclass); processing sums the
sections' outputs, each of which is internally aligned because every section's IR
offset equals (or exceeds by a constant) its own hop — see partitioned.py. The
reference's RT-safe IR hot-swap (``MemorySwap``) has no device-side equivalent in
the functional engine: "swapping" an IR is replacing the spectra pytree between steps
(see utils/memory_swap.py for the host-side runtime counterpart). Reset-offset
staggering (MonoConvolve.cpp:80-99) is a uniprocessor load-balancing device with no
effect on output; here all sections process in parallel so it is intentionally
not reproduced.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.errors import ConvolveError, ConvolveException
from ..core.types import Split
from ..fft import api as fft_api
from . import partitioned as part
from . import time_domain as td


class LatencyMode(enum.Enum):
    Zero = 0
    Short = 1
    Medium = 2


@dataclasses.dataclass(frozen=True)
class SectionPlan:
    """One partitioned section: FFT size + the IR window it owns."""
    fft_size: int
    offset: int
    length: int  # 0 = remainder of the IR


@dataclasses.dataclass(frozen=True)
class PartitionScheme:
    """Static partition plan (reference setPartitions, MonoConvolve.cpp:203-258)."""

    sizes: Tuple[int, ...]
    zero_latency: bool

    def __post_init__(self):
        prev = 0
        for s in self.sizes:
            log2s = s.bit_length() - 1
            if (1 << log2s) != s or not (5 <= log2s <= 20) or s <= prev:
                raise ConvolveException(ConvolveError.FFT_SIZE_OUT_OF_RANGE,
                                        f"invalid FFT size/order {self.sizes}")
            prev = s
        if not self.sizes:
            raise ConvolveException(ConvolveError.FFT_SIZE_OUT_OF_RANGE,
                                    "no valid FFT sizes given")
        if len(self.sizes) > 4:
            # sections() builds plans for at most four sizes (A < B < C < D,
            # reference setPartitions, MonoConvolve.cpp:203-258); extra sizes
            # would silently drop IR coverage, so reject them outright.
            raise ConvolveException(ConvolveError.FFT_SIZE_OUT_OF_RANGE,
                                    f"at most 4 FFT sizes supported, got "
                                    f"{len(self.sizes)}")

    @classmethod
    def from_latency(cls, mode: LatencyMode) -> "PartitionScheme":
        if mode == LatencyMode.Zero:
            return cls((256, 1024, 4096, 16384), True)
        if mode == LatencyMode.Short:
            return cls((256, 1024, 4096, 16384), False)
        return cls((1024, 4096, 16384), False)

    @classmethod
    def for_latency_budget(cls, samples: int) -> "PartitionScheme":
        """Throughput-optimal scheme whose output latency fits the budget.

        The non-uniform presets exist to bound latency below the callback
        size; a caller who tolerates ``samples`` of latency (e.g. one
        streaming large blocks) is better served by fewer, larger sections:
        the small sections repay their existence only in sub-block latency,
        and a single uniform section at N = 2*budget does the least work per
        sample. Budgets below the Medium preset's latency fall back to the
        reference presets (MonoConvolve.cpp:26-31)."""
        if samples < 128:
            return cls.from_latency(LatencyMode.Zero)
        if samples < 512:
            return cls.from_latency(LatencyMode.Short)
        if samples < 1024:
            return cls.from_latency(LatencyMode.Medium)
        n = 1 << min(samples.bit_length(), 17)  # hop = N/2 <= budget
        return cls((n,), zero_latency=False)

    @property
    def latency(self) -> int:
        """Output delay in samples (0 for zero-latency, else A/2)."""
        return 0 if self.zero_latency else self.sizes[0] >> 1

    @property
    def head_taps(self) -> int:
        return self.sizes[0] >> 1 if self.zero_latency else 0

    def sections(self) -> List[SectionPlan]:
        """The per-section IR windows (reference createPart logic)."""
        sizes = self.sizes
        n = len(sizes)
        offset = sizes[0] >> 1 if self.zero_latency else 0
        plans: List[SectionPlan] = []

        def add(size: int, nxt: int):
            nonlocal offset
            cover = (nxt - size) >> 1
            plans.append(SectionPlan(size, offset, cover))
            offset += cover

        if n == 4:
            add(sizes[0], sizes[1])
        if n > 2:
            add(sizes[n - 3], sizes[n - 2])
        if n > 1:
            add(sizes[n - 2], sizes[n - 1])
        plans.append(SectionPlan(sizes[-1], offset, 0))  # resizable final section
        return plans


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MonoState:
    """Streaming state: TD-head tail + one PartitionedState per section."""
    head: jax.Array
    sections: Tuple[part.PartitionedState, ...]

    def tree_flatten(self):
        return (self.head, self.sections), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MonoStreamState:
    """Sample-granular streaming state: TD-head tail + one
    :class:`partitioned.StreamState` per section. Accepts ANY callback block
    size through :func:`process_any` (reference Convolver::process semantics,
    Convolver.cpp:138-154 — the engine, not the caller, owns hop alignment)."""
    head: jax.Array
    sections: Tuple[part.StreamState, ...]

    def tree_flatten(self):
        return (self.head, self.sections), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MonoIR:
    """Device-resident prepared impulse: head taps + per-section spectra.

    ``tail``/``tail_shift`` (optional, built by :func:`prepare_ir`) hold the
    IR's large-section remainder re-partitioned at the offline-optimal uniform
    FFT size: offline processing replaces every section above the direct-FIR
    threshold with this single throughput-tuned engine, realigned by dropping
    ``tail_shift`` leading output samples. Streaming ignores them — the
    latency-bounded sections remain the real-time path.

    ``block0`` (optional) is the zero-delay partition for the block-collapsed
    hop-aligned path: the packed spectrum, at the final section's FFT size, of
    the IR taps every OTHER component (head + non-final sections) covers,
    shifted by the scheme latency. :func:`process` uses it to run the whole
    scheme as ONE uniform engine per block (see _process_block_collapsed);
    sample-granular streaming (:func:`process_any`) never touches it.

    ``far`` (optional) is the far-IR re-partitioned at the throughput-optimal
    multiple of the final hop (hop G*h, FFT size 2*G*h, IR offset
    G*h - latency) for the TWO-TIER block-collapsed path — see
    :func:`_process_block_two_tier`. Like ``block0`` it only serves
    hop-aligned block processing (:func:`init_block_state`)."""
    head_taps: jax.Array
    spectra: Tuple[Split, ...]
    tail: Optional[Split] = None
    tail_shift: int = 0
    block0: Optional[Split] = None
    far: Optional[Split] = None

    def tree_flatten(self):
        return ((self.head_taps, self.spectra, self.tail, self.block0,
                 self.far), (self.tail_shift,))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], children[2], aux[0], children[3],
                   children[4])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MonoBlockState:
    """Two-tier hop-aligned streaming state (see _process_block_two_tier).

    ``near``: ring of the final section's first G-1 partitions (hop h);
    ``far``: ring of the far-IR re-partition (hop G*h, :class:`MonoIR.far`);
    ``hist``/``hpos``: raw input history as a hop ring — (..., S, h) rows,
    next write row ``hpos``, oldest row at ``hpos`` — carrying the last S*h
    input samples so a hand-off to the per-section paths
    (:func:`aligned_state_from_block` / :func:`stream_state_from_block`)
    rebuilds every section state from the exact frames the per-section engine
    would have transformed."""
    near: part.PartitionedState
    far: part.PartitionedState
    hist: jax.Array
    hpos: jax.Array

    def tree_flatten(self):
        return (self.near, self.far, self.hist, self.hpos), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


class MonoConvolve:
    """Non-uniform partitioned convolver for one IR (N x M routing lives in
    multichannel.py). Pure processing functions; configuration is host-side."""

    def __init__(self, max_length: int = 16384,
                 latency: LatencyMode = LatencyMode.Zero,
                 scheme: Optional[PartitionScheme] = None):
        self.scheme = scheme if scheme is not None else PartitionScheme.from_latency(latency)
        self.max_length = max_length
        self.plans = self.scheme.sections()
        self.ir: Optional[MonoIR] = None
        self.length = 0
        self._tail_lazy = False
        self._ir_host = None  # held only until a lazy tail is built

    def resize(self, length: int) -> ConvolveError:
        """Grow the final section's capacity (reference MonoConvolve::resize,
        :101-111). Functionally a no-op here — spectra are rebuilt by set()."""
        self.max_length = max(self.max_length, length)
        return ConvolveError.NONE

    def set(self, ir, dtype=jnp.float32, request_resize: bool = True,
            backend: Optional[str] = None,
            offline_tail: Optional[bool] = None) -> ConvolveError:
        """Prepare the IR: head taps + per-section partition spectra
        (reference MonoConvolve::set, :118-140).

        ``offline_tail``: None (default) = lazy — the throughput-optimal
        offline tail (an extra full-IR transform + ~IR-sized device memory
        that streaming never touches) is built on the first
        :meth:`process_offline` call, so class and functional
        (:func:`prepare_ir`) usage take the same offline path. True builds it
        eagerly; False never builds it (per-section offline processing)."""
        ir = np.asarray(ir)
        err = ConvolveError.NONE
        if ir.shape[-1] > self.max_length:
            if request_resize:
                self.resize(ir.shape[-1])
            else:
                # Reference semantics (MonoConvolve.cpp:117-139): without a
                # resize the IR is still loaded, clamped to the declared
                # capacity, and the error reports the truncation.
                err = ConvolveError.MEM_ALLOC_TOO_SMALL
                ir = ir[..., :self.max_length]
        from ..utils import debug_stages
        self._tail_lazy = offline_tail is None
        # The host IR copy is only needed to build a lazy tail; released on
        # first process_offline so large banks don't pin 2x host memory.
        self._ir_host = ir if self._tail_lazy else None
        self._ir_debug = ir if debug_stages.enabled() else None
        self._dtype = dtype
        self._backend = backend
        self.ir = prepare_ir(self.scheme, ir, self.max_length, dtype, backend,
                             offline_tail=bool(offline_tail))
        self.length = ir.shape[-1]
        return err

    def init_state(self, batch_shape=(), dtype=jnp.float32) -> MonoState:
        if self.ir is None:
            raise ConvolveException(ConvolveError.MEM_UNAVAILABLE, "no IR set")
        return init_state(self.scheme, self.ir, batch_shape, dtype)

    @property
    def block_size(self) -> int:
        """Throughput-path block quantum (the largest section's hop).
        :meth:`process` requires multiples of this; :meth:`process_any`
        accepts any block length."""
        return self.scheme.sizes[-1] >> 1

    def process(self, state: MonoState, x: jax.Array,
                backend: Optional[str] = None) -> Tuple[MonoState, jax.Array]:
        return process(self.ir, state, x, backend=backend)

    def init_stream_state(self, batch_shape=(), dtype=jnp.float32
                          ) -> MonoStreamState:
        if self.ir is None:
            raise ConvolveException(ConvolveError.MEM_UNAVAILABLE, "no IR set")
        return init_stream_state(self.scheme, self.ir, batch_shape, dtype)

    def init_block_state(self, batch_shape=(), dtype=jnp.float32
                         ) -> MonoBlockState:
        """State for the two-tier block path (requires a far-tier IR; blocks
        must be multiples of ``ir.far.shape[-1]`` samples)."""
        if self.ir is None:
            raise ConvolveException(ConvolveError.MEM_UNAVAILABLE, "no IR set")
        return init_block_state(self.scheme, self.ir, batch_shape, dtype)

    def process_any(self, state: MonoStreamState, x: jax.Array,
                    backend: Optional[str] = None
                    ) -> Tuple[MonoStreamState, jax.Array]:
        """Stream a block of ANY length (sample-granular real-time path)."""
        return process_any(self.ir, state, x, backend=backend)

    def process_offline(self, x: jax.Array,
                        backend: Optional[str] = None) -> jax.Array:
        if (self.ir is not None and self.ir.tail is None
                and getattr(self, "_tail_lazy", False)
                and self._ir_host is not None):
            # First offline use: attach ONLY the missing throughput-optimal
            # tail (see set()) — the head taps and per-section spectra are
            # already built and do not depend on the tail, so re-running the
            # full prepare_ir would redo every section rFFT for nothing.
            tail, shift = _make_offline_tail(self.scheme, self._ir_host,
                                             self._dtype, self._backend)
            self.ir = MonoIR(self.ir.head_taps, self.ir.spectra, tail, shift,
                             self.ir.block0, self.ir.far)
            self._ir_host = None  # release the host copy
        if getattr(self, "_ir_debug", None) is not None:
            from ..utils import debug_stages
            debug_stages.maybe_report(self._ir_debug, x, None, backend,
                                      "MonoConvolve.process_offline")
        return process_offline(self.ir, x, backend=backend)


# -- pure functional API ---------------------------------------------------------

def prepare_ir(scheme: PartitionScheme, ir, max_length: int = 0,
               dtype=jnp.float32, backend: Optional[str] = None,
               offline_tail: bool = True) -> MonoIR:
    """Build the device-resident IR pytree for a scheme. ``ir``: (..., L).

    With ``offline_tail`` (default) the remainder of the IR past the direct-FIR
    sections is additionally partitioned at the offline-optimal uniform FFT
    size, so :func:`process_offline` runs it as one throughput-tuned engine
    instead of the latency-bounded large sections.

    ``max_length`` > 0 clamps the IR to that many taps (the reference engine
    never builds more partitions than its declared capacity)."""
    ir = np.asarray(ir)
    if max_length and ir.shape[-1] > max_length:
        ir = ir[..., :max_length]
    head = td.make_taps(ir, 0, scheme.head_taps) if scheme.head_taps else \
        np.zeros(ir.shape[:-1] + (0,), ir.dtype)
    spectra = []
    for plan in scheme.sections():
        spectra.append(part.impulse_spectra(
            ir, plan.fft_size, plan.offset, plan.length, dtype, backend))

    # Offline, head + sections sum to a single convolution with the whole IR
    # delayed by the scheme latency — one throughput-optimal uniform engine
    # replaces the entire stack (the non-uniform sizes and the TD head only
    # exist to bound streaming latency).
    tail, tail_shift = (_make_offline_tail(scheme, ir, dtype, backend)
                        if offline_tail else (None, 0))
    block0 = _block_lag0_spectra(scheme, ir, dtype, backend)
    far = (_far_tier_spectra(scheme, ir, dtype, backend)
           if block0 is not None else None)
    return MonoIR(jnp.asarray(head, dtype), tuple(spectra), tail, tail_shift,
                  block0, far)


def _block_lag0_spectra(scheme: PartitionScheme, ir, dtype,
                        backend) -> Optional[Split]:
    """Zero-delay partition for the block-collapsed hop-aligned path.

    At block granularity B = largest hop, head + non-final sections sum to
    ``conv(x, ir[0 : B - latency])`` delayed by the scheme latency — samples
    the engine can compute from the SAME [prev | current] frame the final
    section transforms each hop. One packed spectrum of those taps (latency-
    shifted, FFT size 2B) therefore replaces every small engine: the final
    section's ring MAC plus this lag-0 term IS the whole scheme (the
    non-uniform sizes exist only to bound latency below a hop —
    MonoConvolve.cpp:26-31; process_any keeps them for that)."""
    b = scheme.sizes[-1] >> 1
    cover = b - scheme.latency
    if cover <= 0:
        return None  # single-section scheme: nothing below the final section
    ir = np.asarray(ir)
    shifted = np.zeros(ir.shape[:-1] + (b,), np.float64)
    take = min(cover, ir.shape[-1])
    shifted[..., scheme.latency:scheme.latency + take] = ir[..., :take]
    return part.impulse_spectra(shifted, 2 * b, 0, 0, dtype, backend)


def _far_hop(scheme: PartitionScheme, ir_len: int) -> int:
    """Far-tier hop for the two-tier block path: the offline-optimal uniform
    hop (offline.choose_fft_size / 2) snapped to a power-of-two multiple
    G >= 2 of the final section's hop, with the far FFT size 2*G*h inside the
    engine range. Returns 0 when no valid multiple exists (tiny schemes where
    even G = 2 overflows 2^20, or IRs short enough that the offline-optimal
    hop is not above the final hop — the single-tier collapse already serves
    those)."""
    from .offline import choose_fft_size
    h = scheme.sizes[-1] >> 1
    g = max(choose_fft_size(ir_len) // (2 * h), 2)
    while g >= 2 and 2 * g * h > (1 << part.MAX_FFT_SIZE_LOG2):
        g >>= 1
    return g * h if g >= 2 else 0


def _far_tier_spectra(scheme: PartitionScheme, ir, dtype,
                      backend) -> Optional[Split]:
    """Far-IR re-partition for the TWO-TIER block-collapsed path.

    The Zero preset's final section MACs the whole far IR at its own hop —
    about 4x the MAC work per sample of the offline engine's hop at a 10 s
    IR (P = 59 partitions at hop 8192 vs 15 at hop 32768). Re-chunking
    the IR beyond G partitions at hop H2 = G*h (a second ring advanced every
    G-th hop) cuts that dominant cost ~G/"P2 ratio"x while preserving the
    scheme's latency semantics: the far engine (FFT size 2*H2, IR offset
    H2 - latency) delays its conv by H2 - offset = latency, exactly like the
    near tier. Non-uniform partitioning IS the reference's own answer to this
    cost structure (MonoConvolve.cpp:26-31) — applied here to the far tail at
    block granularity."""
    ir = np.asarray(ir)
    h2 = _far_hop(scheme, ir.shape[-1])
    if not h2:
        return None
    o2 = h2 - scheme.latency
    if ir.shape[-1] <= o2:
        return None  # far tier would be empty
    return part.impulse_spectra(ir, 2 * h2, o2, 0, dtype, backend)


def _make_offline_tail(scheme: PartitionScheme, ir, dtype, backend):
    """The offline "tail": the WHOLE IR re-partitioned at the throughput-
    optimal uniform FFT size, applied with a ``tail_shift`` realignment (see
    :class:`MonoIR`). Separated from :func:`prepare_ir` so a lazily-built
    tail attaches to an existing MonoIR without redoing the section rFFTs."""
    ir = np.asarray(ir)
    if ir.shape[-1] == 0:
        return None, 0
    from .offline import choose_fft_size
    nprime = choose_fft_size(ir.shape[-1])
    shift = (nprime >> 1) - scheme.latency
    if shift < 0:
        return None, 0
    return part.impulse_spectra(ir, nprime, 0, 0, dtype, backend), shift


def init_state(scheme: PartitionScheme, ir: MonoIR, batch_shape=(),
               dtype=jnp.float32) -> MonoState:
    head_len = max(int(ir.head_taps.shape[-1]) - 1, 1)
    sections = []
    for plan, spec in zip(scheme.sections(), ir.spectra):
        h = plan.fft_size >> 1
        p = spec.shape[-2]
        sections.append(part.PartitionedState(
            prev=jnp.zeros(batch_shape + (h,), dtype),
            ring=Split.zeros(batch_shape + (p, h), dtype),
            pos=jnp.zeros((), jnp.int32),
        ))
    return MonoState(jnp.zeros(batch_shape + (head_len,), dtype), tuple(sections))


def init_stream_state(scheme: PartitionScheme, ir: MonoIR, batch_shape=(),
                      dtype=jnp.float32) -> MonoStreamState:
    """Fresh sample-granular streaming state (any-block-size path)."""
    head_len = max(int(ir.head_taps.shape[-1]) - 1, 1)
    sections = []
    for plan, spec in zip(scheme.sections(), ir.spectra):
        h = plan.fft_size >> 1
        p = spec.shape[-2]
        sections.append(part.StreamState(
            win=jnp.zeros(batch_shape + (plan.fft_size,), dtype),
            out_buf=jnp.zeros(batch_shape + (h,), dtype),
            phase=jnp.zeros((), jnp.int32),
            ring=Split.zeros(batch_shape + (p, h), dtype),
            pos=jnp.zeros((), jnp.int32),
        ))
    return MonoStreamState(jnp.zeros(batch_shape + (head_len,), dtype),
                           tuple(sections))


def init_block_state(scheme: PartitionScheme, ir: MonoIR, batch_shape=(),
                     dtype=jnp.float32) -> MonoBlockState:
    """Fresh state for the TWO-TIER block-collapsed path (requires an IR
    prepared with a far tier — :class:`MonoIR.far`). Blocks fed to
    :func:`process` with this state must be multiples of the far hop
    (``ir.far.shape[-1]`` samples)."""
    if ir.far is None or ir.block0 is None:
        raise ConvolveException(
            ConvolveError.MEM_UNAVAILABLE,
            "IR has no far tier: prepare_ir builds one for multi-section "
            "schemes whose IR extends past the far hop")
    del scheme  # the prepared IR fully determines the state shapes
    h = ir.spectra[-1].shape[-1]
    p = ir.spectra[-1].shape[-2]
    h2 = ir.far.shape[-1]
    p2 = ir.far.shape[-2]
    g = h2 // h
    near = part.PartitionedState(
        prev=jnp.zeros(batch_shape + (h,), dtype),
        ring=Split.zeros(batch_shape + (g - 1, h), dtype),
        pos=jnp.zeros((), jnp.int32))
    far = part.PartitionedState(
        prev=jnp.zeros(batch_shape + (h2,), dtype),
        ring=Split.zeros(batch_shape + (p2, h2), dtype),
        pos=jnp.zeros((), jnp.int32))
    # Hop rows covering BOTH rebuild reach-backs: the final section's state
    # ((P-1)*h + N = (P+1)*h samples) for the per-section hand-off, and the
    # far ring's ((P2+1)*H2 samples) for block_state_from_hist.
    s = max(p + 1, (p2 + 1) * g)
    hist = jnp.zeros(batch_shape + (s, h), dtype)
    return MonoBlockState(near, far, hist, jnp.zeros((), jnp.int32))


def _hist_push(hist: jax.Array, hpos: jax.Array, x: jax.Array
               ) -> Tuple[jax.Array, jax.Array]:
    """Append ``x``'s hop rows to the raw-history ring (oldest at ``hpos``)."""
    s = hist.shape[-2]
    h = hist.shape[-1]
    t = x.shape[-1] // h
    rows = x.reshape(*x.shape[:-1], t, h)
    if t >= s:
        return rows[..., -s:, :].astype(hist.dtype), jnp.zeros((), jnp.int32)
    for j in range(t):
        hist = jax.lax.dynamic_update_index_in_dim(
            hist, rows[..., j, :].astype(hist.dtype), (hpos + j) % s, -2)
    return hist, (hpos + t) % s


def _hist_linear(hist: jax.Array, hpos: jax.Array) -> jax.Array:
    """Unroll the raw-history ring oldest-first into (..., S*h) samples."""
    s = hist.shape[-2]
    order = (hpos + jnp.arange(s, dtype=jnp.int32)) % s
    lin = jnp.take(hist, order, axis=-2)
    return lin.reshape(*lin.shape[:-2], s * hist.shape[-1])


def _process_block_two_tier(ir: MonoIR, state: MonoBlockState, x: jax.Array,
                            backend: Optional[str]
                            ) -> Tuple[MonoBlockState, jax.Array]:
    """TWO-TIER hop-aligned processing: near ring + far ring + zero-delay term.

    The single-tier collapse (:func:`_process_block_collapsed`) MACs the whole
    far IR at the final hop, the dominant cost of a long-IR stream. Splitting
    the coverage

    - ``block0``  : ir[0 : h - latency]          (lag 0 on the hop's own frame),
    - near ring   : ir[h - latency : G*h - latency] — the final section's first
                    G-1 partitions at hop h,
    - far ring    : ir[G*h - latency : ]          — re-chunked at hop G*h,

    keeps the exact output (each term delays its conv by the scheme latency)
    while the dominant MAC runs at the offline engine's FLOPs/sample. The far
    engine is a plain :meth:`partitioned.PartitionedConvolve.process_block`
    at the offline-optimal FFT size. Reference analogue: the non-uniform section
    ladder itself (MonoConvolve.cpp:26-31), extended one rung past the
    preset's largest size at block granularity."""
    h = ir.spectra[-1].shape[-1]
    h2 = ir.far.shape[-1]
    g = h2 // h
    if x.shape[-1] % h2:
        raise ValueError(
            f"two-tier block length {x.shape[-1]} must be a multiple of the "
            f"far hop {h2}")
    near_spec = Split(ir.spectra[-1].re[..., :g - 1, :],
                      ir.spectra[-1].im[..., :g - 1, :])
    # assume_pos0: both tier states are created by init_block_state or a
    # previous process_block — always slot-normalised (pos == 0).
    near, y = part.PartitionedConvolve.process_block(
        near_spec, state.near, x, backend=backend, lag0=ir.block0,
        assume_pos0=True)
    far, y_far = part.PartitionedConvolve.process_block(
        ir.far, state.far, x, backend=backend, assume_pos0=True)
    hist, hpos = _hist_push(state.hist, state.hpos, x)
    return MonoBlockState(near, far, hist, hpos), y + y_far


def aligned_state_from_block(ir: MonoIR, state: MonoBlockState,
                             backend: Optional[str] = None) -> MonoState:
    """Project a two-tier block state onto the per-section :class:`MonoState`.

    Every section's state is a deterministic function of the last
    (P_final+1)*h input samples — exactly what ``state.hist`` carries — so the
    rebuild transforms the same frames the per-section engine would have and
    the hand-off continues as if the per-section path had run throughout."""
    tail = _hist_linear(state.hist, state.hpos)
    head = jnp.zeros(tail.shape[:-1] +
                     (max(int(ir.head_taps.shape[-1]) - 1, 1),), tail.dtype)
    if ir.head_taps.shape[-1]:
        head = tail[..., -head.shape[-1]:]
    sections = tuple(_refresh_aligned_section(spec, tail, backend)
                     for spec in ir.spectra)
    return MonoState(head, sections)


def stream_state_from_block(ir: MonoIR, state: MonoBlockState,
                            backend: Optional[str] = None) -> MonoStreamState:
    """Hand a two-tier block state to the sample-granular path."""
    return stream_state_from_aligned(
        ir, aligned_state_from_block(ir, state, backend), backend)


def block_state_from_hist(ir: MonoIR, hist: jax.Array,
                          backend: Optional[str] = None) -> MonoBlockState:
    """Build a two-tier block state from raw input history.

    ``hist``: the last max(P_final+1, (P2+1)*G)*h raw input samples ending at
    the stream head (callers that cannot supply full history may zero-pad on
    the left — the far ring is then rebuilt as if the stream had started
    inside the window). The near and far rings are rebuilt from ``hist`` via
    the same frame-refresh the per-section hand-off uses, so a per-section
    (or sample-granular) stream can be lifted into the two-tier form at any
    hop boundary given its input history."""
    h = ir.spectra[-1].shape[-1]
    p = ir.spectra[-1].shape[-2]
    p2 = ir.far.shape[-2]
    g = ir.far.shape[-1] // h
    need = max(p + 1, (p2 + 1) * g) * h
    if hist.shape[-1] != need:
        raise ValueError(f"hist must carry {need} samples, got {hist.shape[-1]}")
    near_full = _refresh_aligned_section(
        Split(ir.spectra[-1].re[..., :g - 1, :],
              ir.spectra[-1].im[..., :g - 1, :]), hist, backend)
    far_full = _refresh_aligned_section(ir.far, hist, backend)
    rows = hist.reshape(*hist.shape[:-1], need // h, h)
    return MonoBlockState(near_full, far_full, rows,
                          jnp.zeros((), jnp.int32))


def stream_state_from_aligned(ir: MonoIR, state: MonoState,
                              backend: Optional[str] = None) -> MonoStreamState:
    """Lift a hop-aligned MonoState into the sample-granular form; streaming
    continues bit-identically from the hop boundary."""
    sections = tuple(
        part.PartitionedConvolve.stream_from_aligned(spec, sec, backend)
        for spec, sec in zip(ir.spectra, state.sections))
    return MonoStreamState(state.head, sections)


def process_any(ir: MonoIR, state: MonoStreamState, x: jax.Array,
                backend: Optional[str] = None
                ) -> Tuple[MonoStreamState, jax.Array]:
    """Stream a block of ANY length through the scheme. Pure/jittable (the
    block length is static per jit specialisation; every hop phase is dynamic
    state). Each section fires its FFT only on its own hop boundaries — the
    reference's per-section RW counters (PartitionedConvolve.cpp:243-385)
    threaded through MonoConvolve::process (MonoConvolve.cpp:179-201)."""
    out = jnp.zeros_like(x)
    head_state = state.head
    if ir.head_taps.shape[-1]:
        head_state, y = td.TimeDomainConvolve.process(ir.head_taps, state.head, x)
        out = out + y
    new_sections = []
    for spec, sec_state in zip(ir.spectra, state.sections):
        sec_state, y = part.PartitionedConvolve.step_any(spec, sec_state, x,
                                                         backend=backend)
        new_sections.append(sec_state)
        out = out + y
    return MonoStreamState(head_state, tuple(new_sections)), out


def process(ir: MonoIR, state, x: jax.Array,
            backend: Optional[str] = None) -> Tuple[MonoState, jax.Array]:
    """Stream a block whose length is a multiple of the largest hop. Pure/jittable.

    With a :class:`MonoBlockState` (``init_block_state``, far-tier IRs) the
    scheme runs as the TWO-TIER engine — near ring + far ring + zero-delay
    term (:func:`_process_block_two_tier`; block quantum = the far hop).
    With ``ir.block0`` present (any multi-section scheme) the whole scheme runs
    as ONE uniform engine per block — see :func:`_process_block_collapsed`;
    the per-section path below remains for single-section schemes and blocks
    that are not a multiple of the largest hop."""
    if isinstance(state, MonoBlockState):
        return _process_block_two_tier(ir, state, x, backend)
    if (ir.block0 is not None and x.shape[-1] > 0
            and x.shape[-1] % (ir.spectra[-1].shape[-1]) == 0):
        return _process_block_collapsed(ir, state, x, backend)
    out = jnp.zeros_like(x)
    head_state = state.head
    if ir.head_taps.shape[-1]:
        head_state, y = td.TimeDomainConvolve.process(ir.head_taps, state.head, x)
        out = out + y
    new_sections = []
    for spec, sec_state in zip(ir.spectra, state.sections):
        sec_state, y = part.PartitionedConvolve.process(spec, sec_state, x,
                                                        backend=backend)
        new_sections.append(sec_state)
        out = out + y
    return MonoState(head_state, tuple(new_sections)), out


def _refresh_aligned_section(spec: Split, tail: jax.Array,
                             backend: Optional[str]) -> part.PartitionedState:
    """Rebuild a non-final section's hop-aligned state from the last B input
    samples. Valid because a section's whole state window fits one block:
    its ring holds the newest P frame spectra, reaching back
    (P-1)*h + N = cover + h = next_size/2 <= B samples (the scheme invariant
    that each section's coverage fits the next section's hop). Slot layout is
    oldest-first / pos = 0, newest frame (ending at the stream head) last —
    identical to process_block's normalised ring."""
    h = spec.shape[-1]
    n = 2 * h
    p = spec.shape[-2]
    b = tail.shape[-1]
    frames = jnp.stack(
        [tail[..., b - (p - 1 - k) * h - n: b - (p - 1 - k) * h or None]
         for k in range(p)], axis=-2)
    re, im = fft_api.rfft(frames, backend=backend)
    return part.PartitionedState(prev=tail[..., -h:], ring=Split(re, im),
                                 pos=jnp.zeros((), jnp.int32))


def _process_block_collapsed(ir: MonoIR, state: MonoState, x: jax.Array,
                             backend: Optional[str]
                             ) -> Tuple[MonoState, jax.Array]:
    """Hop-aligned processing of the WHOLE scheme as one uniform engine.

    The final section's ring MAC (lags >= 1) plus the ``block0`` zero-delay
    partition (lag 0 on the same frame spectra) equals the sum of every
    section and the TD head — the multi-section structure is a *latency*
    device (MonoConvolve.cpp:26-31), algebraically redundant once the caller
    hands over full largest-hop blocks (which :func:`process` requires).
    Non-final section states and the head tail are refreshed from the last
    block so a later hand-off to the sample-granular path
    (:func:`stream_state_from_aligned` -> :func:`process_any`) continues
    exactly as if the per-section path had run."""
    b = ir.spectra[-1].shape[-1]  # largest hop = final section's N/2
    new_big, out = part.PartitionedConvolve.process_block(
        ir.spectra[-1], state.sections[-1], x, backend=backend,
        lag0=ir.block0)
    tail = x[..., -b:]
    head_state = state.head
    if ir.head_taps.shape[-1]:
        keep = state.head.shape[-1]
        head_state = tail[..., -keep:]
    new_sections = [
        _refresh_aligned_section(spec, tail, backend)
        for spec in ir.spectra[:-1]]
    new_sections.append(new_big)
    return MonoState(head_state, tuple(new_sections)), out


# Sections at or below this FFT size run as a direct FIR in offline mode: a
# few-thousand-tap depthwise conv replaces tiny-FFT overlap-save with thousands
# of hops. Threshold covers the 256/1024 scheme sections.
_DIRECT_SECTION_MAX_FFT = 1024
_DIRECT_SECTION_MAX_TAPS = 4096


def _direct_eligible(fft_size: int, partitions: int) -> bool:
    """Shared predicate for the offline direct-FIR path (prepare_ir's tail
    boundary and process_offline's dispatch must agree, or a section would be
    silently dropped)."""
    h = fft_size >> 1
    return (fft_size <= _DIRECT_SECTION_MAX_FFT
            and h * (partitions + 1) <= _DIRECT_SECTION_MAX_TAPS)


def section_taps_from_spectra(spec: Split) -> jax.Array:
    """Reconstruct a section's equivalent direct-FIR taps from its partition
    spectra: H zero taps (the section emits window tap m at delay H + m —
    partitioned.py header) followed by the IR window (rifft(rfft(c)) = 2N c).
    Shared by the single-device and sharded direct-FIR paths."""
    h = spec.shape[-1]
    n = 2 * h
    chunks = fft_api.rifft(spec.re, spec.im) * (1.0 / (2.0 * n))  # (..., P, N)
    lead = spec.re.shape[:-2]
    window = chunks[..., :h].reshape(*lead, spec.shape[-2] * h)
    return jnp.concatenate(
        [jnp.zeros(lead + (h,), window.dtype), window], axis=-1)


def _section_offline_direct(spec: Split, x: jax.Array) -> jax.Array:
    """One small section evaluated as a direct FIR instead of overlap-save."""
    return td.fir_offline(x, section_taps_from_spectra(spec)).astype(x.dtype)


def _tail_offline(tail: Split, x: jax.Array, shift: int,
                  backend: Optional[str]) -> jax.Array:
    """Re-partitioned IR remainder: one uniform engine, output realigned by
    dropping ``shift`` leading samples (the engine's hop-minus-offset delay
    in excess of the scheme latency)."""
    L = x.shape[-1]
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, shift)])
    y = part.PartitionedConvolve.process_offline(tail, xp, backend=backend)
    return y[..., shift:shift + L]


def process_offline(ir: MonoIR, x: jax.Array,
                    backend: Optional[str] = None) -> jax.Array:
    """Whole-signal convolution through the scheme with no sequential scan.

    Small sections run as direct FIRs (see _section_offline_direct); the
    large-section remainder runs as the prepared offline tail when present
    (one throughput-optimal uniform engine), else each section uses
    partitioned overlap-save."""
    if ir.tail is not None:
        # The tail covers the whole IR (head included) in one engine.
        return _tail_offline(ir.tail, x, ir.tail_shift, backend)
    out = jnp.zeros_like(x)
    if ir.head_taps.shape[-1]:
        out = out + td.fir_offline(x, ir.head_taps)
    for spec in ir.spectra:
        if _direct_eligible(2 * spec.shape[-1], spec.shape[-2]):
            out = out + _section_offline_direct(spec, x)
        else:
            out = out + part.PartitionedConvolve.process_offline(
                spec, x, backend=backend)
    return out
