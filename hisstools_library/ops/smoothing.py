"""Variable-width kernel smoothing (e.g. spectrum smoothing).

JAX counterpart of ``kernel_smoother`` (/root/reference/KernelSmoother.hpp).
The smoothing width ramps linearly from ``width_lo`` to ``width_hi`` across the
series (:64-77); outputs sharing a rounded half-width form a group filtered with one
resampled kernel (:143-205). Widths depend only on static host parameters, so the
groups are computed at trace time and each group becomes one static-shape
convolution on device — direct for narrow filters, FFT (via the spectral processor)
for wide ones, using the reference's heuristic ``n > 64 && hw > 16 && hw*64 > n``
(:240-245).

Filter construction (make_filter, :257-287): the kernel is linearly resampled over
the filter width with end handling driven by whether the kernel endpoints are zero
(Ends detection :92-103); each filter normalises to unit sum (gain = 1/sum).

Edge modes ZeroPad/Extend/Wrap/Fold/Mirror pad the series by ``filter_size`` on each
side through the table-fetcher index math (:107-132).
"""

from __future__ import annotations

import enum
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import spectral_processor as sp
from .table_reader import EdgeMode as TableEdge, _edge_indices


class EdgeMode(enum.Enum):
    ZeroPad = 0
    Extend = 1
    Wrap = 2
    Fold = 3
    Mirror = 4


class _Ends(enum.Enum):
    Zero = 0
    NonZero = 1
    SymZero = 2
    SymNonZero = 3  # declared by the reference but never assigned (:30,92-103)


_TABLE_EDGE = {
    EdgeMode.ZeroPad: TableEdge.ZeroPad,
    EdgeMode.Extend: TableEdge.Extend,
    EdgeMode.Wrap: TableEdge.Wrap,
    EdgeMode.Fold: TableEdge.Fold,
    EdgeMode.Mirror: TableEdge.Mirror,
}


def _pad_edges(x: jax.Array, pad: int, mode: EdgeMode) -> jax.Array:
    """Pad ``pad`` samples on each side using the edge behaviour (:107-132)."""
    if pad == 0:
        return x
    L = x.shape[-1]
    idx = np.concatenate([np.arange(-pad, 0), np.arange(L, L + pad)])
    idxj = jnp.asarray(idx)
    mapped, zero_mask = _edge_indices(idxj, L, _TABLE_EDGE[mode])
    vals = jnp.take(x, mapped, axis=-1)
    if zero_mask is not None:
        vals = jnp.where(zero_mask, jnp.zeros_like(vals), vals)
    left, right = vals[..., :pad], vals[..., pad:]
    return jnp.concatenate([left, x, right], axis=-1)


def _resample_kernel(kernel: np.ndarray, width: int, ends: _Ends) -> np.ndarray:
    """make_filter (:257-287): linear-resample the kernel over ``width`` samples."""
    kl = len(kernel)
    if kl == 1:
        return np.full(width, kernel[0])
    width_adjust = -1.0 if ends == _Ends.NonZero else (0.0 if ends == _Ends.SymZero else 1.0)
    scale_width = max(1.0, width + width_adjust)
    norm = (kl - 1) / scale_width
    offset = 1 if ends == _Ends.Zero else 0
    loop = width - 1 if ends == _Ends.NonZero else width
    pos = (np.arange(loop) + offset) * norm
    i0 = np.minimum(pos.astype(np.int64), kl - 2)
    fr = pos - i0
    filt = np.empty(width, np.float64)
    filt[:loop] = kernel[i0] + fr * (kernel[i0 + 1] - kernel[i0])
    if ends == _Ends.NonZero:
        filt[width - 1] = kernel[kl - 1]
    return filt


def _use_fft(n: int, half_width: int) -> bool:
    return n > 64 and half_width > 16 and half_width * 64 > n


@jax.jit
def _apply_bank(padded: jax.Array, idx: jax.Array, bank: jax.Array) -> jax.Array:
    """One filter-bank chunk: gather (.., Lc, W) windows, contract with the
    (Lc, W) bank. HIGHEST: default precision may run the f32 contraction
    on reduced-precision units (TF32 on the GPU keeps ~10 mantissa bits) —
    invisible on CPU where the parity test runs. Jitted with bank/idx as runtime inputs so every
    equal-shaped chunk reuses one executable."""
    windows = jnp.take(padded, idx, axis=-1)              # (..., Lc, W)
    return jnp.einsum("...lw,lw->...l", windows, bank,
                      precision=jax.lax.Precision.HIGHEST)


def _group_conv(seg: jax.Array, filt: np.ndarray, n_out: int, gain: float,
                backend: Optional[str]) -> jax.Array:
    """conv(seg, filt)[w-1 : w-1+n_out] * gain — direct or FFT by size heuristic."""
    w = len(filt)
    hw = (w + 1) // 2
    fd = jnp.asarray(filt, seg.dtype)
    if _use_fft(n_out, hw):
        full = sp.convolve(seg, fd, sp.EdgeMode.Linear, backend=backend)
    else:
        # direct correlation framed as depthwise conv (small filter)
        from ..models.time_domain import fir_offline
        y = fir_offline(seg, fd)  # causal conv: y[n] = sum f[j] seg[n-j]
        full = y  # y[k] = conv(seg, filt)[k]
    return full[..., w - 1: w - 1 + n_out] * seg.dtype.type(gain)


def smooth(x, kernel, width_lo: float, width_hi: float,
           symmetric: bool = False, edges: EdgeMode = EdgeMode.ZeroPad,
           backend: Optional[str] = None) -> jax.Array:
    """Smooth ``x`` with a kernel whose width ramps from width_lo to width_hi.

    ``x``: (..., L) device array; ``kernel``: host array (the smoothing shape, e.g.
    half a Hann window). Matches kernel_smoother::smooth (:55-209).
    """
    x = jnp.asarray(x)
    kernel = np.asarray(kernel, np.float64)
    L = x.shape[-1]
    kl = len(kernel)
    if L == 0 or kl == 0:
        return x

    width_lo = min(float(L), max(1.0, width_lo))
    width_hi = min(float(L), max(1.0, width_hi))
    width_mul = (width_hi - width_lo) / (L - 1) if L > 1 else 0.0

    def half_width(i: int) -> int:
        # C++ std::round (half away from zero), not Python banker's rounding
        return int(math.floor((width_lo + i * width_mul) * 0.5 + 0.5))

    filter_size = int(math.ceil(max(width_lo, width_hi) * 0.5))

    # Ends detection (:92-103)
    ends = _Ends.NonZero
    mx = kernel.max()
    if mx <= 0.0:
        # A kernel with no positive mass smooths everything to (at most)
        # zero and the end-ratio test below would be 0/0 — reject instead of
        # letting nan comparisons pick the classification.
        raise ValueError("smoothing kernel must have a positive maximum")
    t1 = kernel[0] / mx
    t2 = kernel[-1] / mx
    eps = np.finfo(np.float64).eps
    if (symmetric or t1 < eps) and t2 < eps:
        ends = _Ends.SymZero if symmetric else _Ends.Zero

    padded = _pad_edges(x, filter_size, edges)

    def build_filter(hw: int):
        w = 2 * hw - 1
        if symmetric:
            half = _resample_kernel(kernel, hw, ends)
            filt_sum = half.sum() * 2.0 - half[0]
            filt = np.concatenate([half[::-1], half[1:]])
        else:
            filt = _resample_kernel(kernel, w, ends)
            filt_sum = filt.sum()
        gain = 1.0 / filt_sum if filt_sum else 1.0
        return filt, gain

    # Vectorised filter-bank path: widths are static, so the whole variable-
    # width smoother is a host-built (L, W) filter bank applied as a gather
    # + weighted reduction — one traced op instead of one sub-graph per width
    # group (each of which would compile separately). Series whose
    # (lead, L, W) window tensor exceeds the materialisation budget are
    # processed in L-chunks through ONE jitted apply (bank and indices are
    # runtime inputs, so every equal-sized chunk reuses the same executable —
    # no per-group compile cliff; at most one extra compile for a ragged
    # tail). Only genuinely huge filters (W > 4096, where windows cost ~W per
    # output and the FFT group path wins asymptotically) fall through.
    hw_max = max(half_width(0), half_width(L - 1))
    w_max = 2 * hw_max - 1
    lead_n = int(np.prod(x.shape[:-1])) if x.ndim > 1 else 1
    if w_max <= 4096:
        bank = np.zeros((L, w_max), np.float64)
        i = 0
        while i < L:
            hw = half_width(i)
            j = i
            while j < L and half_width(j) == hw:
                j += 1
            filt, gain = build_filter(hw)
            w = 2 * hw - 1
            # y[i] = sum_j filt[j] * padded[fs + i + (hw-1) - j]: reversed
            # placement, centred in the fixed W-wide window.
            row = np.zeros(w_max)
            centre = hw_max - 1
            row[centre - (hw - 1): centre + hw] = (filt[::-1] * gain)
            bank[i:j] = row
            i = j
        base = filter_size - (hw_max - 1)
        chunk = max(1, (1 << 25) // max(1, lead_n * w_max))
        outs = []
        for c0 in range(0, L, chunk):
            c1 = min(L, c0 + chunk)
            idx = np.arange(c0, c1)[:, None] + base + np.arange(w_max)[None, :]
            outs.append(_apply_bank(padded, jnp.asarray(idx),
                                    jnp.asarray(bank[c0:c1], x.dtype)))
        return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=-1)

    out_parts = []
    i = 0
    while i < L:
        hw = half_width(i)
        j = i
        while j < L and half_width(j) == hw:
            j += 1
        n_out = j - i
        w = 2 * hw - 1
        filt, gain = build_filter(hw)

        # data window: padded coords [i - (hw-1) + filter_size, ...)
        start = i - (hw - 1) + filter_size
        seg = jax.lax.slice_in_dim(padded, start, start + n_out + w - 1,
                                   axis=padded.ndim - 1)
        out_parts.append(_group_conv(seg, filt, n_out, gain, backend))
        i = j

    return jnp.concatenate(out_parts, axis=-1)
