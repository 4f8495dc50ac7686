"""Double-float ("df64") FFT — ~280 dB transforms from float32 arithmetic.

The reference ships true float64 transform overloads
(/root/reference/HISSTools_FFT/HISSTools_FFT.h:87-369, core radix passes
HISSTools_FFT_Core.h:414-448) delivering ~300 dB round trips. This module gets
close to that without x64 by carrying every value as an unevaluated pair of
f32s (hi + lo, "double-float" / Dekker arithmetic) through a Stockham radix-2
FFT:

- element ops use error-free transformations (TwoSum / Dekker TwoProd), giving
  ~2^-48 relative error per op instead of f32's 2^-24;
- twiddles are precomputed in float64 on the host and stored as hi/lo pairs;
- the dataflow is log2(N) map-style stages (slicing + elementwise), fully
  XLA-fusable, no gather/scatter and no data-dependent control flow.

This is a PRECISION mode, not a throughput mode: it runs ~150 flops per point
per stage, all elementwise (compensated accumulation cannot ride a matmul or a
library FFT). Whether it still earns its place beside native float64 on the
GPU is an open question (ROADMAP); the f32 cuFFT path remains the production
path.

Numerical safety: compensation sequences like ``(a + b) - b`` are meaningful
only under exact IEEE f32 semantics. XLA does not reassociate float arithmetic
by default, but a compiler's algebraic simplifier or FMA contraction can fold
related patterns. :func:`selfcheck` computes a catastrophic-cancellation case
whose survival proves the compiled arithmetic kept the compensation; it runs in
the test-suite and in chip_smoke.py on the GPU.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# -----------------------------------------------------------------------------
# Error-free transformations on f32
# -----------------------------------------------------------------------------

_SPLIT_C = np.float32(4097.0)  # 2^12 + 1: Dekker splitting constant for f32


def _two_sum(a, b):
    """s + e == a + b exactly (Knuth TwoSum, no magnitude assumption)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _quick_two_sum(a, b):
    """s + e == a + b exactly, assuming |a| >= |b| (Dekker FastTwoSum)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _two_prod(a, b):
    """p + e == a * b exactly (Dekker TwoProd via splitting; no FMA needed)."""
    p = a * b
    ca = a * _SPLIT_C
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = b * _SPLIT_C
    bhi = cb - (cb - b)
    blo = b - bhi
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def dd_add(xh, xl, yh, yl):
    """Double-float addition (~2^-47 relative error)."""
    s, e = _two_sum(xh, yh)
    e = e + (xl + yl)
    return _quick_two_sum(s, e)


def dd_sub(xh, xl, yh, yl):
    return dd_add(xh, xl, -yh, -yl)


def dd_mul(xh, xl, yh, yl):
    """Double-float multiplication (~2^-47 relative error)."""
    p, e = _two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return _quick_two_sum(p, e)


def dd_from_f64(a) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side split of a float64 array into an (hi, lo) f32 pair."""
    a = np.asarray(a, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def dd_to_f64(hi, lo) -> np.ndarray:
    """Host-side recombination (fetches from device)."""
    return (np.asarray(jax.device_get(hi), np.float64)
            + np.asarray(jax.device_get(lo), np.float64))


def selfcheck() -> float:
    """Compiled-arithmetic guard: returns the relative error of a df64 dot
    whose terms cancel catastrophically in plain f32. Healthy df64 is ~1e-14;
    if an optimizer folded the compensation it collapses to ~1e-7 (f32).
    Assert ``selfcheck() < 1e-10`` on any new platform/toolchain."""
    @jax.jit
    def f(xh, xl, yh, yl):
        # (pi_hi + pi_lo)^2 accumulated 16 times, minus the closed form —
        # survives only if every TwoSum/TwoProd keeps its error term.
        ph, pl = dd_mul(xh, xl, yh, yl)
        ah = jnp.zeros_like(xh)
        al = jnp.zeros_like(xh)
        for _ in range(16):
            ah, al = dd_add(ah, al, ph, pl)
        return ah, al

    pih, pil = dd_from_f64(np.full((8,), np.pi))
    ah, al = f(jnp.asarray(pih), jnp.asarray(pil),
               jnp.asarray(pih), jnp.asarray(pil))
    got = dd_to_f64(ah, al)
    want = 16.0 * np.pi * np.pi
    return float(np.max(np.abs(got - want) / want))


# -----------------------------------------------------------------------------
# Complex df64 helpers (split layout: 4 planes)
# -----------------------------------------------------------------------------

def _cadd(a, b):
    (arh, arl, aih, ail), (brh, brl, bih, bil) = a, b
    rh, rl = dd_add(arh, arl, brh, brl)
    ih, il = dd_add(aih, ail, bih, bil)
    return rh, rl, ih, il


def _csub(a, b):
    (arh, arl, aih, ail), (brh, brl, bih, bil) = a, b
    rh, rl = dd_sub(arh, arl, brh, brl)
    ih, il = dd_sub(aih, ail, bih, bil)
    return rh, rl, ih, il


def _cmul(a, b):
    """(ar + i ai)(br + i bi) in df64."""
    (arh, arl, aih, ail), (brh, brl, bih, bil) = a, b
    t1h, t1l = dd_mul(arh, arl, brh, brl)
    t2h, t2l = dd_mul(aih, ail, bih, bil)
    rh, rl = dd_sub(t1h, t1l, t2h, t2l)
    t3h, t3l = dd_mul(arh, arl, bih, bil)
    t4h, t4l = dd_mul(aih, ail, brh, brl)
    ih, il = dd_add(t3h, t3l, t4h, t4l)
    return rh, rl, ih, il


@lru_cache(maxsize=64)
def _stage_twiddles(r: int, sign: float):
    """df64 twiddle pairs exp(sign * 2i pi j / r), j = 0..r/2-1 (host f64)."""
    j = np.arange(r // 2, dtype=np.float64)
    ang = sign * 2.0 * np.pi * j / r
    wr_h, wr_l = dd_from_f64(np.cos(ang))
    wi_h, wi_l = dd_from_f64(np.sin(ang))
    return wr_h, wr_l, wi_h, wi_l


def _fft_core(z, n: int, sign: float):
    """Stockham-style radix-2 DIF on df64 planes of shape (..., l, r)."""
    log2n = n.bit_length() - 1
    z = tuple(p.reshape(*p.shape[:-1], 1, n) for p in z)
    for _ in range(log2n):
        r = z[0].shape[-1]
        a = tuple(p[..., : r // 2] for p in z)          # (..., l, r/2)
        b = tuple(p[..., r // 2:] for p in z)
        y0 = _cadd(a, b)
        d = _csub(a, b)
        wt = _stage_twiddles(r, sign)
        w = tuple(jnp.asarray(p) for p in wt)           # (r/2,) broadcasts
        y1 = _cmul(d, w)
        # DIF Stockham: output block k of the new l axis pairs (y0_k, y1_k).
        z = tuple(
            jnp.stack([p0, p1], axis=-2).reshape(
                *p0.shape[:-2], 2 * p0.shape[-2], r // 2)
            for p0, p1 in zip(y0, y1))
    return tuple(p.reshape(*p.shape[:-2], n) for p in z)


def _bitrev_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def fft_df64(re_hi, re_lo, im_hi, im_lo, inverse: bool = False):
    """Unscaled complex DFT (or unscaled inverse = N x IDFT, matching
    fft.api.ifft's convention) in double-float. Inputs/outputs are four f32
    planes (re_hi, re_lo, im_hi, im_lo), batched over leading axes."""
    n = re_hi.shape[-1]
    if n & (n - 1) or n < 2:
        raise ValueError(f"size must be a power of two >= 2, got {n}")
    sign = 1.0 if inverse else -1.0
    z = (jnp.asarray(re_hi, jnp.float32), jnp.asarray(re_lo, jnp.float32),
         jnp.asarray(im_hi, jnp.float32), jnp.asarray(im_lo, jnp.float32))
    out = _fft_core(z, n, sign)
    # DIF Stockham as implemented leaves bit-reversed order; undo with one
    # static gather (host-precomputed permutation).
    perm = jnp.asarray(_bitrev_perm(n))
    return tuple(jnp.take(p, perm, axis=-1) for p in out)


def rfft_df64(x):
    """Packed real FFT in df64: N real samples -> N/2 packed bins with the
    library convention (x2 scale, DC in re[0], Nyquist in im[0] —
    HISSTools_FFT_Core.h:934-988). ``x`` may be f32 (exact) or f64 (split
    host-side if concrete). Returns (re_hi, re_lo, im_hi, im_lo)."""
    if isinstance(x, np.ndarray) and x.dtype == np.float64:
        xh, xl = dd_from_f64(x)
    else:
        xh = jnp.asarray(x, jnp.float32)
        xl = jnp.zeros_like(xh)
    n = xh.shape[-1]
    z = jnp.zeros_like(xh)
    fr_h, fr_l, fi_h, fi_l = fft_df64(xh, xl, z, z, inverse=False)
    # Packed layout: bins 0..N/2-1, x2 scale, Nyquist (bin N/2, purely real)
    # packed into im[0].
    h = n // 2

    def pack(p_h, p_l, is_im: bool):
        hi2, lo2 = dd_add(p_h, p_l, p_h, p_l)  # x2, exact in df64
        if is_im:
            nyq_h, nyq_l = dd_add(fr_h[..., h:h + 1], fr_l[..., h:h + 1],
                                  fr_h[..., h:h + 1], fr_l[..., h:h + 1])
            return (jnp.concatenate([nyq_h, hi2[..., 1:h]], axis=-1),
                    jnp.concatenate([nyq_l, lo2[..., 1:h]], axis=-1))
        return hi2[..., :h], lo2[..., :h]

    re_hi, re_lo = pack(fr_h, fr_l, False)
    im_hi, im_lo = pack(fi_h, fi_l, True)
    return re_hi, re_lo, im_hi, im_lo


def rifft_df64(re_hi, re_lo, im_hi, im_lo):
    """Unscaled packed inverse in df64: rifft(rfft(x)) == 2N x (the library
    identity, fft/api.py). Returns (y_hi, y_lo) time-domain planes."""
    h = re_hi.shape[-1]
    n = 2 * h
    # Unpack to the full Hermitian spectrum (undo nothing — the x2 packing
    # rides through; the identity needs N * IDFT(packed/2 unpacked) * 2 =
    # N * IDFT on the packed values, exactly as fft.api.rifft).
    dc = (re_hi[..., :1], re_lo[..., :1])
    nyq = (im_hi[..., :1], im_lo[..., :1])
    z = jnp.zeros_like(dc[0])

    full_rh = jnp.concatenate(
        [dc[0], re_hi[..., 1:], nyq[0],
         jnp.flip(re_hi[..., 1:], axis=-1)], axis=-1)
    full_rl = jnp.concatenate(
        [dc[1], re_lo[..., 1:], nyq[1],
         jnp.flip(re_lo[..., 1:], axis=-1)], axis=-1)
    full_ih = jnp.concatenate(
        [z, im_hi[..., 1:], z, -jnp.flip(im_hi[..., 1:], axis=-1)], axis=-1)
    full_il = jnp.concatenate(
        [z, im_lo[..., 1:], z, -jnp.flip(im_lo[..., 1:], axis=-1)], axis=-1)

    # Unscaled inverse via N*IDFT(z) = conj(FFT(conj(z))): the Hermitian
    # input carries the packed x2, so the real output is exactly 2N x (the
    # library identity) — no extra scale. The imaginary residue is df64
    # rounding (~1e-14) on a mathematically real signal; drop it.
    cr_h, cr_l, _ci_h, _ci_l = fft_df64(full_rh, full_rl,
                                        -full_ih, -full_il, inverse=False)
    return cr_h, cr_l
