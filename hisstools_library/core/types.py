"""Core types for the JAX HISSTools framework.

The reference library works throughout in *split-complex* layout
(``FFT_SPLIT_COMPLEX_F/D`` — see /root/reference/HISSTools_FFT/HISSTools_FFT.h:26-34):
separate real/imag planes rather than interleaved complex. The framework keeps that
layout: every public API passes real arrays only, split planes avoid interleave
shuffles in elementwise code, and the packed real-spectrum convention below stays
bit-compatible with the reference.

``Split`` is a small registered pytree holding the two planes. Spectra produced by
:mod:`hisstools_library.fft` use the vDSP-compatible *packed* convention
(reference ``HISSTools_FFT_Core.h:934-988``):

  - a real FFT of size N yields N/2 bins,
  - DC lives in ``re[..., 0]``,
  - the Nyquist value is packed into ``im[..., 0]``,
  - the forward real FFT is scaled x2 relative to the textbook DFT.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Split:
    """Split-complex pair of arrays (same shape / dtype).

    Mirrors ``FFT_SPLIT_COMPLEX_F`` (reference HISSTools_FFT.h:26-34) but as an
    immutable JAX pytree. The last axis is the bin axis by convention.
    """

    re: jax.Array
    im: jax.Array

    def tree_flatten(self):
        return (self.re, self.im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- convenience ---------------------------------------------------------

    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype

    def astype(self, dtype) -> "Split":
        return Split(self.re.astype(dtype), self.im.astype(dtype))

    def __add__(self, other: "Split") -> "Split":
        return Split(self.re + other.re, self.im + other.im)

    def __mul__(self, scale) -> "Split":
        return Split(self.re * scale, self.im * scale)

    def conj(self) -> "Split":
        return Split(self.re, -self.im)

    @staticmethod
    def zeros(shape, dtype=jnp.float32) -> "Split":
        return Split(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def cmul(a: Split, b: Split) -> Split:
    """Complex multiply in split layout (reference SpectralFunctions.hpp:274-281)."""
    return Split(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def cmul_conj(a: Split, b: Split) -> Split:
    """a * conj(b) — the correlation kernel (reference SpectralFunctions.hpp:265-272:
    the correlate functor stores ``re = ac + bd, im = bc - ad`` for z1=(a,b),
    z2=(c,d), i.e. z1 * conj(z2))."""
    return Split(a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im)


def packed_mul(a: Split, b: Split, scale=1.0) -> Split:
    """Multiply two *packed* real spectra (DC in re[0], Nyquist in im[0]).

    DC and Nyquist bins are real-valued and multiply independently; all other bins
    multiply as complex numbers. This reproduces ``ir_convolve_real``
    (reference SpectralFunctions.hpp:63-84,421-424) and the Nyquist special-casing of
    ``PartitionedConvolve::processPartition`` (PartitionedConvolve.cpp:387-426).
    """
    prod = cmul(a, b)
    dc = a.re[..., :1] * b.re[..., :1]
    nyq = a.im[..., :1] * b.im[..., :1]
    re = jnp.concatenate([dc, prod.re[..., 1:]], axis=-1)
    im = jnp.concatenate([nyq, prod.im[..., 1:]], axis=-1)
    if scale != 1.0:
        re, im = re * scale, im * scale
    return Split(re, im)


def packed_mul_conj(a: Split, b: Split, scale=1.0) -> Split:
    """Correlation (a*conj(b)) on packed real spectra with DC/Nyquist special cases.

    Reference: ``ir_correlate_real`` (SpectralFunctions.hpp:433-436) — DC/Nyquist are
    processed through the same functor with zero imaginary parts, which for the
    correlate functor degenerates to a plain product.
    """
    prod = cmul_conj(a, b)
    dc = a.re[..., :1] * b.re[..., :1]
    nyq = a.im[..., :1] * b.im[..., :1]
    re = jnp.concatenate([dc, prod.re[..., 1:]], axis=-1)
    im = jnp.concatenate([nyq, prod.im[..., 1:]], axis=-1)
    if scale != 1.0:
        re, im = re * scale, im * scale
    return Split(re, im)
