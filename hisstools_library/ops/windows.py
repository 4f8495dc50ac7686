"""Parametric window functions (JAX port surface of WindowFunctions.hpp).

The reference generates windows sample-by-sample with templated scalar math
(/root/reference/WindowFunctions.hpp:122-346) plus a symmetric half-mirror
optimisation (:350-434). Here each window is a vectorised function of an index
array — a single fused XLA elementwise pipeline. The API mirrors the reference:

  ``<name>(N, begin=0, end=None, params=Params(...), dtype=...)``

generates ``window[i] = f(i / N) ** exponent`` for ``i`` in ``[begin, min(end, N+1))``
— note the reference's inclusive upper edge (``end = min(N + 1, end)``,
WindowFunctions.hpp:364), so a "full" window is ``N + 1`` points when
``end > N`` and windows are symmetric about ``N/2``.

Coefficients follow Nuttall (1981) and Heinzel et al. (2002) exactly as in the
reference (WindowFunctions.hpp:239-346).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Params:
    """Window parameters (reference window_functions::params,
    WindowFunctions.hpp:26-46)."""

    a0: float = 0.0
    a1: float = 0.0
    a2: float = 0.0
    a3: float = 0.0
    a4: float = 0.0
    exponent: float = 1.0


def _izero(x2: float) -> float:
    """Zeroth-order modified Bessel I0 evaluated at sqrt(x2) via the reference's
    epsilon-terminated power series (WindowFunctions.hpp:193-207)."""
    term = 1.0
    bessel = 1.0
    i = 1
    while term > np.finfo(np.float64).eps:
        term = term * x2 * (1.0 / (4.0 * (i * i)))
        bessel += term
        i += 1
    return bessel


def _izero_terms(x2_max: float) -> int:
    """Trip count the eps-terminated series needs at its largest argument.

    The reference iterates each element to machine epsilon
    (WindowFunctions.hpp:193-207); the vectorised kernel instead derives the
    count ONCE from the static maximum argument (terms only shrink for smaller
    x2), so any beta is exact — not just beta <= ~24 as the old fixed-60 loop.
    """
    term = 1.0
    i = 1
    while term > np.finfo(np.float64).eps:
        term = term * x2_max * (1.0 / (4.0 * (i * i)))
        i += 1
    return max(i, 60)


def _izero_vec(x2: jax.Array, n_terms: int = 60) -> jax.Array:
    """Vectorised I0 power series; ``n_terms`` from :func:`_izero_terms`."""
    term = jnp.ones_like(x2)
    bessel = jnp.ones_like(x2)
    for i in range(1, n_terms):
        term = term * x2 * (1.0 / (4.0 * float(i * i)))
        bessel = bessel + term
    return bessel


# -- core shapes (x = i / N in [0, 1]) ----------------------------------------

def _cosine_sum(x, coeffs):
    """a0 - a1 cos(2 pi x) + a2 cos(4 pi x) - a3 cos(6 pi x) + a4 cos(8 pi x)."""
    a0, a1, a2, a3, a4 = coeffs
    w = jnp.full_like(x, a0)
    if a1:
        w = w - a1 * jnp.cos(2.0 * jnp.pi * x)
    if a2:
        w = w + a2 * jnp.cos(4.0 * jnp.pi * x)
    if a3:
        w = w - a3 * jnp.cos(6.0 * jnp.pi * x)
    if a4:
        w = w + a4 * jnp.cos(8.0 * jnp.pi * x)
    return w


def _trapezoid_shape(x, a, b):
    if b < a:
        a, b = b, a
    up = x / a if a > 0 else jnp.ones_like(x)
    down = 1.0 - (x - b) / (1.0 - b) if b < 1.0 else jnp.ones_like(x)
    return jnp.where(x < a, up, jnp.where(x > b, down, jnp.ones_like(x)))


def _shape_fn(name: str, p: Params) -> Callable[[jax.Array], jax.Array]:
    """Return f(x) for the window in terms of normalised position x = i/N."""
    if name == "rect":
        return lambda x: jnp.ones_like(x)
    if name == "triangle":
        return lambda x: 1.0 - jnp.abs(x * 2.0 - 1.0)
    if name == "trapezoid":
        # Reference passes a0/a1 through directly (WindowFunctions.hpp:452-455)
        return lambda x: _trapezoid_shape(x, p.a0, p.a1)
    if name == "welch":
        return lambda x: 1.0 - (2.0 * x - 1.0) ** 2
    if name == "parzen":
        def parzen(x):
            u = jnp.abs(x * 2.0 - 1.0)  # |i - N/2| / (N/2)
            v = 1.0 - u
            return jnp.where(u > 0.5, 2.0 * v * v * v, 1.0 - 6.0 * u * u * (1.0 - u))
        return parzen
    if name == "sine":
        return lambda x: jnp.sin(jnp.pi * x)
    if name == "sine_taper":
        # a0 rounded to integer taper index (WindowFunctions.hpp:476-482)
        k = float(np.round(p.a0))
        return lambda x: jnp.sin(k * jnp.pi * x)
    if name == "tukey":
        # tukey = 0.5 - 0.5 cos(trapezoid(x) * pi) with a = a0/2, b = 1 - a0/2
        a = p.a0 * 0.5
        b = 1.0 - p.a0 * 0.5
        return lambda x: 0.5 - 0.5 * jnp.cos(_trapezoid_shape(x, a, b) * jnp.pi)
    if name == "kaiser":
        # izero((1 - x^2) beta^2) / izero(beta^2) with x in [-1, 1]
        beta = p.a0
        norm = 1.0 / _izero(beta * beta)
        n_terms = _izero_terms(beta * beta)
        def kaiser(x):
            u = 2.0 * x - 1.0
            return _izero_vec((1.0 - u * u) * (beta * beta), n_terms) * norm
        return kaiser
    if name == "cosine_2_term":
        return lambda x: _cosine_sum(x, (p.a0, 1.0 - p.a0, 0, 0, 0))
    if name == "cosine_3_term":
        return lambda x: _cosine_sum(x, (p.a0, p.a1, p.a2, 0, 0))
    if name == "cosine_4_term":
        return lambda x: _cosine_sum(x, (p.a0, p.a1, p.a2, p.a3, 0))
    if name == "cosine_5_term":
        return lambda x: _cosine_sum(x, (p.a0, p.a1, p.a2, p.a3, p.a4))

    fixed = _FIXED_COSINE_COEFFS.get(name)
    if fixed is not None:
        return lambda x: _cosine_sum(x, fixed)
    raise ValueError(f"unknown window {name!r}")


# Named cosine-sum windows with their exact reference coefficients
# (WindowFunctions.hpp:239-346).
_FIXED_COSINE_COEFFS: Dict[str, tuple] = {
    "hann": (0.5, 0.5, 0, 0, 0),
    "hamming": (0.54, 0.46, 0, 0, 0),  # approx-equiripple alpha, as in reference
    "blackman": (0.42, 0.5, 0.08, 0, 0),
    "exact_blackman": (7938 / 18608, 9240 / 18608, 1430 / 18608, 0, 0),
    "blackman_harris_62dB": (0.44959, 0.49364, 0.05677, 0, 0),
    "blackman_harris_71dB": (0.42323, 0.49755, 0.07922, 0, 0),
    "blackman_harris_74dB": (0.402217, 0.49703, 0.09892, 0.00188, 0),
    "blackman_harris_92dB": (0.35875, 0.48829, 0.14128, 0.01168, 0),
    "nuttall_1st_64dB": (0.40897, 0.5, 0.09103, 0, 0),
    "nuttall_1st_93dB": (0.355768, 0.487396, 0.144232, 0.012604, 0),
    "nuttall_3rd_47dB": (0.375, 0.5, 0.125, 0, 0),
    "nuttall_3rd_83dB": (0.338946, 0.481973, 0.161054, 0.018027, 0),
    "nuttall_5th_61dB": (0.3125, 0.46875, 0.1875, 0.03125, 0),
    "nuttall_minimal_71dB": (0.4243801, 0.4973406, 0.0782793, 0, 0),
    "nuttall_minimal_98dB": (0.3635819, 0.4891775, 0.1365995, 0.0106411, 0),
    "ni_flat_top": (0.2810639, 0.5208972, 0.1980399, 0, 0),
    "hp_flat_top": (1.0, 1.912510941, 1.079173272, 0.1832630879, 0),
    "stanford_flat_top": (1.0, 1.939, 1.29, 0.388, 0.028),
    "heinzel_flat_top_70dB": (1.0, 1.90796, 1.07349, 0.18199, 0),
    "heinzel_flat_top_90dB": (1.0, 1.942604, 1.340318, 0.440811, 0.043097),
    "heinzel_flat_top_95dB": (1.0, 1.9383379, 1.3045202, 0.4028270, 0.0350665),
}

# All generator names, mirroring the reference's public generator set
# (WindowFunctions.hpp:439-650).
WINDOW_NAMES = [
    "rect", "triangle", "trapezoid", "welch", "parzen", "sine", "sine_taper",
    "tukey", "kaiser", "cosine_2_term", "cosine_3_term", "cosine_4_term",
    "cosine_5_term",
] + list(_FIXED_COSINE_COEFFS.keys())


def _apply_exponent(w: jax.Array, exponent: float) -> jax.Array:
    """Exponent fast paths matching the reference (WindowFunctions.hpp:394-430)."""
    if exponent == 1.0:
        return w
    if exponent == 0.5:
        return jnp.sqrt(w)
    if exponent == 2.0:
        return w * w
    if exponent == 3.0:
        return w * w * w
    if exponent == 4.0:
        w2 = w * w
        return w2 * w2
    if exponent > 0 and exponent == math.floor(exponent) and exponent <= 2**31 - 1:
        return jnp.power(w, int(exponent))
    return jnp.power(w, exponent)


def generate(
    name: str,
    N: int,
    begin: int = 0,
    end: Optional[int] = None,
    params: Params = Params(),
    dtype=jnp.float32,
) -> jax.Array:
    """Generate ``window[i] = f(i/N)**exponent`` for i in [begin, min(end, N+1)).

    Matches the reference's ``generate`` semantics (WindowFunctions.hpp:350-434)
    including the inclusive-upper-edge clamp. ``end=None`` means the full N+1-point
    window.
    """
    if end is None:
        end = N + 1
    end = min(N + 1, end)
    begin = min(begin, end)
    if end <= begin:
        return jnp.zeros((0,), dtype)

    i = jnp.arange(begin, end, dtype=jnp.float64 if dtype == jnp.float64 else jnp.float32)
    x = i / float(N)
    w = _shape_fn(name, params)(x)
    w = _apply_exponent(w, params.exponent)
    return w.astype(dtype)


def indexed_generator(names=None):
    """Dispatch-table generator (reference indexed_generator,
    WindowFunctions.hpp:652-663): returns fn(type_index, N, begin, end, params)."""
    names = list(names) if names is not None else list(WINDOW_NAMES)

    def call(type_index: int, N: int, begin: int = 0, end: Optional[int] = None,
             params: Params = Params(), dtype=jnp.float32):
        return generate(names[type_index], N, begin, end, params, dtype)

    call.names = names
    return call


# Convenience: expose each window as a module-level function, e.g. windows.hann(N).
def _make_named(name):
    def fn(N, begin=0, end=None, params: Params = Params(), dtype=jnp.float32):
        return generate(name, N, begin, end, params, dtype)
    fn.__name__ = name
    fn.__doc__ = f"{name} window; see module docstring for conventions."
    return fn


for _name in WINDOW_NAMES:
    globals()[_name] = _make_named(_name)
