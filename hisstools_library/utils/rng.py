"""Random number generation.

Counterpart of /root/reference/RandomGenerator.hpp. Two engines:

- :class:`CMWC` — the reference's complementary-multiply-with-carry generator
  (Marsaglia 2003; lag 32, a = 987655670, period ~2^1054), reimplemented host-side
  in numpy uint64 arithmetic. Deterministic parity with the C++ engine given the
  same seed vector. Used for host-side decisions (the reference uses it for reset
  offsets and test noise).
- On-device randomness should use ``jax.random`` (counter-based, reproducible under
  jit/vmap/shard_map); :func:`device_uniform`/:func:`device_gaussian` are thin
  conveniences documenting that mapping.

The wrapper :class:`RandomGenerator` mirrors the reference API: uniform ints
(rejection-sampled range), doubles, Box-Muller polar gaussians and windowed
gaussians via the inverse normal CDF (Acklam's minimax approximation, as in the
reference ltqnorm :247-335).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

_MASK32 = 0xFFFFFFFF


class CMWC:
    """Complementary multiply-with-carry generator (reference cmwc, :25-86)."""

    LAG = 32
    A = 987655670

    def __init__(self, seed_vector: Optional[np.ndarray] = None):
        self.state = np.zeros(self.LAG, np.uint64)
        self.increment = 0
        self.carry = 0
        if seed_vector is not None:
            self.seed(seed_vector)
        else:
            self.rand_seed()

    def seed(self, init) -> None:
        init = np.asarray(init, np.uint64)
        if len(init) != self.LAG:
            raise ValueError(f"seed vector must have {self.LAG} entries")
        self.increment = self.LAG - 1
        self.carry = 123
        self.state[:] = init & np.uint64(_MASK32)

    def rand_seed(self) -> None:
        import secrets
        self.seed(np.array([secrets.randbits(32) for _ in range(self.LAG)],
                           np.uint64))

    def __call__(self) -> int:
        i = (self.increment + 1) & (self.LAG - 1)
        t = self.A * int(self.state[i]) + self.carry
        c = t >> 32
        x = (t + c) & _MASK32
        if x < c:
            x += 1
            c += 1
        value = (0xFFFFFFFE - x) & _MASK32
        self.state[i] = value
        self.increment = i
        self.carry = c
        return value


class RandomGenerator:
    """Distribution layer over an integer engine (reference random_generator)."""

    def __init__(self, engine: Optional[CMWC] = None,
                 seed_vector: Optional[np.ndarray] = None):
        self.engine = engine if engine is not None else CMWC(seed_vector)

    def seed(self, init) -> None:
        self.engine.seed(init)

    def rand_seed(self) -> None:
        self.engine.rand_seed()

    # -- integers ------------------------------------------------------------------

    def rand_int(self, n: Optional[int] = None) -> int:
        """Full 32-bit value, or uniform in [0, n] by masked rejection (:143-159)."""
        if n is None:
            return self.engine()
        used = n
        used |= used >> 1
        used |= used >> 2
        used |= used >> 4
        used |= used >> 8
        used |= used >> 16
        while True:
            i = self.engine() & used
            if i <= n:
                return i

    def rand_int_range(self, lo: int, hi: int) -> int:
        return lo + self.rand_int(hi - lo)

    # -- doubles -------------------------------------------------------------------

    def rand_double(self, a: Optional[float] = None,
                    b: Optional[float] = None) -> float:
        """[0,1] / [0,n] / [lo,hi] — 32-bit resolution like the reference (:166-169)."""
        v = self.engine() * 2.32830643653869628906e-10
        if a is None:
            return v
        if b is None:
            return v * a
        return a + v * (b - a)

    # -- gaussians -----------------------------------------------------------------

    def _polar_pair(self) -> Tuple[float, float, float]:
        x = y = r = 0.0
        while r >= 1.0 or r == 0.0:
            x = self.rand_double(-1.0, 1.0)
            y = self.rand_double(-1.0, 1.0)
            r = x * x + y * y
        return x, y, math.sqrt(-2.0 * math.log(r) / r)

    def rand_gaussian(self, mean: float = 0.0, dev: float = 1.0) -> float:
        x, _, r = self._polar_pair()
        return (r * x) * dev + mean

    def rand_gaussians(self) -> Tuple[float, float]:
        """Two independent N(0,1) values (Box-Muller polar, :183-191)."""
        x, y, r = self._polar_pair()
        return x * r, y * r

    # -- windowed gaussian (inverse-CDF, clipped to [0,1]) ----------------------------

    class WindowedGaussianParams:
        """(reference windowed_gaussian_params, :94-125)"""

        def __init__(self, mean: float, dev: float):
            self.mean = mean
            self.dev = dev
            a = 1.0 / (dev * math.sqrt(2.0))
            b = -mean * a
            lo = math.erf(b)
            hi = math.erf(a + b)
            self.lo = -1.0 if math.isnan(lo) else lo
            self.hi = 1.0 if math.isnan(hi) else hi

    def rand_windowed_gaussian(self, mean: float, dev: float) -> float:
        p = self.WindowedGaussianParams(mean, dev)
        r = ltqnorm(0.5 + 0.5 * self.rand_double(p.lo, p.hi)) * p.dev + p.mean
        return max(0.0, min(1.0, r))


def ltqnorm(p: float) -> float:
    """Inverse standard-normal CDF via Acklam's minimax rational approximation
    (|rel err| < 1.15e-9; the reference uses the same published algorithm,
    RandomGenerator.hpp:247-335)."""
    if p <= 0.0:
        return -math.inf if p == 0.0 else math.nan
    if p >= 1.0:
        return math.inf if p == 1.0 else math.nan

    a = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00)

    low, high = 0.02425, 0.97575
    if p < low:
        q = math.sqrt(-2.0 * math.log(p))
        num = ((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]
        den = (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0
        return num / den
    if p > high:
        q = math.sqrt(-2.0 * math.log(1.0 - p))
        num = ((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]
        den = (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0
        return -num / den
    q = p - 0.5
    r = q * q
    num = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q
    den = ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1.0
    return num / den


# -- on-device randomness ----------------------------------------------------------

def device_uniform(key, shape, dtype=None, lo=0.0, hi=1.0):
    """jax.random uniform — the on-device equivalent of rand_double batches."""
    import jax
    import jax.numpy as jnp
    dtype = dtype or jnp.float32
    return jax.random.uniform(key, shape, dtype, lo, hi)


def device_gaussian(key, shape, dtype=None, mean=0.0, dev=1.0):
    """jax.random normal — the on-device equivalent of rand_gaussian batches."""
    import jax
    import jax.numpy as jnp
    dtype = dtype or jnp.float32
    return jax.random.normal(key, shape, dtype) * dev + mean
