"""Lazy-view array statistics (reference /root/reference/Statistics.hpp).

The reference evaluates statistics through composable modifier views (abs, squares,
logs, index weights) over raw pointers; here each statistic is a fused jnp
reduction — XLA performs the same fusion the C++ views express syntactically. All
functions return scalars in the input dtype (float64 under x64) and are jittable.

Note: the reference's ``stat_count`` reads an uninitialised loop index
(Statistics.hpp:108) — implemented correctly here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _asf(x):
    return jnp.asarray(x)


def stat_length(x) -> jax.Array:
    return jnp.asarray(float(_asf(x).shape[-1]))


def stat_min(x):
    x = _asf(x)
    return jnp.min(x, axis=-1) if x.shape[-1] else jnp.asarray(jnp.inf)


def stat_max(x):
    x = _asf(x)
    return jnp.max(x, axis=-1) if x.shape[-1] else jnp.asarray(-jnp.inf)


def stat_min_position(x):
    """Index of the minimum. The reference returns double (Statistics.hpp:79);
    here the exact integer index is returned — an f32 cast would lose exactness
    above 2^24 without x64. Cast at the call site if needed.
    Empty input returns -1 (same integer dtype as the non-empty case)."""
    x = _asf(x)
    if x.shape[-1]:
        return jnp.argmin(x, axis=-1)
    return jnp.full(x.shape[:-1], -1, dtype=jnp.argmin(jnp.zeros(1)).dtype)


def stat_max_position(x):
    """Index of the maximum (exact integer, -1 when empty; see
    :func:`stat_min_position`)."""
    x = _asf(x)
    if x.shape[-1]:
        return jnp.argmax(x, axis=-1)
    return jnp.full(x.shape[:-1], -1, dtype=jnp.argmin(jnp.zeros(1)).dtype)


def _count_dtype(dtype):
    """Widest-available float for exact integer counts: f64 inputs keep f64
    (exact to 2^53); everything else (f32, AND the half-width bf16/f16 whose
    integers round above 2^8) counts in f32 (exact to 2^24)."""
    return dtype if dtype == jnp.float64 else jnp.float32


def stat_count_above(x, threshold):
    x = _asf(x)
    return jnp.sum(x > threshold, axis=-1).astype(_count_dtype(x.dtype))


def stat_count_below(x, threshold):
    x = _asf(x)
    return jnp.sum(x < threshold, axis=-1).astype(_count_dtype(x.dtype))


def stat_ratio_above(x, threshold):
    return stat_count_above(x, threshold) / stat_length(x)


def stat_ratio_below(x, threshold):
    return stat_count_below(x, threshold) / stat_length(x)


def stat_sum(x):
    return jnp.sum(_asf(x), axis=-1)


def stat_sum_abs(x):
    return jnp.sum(jnp.abs(_asf(x)), axis=-1)


def stat_sum_squares(x):
    x = _asf(x)
    return jnp.sum(x * x, axis=-1)


def stat_sum_logs(x):
    return jnp.sum(jnp.log(_asf(x)), axis=-1)


def _indices(x):
    return jnp.arange(x.shape[-1], dtype=x.dtype)


def _log_indices(x):
    i = jnp.arange(x.shape[-1], dtype=x.dtype)
    return jnp.where(i > 0, jnp.log2(jnp.maximum(i, 1)), 0.0)


def stat_weighted_sum(x, weights=None):
    """With no weights, weights are the indices (reference :186-191)."""
    x = _asf(x)
    if weights is None:
        return jnp.sum(_indices(x) * x, axis=-1)
    return jnp.sum(_asf(weights) * x, axis=-1)


def stat_weighted_sum_abs(x, weights=None):
    x = _asf(x)
    w = _indices(x) if weights is None else _asf(weights)
    return jnp.sum(w * jnp.abs(x), axis=-1)


def stat_weighted_sum_squares(x, weights=None):
    x = _asf(x)
    w = _indices(x) if weights is None else _asf(weights)
    return jnp.sum(w * x * x, axis=-1)


def stat_weighted_sum_logs(x, weights=None):
    x = _asf(x)
    w = _indices(x) if weights is None else _asf(weights)
    return jnp.sum(w * jnp.log(x), axis=-1)


def stat_product(x):
    return jnp.prod(_asf(x), axis=-1)


def stat_mean(x):
    return stat_sum(x) / stat_length(x)


def stat_mean_squares(x):
    return stat_sum_squares(x) / stat_length(x)


def stat_geometric_mean(x):
    return jnp.exp(stat_sum_logs(x) / stat_length(x))


def stat_variance(x):
    x = _asf(x)
    m = stat_mean(x)
    d = x - m[..., None] if jnp.ndim(m) else x - m
    return jnp.sum(d * d, axis=-1) / stat_length(x)


def stat_standard_deviation(x):
    return jnp.sqrt(stat_variance(x))


def stat_pdf_percentile(x, centile):
    """First index where the running sum crosses ``centile``% of the total, with
    fractional correction (reference :251-268)."""
    x = _asf(x)
    target = stat_sum(x) * jnp.clip(jnp.asarray(centile, x.dtype), 0.0, 100.0) / 100.0
    cs = jnp.cumsum(x, axis=-1)
    mask = cs >= target
    idx = jnp.argmax(mask, axis=-1)
    found = jnp.any(mask, axis=-1)
    hit = jnp.take_along_axis(cs, idx[..., None], axis=-1)[..., 0] if x.ndim > 1 else cs[idx]
    val = jnp.take_along_axis(x, idx[..., None], axis=-1)[..., 0] if x.ndim > 1 else x[idx]
    frac = idx - (hit - target) / val
    return jnp.where(found, frac, float(x.shape[-1] - 1))


def stat_centroid(x):
    return stat_weighted_sum(x) / stat_sum(x)


def stat_spread(x):
    x = _asf(x)
    c = stat_centroid(x)
    d = _indices(x) - c
    return jnp.sqrt(jnp.sum(d * d * x, axis=-1) / stat_sum(x))


def stat_skewness(x):
    x = _asf(x)
    c = stat_centroid(x)
    denom = stat_spread(x) ** 3 * stat_sum(x)
    d = _indices(x) - c
    num = jnp.sum(d * d * d * x, axis=-1)
    return jnp.where(denom != 0, num / denom, 0.0)


def stat_kurtosis(x):
    x = _asf(x)
    c = stat_centroid(x)
    denom = stat_spread(x) ** 4 * stat_sum(x)
    d2 = (_indices(x) - c) ** 2
    num = jnp.sum(d2 * d2 * x, axis=-1)
    return jnp.where(denom != 0, num / denom, jnp.inf)


def stat_log_centroid(x):
    x = _asf(x)
    return jnp.exp2(jnp.sum(_log_indices(x) * x, axis=-1) / stat_sum(x))


def stat_log_spread(x):
    x = _asf(x)
    c = jnp.log2(stat_log_centroid(x))
    d = _log_indices(x) - c
    return jnp.sqrt(jnp.sum(d * d * x, axis=-1) / stat_sum(x))


def stat_log_skewness(x):
    x = _asf(x)
    c = jnp.log2(stat_log_centroid(x))
    denom = stat_log_spread(x) ** 3 * stat_sum(x)
    d = _log_indices(x) - c
    num = jnp.sum(d * d * d * x, axis=-1)
    return jnp.where(denom != 0, num / denom, 0.0)


def stat_log_kurtosis(x):
    x = _asf(x)
    c = jnp.log2(stat_log_centroid(x))
    denom = stat_log_spread(x) ** 4 * stat_sum(x)
    d2 = (_log_indices(x) - c) ** 2
    num = jnp.sum(d2 * d2 * x, axis=-1)
    return jnp.where(denom != 0, num / denom, jnp.inf)


def stat_flatness(x):
    return stat_geometric_mean(x) / stat_mean(x)


def stat_rms(x):
    return jnp.sqrt(stat_mean_squares(x))


def stat_crest(x):
    return stat_max(x) / stat_rms(x)
