"""Mesh-sharded four-step FFT: transforms larger than one device.

The reference FFT runs on one core and caps at 2^28 (HISSTools_FFT.h:87-98);
a 2^28 split-complex f32 transform is ~2 GB of working set, and longer IRs /
whole-session spectra exceed one chip's HBM. This module distributes the
four-step (Bailey) factorisation over a mesh axis so the transform scales
with the slice:

  view x as A[n1, n2] row-major, n1 sharded in contiguous row blocks
  1. all_to_all        -> each device holds ALL n1 for a slab of n2 columns
  2. local column DFTs -> B[j, k1] via the four-step (matmul_fft.fft_split)
  3. local twiddle     -> W_N^{n2 k1}, factorised as a per-device column
                          phase times a replicated (n2/D, n1) table — no
                          device ever materialises an N-sized table
  4. local partial DFT over its n2 slab (dense matmul) + psum_scatter
     -> D[k1, k2] arrives k2-sharded; the local transpose-flatten IS the
        contiguous global output chunk (X laid out k2-major)

Communication: ONE all_to_all + ONE psum_scatter, each moving N/D complex
elements per device between devices — the textbook distributed-FFT transpose
algorithm, expressed as JAX collectives (shard_map), which XLA hands to NCCL on
GPUs.

In/out: 1-D split-complex (re, im) of length N, sharded in D contiguous
chunks over the mesh axis (the same layout in and out, so pipelines chain
without resharding). Unscaled, matching ``hisstools_fft``/``hisstools_ifft``
semantics (fft/api.py conventions).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..fft import matmul_fft
from .mesh import BLOCK_AXIS

__all__ = ["fft_sharded", "rfft_sharded", "rifft_sharded",
           "convolve_sharded", "sharded_eligible", "real_sharded_eligible"]


def sharded_eligible(n: int, n_devices: int) -> bool:
    """True when the factorisation supports this (size, device-count)."""
    if n & (n - 1) or n_devices & (n_devices - 1):
        return False
    n1, n2 = matmul_fft._split_factors(n)
    return n1 % n_devices == 0 and n2 % n_devices == 0


@lru_cache(maxsize=32)
def _phase_tables(n: int, d: int, dtype_name: str, inverse: bool):
    """Factorised twiddle/DFT tables (float64-sourced, like every other
    table in the FFT stack — reference generates twiddles in f64 too,
    HISSTools_FFT_Core.h:437-444).

    With m = n2 // d and column j_global = dev*m + j:
      W_N^{n2 k1}      = T1[dev, k1] * T2[j, k1]        (step-3 twiddle)
      W_N2^{n2 k2}     = T3[dev, k2] * T4[j, k2]        (step-4 DFT rows)
    Replicated memory is O(N/D); per-device tables are O(n1 + n2).
    """
    n1, n2 = matmul_fft._split_factors(n)
    m = n2 // d
    sign = 1.0 if inverse else -1.0
    k1 = np.arange(n1)
    k2 = np.arange(n2)
    j = np.arange(m)
    dev = np.arange(d)

    def table(rows, cols, denom):
        # Fold the exponent modulo denom in integer arithmetic first:
        # rows*cols reaches 2^53-ULP territory for huge N.
        prod = np.outer(rows.astype(np.int64), cols.astype(np.int64)) % denom
        ang = sign * 2.0 * np.pi * prod / denom
        dt = np.float32 if dtype_name == "float32" else np.float64
        return np.cos(ang).astype(dt), np.sin(ang).astype(dt)

    t1 = table(dev * m, k1, n)      # (d, n1)
    t2 = table(j, k1, n)            # (m, n1)
    t3 = table(dev * m, k2, n2)     # (d, n2)
    t4 = table(j, k2, n2)           # (m, n2)
    return t1, t2, t3, t4


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def fft_sharded(mesh: Mesh, re: jax.Array, im: jax.Array,
                inverse: bool = False, axis_name: str = BLOCK_AXIS
                ) -> Tuple[jax.Array, jax.Array]:
    """Unscaled complex (i)DFT of a 1-D split-complex signal sharded over
    ``mesh``'s ``axis_name``; output has the identical contiguous-chunk
    sharding. ``rifft(rfft(x)) == 2N x`` scaling conventions do not apply
    here — this is the bare transform pair (fft/ifft), like fft/api.fft."""
    n = re.shape[-1]
    d = mesh.shape[axis_name]
    if re.ndim != 1:
        raise ValueError("fft_sharded operates on 1-D signals")
    if d == 1:
        return matmul_fft.fft_split(re, im, inverse=inverse)
    if not sharded_eligible(n, d):
        raise ValueError(f"size {n} not distributable over {d} devices")
    n1, n2 = matmul_fft._split_factors(n)
    m = n2 // d
    t1, t2, t3, t4 = _phase_tables(n, d, re.dtype.name, inverse)

    def local(re_l, im_l, t1_l, t3_l, t2_l, t4_l):
        # re_l: this device's contiguous chunk of x = a (n1/d, n2) row block
        # of A. One all_to_all turns it into all rows for a slab of m columns.
        a0r = re_l.reshape(n1 // d, n2)
        a0i = im_l.reshape(n1 // d, n2)
        ar = jax.lax.all_to_all(a0r, axis_name, split_axis=1, concat_axis=0,
                                tiled=True)            # (n1, m)
        ai = jax.lax.all_to_all(a0i, axis_name, split_axis=1, concat_axis=0,
                                tiled=True)
        # Column DFTs: rows of the transpose, via the single-device path
        # (recursive four-step for n1 > 1024).
        br, bi = matmul_fft.fft_split(ar.T, ai.T, inverse=inverse)  # (m, k1)
        # Twiddle W_N^{n2 k1} = T1[dev] * T2 (factorised).
        twr, twi = _cmul(t1_l[0, 0][None, :], t1_l[0, 1][None, :],
                         t2_l[0], t2_l[1])  # (m, n1)
        cr, ci = _cmul(br, bi, twr, twi)
        # Step 4: partial DFT over this device's n2 slab (dense matmul),
        # summed across devices straight into k2-sharded form.
        fr, fi = _cmul(t3_l[0, 0][None, :], t3_l[0, 1][None, :],
                       t4_l[0], t4_l[1])  # (m, n2)
        dr, di = matmul_fft._cmatmul(cr.T, ci.T, fr, fi)  # (k1, k2) partial
        dr = jax.lax.psum_scatter(dr, axis_name, scatter_dimension=1,
                                  tiled=True)          # (n1, m)
        di = jax.lax.psum_scatter(di, axis_name, scatter_dimension=1,
                                  tiled=True)
        # X[k1 + n1*k2]: k2-major flatten -> this device's chunk is rows
        # [dev*m, (dev+1)*m) of X viewed as (n2, n1).
        return dr.T.reshape(-1), di.T.reshape(-1)

    spec = P(axis_name)
    tspec = P(axis_name, None, None)
    rspec = P()  # replicated O(N/D) tables, passed as ARGUMENTS: closing
    # over them would bake hundreds of MB of constants into the compiled
    # program in exactly the huge-N regime this module exists for.
    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=(spec, spec, tspec, tspec, rspec, rspec),
                       out_specs=(spec, spec))
    # Per-device tables stacked on the mesh axis: (d, 2, n) = (cos, sin).
    t1d = jnp.stack([jnp.asarray(t1[0]), jnp.asarray(t1[1])], axis=1)
    t3d = jnp.stack([jnp.asarray(t3[0]), jnp.asarray(t3[1])], axis=1)
    t2r = jnp.stack([jnp.asarray(t2[0]), jnp.asarray(t2[1])])  # (2, m, n1)
    t4r = jnp.stack([jnp.asarray(t4[0]), jnp.asarray(t4[1])])  # (2, m, n2)
    return fn(re, im, t1d, t3d, t2r, t4r)


# ---------------------------------------------------------------------------
# Packed real transforms (the framework's spectrum currency — fft/api.py
# conventions: N/2 bins, DC in re[0], Nyquist in im[0], forward x2, and
# rifft(rfft(x)) == 2N x) on top of the sharded complex core.
#
# The real<->complex conversion pass needs conj(Z[(M-k) % M]) — a global
# index MIRROR, which under contiguous-chunk sharding is one ppermute pairing
# device d with device D-1-d, plus one single-element ppermute for each
# chunk's wrap-around boundary lane (matmul_fft.rfft_packed is the
# single-chip reference for the math; HISSTools_FFT_Core.h:934-988 the
# reference's).
# ---------------------------------------------------------------------------


def real_sharded_eligible(n: int, n_devices: int) -> bool:
    return n >= 4 * n_devices and sharded_eligible(n // 2, n_devices)


def _mirror(z_l, axis_name, d):
    """Local chunk of mirror[k] = z[(M - k) % M] from z's local chunk.

    Chunk d of the mirror = [z[first of chunk (D-d) % D],
    reversed(chunk D-1-d)[:-1]]."""
    mirror_perm = [(s, d - 1 - s) for s in range(d)]
    first_perm = [(s, (d - s) % d) for s in range(d)]
    recv = jax.lax.ppermute(z_l, axis_name, mirror_perm)
    first = jax.lax.ppermute(z_l[..., :1], axis_name, first_perm)
    return jnp.concatenate([first, jnp.flip(recv, axis=-1)[..., :-1]],
                           axis=-1)


def _half_tw_tables(m: int, d: int, dtype_name: str):
    """W_N^k (N = 2m) factorised as per-device scalar x replicated W_N^j."""
    c = m // d
    dt = np.float32 if dtype_name == "float32" else np.float64
    ang_dev = np.pi * (np.arange(d) * c) / m
    ang_j = np.pi * np.arange(c) / m
    t_dev = np.stack([np.cos(ang_dev), -np.sin(ang_dev)], axis=1).astype(dt)
    t_j = (np.cos(ang_j).astype(dt), (-np.sin(ang_j)).astype(dt))
    return t_dev, t_j


def rfft_sharded(mesh: Mesh, x: jax.Array, axis_name: str = BLOCK_AXIS
                 ) -> Tuple[jax.Array, jax.Array]:
    """Packed real FFT of a 1-D real signal sharded over ``axis_name``:
    returns (re, im) of N/2 bins with the identical contiguous sharding
    (DC in re[0], Nyquist in im[0], x2 forward scale — fft/api.rfft)."""
    n = x.shape[-1]
    d = mesh.shape[axis_name]
    if x.ndim != 1:
        raise ValueError("rfft_sharded operates on 1-D signals")
    if d == 1:
        return matmul_fft.rfft_packed(x)
    if not real_sharded_eligible(n, d):
        raise ValueError(f"size {n} not distributable over {d} devices")
    m = n // 2
    spec = P(axis_name)

    deinter = jax.shard_map(
        lambda xl: (xl[..., 0::2], xl[..., 1::2]), mesh=mesh,
        in_specs=(spec,), out_specs=(spec, spec))
    zr, zi = deinter(x)
    Zr, Zi = fft_sharded(mesh, zr, zi, inverse=False, axis_name=axis_name)

    t_dev, t_j = _half_tw_tables(m, d, x.dtype.name)

    def recombine(Zr_l, Zi_l, tdev_l, tj_l):
        Zr_rev = _mirror(Zr_l, axis_name, d)
        Zi_rev = -_mirror(Zi_l, axis_name, d)
        ze_r = 0.5 * (Zr_l + Zr_rev)
        ze_i = 0.5 * (Zi_l + Zi_rev)
        zo_r = 0.5 * (Zi_l - Zi_rev)
        zo_i = -0.5 * (Zr_l - Zr_rev)
        twr, twi = _cmul(tdev_l[0, 0], tdev_l[0, 1], tj_l[0], tj_l[1])
        pr = 2.0 * (ze_r + (zo_r * twr - zo_i * twi))
        pi = 2.0 * (ze_i + (zo_r * twi + zo_i * twr))
        # DC/Nyquist pack in lane 0 of device 0 (values valid there only).
        lane0 = (jnp.arange(pr.shape[-1]) == 0) & \
            (jax.lax.axis_index(axis_name) == 0)
        pr = jnp.where(lane0, 2.0 * (Zr_l[..., :1] + Zi_l[..., :1]), pr)
        pi = jnp.where(lane0, 2.0 * (Zr_l[..., :1] - Zi_l[..., :1]), pi)
        return pr, pi

    # t_j is O(N/D): pass as a replicated argument, never a baked constant.
    fn = jax.shard_map(recombine, mesh=mesh,
                       in_specs=(spec, spec, P(axis_name, None), P()),
                       out_specs=(spec, spec))
    return fn(Zr, Zi, jnp.asarray(t_dev), jnp.stack(
        [jnp.asarray(t_j[0]), jnp.asarray(t_j[1])]))


def rifft_sharded(mesh: Mesh, re: jax.Array, im: jax.Array,
                  axis_name: str = BLOCK_AXIS) -> jax.Array:
    """Inverse of :func:`rfft_sharded`, unscaled convention:
    ``rifft_sharded(rfft_sharded(x)) == 2 N x`` (fft/api.rifft)."""
    m = re.shape[-1]
    d = mesh.shape[axis_name]
    if re.ndim != 1:
        raise ValueError("rifft_sharded operates on 1-D spectra")
    if d == 1:
        return matmul_fft.rifft_packed(re, im)
    if not real_sharded_eligible(2 * m, d):
        raise ValueError(f"size {2 * m} not distributable over {d} devices")
    spec = P(axis_name)
    t_dev, t_j = _half_tw_tables(m, d, re.dtype.name)

    def build_z(xr_l, xi_l, tdev_l, tj_l):
        idx0 = jax.lax.axis_index(axis_name) == 0
        lane0 = (jnp.arange(xr_l.shape[-1]) == 0) & idx0
        # X'[m] (Nyquist) lives packed in im[0]; the true imag[0] is 0.
        xi0 = jnp.where(lane0, 0.0, xi_l)
        xr_rev = _mirror(xr_l, axis_name, d)
        # mirror[0] should be X'[m] = packed im[0] (device 0's lane 0)
        xr_rev = jnp.where(lane0, xi_l[..., :1], xr_rev)
        xi_rev = -_mirror(xi0, axis_name, d)
        ze_r = 0.5 * (xr_l + xr_rev)
        ze_i = 0.5 * (xi0 + xi_rev)
        do_r = 0.5 * (xr_l - xr_rev)
        do_i = 0.5 * (xi0 - xi_rev)
        twr, twi = _cmul(tdev_l[0, 0], tdev_l[0, 1], tj_l[0], tj_l[1])
        # Zo = conj(W^k) * (X - conj(Xrev))/2
        zo_r = do_r * twr + do_i * twi
        zo_i = -do_r * twi + do_i * twr
        return ze_r - zo_i, ze_i + zo_r

    fn = jax.shard_map(build_z, mesh=mesh,
                       in_specs=(spec, spec, P(axis_name, None), P()),
                       out_specs=(spec, spec))
    Zr, Zi = fn(re, im, jnp.asarray(t_dev), jnp.stack(
        [jnp.asarray(t_j[0]), jnp.asarray(t_j[1])]))
    wr, wi = fft_sharded(mesh, Zr, Zi, inverse=True, axis_name=axis_name)

    inter = jax.shard_map(
        lambda a, b: 2.0 * jnp.stack([a, b], axis=-1).reshape(-1),
        mesh=mesh, in_specs=(spec, spec), out_specs=spec)
    return inter(wr, wi)


def convolve_sharded(mesh: Mesh, x: jax.Array, h: jax.Array,
                     axis_name: str = BLOCK_AXIS) -> jax.Array:
    """Distributed linear convolution of two 1-D real signals.

    The mesh-scale composition of spectral_processor.convolve (reference
    SpectralProcessor.hpp:164-184): pad both to a shared power of two,
    rfft_sharded each, multiply the packed spectra bin-wise (DC/Nyquist lanes
    are real and multiply independently — core/types.packed_mul semantics,
    reference SpectralFunctions.hpp:63-84 — which under contiguous sharding
    only concerns device 0's lane 0), rifft_sharded, 0.25/N scale. Output has
    the full length lx + lh - 1 and stays sharded over ``axis_name``."""
    lx, lh = x.shape[-1], h.shape[-1]
    out_len = lx + lh - 1
    d = mesh.shape[axis_name]
    if d > 1 and (d & (d - 1)):
        # real_sharded_eligible is False for EVERY n on a non-power-of-two
        # axis; without this guard the size search below would never end.
        raise ValueError(f"convolve_sharded needs a power-of-two mesh axis, "
                         f"got {d} devices")
    n = 1
    while n < out_len or (d > 1 and not real_sharded_eligible(n, d)):
        n <<= 1
    spec = P(axis_name)
    sh = jax.NamedSharding(mesh, spec)
    xp = jax.lax.with_sharding_constraint(
        jnp.pad(x, (0, n - lx)), sh)
    hp = jax.lax.with_sharding_constraint(
        jnp.pad(h, (0, n - lh)), sh)
    xr, xi = rfft_sharded(mesh, xp, axis_name)
    hr, hi = rfft_sharded(mesh, hp, axis_name)

    def mul(ar, ai, br, bi):
        pr = ar * br - ai * bi
        pi = ar * bi + ai * br
        lane0 = (jnp.arange(ar.shape[-1]) == 0) & \
            (jax.lax.axis_index(axis_name) == 0)
        pr = jnp.where(lane0, ar * br, pr)   # DC (real x real)
        pi = jnp.where(lane0, ai * bi, pi)   # Nyquist (real x real)
        return pr, pi

    if d == 1:
        from ..core.types import Split, packed_mul
        prod = packed_mul(Split(xr, xi), Split(hr, hi))
        pr, pi = prod.re, prod.im
    else:
        fn = jax.shard_map(mul, mesh=mesh, in_specs=(spec,) * 4,
                           out_specs=(spec, spec))
        pr, pi = fn(xr, xi, hr, hi)
    y = rifft_sharded(mesh, pr, pi, axis_name) * (0.25 / n)
    return y[:out_len]
