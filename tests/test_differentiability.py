"""Differentiability of the pure engines — a JAX capability with no
reference analogue (the C++ is not differentiable; the functional JAX design
gives exact VJPs through every XLA-path engine for free).

Use cases pinned here: gradient-based IR estimation (learn the spectra that
produce a target response) and input-side gradients (e.g. deconvolution by
optimisation). The Pallas kernels define no VJP — training paths use the
"xla"/"matmul" backends; inference can still run fused kernels.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hisstools_library.core.types import Split
from hisstools_library.models import mono, time_domain as td
from hisstools_library.models.mono import PartitionScheme
from hisstools_library.ops import spectral_processor as sp


SCHEME = PartitionScheme((32, 128), zero_latency=True)


def _fd_check(loss, x, i, eps=1e-2, rtol=0.05):
    g = jax.grad(loss)(x)
    assert bool(np.isfinite(np.asarray(g)).all())
    fd = (loss(x.at[i].add(eps)) - loss(x.at[i].add(-eps))) / (2 * eps)
    assert abs(float(g[i]) - float(fd)) <= rtol * (abs(float(fd)) + 1e-6)
    return g


def test_grad_through_scheme_engine_wrt_input(rng):
    ir = rng.standard_normal(500).astype(np.float32)
    mir = mono.prepare_ir(SCHEME, ir, dtype=jnp.float32, offline_tail=False)
    st = mono.init_state(SCHEME, mir, (), jnp.float32)
    x = jnp.asarray(rng.standard_normal(512), jnp.float32)

    def loss(x):
        _, y = mono.process(mir, st, x)
        return jnp.sum(y * y)

    _fd_check(loss, x, 13)


def test_grad_wrt_ir_spectra_learns_target(rng):
    """Gradient descent on the partition SPECTRA pytree drives the engine's
    output toward a target response — the learnable-FIR use case."""
    ir = (rng.standard_normal(200) * 0.1).astype(np.float32)
    target_ir = (rng.standard_normal(200) * 0.1).astype(np.float32)
    # The TD head ([0, head_taps)) is not part of the learned parameters —
    # share it so the spectra can fully explain the residual.
    target_ir[:SCHEME.head_taps] = ir[:SCHEME.head_taps]
    mir = mono.prepare_ir(SCHEME, ir, dtype=jnp.float32, offline_tail=False)
    mir_t = mono.prepare_ir(SCHEME, target_ir, dtype=jnp.float32,
                            offline_tail=False)
    st = mono.init_state(SCHEME, mir, (), jnp.float32)
    x = jnp.asarray(rng.standard_normal(512), jnp.float32)
    _, y_target = mono.process(mir_t, st, x)

    def loss(spectra):
        m = mono.MonoIR(mir.head_taps, spectra, None, 0)
        _, y = mono.process(m, st, x)
        return jnp.mean((y - y_target) ** 2)

    import optax
    params = mir.spectra
    l0 = float(loss(params))
    opt = optax.adam(0.05)
    ostate = opt.init(params)

    @jax.jit
    def step(p, s):
        g = jax.grad(loss)(p)
        upd, s = opt.update(g, s)
        return optax.apply_updates(p, upd), s

    for _ in range(120):
        params, ostate = step(params, ostate)
    l1 = float(loss(params))
    assert l1 < 0.05 * l0  # optimisation converges toward the 0 floor


def test_grad_through_time_domain_taps(rng):
    x = jnp.asarray(rng.standard_normal(300), jnp.float32)
    taps = jnp.asarray(rng.standard_normal(16), jnp.float32)

    def loss(taps):
        return jnp.sum(td.fir_offline(x, taps) ** 2)

    _fd_check(loss, taps, 3)


def test_grad_through_spectral_processor(rng):
    x = jnp.asarray(rng.standard_normal(256), jnp.float32)
    h = jnp.asarray(rng.standard_normal(64), jnp.float32)

    def loss(x):
        return jnp.sum(sp.convolve(x, h, sp.EdgeMode.Linear) ** 2)

    _fd_check(loss, x, 100)


def test_grad_through_change_phase(rng):
    """Minimum-phase reshaping (cepstral chain) is differentiable end-to-end."""
    x = jnp.asarray(rng.standard_normal(256) *
                    np.exp(-np.arange(256) / 40.0), jnp.float32)

    def loss(x):
        return jnp.sum(sp.change_phase(x, 0.0) ** 2)

    g = jax.grad(loss)(x)
    assert bool(np.isfinite(np.asarray(g)).all())


def test_jit_grad_composes_with_vmap(rng):
    """grad-of-vmapped-engine: per-channel input gradients in one program."""
    ir = rng.standard_normal(300).astype(np.float32)
    mir = mono.prepare_ir(SCHEME, ir, dtype=jnp.float32, offline_tail=False)
    st = mono.init_state(SCHEME, mir, (4,), jnp.float32)
    xs = jnp.asarray(rng.standard_normal((4, 512)), jnp.float32)

    def loss(xs):
        _, ys = mono.process(mir, st, xs)
        return jnp.sum(ys * ys)

    g = jax.jit(jax.grad(loss))(xs)
    assert g.shape == (4, 512)
    assert bool(np.isfinite(np.asarray(g)).all())
