"""Durable checkpoint/resume of streaming engine state (utils/checkpoint.py).

The reference cannot persist its mid-stream state (private buffers,
PartitionedConvolve.h:62-81); here states are pytrees, so a stream can stop,
checkpoint to disk, restore in a fresh context, and continue bit-exactly.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from hisstools_library.models import mono
from hisstools_library.models.mono import PartitionScheme
from hisstools_library.utils import checkpoint as ckpt


SCHEME = PartitionScheme((32, 128), zero_latency=True)


def _run(mir, state, x, hop, start, stop):
    outs = []
    for j in range(start, stop):
        state, y = mono.process(mir, state, jnp.asarray(x[:, j * hop:(j + 1) * hop]))
        outs.append(np.asarray(y))
    return state, outs


@pytest.mark.parametrize("backend", ["orbax", "npz"])
def test_stream_checkpoint_resume_bitexact(tmp_path, rng, backend):
    hop = 64
    C, T = 2, 10
    ir = rng.standard_normal((C, 700)).astype(np.float32)
    x = rng.standard_normal((C, T * hop)).astype(np.float32)
    mir = mono.prepare_ir(SCHEME, ir, dtype=jnp.float32, offline_tail=False)

    # Uninterrupted reference stream.
    st = mono.init_state(SCHEME, mir, (C,), jnp.float32)
    _, ref_outs = _run(mir, st, x, hop, 0, T)

    # Stream 4 hops, checkpoint BOTH the state and the prepared IR, restore
    # into freshly-built exemplars, continue.
    st = mono.init_state(SCHEME, mir, (C,), jnp.float32)
    st, outs = _run(mir, st, x, hop, 0, 4)
    path = str(tmp_path / "ck")
    payload = {"state": st, "ir": mir}
    if backend == "orbax":
        ckpt.save(path, payload)
    else:
        path += ".npz"
        ckpt.save_npz(path, payload)

    exemplar = {"state": mono.init_state(SCHEME, mir, (C,), jnp.float32),
                "ir": mono.prepare_ir(SCHEME, np.zeros_like(ir),
                                      dtype=jnp.float32, offline_tail=False)}
    restored = (ckpt.restore(path, exemplar) if backend == "orbax"
                else ckpt.restore_npz(path, exemplar))
    _, outs2 = _run(restored["ir"], restored["state"], x, hop, 4, T)

    got = np.concatenate(outs + outs2, axis=-1)
    ref = np.concatenate(ref_outs, axis=-1)
    np.testing.assert_array_equal(got, ref)  # bit-exact resume


def test_npz_leaf_count_mismatch_raises(tmp_path, rng):
    st = mono.init_state(
        SCHEME, mono.prepare_ir(SCHEME, rng.standard_normal(300),
                                dtype=jnp.float32, offline_tail=False),
        (), jnp.float32)
    p = str(tmp_path / "s.npz")
    ckpt.save_npz(p, st)
    with pytest.raises(ValueError):
        ckpt.restore_npz(p, {"not": "the same tree"})


def test_npz_python_scalar_leaves(tmp_path):
    """npz restore handles Python-scalar leaves (config values in a state
    dict), returning them as the exemplar's Python type."""
    state = {"gain": 0.5, "count": 3, "arr": np.arange(4)}
    p = str(tmp_path / "s.npz")
    ckpt.save_npz(p, state)
    r = ckpt.restore_npz(p, {"gain": 0.0, "count": 0, "arr": np.zeros(4, np.int64)})
    assert r["gain"] == 0.5 and isinstance(r["gain"], float)
    assert r["count"] == 3 and isinstance(r["count"], int)
    np.testing.assert_array_equal(np.asarray(r["arr"]), np.arange(4))
