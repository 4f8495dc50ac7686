"""Multi-process dry run: jax.distributed over N CPU processes.

The single-process virtual mesh (tests/conftest.py, dryrun_multichip) exercises
the collective *code*; this tool exercises the *multi-process runtime path* a
multi-host deployment uses: ``jax.distributed.initialize`` + a global mesh
whose channel axis spans processes, globally-sharded arrays built per-process
from addressable shards, and the same `scheme_offline_sharded` /
`n_to_one_offline` code with zero changes — proving the framework's sharding
layer is deployment-shape-agnostic (SURVEY.md §5 distributed backend row).

Roles:
- parent (no HT_PROC_ID env): spawns N children of itself and reports;
- child: joins the distributed runtime, runs the sharded pipeline, verifies
  its addressable output shards against a locally computed full reference.

Usage: python tools/multihost_dryrun.py [--procs 2] [--local-devices 4]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COORD = "localhost:47622"


def child(proc_id: int, num_procs: int, local_devices: int) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=COORD,
                               num_processes=num_procs,
                               process_id=proc_id)
    import jax.numpy as jnp
    from hisstools_library.utils.profiling import enable_compile_cache
    enable_compile_cache()
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hisstools_library.models import mono
    from hisstools_library.models.mono import PartitionScheme
    from hisstools_library.parallel import (make_mesh,
                                                scheme_offline_sharded,
                                                n_to_one_offline)
    from hisstools_library.parallel.mesh import BLOCK_AXIS, CHANNEL_AXIS

    n_dev = num_procs * local_devices
    assert len(jax.devices()) == n_dev, (len(jax.devices()), n_dev)

    # Channel axis spans processes (the between-host direction); block axis
    # stays within a process (the within-host direction).
    mesh = make_mesh(channel=num_procs, block=local_devices)

    scheme = PartitionScheme((32, 64), zero_latency=True)
    hop = scheme.sizes[-1] >> 1
    C = 2 * num_procs
    L = hop * local_devices * 2

    rng = np.random.default_rng(0)  # same seed every process
    x = rng.standard_normal((C, L)).astype(np.float32)
    irs = rng.standard_normal((C, 150)).astype(np.float32)
    ir = mono.prepare_ir(scheme, irs, dtype=jnp.float32, offline_tail=False)

    xsh = NamedSharding(mesh, P(CHANNEL_AXIS, BLOCK_AXIS))
    x_g = jax.make_array_from_callback(x.shape, xsh, lambda idx: x[idx])
    # IR pytree is replicated (weights under data parallelism).
    rep = NamedSharding(mesh, P())
    ir_g = jax.tree_util.tree_map(
        lambda a: jax.make_array_from_callback(
            a.shape, rep, lambda idx, _a=a: np.asarray(_a)[idx]), ir)

    fwd = jax.jit(lambda i, xx: scheme_offline_sharded(mesh, scheme, i, xx))
    y = fwd(ir_g, x_g)
    jax.block_until_ready(y)

    # Verify addressable shards against the full local reference.
    y_ref = np.asarray(mono.process_offline(ir, jnp.asarray(x)))
    worst = 0.0
    for shard in y.addressable_shards:
        got = np.asarray(shard.data)
        want = y_ref[shard.index]
        worst = max(worst, float(np.max(np.abs(got - want))))
    scale = float(np.max(np.abs(y_ref))) or 1.0
    rel = worst / scale
    print(f"[proc {proc_id}] scheme_offline_sharded rel err {rel:.2e}",
          flush=True)
    assert rel < 1e-3, rel

    # N-to-mono psum across the process-spanning channel axis.
    f2 = jax.jit(lambda i, xx: n_to_one_offline(mesh, scheme, i, xx))
    y2 = f2(ir_g, x_g)
    jax.block_until_ready(y2)
    y2_ref = y_ref.sum(axis=0)
    w2 = 0.0
    for shard in y2.addressable_shards:
        w2 = max(w2, float(np.max(np.abs(np.asarray(shard.data)
                                         - y2_ref[shard.index]))))
    rel2 = w2 / (float(np.max(np.abs(y2_ref))) or 1.0)
    print(f"[proc {proc_id}] n_to_one_offline (cross-process psum) rel err "
          f"{rel2:.2e}", flush=True)
    assert rel2 < 1e-3, rel2

    # Sample-granular ragged-callback STREAMING across processes
    # (scheme_stream_any_sharded): the serving-at-scale path — each device
    # advances its channel shard's sub-hop state independently; must be
    # bit-identical to the single-process engine across the whole ragged
    # sequence (the multi-process analogue of the single-process-verified
    # serving path).
    from hisstools_library.parallel import scheme_stream_any_sharded
    from hisstools_library.parallel.sharded import _chan_specs

    sstate = mono.init_stream_state(scheme, ir, batch_shape=(C,))

    def to_global(a, spec):
        sh = NamedSharding(mesh, spec)
        host = np.asarray(a)
        return jax.make_array_from_callback(host.shape, sh,
                                            lambda idx, _h=host: _h[idx])

    sstate_g = jax.tree_util.tree_map(to_global, sstate, _chan_specs(sstate))
    sstate_l = sstate  # single-process reference state

    callbacks = [7, hop, 13, 64, 1, 50, hop + 9]
    worst3 = 0.0
    for b in callbacks:
        xb = rng.standard_normal((C, b)).astype(np.float32)  # same seed chain
        xb_g = jax.make_array_from_callback(
            xb.shape, NamedSharding(mesh, P(CHANNEL_AXIS)),
            lambda idx, _x=xb: _x[idx])
        sstate_g, y_g = scheme_stream_any_sharded(mesh, ir_g, sstate_g, xb_g)
        jax.block_until_ready(y_g)
        sstate_l, y_l = mono.process_any(ir, sstate_l, jnp.asarray(xb))
        y_ln = np.asarray(y_l)
        for shard in y_g.addressable_shards:
            d = np.max(np.abs(np.asarray(shard.data) - y_ln[shard.index]))
            worst3 = max(worst3, float(d))
    print(f"[proc {proc_id}] scheme_stream_any_sharded (ragged callbacks, "
          f"cross-process) max abs diff {worst3:.2e}"
          f" {'(bit-identical)' if worst3 == 0.0 else ''}", flush=True)
    assert worst3 == 0.0, worst3

    jax.distributed.shutdown()
    return 0


def parent(num_procs: int, local_devices: int) -> int:
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        f" --xla_force_host_platform_device_count={local_devices}")
    env["JAX_PLATFORMS"] = "cpu"
    env["HT_NUM_PROCS"] = str(num_procs)
    env["HT_LOCAL_DEVICES"] = str(local_devices)
    procs = []
    for pid in range(num_procs):
        e = dict(env)
        e["HT_PROC_ID"] = str(pid)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__)],
                                      env=e))
    rc = 0
    for p in procs:
        rc |= p.wait(timeout=600)
    print("multihost dryrun:", "ok" if rc == 0 else f"FAILED rc={rc}",
          flush=True)
    return rc


def main() -> int:
    if "HT_PROC_ID" in os.environ:
        return child(int(os.environ["HT_PROC_ID"]),
                     int(os.environ["HT_NUM_PROCS"]),
                     int(os.environ["HT_LOCAL_DEVICES"]))
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=4)
    args = ap.parse_args()
    return parent(args.procs, args.local_devices)


if __name__ == "__main__":
    sys.exit(main())
