#!/usr/bin/env python3
"""Time the partition MAC (models.partitioned.lag_mac) at each chunk size.

The MAC sums P lag products over a (C, T+P, K) spectra window. ``chunk`` lags
are unrolled per step of a ``fori_loop``: a chunk of 1 is the per-lag loop
(one accumulator pass per lag), a chunk >= P is one static sum that XLA can
emit as a single fusion. Shapes are the engines' real ones:

- offline: FastFIR at the flagship workload (128 ch, 10 s IR and signal at
  48 kHz: N = 2^16, T = 16 hops, P = 15, K = 32768 bins);
- far: the two-tier stream's far tier (one 32768-sample block, P = 14);
- collapsed: the Zero preset's final section on one 8192-sample block
  (P = 59, K = 8192).

Prints one JSON line per (shape, chunk): the median of 10 timed calls (each
ended by block_until_ready) and the bytes/s achieved against one pass over
X, H and Y, plus a large device copy's bytes/s for scale. Run on the card:

    python tools/mac_ab.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = {  # name: (channels, T, P, K)
    "offline": (128, 16, 15, 32768),
    "far": (128, 1, 14, 32768),
    "collapsed": (128, 1, 59, 8192),
}
CHUNKS = (1, 2, 4, 8, 16, 32, 64)


def _median_time(fn, args, reps=10):
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main(shapes=SHAPES, chunks=CHUNKS, copy_log2=28) -> int:
    import jax
    import jax.numpy as jnp

    from chip_smoke import card_lines
    from hisstools_library.models.partitioned import lag_mac

    card = "; ".join(card_lines())
    dev = jax.devices()[0]
    print(json.dumps({"card": card, "device": dev.device_kind}), flush=True)

    n = 1 << copy_log2
    a = jnp.ones((n,), jnp.float32)
    t = _median_time(jax.jit(lambda v: v * 1.0001), (a,))
    print(json.dumps({"copy_bytes": 8 * n, "seconds": t,
                      "bytes_per_s": 8 * n / t}), flush=True)
    del a

    for name, (c, t_hops, p, k) in shapes.items():
        keys = jax.random.split(jax.random.PRNGKey(0), 4)
        xr = jax.random.normal(keys[0], (c, t_hops + p, k), jnp.float32)
        xi = jax.random.normal(keys[1], (c, t_hops + p, k), jnp.float32)
        hr = jax.random.normal(keys[2], (c, p, k), jnp.float32)
        hi = jax.random.normal(keys[3], (c, p, k), jnp.float32)
        one_pass = 4 * 2 * c * k * ((t_hops + p) + p + t_hops)
        ref = None
        for chunk in chunks:
            if chunk > p and chunk // 2 >= p:
                continue  # same program as the smallest chunk >= P
            fn = jax.jit(lambda a, b, e, f, ch=chunk: lag_mac(
                a, b, e, f, t_hops, ch))
            t0 = time.perf_counter()
            fn.lower(xr, xi, hr, hi).compile()
            compile_s = time.perf_counter() - t0
            sec = _median_time(fn, (xr, xi, hr, hi))
            out = fn(xr, xi, hr, hi)
            if ref is None:
                ref = out
            diff = float(jnp.max(jnp.abs(out[0] - ref[0])))
            print(json.dumps({
                "shape": name, "C": c, "T": t_hops, "P": p, "K": k,
                "chunk": chunk, "seconds": sec, "compile_s": compile_s,
                "one_pass_bytes": one_pass, "bytes_per_s": one_pass / sec,
                "share_of_3.35TB/s": one_pass / sec / 3.35e12,
                "max_abs_diff_vs_chunk1": diff}), flush=True)
        del xr, xi, hr, hi, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
