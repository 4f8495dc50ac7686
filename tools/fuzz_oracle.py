#!/usr/bin/env python
"""Randomized oracle fuzzing: engines vs float64 direct convolution.

Draws random (channel count, signal length, IR length, fft size, scheme,
engine) configurations and checks every output against numpy float64
``np.convolve`` to a hard SNR floor. CPU by default; pass --device to fuzz on
the default device (the GPU).

    python tools/fuzz_oracle.py --minutes 30 --seed 0
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--snr", type=float, default=85.0)
    ap.add_argument("--device", action="store_true",
                    help="fuzz on the default device (the GPU) instead of CPU")
    ap.add_argument("--stages", action="store_true",
                    help="on failure, print a per-stage SNR report "
                         "(utils.debug_stages) to localise the stage that "
                         "lost accuracy")
    args = ap.parse_args(argv)

    import jax
    if not args.device:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from hisstools_library.utils.profiling import enable_compile_cache
    enable_compile_cache()  # randomized shapes recompile every run otherwise

    from hisstools_library.models import mono
    from hisstools_library.models.mono import PartitionScheme
    from hisstools_library.models.offline import FastFIR, fast_fir
    from hisstools_library.models import partitioned as part
    from hisstools_library.core.types import Split

    rng = np.random.default_rng(args.seed)
    deadline = time.time() + args.minutes * 60.0
    n_cases = 0
    failures = []

    def check(tag, ref, test, cfg, raw=None, stream_raw=None):
        nonlocal n_cases
        n_cases += 1
        ref = np.asarray(ref, np.float64)
        err = np.asarray(test, np.float64) - ref
        d = (err * err).sum()
        snr = np.inf if d == 0 else 10 * np.log10((ref * ref).sum() / d)
        status = "ok" if snr > args.snr else "FAIL"
        print(f"[{status}] {tag} SNR {snr:.1f} dB {cfg}", flush=True)
        if snr <= args.snr:
            failures.append((tag, cfg, snr))
            if args.stages and raw is not None:
                from hisstools_library.utils import debug_stages
                ir_raw, x_raw = raw
                rep = debug_stages.stage_report(ir_raw, x_raw)
                print(debug_stages.format_report(rep), flush=True)
            if args.stages and stream_raw is not None:
                # Streaming failure: localise with the streaming stage
                # mirrors (frame_rfft/ring_mac/lag0/rifft_tail/refresh/
                # subhop_fire/subhop_doling).
                from hisstools_library.utils import debug_stages
                ir_raw, x_raw, sch = stream_raw
                B = sch.sizes[-1] >> 1
                pad = max(0, 2 * B - x_raw.shape[-1])
                x2 = np.pad(np.asarray(x_raw, np.float32),
                            [(0, 0)] * (x_raw.ndim - 1) + [(0, pad)])
                rep = debug_stages.stream_stage_report(
                    ir_raw, x2[..., :B], x2[..., B:2 * B], scheme=sch)
                print(debug_stages.format_report(rep), flush=True)

    while time.time() < deadline:
        c = int(rng.integers(1, 5))
        L = int(rng.integers(500, 60000))
        irl = int(rng.integers(16, 30000))
        amp = 10.0 ** rng.uniform(-2, 1)
        x = (rng.standard_normal((c, L)) * amp).astype(np.float32)
        ir = (rng.standard_normal((c, irl)) *
              np.exp(-np.arange(irl) / max(irl / 4, 1)) * 0.3).astype(np.float32)
        ref = np.stack([np.convolve(x[i].astype(np.float64),
                                    ir[i].astype(np.float64))[:L]
                        for i in range(c)])

        pick = rng.integers(0, 6)
        if pick == 0:
            log2n = int(rng.integers(part.MIN_FFT_SIZE_LOG2, 18))
            nfft = 1 << log2n
            cfg = f"fast_fir c={c} L={L} ir={irl} N=2^{log2n}"
            y = fast_fir(jnp.asarray(x), ir, fft_size=nfft)
            check("fast_fir", ref, y, cfg, raw=(ir, x))
        elif pick == 1:
            # random valid ascending scheme
            base = int(rng.integers(5, 9))
            sizes = tuple(1 << (base + 2 * k)
                          for k in range(int(rng.integers(1, 4))))
            zl = bool(rng.integers(0, 2))
            scheme = PartitionScheme(sizes, zero_latency=zl)
            prep = mono.prepare_ir(scheme, ir)
            y = mono.process_offline(prep, jnp.asarray(x))
            lat = scheme.latency
            ref_l = np.concatenate(
                [np.zeros((c, lat)), ref[:, :L - lat]], axis=-1)
            cfg = f"scheme {sizes} zl={zl} c={c} L={L} ir={irl}"
            check("scheme_offline", ref_l, y, cfg, raw=(ir, x))
        elif pick == 3 and not args.device:
            # Sharded offline on a random virtual-mesh factorisation.
            from hisstools_library.parallel import (make_mesh,
                                                        scheme_offline_sharded)
            ndev = len(jax.devices())
            facs = [(a, ndev // a) for a in (1, 2, 4, 8)
                    if ndev % a == 0 and ndev // a >= 1]
            ch_ax, blk_ax = facs[int(rng.integers(0, len(facs)))]
            mesh = make_mesh(channel=ch_ax, block=blk_ax)
            sizes = (int(1 << rng.integers(8, 13)),)
            scheme = PartitionScheme(sizes, zero_latency=False)
            hop = sizes[0] >> 1
            cs = ch_ax * int(rng.integers(1, 3))
            quant = blk_ax * hop
            Ls = max(quant, (L // quant) * quant)
            xs = (rng.standard_normal((cs, Ls)) * amp).astype(np.float32)
            irs = (rng.standard_normal((cs, irl)) * 0.2).astype(np.float32)
            prep = mono.prepare_ir(scheme, irs, offline_tail=False)
            y = scheme_offline_sharded(mesh, scheme, prep, jnp.asarray(xs))
            y_ref = mono.process_offline(prep, jnp.asarray(xs))
            cfg = (f"sharded mesh={ch_ax}x{blk_ax} c={cs} L={Ls} "
                   f"ir={irl} N={sizes[0]}")
            check("sharded_offline", np.asarray(y_ref, np.float64), y, cfg)
        elif pick == 4:
            # Sub-hop streaming: random odd callback sizes through process_any
            # (f32 -> exercises the fused hop kernel for small sections).
            base = int(rng.integers(5, 8))
            sizes = tuple(1 << (base + 2 * k)
                          for k in range(int(rng.integers(1, 3))))
            scheme = PartitionScheme(sizes, zero_latency=True)
            Ls = min(L, (sizes[-1] >> 1) * 6 + int(rng.integers(0, 777)))
            xs = x[:, :Ls]
            prep = mono.prepare_ir(scheme, ir, offline_tail=False)
            st = mono.init_stream_state(scheme, prep, batch_shape=(c,))
            outs = []
            i = 0
            # Cap the callback count: each call is an eager (unjitted)
            # evaluation, so unbounded tiny callbacks dominate runtime.
            lo = max(1, Ls // 12)
            while i < Ls and len(outs) < 16:
                b = min(int(rng.integers(lo, lo + 600)), Ls - i)
                st, yb = mono.process_any(prep, st, jnp.asarray(xs[:, i:i + b]))
                outs.append(np.asarray(yb))
                i += b
            y = np.concatenate(outs, axis=-1)
            refs = np.stack([np.convolve(xs[k].astype(np.float64),
                                         ir[k].astype(np.float64))[:i]
                             for k in range(c)])
            cfg = f"subhop {sizes} c={c} Ls={i} ir={irl}"
            check("subhop_any_blocks", refs, y, cfg,
                  stream_raw=(ir, xs, scheme))
        elif pick == 5:
            # Two-tier block streaming: random scheme whose IR
            # extends past the far hop; carried MonoBlockState over two calls.
            base = int(rng.integers(5, 8))
            sizes = tuple(1 << (base + k)
                          for k in range(int(rng.integers(2, 5))))
            zl = bool(rng.integers(0, 2))
            scheme = PartitionScheme(sizes, zero_latency=zl)
            ir2 = ir
            prep = mono.prepare_ir(scheme, ir2, offline_tail=False)
            if prep.far is None:
                # IR too short for this scheme's far hop: extend it so the
                # two-tier branch always exercises (random tails, same decay).
                need = mono._far_hop(scheme, max(irl, 4096)) or 4096
                irl2 = int(need * (2 + rng.integers(0, 3)) +
                           rng.integers(1, need))
                ir2 = (rng.standard_normal((c, irl2)) *
                       np.exp(-np.arange(irl2) / max(irl2 / 4, 1))
                       * 0.3).astype(np.float32)
                prep = mono.prepare_ir(scheme, ir2, offline_tail=False)
                if prep.far is None:
                    continue
            h2 = prep.far.shape[-1]
            nb = max(2, min(6, L // h2))
            Ls = nb * h2
            xs = (x[:, :Ls] if L >= Ls
                  else np.pad(x, ((0, 0), (0, Ls - L))))
            st = mono.init_block_state(scheme, prep, batch_shape=(c,))
            cut = (nb // 2) * h2
            st, y1 = mono.process(prep, st, jnp.asarray(xs[:, :cut]))
            _, y2 = mono.process(prep, st, jnp.asarray(xs[:, cut:]))
            y = np.concatenate([np.asarray(y1), np.asarray(y2)], axis=-1)
            lat = scheme.latency
            refs = np.stack([np.convolve(xs[i].astype(np.float64),
                                         ir2[i].astype(np.float64))[:Ls]
                             for i in range(c)])
            if lat:
                refs = np.concatenate(
                    [np.zeros((c, lat)), refs[:, :Ls - lat]], axis=-1)
            cfg = (f"two_tier {sizes} zl={zl} c={c} Ls={Ls} "
                   f"ir={ir2.shape[-1]} H2={h2}")
            check("two_tier_stream", refs, y, cfg)
        else:
            sizes = (256, 1024)
            scheme = PartitionScheme(sizes, zero_latency=True)
            blk = sizes[-1] >> 1
            Ls = max(blk, (L // blk) * blk)
            xs = x[:, :Ls] if L >= blk else np.pad(x, ((0, 0), (0, blk - L)))
            prep = mono.prepare_ir(scheme, ir, offline_tail=False)
            st = mono.init_state(scheme, prep, batch_shape=(c,))
            # split into two calls to exercise state carry
            cut = (Ls // blk // 2) * blk
            st, y1 = mono.process(prep, st, jnp.asarray(xs[:, :cut]))
            _, y2 = mono.process(prep, st, jnp.asarray(xs[:, cut:]))
            y = np.concatenate([np.asarray(y1), np.asarray(y2)], axis=-1)
            refs = np.stack([np.convolve(xs[i].astype(np.float64),
                                         ir[i].astype(np.float64))[:Ls]
                             for i in range(c)])
            cfg = f"stream c={c} Ls={Ls} ir={irl} cut={cut}"
            check("streaming", refs, y, cfg,
                  stream_raw=(ir, xs, scheme))

    print(f"\n{n_cases} cases, {len(failures)} failures", flush=True)
    if failures:
        for f in failures:
            print("FAILED:", f)
        sys.exit(1)
    print("fuzz: all cases passed")


if __name__ == "__main__":
    main()
