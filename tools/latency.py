#!/usr/bin/env python3
"""Per-block end-to-end latency of the server fast path.

Throughput (bench.py) is proven; this measures LATENCY: host staging ->
device step -> symbols fetched, per block, for the shapes that matter:

- the reference's own real-time buffer (4096 samples,
  reference test/perf_fsk_modem.c:72), single lane ragged and
  128-lane full-block;
- the server's default buffer (262144, server_config.c:48);
- the bench throughput block (1M).

Method: compile + warm once, then N reps of [device_put block, step,
fetch counts] with the carried state threading through (every rep is a
real stream continuation, not a replay).  The symbol-count fetch to the
host is the sync point: it is what a client waits for.
Reports median/p10/p90 ms per block.

Usage: python3 tools/latency.py [--reps 20] [--out latency.json] [--cpu]
(--cpu runs on the CPU for a local check; its times are not device times)
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def measure(shape_name, step_fn, make_x, state, reps):
    import jax.numpy as jnp

    times = []
    s = state
    for _ in range(reps):
        x = make_x()
        t0 = time.perf_counter()
        xd = jnp.asarray(x)
        out = step_fn(s, xd)
        s = out[0]
        total = int(np.asarray(out[2]).sum())  # sync point
        times.append((time.perf_counter() - t0) * 1e3)
    times = sorted(times)
    n = len(times)
    return {
        "shape": shape_name,
        "median_ms": round(times[n // 2], 3),
        "p10_ms": round(times[n // 10], 3),
        "p90_ms": round(times[(9 * n) // 10], 3),
        "reps": reps,
        "symbols_last": total,
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", default=None)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument(
        "--blocks", default="4096,65536,262144,1048576",
        help="comma-separated full-path block sizes",
    )
    args = parser.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from sdrmodem.dsp.fsk_demod import FskDemodConfig
    from sdrmodem.dsp.pipeline import DemodPipeline
    from sdrmodem.ops.select import require_gpu

    if not args.cpu:
        require_gpu()
    cfg = FskDemodConfig(48000, 4800, 5000, 2, 2000, True)
    rng = np.random.default_rng(0)
    results = []

    # --- single-lane ragged step at the reference's 4096-sample buffer
    # (the reference's own real-time shape: one client, one buffer)
    pipe_r = DemodPipeline(cfg, 4096, exact=False, use_atan_lut="free")
    st = pipe_r.init_state()
    iq = rng.standard_normal((2, 4096)).astype(np.float32) * 0.3
    step = lambda s, x: pipe_r._step(s, x, jnp.int32(4096))
    st2 = step(st, jnp.asarray(iq))  # compile
    int(np.asarray(st2[2]).sum())
    results.append(
        measure("ragged 1 lane x 4096", step, lambda: iq, st, args.reps)
    )

    # --- full-block production path at several block sizes, 128 lanes
    for block in (int(b) for b in args.blocks.split(",")):
        pipe = DemodPipeline(cfg, block, exact=False, use_atan_lut="free")
        stepf = pipe.make_batched_step_full(layout="tm")
        state = pipe.init_full_state(128)
        x = (rng.standard_normal((block, 256)) * 0.3).astype(np.float32)
        out = stepf(state, jnp.asarray(x))  # compile
        int(np.asarray(out[2]).sum())
        results.append(
            measure(
                f"full 128 lanes x {block}",
                lambda s, xd, stepf=stepf: stepf(s, xd),
                lambda: x,
                state,
                args.reps,
            )
        )

    report = {
        "platform": jax.devices()[0].platform,
        "device": jax.devices()[0].device_kind,
        "results": results,
    }
    for r in results:
        print(
            f"{r['shape']:>28}: median {r['median_ms']:8.3f} ms "
            f"(p10 {r['p10_ms']:.3f} / p90 {r['p90_ms']:.3f})"
        )
    text = json.dumps(report, indent=2)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    else:
        print(text)


if __name__ == "__main__":
    main()
