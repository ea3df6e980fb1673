#!/usr/bin/env python3
"""Capture a jax.profiler trace of the full-block demod step on the GPU.

SURVEY.md §5: the reference's only profiling is a micro-benchmark with
commented timings (test/perf_fsk_modem.c); this build gets device traces.
Writes a TensorBoard-compatible trace directory; view with
``tensorboard --logdir <out>`` or read it with
``jax.profiler.ProfileData.from_file``.

Usage: python3 tools/trace.py [--out traces/step] [--block 65536]
                              [--channels 128] [--steps 4]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="traces/step")
    parser.add_argument("--block", type=int, default=65536)
    parser.add_argument("--channels", type=int, default=128)
    parser.add_argument("--steps", type=int, default=4)
    args = parser.parse_args(argv)

    import numpy as np
    import jax
    import jax.numpy as jnp

    from sdrmodem.dsp.fsk_demod import FskDemodConfig
    from sdrmodem.dsp.pipeline import DemodPipeline
    from sdrmodem.ops.select import require_gpu

    require_gpu()
    cfg = FskDemodConfig(48000, 4800, 5000, 2, 2000, True)
    pipe = DemodPipeline(cfg, args.block, exact=False, use_atan_lut="free")
    step = pipe.make_batched_step_full()
    state = pipe.init_full_state(args.channels)
    rng = np.random.default_rng(0)
    x = jnp.asarray(
        rng.standard_normal((args.channels, 2, args.block)).astype(np.float32)
    )

    # warm-up compile outside the trace
    state, sym, cnt = step(state, x)
    int(np.asarray(cnt).sum())

    with jax.profiler.trace(args.out):
        s = state
        for _ in range(args.steps):
            s, sym, cnt = step(s, x)
        total = int(np.asarray(cnt).sum())
    print(f"traced {args.steps} steps ({total} symbols in the last) -> {args.out}")


if __name__ == "__main__":
    main()
