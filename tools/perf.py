#!/usr/bin/env python3
"""Micro-benchmark analog of reference test/perf_fsk_modem.c, on one GPU:

- gfsk_mod:  100 x 2048 bytes at Fs=19200, baud=9600, dev=5000, BT=0.5
  (reference M1: 0.044 s = 74 Msamples/s produced)
- fsk_demod: 100 x 4096 samples at Fs=48000, baud=4800, dev=5000, decim=2,
  DC on (reference M1: 0.037 s = 11.0 Msamples/s)

plus the batched shapes the server runs.  Every timing ends in
``block_until_ready``.  Exits non-zero when JAX finds no GPU.
"""

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _time(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return time.perf_counter() - t0


def main():
    import jax
    import jax.numpy as jnp

    from sdrmodem import GfskModConfig, GfskModulator
    from sdrmodem.dsp.fsk_demod import FskDemodConfig
    from sdrmodem.dsp.pipeline import DemodPipeline
    from sdrmodem.dsp.streaming import StreamingGfskMod
    from sdrmodem.ops.select import require_gpu

    require_gpu()
    print(f"device: {jax.devices()[0].device_kind} x {len(jax.devices())}")
    rng = np.random.default_rng(0)
    cfg_tx = GfskModConfig.from_radio(19200, 9600, 5000)
    mod = GfskModulator(cfg_tx)

    # --- gfsk_mod, the reference's shape: one stream, 100 messages
    msgs = [rng.integers(0, 255, 2048).astype(np.uint8) for _ in range(100)]
    tx = StreamingGfskMod(cfg_tx)
    tx.process(msgs[0])  # compile
    t0 = time.perf_counter()
    for m in msgs:
        tx.process(m)
    dt = time.perf_counter() - t0
    n_out = 100 * 2048 * 8 * 2
    print(f"gfsk_mod streaming: 100 x 2048 bytes in {dt:.6f} s "
          f"({n_out / dt / 1e6:.1f} Msamples/s produced, host round trip per message)")

    # --- gfsk_mod, 128 streams batched per dispatch
    channels = 128
    datab = jnp.asarray(rng.integers(0, 255, (channels, 2048)).astype(np.uint8))
    stepb = jax.jit(lambda d: mod.process_pair(d)[:2])
    dt = _time(lambda: stepb(datab), 20)
    n_out = 20 * channels * 2048 * 8 * 2
    print(f"gfsk_mod batched: 20 x {channels}ch x 2048 bytes in {dt:.6f} s "
          f"({n_out / dt / 1e6:.1f} Msamples/s produced)")

    # --- fsk_demod, the reference's shape: one lane, 4096-sample blocks
    cfg = FskDemodConfig(48000, 4800, 5000, 2, 2000, True)
    pipe = DemodPipeline(cfg, 4096, exact=False, use_atan_lut="free")
    x = jnp.asarray(rng.standard_normal((2, 4096)).astype(np.float32))
    n = jnp.int32(4096)
    state = [pipe.init_state()]

    def one():
        state[0], _, cnt = pipe._step(state[0], x, n)
        return cnt

    dt = _time(one, 100)
    print(f"fsk_demod: 100 x 4096 samples in {dt:.6f} s "
          f"({100 * 4096 / dt / 1e6:.1f} Msamples/s, single lane)")

    # --- fsk_demod, batched full-block step
    channels, block, iters = 128, 65536, 6
    pipef = DemodPipeline(cfg, block, exact=False, use_atan_lut="free")
    stepf = pipef.make_batched_step_full()
    statef = [pipef.init_full_state(channels)]
    xf = jnp.asarray(rng.standard_normal((channels, 2, block)).astype(np.float32))

    def full():
        statef[0], _, cnt = stepf(statef[0], xf)
        return cnt

    dt = _time(full, iters)
    print(f"fsk_demod: {iters} x {channels}ch x {block} samples in {dt:.6f} s "
          f"({iters * channels * block / dt / 1e6:.1f} Msamples/s, batched full path)")


if __name__ == "__main__":
    main()
