#!/usr/bin/env python3
"""Benchmark: batched GMSK demod throughput of the full-block step on one GPU.

Configuration: the reference's own fsk_demod parameters (Fs=48k,
baud=4800, dev=5k, decim=2, DC on; reference test/perf_fsk_modem.c),
128 channels x 1,048,576 samples per step, the lucky7 capture tiled
across channels and time.  The reference's single-core figure for the
same demodulator is 11.0 Msamples/s (its README, MacBook Air M1, volk
generic).

Methodology: the full-block step the server's fast mode runs (XLA front
end + the platform's clock) is compiled once and stepped ``iters`` times
with the state threaded through; each timed batch ends in
``block_until_ready``.  Afterwards the lucky7 fixture is replayed through
the same compiled step and held to the reference's +-2 LSB bound; a
parity failure exits non-zero.  Prints ONE JSON line naming the device.

Runs on a GPU only: with no GPU visible it exits non-zero.
"""

import json
import os
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from sdrmodem.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax
    import jax.numpy as jnp

    from sdrmodem.dsp.fsk_demod import FskDemodConfig
    from sdrmodem.dsp.pipeline import DemodPipeline
    from sdrmodem.ops.select import require_gpu
    from tools.parity import _report

    require_gpu()
    channels = int(os.environ.get("SDRM_BENCH_CHANNELS", "128"))
    block = int(os.environ.get("SDRM_BENCH_BLOCK", str(1 << 20)))
    iters = int(os.environ.get("SDRM_BENCH_ITERS", "6"))

    cfg = FskDemodConfig(48000, 4800, 5000, 2, 2000, True)
    pipe = DemodPipeline(cfg, block, exact=False, use_atan_lut="free")
    step = pipe.make_batched_step_full(layout="tm")

    fixtures = ROOT / "tests" / "fixtures"
    iq = np.fromfile(fixtures / "lucky7.expected.cf32", dtype=np.complex64)
    reps = int(np.ceil(channels * block / len(iq)))
    tiled = np.tile(iq, reps)[: channels * block].reshape(channels, block)
    x = jnp.asarray(np.concatenate([tiled.real.T, tiled.imag.T], axis=1).astype(np.float32))

    state = pipe.init_full_state(channels)
    t0 = time.perf_counter()
    state, symbols, counts = step(state, x)
    jax.block_until_ready(counts)
    first_s = time.perf_counter() - t0

    batches = 3
    per = max(1, iters // batches)
    batch_msps = []
    t_all = time.perf_counter()
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(per):
            state, symbols, counts = step(state, x)
        jax.block_until_ready(counts)
        batch_msps.append(channels * block * per / (time.perf_counter() - t0) / 1e6)
    dt = time.perf_counter() - t_all
    msps = channels * block * batches * per / dt / 1e6

    # golden parity through the same compiled step (+-2 LSB,
    # reference test/test_fsk_demod.c:43-48)
    golden = np.fromfile(fixtures / "lucky7.expected.s8", dtype=np.int8)
    padded = np.zeros(-(-len(iq) // block) * block, np.complex64)
    padded[: len(iq)] = iq
    pstate = pipe.init_full_state(channels)
    out = []
    for start in range(0, len(padded), block):
        chunk = padded[start : start + block]
        xp = np.concatenate(
            [
                np.broadcast_to(chunk.real[:, None], (block, channels)),
                np.broadcast_to(chunk.imag[:, None], (block, channels)),
            ],
            axis=1,
        ).astype(np.float32)
        pstate, sym, cnt = step(pstate, jnp.asarray(xp))
        sym0, cnt0 = np.asarray(sym)[0], np.asarray(cnt)[0]
        out.extend(sym0[k, : int(c)] for k, c in enumerate(cnt0) if c)
    parity = _report(np.concatenate(out), golden)

    dev = jax.devices()[0]
    band = sorted(batch_msps)
    print(
        json.dumps(
            {
                "metric": "gmsk_demod_throughput",
                "value": msps,
                "unit": "Msamples/s",
                "band": [band[0], band[len(band) // 2], band[-1]],
                "first_step_s": first_s,
                "channels": channels,
                "block": block,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "parity_lucky7": parity,
            }
        )
    )
    return 0 if parity["beyond_tol_rate"] == 0.0 and parity["missing"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
