#!/usr/bin/env python3
"""TX → channel (AWGN + frequency offset) → RX loopback BER sweep.

Modulate random payloads with gfsk_mod, impair with white Gaussian noise
and a carrier offset, demodulate with fsk_demod, and report BER per SNR
point.

Batched mode (default): every SNR point is one lane of the batched
full-block demod step — the program the server fast mode runs (float32
pairs, banded-matmul FIRs, the platform's clock, gather-free LUT
arctangent).  The channel model is host-side numpy on float32 I/Q pairs
(stimulus generation, not device work).

Usage: python3 tools/ber_sweep.py [--snrs 0,2,4,...] [--offset-hz 200]
       [--cpu]  (force the CPU backend; also used by the unit tests)
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _tx_and_bits(n_bytes: int, seed: int, fs: int, baud: int, dev: int):
    """Modulate a random payload; returns (iq complex64 host array, tx bits)."""
    import jax.numpy as jnp

    from sdrmodem import GfskModConfig, GfskModulator

    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, n_bytes).astype(np.uint8)
    mod = GfskModulator(GfskModConfig.from_radio(fs, baud, dev))
    i, q, _ = mod.process_pair(jnp.asarray(payload))
    iq = (np.asarray(i) + 1j * np.asarray(q)).astype(np.complex64)
    bits = np.unpackbits(payload).astype(np.int8) * 2 - 1
    return iq, bits


def _channel(iq: np.ndarray, snr_db: float, offset_hz: float, fs: int, rng):
    """AWGN at the requested Es/N0 (signal power 1.0 by construction) plus
    an optional carrier offset; host-side numpy, complex only on the host."""
    noise_power = 10 ** (-snr_db / 10.0)
    noise = (
        rng.standard_normal(len(iq)) + 1j * rng.standard_normal(len(iq))
    ).astype(np.complex64) * np.sqrt(noise_power / 2.0)
    rx = (iq + noise).astype(np.complex64)
    if offset_hz:
        n = np.arange(len(iq), dtype=np.float64)
        rx = rx * np.exp(2j * np.pi * offset_hz / fs * n).astype(np.complex64)
    return rx


def _ber(hard: np.ndarray, bits_tx: np.ndarray, skip: int = 128):
    """Best-alignment bit error rate, skipping the filter warm-up (the DC
    blocker alone delays by 2*(L-1) samples ~ 64 symbols)."""
    best_err, best_n = 1.0, 1
    for off in range(0, 220):
        n = min(len(hard) - off - skip, len(bits_tx) - skip)
        if n <= 100:
            break
        errs = float(
            (hard[skip + off : skip + off + n] != bits_tx[skip : skip + n]).mean()
        )
        if errs < best_err:
            best_err, best_n = errs, n
    return best_err, best_n


def run_point(snr_db: float, offset_hz: float, n_bytes: int, seed: int):
    """Single-point CPU-path BER (whole-stream FskDemodulator); kept as the
    parity-mode reference and for the unit tests."""
    import jax.numpy as jnp

    from sdrmodem import FskDemodConfig, FskDemodulator

    fs, baud, dev = 48000, 9600, 5000
    rng = np.random.default_rng(seed)
    iq, bits_tx = _tx_and_bits(n_bytes, seed, fs, baud, dev)
    rx = _channel(iq, snr_db, offset_hz, fs, rng)

    demod = FskDemodulator(FskDemodConfig(fs, baud, dev, 1, 2000, True), exact=False)
    out, count, _ = demod.process(jnp.asarray(rx))
    soft = np.asarray(out)[: int(count)]
    hard = np.sign(soft).astype(np.int8)
    return _ber(hard, bits_tx)


def run_sweep_batched(snrs, offset_hz: float, n_bytes: int, seed: int, block: int = 32768):
    """All SNR points batched as channel lanes of ONE full-block step."""
    import jax.numpy as jnp

    from sdrmodem import FskDemodConfig
    from sdrmodem.dsp.pipeline import DemodPipeline

    fs, baud, dev = 48000, 9600, 5000
    iq, bits_tx = _tx_and_bits(n_bytes, seed, fs, baud, dev)

    lanes = []
    for k, snr in enumerate(snrs):
        rng = np.random.default_rng(seed + 1000 + k)
        lanes.append(_channel(iq, snr, offset_hz, fs, rng))
    rxs = np.stack(lanes)  # (C, N) complex64 on the host only

    cfg = FskDemodConfig(fs, baud, dev, 1, 2000, True)
    blk = min(block, -(-rxs.shape[1] // cfg.decimation) * cfg.decimation)
    pipe = DemodPipeline(cfg, blk, exact=False, use_atan_lut="free")
    step = pipe.make_batched_step_full()
    state = pipe.init_full_state(len(snrs))

    n = rxs.shape[1]
    padded = np.zeros((len(snrs), -(-n // blk) * blk), np.complex64)
    padded[:, :n] = rxs
    outs = [[] for _ in snrs]
    for start in range(0, padded.shape[1], blk):
        chunk = padded[:, start : start + blk]
        x = np.stack([chunk.real, chunk.imag], axis=1).astype(np.float32)  # (C,2,blk)
        state, sym, cnt = step(state, jnp.asarray(x))
        sym = np.asarray(sym)  # (C, n_chunks, K)
        cnt = np.asarray(cnt)  # (C, n_chunks)
        for c in range(len(snrs)):
            for k in range(cnt.shape[1]):
                if cnt[c, k]:
                    outs[c].append(sym[c, k, : int(cnt[c, k])])

    points = []
    for c, snr in enumerate(snrs):
        soft = np.concatenate(outs[c]) if outs[c] else np.zeros(0, np.int8)
        hard = np.sign(soft).astype(np.int8)
        ber, nbits = _ber(hard, bits_tx)
        points.append({"snr_db": float(snr), "ber": ber, "bits": nbits})
    return points


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--snrs", default="0,2,4,6,8,10,12")
    parser.add_argument("--offset-hz", type=float, default=0.0)
    parser.add_argument("--bytes", type=int, default=2048)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--point-mode", action="store_true",
                        help="per-point whole-stream CPU path (parity mode)")
    args = parser.parse_args(argv)

    import jax

    if args.cpu:
        # must happen before the first backend initialization
        jax.config.update("jax_platforms", "cpu")

    snrs = [float(s) for s in args.snrs.split(",")]
    if args.point_mode:
        points = []
        for snr in snrs:
            ber, n = run_point(snr, args.offset_hz, args.bytes, args.seed)
            points.append({"snr_db": snr, "ber": ber, "bits": n})
            print(json.dumps(points[-1]))
        return points

    points = run_sweep_batched(snrs, args.offset_hz, args.bytes, args.seed)
    print(json.dumps({
        "metric": "ber_sweep",
        "platform": jax.devices()[0].platform,
        "offset_hz": args.offset_hz,
        "points": points,
    }))
    return points


if __name__ == "__main__":
    main()
