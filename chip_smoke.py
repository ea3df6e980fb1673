#!/usr/bin/env python3
"""Smoke test of the modem's main path on one GPU.

    python3 chip_smoke.py               # one GPU: phases 1-4
    python3 chip_smoke.py --four-cards  # four GPUs: the sharded server step only

Phases (any failure exits non-zero and prints no result line):

1. device — JAX must see a GPU (no CPU fallback); prints its kind, the
   device count and ``nvidia-smi``'s name and power limit.
2. kernel — the full-block step at 128 lanes x 1,048,576 samples (the
   lucky7 config, lucky7 tiled), with the clock kernel and with the scan
   clock: memory analysis, step times, and both clocks on the same front
   output (equal counts per lane, hard-decision agreement 1.0, no symbol
   beyond ±2 LSB).
3. parity — the four golden fixtures through the fast path under
   ``tools/parity.py``'s gate, lucky7 through the exact path, the TX
   golden and a TX→RX loopback through the fast path.
4. server — ``ServerConfig.load`` + ``SdrModemServer`` in fast mode with
   262,144-sample buffers fed by a mock sdr-server streaming lucky7: 8 RX
   clients (one checked against the golden, seven with Doppler), one
   client on a second server in exact mode, and one TX client sending
   100 x 2,048-byte TX_DATA messages.

``--four-cards`` runs only: 512 lanes (``SDRM_SERVER_LANES``) sharded over
4 GPUs (``SDRM_SERVER_MESH=1``) against the same 512-lane step on one GPU,
in one process; per-lane symbols must be identical.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
FIX = ROOT / "tests" / "fixtures"
LUCKY7 = (48000, 4800, 5000, 2, 2000, True)
SERVER_BUFFER = 262144
TLE = [
    "LUCKY-7",
    "1 44406U 19038W   20069.88080907  .00000505  00000-0  32890-4 0  9992",
    "2 44406  97.5270  32.5584 0026284 107.4758 252.9348 15.12089395 37524",
]


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}, default=str), flush=True)


def timed(fn, *args, reps=3):
    """(result, [seconds]) of ``reps`` calls after one warm-up call."""
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return out, times


def lucky7_tm(channels, block):
    """lucky7 tiled across lanes and time, as a (B, 2C) time-major pair."""
    iq = np.fromfile(FIX / "lucky7.expected.cf32", np.complex64)
    reps = int(np.ceil(channels * block / len(iq)))
    tiled = np.tile(iq, reps)[: channels * block].reshape(channels, block)
    return np.concatenate([tiled.real.T, tiled.imag.T], axis=1).astype(np.float32)


# ---------------------------------------------------------------- phase 1
def phase_device():
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu", f"JAX platform is {devs[0].platform!r}, not gpu")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    say("device", kind=devs[0].device_kind, count=len(devs), jax=jax.__version__)
    print(smi, flush=True)
    return devs


# ---------------------------------------------------------------- phase 2
def phase_kernel(channels=128, block=1 << 20):
    import jax
    import jax.numpy as jnp

    from sdrmodem.dsp.clock_recovery import clock_mm_batched_full
    from sdrmodem.dsp.fsk_demod import FskDemodConfig, float_to_int8
    from sdrmodem.dsp.pipeline import DemodPipeline

    cfg = FskDemodConfig(*LUCKY7)
    pipe = DemodPipeline(cfg, block, exact=False, use_atan_lut="free")
    x = jnp.asarray(lucky7_tm(channels, block))
    state = pipe.init_full_state(channels)

    steps = {}
    for clock in ("kernel", "scan"):
        step = pipe.make_batched_step_full(clock, layout="tm")
        t0 = time.perf_counter()
        compiled = step.lower(state, x).compile()
        compile_s = time.perf_counter() - t0
        if clock == "kernel":
            print(f"kernel step memory_analysis: {compiled.memory_analysis()}", flush=True)
        _, times = timed(compiled, state, x)
        steps[clock] = dict(compile_s=compile_s, step_s=times)
    say("kernel_step_times", lanes=channels, samples_per_lane=block, **steps)

    # both clocks on ONE front output
    y3, _ = jax.jit(pipe._front_batched_full)(state, x)
    p = cfg.clock_params()
    res = {}
    for clock in ("kernel", "scan"):
        fn = jax.jit(
            lambda y, cs, clock=clock: clock_mm_batched_full(
                y, cs, omega=p["omega"], gain_omega=p["gain_omega"], mu=p["mu"],
                gain_mu=p["gain_mu"], omega_relative_limit=p["omega_relative_limit"],
                backend=clock,
            )[:2]
        )
        outs, counts = fn(y3, state.clock)
        res[clock] = (np.asarray(float_to_int8(outs))[:, 0], np.asarray(counts)[:, 0])
    (ko, kc), (so, sc) = res["kernel"], res["scan"]
    check(np.array_equal(kc, sc), "kernel and scan symbol counts differ")
    n = int(kc.max())
    valid = np.arange(n)[None, :] < kc[:, None]
    k = ko[:, :n].astype(np.int32)[valid]
    s = so[:, :n].astype(np.int32)[valid]
    diff = np.abs(k - s)
    confident = np.abs(s) >= 8
    stats = dict(
        symbols=int(valid.sum()),
        counts_equal=True,
        max_lsb_diff=int(diff.max()),
        mismatch_rate=float((diff != 0).mean()),
        beyond_tol_rate=float((diff > 2).mean()),
        hard_decision_agreement=float((np.sign(k[confident]) == np.sign(s[confident])).mean()),
    )
    say("kernel_vs_scan", **stats)
    check(stats["beyond_tol_rate"] == 0.0, "kernel vs scan: symbols beyond ±2 LSB")
    check(stats["hard_decision_agreement"] == 1.0, "kernel vs scan: hard decisions differ")


# ---------------------------------------------------------------- phase 3
def phase_parity():
    import jax.numpy as jnp

    from sdrmodem.dsp.fsk_demod import FskDemodConfig
    from sdrmodem.dsp.gfsk_mod import GfskModConfig
    from sdrmodem.dsp.pipeline import DemodPipeline
    from sdrmodem.dsp.streaming import StreamingGfskMod
    from tools import parity

    rep = parity.run(16384)
    say("parity_fast", gate=rep["gate"], fixtures=rep["fixtures"])
    check(rep["gate"]["pass"], f"fast-path parity gate: {rep['gate']['failures']}")
    rep = parity.run(16384, names=["lucky7"], modes=("exact",))
    say("parity_exact", gate=rep["gate_exact"], fixtures=rep["fixtures_exact"])
    check(rep["gate_exact"]["pass"], f"exact-path parity: {rep['gate_exact']['failures']}")

    vals = np.load(FIX / "gfsk_mod_expected320.npy")
    iq = StreamingGfskMod(GfskModConfig.from_radio(19200, 9600, 5000)).process(
        np.arange(10, dtype=np.uint8)
    )
    err = float(max(np.abs(iq.real - vals[0::2]).max(), np.abs(iq.imag - vals[1::2]).max()))
    say("tx_golden", max_abs_err=err, tolerance=0.01)
    check(err < 0.01, "TX golden beyond 0.01")

    # TX -> RX loopback through the fast full-block step
    fs, baud, dev = 48000, 9600, 5000
    payload = np.random.default_rng(0).integers(0, 256, 2048).astype(np.uint8)
    tx = StreamingGfskMod(GfskModConfig.from_radio(fs, baud, dev))
    iq = np.concatenate([tx.process(payload[:1000]), tx.process(payload[1000:])])
    block = 16384
    pipe = DemodPipeline(FskDemodConfig(fs, baud, dev, 1, 2000, False), block, exact=False,
                         use_atan_lut="free")
    step = pipe.make_batched_step_full()
    st = pipe.init_full_state(1)
    padded = np.zeros(-(-(len(iq) + block) // block) * block, np.complex64)
    padded[: len(iq)] = iq
    soft = []
    for i in range(0, len(padded), block):
        c = padded[i : i + block]
        st, sym, cnt = step(st, jnp.asarray(np.stack([c.real, c.imag])[None].astype(np.float32)))
        soft.append(np.asarray(sym)[0, 0, : int(np.asarray(cnt)[0, 0])])
    hard = np.sign(np.concatenate(soft)).astype(np.int8)
    bits = np.unpackbits(payload).astype(np.int8) * 2 - 1
    errors = min(
        int((hard[off : off + len(bits)] != bits).sum())
        for off in range(0, 64)
        if off + len(bits) <= len(hard)
    )
    say("tx_rx_loopback", bits=len(bits), bit_errors=errors)
    check(errors == 0, f"loopback: {errors} bit errors")


# ---------------------------------------------------------------- phase 4
def _server_conf(path, port, mode, tmp):
    path.write_text(
        f'bind_address = "127.0.0.1";\nport = 0;\nbuffer_size = {SERVER_BUFFER};\n'
        f'demod_mode = "{mode}";\nrx_sdr_type = "sdr-server";\n'
        f'rx_sdr_server_address = "127.0.0.1";\nrx_sdr_server_port = {port};\n'
        f'tx_sdr_type = "file";\nbase_path = "{tmp}";\n'
        f'rx_file_base_path = "{tmp}";\ntx_file_base_path = "{tmp}";\n'
    )
    return path


def _rx_request(doppler):
    from sdrmodem.server import wire

    return wire.RxRequest(
        rx_center_freq=437525000,
        rx_sampling_freq=48000,
        demod_type=wire.ModemType.GMSK,
        demod_baud_rate=4800,
        demod_decimation=2,
        demod_destination=wire.DemodDestination.SOCKET,
        doppler=wire.DopplerSettings(
            tle=TLE, latitude=537200000, longitude=475700000, altitude=0
        ) if doppler else None,
        fsk_settings=wire.FskDemodulationSettings(
            demod_fsk_deviation=5000, demod_fsk_transition_width=2000,
            demod_fsk_use_dc_block=True,
        ),
    )


async def _server_phase(tmp: pathlib.Path):
    from sdrmodem.server import wire
    from sdrmodem.server.config import ServerConfig
    from sdrmodem.server.tcp_server import SdrModemServer
    from tests.server_helpers import MockSdrServer, ModemClient

    iq = np.fromfile(FIX / "lucky7.expected.cf32", np.complex64)
    golden = np.fromfile(FIX / "lucky7.expected.s8", np.int8)
    blocks = 4
    stream = np.tile(iq, -(-blocks * SERVER_BUFFER // len(iq)))[: blocks * SERVER_BUFFER]
    n_read = blocks * SERVER_BUFFER // 2 // 5 - 512  # symbols every lane must emit

    mock = MockSdrServer()
    ss_port = await mock.start()
    fast = SdrModemServer(ServerConfig.load(_server_conf(tmp / "fast.conf", ss_port, "fast", tmp)))
    exact = SdrModemServer(ServerConfig.load(_server_conf(tmp / "exact.conf", ss_port, "exact", tmp)))
    check(fast.config.demod_mode == "fast" and fast.config.buffer_size == SERVER_BUFFER,
          "fast config not loaded")
    await fast.start()
    await exact.start()
    clients = []
    for i in range(8):
        c = await ModemClient.connect("127.0.0.1", fast.port)
        r = await c.rx_request(_rx_request(doppler=i > 0))
        check(r.status == wire.ResponseStatus.SUCCESS, f"fast rx client {i} refused")
        clients.append(c)
    ce = await ModemClient.connect("127.0.0.1", exact.port)
    r = await ce.rx_request(_rx_request(doppler=False))
    check(r.status == wire.ResponseStatus.SUCCESS, "exact rx client refused")
    while len(mock.clients) < 2:
        await asyncio.sleep(0.05)

    t0 = time.perf_counter()
    await mock.send_iq(stream)
    got = [np.frombuffer(await c.read_stream(n_read, timeout=600), np.int8) for c in clients]
    rx_s = time.perf_counter() - t0
    got_exact = np.frombuffer(await ce.read_stream(n_read, timeout=600), np.int8)
    exact_s = time.perf_counter() - t0

    def golden_report(sym):
        m = min(len(sym), len(golden))
        d = np.abs(sym[:m].astype(np.int32) - golden[:m].astype(np.int32))
        return int(d.max()), float((d > 2).mean())

    fast_max, fast_beyond = golden_report(got[0])
    exact_max, exact_beyond = golden_report(got_exact)

    # TX: 100 x 2048-byte messages, one ACK each
    tx = await ModemClient.connect("127.0.0.1", fast.port)
    r = await tx.tx_request(
        wire.TxRequest(
            tx_center_freq=437525000, tx_sampling_freq=19200, tx_offset=0,
            mod_type=wire.ModemType.GMSK, mod_baud_rate=9600,
            fsk_settings=wire.FskModulationSettings(mod_fsk_deviation=5000),
            file_settings=wire.FileSettings(filename=str(tmp / "tx.cf32")),
        )
    )
    check(r.status == wire.ResponseStatus.SUCCESS, "tx client refused")
    rng = np.random.default_rng(1)
    acks = 0
    t1 = time.perf_counter()
    for _ in range(100):
        resp = await tx.tx_data(rng.integers(0, 256, 2048).astype(np.uint8).tobytes())
        acks += resp.status == wire.ResponseStatus.SUCCESS
    tx_s = time.perf_counter() - t1
    await tx.shutdown()

    for c in clients + [ce]:
        await c.shutdown()
    await asyncio.sleep(0.5)
    for c in clients + [ce, tx]:
        c.close()
    await mock.stop()
    await fast.stop()
    await exact.stop()
    tx_bytes = (tmp / "tx.cf32").stat().st_size
    say(
        "server",
        fast_clients=len(got), symbols_per_client=n_read,
        fast_golden_max_lsb=fast_max, fast_golden_beyond_tol_rate=fast_beyond,
        exact_clients=1, exact_golden_max_lsb=exact_max,
        exact_golden_beyond_tol_rate=exact_beyond,
        tx_acks=acks, tx_file_bytes=tx_bytes,
        rx_fast_wall_s=rx_s, rx_exact_wall_s=exact_s, tx_wall_s=tx_s,
    )
    check(all(len(g) == n_read for g in got), "a fast client got too few symbols")
    check(fast_beyond == 0.0, "fast client beyond ±2 LSB of the golden")
    check(exact_beyond == 0.0, "exact client beyond ±2 LSB of the golden")
    check(acks == 100, f"{acks} of 100 TX ACKs")
    check(tx_bytes == 100 * 2048 * 8 * 2 * 8, "TX file size")


def phase_server():
    with tempfile.TemporaryDirectory() as tmp:
        asyncio.run(asyncio.wait_for(_server_phase(pathlib.Path(tmp)), timeout=900))


# ---------------------------------------------------------------- --four-cards
def phase_four_cards():
    """512 lanes over 4 GPUs (SDRM_SERVER_MESH) vs the same step on one."""
    import jax
    import jax.numpy as jnp

    from sdrmodem.dsp.doppler import Doppler
    from sdrmodem.dsp.fsk_demod import FskDemodConfig
    from sdrmodem.server import session

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} GPUs visible, 4 needed")
    check(session.BatchedRxGroup.LANES == 512, "SDRM_SERVER_LANES did not apply")
    cfg = FskDemodConfig(*LUCKY7)
    groups = {}
    for mesh in ("1", "0"):
        os.environ["SDRM_SERVER_MESH"] = mesh
        groups[mesh] = session.BatchedRxGroup(cfg, SERVER_BUFFER)
    lanes = 512
    iq = np.fromfile(FIX / "lucky7.expected.cf32", np.complex64)
    iq = np.tile(iq, -(-2 * SERVER_BUFFER // len(iq)))
    blocks = [iq[i * SERVER_BUFFER : (i + 1) * SERVER_BUFFER] for i in range(2)]
    rows = groups["0"].dop_rows
    dops = [
        Doppler(latitude=53.72, longitude=47.57, altitude_km=0.0, sampling_freq=48000,
                center_freq=437525000, tle_lines=TLE, constant_offset=25 * lane,
                start_time_seconds=1583840449)
        if lane % 2 else None
        for lane in range(lanes)
    ]
    tables = []
    for b in blocks:
        t = np.zeros((4, rows, lanes), np.float32)
        for lane, d in enumerate(dops):
            if d is None:
                continue
            for k, (st, ln, adj, ph0) in enumerate(d.device_segments(SERVER_BUFFER, +1)):
                t[:, k, lane] = (st, st + ln, adj, ph0)
        tables.append(tuple(jnp.asarray(a) for a in t))
    xs = [jnp.asarray(np.stack([b.real, b.imag]).astype(np.float32)) for b in blocks]

    results, times = {}, {}
    for mesh, g in groups.items():
        state, syms, cnts = g.state, [], []
        for x, tab in zip(xs, tables):
            state, s, c = g._step(state, x, tab)
            syms.append(np.asarray(s))
            cnts.append(np.asarray(c))
        results[mesh] = (syms, cnts)
        _, times[mesh] = timed(g._step, state, xs[0], tables[0])
    same = all(
        np.array_equal(a, b) for a, b in zip(results["1"][0] + results["1"][1],
                                             results["0"][0] + results["0"][1])
    )
    say("four_cards", lanes=lanes, devices=4, identical_per_lane_symbols=same,
        symbols=int(sum(c.sum() for c in results["0"][1])),
        step_s_4_cards=times["1"], step_s_1_card=times["0"])
    check(same, "4-card and 1-card per-lane symbols differ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 512-lane step sharded over 4 GPUs vs 1 GPU")
    args = ap.parse_args(argv)
    if not (ROOT / "sdrmodem").is_dir():
        print("chip_smoke: the sdrmodem package is not beside this script", file=sys.stderr)
        return 2
    if args.four_cards:
        os.environ["SDRM_SERVER_LANES"] = "512"
    sys.path.insert(0, str(ROOT))
    from sdrmodem.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    try:
        devs = phase_device()
        if args.four_cards:
            phase_four_cards()
        else:
            phase_kernel()
            phase_parity()
            phase_server()
    except (SmokeFailure, RuntimeError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
