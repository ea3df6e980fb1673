"""End-to-end server integration tests (reference test/test_tcp_server.c):
real server + mock sdr-server + wire-protocol client in one process."""

import asyncio

import numpy as np
import pytest

from sdrmodem.server import wire
from sdrmodem.server.config import RxSdrType, ServerConfig, TxSdrType
from sdrmodem.server.tcp_server import SdrModemServer

from tests.server_helpers import MockSdrServer, ModemClient


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=120))


def make_config(tmp_path, **kw) -> ServerConfig:
    cfg = ServerConfig()
    cfg.bind_address = "127.0.0.1"
    cfg.port = 0
    cfg.buffer_size = 4096
    cfg.base_path = str(tmp_path)
    cfg.read_timeout_seconds = 5
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def rx_request(**kw) -> wire.RxRequest:
    req = wire.RxRequest(
        rx_center_freq=437525000,
        rx_sampling_freq=48000,
        rx_offset=0,
        demod_type=wire.ModemType.GMSK,
        demod_baud_rate=4800,
        demod_decimation=2,
        demod_destination=wire.DemodDestination.SOCKET,
        fsk_settings=wire.FskDemodulationSettings(
            demod_fsk_deviation=5000, demod_fsk_transition_width=2000,
            demod_fsk_use_dc_block=True,
        ),
    )
    for k, v in kw.items():
        setattr(req, k, v)
    return req


def test_ping(tmp_path):
    async def body():
        server = SdrModemServer(make_config(tmp_path))
        await server.start()
        client = await ModemClient.connect("127.0.0.1", server.port)
        resp = await client.ping()
        assert resp.status == wire.ResponseStatus.SUCCESS
        client.close()
        await server.stop()

    run(body())


@pytest.mark.parametrize(
    "mutate",
    [
        dict(demod_type=99),
        dict(rx_center_freq=0),
        dict(rx_sampling_freq=0),
        dict(demod_baud_rate=0),
        dict(demod_decimation=0),
        dict(demod_destination=42),
        dict(fsk_settings=None),
        dict(doppler=wire.DopplerSettings(tle=["only", "two"])),
    ],
)
def test_invalid_rx_requests(tmp_path, mutate):
    async def body():
        server = SdrModemServer(make_config(tmp_path))
        await server.start()
        client = await ModemClient.connect("127.0.0.1", server.port)
        resp = await client.rx_request(rx_request(**mutate))
        assert resp.status == wire.ResponseStatus.FAILURE
        assert resp.details == wire.ResponseDetails.INVALID_REQUEST
        client.close()
        await server.stop()

    run(body())


def test_rx_stream_demod_golden(tmp_path, resources_dir):
    """Full RX pipeline: mock sdr-server pushes the doppler-corrected
    capture, client receives int8 soft symbols matching the golden
    (test_tcp_server.c test_read_data analog)."""
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:48000]
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)

    async def body():
        mock = MockSdrServer()
        ss_port = await mock.start()
        config = make_config(
            tmp_path, rx_sdr_type=RxSdrType.SDR_SERVER, rx_sdr_server_port=ss_port
        )
        server = SdrModemServer(config)
        await server.start()

        client = await ModemClient.connect("127.0.0.1", server.port)
        resp = await client.rx_request(
            rx_request(rx_dump_file=True, demod_destination=wire.DemodDestination.BOTH)
        )
        assert resp.status == wire.ResponseStatus.SUCCESS
        client_id = resp.details
        await mock.wait_client()
        # sdr-server got the tuning request
        center, rate, band, dest = mock.requests[0]
        assert (center, rate, band, dest) == (437525000, 48000, 437525000, 1)

        await mock.send_iq(iq)
        # 48000 samples -> ~4800 symbols; read what the reference golden says
        expected_symbols = 4801
        data = await client.read_stream(expected_symbols)
        got = np.frombuffer(data, dtype=np.int8)
        diff = np.abs(got.astype(np.int32) - golden[: len(got)].astype(np.int32))
        assert diff.max() <= 2

        await client.shutdown()
        await asyncio.sleep(0.2)
        # dump files written
        dump_iq = np.fromfile(tmp_path / f"rx.sdr2demod.{client_id}.cf32", dtype=np.complex64)
        assert len(dump_iq) == len(iq)
        dump_sym = np.fromfile(
            tmp_path / f"rx.demod2client.{client_id}.s8", dtype=np.int8
        )
        assert len(dump_sym) >= expected_symbols

        client.close()
        await mock.stop()
        await server.stop()

    run(body())


def test_multiple_clients_share_sdr_connection(tmp_path, resources_dir):
    """Two clients with identical tuning share one sdr-server connection
    (test_tcp_server.c test_multiple_clients)."""

    async def body():
        mock = MockSdrServer()
        ss_port = await mock.start()
        config = make_config(tmp_path, rx_sdr_server_port=ss_port)
        server = SdrModemServer(config)
        await server.start()

        c1 = await ModemClient.connect("127.0.0.1", server.port)
        r1 = await c1.rx_request(rx_request())
        assert r1.status == wire.ResponseStatus.SUCCESS
        c2 = await ModemClient.connect("127.0.0.1", server.port)
        r2 = await c2.rx_request(rx_request())
        assert r2.status == wire.ResponseStatus.SUCCESS
        assert len(mock.requests) == 1  # one upstream connection only
        assert len(server.streams) == 1
        assert len(server.streams[0].sessions) == 2

        # both receive the same demod stream
        iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:24000]
        await mock.send_iq(iq)
        d1 = await c1.read_stream(1000)
        d2 = await c2.read_stream(1000)
        assert d1 == d2

        await c1.shutdown()
        await asyncio.sleep(0.2)
        assert len(server.streams) == 1  # second client keeps it alive
        await c2.shutdown()
        await asyncio.sleep(0.3)
        assert len(server.streams) == 0  # cascade teardown
        c1.close()
        c2.close()
        await mock.stop()
        await server.stop()

    run(body())


def test_file_tx_then_rx_loopback(tmp_path):
    """TX to a file device, then demodulate that file back — the
    reference's test_file_data flow (test_tcp_server.c:435-480)."""
    payload = bytes(b"\xca\xfe\x01\x02\x03\x04\x05\x06\x07\x08" * 40)

    async def body():
        tx_file = tmp_path / "tx.cf32"
        config = make_config(
            tmp_path, tx_sdr_type=TxSdrType.FILE, rx_sdr_type=RxSdrType.FILE
        )
        server = SdrModemServer(config)
        await server.start()

        tx = await ModemClient.connect("127.0.0.1", server.port)
        resp = await tx.tx_request(
            wire.TxRequest(
                tx_center_freq=437525000,
                tx_sampling_freq=48000,
                tx_offset=0,
                mod_type=wire.ModemType.GMSK,
                mod_baud_rate=9600,
                fsk_settings=wire.FskModulationSettings(mod_fsk_deviation=5000),
                file_settings=wire.FileSettings(filename=str(tx_file)),
            )
        )
        assert resp.status == wire.ResponseStatus.SUCCESS
        ack = await tx.tx_data(payload)
        assert ack.status == wire.ResponseStatus.SUCCESS
        await tx.shutdown()
        await asyncio.sleep(0.2)

        assert tx_file.exists() and tx_file.stat().st_size > 0

        rx = await ModemClient.connect("127.0.0.1", server.port)
        resp = await rx.rx_request(
            rx_request(
                rx_sampling_freq=48000,
                demod_baud_rate=9600,
                demod_decimation=1,
                fsk_settings=wire.FskDemodulationSettings(
                    demod_fsk_deviation=5000,
                    demod_fsk_transition_width=2000,
                    demod_fsk_use_dc_block=False,
                ),
                file_settings=wire.FileSettings(filename=str(tx_file)),
            )
        )
        assert resp.status == wire.ResponseStatus.SUCCESS
        n_bits = len(payload) * 8
        data = await rx.read_stream(n_bits - 32)
        soft = np.frombuffer(data, dtype=np.int8)
        bits_tx = np.unpackbits(np.frombuffer(payload, np.uint8)).astype(np.int8) * 2 - 1
        hard = np.sign(soft).astype(np.int8)
        best = 0.0
        for off in range(0, 64):
            n = min(len(hard) - off, len(bits_tx))
            best = max(best, float((hard[off : off + n] == bits_tx[:n]).mean()))
        assert best > 0.995, f"loopback BER {1-best:.4f}"
        await rx.shutdown()
        rx.close()
        tx.close()
        await server.stop()

    run(body())


def test_plutosdr_tx_e2e_golden(tmp_path):
    """TX session through the real server into the mocked iio device:
    the captured int16 DAC samples and the tx dump file must match the
    reference's goldens (test_tcp_server.c:198-239 — first 50 DAC values
    alternate 32767, 0 and the dump is 1.0 - 0.0j, because the Gaussian
    FIR warmup keeps the VCO phase at ~0 for the first bit period)."""
    from tests.test_plutosdr import MockIioLib

    async def body():
        lib = MockIioLib()
        config = make_config(tmp_path, tx_sdr_type=TxSdrType.PLUTOSDR, iio_lib=lib)
        server = SdrModemServer(config)
        await server.start()
        tx = await ModemClient.connect("127.0.0.1", server.port)
        resp = await tx.tx_request(
            wire.TxRequest(
                tx_center_freq=437525000,
                tx_sampling_freq=580000,
                tx_dump_file=True,
                tx_offset=0,
                mod_type=wire.ModemType.GMSK,
                mod_baud_rate=4800,
                fsk_settings=wire.FskModulationSettings(mod_fsk_deviation=5000),
            )
        )
        assert resp.status == wire.ResponseStatus.SUCCESS
        ack = await tx.tx_data(bytes(range(50)))
        assert ack.status == wire.ResponseStatus.SUCCESS
        await tx.shutdown()
        await asyncio.sleep(0.2)
        tx.close()
        await server.stop()

        # DAC capture: reference golden = {32767, 0} x 25
        pushed = np.frombuffer(b"".join(lib.tx_pushed), np.int16)
        assert len(pushed) == 50 * 8 * 120 * 2  # 50 bytes * 8 bits * sps, I+Q
        expected = np.zeros(50, np.int16)
        expected[0::2] = 32767
        np.testing.assert_array_equal(pushed[:50], expected)

        # dump file: reference golden = 1.0 - 0.0j within 0.001
        dumps = list(tmp_path.glob("tx.mod2sdr.*.cf32"))
        assert len(dumps) == 1
        dump = np.frombuffer(dumps[0].read_bytes(), np.complex64)
        assert len(dump) == 50 * 8 * 120
        np.testing.assert_allclose(dump[:50].real, 1.0, atol=1e-3)
        np.testing.assert_allclose(dump[:50].imag, 0.0, atol=1e-3)

    run(body())


def test_plutosdr_rx_e2e(tmp_path):
    """RX session over the mocked pluto: a GMSK capture served through the
    iio seam (int16, 12-bit scale 2048) demodulates back to the
    transmitted bits; a second concurrent client hits the single-pluto-RX
    enforcement (RX_IS_BEING_USED), and a later client succeeds again
    after teardown (reference src/tcp_server.c:425-430)."""
    from sdrmodem.dsp.gfsk_mod import GfskModConfig
    from sdrmodem.dsp.streaming import StreamingGfskMod

    from tests.test_plutosdr import MockIioLib

    # Fs must satisfy the AD9361's minimum rate (520834 with the DEC4 FIR,
    # reference src/sdr/plutosdr.c:310-407)
    payload = bytes(b"\xca\xfe\x01\x02\x03\x04\x05\x06\x07\x08" * 10)
    mod = StreamingGfskMod(GfskModConfig.from_radio(576000, 9600, 5000))
    iq = mod.process(payload)
    raw = np.empty(2 * len(iq), np.int16)
    raw[0::2] = np.round(iq.real * 2048.0).astype(np.int16)
    raw[1::2] = np.round(iq.imag * 2048.0).astype(np.int16)

    def request():
        return rx_request(
            rx_sampling_freq=576000,
            demod_baud_rate=9600,
            demod_decimation=6,
            fsk_settings=wire.FskDemodulationSettings(
                demod_fsk_deviation=5000,
                demod_fsk_transition_width=2000,
                demod_fsk_use_dc_block=False,
            ),
        )

    async def body():
        lib = MockIioLib(rx_data=raw)
        config = make_config(tmp_path, rx_sdr_type=RxSdrType.PLUTOSDR, iio_lib=lib)
        server = SdrModemServer(config)
        await server.start()

        rx = await ModemClient.connect("127.0.0.1", server.port)
        resp = await rx.rx_request(request())
        assert resp.status == wire.ResponseStatus.SUCCESS

        # single-pluto-RX enforcement while the first session is live
        rx2 = await ModemClient.connect("127.0.0.1", server.port)
        resp2 = await rx2.rx_request(request())
        assert resp2.status == wire.ResponseStatus.FAILURE
        assert resp2.details == wire.ResponseDetails.RX_IS_BEING_USED
        rx2.close()

        n_bits = len(payload) * 8
        data = await rx.read_stream(n_bits - 32)
        soft = np.frombuffer(data, dtype=np.int8)
        bits_tx = np.unpackbits(np.frombuffer(payload, np.uint8)).astype(np.int8) * 2 - 1
        hard = np.sign(soft).astype(np.int8)
        best = 0.0
        for off in range(0, 64):
            n = min(len(hard) - off, len(bits_tx))
            best = max(best, float((hard[off : off + n] == bits_tx[:n]).mean()))
        assert best > 0.995, f"pluto rx BER {1-best:.4f}"
        # TX LO was powered down for RX sensitivity (plutosdr.c:251-258)
        assert any(
            "powerdown" in str(k) and v for k, v in lib.attrs.items()
        )
        await rx.shutdown()
        await asyncio.sleep(0.3)
        rx.close()

        # after teardown the pluto RX slot frees up
        lib2 = MockIioLib(rx_data=raw)
        server.config.iio_lib = lib2
        rx3 = await ModemClient.connect("127.0.0.1", server.port)
        resp3 = await rx3.rx_request(request())
        assert resp3.status == wire.ResponseStatus.SUCCESS
        await rx3.shutdown()
        rx3.close()
        await server.stop()

    run(body())


def test_tx_pipelined_coalescing_matches_sequential(tmp_path):
    """A pipelining client (several TX_DATA frames in flight before reading
    ACKs) gets every ACK in order, the modulated stream matches
    one-message-at-a-time processing within float tolerance, and the server
    actually coalesced the burst into fewer device dispatches.  The carried
    modulator state makes any chunking of the stream equivalent up to f32
    phase-prefix rounding (~1e-5 rad; the reference's own complex golden
    tolerance is 0.01, test/utils.c:134-140); the reference processes
    per-message synchronously (src/tcp_server.c:176-241)."""
    rng = np.random.default_rng(7)
    payloads = [rng.integers(0, 256, 512, dtype=np.uint8).tobytes() for _ in range(6)]

    async def run_tx(fname, pipelined):
        config = make_config(tmp_path, tx_sdr_type=TxSdrType.FILE)
        server = SdrModemServer(config)
        await server.start()
        tx = await ModemClient.connect("127.0.0.1", server.port)
        resp = await tx.tx_request(
            wire.TxRequest(
                tx_center_freq=437525000,
                tx_sampling_freq=48000,
                tx_offset=0,
                mod_type=wire.ModemType.GMSK,
                mod_baud_rate=9600,
                fsk_settings=wire.FskModulationSettings(mod_fsk_deviation=5000),
                file_settings=wire.FileSettings(filename=str(fname)),
            )
        )
        assert resp.status == wire.ResponseStatus.SUCCESS
        if pipelined:
            for p in payloads:
                await tx._send(wire.MsgType.TX_DATA, wire.TxData(data=p).encode())
            for _ in payloads:
                ack = await tx.read_response()
                assert ack.status == wire.ResponseStatus.SUCCESS
        else:
            for p in payloads:
                ack = await tx.tx_data(p)
                assert ack.status == wire.ResponseStatus.SUCCESS
        await tx.shutdown()
        await asyncio.sleep(0.2)
        tx.close()
        await server.stop()
        return server

    async def body():
        seq_file = tmp_path / "seq.cf32"
        pipe_file = tmp_path / "pipe.cf32"
        server_seq = await run_tx(seq_file, pipelined=False)
        assert server_seq.tx_msgs_coalesced == len(payloads)
        server_pipe = await run_tx(pipe_file, pipelined=True)
        assert server_pipe.tx_msgs_coalesced == len(payloads)
        # the pipelined burst must actually coalesce into fewer dispatches
        assert server_pipe.tx_bursts < len(payloads)
        seq = np.frombuffer(seq_file.read_bytes(), np.complex64)
        pipe = np.frombuffer(pipe_file.read_bytes(), np.complex64)
        assert len(seq) == len(pipe) == sum(len(p) for p in payloads) * 8 * 5
        # f32 phase-prefix rounding accumulates along the stream
        # (~2e-4 here); the reference's complex golden tolerance is 0.01
        assert np.abs(seq - pipe).max() < 0.01

    run(body())


def test_tx_busy(tmp_path):
    async def body():
        config = make_config(tmp_path, tx_sdr_type=TxSdrType.FILE)
        server = SdrModemServer(config)
        await server.start()
        req = wire.TxRequest(
            tx_center_freq=437525000,
            tx_sampling_freq=48000,
            mod_type=wire.ModemType.GMSK,
            mod_baud_rate=9600,
            fsk_settings=wire.FskModulationSettings(mod_fsk_deviation=5000),
            file_settings=wire.FileSettings(filename=str(tmp_path / "a.cf32")),
        )
        c1 = await ModemClient.connect("127.0.0.1", server.port)
        r1 = await c1.tx_request(req)
        assert r1.status == wire.ResponseStatus.SUCCESS
        c2 = await ModemClient.connect("127.0.0.1", server.port)
        r2 = await c2.tx_request(req)
        assert r2.status == wire.ResponseStatus.FAILURE
        assert r2.details == wire.ResponseDetails.TX_IS_BEING_USED
        await c1.shutdown()
        c1.close()
        c2.close()
        await server.stop()

    run(body())


def test_tx_not_supported(tmp_path):
    async def body():
        server = SdrModemServer(make_config(tmp_path, tx_sdr_type=TxSdrType.NONE))
        await server.start()
        c = await ModemClient.connect("127.0.0.1", server.port)
        r = await c.tx_request(
            wire.TxRequest(
                tx_center_freq=1, tx_sampling_freq=1, mod_type=wire.ModemType.GMSK,
                mod_baud_rate=1, fsk_settings=wire.FskModulationSettings(1),
            )
        )
        assert r.status == wire.ResponseStatus.FAILURE
        assert r.details == wire.ResponseDetails.INVALID_REQUEST
        c.close()
        await server.stop()

    run(body())


def test_rx_invalid_basepath_internal_error(tmp_path):
    """Dump file cannot be opened -> INTERNAL_ERROR (test_dsp_worker.c
    test_invalid_basepath analog)."""

    async def body():
        config = make_config(tmp_path)
        config.base_path = str(tmp_path / "does" / "not" / "exist")
        server = SdrModemServer(config)
        await server.start()
        c = await ModemClient.connect("127.0.0.1", server.port)
        r = await c.rx_request(rx_request(rx_dump_file=True))
        assert r.status == wire.ResponseStatus.FAILURE
        assert r.details == wire.ResponseDetails.INTERNAL_ERROR
        c.close()
        await server.stop()

    run(body())


def test_rx_bad_tle_internal_error(tmp_path):
    """Three TLE lines that fail the checksum -> INTERNAL_ERROR
    (test_dsp_worker.c test_invalid_doppler_configuration analog)."""

    async def body():
        server = SdrModemServer(make_config(tmp_path))
        await server.start()
        c = await ModemClient.connect("127.0.0.1", server.port)
        r = await c.rx_request(
            rx_request(
                doppler=wire.DopplerSettings(
                    tle=["SAT", "1 garbage", "2 garbage"],
                    latitude=537200000, longitude=475700000, altitude=0,
                )
            )
        )
        assert r.status == wire.ResponseStatus.FAILURE
        assert r.details == wire.ResponseDetails.INTERNAL_ERROR
        c.close()
        await server.stop()

    run(body())


def test_rx_invalid_fsk_params_internal_error(tmp_path):
    """FSK parameters that fail filter design (cutoff beyond Nyquist)
    -> INTERNAL_ERROR (test_dsp_worker.c test_invalid_fsk_configuration)."""

    async def body():
        server = SdrModemServer(make_config(tmp_path))
        await server.start()
        c = await ModemClient.connect("127.0.0.1", server.port)
        r = await c.rx_request(
            rx_request(
                rx_sampling_freq=8000,
                fsk_settings=wire.FskDemodulationSettings(
                    demod_fsk_deviation=50000,  # Carson cutoff >> Fs/2
                    demod_fsk_transition_width=2000,
                    demod_fsk_use_dc_block=True,
                ),
            )
        )
        assert r.status == wire.ResponseStatus.FAILURE
        assert r.details == wire.ResponseDetails.INTERNAL_ERROR
        c.close()
        await server.stop()

    run(body())


def test_fast_lane_attach_race_gets_fresh_state(tmp_path):
    """A client attaching while a batched step is in flight must start
    from ZERO history: attach() queues the lane reset and _step_block
    applies it before the next step.  (An immediate reset would be
    overwritten when the in-flight step's returning state is assigned,
    silently handing the new client the previous occupant's filter and
    clock history.)"""
    import threading

    import jax

    from sdrmodem.dsp.fsk_demod import FskDemodConfig
    from sdrmodem.server.session import BatchedRxGroup

    class Stub:
        doppler = None
        samples_in = 0
        group = None
        lane = -1

        def __init__(self):
            self.finished = asyncio.Event()

        def note_progress(self, n):
            self.samples_in += n

        async def emit(self, symbols):
            pass

    async def body():
        cfg = FskDemodConfig(48000, 4800, 5000, 2, 2000, True)
        group = BatchedRxGroup(cfg, 2048)
        a = Stub()
        group.attach(a)
        assert a.lane == 0

        entered, release = threading.Event(), threading.Event()
        captured = []
        orig = group._step_host

        def slow_step(x, dop):
            captured.append(jax.tree.map(np.asarray, group.state))
            entered.set()
            release.wait(60)
            return orig(x, dop)

        group._step_host = slow_step
        rng = np.random.default_rng(0)
        buf = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)).astype(
            np.complex64
        )
        # feed() returns as soon as the block is queued (ingest/compute
        # overlap); the worker task runs the step
        await group.feed(buf)
        await asyncio.to_thread(entered.wait, 60)
        # step 1 in flight: occupant leaves, new client takes the lane
        group.detach(a)
        b = Stub()
        group.attach(b)
        assert b.lane == 0
        release.set()
        await _drain(group, 1)
        assert 0 in group._pending_resets  # reset survives the step return

        await group.feed(buf)  # step 2: b's first step
        await _drain(group, 2)
        state_seen = captured[1]
        cp = state_seen.quad_prev.shape[1] // 2
        # lane 0 must be zero history in every leaf (fresh dsp_worker)
        assert not state_seen.lpf1_hist[:, 0].any()
        assert not state_seen.lpf1_hist[:, cp].any()  # Q half
        assert not state_seen.clock.suffix[:, 0].any()
        assert state_seen.clock.resid[0] == 0
        # ...while the signal left real history in step 1's returning state
        # fanout layout: unoccupied lanes ride the same broadcast stream
        # (their output is ignored; state is reset on attach) — every
        # empty lane's history is identical
        np.testing.assert_array_equal(
            np.asarray(group.state.lpf1_hist[:, 1]),
            np.asarray(group.state.lpf1_hist[:, 2]),
        )
        assert np.asarray(group.state.lpf1_hist[:, 1] != 0).any()
        await group.close()

    run(body())


async def _drain(group, n, timeout=60.0):
    """Wait until the group's worker has processed >= n blocks."""
    import time as _time

    t0 = _time.monotonic()
    while group.blocks_processed < n:
        assert _time.monotonic() - t0 < timeout, "group worker stalled"
        await asyncio.sleep(0.01)


def test_group_ingest_overlaps_device_step(tmp_path):
    """VERDICT item: the SDR reader must never wait on the demodulator.
    With the step artificially stalled, feed() keeps accepting blocks
    (lossy mode) and the bounded queue drops instead of blocking —
    reference src/queue.c:124-128, 168-200."""
    import threading

    from sdrmodem.dsp.fsk_demod import FskDemodConfig
    from sdrmodem.server.session import BatchedRxGroup

    class Stub:
        doppler = None
        samples_in = 0
        group = None
        lane = -1

        def __init__(self):
            self.finished = asyncio.Event()
            self.emitted = []

        def note_progress(self, n):
            self.samples_in += n

        async def emit(self, symbols):
            self.emitted.append(np.asarray(symbols))

    async def body():
        cfg = FskDemodConfig(48000, 4800, 5000, 2, 2000, True)
        group = BatchedRxGroup(cfg, 2048, queue_capacity=2)  # lossy (live-SDR policy)
        s = Stub()
        group.attach(s)

        entered, release = threading.Event(), threading.Event()
        orig = group._step_host

        def slow_step(x, dop):
            entered.set()
            release.wait(60)
            return orig(x, dop)

        group._step_host = slow_step
        rng = np.random.default_rng(1)
        buf = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)).astype(
            np.complex64
        )
        # first block enters the (stalled) step
        await group.feed(buf)
        await asyncio.to_thread(entered.wait, 60)
        # while the step is stalled, the reader can keep feeding: these
        # must return promptly (copy + enqueue), never await the step
        import time as _time

        t0 = _time.monotonic()
        for _ in range(4):  # capacity 2 -> the extras hit the lossy drop
            await group.feed(buf)
        assert _time.monotonic() - t0 < 5.0  # step stall is 60 s
        assert group.queue.dropped >= 2  # bounded queue dropped, not blocked
        release.set()
        # worker drains what the queue kept: 1 in-flight + 2 queued
        await _drain(group, 3)
        assert group.blocks_processed == 3
        assert s.samples_in == 3 * 2048
        await group.close()

    run(body())


def test_group_blocking_mode_backpressures_file_reader(tmp_path):
    """File sources must not drop: with the queue full and the step
    stalled, feed() blocks until the worker frees space (the reference's
    blocking queue, src/dsp_worker.c:176-179)."""
    import threading

    from sdrmodem.dsp.fsk_demod import FskDemodConfig
    from sdrmodem.server.session import BatchedRxGroup

    class Stub:
        doppler = None
        samples_in = 0
        group = None
        lane = -1

        def __init__(self):
            self.finished = asyncio.Event()

        def note_progress(self, n):
            self.samples_in += n

        async def emit(self, symbols):
            pass

    async def body():
        cfg = FskDemodConfig(48000, 4800, 5000, 2, 2000, True)
        group = BatchedRxGroup(cfg, 2048, blocking=True, queue_capacity=2)
        s = Stub()
        group.attach(s)

        entered, release = threading.Event(), threading.Event()
        orig = group._step_host

        def slow_step(x, dop):
            entered.set()
            release.wait(60)
            return orig(x, dop)

        group._step_host = slow_step
        rng = np.random.default_rng(2)
        buf = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)).astype(
            np.complex64
        )
        await group.feed(buf)  # enters the stalled step
        await asyncio.to_thread(entered.wait, 60)
        await group.feed(buf)  # queue slot 1
        await group.feed(buf)  # queue slot 2 (capacity 2)
        blocked = asyncio.create_task(group.feed(buf))  # must back-pressure
        await asyncio.sleep(0.2)
        assert not blocked.done()  # reader is held, nothing dropped
        release.set()
        await blocked
        await _drain(group, 4)
        assert group.queue.dropped == 0
        assert s.samples_in == 4 * 2048
        await group.close()

    run(body())


def test_fast_emit_after_stop_is_noop(tmp_path):
    """stop()/stream-death closes a fast lane's writers; an in-flight step
    that snapshotted the lane must emit into a no-op, not a ValueError
    that would kill the stream reader for every client."""
    from sdrmodem.server.session import RxSession

    async def body():
        cfg = make_config(tmp_path, demod_mode="fast")
        req = rx_request(demod_destination=wire.DemodDestination.BOTH)
        s = RxSession(7, req, cfg, writer=None)
        await s.emit(np.ones(8, np.int8))
        assert s.symbols_out == 8
        s.finish_fast()
        s.finish_fast()  # idempotent
        await s.emit(np.ones(8, np.int8))  # closed writers: must not raise
        assert s.symbols_out == 8

    run(body())


def test_rx_stream_demod_fast_mode(tmp_path, resources_dir):
    """demod_mode = fast: clients on one SDR stream are lanes of a single
    batched full-block Pallas step.  Two clients receive the same symbol
    stream; output matches the golden within the reference's +-2 policy."""
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:24576]
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)

    async def body():
        mock = MockSdrServer()
        ss_port = await mock.start()
        config = make_config(
            tmp_path,
            rx_sdr_type=RxSdrType.SDR_SERVER,
            rx_sdr_server_port=ss_port,
            demod_mode="fast",
        )
        server = SdrModemServer(config)
        await server.start()

        c1 = await ModemClient.connect("127.0.0.1", server.port)
        resp1 = await c1.rx_request(rx_request())
        assert resp1.status == wire.ResponseStatus.SUCCESS
        c2 = await ModemClient.connect("127.0.0.1", server.port)
        resp2 = await c2.rx_request(rx_request())
        assert resp2.status == wire.ResponseStatus.SUCCESS
        await mock.wait_client()
        assert len(mock.requests) == 1  # shared sdr connection

        await mock.send_iq(iq)
        # 24576 samples = 6 full 4096-sample blocks -> ~2400 symbols
        expected = 2300
        # first step includes the jit compile of the batched
        # program — allow well past the helper's default 10 s
        d1 = np.frombuffer(await c1.read_stream(expected, timeout=90), dtype=np.int8)
        d2 = np.frombuffer(await c2.read_stream(expected, timeout=90), dtype=np.int8)
        np.testing.assert_array_equal(d1, d2)
        diff = np.abs(d1.astype(np.int32) - golden[: len(d1)].astype(np.int32))
        assert diff.max() <= 2

        await c1.shutdown()
        await c2.shutdown()
        c1.close()
        c2.close()
        await mock.stop()
        await server.stop()

    run(body())


def test_observability_counters(tmp_path):
    """SURVEY §5: running samples/s log lines and queue-drop counters on
    the session."""
    import logging

    from sdrmodem.utils.queue import BufferQueue

    async def body():
        # lossy queue counts overwrites
        q = BufferQueue(2, blocking=False)
        for k in range(5):
            await q.put(np.zeros(4, np.complex64))
        assert q.dropped == 3

        # session rate logging: force the interval to 0 so one call logs
        from sdrmodem.server import session as session_mod

        req = rx_request()
        cfg = make_config(tmp_path)
        sess = session_mod.RxSession(7, req, cfg, writer=None)
        sess._rate_interval = 0.0
        records = []
        handler = logging.Handler()
        handler.emit = lambda r: records.append(r.getMessage())
        session_mod.log.addHandler(handler)
        old_level = session_mod.log.level
        session_mod.log.setLevel(logging.INFO)
        try:
            sess.note_progress(48000)
            sess.note_progress(48000)
        finally:
            session_mod.log.removeHandler(handler)
            session_mod.log.setLevel(old_level)
        assert sess.samples_in == 96000
        assert any("rx rate" in m and "queue drops" in m for m in records)
        await sess.stop()

    asyncio.run(body())


def test_group_mesh_shards_lanes_over_devices(tmp_path, monkeypatch, resources_dir):
    """SDRM_SERVER_MESH: with >1 device visible the batched step is
    shard_mapped over a channel mesh built from jax.devices() — lanes
    split across chips (128-lane granules), same symbols as unsharded."""
    import jax

    from sdrmodem.dsp.fsk_demod import FskDemodConfig
    from sdrmodem.server.session import BatchedRxGroup

    class Stub:
        doppler = None
        samples_in = 0
        group = None
        lane = -1

        def __init__(self):
            self.finished = asyncio.Event()
            self.emitted = []

        def note_progress(self, n):
            self.samples_in += n

        async def emit(self, symbols):
            self.emitted.append(np.asarray(symbols))

    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:16384]
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)

    async def run_group():
        cfg = FskDemodConfig(48000, 4800, 5000, 2, 2000, True)
        group = BatchedRxGroup(cfg, 8192, queue_capacity=4)
        s = Stub()
        group.attach(s)
        await group.feed(iq)
        await _drain(group, 2)
        await group.close()
        return np.concatenate(s.emitted)

    monkeypatch.setattr(BatchedRxGroup, "LANES", 256)
    monkeypatch.setenv("SDRM_SERVER_MESH", "1")
    assert len(jax.devices()) >= 2
    sharded = run(run_group())

    monkeypatch.setenv("SDRM_SERVER_MESH", "0")
    plain = run(run_group())

    assert len(sharded) == len(plain)
    d = np.abs(sharded.astype(np.int32) - plain.astype(np.int32))
    assert d.max() <= 2 and (d > 0).mean() < 0.01
    dg = np.abs(sharded.astype(np.int32) - golden[: len(sharded)].astype(np.int32))
    assert dg.max() <= 2


def test_group_cap_demotes_to_standalone(tmp_path, monkeypatch, resources_dir):
    """SDRM_MAX_GROUPS: a fast-mode client whose demod config matches no
    existing group past the cap runs as a standalone ragged lane instead
    of spawning another batched program; both clients still get correct
    symbol streams from the shared SDR connection."""
    monkeypatch.setenv("SDRM_MAX_GROUPS", "1")
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:24576]
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)

    async def body():
        mock = MockSdrServer()
        ss_port = await mock.start()
        config = make_config(
            tmp_path,
            rx_sdr_type=RxSdrType.SDR_SERVER,
            rx_sdr_server_port=ss_port,
            demod_mode="fast",
        )
        server = SdrModemServer(config)
        await server.start()

        c1 = await ModemClient.connect("127.0.0.1", server.port)
        assert (await c1.rx_request(rx_request())).status == wire.ResponseStatus.SUCCESS
        # different transition width -> different demod config -> no group
        # available under the cap -> standalone fallback
        c2 = await ModemClient.connect("127.0.0.1", server.port)
        req2 = rx_request(
            fsk_settings=wire.FskDemodulationSettings(
                demod_fsk_deviation=5000, demod_fsk_transition_width=1000,
                demod_fsk_use_dc_block=True,
            )
        )
        assert (await c2.rx_request(req2)).status == wire.ResponseStatus.SUCCESS
        await mock.wait_client()
        assert len(server.streams) == 1
        stream = server.streams[0]
        assert len(stream.groups) == 1  # cap respected
        modes = sorted(s.mode for s in stream.sessions)
        assert modes == ["fast", "standalone"]

        await mock.send_iq(iq)
        d1 = np.frombuffer(await c1.read_stream(2300, timeout=90), dtype=np.int8)
        d2 = np.frombuffer(await c2.read_stream(2300, timeout=90), dtype=np.int8)
        diff1 = np.abs(d1.astype(np.int32) - golden[: len(d1)].astype(np.int32))
        assert diff1.max() <= 2
        # the standalone client demodulates with its own (different-
        # transition-width) filter; just require a sane soft stream
        assert np.abs(d2.astype(np.int32)).max() > 20

        await c1.shutdown()
        await c2.shutdown()
        c1.close()
        c2.close()
        await mock.stop()
        await server.stop()

    run(body())
