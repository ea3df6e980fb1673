"""Native host library (C++ conversions + SPSC queue) vs numpy semantics."""

import threading

import numpy as np
import pytest

from sdrmodem.utils import native

RNG = np.random.default_rng(11)

needs_native = pytest.mark.skipif(not native.available(), reason="native lib not built")


@needs_native
def test_int16_float_roundtrip():
    x = RNG.integers(-2048, 2048, 4096).astype(np.int16)
    f = native.int16_to_float(x, 2048.0)
    np.testing.assert_allclose(f, x.astype(np.float32) / 2048.0, rtol=1e-6)
    back = native.float_to_int16(f, 2048.0)
    np.testing.assert_array_equal(back, x)


@needs_native
def test_float_to_int16_saturates():
    x = np.array([2.0, -2.0, 0.5], np.float32)
    out = native.float_to_int16(x, 32768.0)
    np.testing.assert_array_equal(out, [32767, -32768, 16384])


@needs_native
def test_float_to_int8_matches_volk_semantics():
    x = RNG.standard_normal(10000).astype(np.float32)
    got = native.float_to_int8(x, 127.0)
    want = np.round(np.clip(x * np.float32(127.0), -128, 127)).astype(np.int8)
    np.testing.assert_array_equal(got, want)


@needs_native
def test_bytes_to_nrz():
    data = bytes([0b10110001, 0xFF, 0x00])
    out = native.bytes_to_nrz(data)
    want = np.unpackbits(np.frombuffer(data, np.uint8)).astype(np.float32) * 2 - 1
    np.testing.assert_array_equal(out, want)


@needs_native
def test_native_queue_blocking_fifo():
    q = native.NativeQueue(capacity=4, block_bytes=64, blocking=True)
    for i in range(4):
        assert q.put(np.full(8, i, np.uint8))
    got = [q.take() for _ in range(4)]
    assert [g[0] for g in got] == [0, 1, 2, 3]
    q.interrupt()
    assert q.take() is None  # poison pill


@needs_native
def test_native_queue_lossy_overwrites_newest():
    q = native.NativeQueue(capacity=2, block_bytes=16, blocking=False)
    for i in range(5):
        q.put(np.full(4, i, np.uint8))
    assert q.dropped == 3
    a, b = q.take(), q.take()
    # oldest survives; the last slot holds the newest value (queue.c:124-128)
    assert a[0] == 0 and b[0] == 4


@needs_native
def test_native_queue_threaded_producer_consumer():
    q = native.NativeQueue(capacity=8, block_bytes=4096, blocking=True)
    n = 200
    payloads = [RNG.integers(0, 255, 1024).astype(np.uint8) for _ in range(n)]

    def producer():
        for p in payloads:
            q.put(p)
        q.interrupt()

    results = []

    def consumer():
        while True:
            item = q.take()
            if item is None:
                break
            results.append(item)

    t1 = threading.Thread(target=producer)
    t2 = threading.Thread(target=consumer)
    t2.start(); t1.start(); t1.join(); t2.join()
    assert len(results) == n
    for got, want in zip(results, payloads):
        np.testing.assert_array_equal(np.frombuffer(got, np.uint8), want)


class _FakeDevice:
    """Scripted device for the read-ahead wrapper tests."""

    def __init__(self, blocks, lossless):
        self.blocks = list(blocks)
        self.lossless_rx = lossless
        self.closed = False
        self.read_gate = threading.Event()
        self.read_gate.set()

    def read_stream_sync(self):
        self.read_gate.wait()
        if not self.blocks:
            return None
        return self.blocks.pop(0)

    async def write_stream(self, iq):
        raise NotImplementedError

    async def stop_rx(self):
        pass

    async def close(self):
        self.closed = True


@needs_native
def test_native_readahead_blocking_no_drops():
    """Blocking mode (file sources): a slow consumer back-pressures the
    producer thread; every block arrives, in order, no drops
    (reference src/dsp_worker.c:176-179 + src/queue.c blocking put)."""
    import asyncio

    from sdrmodem.devices.native_ingest import NativeReadAhead

    n, blk = 32, 256
    blocks = [
        np.full(blk, i + 1j * i, np.complex64) for i in range(n)
    ]

    async def body():
        dev = _FakeDevice(blocks, lossless=True)
        wrap = NativeReadAhead(dev, blk, capacity=3)
        got = []
        while True:
            buf = await wrap.read_stream()
            await asyncio.sleep(0.002)  # slow consumer
            if buf is None:
                break
            got.append(buf)
        assert wrap.dropped == 0
        assert len(got) == n
        for i, b in enumerate(got):
            np.testing.assert_array_equal(b, np.full(blk, i + 1j * i, np.complex64))
        await wrap.close()
        assert dev.closed

    async def with_stop():
        # EOF must hold until stop_rx (file_source.c:109-117): run body
        # with a watchdog that releases the EOF hold
        task = asyncio.ensure_future(body())
        await task

    # the EOF hold blocks read_stream until stop_rx; emulate the server's
    # teardown by stopping after the drain
    async def run():
        dev = _FakeDevice(blocks, lossless=True)
        wrap = NativeReadAhead(dev, blk, capacity=3)
        got = []
        for _ in range(n):
            buf = await wrap.read_stream()
            await asyncio.sleep(0.001)
            assert buf is not None
            got.append(buf)
        # next read would hit the EOF hold: release it like a disconnect
        hold = asyncio.ensure_future(wrap.read_stream())
        await asyncio.sleep(0.05)
        assert not hold.done(), "EOF must hold the session open"
        await wrap.stop_rx()
        assert await hold is None
        assert wrap.dropped == 0
        assert len(got) == n
        for i, b in enumerate(got):
            np.testing.assert_array_equal(b, np.full(blk, i + 1j * i, np.complex64))
        await wrap.close()

    asyncio.run(asyncio.wait_for(run(), 30))


@needs_native
def test_native_readahead_lossy_drops_and_counts():
    """Lossy mode (live SDRs): a stalled consumer drops newest blocks
    with a surfaced counter instead of back-pressuring the radio
    (reference src/queue.c:124-128)."""
    import asyncio

    from sdrmodem.devices.native_ingest import NativeReadAhead

    n, blk = 64, 256
    blocks = [np.full(blk, i, np.complex64) for i in range(n)]

    async def run():
        dev = _FakeDevice(blocks, lossless=False)
        wrap = NativeReadAhead(dev, blk, capacity=4)
        # let the producer run far ahead of any consumption
        for _ in range(200):
            if wrap.dropped > 0 and not dev.blocks:
                break
            await asyncio.sleep(0.01)
        assert wrap.dropped > 0
        got = []
        while True:
            buf = await wrap.read_stream()
            if buf is None:
                break
            got.append(int(buf[0].real))
        # at most capacity survive, in order, ending with the newest write
        assert 0 < len(got) <= 4
        assert got == sorted(got)
        assert got[-1] == n - 1
        await wrap.stop_rx()
        await wrap.close()

    asyncio.run(asyncio.wait_for(run(), 30))


@needs_native
def test_server_file_rx_uses_native_ingest(tmp_path):
    """End-to-end: a file RX session through the real server rides the
    native ring (SDRM_NATIVE_INGEST default-on) and still matches the
    golden demod output."""
    import asyncio
    import pathlib

    from sdrmodem.server import wire
    from sdrmodem.server.config import RxSdrType
    from sdrmodem.server.tcp_server import SdrModemServer

    from tests.server_helpers import ModemClient
    from tests.test_server import make_config, rx_request

    fixtures = pathlib.Path(__file__).resolve().parent / "fixtures"
    src = fixtures / "lucky7.expected.cf32"
    golden = np.fromfile(fixtures / "lucky7.expected.s8", np.int8)

    async def run():
        config = make_config(tmp_path, rx_sdr_type=RxSdrType.FILE)
        server = SdrModemServer(config)
        await server.start()
        rx = await ModemClient.connect("127.0.0.1", server.port)
        resp = await rx.rx_request(
            rx_request(file_settings=wire.FileSettings(filename=str(src)))
        )
        assert resp.status == wire.ResponseStatus.SUCCESS
        # the stream object must be the native wrapper
        from sdrmodem.devices.native_ingest import NativeReadAhead

        assert any(
            isinstance(s.device, NativeReadAhead) for s in server.streams
        ), "file RX did not ride the native ring"
        data = await rx.read_stream(len(golden), timeout=60)
        got = np.frombuffer(data, np.int8)
        diff = np.abs(got.astype(np.int32) - golden.astype(np.int32))
        assert diff.max() <= 2
        await rx.shutdown()
        rx.close()
        await server.stop()

    asyncio.run(asyncio.wait_for(run(), 120))
