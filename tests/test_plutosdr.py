"""PlutoSDR driver tests with an in-memory iio mock
(analog of reference test/iio_lib_mock.c + test/test_plutosdr.c)."""

import asyncio

import numpy as np
import pytest

from sdrmodem.devices.iio_lib import IioError, IioLib
from sdrmodem.devices.plutosdr import (
    FIR_128_2,
    FIR_128_4,
    MIN_FIR_FILTER,
    PlutoSdr,
    PlutoSdrError,
    build_fir_config,
    select_fir_config,
)


class MockIioLib(IioLib):
    """Captures every attribute write; serves int16 RX data; records TX."""

    def __init__(self, rx_data: np.ndarray | None = None):
        self.attrs: dict[tuple, object] = {}
        self.raw_attrs: dict[tuple, bytes] = {}
        self.enabled: list[tuple] = []
        self.rx_data = rx_data if rx_data is not None else np.zeros(0, np.int16)
        self.rx_pos = 0
        self.tx_pushed: list[bytes] = []
        self.fail_push = False
        self.fail_refill = False

    def create_context(self):
        return "ctx"

    def destroy_context(self, ctx):
        pass

    def find_device(self, ctx, name):
        return ("dev", name)

    def find_channel(self, device, name, output):
        return ("chn", device[1], name, output)

    def channel_attr_write(self, channel, attr, value):
        self.attrs[(channel, attr)] = value
        return len(value)

    def channel_attr_write_longlong(self, channel, attr, value):
        self.attrs[(channel, attr)] = value
        return 0

    def channel_attr_write_double(self, channel, attr, value):
        self.attrs[(channel, attr)] = value
        return 0

    def channel_attr_write_bool(self, channel, attr, value):
        self.attrs[(channel, attr)] = value
        return 0

    def device_attr_write_bool(self, device, attr, value):
        self.attrs[(device, attr)] = value
        return 0

    def device_attr_write_raw(self, device, attr, data):
        self.raw_attrs[(device, attr)] = data
        return len(data)

    def channel_enable(self, channel):
        self.enabled.append(channel)

    def create_buffer(self, device, samples_count, cyclic):
        return ("buf", device[1], samples_count)

    def destroy_buffer(self, buffer):
        pass

    def buffer_refill(self, buffer):
        if self.fail_refill:
            raise IioError("refill failed")
        n = buffer[2] * 2  # int16 I+Q per sample
        chunk = self.rx_data[self.rx_pos : self.rx_pos + n]
        self.rx_pos += n
        return chunk.tobytes()

    def buffer_push(self, buffer, data):
        if self.fail_push:
            return -5
        self.tx_pushed.append(data)
        return len(data) // 4

    def set_timeout(self, ctx, timeout_millis):
        self.attrs[("ctx", "timeout")] = timeout_millis
        return 0


def test_select_fir_config_thresholds():
    assert select_fir_config(None) == (0, None)
    assert select_fir_config(2083334)[0] == 0
    assert select_fir_config(2083333)[0] == 2
    assert select_fir_config(1041666)[0] == 4
    with pytest.raises(PlutoSdrError):
        select_fir_config(MIN_FIR_FILTER - 1)


def test_build_fir_config_format():
    cfg = build_fir_config(select_fir_config(528000), (0, None)).decode()
    lines = cfg.splitlines()
    assert lines[0] == "RX 3 GAIN -6 DEC 4"
    assert lines[1] == "TX 3 GAIN 0 INT 4"
    coeff_rows = [ln for ln in lines[2:] if ln]
    assert len(coeff_rows) == 128  # 128 "tx,rx" coefficient rows
    assert all("," in ln for ln in coeff_rows)


def test_fir_blob_matches_adi_hardware_tables():
    """The rendered filter_fir_config carries the ADI coefficient tables
    verbatim (reference src/sdr/plutosdr.c:19-30): a Pluto programmed by
    this server gets the same analog-chain response as the reference."""
    for rate, table in ((528000, FIR_128_4), (1200000, FIR_128_2)):
        blob = build_fir_config(select_fir_config(rate), (0, None)).decode()
        rows = [ln for ln in blob.splitlines()[2:] if ln]
        tx = np.array([int(r.split(",")[0]) for r in rows], np.int16)
        rx = np.array([int(r.split(",")[1]) for r in rows], np.int16)
        np.testing.assert_array_equal(rx, table)
        np.testing.assert_array_equal(tx, table)  # tx side mirrors rx when absent
    # structural invariants of the hardware tables themselves
    assert FIR_128_2[63] == 32767 and FIR_128_4[63] == FIR_128_4[64] == 15921
    np.testing.assert_array_equal(FIR_128_2[1:63:2], np.zeros(31))  # half-band zeros
    np.testing.assert_array_equal(FIR_128_4, FIR_128_4[::-1])  # linear phase


def test_rx_configuration_and_conversion():
    # 48 kHz requires... below min rate -> use 2.1 MHz (no FIR needed)
    raw = (np.arange(-8, 8, dtype=np.int16) * 256).astype(np.int16)
    lib = MockIioLib(rx_data=raw)
    dev = PlutoSdr.create_rx(
        sampling_freq=2100000, center_freq=437525000, gain=30.0,
        timeout_millis=10000, buffer_size=4, power_down_tx=True, lib=lib,
    )
    phy_rx = ("chn", "ad9361-phy", "voltage0", False)
    assert lib.attrs[(phy_rx, "sampling_frequency")] == 2100000
    assert lib.attrs[(phy_rx, "gain_control_mode")] == "manual"
    assert lib.attrs[(phy_rx, "hardwaregain")] == 30.0
    lo = ("chn", "ad9361-phy", "altvoltage0", True)
    assert lib.attrs[(lo, "frequency")] == 437525000
    # rx-only mode powers down TX LO (plutosdr.c:251-258)
    tx_lo = ("chn", "ad9361-phy", "altvoltage1", True)
    assert lib.attrs[(tx_lo, "powerdown")] is True

    iq = asyncio.run(dev.read_stream())
    expected = raw[: 2 * len(iq)].astype(np.float32) / 2048.0
    np.testing.assert_allclose(iq.real, expected[0::2], rtol=1e-6)
    np.testing.assert_allclose(iq.imag, expected[1::2], rtol=1e-6)


def test_rx_low_rate_programs_fir():
    lib = MockIioLib()
    PlutoSdr.create_rx(
        sampling_freq=528000, center_freq=100000000, gain=0.0,
        timeout_millis=1000, buffer_size=16, lib=lib,
    )
    phy = ("dev", "ad9361-phy")
    assert (phy, "filter_fir_config") in lib.raw_attrs
    assert lib.attrs[(phy, "in_out_voltage_filter_fir_en")] is True


def test_tx_dds_disable_and_push():
    lib = MockIioLib()
    dev = PlutoSdr.create_tx(
        sampling_freq=2100000, center_freq=437525000, gain=-10.0,
        timeout_millis=1000, buffer_size=64, lib=lib,
    )
    for name in ("TX1_I_F1", "TX1_Q_F1", "TX1_Q_F2", "TX1_I_F2"):
        chn = ("chn", "cf-ad9361-dds-core-lpc", name, True)
        assert lib.attrs[(chn, "raw")] is False

    iq = np.array([0.5 + 0.25j, -1.5 + 0j], np.complex64)  # -1.5 saturates
    asyncio.run(dev.write_stream(iq))
    sent = np.frombuffer(lib.tx_pushed[0], dtype=np.int16)
    np.testing.assert_array_equal(sent, [16384, 8192, -32768, 0])


def test_tx_push_failure_raises():
    lib = MockIioLib()
    lib.fail_push = True
    dev = PlutoSdr.create_tx(
        sampling_freq=2100000, center_freq=437525000, gain=0.0,
        timeout_millis=1000, buffer_size=64, lib=lib,
    )
    with pytest.raises(PlutoSdrError):
        asyncio.run(dev.write_stream(np.ones(4, np.complex64)))


def test_rx_refill_failure_ends_stream():
    lib = MockIioLib()
    lib.fail_refill = True
    dev = PlutoSdr.create_rx(
        sampling_freq=2100000, center_freq=437525000, gain=0.0,
        timeout_millis=1000, buffer_size=16, lib=lib,
    )
    assert asyncio.run(dev.read_stream()) is None
