"""PlutoSDR (AD9361) device via the libiio seam.

Behavioural equivalent of reference src/sdr/plutosdr.c:16-633:

- stream configuration: LO frequency, rf_bandwidth, sampling_frequency,
  manual hardwaregain on the phy channels; DDS tone disable on TX;
  RX-only mode powers down the TX LO for sensitivity (:251-258).
- FIR decimation programming for low sample rates: rates below
  25 MHz/12 (+1) need the AD936x FIR block at DEC/INT 2 or 4 with a
  128-tap filter (:16-30, :310-407).  The coefficient tables are the
  ADI hardware-configuration constants verbatim (fir_128_4 / fir_128_2,
  src/sdr/plutosdr.c:19-30) — device register data, not code: a Pluto
  configured by this server gets the exact same analog-chain response
  as one configured by the reference.
- RX: buffer refill -> int16 -> float32 / 2048 (12-bit ADC, :99-133);
  TX: float32 * 32768 -> int16 push (:63-97).

The libiio binding is injectable (tests use an in-memory mock, the
analog of test/iio_lib_mock.c).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

import numpy as np

from sdrmodem.devices.base import SdrDevice
from sdrmodem.devices.iio_lib import CtypesIioLib, IioError, IioLib
from sdrmodem.utils import native

MIN_NO_FIR_FILTER = 2083334  # 25e6/12 + 1
MIN_FIR_FILTER_2 = 1041667  # MIN_NO_FIR_FILTER / 2
MIN_FIR_FILTER = 520834  # MIN_NO_FIR_FILTER / 4 + 1


class PlutoSdrError(RuntimeError):
    pass


# ADI AD936x FIR coefficient tables (hardware register constants;
# reference src/sdr/plutosdr.c:19-24 fir_128_4 and :26-30 fir_128_2).
FIR_128_4 = np.array([
    -15, -27, -23, -6, 17, 33, 31, 9, -23, -47, -45, -13, 34, 69, 67, 21,
    -49, -102, -99, -32, 69, 146, 143, 48, -96, -204, -200, -69, 129, 278,
    275, 97, -170, -372, -371, -135, 222, 494, 497, 187, -288, -654, -665,
    -258, 376, 875, 902, 363, -500, -1201, -1265, -530, 699, 1748, 1906,
    845, -1089, -2922, -3424, -1697, 2326, 7714, 12821, 15921, 15921,
    12821, 7714, 2326, -1697, -3424, -2922, -1089, 845, 1906, 1748, 699,
    -530, -1265, -1201, -500, 363, 902, 875, 376, -258, -665, -654, -288,
    187, 497, 494, 222, -135, -371, -372, -170, 97, 275, 278, 129, -69,
    -200, -204, -96, 48, 143, 146, 69, -32, -99, -102, -49, 21, 67, 69,
    34, -13, -45, -47, -23, 9, 31, 33, 17, -6, -23, -27, -15,
], dtype=np.int16)

FIR_128_2 = np.array([
    0, 0, 1, 0, -2, 0, 3, 0, -5, 0, 8, 0, -11, 0, 17, 0, -24, 0, 33, 0,
    -45, 0, 61, 0, -80, 0, 104, 0, -134, 0, 169, 0, -213, 0, 264, 0,
    -327, 0, 401, 0, -489, 0, 595, 0, -724, 0, 880, 0, -1075, 0, 1323, 0,
    -1652, 0, 2114, 0, -2819, 0, 4056, 0, -6883, 0, 20837, 32767, 20837,
    0, -6883, 0, 4056, 0, -2819, 0, 2114, 0, -1652, 0, 1323, 0, -1075, 0,
    880, 0, -724, 0, 595, 0, -489, 0, 401, 0, -327, 0, 264, 0, -213, 0,
    169, 0, -134, 0, 104, 0, -80, 0, 61, 0, -45, 0, 33, 0, -24, 0, 17, 0,
    -11, 0, 8, 0, -5, 0, 3, 0, -2, 0, 1, 0, 0, 0,
], dtype=np.int16)


def _fir_taps(factor: int) -> np.ndarray:
    """128-tap int16 table for the AD936x FIR block at DEC/INT ``factor``
    — the ADI hardware constants, not a regenerated design."""
    return FIR_128_4 if factor == 4 else FIR_128_2


def select_fir_config(sampling_freq: int | None) -> tuple[int, np.ndarray | None]:
    """(decimation, taps) for a requested rate; raises when rate too low
    (plutosdr_select_fir_filter_config, :310-328)."""
    if sampling_freq is None:
        return 0, None
    if sampling_freq < MIN_FIR_FILTER:
        raise PlutoSdrError(f"sampling freq is too low: {sampling_freq}")
    if sampling_freq < MIN_FIR_FILTER_2:
        return 4, _fir_taps(4)
    if sampling_freq < MIN_NO_FIR_FILTER:
        return 2, _fir_taps(2)
    return 0, None


def build_fir_config(
    rx: tuple[int, np.ndarray | None], tx: tuple[int, np.ndarray | None]
) -> bytes | None:
    """Render the filter_fir_config blob (plutosdr_setup_fir_filter :368-395)."""
    rx_dec, rx_taps = rx
    tx_dec, tx_taps = tx
    if rx_taps is None and tx_taps is None:
        return None
    if rx_taps is None:
        rx_dec, rx_taps = tx_dec, tx_taps
    if tx_taps is None:
        tx_dec, tx_taps = rx_dec, rx_taps
    lines = []
    if rx_dec > 0:
        lines.append(f"RX 3 GAIN -6 DEC {rx_dec}")
    if tx_dec > 0:
        lines.append(f"TX 3 GAIN 0 INT {tx_dec}")
    lines += [f"{int(t)},{int(r)}" for t, r in zip(tx_taps, rx_taps)]
    return ("\n".join(lines) + "\n\n").encode()


@dataclass
class StreamCfg:
    sampling_freq: int
    center_freq: int
    manual_gain: float


class PlutoSdr(SdrDevice):
    def __init__(self, lib: IioLib, ctx, buffer_size: int):
        self.lib = lib
        self.ctx = ctx
        self.buffer_size = buffer_size
        self.rx_buffer = None
        self.tx_buffer = None
        self._running = True

    # ------------------------------------------------------------------
    @classmethod
    def create_rx(
        cls,
        sampling_freq: int,
        center_freq: int,
        gain: float,
        timeout_millis: int,
        buffer_size: int,
        power_down_tx: bool = True,
        lib: IioLib | None = None,
    ) -> "PlutoSdr":
        lib = lib or CtypesIioLib()
        try:
            ctx = lib.create_context()
            dev = cls(lib, ctx, buffer_size)
            lib.set_timeout(ctx, timeout_millis)
            dev._setup_fir(rx_rate=sampling_freq, tx_rate=None)
            dev._configure("rx", StreamCfg(sampling_freq, center_freq, gain), power_down_tx)
            rx_dev = lib.find_device(ctx, "cf-ad9361-lpc")
            lib.channel_enable(lib.find_channel(rx_dev, "voltage0", False))
            lib.channel_enable(lib.find_channel(rx_dev, "voltage1", False))
            dev.rx_buffer = lib.create_buffer(rx_dev, buffer_size, False)
            return dev
        except IioError as e:
            raise PlutoSdrError(str(e)) from None

    @classmethod
    def create_tx(
        cls,
        sampling_freq: int,
        center_freq: int,
        gain: float,
        timeout_millis: int,
        buffer_size: int,
        lib: IioLib | None = None,
    ) -> "PlutoSdr":
        lib = lib or CtypesIioLib()
        try:
            ctx = lib.create_context()
            dev = cls(lib, ctx, buffer_size)
            lib.set_timeout(ctx, timeout_millis)
            dev._setup_fir(rx_rate=None, tx_rate=sampling_freq)
            dev._disable_dds()
            dev._configure("tx", StreamCfg(sampling_freq, center_freq, gain), False)
            tx_dev = lib.find_device(ctx, "cf-ad9361-dds-core-lpc")
            lib.channel_enable(lib.find_channel(tx_dev, "voltage0", True))
            lib.channel_enable(lib.find_channel(tx_dev, "voltage1", True))
            dev.tx_buffer = lib.create_buffer(tx_dev, buffer_size, False)
            return dev
        except IioError as e:
            raise PlutoSdrError(str(e)) from None

    # ------------------------------------------------------------------
    def _setup_fir(self, rx_rate: int | None, tx_rate: int | None):
        lib = self.lib
        phy = lib.find_device(self.ctx, "ad9361-phy")
        cfg = build_fir_config(select_fir_config(rx_rate), select_fir_config(tx_rate))
        if cfg is None:
            # bump rates so the FIR can be disabled without error (:346-366)
            for name, out in (("voltage0", True), ("voltage0", False)):
                chn = lib.find_channel(phy, name, out)
                lib.channel_attr_write_longlong(chn, "sampling_frequency", MIN_NO_FIR_FILTER)
            lib.device_attr_write_bool(phy, "in_out_voltage_filter_fir_en", False)
            return
        code = lib.device_attr_write_raw(phy, "filter_fir_config", cfg)
        if code < 0:
            raise IioError(f"filter_fir_config failed: {code}")
        lib.device_attr_write_bool(phy, "in_out_voltage_filter_fir_en", True)

    def _disable_dds(self):
        """Kill the default DDS test tone (:150-186)."""
        lib = self.lib
        tx = lib.find_device(self.ctx, "cf-ad9361-dds-core-lpc")
        for name in ("TX1_I_F1", "TX1_Q_F1", "TX1_Q_F2", "TX1_I_F2"):
            chn = lib.find_channel(tx, name, True)
            lib.channel_attr_write_bool(chn, "raw", False)

    def _configure(self, direction: str, cfg: StreamCfg, power_down_tx: bool):
        lib = self.lib
        phy = lib.find_device(self.ctx, "ad9361-phy")
        # LO: altvoltage0 = RX LO, altvoltage1 = TX LO (:229-239)
        lo = lib.find_channel(phy, "altvoltage0" if direction == "rx" else "altvoltage1", True)
        lib.channel_attr_write_longlong(lo, "frequency", cfg.center_freq)
        if direction == "rx" and power_down_tx:
            tx_lo = lib.find_channel(phy, "altvoltage1", True)
            lib.channel_attr_write_bool(tx_lo, "powerdown", True)
        chn = lib.find_channel(phy, "voltage0", direction == "tx")
        lib.channel_attr_write_longlong(chn, "rf_bandwidth", cfg.sampling_freq)
        lib.channel_attr_write_longlong(chn, "sampling_frequency", cfg.sampling_freq)
        if direction == "rx":
            lib.channel_attr_write(chn, "gain_control_mode", "manual")
        lib.channel_attr_write_double(chn, "hardwaregain", cfg.manual_gain)

    # ------------------------------------------------------------------
    async def read_stream(self) -> np.ndarray | None:
        if not self._running or self.rx_buffer is None:
            return None
        try:
            raw = await asyncio.to_thread(self.lib.buffer_refill, self.rx_buffer)
        except IioError:
            return None
        if not raw:
            return None
        # 12-bit ADC scale 2048 (volk_16i_s32f_convert_32f analog); native
        # C++ conversion when built, numpy otherwise
        samples = native.int16_to_float(np.frombuffer(raw, dtype=np.int16), 2048.0)
        return (samples[0::2] + 1j * samples[1::2]).astype(np.complex64)

    async def write_stream(self, iq: np.ndarray) -> None:
        if self.tx_buffer is None:
            raise PlutoSdrError("device does not support tx")
        iq = np.asarray(iq, np.complex64)
        interleaved = np.empty(2 * len(iq), np.float32)
        interleaved[0::2] = iq.real
        interleaved[1::2] = iq.imag
        data = native.float_to_int16(interleaved, 32768.0)
        code = await asyncio.to_thread(self.lib.buffer_push, self.tx_buffer, data.tobytes())
        if code < 0:
            raise PlutoSdrError(f"unable to push tx buffer: {code}")

    async def stop_rx(self) -> None:
        self._running = False

    async def close(self) -> None:
        self._running = False
        if self.rx_buffer is not None:
            self.lib.destroy_buffer(self.rx_buffer)
            self.rx_buffer = None
        if self.tx_buffer is not None:
            self.lib.destroy_buffer(self.tx_buffer)
            self.tx_buffer = None
        if self.ctx is not None:
            self.lib.destroy_context(self.ctx)
            self.ctx = None
