"""Server configuration: libconfig-style file parsing with defaults.

Behavioural equivalent of reference src/server_config.c:26-249: the same
key names, defaults and validation (buffer_size 262144, port 8091,
read_timeout 5 s must be positive, queue_size 64, rx/tx sdr types,
sdr-server 127.0.0.1:8090, pluto gains/timeout, TMPDIR fallback).

The accepted syntax is the subset of libconfig the reference's configs
use: ``key = value;`` / ``key = value`` lines, ``#`` and ``//`` comments,
quoted strings, integers and floats.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path


class ConfigError(ValueError):
    pass


class RxSdrType(Enum):
    SDR_SERVER = "sdr-server"
    PLUTOSDR = "plutosdr"
    FILE = "file"


class TxSdrType(Enum):
    NONE = "none"
    PLUTOSDR = "plutosdr"
    FILE = "file"


_LINE = re.compile(
    r"""^\s*([A-Za-z_][A-Za-z0-9_]*)\s*=\s*("(?:[^"\\]|\\.)*"|[^;#]+?)\s*;?\s*(?:\#.*|//.*)?$"""
)


def parse_libconfig(text: str) -> dict:
    """Parse the flat scalar subset of libconfig syntax used by sdr-modem."""
    values: dict = {}
    saw_setting = False
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith("//"):
            continue
        m = _LINE.match(raw)
        if not m:
            raise ConfigError(f"syntax error: {raw!r}")
        key, val = m.group(1), m.group(2).strip()
        saw_setting = True
        if val.startswith('"'):
            values[key] = val[1:-1]
        elif re.fullmatch(r"[-+]?\d+", val):
            values[key] = int(val)
        elif re.fullmatch(r"[-+]?\d*\.\d+([eE][-+]?\d+)?", val):
            values[key] = float(val)
        elif val in ("true", "false"):
            values[key] = val == "true"
        else:
            raise ConfigError(f"syntax error in value: {raw!r}")
    if not saw_setting:
        # libconfig fails on an empty file; reference minimal.conf notes this
        raise ConfigError("syntax error: empty config")
    return values


@dataclass
class ServerConfig:
    bind_address: str = "127.0.0.1"
    port: int = 8091
    buffer_size: int = 262144
    read_timeout_seconds: int = 5
    queue_size: int = 64
    base_path: str = ""
    rx_sdr_type: RxSdrType = RxSdrType.SDR_SERVER
    tx_sdr_type: TxSdrType = TxSdrType.NONE
    rx_sdr_server_address: str = "127.0.0.1"
    rx_sdr_server_port: int = 8090
    rx_file_base_path: str = ""
    tx_file_base_path: str = ""
    rx_plutosdr_gain: float = 0.0
    tx_plutosdr_gain: float = 0.0
    tx_plutosdr_timeout_millis: int = 10000
    # libiio binding seam: None = load the real library on first use.
    # The reference loads it at config time and its tests swap in a mock
    # (src/server_config.c:176-183, test/iio_lib_mock.c) — same seam here.
    iio_lib: object | None = None
    # extensions (absent from the reference; defaults keep parity)
    bench_channels: int = 64
    # demod_mode: "exact" runs one deterministic f64-accumulated pipeline
    # per client (bit parity with the reference goldens); "fast" batches
    # every client on a shared SDR stream into ONE full-block device step
    # (lanes of BatchedRxGroup, server/session.py)
    demod_mode: str = "exact"

    @classmethod
    def load(cls, path: str | Path) -> "ServerConfig":
        values = parse_libconfig(Path(path).read_text())
        cfg = cls()
        cfg.bind_address = str(values.get("bind_address", cfg.bind_address))
        cfg.port = int(values.get("port", cfg.port))
        cfg.buffer_size = int(values.get("buffer_size", cfg.buffer_size))
        timeout = int(values.get("read_timeout_seconds", cfg.read_timeout_seconds))
        if timeout <= 0:
            raise ConfigError("read timeout should be positive")
        cfg.read_timeout_seconds = timeout
        cfg.queue_size = int(values.get("queue_size", cfg.queue_size))
        tmp = os.environ.get("TMPDIR", "/tmp")
        cfg.base_path = str(values.get("base_path", tmp))
        rx_type = values.get("rx_sdr_type", cfg.rx_sdr_type.value)
        try:
            cfg.rx_sdr_type = RxSdrType(rx_type)
        except ValueError:
            raise ConfigError(f"unsupported rx_sdr_type: {rx_type}") from None
        tx_type = values.get("tx_sdr_type", cfg.tx_sdr_type.value)
        try:
            cfg.tx_sdr_type = TxSdrType(tx_type)
        except ValueError:
            raise ConfigError(f"unsupported tx_sdr_type: {tx_type}") from None
        cfg.rx_sdr_server_address = str(
            values.get("rx_sdr_server_address", cfg.rx_sdr_server_address)
        )
        cfg.rx_sdr_server_port = int(values.get("rx_sdr_server_port", cfg.rx_sdr_server_port))
        cfg.rx_file_base_path = str(values.get("rx_file_base_path", tmp))
        cfg.tx_file_base_path = str(values.get("tx_file_base_path", tmp))
        cfg.rx_plutosdr_gain = float(values.get("rx_plutosdr_gain", cfg.rx_plutosdr_gain))
        cfg.tx_plutosdr_gain = float(values.get("tx_plutosdr_gain", cfg.tx_plutosdr_gain))
        cfg.tx_plutosdr_timeout_millis = int(
            values.get("tx_plutosdr_timeout_millis", cfg.tx_plutosdr_timeout_millis)
        )
        cfg.bench_channels = int(values.get("bench_channels", cfg.bench_channels))
        cfg.demod_mode = str(values.get("demod_mode", cfg.demod_mode))
        if cfg.demod_mode not in ("exact", "fast"):
            raise ConfigError(f"unsupported demod_mode: {cfg.demod_mode}")
        return cfg
