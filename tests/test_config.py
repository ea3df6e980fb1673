"""Server config parsing vs the reference's .conf fixtures
(reference test/test_server_config.c)."""

import pytest

from sdrmodem.server.config import ConfigError, RxSdrType, ServerConfig, TxSdrType


def test_full_config(resources_dir):
    cfg = ServerConfig.load(resources_dir / "full.conf")
    assert cfg.bind_address == "127.0.0.1"
    assert cfg.port == 8091
    assert cfg.buffer_size == 2048
    assert cfg.base_path == "/tmp/"
    assert cfg.read_timeout_seconds == 10
    assert cfg.rx_sdr_type == RxSdrType.SDR_SERVER
    assert cfg.tx_sdr_type == TxSdrType.NONE
    assert cfg.rx_sdr_server_port == 8090
    assert cfg.queue_size == 64
    assert cfg.tx_plutosdr_timeout_millis == 10000


def test_minimal_config_defaults(resources_dir):
    cfg = ServerConfig.load(resources_dir / "minimal.conf")
    assert cfg.port == 8091
    assert cfg.buffer_size == 262144
    assert cfg.read_timeout_seconds == 5
    assert cfg.queue_size == 64
    assert cfg.rx_sdr_type == RxSdrType.SDR_SERVER
    assert cfg.tx_sdr_type == TxSdrType.NONE


@pytest.mark.parametrize(
    "name",
    ["invalid.format.conf", "invalid.timeout.conf", "invalid.rx_sdr_type.conf",
     "invalid.tx_sdr_type.conf"],
)
def test_invalid_configs_rejected(resources_dir, name):
    with pytest.raises(ConfigError):
        ServerConfig.load(resources_dir / name)


def test_empty_config_rejected(tmp_path):
    p = tmp_path / "empty.conf"
    p.write_text("")
    with pytest.raises(ConfigError):
        ServerConfig.load(p)
