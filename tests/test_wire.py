"""Wire codec interop: our hand-written proto2 codec must be byte-compatible
with protobuf code generated from the reference's api.proto."""

import pathlib
import shutil
import subprocess
import sys

import pytest

from sdrmodem.server import wire


def test_header_framing():
    payload = b"\x01\x02\x03"
    framed = wire.frame(wire.MsgType.TX_DATA, payload)
    assert framed[:3] == bytes([0, 4, 0])  # version, type, BE length hi
    version, msg_type, length = wire.parse_header(framed[:6])
    assert (version, msg_type, length) == (0, 4, 3)
    assert framed[6:] == payload


def test_roundtrip_all_messages():
    rx = wire.RxRequest(
        rx_center_freq=437525000, rx_sampling_freq=48000, rx_dump_file=True,
        rx_offset=-12000, demod_type=1, demod_baud_rate=4800, demod_decimation=2,
        demod_destination=wire.DemodDestination.BOTH,
        doppler=wire.DopplerSettings(tle=["A", "B", "C"], latitude=537200000,
                                     longitude=475700000, altitude=120),
        fsk_settings=wire.FskDemodulationSettings(-5000, 2000, True),
        file_settings=wire.FileSettings("/tmp/x.cf32", 1583840449),
    )
    assert wire.RxRequest.decode(rx.encode()) == rx
    tx = wire.TxRequest(
        tx_center_freq=437525000, tx_sampling_freq=19200, tx_offset=3000,
        mod_baud_rate=9600, fsk_settings=wire.FskModulationSettings(5000),
    )
    assert wire.TxRequest.decode(tx.encode()) == tx
    assert wire.Response.decode(wire.Response(1, 4).encode()) == wire.Response(1, 4)
    assert wire.TxData.decode(wire.TxData(b"hello").encode()).data == b"hello"


def test_negative_int64_encoding():
    fsk = wire.FskDemodulationSettings(demod_fsk_deviation=-5000)
    out = wire.FskDemodulationSettings.decode(fsk.encode())
    assert out.demod_fsk_deviation == -5000


@pytest.fixture(scope="module")
def api_pb2(tmp_path_factory):
    # the vendored protocol definition (resources/api.proto, verbatim the
    # reference's api.proto — asserted in test_vendored_proto below)
    proto = pathlib.Path(__file__).resolve().parents[1] / "resources" / "api.proto"
    if shutil.which("protoc") is None:
        pytest.skip("protoc not available")
    out = tmp_path_factory.mktemp("pb")
    shutil.copy(proto, out / "api.proto")
    subprocess.run(
        ["protoc", f"--python_out={out}", "api.proto"], cwd=out, check=True
    )
    sys.path.insert(0, str(out))
    try:
        import api_pb2 as mod

        yield mod
    finally:
        sys.path.remove(str(out))
        sys.modules.pop("api_pb2", None)


def test_interop_with_protoc(api_pb2):
    rx = wire.RxRequest(
        rx_center_freq=437525000, rx_sampling_freq=48000, rx_dump_file=True,
        rx_offset=-12000, demod_type=1, demod_baud_rate=4800, demod_decimation=2,
        demod_destination=wire.DemodDestination.BOTH,
        doppler=wire.DopplerSettings(tle=["A", "B", "C"], latitude=537200000,
                                     longitude=475700000, altitude=0),
        fsk_settings=wire.FskDemodulationSettings(-5000, 2000, True),
        file_settings=wire.FileSettings("/tmp/x.cf32", 1583840449),
    )
    ref = api_pb2.RxRequest()
    ref.ParseFromString(rx.encode())
    assert ref.rx_center_freq == rx.rx_center_freq
    assert ref.rx_offset == -12000
    assert ref.fsk_settings.demod_fsk_deviation == -5000
    assert list(ref.doppler.tle) == ["A", "B", "C"]
    assert ref.file_settings.start_time_seconds == 1583840449
    # decode their bytes
    assert wire.RxRequest.decode(ref.SerializeToString()) == rx

    resp = api_pb2.Response()
    resp.status = 1
    resp.details = 4
    assert wire.Response.decode(resp.SerializeToString()) == wire.Response(1, 4)

    tx = wire.TxRequest(
        tx_center_freq=1, tx_sampling_freq=2, mod_baud_rate=3,
        fsk_settings=wire.FskModulationSettings(5000),
    )
    reftx = api_pb2.TxRequest()
    reftx.ParseFromString(tx.encode())
    assert reftx.fsk_settings.mod_fsk_deviation == 5000


def test_fuzz_roundtrip_random_messages():
    """Randomized encode->decode round-trip over the full field ranges
    (incl. int64 sign boundaries and junk-resilient decode of unknown
    trailing fields — proto2 forward compatibility)."""
    import numpy as np

    from sdrmodem.server import wire as W

    rng = np.random.default_rng(7)
    for _ in range(200):
        rx = W.RxRequest(
            rx_center_freq=int(rng.integers(0, 1 << 63)),
            rx_sampling_freq=int(rng.integers(0, 1 << 32)),
            rx_dump_file=bool(rng.integers(0, 2)),
            rx_offset=int(rng.integers(-(1 << 62), 1 << 62)),
            demod_type=W.ModemType.GMSK,
            demod_baud_rate=int(rng.integers(1, 1 << 31)),
            demod_decimation=int(rng.integers(1, 256)),
            demod_destination=W.DemodDestination(int(rng.integers(0, 3))),
            doppler=(
                W.DopplerSettings(
                    tle=["x" * int(rng.integers(0, 70)), "y", "z"],
                    latitude=int(rng.integers(0, 1 << 31)),
                    longitude=int(rng.integers(0, 1 << 31)),
                    altitude=int(rng.integers(0, 1 << 31)),
                )
                if rng.integers(0, 2)
                else None
            ),
            fsk_settings=W.FskDemodulationSettings(
                demod_fsk_deviation=int(rng.integers(-(1 << 40), 1 << 40)),
                demod_fsk_transition_width=int(rng.integers(0, 1 << 31)),
                demod_fsk_use_dc_block=bool(rng.integers(0, 2)),
            ),
        )
        assert W.RxRequest.decode(rx.encode()) == rx

        tx = W.TxRequest(
            tx_center_freq=int(rng.integers(0, 1 << 63)),
            tx_sampling_freq=int(rng.integers(0, 1 << 32)),
            tx_dump_file=bool(rng.integers(0, 2)),
            tx_offset=int(rng.integers(-(1 << 62), 1 << 62)),
            mod_type=W.ModemType.GMSK,
            mod_baud_rate=int(rng.integers(1, 1 << 31)),
            fsk_settings=W.FskModulationSettings(
                mod_fsk_deviation=int(rng.integers(-(1 << 40), 1 << 40))
            ),
        )
        assert W.TxRequest.decode(tx.encode()) == tx

        data = rng.integers(0, 256, int(rng.integers(0, 2048))).astype(np.uint8)
        td = W.TxData(data=bytes(data.tobytes()))
        assert W.TxData.decode(td.encode()) == td

    # unknown trailing field (num 15, varint) must be skipped, not fatal
    resp = W.Response(status=W.ResponseStatus.SUCCESS, details=3)
    blob = resp.encode() + W._field_varint(15, 42)
    assert W.Response.decode(blob) == resp


def test_fuzz_decode_garbage_raises_not_crashes():
    """Arbitrary byte blobs must raise WireError (or parse), never crash."""
    import numpy as np

    from sdrmodem.server import wire as W

    rng = np.random.default_rng(11)
    for _ in range(300):
        blob = bytes(rng.integers(0, 256, int(rng.integers(0, 64))).astype(np.uint8))
        for msg in (W.RxRequest, W.TxRequest, W.Response, W.TxData):
            try:
                msg.decode(blob)
            except W.WireError:
                pass


def test_vendored_proto_matches_reference(reference_dir):
    """resources/api.proto is verbatim the reference's protocol file."""
    mine = (pathlib.Path(__file__).resolve().parents[1] / "resources" / "api.proto").read_bytes()
    assert mine == (reference_dir / "api.proto").read_bytes()
