"""End-to-end golden-fixture tests against the reference's recorded IQ.

Mirrors reference test/test_fsk_demod.c and test/test_gfsk_mod.c: demodulate
the recorded captures and compare int8 soft symbols within ±2 LSB; modulate
a known byte pattern and compare the complex baseband within 0.01.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from sdrmodem import FskDemodConfig, FskDemodulator, GfskModConfig, GfskModulator

CASES = [
    ("nusat", FskDemodConfig(192000, 40000, 5000, 1, 2000, True), "nusat.cf32", "processed.s8"),
    ("nan", FskDemodConfig(240000, 9600, 5000, 1, 2000, True), "inputnan.cf32", "nan.s8"),
    (
        "lucky7",
        FskDemodConfig(48000, 4800, 5000, 2, 2000, True),
        "lucky7.expected.cf32",
        "lucky7.expected.s8",
    ),
    (
        "lucky7_nodc",
        FskDemodConfig(48000, 4800, 5000, 2, 2000, False),
        "lucky7.expected.cf32",
        "lucky7.expected.nodc.s8",
    ),
]


def test_vendored_fixtures_match_reference(reference_dir, fixtures_dir):
    """Every vendored binary fixture is byte-identical to the reference's
    test/resources copy (guards fixture drift; runs only when the
    upstream checkout is available)."""
    ref = reference_dir / "test" / "resources"
    checked = 0
    for f in sorted(fixtures_dir.iterdir()):
        src = ref / f.name
        if src.exists():
            assert f.read_bytes() == src.read_bytes(), f.name
            checked += 1
    assert checked >= 18


@pytest.mark.parametrize("name,cfg,fin,fexp", CASES, ids=[c[0] for c in CASES])
def test_fsk_demod_golden(resources_dir, name, cfg, fin, fexp):
    iq = np.fromfile(resources_dir / fin, dtype=np.complex64)
    golden = np.fromfile(resources_dir / fexp, dtype=np.int8)
    out, count, _ = FskDemodulator(cfg).process(jnp.asarray(iq))
    got = np.asarray(out)[: int(count)]
    assert len(got) == len(golden)
    diff = np.abs(got.astype(np.int32) - golden.astype(np.int32))
    assert diff.max() <= 2, f"{name}: {(diff > 2).sum()} symbols beyond tolerance"


def test_fsk_demod_batched_channels(resources_dir):
    """Batched (channel-axis) demod must equal per-channel demod."""
    iq = np.fromfile(resources_dir / "nusat.cf32", dtype=np.complex64)
    cfg = FskDemodConfig(192000, 40000, 5000, 1, 2000, True)
    dem = FskDemodulator(cfg)
    single, count, _ = dem.process(jnp.asarray(iq))
    batch = jnp.stack([jnp.asarray(iq)] * 4)
    bout, bcount, _ = dem.process(batch)
    assert np.all(np.asarray(bcount) == int(count))
    for b in range(4):
        # backend conv blocking can differ between batch sizes; a single
        # float32 ulp upstream of the (chaotic) M&M loop wiggles a few
        # symbols by the golden tolerance, exactly like the reference's
        # cross-machine ±2 LSB policy
        diff = np.abs(
            np.asarray(bout)[b, : int(count)].astype(np.int32)
            - np.asarray(single)[: int(count)].astype(np.int32)
        )
        assert diff.max() <= 2 and (diff > 0).mean() < 0.01


def test_gfsk_mod_golden(fixtures_dir):
    vals = np.load(fixtures_dir / "gfsk_mod_expected320.npy")
    expected = vals[0::2] + 1j * vals[1::2]

    cfg = GfskModConfig.from_radio(19200, 9600, 5000)
    out, _ = GfskModulator(cfg).process(jnp.asarray(np.arange(10, dtype=np.uint8)))
    got = np.asarray(out)
    assert got.shape == (160,)
    assert np.abs(got.real - expected.real).max() < 0.01
    assert np.abs(got.imag - expected.imag).max() < 0.01


def test_mod_demod_loopback():
    """TX → RX loopback recovers the transmitted bits (reference
    test_tcp_server.c test_file_data analog, 10 warm-up symbols skipped)."""
    fs, baud, dev = 48000, 9600, 5000
    payload = np.frombuffer(b"hello sdr-modem gpu loopback!!!!" * 8, dtype=np.uint8)
    mod = GfskModulator(GfskModConfig.from_radio(fs, baud, dev))
    iq, _ = mod.process(jnp.asarray(payload))

    demod = FskDemodulator(FskDemodConfig(fs, baud, dev, 1, 2000, False))
    out, count, _ = demod.process(iq)
    soft = np.asarray(out)[: int(count)]
    bits_tx = np.unpackbits(payload).astype(np.int8) * 2 - 1
    hard = np.sign(soft).astype(np.int8)
    # filter group delays put the first symbol ~20 positions in; search the
    # alignment and require an essentially error-free match
    best = 0.0
    for off in range(0, 80):
        n = min(len(hard) - off, len(bits_tx))
        best = max(best, float((hard[off : off + n] == bits_tx[:n]).mean()))
    assert best > 0.999, f"loopback BER too high: {1 - best:.4f}"


def test_ber_waterfall():
    """TX→AWGN→RX BER decreases with SNR and is error-free at high SNR
    (BASELINE config #3)."""
    import sys, pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
    import ber_sweep

    low, _ = ber_sweep.run_point(-3.0, 0.0, 512, seed=1)
    high, _ = ber_sweep.run_point(14.0, 0.0, 512, seed=1)
    assert high < 0.002
    assert low > high


def test_ber_with_frequency_offset():
    import sys, pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
    import ber_sweep

    ber, _ = ber_sweep.run_point(14.0, 200.0, 512, seed=2)
    assert ber < 0.01  # DC blocker absorbs a small carrier offset


def test_gfsk_mod_pair_fast_golden(fixtures_dir):
    """The production (two-level f32 VCO) TX pair path matches the
    reference's 320-float golden within the complex tolerance (0.01,
    reference test/utils.c:134-140)."""
    vals = np.load(fixtures_dir / "gfsk_mod_expected320.npy")

    cfg = GfskModConfig.from_radio(19200, 9600, 5000)
    i, q, _ = GfskModulator(cfg).process_pair(jnp.asarray(np.arange(10, dtype=np.uint8)))
    assert np.abs(np.asarray(i) - vals[0::2]).max() < 0.01
    assert np.abs(np.asarray(q) - vals[1::2]).max() < 0.01
