"""Doppler correction against the reference's recorded-pass goldens
(reference test/test_doppler.c — which always streams 2000-sample chunks;
the 47000/95000 variants only change the allocated max buffer)."""

import numpy as np
import pytest

from sdrmodem.dsp.doppler import Doppler

TLE = [
    "LUCKY-7",
    "1 44406U 19038W   20069.88080907  .00000505  00000-0  32890-4 0  9992",
    "2 44406  97.5270  32.5584 0026284 107.4758 252.9348 15.12089395 37524",
]

ARGS = dict(
    latitude=53.72,
    longitude=47.57,
    altitude_km=0.0,
    sampling_freq=48000,
    center_freq=437525000,
    tle_lines=TLE,
    constant_offset=0,
    start_time_seconds=1583840449,
)


def _stream(d, iq, chunk, direction):
    out = []
    fn = d.process_rx if direction > 0 else d.process_tx
    for i in range(0, len(iq), chunk):
        out.append(fn(iq[i : i + chunk]))
    return np.concatenate(out)


@pytest.mark.parametrize(
    "golden", ["lucky7.expected.cf32", "lucky7.expected.47000.cf32", "lucky7.expected.95000.cf32"]
)
def test_doppler_rx_golden(resources_dir, golden):
    iq = np.fromfile(resources_dir / "lucky7.cf32", dtype=np.complex64)
    exp = np.fromfile(resources_dir / golden, dtype=np.complex64)
    got = _stream(Doppler(**ARGS), iq, 2000, +1)
    assert np.abs(got.real - exp.real).max() < 0.01
    assert np.abs(got.imag - exp.imag).max() < 0.01


def test_doppler_tx_inverts_rx(resources_dir):
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)
    exp = np.fromfile(resources_dir / "lucky7.cf32", dtype=np.complex64)
    got = _stream(Doppler(**ARGS), iq, 2000, -1)
    assert np.abs(got.real - exp.real).max() < 0.01
    assert np.abs(got.imag - exp.imag).max() < 0.01


def test_doppler_chunk_trajectory_is_buffer_dependent(resources_dir):
    """The reference interpolates the shift per process() call, so chunk size
    shapes the frequency staircase — document that behaviour."""
    iq = np.fromfile(resources_dir / "lucky7.cf32", dtype=np.complex64)[:96000]
    a = _stream(Doppler(**ARGS), iq, 2000, +1)
    b = _stream(Doppler(**ARGS), iq, 48000, +1)
    # same to first order but not identical
    assert np.abs(a - b).max() > 1e-4


def _device_mix_stream(d, iq, chunk, direction):
    """Apply Doppler via the DEVICE path: host 1 Hz bookkeeping
    (device_segments) + nco_mix_pair_tm, one lane."""
    import jax.numpy as jnp

    from sdrmodem.dsp.elementwise import nco_mix_pair_tm

    out = []
    for i in range(0, len(iq), chunk):
        blk = iq[i : i + chunk]
        rows = d.device_segments(len(blk), direction)
        assert len(rows) <= d.max_rows(len(blk), d.fs)
        s = max(len(rows), 1)
        tables = [np.zeros((s, 1), np.float32) for _ in range(4)]
        for k, (st, ln, adj, ph0) in enumerate(rows):
            tables[0][k, 0] = st
            tables[1][k, 0] = st + ln
            tables[2][k, 0] = adj
            tables[3][k, 0] = ph0
        x_tm = np.stack([blk.real, blk.imag], axis=1).astype(np.float32)
        y = np.asarray(nco_mix_pair_tm(jnp.asarray(x_tm), *map(jnp.asarray, tables)))
        out.append((y[:, 0] + 1j * y[:, 1]).astype(np.complex64))
    return np.concatenate(out)


@pytest.mark.parametrize(
    "golden", ["lucky7.expected.cf32", "lucky7.expected.47000.cf32", "lucky7.expected.95000.cf32"]
)
def test_device_doppler_matches_goldens(resources_dir, golden):
    """The device-side NCO (piecewise-linear phase rows applied on-device
    inside the batched step) reproduces the reference goldens just like
    the host mix — same segments, same f32 increments, same phase carry."""
    iq = np.fromfile(resources_dir / "lucky7.cf32", dtype=np.complex64)
    exp = np.fromfile(resources_dir / golden, dtype=np.complex64)
    got = _device_mix_stream(Doppler(**ARGS), iq, 2000, +1)
    assert np.abs(got.real - exp.real).max() < 0.01
    assert np.abs(got.imag - exp.imag).max() < 0.01


def test_device_doppler_batched_full_path(resources_dir):
    """lucky7 golden through the PRODUCTION shape: batched full-block step
    with doppler=True, mixing on-device before LPF1; a doppler-free lane
    rides along and must pass through bit-identically."""
    import jax.numpy as jnp

    from sdrmodem.dsp.fsk_demod import FskDemodConfig
    from sdrmodem.dsp.pipeline import DemodPipeline

    iq = np.fromfile(resources_dir / "lucky7.cf32", dtype=np.complex64)
    pre = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)

    block = 2000
    cfg = FskDemodConfig(48000, 4800, 5000, 2, 2000, True)
    pipe = DemodPipeline(cfg, block, exact=False, use_atan_lut=False)
    step = pipe.make_batched_step_full("scan", doppler=True)
    step_plain = pipe.make_batched_step_full("scan")
    state = pipe.init_full_state(2)
    state_plain = pipe.init_full_state(2)
    cp = state.quad_prev.shape[1] // 2
    d = Doppler(**ARGS)
    s_rows = d.max_rows(block, 48000)

    out0, out1, ref1 = [], [], []
    for i in range(0, len(iq) - block + 1, block):
        blk = iq[i : i + block]
        tables = [np.zeros((s_rows, cp), np.float32) for _ in range(4)]
        for k, (st, ln, adj, ph0) in enumerate(d.device_segments(block, +1)):
            tables[0][k, 0] = st
            tables[1][k, 0] = st + ln
            tables[2][k, 0] = adj
            tables[3][k, 0] = ph0
        # lane 0: raw capture + device doppler; lane 1: pre-corrected, no rows
        x = np.stack(
            [
                np.stack([blk.real, blk.imag]),
                np.stack([pre[i : i + block].real, pre[i : i + block].imag]),
            ]
        ).astype(np.float32)
        state, sym, cnt = step(state, jnp.asarray(x), tuple(map(jnp.asarray, tables)))
        state_plain, sym_p, cnt_p = step_plain(state_plain, jnp.asarray(x))
        sym, cnt = np.asarray(sym), np.asarray(cnt)
        out0.append(np.concatenate([sym[0, t, : cnt[0, t]] for t in range(cnt.shape[1])]))
        out1.append(np.concatenate([sym[1, t, : cnt[1, t]] for t in range(cnt.shape[1])]))
        sym_p, cnt_p = np.asarray(sym_p), np.asarray(cnt_p)
        ref1.append(
            np.concatenate([sym_p[1, t, : cnt_p[1, t]] for t in range(cnt_p.shape[1])])
        )
    got = np.concatenate(out0)
    n = min(len(got), len(golden))
    diff = np.abs(got[:n].astype(np.int32) - golden[:n].astype(np.int32))
    # same policy as the host-path end-to-end test: the trajectory differs
    # from the golden's by float-level noise the chaotic M&M can amplify
    assert (diff <= 2).mean() > 0.995
    # doppler-free lane with zero tables == step without the mix, bit-exact
    np.testing.assert_array_equal(np.concatenate(out1), np.concatenate(ref1))


def test_doppler_end_to_end_demod(resources_dir):
    """Doppler correction + GMSK demod = the full reference RX pipeline
    (dsp_worker.c:65-76): raw pass recording to soft symbols."""
    import jax.numpy as jnp

    from sdrmodem import FskDemodConfig, FskDemodulator

    iq = np.fromfile(resources_dir / "lucky7.cf32", dtype=np.complex64)
    corrected = _stream(Doppler(**ARGS), iq, 2000, +1)
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)
    out, count, _ = FskDemodulator(FskDemodConfig(48000, 4800, 5000, 2, 2000, True)).process(
        jnp.asarray(corrected)
    )
    got = np.asarray(out)[: int(count)]
    assert len(got) == len(golden)
    diff = np.abs(got.astype(np.int32) - golden.astype(np.int32))
    # the doppler trajectory differs from the golden's by float-level noise,
    # which the chaotic M&M loop can amplify at a handful of symbols
    assert (diff <= 2).mean() > 0.995
