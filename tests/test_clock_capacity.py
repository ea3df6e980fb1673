"""Clock-state capacity contract: the carried tail/suffix is sized from
omega at construction, so high samples-per-symbol configurations (e.g.
Fs=48000, baud=500, decim=1 → sps=96) stream chunk-invariantly instead of
silently clipping unconsumed samples (the reference carries an unbounded
history, src/dsp/clock_recovery_mm.c:127-135).  Beyond MAX_SPS the
request/pipeline is rejected explicitly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sdrmodem.dsp.clock_recovery import (
    MAX_SPS,
    SUFFIX,
    TAIL_CAP,
    check_sps_supported,
    clock_mm_batched_full,
    clock_mm_stream,
    initial_full_state,
    initial_state,
    mm_params,
    suffix_cap_for,
    tail_cap_for,
)


def _soft(n, sps, seed=0):
    """Pulse-shaped ±1 soft stream at ~sps samples/symbol."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, int(n / sps) + 8) * 2.0 - 1.0
    idx = np.floor(np.arange(n) / sps).astype(int)
    x = bits[idx] + 0.05 * rng.standard_normal(n)
    return x.astype(np.float32)


def test_caps_derive_from_omega():
    assert tail_cap_for(5.0) == TAIL_CAP
    assert suffix_cap_for(5.0) == SUFFIX
    cap96 = tail_cap_for(96.0)
    assert cap96 >= 8 + int(np.ceil(96 * 1.01)) + 1 and cap96 % 8 == 0
    assert suffix_cap_for(96.0) >= 8 + int(np.ceil(96 * 1.01)) + 1
    assert initial_state(96.0).tail.shape[0] == cap96
    assert initial_full_state(96.0, 4).suffix.shape[0] == suffix_cap_for(96.0)


@pytest.mark.parametrize("sps", [24.0, 96.0])
def test_stream_chunked_equals_whole_high_sps(sps):
    """Chunked clock_mm_stream == one-shot on sps past the old fixed caps
    (96 overflows both TAIL_CAP=32 and SUFFIX=64)."""
    p = mm_params(sps)
    kw = dict(
        omega=p["omega"], gain_omega=p["gain_omega"], mu=p["mu"],
        gain_mu=p["gain_mu"], omega_relative_limit=p["omega_relative_limit"],
    )
    n = 8192
    x = _soft(n, p["omega"])

    whole, wcount, _ = clock_mm_stream(jnp.asarray(x), **kw)
    whole = np.asarray(whole)[: int(wcount)]

    state = initial_state(p["omega"], p["mu"])
    got = []
    for s in range(0, n, 1024):
        outs, cnt, state = clock_mm_stream(jnp.asarray(x[s : s + 1024]), state=state, **kw)
        got.append(np.asarray(outs)[: int(cnt)])
    got = np.concatenate(got)
    assert len(got) == len(whole)
    np.testing.assert_allclose(got, whole, atol=1e-5)


@pytest.mark.parametrize("backend", ["scan", "kernel"])
def test_full_block_high_sps_matches_stream(backend):
    """The full-block (suffix-carry) path at sps=96, both the scan
    reference and the clock kernel (interpret mode), against the
    whole-stream oracle."""
    p = mm_params(96.0)
    kw = dict(
        omega=p["omega"], gain_omega=p["gain_omega"], mu=p["mu"],
        gain_mu=p["gain_mu"], omega_relative_limit=p["omega_relative_limit"],
    )
    n, c = 8192, 2
    x = np.stack([_soft(n, p["omega"], seed=i) for i in range(c)])  # (C, N)

    oracle = []
    for i in range(c):
        o, cnt, _ = clock_mm_stream(jnp.asarray(x[i]), **kw)
        oracle.append(np.asarray(o)[: int(cnt)])

    state = initial_full_state(p["omega"], c, p["mu"])
    got = [[] for _ in range(c)]
    for s in range(0, n, 2048):
        outs, counts, state = clock_mm_batched_full(
            jnp.asarray(x[:, s : s + 2048].T), state, backend=backend, **kw,
        )
        outs, counts = np.asarray(outs), np.asarray(counts)
        for i in range(c):
            for t in range(counts.shape[1]):
                if counts[i, t]:
                    got[i].append(outs[i, t, : counts[i, t]])
    for i in range(c):
        g = np.concatenate(got[i])
        assert len(g) == len(oracle[i]), f"ch{i}: {len(g)} vs {len(oracle[i])}"
        # same interpolator table, same loop: the kernel differs from the
        # scan only in floating-point contraction
        np.testing.assert_allclose(g, oracle[i], atol=1e-5)


def test_beyond_max_sps_rejected():
    from sdrmodem.dsp.fsk_demod import FskDemodConfig, FskDemodulator
    from sdrmodem.dsp.pipeline import DemodPipeline

    with pytest.raises(ValueError, match="demod_decimation"):
        check_sps_supported(MAX_SPS + 1)
    cfg = FskDemodConfig(480000, 500, 5000, 1, 2000, True)  # sps = 960
    with pytest.raises(ValueError):
        DemodPipeline(cfg, 4096, exact=False)
    with pytest.raises(ValueError):
        FskDemodulator(cfg)


def test_validate_rx_request_rejects_beyond_max_sps():
    from sdrmodem.server import wire
    from sdrmodem.server.config import ServerConfig
    from sdrmodem.server.tcp_server import validate_rx_request

    config = ServerConfig()
    req = wire.RxRequest(
        rx_center_freq=437525000,
        rx_sampling_freq=480000,
        demod_type=wire.ModemType.GMSK,
        demod_baud_rate=500,
        demod_decimation=1,
        demod_destination=wire.DemodDestination.SOCKET,
        fsk_settings=wire.FskDemodulationSettings(
            demod_fsk_deviation=5000, demod_fsk_transition_width=2000,
            demod_fsk_use_dc_block=1,
        ),
    )
    assert not validate_rx_request(req, config)  # sps 960 > MAX_SPS
    req2 = wire.RxRequest(
        rx_center_freq=437525000,
        rx_sampling_freq=480000,
        demod_type=wire.ModemType.GMSK,
        demod_baud_rate=500,
        demod_decimation=4,  # sps 240 <= MAX_SPS
        demod_destination=wire.DemodDestination.SOCKET,
        fsk_settings=wire.FskDemodulationSettings(
            demod_fsk_deviation=5000, demod_fsk_transition_width=2000,
            demod_fsk_use_dc_block=1,
        ),
    )
    assert validate_rx_request(req2, config)
