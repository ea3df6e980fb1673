"""Unit tests of the stream DSP blocks against the numpy C-semantics oracle.

Covers the reference's unit-test tiers for fir_filter/lpf, quadrature_demod,
dc_blocker, clock_recovery_mm, interp_fir_filter, frequency_modulator and
sig_source — including the chunk-size-invariance property the reference's
big/small-buffer tests establish.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from sdrmodem.dsp import taps as T
from sdrmodem.dsp.clock_recovery import clock_mm_stream, mm_params
from sdrmodem.dsp.elementwise import (
    dc_blocker_stream,
    fast_atan2,
    freq_mod_stream,
    nco_stream,
    quad_demod_stream,
)
from sdrmodem.dsp.fir import fir_stream, interp_fir_stream

from tests import reference_impl as R

RNG = np.random.default_rng(42)


@pytest.mark.parametrize("decim", [1, 2, 4])
@pytest.mark.parametrize("chunks", [[300], [100, 100, 100], [37, 263], [1] * 10 + [290]])
def test_fir_float_matches_reference(decim, chunks):
    taps = T.low_pass_taps(1.0, 8000, 1750, 500)
    x = RNG.standard_normal(300).astype(np.float32)
    ref = R.RefFir(taps, decim)
    expected = np.concatenate(
        [ref.process(x[sum(chunks[:i]) : sum(chunks[: i + 1])]) for i in range(len(chunks))]
    )
    got = np.asarray(fir_stream(jnp.asarray(x), taps, decim))
    assert len(got) == len(expected)
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_fir_complex_matches_reference():
    taps = T.low_pass_taps(1.0, 8000, 1750, 500)
    x = (RNG.standard_normal(200) + 1j * RNG.standard_normal(200)).astype(np.complex64)
    ref = R.RefFir(taps, 2, complex_input=True)
    expected = ref.process(x)
    got = np.asarray(fir_stream(jnp.asarray(x), taps, 2))
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_fast_atan2_accuracy():
    y = RNG.standard_normal(5000).astype(np.float32)
    x = RNG.standard_normal(5000).astype(np.float32)
    got = np.asarray(fast_atan2(jnp.asarray(y), jnp.asarray(x)))
    true = np.arctan2(y, x)
    assert np.abs(got - true).max() < 4e-6  # LUT interpolation error bound
    # both zero -> 0 (including the NaN-squashing C behaviour)
    assert float(fast_atan2(jnp.float32(0), jnp.float32(0))) == 0.0
    assert float(fast_atan2(jnp.float32(np.nan), jnp.float32(np.nan))) == 0.0


@pytest.mark.parametrize("use_lut", [True, False])
def test_quad_demod_matches_reference(use_lut):
    x = (RNG.standard_normal(500) + 1j * RNG.standard_normal(500)).astype(np.complex64)
    ref = R.RefQuadDemod(1.5)
    expected = np.concatenate([ref.process(x[:123]), ref.process(x[123:])])
    got = np.asarray(quad_demod_stream(jnp.asarray(x), 1.5, use_lut=use_lut))
    np.testing.assert_allclose(got, expected, atol=1e-5)


@pytest.mark.parametrize("length", [4, 32, 160])
def test_dc_blocker_matches_reference(length):
    x = (RNG.standard_normal(600) + 0.3).astype(np.float32)
    ref = R.RefDcBlocker(length)
    expected = np.concatenate([ref.process(x[:250]), ref.process(x[250:])])
    got = np.asarray(dc_blocker_stream(jnp.asarray(x), length))
    np.testing.assert_allclose(got, expected, atol=2e-4)


def _lowpass_signal(n, sps=5.0):
    """Random NRZ-ish soft signal resembling the demod input to clock recovery."""
    bits = RNG.integers(0, 2, int(n / sps) + 8) * 2.0 - 1.0
    up = np.repeat(bits, int(sps * 2))[: n * 2 : 2].astype(np.float32)
    k = np.hanning(9).astype(np.float32)
    return np.convolve(up, k / k.sum(), mode="same").astype(np.float32)


@pytest.mark.parametrize("sps", [4.8, 5.0, 2.5])
def test_clock_recovery_matches_reference(sps):
    params = mm_params(sps)
    x = _lowpass_signal(2000, sps)
    ref = R.RefClockMM(
        params["omega"], params["gain_omega"], params["mu"],
        params["gain_mu"], params["omega_relative_limit"],
    )
    expected = ref.process(x)
    outs, count, _ = clock_mm_stream(jnp.asarray(x), **params)
    got = np.asarray(outs)[: int(count)]
    assert len(got) == len(expected)
    np.testing.assert_allclose(got, expected, atol=1e-4)


def test_clock_recovery_chunked_state_handoff():
    """Block-streamed processing with carried state == whole-stream result."""
    params = mm_params(5.0)
    x = _lowpass_signal(3000, 5.0)
    whole, count, _ = clock_mm_stream(jnp.asarray(x), **params)
    whole = np.asarray(whole)[: int(count)]

    state = None
    pieces = []
    for chunk in np.split(x, [700, 1400, 2100]):
        outs, c, state = clock_mm_stream(jnp.asarray(chunk), state=state, **params)
        pieces.append(np.asarray(outs)[: int(c)])
    chunked = np.concatenate(pieces)
    assert len(chunked) == len(whole)
    np.testing.assert_allclose(chunked, whole, atol=1e-5)


def test_clock_recovery_nan_handling():
    params = mm_params(5.0)
    x = _lowpass_signal(500, 5.0)
    x[100:200] = np.nan
    ref = R.RefClockMM(
        params["omega"], params["gain_omega"], params["mu"],
        params["gain_mu"], params["omega_relative_limit"],
    )
    expected = ref.process(x)
    outs, count, _ = clock_mm_stream(jnp.asarray(x), **params)
    got = np.asarray(outs)[: int(count)]
    assert len(got) == len(expected)
    nan_zeros = expected == 0.0
    np.testing.assert_allclose(got, expected, atol=1e-4)
    assert nan_zeros.any()  # the NaN branch actually triggered


def test_interp_fir_matches_polyphase_definition():
    taps = T.gfsk_pulse_taps(4.0, 0.5)
    x = RNG.standard_normal(64).astype(np.float32)
    got = np.asarray(interp_fir_stream(jnp.asarray(x), taps, 4))
    assert got.shape == (256,)
    # direct definition: y[n*I+i] = sum_m x[n-m] h[m*I+i]
    tp = np.concatenate([taps, np.zeros((-len(taps)) % 4, np.float32)])
    expected = np.zeros(256, np.float32)
    for n in range(64):
        for i in range(4):
            acc = 0.0
            for m in range(len(tp) // 4):
                if 0 <= n - m < 64:
                    acc += x[n - m] * tp[m * 4 + i]
            expected[n * 4 + i] = acc
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_freq_modulator_matches_reference():
    x = RNG.standard_normal(400).astype(np.float32)
    ref = R.RefFreqModulator(0.7)
    expected = np.concatenate([ref.process(x[:150]), ref.process(x[150:])])
    out, phase = freq_mod_stream(jnp.asarray(x), 0.7)
    np.testing.assert_allclose(np.asarray(out), expected, atol=1e-4)
    # carried phase continues the stream
    out1, p1 = freq_mod_stream(jnp.asarray(x[:150]), 0.7)
    out2, _ = freq_mod_stream(jnp.asarray(x[150:]), 0.7, p1)
    np.testing.assert_allclose(
        np.concatenate([np.asarray(out1), np.asarray(out2)]), expected, atol=1e-4
    )


def test_nco_matches_reference():
    ref = R.RefSigSource(48000)
    expected = np.concatenate([ref.process(1000, 500), ref.process(1000, 500)])
    out1, p1 = nco_stream(1000, 500, 48000)
    out2, _ = nco_stream(1000, 500, 48000, phase0=p1)
    got = np.concatenate([np.asarray(out1), np.asarray(out2)])
    np.testing.assert_allclose(got, expected, atol=1e-3)


def test_nco_negative_freq():
    ref = R.RefSigSource(48000)
    expected = ref.process(-3000, 1000)
    out, _ = nco_stream(-3000, 1000, 48000)
    np.testing.assert_allclose(np.asarray(out), expected, atol=1e-3)


def test_fast_atan2_free_matches_lut():
    """Gather-free LUT evaluation tracks the table LUT to float32 noise."""
    from sdrmodem.dsp.elementwise import fast_atan2_free

    y = np.concatenate(
        [RNG.standard_normal(5000), [0.0, 1.0, -1.0, 0.0, 1e-30, np.nan]]
    ).astype(np.float32)
    x = np.concatenate(
        [RNG.standard_normal(5000), [0.0, 0.0, 0.0, -2.0, 1e-30, np.nan]]
    ).astype(np.float32)
    lut = np.asarray(fast_atan2(jnp.asarray(y), jnp.asarray(x)))
    free = np.asarray(fast_atan2_free(jnp.asarray(y), jnp.asarray(x)))
    # recomputed atan(k/255) vs the stored f32 table entry: <=2 ulp each
    assert np.abs(free - lut).max() < 5e-7
    assert float(fast_atan2_free(jnp.float32(0), jnp.float32(0))) == 0.0
    assert float(fast_atan2_free(jnp.float32(np.nan), jnp.float32(np.nan))) == 0.0


def test_freq_mod_stream_pair_chunked_matches_complex():
    """The pair VCO == the complex VCO, including chunked phase
    continuity and batched lanes (the server TX shape)."""
    from sdrmodem.dsp.elementwise import freq_mod_stream, freq_mod_stream_pair

    x = RNG.standard_normal(10_000).astype(np.float32)
    ref, pe = freq_mod_stream(jnp.asarray(x), 1.636)
    i1, q1, p1 = freq_mod_stream_pair(jnp.asarray(x[:4096]), 1.636)
    i2, q2, p2 = freq_mod_stream_pair(jnp.asarray(x[4096:]), 1.636, p1)
    i = np.concatenate([np.asarray(i1), np.asarray(i2)])
    q = np.concatenate([np.asarray(q1), np.asarray(q2)])
    np.testing.assert_allclose(i, np.asarray(ref).real, atol=5e-4)
    np.testing.assert_allclose(q, np.asarray(ref).imag, atol=5e-4)
    assert abs(float(p2) - float(pe)) < 1e-3
    xb = RNG.standard_normal((3, 2048)).astype(np.float32)
    ib, qb, pb = freq_mod_stream_pair(jnp.asarray(xb), 0.7)
    refb, peb = freq_mod_stream(jnp.asarray(xb), 0.7)
    np.testing.assert_allclose(np.asarray(ib), np.asarray(refb).real, atol=5e-4)
    np.testing.assert_allclose(np.asarray(pb), np.asarray(peb), atol=1e-3)
