"""The clock kernel (ops/mm_clock.py, Pallas interpret mode on CPU) and the
time-major FIR (dsp/fir.fir_tm) vs their plain references."""

import numpy as np
import pytest

import jax.numpy as jnp

from sdrmodem.dsp import taps as T
from sdrmodem.dsp.clock_recovery import (
    SUFFIX,
    clock_mm_batched_full,
    clock_mm_stream,
    initial_full_state,
    max_symbols,
    mm_params,
)
from sdrmodem.dsp.fir import conv1d, fir_stream, fir_tm
from sdrmodem.dsp.fsk_demod import FskDemodConfig
from sdrmodem.dsp.pipeline import DemodPipeline
from sdrmodem.ops.mm_clock import LANES_PER_PROGRAM, _round_half_even, mm_clock

RNG = np.random.default_rng(5)


@pytest.mark.parametrize("decim", [1, 2, 4])
def test_pallas_fir_matches_stream(decim):
    """fir_tm (banded matmul, time-major) == the whole-stream conv FIR."""
    taps = T.low_pass_taps(1.0, 48000, 7400, 740)
    x = RNG.standard_normal((1500, 128)).astype(np.float32)
    ref = np.asarray(fir_stream(jnp.asarray(x.T), taps, decim)).T
    # fir_stream pre-pads T-1 zeros (fresh filter); fir_tm reads its own
    # history rows, so hand it the same zero history
    work = np.concatenate([np.zeros((len(taps) - 1, 128), np.float32), x])
    got = np.asarray(
        fir_tm(jnp.asarray(work), np.asarray(taps, np.float32)[::-1], decim, ref.shape[0])
    )
    np.testing.assert_allclose(got, ref, atol=2e-5)


def _soft_signals(c, n, sps=4.8, seed=None):
    rng = RNG if seed is None else np.random.default_rng(seed)
    bits = rng.integers(0, 2, (c, int(n / sps) + 8)) * 2.0 - 1.0
    k = np.hanning(9) / 4.5
    return np.stack(
        [np.convolve(np.repeat(bits[i], 5)[:n], k, mode="same") for i in range(c)]
    ).astype(np.float32)


def _q(a):
    return np.clip(np.rint(np.asarray(a) * 127.0), -128, 127)


def _kernel_call(y_tm, n_valid, p, k):
    c = y_tm.shape[1]
    return mm_clock(
        jnp.asarray(y_tm), jnp.asarray(n_valid, jnp.int32),
        jnp.zeros((c,), jnp.int32),
        jnp.full((c,), p["mu"], jnp.float32),
        jnp.full((c,), p["omega"], jnp.float32),
        jnp.zeros((c,), jnp.float32),
        omega_mid=p["omega"], omega_relative_limit=p["omega_relative_limit"],
        gain_omega=p["gain_omega"], gain_mu=p["gain_mu"],
        num_symbols=k, interpret=True,
    )


def test_pallas_clock_matches_scan():
    """Per lane, the kernel equals the scan: same counts, same symbols up
    to float contraction, NaN windows emitting 0 and striding floor(omega)
    (reference src/dsp/clock_recovery_mm.c:107-113)."""
    p = mm_params(4.8)
    c, n = 6, 2500
    y = _soft_signals(c, n, seed=7)
    y[3, 400:430] = np.nan
    k = max_symbols(n, p["omega"], p["omega_relative_limit"], p["gain_mu"])
    outs, counts, fin = _kernel_call(y.T.copy(), np.full(c, n), p, k)
    outs, counts = np.asarray(outs), np.asarray(counts)
    assert outs.shape == (k, c)
    for ch in range(c):
        o, cnt, st = clock_mm_stream(jnp.asarray(y[ch]), **p)
        assert counts[ch] == int(cnt)
        np.testing.assert_allclose(outs[:, ch], np.asarray(o)[:k], atol=1e-5)
        assert float(fin["mu"][ch]) == pytest.approx(float(st.mu), abs=1e-5)
    assert np.all(outs[counts[3]:, 3] == 0.0)  # zero past the count


def test_pallas_clock_batched_state_handoff():
    """Kernel clock over three blocks with the suffix-carry state handed
    between them == the whole-stream scan, symbol for symbol."""
    p = mm_params(5.0)
    c, n = 4, 3000
    y = _soft_signals(c, n, 5.0)
    whole = []
    for ch in range(c):
        o, cnt, _ = clock_mm_stream(jnp.asarray(y[ch]), **p)
        whole.append(np.asarray(o)[: int(cnt)])

    state = initial_full_state(p["omega"], c, p["mu"])
    pieces = [[] for _ in range(c)]
    for lo, hi in [(0, 1000), (1000, 2000), (2000, 3000)]:
        outs, counts, state = clock_mm_batched_full(
            jnp.asarray(y[:, lo:hi].T), state, backend="kernel",
            omega=p["omega"], gain_omega=p["gain_omega"], mu=p["mu"],
            gain_mu=p["gain_mu"], omega_relative_limit=p["omega_relative_limit"],
        )
        for ch in range(c):
            pieces[ch].append(np.asarray(outs)[ch, 0, : int(np.asarray(counts)[ch, 0])])
    for ch in range(c):
        got = np.concatenate(pieces[ch])
        # the full-block hand-off keeps unconsumed samples, so the tail of
        # the stream may hold one symbol fewer than the whole-stream run
        assert abs(len(got) - len(whole[ch])) <= 1
        m = min(len(got), len(whole[ch]))
        np.testing.assert_allclose(got[:m], whole[ch][:m], atol=1e-5)


def test_clock_kernel_per_lane_valid_lengths():
    """Lanes with different valid lengths stop independently; padding
    lanes (C not a multiple of the program width) never leak out."""
    p = mm_params(5.0)
    c, n = 5, 2000
    assert c % LANES_PER_PROGRAM != 0
    y = _soft_signals(c, n, 5.0)
    n_valid = np.array([2000, 1500, 64, 7, 1999])
    k = max_symbols(n, p["omega"], p["omega_relative_limit"], p["gain_mu"])
    outs, counts, fin = _kernel_call(y.T.copy(), n_valid, p, k)
    outs, counts = np.asarray(outs), np.asarray(counts)
    assert outs.shape == (k, c) and counts.shape == (c,)
    assert counts[3] == 0 and int(fin["ii"][3]) == 0  # fewer than 8 samples
    for ch in range(c):
        o, cnt, _ = clock_mm_stream(jnp.asarray(y[ch]), n_valid=int(n_valid[ch]), **p)
        assert counts[ch] == int(cnt)
        np.testing.assert_allclose(outs[:, ch], np.asarray(o)[:k], atol=1e-5)


def test_round_half_even_matches_jnp_round():
    v = np.concatenate(
        [np.arange(0, 129, 0.5), RNG.uniform(0, 128, 1000)]
    ).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(_round_half_even(jnp.asarray(v))), np.asarray(jnp.round(v))
    )


def test_batched_pipeline_pallas_backend_golden(resources_dir):
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:24576]
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)

    c, b = 3, 8192
    pipe = DemodPipeline(FskDemodConfig(48000, 4800, 5000, 2, 2000, True), b, exact=False)
    step = pipe.make_batched_step_full("kernel")
    state = pipe.init_full_state(c)
    out = []
    for i in range(0, len(iq), b):
        chunk = iq[i : i + b]
        x = np.stack(
            [np.tile(chunk.real, (c, 1)), np.tile(chunk.imag, (c, 1))], axis=1
        ).astype(np.float32)
        state, sym, cnt = step(state, jnp.asarray(x))
        out.append(np.asarray(sym)[0, 0, : int(np.asarray(cnt)[0, 0])])
    got = np.concatenate(out)
    diff = np.abs(got.astype(np.int32) - golden[: len(got)].astype(np.int32))
    assert diff.max() <= 2


@pytest.mark.parametrize("stride", [1, 2])
def test_fir_precision_pin_matches_f64(stride):
    """The pinned FIR precision keeps float32 accuracy: fir_tm against the
    float64-accumulated conv1d, far below the -42 dB the ±2 LSB int8
    budget needs (TF32 would sit near -69 dB)."""
    taps = T.low_pass_taps(1.0, 48000, 7400, 740)
    rev = np.asarray(taps, np.float32)[::-1].copy()
    x = RNG.standard_normal((4096, 64)).astype(np.float32)
    n_out = (4096 - len(rev)) // stride + 1
    exact = np.asarray(conv1d(jnp.asarray(x.T), jnp.asarray(rev), stride, 0, exact=True))
    got = np.asarray(fir_tm(jnp.asarray(x), rev, stride, n_out)).T
    exact = exact[:, 0, :n_out]
    err = np.sqrt(((got - exact) ** 2).mean() / (exact**2).mean())
    assert err < 3e-6  # < -110 dB relative error floor


def test_chunked_clock_ragged_and_tiny_blocks_match_scan():
    """Full-block clock, kernel vs scan, threading state through (a) a
    block whose length is no multiple of anything in the kernel and (b) a
    stream of tiny blocks shorter than the carried SUFFIX."""
    p = mm_params(5.0)
    kw = dict(
        omega=p["omega"], gain_omega=p["gain_omega"], mu=p["mu"],
        gain_mu=p["gain_mu"], omega_relative_limit=p["omega_relative_limit"],
    )

    def run(blocks, backend):
        st = initial_full_state(p["omega"], blocks[0].shape[1])
        outs = []
        for b in blocks:
            o, cnt, st = clock_mm_batched_full(jnp.asarray(b), st, backend=backend, **kw)
            o, cnt = np.asarray(o), np.asarray(cnt)
            for ch in range(o.shape[0]):
                outs.append(
                    np.concatenate([o[ch, t, : cnt[ch, t]] for t in range(cnt.shape[1])])
                )
        return outs

    def check(kern, scan):
        for a, b in zip(kern, scan):
            assert len(a) == len(b)
            assert np.abs(_q(a) - _q(b)).max() <= 2

    c = 2
    y = _soft_signals(c, 3 * 1024 + 517, 5.0).T.copy()
    check(run([y], "kernel"), run([y], "scan"))

    ys = _soft_signals(c, 3 * (SUFFIX - 8), 5.0).T.copy()
    tiny = [ys[k * (SUFFIX - 8) : (k + 1) * (SUFFIX - 8)] for k in range(3)]
    check(run(tiny, "kernel"), run(tiny, "scan"))


def test_chunked_clock_multi_vreg_lanes_match_scan():
    """Lane counts past one program (C > 32): 136 channels run as five
    lane groups of one kernel launch, the last one padded.  Must match the
    scan path per symbol."""
    p = mm_params(5.0)
    kw = dict(
        omega=p["omega"], gain_omega=p["gain_omega"], mu=p["mu"],
        gain_mu=p["gain_mu"], omega_relative_limit=p["omega_relative_limit"],
    )
    c = 136
    y = _soft_signals(c, 2208, 5.0).T.copy()

    def run(backend):
        st = initial_full_state(p["omega"], c)
        o, cnt, st = clock_mm_batched_full(jnp.asarray(y), st, backend=backend, **kw)
        o, cnt = np.asarray(o), np.asarray(cnt)
        return [
            np.concatenate([o[ch, t, : cnt[ch, t]] for t in range(cnt.shape[1])])
            for ch in range(c)
        ]

    for a, b in zip(run("kernel"), run("scan")):
        assert len(a) == len(b)
        assert np.abs(_q(a) - _q(b)).max() <= 2  # the reference's own int8 policy
