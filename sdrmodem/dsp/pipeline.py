"""Ragged-block jit pipeline: ONE compiled program for any chunk size.

This is the per-client demodulator (the server's exact and standalone
modes) and the module that builds the batched full-block step: all
buffers have static shapes sized by ``block_size`` (the reference's
``max_input_buffer_length`` pre-allocation convention), the number of
valid samples is a runtime scalar, and each stage masks its outputs.  A
stream chunk of any length <= block_size is zero-padded into the block
buffer and processed by the same executable — no shape-keyed recompiles.

IQ is carried as a (2, N) float32 pair (I, Q) rather than complex64, so
the FIRs are real matmuls over I and Q lanes; the complex64 <-> pair
conversion happens at the host boundary only.

State per stage mirrors the reference's carried history
(src/dsp/fir_filter.c:95-113, quadrature_demod.c:64-69,
clock_recovery_mm.c:119-135) and is a pytree, so the whole pipeline can
be vmapped over a channel axis and sharded with shard_map.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from sdrmodem.dsp import taps as taps_mod
from sdrmodem.dsp.clock_recovery import (
    ClockState,
    clock_mm_batched_full,
    clock_mm_stream,
    initial_full_state,
    initial_state,
)
from sdrmodem.dsp.elementwise import atan2_dispatch, dc_blocker_taps, nco_mix_pair_tm
from sdrmodem.dsp.fir import conv1d, conv1d_banded, fir_tm
from sdrmodem.dsp.fsk_demod import FskDemodConfig, float_to_int8


class FirRaggedState(NamedTuple):
    hist: jnp.ndarray  # (..., cap) float32 — rows are independent lanes
    hist_len: jnp.ndarray  # () int32


class DemodState(NamedTuple):
    lpf1: FirRaggedState  # complex as 2 lanes
    quad_prev: jnp.ndarray  # (2,) float32 — previous (I, Q)
    lpf2: FirRaggedState
    dc: FirRaggedState | None
    clock: ClockState


class DemodStateFull(NamedTuple):
    """State of the full-block fast path: every history length is a
    compile-time constant (the stream's steady state when each step
    consumes exactly ``block`` samples), so history splicing is static
    concat/slice — no dynamic-start copies, masks, or gathers.

    Layout is TIME-MAJOR with channels along the last axis (padded to a
    multiple of 128 lanes): the FIR matmuls and the clock kernel consume
    it directly, so the hot path runs without a transpose."""

    lpf1_hist: jnp.ndarray  # (t1-1, 2*Cp) f32
    quad_prev: jnp.ndarray  # (1, 2*Cp) f32
    lpf2_hist: jnp.ndarray  # (t2-1, Cp) f32
    dc_hist: jnp.ndarray | None  # (4L-4, Cp) f32
    clock: "ClockFullState"


def _left_align(hist: jnp.ndarray, hist_len, x: jnp.ndarray, cap: int) -> jnp.ndarray:
    """[hist[:hist_len], x, ...] into a (lanes, cap + N) buffer.

    Two dynamic_update_slice copies.  The region past hist_len + N keeps
    whatever the second copy leaves there; callers mask by work_len.  The
    hist buffer invariant (zeros past hist_len) is maintained by
    _fir_ragged."""
    lanes = x.shape[0]
    work = jnp.zeros((lanes, cap + x.shape[-1]), x.dtype)
    work = jax.lax.dynamic_update_slice(work, hist, (0, 0))
    work = jax.lax.dynamic_update_slice(work, x, (jnp.int32(0), hist_len.astype(jnp.int32)))
    return work


def _fir_ragged(
    state: FirRaggedState,
    x: jnp.ndarray,  # (lanes, N) float32, valid first n_valid columns
    n_valid,
    rev_taps: jnp.ndarray,
    decimation: int,
    max_out: int,
    exact: bool,
):
    rev_taps = np.asarray(rev_taps, np.float32)
    t = rev_taps.shape[0]
    cap = state.hist.shape[-1]  # t - 1 + decimation - 1
    work = _left_align(state.hist, state.hist_len, x, cap)
    work_len = state.hist_len + n_valid
    # mask invalid region to zero so stale values never leak into windows
    work = jnp.where(jnp.arange(work.shape[-1]) < work_len, work, 0.0)

    n_out = jnp.maximum(work_len - (t - 1) + decimation - 1, 0) // decimation
    if exact:
        # float64-accumulated conv: the deterministic golden-parity path
        y = conv1d(work, jnp.asarray(rev_taps), decimation, 0, exact=True)[:, 0, :max_out]
    else:
        y = conv1d_banded(work, rev_taps, decimation, max_out)
    consumed = n_out * decimation

    new_hist_len = (work_len - consumed).astype(jnp.int32)
    start = jnp.clip(consumed, 0, work.shape[-1] - cap)
    lanes = work.shape[0]
    new_hist = jax.lax.dynamic_slice(
        work, (jnp.int32(0), start.astype(jnp.int32)), (lanes, cap)
    )
    new_hist = jnp.where(jnp.arange(cap) < new_hist_len, new_hist, 0.0)
    return FirRaggedState(new_hist, new_hist_len), y, n_out.astype(jnp.int32)


def _quad_demod_ragged(prev, x, n_valid, gain, use_lut):
    """x: (2, N) pairs. y[n] = gain * atan2(im, re) of x[n]*conj(x[n-1])."""
    shifted = jnp.concatenate([prev[:, None], x[:, :-1]], axis=1)
    re = x[0] * shifted[0] + x[1] * shifted[1]
    im = x[1] * shifted[0] - x[0] * shifted[1]
    y = jnp.float32(gain) * atan2_dispatch(im, re, use_lut)
    # previous sample for the next block = last VALID sample of x
    idx = jnp.clip(n_valid - 1, 0, x.shape[1] - 1)
    new_prev = jnp.where(n_valid > 0, x[:, idx], prev)
    return new_prev, y


class FrontTaps(NamedTuple):
    """Everything ``front_full`` needs of a demod config."""

    t1: np.ndarray  # LPF1 taps (natural order)
    t2: np.ndarray  # LPF2 taps
    tdc: np.ndarray | None  # DC blocker as one causal FIR, or None
    decimation: int
    quad_gain: float
    atan_mode: object  # atan2_dispatch mode

    @classmethod
    def from_config(cls, config: FskDemodConfig, atan_mode) -> "FrontTaps":
        return cls(
            np.asarray(config.lpf1_taps(), np.float32),
            np.asarray(config.lpf2_taps(), np.float32),
            np.asarray(dc_blocker_taps(config.dc_length), np.float32)
            if config.use_dc_block
            else None,
            config.decimation,
            config.quad_gain,
            atan_mode,
        )


def front_full(x_tm: jnp.ndarray, history, taps: FrontTaps):
    """The full-block front end: LPF1 -> quadrature demod -> LPF2 (+ DC).

    ``x_tm`` is (B, 2*Cp) time-major, I in lanes [0, Cp) and Q in
    [Cp, 2Cp).  ``history(stage, x, h)`` returns the ``h`` rows that
    precede stage input ``x`` in the stream (stage in "lpf1", "quad",
    "lpf2", "dc"): the carried state for one device, a ring neighbour's
    tail for a time-sharded stream.  Every history length is a static
    constant (taps-1, and 1 for the quad demod; LPF2's stays taps-1
    because B % decimation == 0), so [history, x] is a static concat.

    Returns (y (B/d, Cp), tails) where tails are the next block's
    histories (lpf1_hist, quad_prev, lpf2_hist, dc_hist).
    """
    b = x_tm.shape[0]
    cp = x_tm.shape[1] // 2
    d = taps.decimation

    h1 = len(taps.t1) - 1
    work1 = jnp.concatenate([history("lpf1", x_tm, h1), x_tm], axis=0)
    y1 = fir_tm(work1, taps.t1[::-1], 1, b)

    shifted = jnp.concatenate([history("quad", y1, 1), y1[:-1, :]], axis=0)
    i, q = y1[:, :cp], y1[:, cp:]
    si, sq = shifted[:, :cp], shifted[:, cp:]
    re = i * si + q * sq
    im = q * si - i * sq
    yq = jnp.float32(taps.quad_gain) * atan2_dispatch(im, re, taps.atan_mode)

    n2 = b // d
    h2 = len(taps.t2) - 1
    work2 = jnp.concatenate([history("lpf2", yq, h2), yq], axis=0)
    y2 = fir_tm(work2, taps.t2[::-1], d, n2)

    if taps.tdc is not None:
        # the DC blocker is LTI: one causal (4L-3)-tap FIR (delay minus
        # 4-cascade moving average, dsp/elementwise.py:dc_blocker_taps)
        h3 = len(taps.tdc) - 1
        work3 = jnp.concatenate([history("dc", y2, h3), y2], axis=0)
        y3 = fir_tm(work3, taps.tdc[::-1], 1, n2)
        dc_hist = work3[n2:, :]
    else:
        y3, dc_hist = y2, None
    return y3, (work1[b:, :], y1[-1:, :], work2[b:, :], dc_hist)


class DemodPipeline:
    """Single-jit ragged GMSK demodulator (per channel)."""

    def __init__(
        self,
        config: FskDemodConfig,
        block_size: int,
        *,
        use_atan_lut=True,  # True/"lut" | "free" (production) | False/"atan2"
        exact: bool = False,
    ):
        self.config = config
        self.block = int(block_size)
        self.use_atan_lut = use_atan_lut
        self.exact = exact
        self._t1 = np.asarray(config.lpf1_taps(), np.float32)
        self._t2 = np.asarray(config.lpf2_taps(), np.float32)
        self._tdc = (
            np.asarray(dc_blocker_taps(config.dc_length), np.float32)
            if config.use_dc_block
            else None
        )
        self._clockp = config.clock_params()
        from sdrmodem.dsp.clock_recovery import check_sps_supported

        check_sps_supported(self._clockp["omega"])  # explicit contract bound
        d = config.decimation
        self.max_mid = self.block  # lpf1 output bound
        self.max_dec = (self.block + d - 1) // d + 1
        self._step = jax.jit(self._step_impl)

    # ------------------------------------------------------------------
    def init_state(self) -> DemodState:
        d = self.config.decimation
        return DemodState(
            lpf1=FirRaggedState(
                jnp.zeros((2, len(self._t1) - 1), jnp.float32),
                jnp.int32(len(self._t1) - 1),
            ),
            quad_prev=jnp.zeros(2, jnp.float32),
            lpf2=FirRaggedState(
                jnp.zeros((1, len(self._t2) - 1 + d - 1), jnp.float32),
                jnp.int32(len(self._t2) - 1),
            ),
            dc=(
                FirRaggedState(
                    jnp.zeros((1, len(self._tdc) - 1), jnp.float32),
                    jnp.int32(len(self._tdc) - 1),
                )
                if self._tdc is not None
                else None
            ),
            clock=initial_state(self._clockp["omega"], self._clockp["mu"]),
        )

    def _step_impl(self, state: DemodState, x_pair: jnp.ndarray, n_valid: jnp.ndarray):
        cfg = self.config
        lpf1_state, y1, n1 = _fir_ragged(
            state.lpf1, x_pair, n_valid, self._t1[::-1], 1,
            self.max_mid, self.exact,
        )
        quad_prev, yq = _quad_demod_ragged(
            state.quad_prev, y1, n1, cfg.quad_gain, self.use_atan_lut
        )
        lpf2_state, y2, n2 = _fir_ragged(
            state.lpf2, yq[None, :], n1, self._t2[::-1], cfg.decimation,
            self.max_dec, self.exact,
        )
        if self._tdc is not None:
            dc_state, y3, n3 = _fir_ragged(
                state.dc, y2, n2, self._tdc[::-1], 1,
                self.max_dec, self.exact,
            )
        else:
            dc_state, y3, n3 = state.dc, y2, n2
        p = self._clockp
        outs, count, clock_state = clock_mm_stream(
            y3[0],
            omega=p["omega"],
            gain_omega=p["gain_omega"],
            mu=p["mu"],
            gain_mu=p["gain_mu"],
            omega_relative_limit=p["omega_relative_limit"],
            state=state.clock,
            n_valid=n3,
        )
        new_state = DemodState(lpf1_state, quad_prev, lpf2_state, dc_state, clock_state)
        return new_state, float_to_int8(outs), count

    def _front_impl(self, state: DemodState, x_pair: jnp.ndarray, n_valid: jnp.ndarray):
        """Filter front-end only (everything before clock recovery)."""
        cfg = self.config
        lpf1_state, y1, n1 = _fir_ragged(
            state.lpf1, x_pair, n_valid, self._t1[::-1], 1,
            self.max_mid, self.exact,
        )
        quad_prev, yq = _quad_demod_ragged(
            state.quad_prev, y1, n1, cfg.quad_gain, self.use_atan_lut
        )
        lpf2_state, y2, n2 = _fir_ragged(
            state.lpf2, yq[None, :], n1, self._t2[::-1], cfg.decimation,
            self.max_dec, self.exact,
        )
        if self._tdc is not None:
            dc_state, y3, n3 = _fir_ragged(
                state.dc, y2, n2, self._tdc[::-1], 1,
                self.max_dec, self.exact,
            )
        else:
            dc_state, y3, n3 = state.dc, y2, n2
        return (lpf1_state, quad_prev, lpf2_state, dc_state), y3[0], n3

    def _front_batched(self, state: DemodState, x: jnp.ndarray, n_valid: jnp.ndarray):
        """Channel-batched front-end for the fast path: the per-channel
        ragged bookkeeping is vmapped, but every FIR runs as ONE banded
        matmul with all channel lanes in the matrix columns, instead of a
        2-column matmul per channel."""
        cfg = self.config
        c = x.shape[0]

        def fir_stage(fir_state, xs, nv, rev, d, max_out, cap):
            t = len(rev)

            def prep(st, xx, n):
                work = _left_align(st.hist, st.hist_len, xx, cap)
                work_len = st.hist_len + n
                work = jnp.where(jnp.arange(work.shape[-1]) < work_len, work, 0.0)
                return work, work_len

            works, work_lens = jax.vmap(prep)(fir_state, xs, nv)  # (C, lanes, W)
            lanes, w = works.shape[1], works.shape[2]
            y = conv1d_banded(works.reshape(c * lanes, w), rev, d, max_out)
            y = y.reshape(c, lanes, max_out)

            def post(st, work, work_len):
                n_out = jnp.maximum(work_len - (t - 1) + d - 1, 0) // d
                consumed = n_out * d
                new_hist_len = (work_len - consumed).astype(jnp.int32)
                start = jnp.clip(consumed, 0, work.shape[-1] - cap)
                new_hist = jax.lax.dynamic_slice(
                    work, (jnp.int32(0), start.astype(jnp.int32)), (work.shape[0], cap)
                )
                new_hist = jnp.where(jnp.arange(cap) < new_hist_len, new_hist, 0.0)
                return FirRaggedState(new_hist, new_hist_len), n_out.astype(jnp.int32)

            new_states, n_outs = jax.vmap(post)(fir_state, works, work_lens)
            return new_states, y, n_outs

        lpf1_state, y1, n1 = fir_stage(
            state.lpf1, x, n_valid, self._t1[::-1], 1, self.max_mid, len(self._t1) - 1
        )
        quad_prev, yq = jax.vmap(
            lambda pv, xx, n: _quad_demod_ragged(pv, xx, n, cfg.quad_gain, self.use_atan_lut)
        )(state.quad_prev, y1, n1)
        d = cfg.decimation
        lpf2_state, y2, n2 = fir_stage(
            state.lpf2, yq[:, None, :], n1, self._t2[::-1], d,
            self.max_dec, len(self._t2) - 1 + d - 1,
        )
        if self._tdc is not None:
            dc_state, y3, n3 = self._dc_cumsum_stage(state.dc, y2[:, 0:1, :], n2)
        else:
            dc_state, y3, n3 = state.dc, y2, n2
        return (lpf1_state, quad_prev, lpf2_state, dc_state), y3[:, 0, :], n3

    def _dc_cumsum_stage(self, dc_state: FirRaggedState, x: jnp.ndarray, n_valid):
        """DC blocker via cascaded cumsum moving averages — O(1)/sample
        instead of a 637-tap FIR (fast path only; the conv path remains the
        parity reference).

        out[t] = work[t - 2(L-1)] - MA_L^4(work)[t], computed entirely from
        the raw-input work buffer: the carried history (4L-4 samples) gives
        every nested average its full lookback.
        """
        ll = self.config.dc_length
        cap = dc_state.hist.shape[-1]  # 4L - 4
        t_delay = 2 * (ll - 1)

        def prep(st, xx, n):
            work = _left_align(st.hist, st.hist_len, xx, cap)
            work_len = st.hist_len + n
            work = jnp.where(jnp.arange(work.shape[-1]) < work_len, work, 0.0)
            return work, work_len

        works, work_lens = jax.vmap(prep)(dc_state, x, n_valid)  # (C, 1, W)
        w = works.shape[-1]
        flat = works[:, 0, :]  # (C, W)

        def ma(v):
            s = jnp.cumsum(v, axis=-1)
            shifted = jnp.concatenate(
                [jnp.zeros((v.shape[0], ll), v.dtype), s[:, :-ll]], axis=-1
            )
            return (s - shifted) * jnp.float32(1.0 / ll)

        m = ma(ma(ma(ma(flat))))
        # output k corresponds to work position k + cap (the first cap
        # positions are history); same count bookkeeping as a 4L-3-tap FIR
        t_taps = 4 * ll - 3
        n_out = jnp.maximum(work_lens - (t_taps - 1), 0)
        delayed = flat[:, cap - t_delay : w - t_delay][:, : self.max_dec]
        ma4 = m[:, cap:w][:, : self.max_dec]
        pad = self.max_dec - delayed.shape[-1]
        if pad > 0:
            delayed = jnp.pad(delayed, ((0, 0), (0, pad)))
            ma4 = jnp.pad(ma4, ((0, 0), (0, pad)))
        y = (delayed - ma4)[:, None, :]  # (C, 1, max_dec)

        def post(st, work, work_len, nout):
            consumed = nout
            new_hist_len = (work_len - consumed).astype(jnp.int32)
            start = jnp.clip(consumed, 0, work.shape[-1] - cap)
            new_hist = jax.lax.dynamic_slice(
                work, (jnp.int32(0), start.astype(jnp.int32)), (1, cap)
            )
            new_hist = jnp.where(jnp.arange(cap) < new_hist_len, new_hist, 0.0)
            return FirRaggedState(new_hist, new_hist_len)

        new_states = jax.vmap(post)(dc_state, works, work_lens, n_out)
        return new_states, y, n_out.astype(jnp.int32)

    # ------------------------------------------------------------------
    # full-block fast path: static history lengths, no ragged bookkeeping
    def init_full_state(self, channels: int) -> DemodStateFull:
        d = self.config.decimation
        if self.block % d != 0:
            raise ValueError("full-block path requires block % decimation == 0")
        p = self._clockp
        cp = -(-channels // 128) * 128  # lane-padded channel count
        return DemodStateFull(
            lpf1_hist=jnp.zeros((len(self._t1) - 1, 2 * cp), jnp.float32),
            quad_prev=jnp.zeros((1, 2 * cp), jnp.float32),
            lpf2_hist=jnp.zeros((len(self._t2) - 1, cp), jnp.float32),
            dc_hist=(
                jnp.zeros((4 * self.config.dc_length - 4, cp), jnp.float32)
                if self._tdc is not None
                else None
            ),
            clock=initial_full_state(p["omega"], cp, p["mu"]),
        )

    def _front_batched_full(self, state: DemodStateFull, x_tm: jnp.ndarray):
        """Front-end when every channel consumes exactly ``block`` samples:
        ``front_full`` with the carried state as every stage's history."""
        hists = {
            "lpf1": state.lpf1_hist,
            "quad": state.quad_prev,
            "lpf2": state.lpf2_hist,
            "dc": state.dc_hist,
        }
        return front_full(
            x_tm, lambda stage, x, h: hists[stage], self.front_taps()
        )

    def front_taps(self) -> "FrontTaps":
        return FrontTaps.from_config(self.config, self.use_atan_lut)

    def make_batched_step_full(
        self, clock_backend: str | None = None, *,
        doppler: bool = False, layout: str = "cm", jit: bool = True,
    ):
        """Batched full-block step: (state, x) -> (state', symbols (C, 1, K),
        counts (C, 1)).  Every channel advances by exactly ``block``
        samples; the server's batch feeder accumulates partial chunks
        host-side.  ``clock_backend`` is "kernel" or "scan"; None takes the
        platform's choice (ops/select.py).

        ``layout`` picks the input convention (C = lane count of the state):
          - "cm"     x is (C, 2, B) channel-major; one (C,2,B) -> (B,2C)
                     device transpose at the input (the only re-layout in
                     the whole step).
          - "tm"     x is (B, 2*Cp) already time-major (I in lanes [0,Cp),
                     Q in [Cp,2Cp)) — the step's native layout, no
                     re-layout on device.
          - "fanout" x is (2, B): ONE shared IQ stream broadcast to every
                     lane on-device (the reference's sdr_worker fan-out,
                     src/sdr_worker.c:31-55, where all clients of one SDR
                     connection see the same samples).  Per-lane Doppler
                     still differentiates lanes after the broadcast.

        With ``doppler=True`` the step takes an extra
        (starts, ends, adjs, ph0s) tuple of (S, C) float32 tables (from
        Doppler.device_segments) and applies the per-lane NCO multiply
        in-stream before LPF1 — the device half of Doppler correction.
        Lanes with no active rows pass through bit-identically."""
        from sdrmodem.ops import select

        if self.exact:
            raise ValueError("the full-block fast path is float32-only")
        if layout not in ("cm", "tm", "fanout"):
            raise ValueError(f"unknown layout {layout!r}")
        clock = select.clock_backend(clock_backend)
        p = self._clockp

        def step(state: DemodStateFull, x: jnp.ndarray, dop=None):
            cp = state.quad_prev.shape[1] // 2
            if layout == "cm":
                c = x.shape[0]
                x_tm = jnp.transpose(x, (2, 1, 0))  # (B, 2, C)
                if cp != c:
                    x_tm = jnp.pad(x_tm, ((0, 0), (0, 0), (0, cp - c)))
                x_tm = x_tm.reshape(self.block, 2 * cp)
            elif layout == "fanout":
                c = cp
                # (2, B) -> (B, 2Cp): pure broadcast, no transpose of bulk data
                x_tm = jnp.concatenate(
                    [
                        jnp.broadcast_to(x[0][:, None], (self.block, cp)),
                        jnp.broadcast_to(x[1][:, None], (self.block, cp)),
                    ],
                    axis=1,
                )
            else:  # "tm"
                c = cp
                x_tm = x
            if dop is not None:
                x_tm = nco_mix_pair_tm(x_tm, *dop)
            y3, fstate = self._front_batched_full(state, x_tm)
            outs, counts, clock_state = clock_mm_batched_full(
                y3, state.clock,
                omega=p["omega"], gain_omega=p["gain_omega"], mu=p["mu"],
                gain_mu=p["gain_mu"],
                omega_relative_limit=p["omega_relative_limit"],
                backend=clock,
            )
            new_state = DemodStateFull(*fstate, clock_state)
            return new_state, float_to_int8(outs[:c]), counts[:c]

        if doppler:
            return jax.jit(step) if jit else step
        plain = lambda state, x: step(state, x)
        return jax.jit(plain) if jit else plain

    def make_batched_step(self):
        """Batched (channel-axis) ragged step: the reference the full-block
        step is tested against; the clock is the vmapped scan."""
        p = self._clockp

        def step(state: DemodState, x: jnp.ndarray, n_valid: jnp.ndarray):
            if not self.exact:
                front_states, y3, n3 = self._front_batched(state, x, n_valid)
            else:
                front_states, y3, n3 = jax.vmap(self._front_impl)(state, x, n_valid)
            outs, counts, clock_state = jax.vmap(
                lambda d, s, n: clock_mm_stream(
                    d, state=s, n_valid=n,
                    omega=p["omega"], gain_omega=p["gain_omega"], mu=p["mu"],
                    gain_mu=p["gain_mu"],
                    omega_relative_limit=p["omega_relative_limit"],
                )
            )(y3, state.clock, n3)
            new_state = DemodState(*front_states, clock_state)
            return new_state, float_to_int8(outs), counts

        return jax.jit(step)

    # ------------------------------------------------------------------
    # host-side streaming wrapper
    def streamer(self) -> "DemodStreamer":
        return DemodStreamer(self)


class DemodStreamer:
    def __init__(self, pipeline: DemodPipeline):
        self.p = pipeline
        self.state = pipeline.init_state()

    def process(self, iq: np.ndarray) -> np.ndarray:
        """complex64 chunk of ANY length -> int8 symbols (may span blocks)."""
        iq = np.asarray(iq, np.complex64)
        out = []
        for start in range(0, len(iq), self.p.block):
            chunk = iq[start : start + self.p.block]
            buf = np.zeros((2, self.p.block), np.float32)
            buf[0, : len(chunk)] = chunk.real
            buf[1, : len(chunk)] = chunk.imag
            self.state, symbols, count = self.p._step(
                self.state, jnp.asarray(buf), jnp.int32(len(chunk))
            )
            c = int(count)
            if c:
                out.append(np.asarray(symbols)[:c])
        return np.concatenate(out) if out else np.zeros(0, np.int8)
