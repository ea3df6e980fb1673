"""Mueller & Müller symbol-timing recovery as a `lax.scan`.

Reference: src/dsp/clock_recovery_mm.c:78-139 plus the 8-tap MMSE
fractional-delay interpolator (src/dsp/mmse_fir_interpolator.c:188-191).

The loop is inherently sequential with data-dependent input strides:

    y_k     = dot(x[ii .. ii+7], bank[rint(mu * 128)])
    mm      = sgn(last) * y_k - sgn(y_k) * last
    omega  <- omega_mid + clip(omega + g_o * mm - omega_mid, +-lim)
    mu     <- mu + omega + g_m * mm;   ii += floor(mu);   mu -= floor(mu)

(NaN input emits 0.0 and strides floor(omega), reference :107-113.)

Formulated here as a fixed-length scan over output symbols with masked
validity: once the read pointer runs past the available input the step
becomes a no-op, so the emitted count is data-dependent but shapes stay
static (XLA-friendly).  Batching over channels is `jax.vmap`.

Per-block carried state {omega, mu, last_sample, input tail} is exactly
the reference's history hand-off (:119-135) and is what gets exchanged
between time-shards in the multi-device pipeline.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sdrmodem.dsp import taps as taps_mod

NTAPS = taps_mod.MMSE_INTERP_NTAPS  # 8
NSTEPS = taps_mod.MMSE_INTERP_NSTEPS  # 128

# Maximum input tail carried between blocks: the loop stops with
# ii > L - 8, and a single stride is at most ceil(omega*(1+limit)) + 1,
# so the un-consumed tail is < 8 + max_stride.  The state capacity is
# DERIVED from omega at construction (the reference carries a
# variable-length history with no bound, src/dsp/clock_recovery_mm.c:
# 127-135); the floors keep the historical state shapes (and checkpoint
# compatibility) for the common sps ranges.
TAIL_CAP = 32  # floor: covers sps <= ~22


def tail_cap_for(omega: float, omega_relative_limit: float = 0.01) -> int:
    """Tail capacity (multiple of 8) provably >= the largest unconsumed
    tail for this omega: NTAPS + ceil(omega*(1+limit)) + 1."""
    need = NTAPS + int(np.ceil(float(omega) * (1.0 + omega_relative_limit))) + 2
    return max(TAIL_CAP, -(-need // 8) * 8)


class ClockState(NamedTuple):
    omega: jnp.ndarray  # () f32
    mu: jnp.ndarray  # () f32
    last_sample: jnp.ndarray  # () f32
    tail: jnp.ndarray  # (TAIL_CAP,) f32 — unconsumed input samples
    tail_len: jnp.ndarray  # () i32


# Fixed-size suffix carried by the full-block fast path.  SUFFIX is the
# FLOOR (covers sps <= ~53); the actual capacity is derived from omega at
# state construction (suffix_cap_for), always a multiple of 8.
SUFFIX = 64


def suffix_cap_for(omega: float, omega_relative_limit: float = 0.01) -> int:
    """Suffix capacity (multiple of 8) provably >= the largest unconsumed
    tail for this omega — the full-block analog of ``tail_cap_for``."""
    need = NTAPS + int(np.ceil(float(omega) * (1.0 + omega_relative_limit))) + 2
    return max(SUFFIX, -(-need // 8) * 8)


# Largest supported samples-per-symbol: the carried tail/suffix grows
# linearly with omega, so an explicit contract bound replaces a silent
# state-capacity clip (the reference carries an unbounded malloc'd
# history instead, src/dsp/clock_recovery_mm.c:127-135).  512 sps is far
# past any real GMSK configuration (the fixtures run 4.8-25); beyond it,
# raise/reject with guidance to increase demod_decimation.
MAX_SPS = 512.0


def check_sps_supported(omega: float) -> None:
    if float(omega) > MAX_SPS:
        raise ValueError(
            f"samples-per-symbol {float(omega):.1f} exceeds the supported "
            f"bound {MAX_SPS:.0f} (clock state capacity); increase "
            "demod_decimation so Fs/baud/decimation <= "
            f"{MAX_SPS:.0f}"
        )


class ClockFullState(NamedTuple):
    """State of the full-block clock path (time-major, channel-last).

    Instead of extracting the variable-length unconsumed tail (a
    per-channel dynamic slice), the full-block path carries the last
    ``SUFFIX`` input samples verbatim (a static slice) plus ``resid``, the
    number of them not yet consumed.  The next block prepends the suffix and starts
    its read pointer at ``SUFFIX - resid`` — numerically identical to the
    reference's tail hand-off (src/dsp/clock_recovery_mm.c:119-135).
    """

    omega: jnp.ndarray  # (C,) f32
    mu: jnp.ndarray  # (C,) f32
    last_sample: jnp.ndarray  # (C,) f32
    suffix: jnp.ndarray  # (SUFFIX, C) f32 — last SUFFIX input samples
    resid: jnp.ndarray  # (C,) i32 — unconsumed count (< SUFFIX)


def initial_full_state(omega: float, channels: int, mu: float = 0.5) -> ClockFullState:
    return ClockFullState(
        omega=jnp.full((channels,), omega, jnp.float32),
        mu=jnp.full((channels,), mu, jnp.float32),
        last_sample=jnp.zeros((channels,), jnp.float32),
        suffix=jnp.zeros((suffix_cap_for(omega), channels), jnp.float32),
        resid=jnp.zeros((channels,), jnp.int32),
    )


def mm_params(sps: float) -> dict:
    """The reference fsk_demod's M&M constants (src/dsp/fsk_demod.c:63-67)."""
    sps = np.float32(sps)
    return dict(
        omega=float(sps),
        gain_omega=float(np.float32(sps * np.float32(np.pi)) / np.float32(100.0)),
        mu=0.5,
        gain_mu=0.0625,
        omega_relative_limit=0.01,
    )


def initial_state(omega: float, mu: float = 0.5) -> ClockState:
    return ClockState(
        omega=jnp.float32(omega),
        mu=jnp.float32(mu),
        last_sample=jnp.float32(0.0),
        tail=jnp.zeros(tail_cap_for(omega), jnp.float32),
        tail_len=jnp.int32(0),
    )


def max_symbols(n_in: int, omega_mid: float, omega_relative_limit: float, gain_mu: float) -> int:
    """Static upper bound on symbols produced from n_in input samples."""
    min_stride = max(1.0, np.floor(omega_mid * (1.0 - omega_relative_limit) - 4.0 * gain_mu))
    return int(np.ceil(n_in / min_stride)) + 2


def _slice_sign(x):
    return jnp.where(x < 0, jnp.float32(-1.0), jnp.float32(1.0))


def _branchless_clip(x, clip):
    return jnp.float32(0.5) * (jnp.abs(x + clip) - jnp.abs(x - clip))


def clock_mm_stream(
    x: jnp.ndarray,
    *,
    omega: float,
    gain_omega: float,
    mu: float = 0.5,
    gain_mu: float = 0.0625,
    omega_relative_limit: float = 0.01,
    state: ClockState | None = None,
    n_valid: jnp.ndarray | int | None = None,
    num_symbols: int | None = None,
):
    """Run M&M clock recovery over a 1-D float32 stream.

    x: (L,) float32.  ``state`` carries {omega, mu, last, tail} across
    blocks (tail is prepended to x).  ``n_valid`` marks how many samples of
    x are meaningful (for ragged last blocks).  Returns
    (symbols (K,) f32, count () i32, new_state) where K is the static
    ``num_symbols`` bound and only the first ``count`` entries are valid.

    Batch over channels with ``jax.vmap``.
    """
    banks = jnp.asarray(taps_mod.mmse_interp_taps())  # (129, 8)
    omega_mid = np.float32(omega)
    omega_lim = np.float32(omega_mid * np.float32(omega_relative_limit))

    ln = x.shape[-1]
    if state is None:
        state = initial_state(omega, mu)
        cap = state.tail.shape[0]  # capacity derives from omega (tail_cap_for)
        work = jnp.concatenate([x.astype(jnp.float32), jnp.zeros(cap, jnp.float32)])
        base_valid = jnp.asarray(ln if n_valid is None else n_valid, jnp.int32)
        ii0 = jnp.int32(0)
    else:
        cap = state.tail.shape[0]
        # tail_len < 0 encodes a SKIP: the previous block's final stride
        # overshot its end by -tail_len samples, so this block starts its
        # read pointer there instead of at 0.  (The reference instead
        # rewinds to the previously processed position on overshoot,
        # src/dsp/clock_recovery_mm.c:126-131 — making its output depend
        # on the buffer size whenever sps > 8.  Carrying the exact
        # overshoot keeps the symbol trajectory block-size-invariant,
        # which the time-sharded paths rely on.)
        tl = jnp.maximum(state.tail_len, 0)
        ii0 = jnp.maximum(-state.tail_len, 0).astype(jnp.int32)
        # work = [tail, x, pad]; valid length = tail_len + n_valid
        work = jnp.concatenate(
            [state.tail, x.astype(jnp.float32), jnp.zeros(cap, jnp.float32)]
        )
        # left-align [tail[:tail_len], x, ...]: positions >= tail_len skip the
        # unused remainder of the fixed-capacity tail buffer
        i = jnp.arange(work.shape[0])
        idx = jnp.where(i < tl, i, i + (cap - tl))
        work = jnp.take(work, jnp.clip(idx, 0, work.shape[0] - 1))
        base_valid = tl + jnp.asarray(
            ln if n_valid is None else n_valid, jnp.int32
        )

    if num_symbols is None:
        num_symbols = max_symbols(
            ln + cap, float(omega_mid), omega_relative_limit, gain_mu
        )

    (ii_f, mu_f, omega_f, last_f, count), outs = _mm_scan_core(
        work,
        base_valid,
        ii0,
        jnp.asarray(state.mu, jnp.float32),
        jnp.asarray(state.omega, jnp.float32),
        jnp.asarray(state.last_sample, jnp.float32),
        omega_mid=omega_mid,
        omega_lim=omega_lim,
        gain_omega=gain_omega,
        gain_mu=gain_mu,
        num_symbols=int(num_symbols),
    )

    # Tail hand-off: keep work[ii_f:valid_len].  When the final stride
    # overshot the block end (ii_f > valid, possible whenever sps > 8),
    # tail_len goes NEGATIVE — the exact skip into the next block —
    # instead of the reference's rewind-to-previous (:126-131), keeping
    # the output block-size-invariant (see the skip note above).
    lmax = work.shape[0]
    last_index = jnp.minimum(ii_f, base_valid)
    tail_len = jnp.minimum(base_valid - ii_f, cap)
    start = jnp.clip(last_index, 0, lmax - cap)
    tail = jax.lax.dynamic_slice(work, (start,), (cap,))
    tail = jnp.where(jnp.arange(cap) < jnp.maximum(tail_len, 0), tail, 0.0)

    new_state = ClockState(omega_f, mu_f, last_f, tail, tail_len.astype(jnp.int32))
    return outs, count, new_state


def mul_separate(a, b):
    """``a * b`` rounded on its own.  The barrier keeps XLA from fusing the
    product into the add that consumes it: a fused multiply-add rounds
    once, the reference (plain float32 C, no fma) rounds twice, and the
    chaotic M&M loop turns that one-ulp difference into a different timing
    trajectory."""
    return jax.lax.optimization_barrier(a * b)


def mm_interp(window, taps, mul=mul_separate):
    """The 8-tap MMSE interpolation sum(window[t] * taps[t]) in float32, in
    the reference's sequential order with every product rounded on its own
    (the volk generic dot product, src/dsp/mmse_fir_interpolator.c:188-191).
    The scan and the GPU kernel both call this; ``mul`` is the product
    their compiler cannot contract."""
    acc = mul(window[0], taps[0])
    for t in range(1, NTAPS):
        acc = acc + mul(window[t], taps[t])
    return acc


def mm_update(y, mu, omega, last, *, omega_mid, omega_lim, gain_omega, gain_mu):
    """One M&M decision after the interpolated sample ``y`` (reference
    src/dsp/clock_recovery_mm.c:100-118), shared by the scan and the GPU
    kernel.  Returns (out, is_nan, mu', omega', stride): the caller applies
    mu'/omega'/out for a valid, non-NaN symbol; on NaN it keeps mu, omega
    and last and strides ``stride`` = floor(omega).

    ``omega + gain_omega * mm`` is the one update whose rounding a
    compiler could change (fused or not).  It runs as a fused multiply-add
    on every backend: the float64 product of two float32 values is exact,
    and the float64 sum rounds to float32 like an fma.  The other products
    (signs, 2^-4, 0.5) are exact."""
    is_nan = jnp.isnan(y)
    out = jnp.where(is_nan, jnp.float32(0.0), y)
    mm = _slice_sign(last) * out - _slice_sign(out) * last
    omega_n = (
        omega.astype(jnp.float64)
        + np.float64(np.float32(gain_omega)) * mm.astype(jnp.float64)
    ).astype(jnp.float32)
    omega_n = jnp.float32(omega_mid) + _branchless_clip(
        omega_n - jnp.float32(omega_mid), jnp.float32(omega_lim)
    )
    mu_n = mu + omega_n + jnp.float32(gain_mu) * mm
    stride_n = jnp.floor(mu_n)
    mu_n = mu_n - stride_n
    stride = jnp.where(is_nan, jnp.floor(omega), stride_n)
    return out, is_nan, mu_n, omega_n, stride


def _mm_scan_core(
    work: jnp.ndarray,  # (L,) f32
    base_valid,  # () i32
    ii0,  # () i32 — initial read pointer
    mu0,
    omega0,
    last0,
    *,
    omega_mid,
    omega_lim,
    gain_omega,
    gain_mu,
    num_symbols: int,
):
    """The sequential M&M loop (reference src/dsp/clock_recovery_mm.c:78-139)
    as a fixed-length masked scan.  Returns ((ii, mu, omega, last, count), outs)."""
    banks = jnp.asarray(taps_mod.mmse_interp_taps())  # (129, 8)
    lmax = work.shape[0]

    def step(carry, _):
        ii, mu_c, omega_c, last, count = carry
        valid = ii <= base_valid - NTAPS
        ii_c = jnp.clip(ii, 0, lmax - NTAPS)
        window = jax.lax.dynamic_slice(work, (ii_c,), (NTAPS,))
        imu = jnp.clip(jnp.round(mu_c * NSTEPS).astype(jnp.int32), 0, NSTEPS)
        taps = banks[imu]
        y = mm_interp([window[t] for t in range(NTAPS)], [taps[t] for t in range(NTAPS)])
        out, is_nan, mu_n, omega_n, stride = mm_update(
            y, mu_c, omega_c, last,
            omega_mid=omega_mid, omega_lim=omega_lim,
            gain_omega=gain_omega, gain_mu=gain_mu,
        )
        step_ok = valid & ~is_nan
        carry = (
            jnp.where(valid, ii + stride.astype(jnp.int32), ii),
            jnp.where(step_ok, mu_n, mu_c),
            jnp.where(step_ok, omega_n, omega_c),
            jnp.where(step_ok, out, last),
            count + valid.astype(jnp.int32),
        )
        return carry, jnp.where(valid, out, jnp.float32(0.0))

    init = (
        jnp.asarray(ii0, jnp.int32),
        jnp.asarray(mu0, jnp.float32),
        jnp.asarray(omega0, jnp.float32),
        jnp.asarray(last0, jnp.float32),
        jnp.int32(0),
    )
    return jax.lax.scan(step, init, None, length=int(num_symbols))


def clock_mm_batched_full(
    x_tm: jnp.ndarray,  # (N, C) float32 time-major — every channel a FULL block
    state: ClockFullState,  # channel-last leaves
    *,
    omega: float,
    gain_omega: float,
    mu: float = 0.5,
    gain_mu: float = 0.0625,
    omega_relative_limit: float = 0.01,
    num_symbols: int | None = None,
    backend: str | None = None,
):
    """Batched M&M for the full-block fast path (suffix-carry state).

    The work buffer is the static row-concat [suffix, x]; only the read
    pointer ``SUFFIX - resid`` is dynamic, and both implementations
    consume it as part of their carried state.  ``backend`` is "kernel"
    (ops/mm_clock.py) or "scan"; None takes the platform's choice
    (ops/select.py).

    Returns (outs (C, 1, K), counts (C, 1), new_state): one chunk per
    block, in the (C, n_chunks, K) layout the consumers index.
    """
    from sdrmodem.ops import select

    backend = select.clock_backend(backend)
    n, c = x_tm.shape
    sfx = state.suffix.shape[0]  # capacity derives from omega (suffix_cap_for)
    omega_mid = np.float32(omega)
    w = n + sfx
    if num_symbols is None:
        num_symbols = max_symbols(w, float(omega_mid), omega_relative_limit, gain_mu)

    work = jnp.concatenate([state.suffix, x_tm.astype(jnp.float32)], axis=0)
    ii0 = (jnp.int32(sfx) - state.resid.astype(jnp.int32)).astype(jnp.int32)
    if backend == "kernel":
        from sdrmodem.ops.mm_clock import mm_clock

        outs, counts, fin = mm_clock(
            work,
            jnp.full((c,), w, jnp.int32),
            ii0,
            state.mu,
            state.omega,
            state.last_sample,
            omega_mid=float(omega_mid),
            omega_relative_limit=omega_relative_limit,
            gain_omega=gain_omega,
            gain_mu=gain_mu,
            num_symbols=int(num_symbols),
            interpret=select.select().interpret,
        )
        outs = outs.T
        ii_f, mu_f, omega_f, last_f = fin["ii"], fin["mu"], fin["omega"], fin["last"]
    else:
        omega_lim = np.float32(omega_mid * np.float32(omega_relative_limit))

        def one(row, i0, mu_c, om_c, la_c):
            (ii_f, mu_f, om_f, la_f, count), outs = _mm_scan_core(
                row, jnp.int32(w), i0, mu_c, om_c, la_c,
                omega_mid=omega_mid, omega_lim=omega_lim,
                gain_omega=gain_omega, gain_mu=gain_mu,
                num_symbols=int(num_symbols),
            )
            return outs, count, ii_f, mu_f, om_f, la_f

        outs, counts, ii_f, mu_f, omega_f, last_f = jax.vmap(one)(
            work.T, ii0, state.mu, state.omega, state.last_sample
        )

    # negative resid = the final stride overshot the block end: the next
    # block starts its read pointer sfx - resid > sfx samples in (exact
    # continuation instead of the reference's rewind, see clock_mm_stream)
    resid = jnp.minimum(jnp.int32(w) - ii_f, sfx - 1)
    new_state = ClockFullState(
        omega_f, mu_f, last_f, work[-sfx:, :], resid.astype(jnp.int32)
    )
    return outs[:, None, :], counts[:, None].astype(jnp.int32), new_state
