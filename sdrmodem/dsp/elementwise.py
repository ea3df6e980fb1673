"""Element-wise / short-memory stream blocks.

- ``fast_atan2``        — LUT arctangent (reference src/math/fast_atan2f.c:87-150)
- ``quad_demod_stream`` — FM discriminator (reference src/dsp/quadrature_demod.c:57-73)
- ``dc_blocker_taps`` / ``dc_blocker_stream``
                        — GNU-Radio delay-line DC blocker, re-expressed as a
                          single causal FIR (reference src/dsp/dc_blocker.c:56-119)
- ``nco_stream``        — complex NCO / frequency-translating multiply
                          (reference src/dsp/sig_source.c:43-75)
- ``freq_mod_stream``   — VCO frequency modulator (reference src/dsp/frequency_modulator.c:41-59)

All blocks are pure over the whole stream; carried state (previous sample,
phase) is an explicit argument/return so streams can be chunked or sharded.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sdrmodem.dsp import taps as taps_mod
from sdrmodem.dsp.fir import fir_stream

_TWO_PI = np.float32(2 * np.pi)


def fast_atan2(y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Vectorised table-lookup arctangent, float32.

    Bit-path equivalent of reference src/math/fast_atan2f.c:87-150: 257-entry
    table over [0, pi/4] with linear interpolation, octant folding and a
    small-angle shortcut; avg error ~6e-7 rad vs true atan2.
    """
    table = jnp.asarray(taps_mod.atan_table())
    y = y.astype(jnp.float32)
    x = x.astype(jnp.float32)
    y_abs = jnp.abs(y)
    x_abs = jnp.abs(x)
    both_zero = ~((y_abs > 0.0) | (x_abs > 0.0))
    denom = jnp.maximum(jnp.maximum(y_abs, x_abs), jnp.float32(1e-45))
    z = jnp.minimum(y_abs, x_abs) / denom

    alpha = z * jnp.float32(255.0)
    index = jnp.clip(alpha.astype(jnp.int32), 0, 255)
    frac = alpha - index.astype(jnp.float32)
    t0 = table[index]
    t1 = table[index + 1]
    interp = t0 + (t1 - t0) * frac
    tan_map_res = jnp.float32(0.003921569)  # smallest non-zero table value
    base = jnp.where(z < tan_map_res, z, interp)

    pi = jnp.float32(np.pi)
    half_pi = jnp.float32(np.pi / 2)
    # octant folding identical to the C branch ladder
    angle = jnp.where(
        x_abs > y_abs,
        jnp.where(
            x >= 0.0,
            jnp.where(y >= 0.0, base, -base),
            jnp.where(y >= 0.0, pi - base, base - pi),
        ),
        jnp.where(
            y >= 0.0,
            jnp.where(x >= 0.0, half_pi - base, half_pi + base),
            jnp.where(x >= 0.0, base - half_pi, -half_pi - base),
        ),
    )
    return jnp.where(both_zero, jnp.float32(0.0), angle)


def fast_atan2_free(y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Gather-free evaluation of the reference LUT arctangent.

    Numerically the same function as ``fast_atan2`` (the 257-entry
    piecewise-linear table of reference src/math/fast_atan2f.c:23-150), but
    the two bracketing table entries atan(k/255), atan((k+1)/255) are
    recomputed on the fly with ``jnp.arctan`` instead of gathered — each
    entry matches the stored float32 table value to <=2 ulp (~1e-7 rad,
    far below the table's own ~1.25e-6 rad interpolation error).  It is
    the fast path's quad-demod arctangent: reference LUT semantics as a
    purely elementwise chain that XLA fuses with its neighbours.
    """
    y = y.astype(jnp.float32)
    x = x.astype(jnp.float32)
    y_abs = jnp.abs(y)
    x_abs = jnp.abs(x)
    both_zero = ~((y_abs > 0.0) | (x_abs > 0.0))
    denom = jnp.maximum(jnp.maximum(y_abs, x_abs), jnp.float32(1e-45))
    z = jnp.minimum(y_abs, x_abs) / denom

    alpha = z * jnp.float32(255.0)
    index = jnp.clip(alpha.astype(jnp.int32), 0, 255)
    frac = alpha - index.astype(jnp.float32)
    inv = jnp.float32(1.0 / 255.0)
    kf = index.astype(jnp.float32)
    t0 = jnp.arctan(kf * inv)
    # table[256] duplicates table[255] as an interpolation guard
    t1 = jnp.arctan(jnp.minimum(kf + 1.0, jnp.float32(255.0)) * inv)
    interp = t0 + (t1 - t0) * frac
    tan_map_res = jnp.float32(0.003921569)
    base = jnp.where(z < tan_map_res, z, interp)

    pi = jnp.float32(np.pi)
    half_pi = jnp.float32(np.pi / 2)
    angle = jnp.where(
        x_abs > y_abs,
        jnp.where(
            x >= 0.0,
            jnp.where(y >= 0.0, base, -base),
            jnp.where(y >= 0.0, pi - base, base - pi),
        ),
        jnp.where(
            y >= 0.0,
            jnp.where(x >= 0.0, half_pi - base, half_pi + base),
            jnp.where(x >= 0.0, base - half_pi, -half_pi - base),
        ),
    )
    return jnp.where(both_zero, jnp.float32(0.0), angle)


def atan2_dispatch(im: jnp.ndarray, re: jnp.ndarray, mode) -> jnp.ndarray:
    """Select the quad-demod arctangent.

    mode: True / "lut"    -> table gather + lerp (bit path of the reference)
          "free"          -> gather-free LUT (the fast path's default)
          False / "atan2" -> plain arctan2 with the LUT's (0,0) -> 0 rule
    """
    if mode is True or mode == "lut":
        return fast_atan2(im, re)
    if mode == "free":
        return fast_atan2_free(im, re)
    both_zero = ~((jnp.abs(im) > 0) | (jnp.abs(re) > 0))
    return jnp.where(both_zero, jnp.float32(0.0), jnp.arctan2(im, re))


def quad_demod_stream(
    x: jnp.ndarray,
    gain: float,
    prev: jnp.ndarray | None = None,
    *,
    use_lut: bool = True,
) -> jnp.ndarray:
    """FM discriminator: y[n] = gain * arg(x[n] * conj(x[n-1])).

    x: (..., N) complex64.  ``prev`` is the carried 1-sample history
    (defaults to 0, the reference's fresh state, which makes y[0] = 0
    because atan2(0, 0) = 0).
    """
    if prev is None:
        prev = jnp.zeros(x.shape[:-1] + (1,), x.dtype)
    else:
        prev = jnp.broadcast_to(prev, x.shape[:-1] + (1,)).astype(x.dtype)
    shifted = jnp.concatenate([prev, x[..., :-1]], axis=-1)
    prod = x * jnp.conj(shifted)
    im, re = jnp.imag(prod), jnp.real(prod)
    return jnp.float32(gain) * atan2_dispatch(im, re, use_lut)


def dc_blocker_length(sps: float) -> int:
    """Reference DC blocker length: ceil(sps * 32) (src/dsp/fsk_demod.c:56)."""
    return int(np.ceil(np.float32(sps) * 32))


def dc_blocker_taps(length: int) -> np.ndarray:
    """Equivalent causal FIR taps of the 4-stage moving-average DC blocker.

    The reference (src/dsp/dc_blocker.c:105-119) computes, per sample,
    out[t] = x[t - 2(L-1)] - MA_L^4(x)[t] where MA_L is a length-L
    moving average implemented as a running-sum recurrence and the
    delayed path is a 2(L-1)-sample delay line (both zero-initialised,
    equivalent to a zero-pre-padded stream).  Composing the four averages
    gives a single causal FIR of length 4L-3:

        taps[j] = delta[j - 2(L-1)] - (u*u*u*u)[j],   u = ones(L)/L
    """
    u = np.full(length, 1.0 / length, np.float64)
    k = np.convolve(np.convolve(u, u), np.convolve(u, u))  # length 4L-3
    taps = -k
    taps[2 * (length - 1)] += 1.0
    return taps.astype(np.float32)


def dc_blocker_stream(x: jnp.ndarray, length: int) -> jnp.ndarray:
    """Apply the DC blocker over a whole stream (zero initial state)."""
    return fir_stream(x, dc_blocker_taps(length), 1)


def nco_phases(
    freq: jnp.ndarray,
    n: int,
    sampling_freq: float,
    phase0: jnp.ndarray | float = 0.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Phases of a complex NCO at integer frequency ``freq`` for n samples.

    Matches reference src/dsp/sig_source.c:43-58: per-sample increment
    adj = float32(2*pi*freq/Fs); sample i gets phase0 + i*adj.  The C code
    accumulates in float32 with +-2pi wrapping; here the ramp is computed
    exactly (i*adj in float64, reduced mod 2pi) which tracks the C
    trajectory to < 1e-3 rad over millions of samples — well inside the
    golden-test tolerance — and is chunk/shard invariant.

    Returns (phases[n] float32, next_phase0 float64-like scalar).
    """
    adj = (_TWO_PI * jnp.asarray(freq, jnp.float32) / np.float32(sampling_freq)).astype(
        jnp.float32
    )
    i = jnp.arange(n, dtype=jnp.float64)
    ramp = jnp.mod(i * adj.astype(jnp.float64), 2 * np.pi)
    phase = jnp.mod(jnp.asarray(phase0, jnp.float64) + ramp, 2 * np.pi)
    next_phase = jnp.mod(jnp.asarray(phase0, jnp.float64) + n * adj.astype(jnp.float64), 2 * np.pi)
    return phase.astype(jnp.float32), next_phase


def nco_stream(
    freq,
    n: int,
    sampling_freq: float,
    amplitude: float = 1.0,
    phase0=0.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Complex NCO output (cos + j sin) and the carried phase."""
    phase, next_phase = nco_phases(freq, n, sampling_freq, phase0)
    out = jnp.float32(amplitude) * jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
    return out, next_phase


def freq_mod_stream(
    x: jnp.ndarray,
    sensitivity: float,
    phase0=0.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """VCO: phase[n] = phase0 + sensitivity * cumsum(x); out = exp(j*phase).

    Matches reference src/dsp/frequency_modulator.c:48-57 (which wraps the
    float32 phase at +-2pi; here the cumulative sum is carried in float64
    and reduced mod 2pi, equivalent within float32 resolution).

    x: (..., N) float32.  Returns ((..., N) complex64, next phase scalar).
    """
    inc = (jnp.float32(sensitivity) * x.astype(jnp.float32)).astype(jnp.float64)
    phase = jnp.asarray(phase0, jnp.float64) + jnp.cumsum(inc, axis=-1)
    next_phase = jnp.mod(phase[..., -1], 2 * np.pi)
    ph32 = jnp.mod(phase, 2 * np.pi).astype(jnp.float32)
    return jax.lax.complex(jnp.cos(ph32), jnp.sin(ph32)), next_phase


def nco_mix_pair_tm(
    x_tm: jnp.ndarray,  # (B, 2*Cp) f32 time-major, I lanes [0,Cp) Q [Cp,2Cp)
    starts: jnp.ndarray,  # (S, Cp) f32 — row-active from starts[s]
    ends: jnp.ndarray,  # (S, Cp) f32 — ... to ends[s] (exclusive)
    adjs: jnp.ndarray,  # (S, Cp) f32 — per-sample phase increment
    ph0s: jnp.ndarray,  # (S, Cp) f32 — phase at the row's first sample
) -> jnp.ndarray:
    """Per-lane piecewise-linear-phase NCO multiply in the time-major
    layout — the device half of Doppler correction (host: SGP4 at 1 Hz →
    Doppler.device_segments; reference src/dsp/doppler.c:164-186 +
    src/dsp/sig_source.c:60-75).

    Sample n of lane c gets phase ph0s[s,c] + (n - starts[s,c]) *
    adjs[s,c] for the row s whose [start, end) contains n, and phase 0
    (an EXACT identity multiply: i*1 - q*0 = i) where no row matches —
    so doppler-free lanes pass through bit-identical and the mix can be
    unconditionally fused into the batched step.  S is a small static
    bound (Doppler.max_rows), so this is S fused compare+FMA passes —
    trivial next to the FIR matmuls.
    """
    b, cp2 = x_tm.shape
    cp = cp2 // 2
    s_rows = starts.shape[0]
    n = jax.lax.broadcasted_iota(jnp.float32, (b, 1), 0)
    phase = jnp.zeros((b, cp), jnp.float32)
    # two-level ramp: d*adj for d up to a whole 1 Hz segment would lose
    # f32 bits, so d = k*4096 + m and the per-4096 phase step is computed
    # once per row in f64 (reduced mod 2pi) — rows no longer need the
    # 4096-sample split (Doppler.MAX_SEG), cutting the O(rows)/sample mix
    # passes ~12x on large blocks.  Rows with d < 4096 take k = 0 and are
    # BIT-IDENTICAL to the single-level ramp, so split tables still match.
    steps = jnp.mod(adjs.astype(jnp.float64) * 4096.0, 2 * np.pi).astype(jnp.float32)
    for s in range(s_rows):
        active = (n >= starts[s][None, :]) & (n < ends[s][None, :])
        d = n - starts[s][None, :]
        k = jnp.floor(d * jnp.float32(1.0 / 4096.0))
        m = d - k * jnp.float32(4096.0)
        ramp = ph0s[s][None, :] + m * adjs[s][None, :] + k * steps[s][None, :]
        phase = phase + jnp.where(active, ramp, 0.0)
    c, si = jnp.cos(phase), jnp.sin(phase)
    i, q = x_tm[:, :cp], x_tm[:, cp:]
    return jnp.concatenate([i * c - q * si, i * si + q * c], axis=1)


def freq_mod_stream_pair(
    x: jnp.ndarray,
    sensitivity: float,
    phase0=0.0,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """``freq_mod_stream`` without a complex dtype: returns (I, Q, next
    phase) float32 arrays, so the TX path carries IQ as pairs like the RX
    pipeline (dsp/pipeline.py) and combines them on the host."""
    inc = (jnp.float32(sensitivity) * x.astype(jnp.float32)).astype(jnp.float64)
    phase = jnp.asarray(phase0, jnp.float64) + jnp.cumsum(inc, axis=-1)
    next_phase = jnp.mod(phase[..., -1], 2 * np.pi)
    ph32 = jnp.mod(phase, 2 * np.pi).astype(jnp.float32)
    return jnp.cos(ph32), jnp.sin(ph32), next_phase
