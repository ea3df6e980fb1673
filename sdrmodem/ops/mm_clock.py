"""Mueller & Müller clock recovery as a Pallas kernel for NVIDIA GPUs.

The M&M loop (reference src/dsp/clock_recovery_mm.c:78-139) is a serial
recurrence inside each lane: the read pointer of symbol k+1 depends on
the interpolated value of symbol k.  The portable form is a vmapped
``lax.scan`` (dsp/clock_recovery._mm_scan_core), which XLA runs as a
device loop paying its per-iteration overhead once per symbol.  This
kernel runs the whole loop inside one launch instead:

- one lane per thread; a program owns ``LANES_PER_PROGRAM`` lanes (one
  warp), and the grid walks the lane groups;
- the carried state {ii, mu, omega, last, count} stays in registers;
- each symbol's 8-sample window is a direct gather at the lane's own read
  pointer from the time-major work buffer, and its interpolator taps are
  a gather from the 129-row MMSE bank — the table the scan uses;
- the symbol math is the scan's own (clock_recovery.mm_interp and
  mm_update); the interpolator's products are PTX ``mul.rn.f32``, which
  is never contracted into an fma, so they round on their own as the
  scan's do, and kernel and scan agree bit for bit on the same input,
  NaN handling included (reference :107-113);
- the loop checks every ``CHECK_EVERY`` symbols whether any lane of the
  program is still inside its input, so the static symbol bound
  (``max_symbols``) costs nothing past the last valid symbol.

It compiles through Pallas' Triton route (``backend="triton"``) and runs
in Pallas interpret mode on the CPU, where the tests check it against the
scan.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from sdrmodem.dsp import taps as taps_mod
from sdrmodem.dsp.clock_recovery import mm_interp, mm_update, mul_separate

NTAPS = taps_mod.MMSE_INTERP_NTAPS  # 8
NSTEPS = taps_mod.MMSE_INTERP_NSTEPS  # 128
# One warp per program, one lane per thread.  Each lane is its own
# dependent chain, so the step time is one chain's latency whatever the
# width; a full warp keeps the gathers of neighbouring lanes in one
# instruction and the program count (lanes / 32) low.
LANES_PER_PROGRAM = 32
NUM_WARPS = 1
CHECK_EVERY = 64


def _round_half_even(v):
    """jnp.round (ties to even) from floor, which every lowering has."""
    f = jnp.floor(v)
    d = v - f
    half = jnp.float32(0.5)
    odd = (f - jnp.float32(2.0) * jnp.floor(f * half)) != 0.0
    return jnp.where((d > half) | ((d == half) & odd), f + 1.0, f)


def _mul_rn(a, b):
    """``a * b`` as PTX ``mul.rn.f32``: an instruction with an explicit
    rounding mode is never contracted into an fma, so the product is
    rounded on its own as in the reference (see clock_recovery.mul_separate)."""
    return plgpu.elementwise_inline_asm(
        "mul.rn.f32 $0, $1, $2;",
        args=[a, b],
        constraints="=f,f,f",
        pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape, jnp.float32)],
    )[0]


def _mm_kernel(
    work_ref,  # (W, Cp) f32 time-major soft input
    bank_ref,  # (NSTEPS + 1, NTAPS) f32 MMSE interpolator bank
    valid_ref,  # (Cp,) i32 valid rows per lane
    ii_ref,  # (Cp,) i32 initial read pointer
    mu_ref,
    omega_ref,
    last_ref,  # (Cp,) f32
    outs_zero_ref,  # (Kp, Cp) f32 zeros, aliased to outs_ref
    outs_ref,  # (Kp, Cp) f32 symbols, time-major
    count_out,  # (Cp,) i32
    ii_out,  # (Cp,) i32
    mu_out,
    omega_out,
    last_out,  # (Cp,) f32
    *,
    num_checks: int,
    omega_mid: float,
    omega_lim: float,
    gain_omega: float,
    gain_mu: float,
    interpret: bool,
):
    del outs_zero_ref
    # interpret mode runs the kernel through XLA, where the barrier form
    # of the uncontracted product applies
    mul = mul_separate if interpret else _mul_rn
    bl = LANES_PER_PROGRAM
    base = pl.program_id(0) * bl
    lanes = base + jnp.arange(bl, dtype=jnp.int32)
    sl = pl.ds(base, bl)
    w_max = work_ref.shape[0] - NTAPS
    limit = valid_ref[sl] - NTAPS

    def symbol(k, carry):
        ii, mu, omega, last, count = carry
        valid = ii <= limit
        ii_c = jnp.clip(ii, 0, w_max)
        imu = jnp.clip(
            _round_half_even(mu * jnp.float32(NSTEPS)).astype(jnp.int32), 0, NSTEPS
        )
        y = mm_interp(
            [work_ref[ii_c + t, lanes] for t in range(NTAPS)],
            [bank_ref[imu, t] for t in range(NTAPS)],
            mul,
        )
        out, is_nan, mu_n, omega_n, stride = mm_update(
            y, mu, omega, last, omega_mid=omega_mid, omega_lim=omega_lim,
            gain_omega=gain_omega, gain_mu=gain_mu,
        )
        outs_ref[k, sl] = jnp.where(valid, out, jnp.float32(0.0))
        step = valid & ~is_nan
        return (
            jnp.where(valid, ii + stride.astype(jnp.int32), ii),
            jnp.where(step, mu_n, mu),
            jnp.where(step, omega_n, omega),
            jnp.where(step, out, last),
            count + valid.astype(jnp.int32),
        )

    def run_checked(carry):
        chk, state = carry
        k0 = chk * CHECK_EVERY
        state = jax.lax.fori_loop(
            0, CHECK_EVERY, lambda j, s: symbol(k0 + j, s), state
        )
        return chk + 1, state

    def any_active(carry):
        chk, (ii, *_rest) = carry
        live = jnp.max((ii <= limit).astype(jnp.int32))
        return (chk < num_checks) & (live > 0)

    init = (
        ii_ref[sl],
        mu_ref[sl],
        omega_ref[sl],
        last_ref[sl],
        jnp.zeros((bl,), jnp.int32),
    )
    _, (ii, mu, omega, last, count) = jax.lax.while_loop(
        any_active, run_checked, (jnp.int32(0), init)
    )
    count_out[sl] = count
    ii_out[sl] = ii
    mu_out[sl] = mu
    omega_out[sl] = omega
    last_out[sl] = last


def mm_clock(
    work: jnp.ndarray,  # (W, C) f32 time-major
    n_valid: jnp.ndarray,  # (C,) i32 valid rows of work per lane
    ii0: jnp.ndarray,  # (C,) i32
    mu: jnp.ndarray,
    omega: jnp.ndarray,
    last: jnp.ndarray,  # (C,) f32
    *,
    omega_mid: float,
    omega_relative_limit: float,
    gain_omega: float,
    gain_mu: float,
    num_symbols: int,
    interpret: bool,
):
    """Run the M&M loop over every lane of ``work``.

    Semantics are those of ``clock_recovery._mm_scan_core`` per lane.
    Returns (outs (K, C) f32 time-major, zero past each lane's count,
    count (C,) i32, final {ii, mu, omega, last} (C,) each)."""
    w, c = work.shape
    bl = LANES_PER_PROGRAM
    cp = -(-c // bl) * bl
    num_checks = -(-int(num_symbols) // CHECK_EVERY)
    kp = num_checks * CHECK_EVERY
    pad = cp - c

    def lanes(a, dtype):
        return jnp.pad(a.astype(dtype), (0, pad))

    work_p = jnp.pad(work.astype(jnp.float32), ((0, 0), (0, pad)))
    bank = jnp.asarray(taps_mod.mmse_interp_taps(), jnp.float32)
    o_mid = np.float32(omega_mid)
    kernel = functools.partial(
        _mm_kernel,
        num_checks=num_checks,
        omega_mid=float(o_mid),
        omega_lim=float(o_mid * np.float32(omega_relative_limit)),
        gain_omega=float(np.float32(gain_omega)),
        gain_mu=float(np.float32(gain_mu)),
        interpret=interpret,
    )
    lane_f32 = jax.ShapeDtypeStruct((cp,), jnp.float32)
    lane_i32 = jax.ShapeDtypeStruct((cp,), jnp.int32)
    outs, count, ii, mu_f, omega_f, last_f = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((kp, cp), jnp.float32),
            lane_i32,
            lane_i32,
            lane_f32,
            lane_f32,
            lane_f32,
        ),
        grid=(cp // bl,),
        input_output_aliases={7: 0},
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        name="mm_clock",
    )(
        work_p,
        bank,
        lanes(n_valid, jnp.int32),
        lanes(ii0, jnp.int32),
        lanes(mu, jnp.float32),
        lanes(omega, jnp.float32),
        lanes(last, jnp.float32),
        jnp.zeros((kp, cp), jnp.float32),
    )
    final = dict(ii=ii[:c], mu=mu_f[:c], omega=omega_f[:c], last=last_f[:c])
    return outs[: int(num_symbols), :c], count[:c], final
