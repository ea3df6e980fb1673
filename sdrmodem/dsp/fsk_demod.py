"""GMSK/FSK demodulator chain: LPF → quadrature demod → LPF(decim) → DC block → M&M.

Chain assembly and derived parameters match reference
src/dsp/fsk_demod.c:28-110 exactly:

- LPF1: complex, decimation 1, Carson-rule cutoff |deviation| + baud/2,
  transition width 0.1 * cutoff (truncated to integer Hz).
- quadrature demod gain = Fs / (2*pi*deviation).
- LPF2: real, decimation = ``decimation``, cutoff = baud/2 (integer division),
  transition width as requested.
- optional DC blocker of length ceil(32 * sps).
- M&M clock recovery with omega = sps = Fs/baud/decimation,
  gain_omega = sps*pi/100, mu = 0.5, gain_mu = 1/16, limit = 0.01.
- int8 soft symbols: round(clip(x * 127)) (volk_32f_s32f_convert_8i).

The whole chain is one jit-compiled program; channels batch on a leading
axis (the reference runs one ``dsp_worker`` thread per channel instead).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, partial

import jax
import jax.numpy as jnp
import numpy as np

from sdrmodem.dsp import taps as taps_mod
from sdrmodem.dsp.clock_recovery import ClockState, clock_mm_stream, mm_params
from sdrmodem.dsp.elementwise import dc_blocker_length, dc_blocker_taps, quad_demod_stream
from sdrmodem.dsp.fir import fir_stream


def float_to_int8(x: jnp.ndarray, scale: float = 127.0) -> jnp.ndarray:
    """volk_32f_s32f_convert_8i: scale, clip to int8 range, rint."""
    r = x * jnp.float32(scale)
    r = jnp.clip(r, -128.0, 127.0)
    return jnp.round(r).astype(jnp.int8)


@dataclass(frozen=True)
class FskDemodConfig:
    sampling_freq: int
    baud_rate: int
    deviation: int
    decimation: int = 1
    transition_width: int = 2000
    use_dc_block: bool = True

    @property
    def carson_cutoff(self) -> float:
        return float(abs(self.deviation)) + float(self.baud_rate) / 2.0

    @property
    def quad_gain(self) -> float:
        return float(
            np.float32(self.sampling_freq / (2.0 * np.pi * float(self.deviation)))
        )

    @property
    def sps(self) -> float:
        """Samples per symbol after decimation, float32 (fsk_demod.c:52)."""
        return float(
            np.float32(self.sampling_freq / self.baud_rate / self.decimation)
        )

    @property
    def dc_length(self) -> int:
        return dc_blocker_length(self.sps)

    def lpf1_taps(self) -> np.ndarray:
        cutoff = int(self.carson_cutoff)  # (uint64) truncation
        tw = int(np.float32(0.1) * np.float32(self.carson_cutoff))  # (uint32)(0.1f * c)
        return taps_mod.low_pass_taps(1.0, self.sampling_freq, cutoff, tw)

    def lpf2_taps(self) -> np.ndarray:
        return taps_mod.low_pass_taps(
            1.0, self.sampling_freq, self.baud_rate // 2, self.transition_width
        )

    def clock_params(self) -> dict:
        return mm_params(self.sps)


class FskDemodulator:
    """Whole-stream (offline / batched) FSK demodulator.

    ``process(iq)`` demodulates complex64 IQ of shape (N,) or (B, N) into
    int8 soft symbols.  Output is (K,)/(B, K) padded to the static symbol
    bound with a per-channel valid count.
    """

    def __init__(
        self,
        config: FskDemodConfig,
        *,
        use_atan_lut: bool = True,
        exact: bool = True,
    ):
        """``exact=True`` (default) accumulates FIR dot products in float64
        for deterministic golden parity; ``exact=False`` is the fast float32
        path."""
        self.config = config
        self.use_atan_lut = use_atan_lut
        self.exact = exact
        self._lpf1 = config.lpf1_taps()
        self._lpf2 = config.lpf2_taps()
        self._dc = dc_blocker_taps(config.dc_length) if config.use_dc_block else None
        self._clock = config.clock_params()
        from sdrmodem.dsp.clock_recovery import check_sps_supported

        check_sps_supported(self._clock["omega"])  # explicit contract bound

    def soft_stream(self, iq: jnp.ndarray, clock_state: ClockState | None = None):
        """Demodulate to float soft symbols. iq: (..., N) complex64."""
        cfg = self.config
        if iq.shape[-1] == 0:
            # the reference returns zero output for an empty buffer
            zeros = jnp.zeros(iq.shape[:-1] + (0,), jnp.float32)
            count = jnp.zeros(iq.shape[:-1], jnp.int32)
            return zeros, count, clock_state
        x = fir_stream(iq, self._lpf1, 1, exact=self.exact)
        x = quad_demod_stream(x, cfg.quad_gain, use_lut=self.use_atan_lut)
        x = fir_stream(x, self._lpf2, cfg.decimation, exact=self.exact)
        if self._dc is not None:
            x = fir_stream(x, self._dc, 1, exact=self.exact)
        clock = partial(
            clock_mm_stream,
            omega=self._clock["omega"],
            gain_omega=self._clock["gain_omega"],
            mu=self._clock["mu"],
            gain_mu=self._clock["gain_mu"],
            omega_relative_limit=self._clock["omega_relative_limit"],
        )
        if x.ndim == 1:
            return clock(x, state=clock_state)
        batch_shape = x.shape[:-1]
        flat = x.reshape(-1, x.shape[-1])
        if clock_state is not None:
            outs, count, state = jax.vmap(lambda d, s: clock(d, state=s))(flat, clock_state)
        else:
            outs, count, state = jax.vmap(clock)(flat)
        k = outs.shape[-1]
        return (
            outs.reshape(*batch_shape, k),
            count.reshape(batch_shape),
            jax.tree.map(lambda a: a.reshape(batch_shape + a.shape[1:]), state),
        )

    def process(self, iq: jnp.ndarray, clock_state: ClockState | None = None):
        """Demodulate to int8 soft symbols: (symbols_i8, count, clock_state)."""
        soft, count, state = self.soft_stream(iq, clock_state)
        return float_to_int8(soft), count, state

    @cached_property
    def jit_process(self):
        return jax.jit(lambda iq: self.process(iq)[:2])
