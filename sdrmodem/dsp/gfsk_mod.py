"""GFSK/GMSK modulator: bytes → NRZ → Gaussian polyphase FIR → VCO.

Chain assembly matches reference src/dsp/gfsk_mod.c:43-132:

- pulse taps = gaussian(4*sps taps, BT) convolved with ones(int(sps))
- bytes expand MSB-first to ±1.0 NRZ at 1 sample/bit
- polyphase interpolating FIR by factor int(sps)
- frequency modulator with sensitivity 2*pi*deviation/Fs
  (set at reference src/tcp_server.c:529)

Expressed as one jit program: the bit expansion is a reshape, the
interpolator is a single convolution producing ``sps`` output phases per
bit, and the VCO is a cumulative sum + complex exp.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import jax
import jax.numpy as jnp
import numpy as np

from sdrmodem.dsp import taps as taps_mod
from sdrmodem.dsp.elementwise import freq_mod_stream
from sdrmodem.dsp.fir import interp_fir_stream


@dataclass(frozen=True)
class GfskModConfig:
    samples_per_symbol: float
    sensitivity: float
    bt: float = 0.5

    @classmethod
    def from_radio(cls, sampling_freq: int, baud_rate: int, deviation: int, bt: float = 0.5):
        """Derive from radio parameters as the reference server does."""
        return cls(
            samples_per_symbol=float(np.float32(sampling_freq / baud_rate)),
            sensitivity=float(np.float32(2.0 * np.pi * deviation / sampling_freq)),
            bt=bt,
        )


def bytes_to_nrz(data: jnp.ndarray) -> jnp.ndarray:
    """uint8 bytes (..., N) → float32 (..., N*8) of ±1.0, MSB first."""
    data = data.astype(jnp.uint8)
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (data[..., :, None] >> shifts) & 1
    nrz = jnp.where(bits == 0, jnp.float32(-1.0), jnp.float32(1.0))
    return nrz.reshape(*data.shape[:-1], data.shape[-1] * 8)


class GfskModulator:
    """Whole-stream GFSK modulator; channels batch on a leading axis."""

    def __init__(self, config: GfskModConfig):
        self.config = config
        self.interpolation = int(config.samples_per_symbol)
        self.taps = taps_mod.gfsk_pulse_taps(config.samples_per_symbol, config.bt)

    def process(self, data: jnp.ndarray, phase0=0.0):
        """data: uint8 (..., N) → (complex64 (..., N*8*int(sps)), next_phase)."""
        nrz = bytes_to_nrz(data)
        filtered = interp_fir_stream(nrz, self.taps, self.interpolation)
        return freq_mod_stream(filtered, self.config.sensitivity, phase0)

    def process_pair(self, data: jnp.ndarray, phase0=0.0):
        """Complex-free variant: uint8 (..., N) → (I, Q float32
        (..., N*8*int(sps)), next_phase), the layout the streaming TX and
        the RX pipeline carry IQ in."""
        from sdrmodem.dsp.elementwise import freq_mod_stream_pair

        nrz = bytes_to_nrz(data)
        filtered = interp_fir_stream(nrz, self.taps, self.interpolation)
        return freq_mod_stream_pair(filtered, self.config.sensitivity, phase0)

    @cached_property
    def jit_process(self):
        return jax.jit(lambda data: self.process(data)[0])
