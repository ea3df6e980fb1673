"""Chunked streaming TX modulator with carried state.

(The RX side lives in ``sdrmodem.dsp.pipeline`` as the ragged-block jit
pipeline; this module holds the TX analog: polyphase history + VCO
phase carried across TxData batches, the reference's gfsk_mod state,
src/dsp/gfsk_mod.c + frequency_modulator.c.)

Each TxData runs NRZ → polyphase FIR → VCO as ONE jitted XLA program,
compiled once per padded payload length.  The k-1-bit FIR history is
mirrored host-side so ragged payloads can be zero-padded to the jit
shape without corrupting carried state: the FIR outputs of the padding
are zeroed before the VCO, so they add no phase, and the next history
is taken from the real tail.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from sdrmodem.dsp.gfsk_mod import GfskModConfig, GfskModulator


class StreamingGfskMod:
    """Chunked GFSK modulator: carried polyphase history + VCO phase."""

    # jit-shape granule for ragged TxData payloads (bits)
    PAD_BITS = 2048

    def __init__(self, config: GfskModConfig):
        self.mod = GfskModulator(config)
        taps = self.mod.taps
        interp = self.mod.interpolation
        pad = (-len(taps)) % interp
        self.k = (len(taps) + pad) // interp
        self.hist = np.zeros(self.k - 1, np.float32)
        self.phase = 0.0
        self._steps = {}

    def _step(self, nbits: int):
        """Jitted modulation step for one padded bit count."""
        if nbits in self._steps:
            return self._steps[nbits]
        from sdrmodem.dsp.elementwise import freq_mod_stream_pair
        from sdrmodem.dsp.fir import interp_fir_stream

        mod = self.mod
        interp = mod.interpolation
        n_hist = self.k - 1

        @jax.jit
        def step(nrz, hist, phase, n_valid):
            work = jnp.concatenate([hist, nrz])
            # drop the outputs that belong to the carried history positions
            out = interp_fir_stream(work, mod.taps, interp)[n_hist * interp :]
            out = jnp.where(jnp.arange(out.shape[0]) < n_valid * interp, out, 0.0)
            return freq_mod_stream_pair(out, mod.config.sensitivity, phase)

        self._steps[nbits] = step
        return step

    def process(self, data: bytes | np.ndarray) -> np.ndarray:
        data = (
            np.frombuffer(bytes(data), np.uint8)
            if isinstance(data, (bytes, bytearray))
            else np.asarray(data, np.uint8)
        )
        if len(data) == 0:
            return np.zeros(0, np.complex64)
        nrz = np.unpackbits(data).astype(np.float32) * 2.0 - 1.0
        nbits = len(nrz)
        padded_bits = -(-nbits // self.PAD_BITS) * self.PAD_BITS
        buf = np.zeros(padded_bits, np.float32)
        buf[:nbits] = nrz
        i, q, phase = self._step(padded_bits)(
            jnp.asarray(buf), jnp.asarray(self.hist), jnp.float64(self.phase),
            jnp.int32(nbits),
        )
        n_out = nbits * self.mod.interpolation
        iq = np.asarray(i[:n_out]) + 1j * np.asarray(q[:n_out])
        self.phase = float(phase)
        if self.k > 1:
            work = np.concatenate([self.hist, nrz])
            self.hist = work[-(self.k - 1) :].astype(np.float32)
        return iq.astype(np.complex64)
