"""sdrmodem — a GMSK/FSK software modem framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
``sdr-modem`` C daemon (reference: dernasherbrezon/sdr-modem): batched
GMSK/FSK demodulation and modulation, SGP4-driven Doppler correction,
an asyncio TCP server speaking the reference's wire protocol, and SDR
device backends (file, sdr-server, PlutoSDR).

Architecture (batched device arrays, not a translation of the C):

- DSP blocks are pure functions ``(state, samples) -> (state', output)``
  with static shapes, composed under ``jax.jit``; per-sample C hot loops
  (reference ``src/dsp/*.c``) become batched convolutions / scans.
- Channels are a batch axis sharded over a ``jax.sharding.Mesh``
  (the reference's thread-per-client ``dsp_worker`` model).
- Long streams are time-sharded with overlap-save halo exchange
  (the reference's per-block carried FIR/NCO/clock state).
"""

__version__ = "0.1.0"

# Double precision is required by the orbital-mechanics layer (SGP4) and the
# long-stream phase bookkeeping; hot DSP paths request float32/complex64
# explicitly so this does not change their compute dtype.
import jax as _jax

_jax.config.update("jax_enable_x64", True)

from sdrmodem.dsp.fsk_demod import FskDemodConfig, FskDemodulator  # noqa: E402
from sdrmodem.dsp.gfsk_mod import GfskModConfig, GfskModulator  # noqa: E402

__all__ = [
    "FskDemodConfig",
    "FskDemodulator",
    "GfskModConfig",
    "GfskModulator",
    "__version__",
]
