"""The XLA TX path (StreamingGfskMod, GfskModulator.process_pair) vs the
complex whole-stream modulator and the goldens."""

import numpy as np

import jax.numpy as jnp

from sdrmodem.dsp.gfsk_mod import GfskModConfig, GfskModulator
from sdrmodem.dsp.streaming import StreamingGfskMod

CFG = GfskModConfig.from_radio(19200, 9600, 5000)

# f32 phase rounding: the pair path and the complex path both carry the
# phase in f64 and round once; the goldens' tolerance is 0.01
TOL = 1e-3


def test_kernel_golden_320(fixtures_dir):
    """The reference's 320-float golden within the complex tolerance 0.01
    (reference test/utils.c:134-140), through the streaming modulator."""
    vals = np.load(fixtures_dir / "gfsk_mod_expected320.npy")
    iq = StreamingGfskMod(CFG).process(np.arange(10, dtype=np.uint8))
    assert len(iq) == 160
    assert np.abs(iq.real - vals[0::2]).max() < 0.01
    assert np.abs(iq.imag - vals[1::2]).max() < 0.01


def test_kernel_batched_streams():
    """process_pair over a (C, N) batch == the complex modulator per row."""
    mod = GfskModulator(CFG)
    rng = np.random.default_rng(1)
    data = rng.integers(0, 255, (5, 96)).astype(np.uint8)
    ib, qb, _ = mod.process_pair(jnp.asarray(data))
    assert ib.shape == qb.shape == (5, 96 * 8 * 2)
    for row in range(5):
        ref, _ = mod.process(jnp.asarray(data[row]))
        ref = np.asarray(ref)
        np.testing.assert_allclose(np.asarray(ib[row]), ref.real, atol=TOL)
        np.testing.assert_allclose(np.asarray(qb[row]), ref.imag, atol=TOL)


def test_streaming_fused_chunk_invariant():
    """Ragged TxData chunks through the streaming modulator equal the
    one-shot run and the whole-stream complex modulator (carried phase +
    host history mirror; the padded outputs are zeroed before the VCO)."""
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 255, 700).astype(np.uint8)

    def run(chunks):
        m = StreamingGfskMod(CFG)
        out, i = [], 0
        for c in chunks:
            out.append(m.process(payload[i : i + c]))
            i += c
        return np.concatenate(out)

    whole = run([700])
    chunked = run([100, 250, 350])
    ref, _ = GfskModulator(CFG).process(jnp.asarray(payload))
    assert np.abs(whole - chunked).max() < TOL
    assert np.abs(whole - np.asarray(ref)).max() < TOL


def test_streaming_padding_carries_exact_phase():
    """A payload that is not a multiple of the jit granule: the carried
    phase after it equals the whole-stream phase at the last real sample."""
    m = StreamingGfskMod(CFG)
    payload = np.arange(37, dtype=np.uint8)
    m.process(payload)
    _, phase = GfskModulator(CFG).process(jnp.asarray(payload))
    d = (m.phase - float(phase) + np.pi) % (2 * np.pi) - np.pi
    assert abs(d) < 1e-4


def test_streaming_fused_mod_demod_loopback():
    """TX through the streaming modulator → RX recovers the bits."""
    from sdrmodem.dsp.fsk_demod import FskDemodConfig, FskDemodulator

    fs, baud, dev = 48000, 9600, 5000
    payload = np.frombuffer(b"streaming tx loopback \x00\xff!!!!!" * 8, dtype=np.uint8)
    m = StreamingGfskMod(GfskModConfig.from_radio(fs, baud, dev))
    iq = np.concatenate([m.process(payload[:100]), m.process(payload[100:])])

    demod = FskDemodulator(FskDemodConfig(fs, baud, dev, 1, 2000, False))
    out, count, _ = demod.process(jnp.asarray(iq))
    soft = np.asarray(out)[: int(count)]
    bits_tx = np.unpackbits(payload).astype(np.int8) * 2 - 1
    hard = np.sign(soft).astype(np.int8)
    best = 0.0
    for off in range(0, 80):
        n = min(len(hard) - off, len(bits_tx))
        best = max(best, float((hard[off : off + n] == bits_tx[:n]).mean()))
    assert best > 0.999, f"loopback BER too high: {1 - best:.4f}"
