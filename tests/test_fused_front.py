"""The full-block XLA front end (pipeline.front_full) vs the ragged front
and the goldens.

The full-block front keeps every history length a static constant; the
ragged front bookkeeps dynamic histories.  Fed the same full blocks, the
two must agree to float32 rounding (their matmuls are shaped differently,
so the accumulation order differs), and the full-block front must not
depend on how the stream is cut into blocks.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sdrmodem.dsp.fsk_demod import FskDemodConfig
from sdrmodem.dsp.pipeline import DemodPipeline, DemodStateFull

CFG = FskDemodConfig(48000, 4800, 5000, 2, 2000, True)
TOL = 1e-4  # ≈ 0.013 int8 LSB (1 LSB = 1/127)


def _full_front(cfg, block, x_blocks):
    """Run the full-block front over (B, 2*Cp) blocks with carried state."""
    pipe = DemodPipeline(cfg, block, exact=False, use_atan_lut="free")
    st = pipe.init_full_state(x_blocks[0].shape[1] // 2)
    front = jax.jit(pipe._front_batched_full)
    outs = []
    for x in x_blocks:
        y3, fs = front(st, jnp.asarray(x))
        st = DemodStateFull(*fs, st.clock)
        outs.append(np.asarray(y3))
    return np.concatenate(outs)


def _ragged_front(cfg, block, x_blocks, channels):
    """The ragged front (dynamic histories) over the same blocks."""
    pipe = DemodPipeline(cfg, block, exact=False, use_atan_lut="free")
    st = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (channels,) + a.shape), pipe.init_state()
    )
    front = jax.jit(pipe._front_batched)
    nv = jnp.full((channels,), block, jnp.int32)
    outs = []
    for x in x_blocks:
        cp = x.shape[1] // 2
        x_cm = np.stack([x[:, :channels].T, x[:, cp : cp + channels].T], axis=1)
        fs, y3, n3 = front(st, jnp.asarray(x_cm), nv)
        st = st._replace(lpf1=fs[0], quad_prev=fs[1], lpf2=fs[2], dc=fs[3])
        n = int(np.asarray(n3)[0])
        outs.append(np.asarray(y3)[:, :n].T)
    return np.concatenate(outs)


def _check_front_matches_ragged(cfg, block, steps, channels=4, seed=0):
    rng = np.random.default_rng(seed)
    x_blocks = [
        rng.standard_normal((block, 256)).astype(np.float32) for _ in range(steps)
    ]
    full = _full_front(cfg, block, x_blocks)[:, :channels]
    ragged = _ragged_front(cfg, block, x_blocks, channels)
    assert full.shape == ragged.shape
    np.testing.assert_allclose(full, ragged, atol=TOL)


def test_fused_front_matches_banded():
    _check_front_matches_ragged(CFG, 4096, steps=3)


def test_fused_front_no_dc():
    _check_front_matches_ragged(FskDemodConfig(48000, 4800, 5000, 2, 2000, False), 2048, 2)


def test_fused_front_decim1():
    cfg = FskDemodConfig(192000, 40000, 5000, 1, 2000, True)
    _check_front_matches_ragged(cfg, 1920, steps=2)  # non-power-of-two block


def test_fused_front_tile_invariant():
    """Block-size invariance: one 4096-sample block and two 2048-sample
    blocks of the same stream give the same front output (static history
    hand-off is exact)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4096, 256)).astype(np.float32)
    one = _full_front(CFG, 4096, [x])
    two = _full_front(CFG, 2048, [x[:2048], x[2048:]])
    np.testing.assert_allclose(one, two, atol=TOL)


def _demod_fixture(cfg, iq, block):
    """Full-block step over a fixture, single channel."""
    pipe = DemodPipeline(cfg, block, exact=False, use_atan_lut="free")
    step = pipe.make_batched_step_full(layout="tm")
    padded = np.zeros(-(-len(iq) // block) * block, np.complex64)
    padded[: len(iq)] = iq
    state = pipe.init_full_state(1)
    out = []
    for start in range(0, len(padded), block):
        chunk = padded[start : start + block]
        x = np.concatenate(
            [
                np.broadcast_to(chunk.real[:, None], (block, 128)),
                np.broadcast_to(chunk.imag[:, None], (block, 128)),
            ],
            axis=1,
        ).astype(np.float32)
        state, sym, cnt = step(state, jnp.asarray(x))
        sym0, cnt0 = np.asarray(sym)[0], np.asarray(cnt)[0]
        out.extend(sym0[k, : int(c)] for k, c in enumerate(cnt0) if c)
    return np.concatenate(out) if out else np.zeros(0, np.int8)


GOLDEN_CASES = [
    ("lucky7", CFG, "lucky7.expected.cf32", "lucky7.expected.s8", 8192),
    (
        "lucky7_nodc",
        FskDemodConfig(48000, 4800, 5000, 2, 2000, False),
        "lucky7.expected.cf32",
        "lucky7.expected.nodc.s8",
        8192,
    ),
    ("nusat", FskDemodConfig(192000, 40000, 5000, 1, 2000, True), "nusat.cf32", "processed.s8", 5120),
    ("nan", FskDemodConfig(240000, 9600, 5000, 1, 2000, True), "inputnan.cf32", "nan.s8", 4096),
]


@pytest.mark.parametrize("name,cfg,fin,fexp,block", GOLDEN_CASES, ids=[c[0] for c in GOLDEN_CASES])
def test_fused_front_golden(resources_dir, name, cfg, fin, fexp, block):
    """The full-block fast path reproduces the reference goldens within
    the reference's own ±2 LSB bound (test/test_fsk_demod.c:14-48)."""
    iq = np.fromfile(resources_dir / fin, dtype=np.complex64)
    golden = np.fromfile(resources_dir / fexp, dtype=np.int8)
    got = _demod_fixture(cfg, iq, block)
    m = min(len(got), len(golden))
    assert m >= len(golden) * 0.99
    diff = np.abs(got[:m].astype(np.int32) - golden[:m].astype(np.int32))
    assert diff.max() <= 2, f"{name}: {(diff > 2).sum()} symbols beyond tolerance"
