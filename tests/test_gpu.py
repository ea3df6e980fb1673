"""Tests that need the GPU: the compiled clock kernel and the fast path's
golden parity on the card.  They skip on the CPU; run them on a GPU with
``python -m pytest -m gpu tests/``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sdrmodem.dsp.clock_recovery import clock_mm_batched_full, initial_full_state, mm_params

pytestmark = pytest.mark.gpu


def test_gpu_selects_compiled_kernel(gpu):
    from sdrmodem.ops import select

    assert select.select() == select.Impl("gpu", "kernel", False)


def test_compiled_clock_kernel_equals_scan(gpu):
    """The compiled kernel and the scan agree bit for bit on one input."""
    p = mm_params(5.0)
    kw = dict(
        omega=p["omega"], gain_omega=p["gain_omega"], mu=p["mu"],
        gain_mu=p["gain_mu"], omega_relative_limit=p["omega_relative_limit"],
    )
    rng = np.random.default_rng(0)
    c, n = 64, 65536
    bits = rng.integers(0, 2, (c, n // 5 + 8)) * 2.0 - 1.0
    y = np.stack(
        [np.convolve(np.repeat(b, 5)[:n], np.hanning(9) / 4.5, mode="same") for b in bits]
    ).T.astype(np.float32)
    y += 0.05 * rng.standard_normal(y.shape).astype(np.float32)
    st = initial_full_state(p["omega"], c)
    out = {}
    for backend in ("kernel", "scan"):
        fn = jax.jit(lambda x, s, b=backend: clock_mm_batched_full(x, s, backend=b, **kw)[:2])
        o, cnt = fn(jnp.asarray(y), st)
        out[backend] = (np.asarray(o), np.asarray(cnt))
    np.testing.assert_array_equal(out["kernel"][1], out["scan"][1])
    np.testing.assert_array_equal(out["kernel"][0], out["scan"][0])


def test_fast_path_goldens_on_gpu(gpu):
    from tools import parity

    rep = parity.run(16384)
    assert rep["gate"]["pass"], rep["gate"]["failures"]
