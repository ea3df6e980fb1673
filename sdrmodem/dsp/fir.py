"""Decimating / interpolating FIR filtering as batched XLA convolutions.

Stream semantics (chunk-size invariant, proven by the reference's
big/small-buffer tests) of the reference FIR
(src/dsp/fir_filter.c:93-144): with X' = [taps_len-1 zeros, stream],

    y[k] = sum_j X'[k*decimation + j] * taps[taps_len-1-j]

i.e. a plain strided convolution of the zero-pre-padded stream with the
taps.  The C implementation carries a (taps_len-1)-sample history between
calls; here the whole-stream transform is a single
``lax.conv_general_dilated`` (batched over channels).  Streaming state
(the carried history) is handled by ``sdrmodem.dsp.streaming``.

The interpolating (polyphase) FIR of src/dsp/interp_fir_filter.c:75-154
is expressed as a single convolution producing ``interpolation`` output
features per input step:  y[n*I + i] = sum_m x[n-m] * h[m*I + i].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


# Matmul precision of the fast-path FIRs, pinned.  On the H100 both
# Precision.DEFAULT and Precision.HIGH run a float32 product as TF32
# (~10 mantissa bits: a -69 dB error floor on the filtered signal),
# while HIGHEST keeps the full float32 product.  The M&M loop downstream
# is chaotic in its input, so the FIRs keep float32 accuracy.
FIR_PRECISION = jax.lax.Precision.HIGHEST
COLUMN_GROUP = 128  # lanes per FIR gemm (see fir_tm)


def conv1d(
    x: jnp.ndarray,
    kernel: jnp.ndarray,
    stride: int,
    left_pad: int,
    *,
    exact: bool = False,
) -> jnp.ndarray:
    """Batched 1-D correlation.  x: (B, N) float32, kernel: (T,) or (O, T).

    Returns (B, O, M) with
    out[b, o, k] = sum_j x_pad[b, k*stride + j] * kernel[o, j],
    where x is padded with ``left_pad`` zeros on the left.

    ``exact=True`` accumulates in float64 and rounds the result to float32:
    a canonical deterministic dot product, independent of how the backend
    partitions the reduction.  This is the parity mode used to match the
    reference's golden fixtures (the M&M feedback loop downstream is
    chaotic w.r.t. 1-ulp differences, like the reference's own
    VOLK_GENERIC + fixed-alignment golden policy).  ``exact=False`` is the
    fast float32 production path.
    """
    if kernel.ndim == 1:
        kernel = kernel[None, :]
    dtype = jnp.float64 if exact else jnp.float32
    lhs = x.astype(dtype)[:, None, :]  # (B, 1, N)
    rhs = kernel.astype(dtype)[:, None, :]  # (O, 1, T)
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(stride,),
        padding=[(left_pad, 0)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.astype(jnp.float32)


def fir_tm(
    x: jnp.ndarray,  # (W, B) float32 time-major — columns are independent lanes
    rev_taps: np.ndarray,  # (T,) float32, already reversed
    stride: int,
    n_out: int,
    *,
    tile_out: int = 128,
) -> jnp.ndarray:
    """Strided correlation as banded-matrix matmuls, time-major.

    out[k, b] = sum_j x[k*stride + j, b] * rev_taps[j], k < n_out.

    Every tile of ``tile_out`` outputs is one (tile_out, Lwin) x (Lwin, B)
    product with a constant banded weight matrix, and all tiles go
    through ONE matmul stacked along the column dimension — the
    reference's dot-product loop (src/dsp/fir_filter.c:93-144) as a
    single cuBLAS gemm.  A decimating filter is split into its polyphase
    branches first.  Rows past the end of ``x`` read as zeros.

    Columns run in groups of ``COLUMN_GROUP``, one gemm each, so every
    gemm has the same shape whatever the lane count: cuBLAS may pick
    another reduction order (split-K) for another shape, and the chaotic
    clock downstream must give a lane the same symbols whether it shares
    its step with 127 lanes on one card or 511 across four.
    """
    rev = np.asarray(rev_taps, np.float32)
    t = len(rev)
    w, b = x.shape
    x = x.astype(jnp.float32)
    if b > COLUMN_GROUP:
        return jnp.concatenate(
            [
                fir_tm(x[:, i : i + COLUMN_GROUP], rev, stride, n_out, tile_out=tile_out)
                for i in range(0, b, COLUMN_GROUP)
            ],
            axis=1,
        )

    if stride > 1:
        # polyphase: split into stride phase streams, sum short stride-1 FIRs
        wr = -(-w // stride) * stride
        if wr != w:
            x = jnp.pad(x, ((0, wr - w), (0, 0)))
        phases = x.reshape(wr // stride, stride, b)
        out = None
        for p in range(stride):
            rp = rev[p::stride]
            if len(rp) == 0:
                continue
            y = fir_tm(phases[:, p, :], rp, 1, n_out, tile_out=tile_out)
            out = y if out is None else out + y
        return out

    g = -(-n_out // tile_out)
    lwin = tile_out + t - 1
    lpad = -(-lwin // 128) * 128
    need = (g - 1) * tile_out + lpad
    if w < need:
        x = jnp.pad(x, ((0, need - w), (0, 0)))
    starts = (jnp.arange(g) * tile_out).astype(jnp.int32)
    frames = jax.vmap(
        lambda s: jax.lax.dynamic_slice(x, (s, jnp.int32(0)), (lpad, b))
    )(starts)  # (g, lpad, B)

    wmat = np.zeros((tile_out, lpad), np.float32)
    for k in range(tile_out):
        wmat[k, k : k + t] = rev
    cols = jnp.transpose(frames, (1, 0, 2)).reshape(lpad, g * b)
    out2d = jnp.dot(
        jnp.asarray(wmat), cols, preferred_element_type=jnp.float32,
        precision=FIR_PRECISION,
    )
    out = out2d.reshape(tile_out, g, b).transpose(1, 0, 2)
    return out.reshape(g * tile_out, b)[:n_out]


def conv1d_banded(
    x: jnp.ndarray,  # (B, W) float32 — rows are independent lanes
    rev_taps: np.ndarray,  # (T,) float32, already reversed
    stride: int,
    max_out: int,
) -> jnp.ndarray:
    """``fir_tm`` for channel-major input: out[b, k], k < max_out."""
    return fir_tm(x.T, rev_taps, stride, max_out).T


def fir_stream(
    x: jnp.ndarray,
    taps: jnp.ndarray,
    decimation: int = 1,
    *,
    history: bool = True,
    exact: bool = False,
) -> jnp.ndarray:
    """Decimating FIR over a whole stream, float or complex input.

    x: (..., N) float32 or complex64; taps: (T,) float32 (natural order, as
    designed).

    With ``history=True`` (fresh-filter semantics) the stream is pre-padded
    with T-1 zeros and the output length is ceil(N / decimation), matching
    the reference's produced count from a zeroed history buffer.  With
    ``history=False`` the first output's window starts at x[0] (used by the
    streaming runner, which prepends carried history itself).
    """
    taps = jnp.asarray(taps, jnp.float32)
    rev = taps[::-1]
    t = taps.shape[0]
    left_pad = t - 1 if history else 0
    batch_shape = x.shape[:-1]
    n = x.shape[-1]
    if jnp.iscomplexobj(x):
        # real taps: filter I and Q independently through the batch dim
        flat = jnp.concatenate(
            [jnp.real(x).reshape(-1, n), jnp.imag(x).reshape(-1, n)], axis=0
        )
        out = conv1d(flat, rev, decimation, left_pad, exact=exact)[:, 0, :]
        half = out.shape[0] // 2
        y = jax.lax.complex(out[:half], out[half:])
        return y.reshape(*batch_shape, -1)
    flat = x.reshape(-1, n).astype(jnp.float32)
    out = conv1d(flat, rev, decimation, left_pad, exact=exact)[:, 0, :]
    return out.reshape(*batch_shape, -1)


def interp_fir_stream(x: jnp.ndarray, taps: np.ndarray, interpolation: int) -> jnp.ndarray:
    """Interpolating polyphase FIR over a whole stream.

    x: (..., N) float32; taps: (T,) float32; output (..., N*interpolation)
    with y[n*I + i] = sum_m x[n-m] * taps[m*I + i] (zero initial history),
    matching reference src/dsp/interp_fir_filter.c:139-154.
    """
    taps = np.asarray(taps, np.float32)
    ii = int(interpolation)
    pad = (-len(taps)) % ii
    if pad:
        taps = np.concatenate([taps, np.zeros(pad, np.float32)])
    k = len(taps) // ii
    # kernel[i, m] = taps[(K-1-m)*I + i]  -> correlation over left-padded x
    kernel = jnp.asarray(taps.reshape(k, ii)[::-1].T.copy())  # (I, K)
    batch_shape = x.shape[:-1]
    n = x.shape[-1]
    flat = x.reshape(-1, n).astype(jnp.float32)
    out = conv1d(flat, kernel, 1, k - 1)  # (B, I, N)
    y = jnp.swapaxes(out, 1, 2).reshape(-1, n * ii)  # interleave phases
    return y.reshape(*batch_shape, n * ii)
