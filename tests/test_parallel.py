"""Sharded execution on the 8-device virtual CPU mesh: channel-parallel and
time-parallel results must equal the unsharded reference output."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from sdrmodem.dsp.fsk_demod import FskDemodConfig, FskDemodulator
from sdrmodem.parallel.channels import ShardedChannelDemod
from sdrmodem.parallel.time_shard import demod_time_sharded

CFG = FskDemodConfig(48000, 4800, 5000, 2, 2000, True)


def _mesh(axis):
    devices = np.array(jax.devices()[:8])
    return Mesh(devices, axis_names=(axis,))


def test_channel_sharded_equals_single(resources_dir):
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:16384]
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)
    channels = 16
    mesh = _mesh("channel")
    sharded = ShardedChannelDemod(CFG, 16384, channels, mesh, exact=False)

    state = sharded.init_state()
    batch = np.tile(iq, (channels, 1))
    x = sharded.place_input(batch)
    state, symbols, count = sharded.step(state, x)
    counts = np.asarray(count)
    assert (counts == counts[0]).all()
    out = np.asarray(symbols)
    for c in range(channels):
        np.testing.assert_array_equal(out[c, : counts[0]], out[0, : counts[0]])
    # channel 0 matches the golden prefix within tolerance
    got = out[0, : counts[0]]
    diff = np.abs(got.astype(np.int32) - golden[: len(got)].astype(np.int32))
    assert diff.max() <= 2


def test_channel_sharded_state_carries_between_blocks(resources_dir):
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:16384]
    mesh = _mesh("channel")
    block = 8192
    sharded = ShardedChannelDemod(CFG, block, 8, mesh, exact=False)
    state = sharded.init_state()
    outs = []
    for i in range(2):
        x = sharded.place_input(np.tile(iq[i * block : (i + 1) * block], (8, 1)))
        state, symbols, count = sharded.step(state, x)
        outs.append(np.asarray(symbols)[0, : int(np.asarray(count)[0])])
    two_block = np.concatenate(outs)

    whole = ShardedChannelDemod(CFG, 16384, 8, mesh, exact=False)
    st = whole.init_state()
    _, symbols, count = whole.step(st, whole.place_input(np.tile(iq, (8, 1))))
    one_block = np.asarray(symbols)[0, : int(np.asarray(count)[0])]
    np.testing.assert_array_equal(two_block, one_block)


def test_time_sharded_equals_unsharded(resources_dir):
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:32768]
    mesh = _mesh("time")
    symbols, count = demod_time_sharded(iq, CFG, mesh, clock_backend="scan")

    ref_out, ref_count, _ = FskDemodulator(CFG, exact=False).process(jnp.asarray(iq))
    ref = np.asarray(ref_out)[: int(ref_count)]
    assert count == len(ref)
    diff = np.abs(symbols.astype(np.int32) - ref.astype(np.int32))
    # halo-exchanged front-end is numerically identical; allow the golden
    # tolerance for conv-partitioning float wiggle through the M&M loop
    assert diff.max() <= 2 and (diff > 0).mean() < 0.01


def test_channel_sharded_full_path(resources_dir):
    """The production full-block fast path under shard_map: every shard
    runs its local 128-lane batched step; output matches the unsharded
    full-block step exactly (same program per lane, no collectives)."""
    from sdrmodem.dsp.pipeline import DemodPipeline
    from sdrmodem.parallel.channels import ShardedChannelDemodFull

    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:8192]
    channels = 16
    mesh = _mesh("channel")
    sharded = ShardedChannelDemodFull(
        CFG, 8192, channels, mesh, clock_backend="scan"
    )
    def collect(symbols, counts, lane):
        return np.concatenate(
            [symbols[lane, t, : counts[lane, t]] for t in range(counts.shape[1])]
        )

    state = sharded.init_state()
    batch = np.tile(iq, (channels, 1))
    state, symbols, counts = sharded.step(state, sharded.place_input(batch))
    counts = np.asarray(counts)
    symbols = np.asarray(symbols)
    assert (counts == counts[0:1]).all() and counts.sum() > 0
    lane0 = collect(symbols, counts, 0)
    for c in range(1, channels):
        np.testing.assert_array_equal(collect(symbols, counts, c), lane0)

    pipe = DemodPipeline(CFG, 8192, exact=False, use_atan_lut="free")
    step = pipe.make_batched_step_full("scan")
    st = pipe.init_full_state(1)
    x = np.stack([iq.real, iq.imag])[None].astype(np.float32)
    st, ref_sym, ref_cnt = step(st, jnp.asarray(x))
    ref = collect(np.asarray(ref_sym), np.asarray(ref_cnt), 0)
    np.testing.assert_array_equal(lane0, ref)


def test_channel_sharded_production_kernels(resources_dir):
    """The GPU's kernel stack — XLA front end + the clock kernel — under
    shard_map, interpret mode on the CPU mesh: symbol-exact vs the same
    step unsharded (the reference's integration tests run the code paths
    production runs, test_tcp_server.c:482-563)."""
    from sdrmodem.dsp.pipeline import DemodPipeline
    from sdrmodem.parallel.channels import ShardedChannelDemodFull

    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:2048]
    channels = 16
    mesh = _mesh("channel")
    sharded = ShardedChannelDemodFull(
        CFG, 2048, channels, mesh, clock_backend="kernel"
    )

    def collect(symbols, counts, lane):
        return np.concatenate(
            [symbols[lane, t, : counts[lane, t]] for t in range(counts.shape[1])]
        )

    state = sharded.init_state()
    batch = np.tile(iq, (channels, 1))
    state, symbols, counts = sharded.step(state, sharded.place_input(batch))
    counts = np.asarray(counts)
    symbols = np.asarray(symbols)
    assert (counts == counts[0:1]).all() and counts.sum() > 0
    lane0 = collect(symbols, counts, 0)
    for c in range(1, channels):
        np.testing.assert_array_equal(collect(symbols, counts, c), lane0)

    pipe = DemodPipeline(CFG, 2048, exact=False, use_atan_lut="free")
    step = pipe.make_batched_step_full("kernel")
    st = pipe.init_full_state(1)
    x = np.stack([iq.real, iq.imag])[None].astype(np.float32)
    st, ref_sym, ref_cnt = step(st, jnp.asarray(x))
    ref = collect(np.asarray(ref_sym), np.asarray(ref_cnt), 0)
    np.testing.assert_array_equal(lane0, ref)


def test_pipelined_streams_equal_unsharded_full_block(resources_dir):
    """Multi-device path: 8 independent streams, each stream's time axis
    sharded over 8 devices in the skewed systolic layout, front end with
    ring-halo state, clock rotation
    with ppermuted suffix-carry.  Every stream's symbols must equal
    feeding that stream alone through the single-chip full-block step
    with block = N/D: same symbol count (the M&M clock walks the same
    path — no divergence), values within the reference's own ±2 LSB
    golden policy (test/test_fsk_demod.c:43-48; XLA compiles the
    shard_map program with different fusion/FMA choices than the plain
    one, so 1-ulp float wiggle at int8 rounding boundaries is expected —
    the same wiggle the reference accepts across machines)."""
    from sdrmodem.dsp.pipeline import DemodPipeline
    from sdrmodem.parallel.time_shard import demod_pipelined

    n_dev, n = 8, 32768
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)
    rng = np.random.default_rng(7)
    # 8 DISTINCT streams: different capture offsets + per-stream noise, so
    # symbol clocks genuinely diverge across the rotation
    streams = np.stack(
        [
            iq[s * 1024 : s * 1024 + n]
            + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            for s in range(n_dev)
        ]
    ).astype(np.complex64)

    mesh = _mesh("time")
    outs = demod_pipelined(streams, CFG, mesh, clock_backend="scan")
    assert len(outs) == n_dev

    block = n // n_dev
    pipe = DemodPipeline(CFG, block, exact=False, use_atan_lut=False)
    step = pipe.make_batched_step_full("scan")
    for s in range(n_dev):
        st = pipe.init_full_state(1)
        parts = []
        for dd in range(n_dev):
            x = np.stack(
                [
                    streams[s, dd * block : (dd + 1) * block].real,
                    streams[s, dd * block : (dd + 1) * block].imag,
                ]
            )[None].astype(np.float32)
            st, sym, cnt = step(st, jnp.asarray(x))
            sym, cnt = np.asarray(sym), np.asarray(cnt)
            parts.extend(sym[0, t, : cnt[0, t]] for t in range(cnt.shape[1]))
        ref = np.concatenate(parts)
        assert len(outs[s]) == len(ref)  # identical clock path
        diff = np.abs(outs[s].astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 2 and (diff > 0).mean() < 0.01


def test_pipeline_schedule_is_bubble_free():
    from sdrmodem.parallel.time_shard import pipeline_schedule_report

    rep = pipeline_schedule_report(8, 1 << 20, CFG)
    assert rep["idle_device_rounds"] == 0
    assert rep["schedule_efficiency"] == 1.0
    assert rep["busy_device_rounds"] == rep["clock_block_tasks"] == 64
    assert rep["halo_bytes_per_device"] > 0


def test_grid_sharded_channels_by_time(resources_dir):
    """2-D mesh: 2 channel shards x 4 time shards; every channel's output
    matches the unsharded whole-stream demodulator."""
    from sdrmodem.parallel.time_shard import demod_grid_sharded

    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)[:32768]
    channels = 4
    batch = np.tile(iq, (channels, 1))
    devices = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devices, axis_names=("channel", "time"))

    outs = demod_grid_sharded(batch, CFG, mesh, clock_backend="scan")

    ref_out, ref_count, _ = FskDemodulator(CFG, exact=False).process(jnp.asarray(iq))
    ref = np.asarray(ref_out)[: int(ref_count)]
    for ch in range(channels):
        assert len(outs[ch]) == len(ref)
        diff = np.abs(outs[ch].astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 2 and (diff > 0).mean() < 0.01


def test_pipelined_lane_packing_k_streams(resources_dir):
    """S > D: k = S/D streams pack per ring group, filling the vector
    lanes (the round-3 path wasted 94% of lanes at S == D).  Every
    stream must still equal its solo single-chip full-block run."""
    from sdrmodem.dsp.pipeline import DemodPipeline
    from sdrmodem.parallel.time_shard import demod_pipelined

    n_dev, n, s_streams = 4, 16384, 10  # k = ceil(10/4) = 3, 2 pad lanes
    iq = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)
    rng = np.random.default_rng(3)
    streams = np.stack(
        [
            iq[s * 512 : s * 512 + n]
            + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            for s in range(s_streams)
        ]
    ).astype(np.complex64)

    devices = np.array(jax.devices()[:n_dev])
    mesh = Mesh(devices, axis_names=("time",))
    outs = demod_pipelined(streams, CFG, mesh, clock_backend="scan")
    assert len(outs) == s_streams

    block = n // n_dev
    pipe = DemodPipeline(CFG, block, exact=False, use_atan_lut=False)
    step = pipe.make_batched_step_full("scan")
    for s in range(s_streams):
        st = pipe.init_full_state(1)
        parts = []
        for dd in range(n_dev):
            x = np.stack(
                [
                    streams[s, dd * block : (dd + 1) * block].real,
                    streams[s, dd * block : (dd + 1) * block].imag,
                ]
            )[None].astype(np.float32)
            st, sym, cnt = step(st, jnp.asarray(x))
            sym, cnt = np.asarray(sym), np.asarray(cnt)
            parts.extend(sym[0, t, : cnt[0, t]] for t in range(cnt.shape[1]))
        ref = np.concatenate(parts)
        assert len(outs[s]) == len(ref), f"stream {s}"
        diff = np.abs(outs[s].astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 2 and (diff > 0).mean() < 0.01


def test_pipelined_doppler_golden(resources_dir):
    """VERDICT item: Doppler through the sharded path.  The raw lucky7
    capture with per-stream device Doppler tables (skewed like the data)
    demodulates to the lucky7 golden symbols on the virtual mesh; a
    doppler-free lane of the pre-corrected capture rides along."""
    from sdrmodem.dsp.doppler import Doppler
    from sdrmodem.parallel.time_shard import demod_pipelined
    from tests.test_doppler import ARGS

    n_dev = 4
    raw = np.fromfile(resources_dir / "lucky7.cf32", dtype=np.complex64)
    pre = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)
    n = (len(raw) // (n_dev * CFG.decimation)) * n_dev * CFG.decimation
    streams = np.stack([raw[:n], pre[:n]]).astype(np.complex64)

    devices = np.array(jax.devices()[:n_dev])
    mesh = Mesh(devices, axis_names=("time",))
    outs = demod_pipelined(
        streams, CFG, mesh, clock_backend="scan",
        dopplers=[Doppler(**ARGS), None],
    )
    for s in range(2):
        got = outs[s][: len(golden)]
        m = min(len(got), len(golden))
        assert m >= len(golden) - 2
        diff = np.abs(got[:m].astype(np.int32) - golden[:m].astype(np.int32))
        assert diff.max() <= 2, f"stream {s}: {(diff > 2).sum()} beyond"


def test_grid_sharded_doppler(resources_dir):
    """Per-channel Doppler through the 2-D grid (channel x time)."""
    from sdrmodem.dsp.doppler import Doppler
    from sdrmodem.parallel.time_shard import demod_grid_sharded
    from tests.test_doppler import ARGS

    raw = np.fromfile(resources_dir / "lucky7.cf32", dtype=np.complex64)
    pre = np.fromfile(resources_dir / "lucky7.expected.cf32", dtype=np.complex64)
    golden = np.fromfile(resources_dir / "lucky7.expected.s8", dtype=np.int8)
    n = 32768
    batch = np.stack([raw[:n], pre[:n], raw[:n], pre[:n]]).astype(np.complex64)
    dops = [Doppler(**ARGS), None, Doppler(**ARGS), None]

    devices = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devices, axis_names=("channel", "time"))
    outs = demod_grid_sharded(batch, CFG, mesh, clock_backend="scan", dopplers=dops)
    for ch in range(4):
        got = outs[ch]
        m = min(len(got), len(golden))
        assert m > 3000
        diff = np.abs(got[:m].astype(np.int32) - golden[:m].astype(np.int32))
        assert diff.max() <= 2, f"ch {ch}: {(diff > 2).sum()} beyond"
