"""Time-sharded demodulation of one long stream across devices.

The reference streams unbounded signals in O(buffer) memory by carrying
per-block state (FIR tails, quad-demod sample, clock phase —
src/dsp/fir_filter.c:107-110, clock_recovery_mm.c:119-135).  Sharded over
a device mesh this becomes:

- the filter front-end (LPF1 → quad demod → LPF2 → DC) is data-parallel
  over time blocks with **overlap-save halo exchange**: each device
  receives its left neighbour's taps-1 tail via ``jax.lax.ppermute``, so
  every FIR window is complete and the sharded result equals the
  unsharded stream bit for bit;
- M&M clock recovery is inherently sequential, so its tiny carried state
  {omega, mu, last, input tail} is **handed block-to-block**: block d's
  scan consumes block d-1's final state.  Here the hand-off is a
  sequential pass over the sharded blocks (device-to-device state
  transfer); multiple independent streams can be pipelined to fill all
  devices every step.

Block length must be a multiple of the decimation factor so decimated
output indices align with block boundaries.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sdrmodem.dsp.clock_recovery import clock_mm_batched_full, initial_full_state
from sdrmodem.dsp.fsk_demod import FskDemodConfig, float_to_int8
from sdrmodem.dsp.pipeline import FrontTaps, front_full


def _put(arr: np.ndarray, sharding: NamedSharding):
    """device_put that also works on a MULTI-PROCESS mesh (each process
    contributes its addressable shards of the same global host array —
    the multi-host analog of the reference's per-host TCP fan-in)."""
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(arr), sharding)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: np.ascontiguousarray(arr[idx])
    )


def _fetch(x) -> np.ndarray:
    """Gather a (possibly cross-process) sharded array to every host."""
    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def demod_time_sharded(
    iq: np.ndarray,
    config: FskDemodConfig,
    mesh: Mesh,
    axis: str = "time",
    **kw,
):
    """Demodulate ONE stream with its time axis sharded over ``mesh``.

    Thin wrapper over the production systolic path (``demod_pipelined``
    with S=1 — the old XLA-front/host-clock-loop variant is retired);
    returns (int8 symbols, count) equal to the unsharded whole-stream
    full-block demod.
    """
    outs = demod_pipelined(np.asarray(iq, np.complex64)[None, :], config, mesh, axis, **kw)
    return outs[0], len(outs[0])


def _skewed_layout(iq, dopplers, config, n_dev, lanes=128):
    """Host-side staging shared by the pipelined and grid paths.

    Streams s = j*k + g (j = ring group in [0, D), g = slot in [0, k));
    stream s's time-block dd lives on device (j + dd) mod D at lane s, so
    every stream's predecessor block is on the ring-left neighbour and
    block 0 of group j starts ON device j (zero fill/drain bubbles).

    Returns (x_skew (D, B, 2*lanes) f32, dop_tabs (D, 4, rows, lanes) f32
    or None, block, k).
    """
    s_streams, n = iq.shape
    d = config.decimation
    k = -(-s_streams // n_dev)  # streams per ring group (zero-pad the rest)
    s_pad = k * n_dev
    if s_pad > lanes:
        raise ValueError(
            f"{s_streams} streams over {n_dev} devices needs {s_pad} lanes > {lanes}"
        )
    block = -(-n // n_dev)
    block = -(-block // d) * d
    padded = np.zeros((s_pad, block * n_dev), np.complex64)
    padded[:s_streams, :n] = np.asarray(iq, np.complex64)

    x_skew = np.zeros((n_dev, block, 2 * lanes), np.float32)
    for s in range(s_pad):
        j = s // k
        for dd in range(n_dev):
            p = (j + dd) % n_dev
            blk = padded[s, dd * block : (dd + 1) * block]
            x_skew[p, :, s] = blk.real
            x_skew[p, :, lanes + s] = blk.imag

    dop_tabs = None
    if dopplers is not None and any(dp is not None for dp in dopplers):
        from sdrmodem.dsp.doppler import Doppler

        # the goldens' interpolation cadence (reference test_doppler.c
        # streams 2000-sample buffers; the reference interpolates df per
        # buffer, so cadence = fidelity) — pinning it makes the sharded
        # correction independent of the block-partitioning choice
        cadence = 2000
        rows = Doppler.max_rows(block, config.sampling_freq, cadence)
        # tabs rows: 0=start, 1=end, 2=adj, 3=ph0 (nco_mix_pair_tm order)
        dop_tabs = np.zeros((n_dev, 4, rows, lanes), np.float32)
        for s, dp in enumerate(dopplers):
            if dp is None:
                continue
            j = s // k
            # walk the stream's blocks IN ORDER (device_segments advances
            # the 1 Hz SGP4 state exactly like the streaming server does)
            for dd in range(n_dev):
                p = (j + dd) % n_dev
                segs = dp.device_segments(block, +1, max_batch=cadence)
                for r, (st, ln, adj, ph0) in enumerate(segs):
                    dop_tabs[p, 0, r, s] = st
                    dop_tabs[p, 1, r, s] = st + ln
                    dop_tabs[p, 2, r, s] = adj
                    dop_tabs[p, 3, r, s] = ph0
    return x_skew, dop_tabs, block, k


def _pipelined_shard_fn(
    x_tm, cstate, dop_tab, taps: FrontTaps, clock_params, axis, n_dev, lanes, k,
    *, clock,
):
    """One device's whole program: optional device-side Doppler mix, the
    halo'd production front-end, then the systolic clock rotation."""
    if dop_tab is not None:
        from sdrmodem.dsp.elementwise import nco_mix_pair_tm

        x_tm = nco_mix_pair_tm(
            x_tm, dop_tab[0], dop_tab[1], dop_tab[2], dop_tab[3]
        )
    p = jax.lax.axis_index(axis)
    soft, _ = front_full(
        x_tm, lambda stage, x, h: _ring_halo(x, h, axis, lanes, p, k), taps
    )
    return _clock_rotation(soft, cstate, clock_params, axis, n_dev, k, clock=clock)


def demod_pipelined(
    iq: np.ndarray,  # (S, N) complex64 — S independent streams, S <= 128
    config: FskDemodConfig,
    mesh: Mesh,
    axis: str = "time",
    *,
    clock_backend: str | None = None,
    use_atan_lut="free",
    dopplers=None,  # optional list of per-stream Doppler (or None) objects
):
    """PRODUCTION multi-device path: S streams demodulated with each
    stream's time axis sharded over the mesh, ZERO idle device-rounds.

    The reference overlaps its sequential demod with concurrent reader
    threads (src/dsp_worker.c:44-106, src/queue.c:168-200); re-expressed
    for a device mesh as a systolic skew:

    - layout: streams pack k = ceil(S/D) per ring group (lane s = j*k+g);
      stream (j, g)'s time-block dd lives on device (j + dd) mod D, so
      for EVERY stream the predecessor block is on the ring-left
      neighbour and group j's block 0 is local to device j;
    - front-end (LPF1 → quad → LPF2 → DC) is the single-device step's
      ``pipeline.front_full``, all local blocks batched in 128 lanes;
      each stage's history is its ring-left neighbour's output tail (one
      ppermute per stage, zeros for block 0) — the same values as the
      unsharded full-block state hand-off;
    - M&M clock recovery is sequential per stream, so the D block-walks
      rotate: in round r device p advances the k streams of ring group
      (p - r) mod D through its local block, then the suffix-carry
      state (ClockFullState, k lanes) ppermutes one step right.  Every
      round keeps ALL devices busy on a different group's clock — the
      pipeline analog of the reference's reader/demod thread overlap,
      with D rounds total and zero fill or drain bubbles (see
      ``pipeline_schedule_report``).

    With ``dopplers`` (one entry per stream, None = no correction), each
    stream's per-block piecewise-linear NCO tables are staged in the same
    skew as the data and applied on-device before LPF1 — the sharded
    equivalent of the single-chip step's doppler=True
    (reference src/dsp/doppler.c:164-186 applies it per client in-stream).

    Returns list of S int8 symbol arrays, bit-identical to feeding each
    stream through DemodPipeline.make_batched_step_full with block = N/D.
    """
    from sdrmodem.ops import select

    clock = select.clock_backend(clock_backend)
    n_dev = mesh.shape[axis]
    s_streams = iq.shape[0]
    lanes = 128  # lane granule of the full-block state
    x_skew, dop_tabs, block, k = _skewed_layout(iq, dopplers, config, n_dev, lanes)
    x = _put(x_skew, NamedSharding(mesh, P(axis, None, None)))

    taps = FrontTaps.from_config(config, use_atan_lut)
    p_clock = config.clock_params()
    cstate0 = initial_full_state(p_clock["omega"], k, p_clock["mu"])

    have_dop = dop_tabs is not None

    def shard_fn(x_loc, cstate, *dop):
        x_tm = x_loc[0]  # (B, 2*lanes)
        cstate = jax.tree.map(lambda a: a[0], cstate)  # strip local shard dim
        tab = dop[0][0] if have_dop else None
        outs, counts = _pipelined_shard_fn(
            x_tm, cstate, tab, taps, p_clock, axis, n_dev, lanes, k, clock=clock,
        )
        return outs[None], counts[None]

    in_specs = [P(axis, None, None), P(axis)]
    args = [x]
    cstate = jax.tree.map(
        lambda a: _put(
            np.broadcast_to(np.asarray(a)[None], (n_dev,) + a.shape),
            NamedSharding(mesh, P(axis)),
        ),
        cstate0,
    )
    args.append(cstate)
    if have_dop:
        in_specs.append(P(axis, None, None, None))
        args.append(_put(dop_tabs, NamedSharding(mesh, P(axis, None, None, None))))
    run = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=(P(axis, None, None, None, None), P(axis, None, None, None)),
            check_vma=False,
        )
    )
    outs, counts = run(*args)
    outs, counts = _fetch(outs), _fetch(counts)

    # reassemble: stream (j, g)'s block r was produced on device (j + r)
    # mod D, slot g.  When n is not a multiple of D*decimation the zero
    # padding clocks out trailing zero symbols, exactly as the unsharded
    # step would on the same padded stream.
    results = []
    for s in range(s_streams):
        j, g = s // k, s % k
        parts = []
        for r in range(n_dev):
            dev = (j + r) % n_dev
            for t in range(counts.shape[3]):
                parts.append(outs[dev, r, g, t, : counts[dev, r, g, t]])
        results.append(np.concatenate(parts))
    return results


def _ring_halo(arr, h, axis_name, lanes, p, k=1):
    """Ring-shift the last ``h`` rows one device right; zero the halo for
    lanes whose LOCAL block is the stream's first (ring group == device
    index under the skewed layout; lane s belongs to group s // k)."""
    tail = arr[-h:, :]
    n_dev = jax.lax.axis_size(axis_name)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    halo = jax.lax.ppermute(tail, axis_name, perm)
    first = ((jnp.arange(arr.shape[1]) % lanes) // k) == p
    return jnp.where(first[None, :], 0.0, halo)


def _clock_rotation(soft, cstate, p_clock, axis_name, n_dev, k, *, clock):
    """D systolic rounds: round r advances the k streams of ring group
    (p - r) mod D through the local block (index r), then the
    suffix-carry state (k lanes) ppermutes one device right.  All
    devices busy every round."""
    n2 = soft.shape[0]
    p = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    outs_rounds, counts_rounds = [], []
    for r in range(n_dev):
        group = jax.lax.rem(p - jnp.int32(r) + jnp.int32(n_dev), jnp.int32(n_dev))
        my = jax.lax.dynamic_slice(
            soft, (jnp.int32(0), group * jnp.int32(k)), (n2, k)
        )
        o, cnt, cstate = clock_mm_batched_full(
            my, cstate,
            omega=p_clock["omega"], gain_omega=p_clock["gain_omega"],
            mu=p_clock["mu"], gain_mu=p_clock["gain_mu"],
            omega_relative_limit=p_clock["omega_relative_limit"],
            backend=clock,
        )
        outs_rounds.append(float_to_int8(o))  # (k, n_chunks, K)
        counts_rounds.append(cnt)  # (k, n_chunks)
        if r + 1 < n_dev:
            cstate = jax.tree.map(
                lambda a: jax.lax.ppermute(a, axis_name, perm), cstate
            )
    return jnp.stack(outs_rounds), jnp.stack(counts_rounds)


def pipeline_schedule_report(
    n_devices: int, n_samples: int, config: FskDemodConfig, n_streams: int = 0
):
    """Steps-per-device accounting for ``demod_pipelined`` — the scaling
    evidence obtainable without real multi-chip hardware.

    The schedule is systolic: S = k*D streams (k per ring group, packing
    the 128 lanes), D time-blocks each, D clock rounds with every device
    advancing exactly one GROUP of k streams per round, so
    device-busy is 100% by construction (no fill/drain bubbles — block 0
    of stream p starts ON device p).  Communication per block-step is the
    per-stage halo tails + the 65-element clock state, which moves
    concurrently with the next round's compute."""
    d = config.decimation
    block = -(-(-(-n_samples // n_devices)) // d) * d
    t1 = len(config.lpf1_taps())
    t2 = len(config.lpf2_taps())
    dc = 4 * config.dc_length - 4 if config.use_dc_block else 0
    lanes = 128
    k = max(1, -(-n_streams // n_devices)) if n_streams else 1
    halo_bytes = 4 * lanes * (2 * (t1 - 1) + 2 * 1 + t2 - 1 + dc)
    state_bytes = 4 * (64 + 4) * k * n_devices  # suffix + scalars, per round
    clock_tasks = k * n_devices * n_devices  # S streams x D blocks
    busy = n_devices * n_devices  # 1 group-task/device/round x D rounds
    return dict(
        devices=n_devices,
        rounds=n_devices,
        block_samples=block,
        streams=k * n_devices,
        streams_per_group=k,
        lane_utilization=min(1.0, k * n_devices / lanes),
        clock_block_tasks=clock_tasks,
        busy_device_rounds=busy,
        idle_device_rounds=0,
        schedule_efficiency=1.0,
        halo_bytes_per_device=halo_bytes,
        clock_state_bytes_per_round=state_bytes,
    )


def demod_grid_sharded(
    iq: np.ndarray,  # (C, N) complex64
    config: FskDemodConfig,
    mesh: Mesh,
    channel_axis: str = "channel",
    time_axis: str = "time",
    *,
    clock_backend: str | None = None,
    use_atan_lut="free",
    dopplers=None,  # optional list of per-channel Doppler (or None)
):
    """2-D sharding: channels over one mesh axis, each stream's TIME over
    the other.

    Each channel shard runs exactly the pipelined systolic program
    (``_pipelined_shard_fn`` — the full-block front end with ring halos,
    k streams per ring group filling the 128 lanes, rotating
    suffix-carry clock rounds) along the time axis; the channel axis is
    embarrassingly parallel.  Per-channel Doppler tables ride the same
    skew (``dopplers``).

    Returns (list of per-channel int8 symbol arrays), bit-identical to
    ``demod_pipelined`` of each channel shard, which is bit-identical to
    the unsharded full-block step.
    """
    from sdrmodem.ops import select

    clock = select.clock_backend(clock_backend)
    c, n = iq.shape
    n_c = mesh.shape[channel_axis]
    n_t = mesh.shape[time_axis]
    lanes = 128
    # channels round-robin over channel shards: shard ci gets channels
    # ci, ci+n_c, ... (keeps shard loads balanced for any C)
    c_per = -(-c // n_c)
    taps = FrontTaps.from_config(config, use_atan_lut)
    p_clock = config.clock_params()

    xs, tabs, ks = [], [], []
    for ci in range(n_c):
        chans = list(range(ci, c, n_c))
        local = np.zeros((c_per, n), np.complex64)
        local[: len(chans)] = iq[chans]
        dops = None
        if dopplers is not None:
            dops = [dopplers[ch] for ch in chans] + [None] * (c_per - len(chans))
        x_skew, dop_tabs, block, k = _skewed_layout(
            local, dops, config, n_t, lanes
        )
        xs.append(x_skew)
        ks.append(k)
        tabs.append(dop_tabs)
    k = ks[0]
    have_dop = any(t is not None for t in tabs)
    if have_dop:
        rows = next(t.shape[2] for t in tabs if t is not None)
        tabs = [
            t if t is not None else np.zeros((n_t, 4, rows, lanes), np.float32)
            for t in tabs
        ]

    x = _put(
        np.stack(xs),  # (n_c, n_t, B, 2*lanes)
        NamedSharding(mesh, P(channel_axis, time_axis, None, None)),
    )
    cstate0 = initial_full_state(p_clock["omega"], k, p_clock["mu"])
    cstate = jax.tree.map(
        lambda a: _put(
            np.broadcast_to(np.asarray(a)[None, None], (n_c, n_t) + a.shape),
            NamedSharding(mesh, P(channel_axis, time_axis)),
        ),
        cstate0,
    )

    def shard_fn(x_loc, cs, *dop):
        x_tm = x_loc[0, 0]  # (B, 2*lanes)
        cs = jax.tree.map(lambda a: a[0, 0], cs)
        tab = dop[0][0, 0] if have_dop else None
        outs, counts = _pipelined_shard_fn(
            x_tm, cs, tab, taps, p_clock, time_axis, n_t, lanes, k, clock=clock,
        )
        return outs[None, None], counts[None, None]

    in_specs = [
        P(channel_axis, time_axis, None, None),
        jax.tree.map(lambda _: P(channel_axis, time_axis), cstate0),
    ]
    args = [x, cstate]
    if have_dop:
        in_specs.append(P(channel_axis, time_axis, None, None, None))
        args.append(
            _put(
                np.stack(tabs),
                NamedSharding(mesh, P(channel_axis, time_axis, None, None, None)),
            )
        )
    run = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=(
                P(channel_axis, time_axis, None, None, None, None),
                P(channel_axis, time_axis, None, None, None),
            ),
            check_vma=False,
        )
    )
    outs, counts = run(*args)
    outs, counts = _fetch(outs), _fetch(counts)

    results = [None] * c
    for ci in range(n_c):
        chans = list(range(ci, c, n_c))
        for li, ch in enumerate(chans):
            j, g = li // k, li % k
            parts = []
            for r in range(n_t):
                dev = (j + r) % n_t
                for t in range(counts.shape[4]):
                    parts.append(outs[ci, dev, r, g, t, : counts[ci, dev, r, g, t]])
            results[ch] = np.concatenate(parts)
    return results
