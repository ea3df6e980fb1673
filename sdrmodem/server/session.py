"""RX/TX session management — the async analog of the reference's
tcp_worker / dsp_worker / sdr_worker triad (src/tcp_server.c,
src/dsp_worker.c, src/sdr_worker.c).

- An RxSession owns the per-client demod pipeline (queue → dump →
  doppler → fsk_demod → dump/socket), one task instead of one thread.
- An SdrStream owns one SDR device reader and fans buffers out to every
  attached session (connection sharing: a new client reuses a stream
  with equal center_freq, offset, and sampling_freq >= requested —
  sdr_worker_find_closest, src/sdr_worker.c:83-95).
- TX runs inline in the client connection handler, one TxData at a time
  with a synchronous ack (src/tcp_server.c:176-241).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from dataclasses import dataclass, field

import numpy as np

from sdrmodem.devices.base import SdrDevice
from sdrmodem.dsp.doppler import Doppler
from sdrmodem.dsp.fsk_demod import FskDemodConfig
from sdrmodem.dsp.pipeline import DemodPipeline
from sdrmodem.dsp.streaming import StreamingGfskMod
from sdrmodem.server import wire
from sdrmodem.server.config import RxSdrType, ServerConfig
from sdrmodem.utils.queue import BufferQueue

log = logging.getLogger("sdrmodem.session")


def doppler_from_settings(
    settings: wire.DopplerSettings,
    sampling_freq: int,
    center_freq: int,
    constant_offset: int,
    start_time_seconds: int,
) -> Doppler:
    """Construct Doppler with the reference's exact unit quirks:
    lat/lon wire values divided by 10E6 (=1e7) and altitude by 10E3
    (src/dsp_worker.c:130, src/tcp_server.c:549)."""
    return Doppler(
        latitude=settings.latitude / 10e6,
        longitude=settings.longitude / 10e6,
        altitude_km=settings.altitude / 10e3,
        sampling_freq=sampling_freq,
        center_freq=center_freq,
        tle_lines=wire.tle_to_lines(settings.tle),
        constant_offset=constant_offset,
        start_time_seconds=start_time_seconds,
    )


@dataclass
class RxKey:
    """Connection-sharing key (struct sdr_rx analog)."""

    center_freq: int
    sampling_freq: int
    offset: int

    def matches(self, other: "RxKey") -> bool:
        """sdr_worker_find_closest: equal tuning, adequate rate."""
        return (
            self.center_freq == other.center_freq
            and self.sampling_freq >= other.sampling_freq
            and self.offset == other.offset
        )


class RxSession:
    """Per-client demodulation lane (dsp_worker analog).

    In ``demod_mode = exact`` (default) the session owns a deterministic
    f64-accumulated streaming pipeline and a consumer task, mirroring the
    reference's one-thread-per-client.  In ``demod_mode = fast`` the
    session is a LANE of its stream's BatchedRxGroup: the group steps all
    clients through one full-block device step and calls ``emit`` with
    this lane's symbols."""

    def __init__(
        self,
        client_id: int,
        req: wire.RxRequest,
        config: ServerConfig,
        writer: asyncio.StreamWriter | None,
    ):
        self.id = client_id
        self.req = req
        self.writer = writer
        self.config = config
        fsk = req.fsk_settings
        self.fsk_config = FskDemodConfig(
            sampling_freq=req.rx_sampling_freq,
            baud_rate=req.demod_baud_rate,
            deviation=fsk.demod_fsk_deviation,
            decimation=req.demod_decimation,
            transition_width=fsk.demod_fsk_transition_width,
            use_dc_block=fsk.demod_fsk_use_dc_block,
        )
        self.mode = config.demod_mode
        if self.mode == "exact":
            self.demod = DemodPipeline(
                self.fsk_config, block_size=config.buffer_size, exact=True
            ).streamer()
        else:
            # constructing the pipeline validates the FSK parameters at
            # request time exactly like the exact path (jit itself is lazy);
            # the stream's BatchedRxGroup owns the compiled batched step
            self.demod = None
            DemodPipeline(self.fsk_config, block_size=config.buffer_size, exact=False)
        self.group = None  # set by SdrStream.add_session in fast mode
        self.lane = -1
        self.doppler: Doppler | None = None
        if req.doppler is not None:
            start = req.file_settings.start_time_seconds if req.file_settings else 0
            self.doppler = doppler_from_settings(
                req.doppler, req.rx_sampling_freq, req.rx_center_freq, 0, start
            )
        # blocking queue iff rx source is a file (no drops; dsp_worker.c:176-179)
        self.queue = BufferQueue(
            config.queue_size, blocking=config.rx_sdr_type == RxSdrType.FILE
        )
        self.rx_dump = (
            open(f"{config.base_path}/rx.sdr2demod.{client_id}.cf32", "wb")
            if req.rx_dump_file
            else None
        )
        dest = req.demod_destination
        self.demod_dump = (
            open(f"{config.base_path}/rx.demod2client.{client_id}.s8", "wb")
            if dest in (wire.DemodDestination.FILE, wire.DemodDestination.BOTH)
            else None
        )
        self.to_socket = dest in (wire.DemodDestination.SOCKET, wire.DemodDestination.BOTH)
        self.task: asyncio.Task | None = None
        self.finished = asyncio.Event()
        # observability counters (the reference logs per-client byte totals;
        # SURVEY §5 adds running samples/s and queue drops)
        self.samples_in = 0
        self.symbols_out = 0
        self._rate_t0 = time.monotonic()
        self._rate_samples = 0
        self._rate_interval = 10.0  # seconds between samples/s log lines

    def note_progress(self, n_samples: int):
        """Update throughput counters; log a structured rate line every
        ``_rate_interval`` seconds (SURVEY §5 'samples/s counters')."""
        self.samples_in += n_samples
        self._rate_samples += n_samples
        now = time.monotonic()
        dt = now - self._rate_t0
        if dt >= self._rate_interval:
            log.info(
                "[%d] rx rate %.3f Msamples/s | totals: %d samples in, "
                "%d symbols out, %d queue drops",
                self.id, self._rate_samples / dt / 1e6,
                self.samples_in, self.symbols_out, self.queue.dropped,
            )
            self._rate_t0 = now
            self._rate_samples = 0

    def start(self):
        if self.mode == "fast":
            log.info("[%d] dsp_worker is starting (batched fast lane)", self.id)
            return
        self.task = asyncio.create_task(self._run(), name=f"rx-session-{self.id}")

    def to_standalone(self):
        """Demote a fast-mode session to its own per-client ragged
        pipeline (float32, same numerics class as the batched step).

        Fast-mode lanes batch by EXACT demod-config equality; a client
        whose config matches no group when the per-stream group cap
        (SDRM_MAX_GROUPS) is reached would otherwise spawn yet another
        full batched step over mostly-empty lanes — quadratically
        wasteful as configs diversify.  The demoted session takes the
        queue/worker path instead (one reference dsp_worker thread)."""
        assert self.mode == "fast" and self.task is None
        self.mode = "standalone"
        self.demod = DemodPipeline(
            self.fsk_config, block_size=self.config.buffer_size, exact=False
        ).streamer()
        log.info(
            "[%d] demod group cap reached; running as standalone lane", self.id
        )

    async def emit(self, symbols: np.ndarray):
        """Deliver one lane's demodulated symbols (fast mode).

        Guarded against teardown races: a batched step that snapshotted
        this lane before ``stop()`` closed the writers must become a no-op
        — an exception here would propagate through the group's feed()
        into SdrStream._run and kill the reader for EVERY client."""
        if self.finished.is_set():
            return
        self.symbols_out += len(symbols)
        if self.demod_dump is not None:
            try:
                self.demod_dump.write(symbols.tobytes())
            except ValueError:  # closed by stop() mid-step
                return
        if self.to_socket and self.writer is not None:
            try:
                self.writer.write(symbols.tobytes())
                await self.writer.drain()
            except (ConnectionError, RuntimeError):
                pass  # teardown arrives via the control loop

    async def _run(self):
        log.info("[%d] dsp_worker is starting", self.id)
        # The ragged-block pipeline runs any chunk size through ONE
        # compiled program, so buffers are processed as they arrive
        # (the reference's per-buffer dsp_worker loop).
        try:
            while True:
                buf = await self.queue.take()
                if buf is None:
                    break  # poison pill
                if self.rx_dump is not None:
                    self.rx_dump.write(np.asarray(buf, np.complex64).tobytes())
                if self.doppler is not None:
                    buf = await asyncio.to_thread(self.doppler.process_rx, buf)
                self.note_progress(len(buf))
                symbols = await asyncio.to_thread(self.demod.process, buf)
                self.symbols_out += len(symbols)
                if len(symbols) == 0:
                    continue
                if self.demod_dump is not None:
                    self.demod_dump.write(symbols.tobytes())
                if self.to_socket and self.writer is not None:
                    try:
                        self.writer.write(symbols.tobytes())
                        await self.writer.drain()
                    except (ConnectionError, RuntimeError):
                        break
        except asyncio.CancelledError:
            pass
        except Exception:
            log.exception("[%d] dsp_worker failed", self.id)
        finally:
            if self.rx_dump:
                self.rx_dump.close()
            if self.demod_dump:
                self.demod_dump.close()
            self.finished.set()
            log.info(
                "[%d] dsp_worker stopped (%d samples in, %d symbols out, "
                "%d queue drops)",
                self.id, self.samples_in, self.symbols_out, self.queue.dropped,
            )

    async def put(self, buf: np.ndarray):
        await self.queue.put(buf)

    def finish_fast(self):
        """Idempotently mark a fast-mode lane finished and close its
        writers.  ``finished`` is set FIRST so in-flight emits see it
        before the files close (both run on the event loop; emit has no
        await between the check and the write)."""
        if self.finished.is_set():
            return
        self.finished.set()
        if self.rx_dump and not self.rx_dump.closed:
            self.rx_dump.close()
        if self.demod_dump and not self.demod_dump.closed:
            self.demod_dump.close()
        log.info(
            "[%d] dsp_worker stopped (%d samples in, %d symbols out)",
            self.id, self.samples_in, self.symbols_out,
        )

    async def stop(self):
        if self.mode == "fast":
            self.finish_fast()
            return
        await self.queue.interrupt()
        if self.task:
            await self.task


class BatchedRxGroup:
    """All fast-mode clients of one SDR stream that share a demod
    signature, batched as lanes of ONE compiled full-block step.

    This is the batched shape of the reference's thread-per-client model:
    the stream buffer is broadcast to every lane (the reference's
    sdr_worker fan-out, src/sdr_worker.c:31-55), the host computes each
    lane's Doppler NCO table, and a single device step advances all
    lanes.

    ``LANES`` (SDRM_SERVER_LANES, default 128, any multiple of 128): the
    clients-per-compiled-step capacity.  Each lane of the clock kernel is
    its own dependent chain, so wider groups serve more clients in about
    the same step time."""

    LANES = max(128, -(-int(os.environ.get("SDRM_SERVER_LANES", "128")) // 128) * 128)

    def __init__(
        self,
        fsk_config: FskDemodConfig,
        block: int,
        *,
        blocking: bool = False,
        queue_capacity: int | None = None,
    ):
        import jax.numpy as jnp

        self.fsk_config = fsk_config
        self.block = block
        # ingest/compute overlap (the reference's whole reason for queue.c:
        # the SDR reader thread must never wait on the demodulator,
        # src/sdr_worker.c:31-55): filled blocks go through a bounded
        # BufferQueue to a worker task that runs the device step, so
        # ``feed`` returns as soon as the block is copied.  blocking=True
        # (file sources) back-pressures the reader instead of dropping.
        # Capacity follows the server config's queue_size (the reference's
        # queue_size knob, default 64, server_config.c:89-97) — deep
        # enough to ride out the first step's jit compile.
        from sdrmodem.utils.queue import BufferQueue

        self.blocking = blocking
        if queue_capacity is None:
            queue_capacity = int(os.environ.get("SDRM_GROUP_QUEUE", "64"))
        self.queue = BufferQueue(queue_capacity, blocking)
        self._worker_task: asyncio.Task | None = None
        self.blocks_processed = 0
        # "free": gather-free evaluation of the reference's atan LUT —
        # same piecewise-linear function (table entries recomputed on the
        # fly, <=2 ulp).  See dsp/elementwise.fast_atan2_free.
        self.pipe = DemodPipeline(fsk_config, block, exact=False, use_atan_lut="free")
        # "fanout": the step takes the ONE shared (2, block) stream and
        # broadcasts it to the lanes on-device — no per-lane host copies
        # and no (C,2,B)->(B,2C) device transpose (the group exists
        # precisely because every lane demodulates the same SDR stream)
        self._step = self._build_step()
        # device-side Doppler: S piecewise-linear phase rows per block
        # (host keeps the 1 Hz SGP4 bookkeeping; Doppler.device_segments)
        self.dop_rows = Doppler.max_rows(block, fsk_config.sampling_freq)
        self.state = self.pipe.init_full_state(self.LANES)
        self._init_state_template = self.pipe.init_full_state(1)
        self.lanes: dict[int, RxSession] = {}
        # lanes whose state must be zeroed before the NEXT step: attach()
        # must not mutate self.state directly — a step awaiting in a worker
        # thread read the pre-reset state and would overwrite the reset on
        # return, silently handing the new client the previous occupant's
        # filter/clock history
        self._pending_resets: set[int] = set()
        self.acc = np.zeros(block, np.complex64)
        self.fill = 0
        self._jnp = jnp

    def _build_step(self):
        """The batched fanout step; with SDRM_SERVER_MESH enabled and more
        than one accelerator visible, the step is shard_mapped over a
        ``channel`` mesh built from jax.devices() — lanes (clients) split
        across chips with NO collectives (each lane is an independent
        demod, the reference's thread-per-client made data-parallel).
        The shared (2, block) stream is replicated; state and outputs
        shard on their channel axis."""
        import jax

        mesh_env = os.environ.get("SDRM_SERVER_MESH", "0")
        devs = jax.devices()
        # each shard keeps a 128-lane multiple (the state's lane granule,
        # DemodPipeline.init_full_state): use the most devices that divide
        # LANES into 128s
        n_use = 1
        if mesh_env not in ("0", "", "off"):
            for n in range(len(devs), 1, -1):
                if self.LANES % n == 0 and (self.LANES // n) % 128 == 0:
                    n_use = n
                    break
        if n_use == 1:
            return self.pipe.make_batched_step_full(doppler=True, layout="fanout")
        import numpy as _np

        from jax.sharding import Mesh, PartitionSpec as P

        mesh = Mesh(_np.array(devs[:n_use]), axis_names=("channel",))
        raw = self.pipe.make_batched_step_full(
            doppler=True, layout="fanout", jit=False
        )
        # state leaves are channel-LAST (time-major); outputs channel-first
        state_spec = jax.tree.map(
            lambda a: P(*((None,) * (a.ndim - 1)), "channel"),
            self.pipe.init_full_state(self.LANES),
        )
        dop_spec = (P(None, "channel"),) * 4
        log.info(
            "rx group sharding %d lanes over %d devices (SDRM_SERVER_MESH)",
            self.LANES, n_use,
        )
        return jax.jit(
            jax.shard_map(
                raw,
                mesh=mesh,
                in_specs=(state_spec, P(), dop_spec),
                out_specs=(state_spec, P("channel"), P("channel")),
                check_vma=False,
            )
        )

    def has_space(self) -> bool:
        return len(self.lanes) < self.LANES

    def attach(self, session: RxSession) -> int:
        lane = next(i for i in range(self.LANES) if i not in self.lanes)
        self._pending_resets.add(lane)
        self.lanes[lane] = session
        session.group = self
        session.lane = lane
        return lane

    def detach(self, session: RxSession):
        if session.lane in self.lanes and self.lanes[session.lane] is session:
            del self.lanes[session.lane]
        session.group = None

    def _reset_lane(self, lane: int):
        """Fresh per-lane stream state (a new client starts from zero
        history, like a freshly created dsp_worker)."""
        import jax

        cp = self.state.quad_prev.shape[1] // 2

        def reset(leaf, init):
            if leaf is None:
                return None
            if leaf.ndim == 1:  # clock scalars, (Cp,)
                return leaf.at[lane].set(init[0])
            if leaf.shape[-1] == 2 * cp:  # I/Q lane pairs
                leaf = leaf.at[..., lane].set(init[..., 0])
                return leaf.at[..., cp + lane].set(init[..., 1])
            return leaf.at[..., lane].set(init[..., 0])

        self.state = jax.tree.map(
            reset, self.state, self._init_state_template,
            is_leaf=lambda x: x is None,
        )

    async def feed(self, buf: np.ndarray):
        """Accumulate a stream buffer; enqueue every filled block for the
        worker task.  Returns as soon as the data is copied (lossy mode) or
        queue space exists (blocking mode) — the reader never waits for the
        device step itself (reference src/queue.c:168-200)."""
        buf = np.asarray(buf, np.complex64)
        i = 0
        while i < len(buf):
            take = min(self.block - self.fill, len(buf) - i)
            self.acc[self.fill : self.fill + take] = buf[i : i + take]
            self.fill += take
            i += take
            if self.fill == self.block:
                self.fill = 0
                self._ensure_worker()
                await self.queue.put(self.acc.copy())

    def _ensure_worker(self):
        if self._worker_task is None or self._worker_task.done():
            self._worker_task = asyncio.create_task(
                self._worker(), name=f"rx-group-worker-{id(self):x}"
            )

    async def _worker(self):
        """Drain filled blocks through the device step until the poison
        pill (the dsp_worker thread analog, src/dsp_worker.c:44-106)."""
        try:
            while True:
                block = await self.queue.take()
                if block is None:
                    break
                await self._step_block(block)
                self.blocks_processed += 1
        except asyncio.CancelledError:
            pass
        except Exception:
            log.exception("rx group worker failed; finishing %d lanes", len(self.lanes))
            for s in list(self.lanes.values()):
                s.finish_fast()

    async def close(self):
        """Stop the worker (pending blocks are discarded, poison-pill
        semantics of queue.c:215-223)."""
        if self._worker_task is not None and not self._worker_task.done():
            await self.queue.interrupt()
            await self._worker_task

    async def _step_block(self, acc: np.ndarray):
        # apply lane resets queued by attach(); the single worker task
        # processes blocks serially, so no step can be mid-flight here
        for lane in self._pending_resets:
            self._reset_lane(lane)
        self._pending_resets.clear()
        sessions = {
            lane: s for lane, s in self.lanes.items() if not s.finished.is_set()
        }
        if not sessions:
            return
        # one shared (2, block) pair — the step broadcasts it to all lanes
        x = np.stack([acc.real, acc.imag]).astype(np.float32)
        # per-lane Doppler as device NCO tables: the host only runs the
        # 1 Hz SGP4 bookkeeping (cheap scalars), the mix itself happens
        # on-device inside the batched step — no serialized per-lane
        # host math (reference applies it in-stream, doppler.c:164-186)
        s_rows = self.dop_rows
        starts = np.zeros((s_rows, self.LANES), np.float32)
        ends = np.zeros((s_rows, self.LANES), np.float32)
        adjs = np.zeros((s_rows, self.LANES), np.float32)
        ph0s = np.zeros((s_rows, self.LANES), np.float32)
        for lane, s in sessions.items():
            s.note_progress(self.block)
            if s.doppler is not None:
                for k, (st, ln, adj, ph0) in enumerate(
                    s.doppler.device_segments(self.block, +1)
                ):
                    starts[k, lane] = st
                    ends[k, lane] = st + ln
                    adjs[k, lane] = adj
                    ph0s[k, lane] = ph0
        self.state, symbols, counts = await asyncio.to_thread(
            self._step_host, x, (starts, ends, adjs, ph0s)
        )
        # symbols: (C, n_chunks, K_c) with per-(lane, chunk) valid counts
        for lane, s in sessions.items():
            parts = [
                symbols[lane, t, : counts[lane, t]]
                for t in range(counts.shape[1])
                if counts[lane, t]
            ]
            if parts:
                await s.emit(np.concatenate(parts))

    def _step_host(self, x: np.ndarray, dop):
        state, symbols, counts = self._step(
            self.state, self._jnp.asarray(x), tuple(map(self._jnp.asarray, dop))
        )
        return state, np.asarray(symbols), np.asarray(counts)


class SdrStream:
    """One reader per distinct SDR stream, fanning out to sessions
    (sdr_worker analog)."""

    def __init__(self, stream_id: int, key: RxKey, device: SdrDevice):
        self.id = stream_id
        self.key = key
        self.device = device
        self.sessions: list[RxSession] = []
        self.groups: list[BatchedRxGroup] = []  # fast-mode lane batches
        self.task: asyncio.Task | None = None

    def start(self):
        self.task = asyncio.create_task(self._run(), name=f"sdr-stream-{self.id}")

    def add_session(self, session: RxSession):
        self.sessions.append(session)
        if session.mode == "fast":
            for g in self.groups:
                if g.fsk_config == session.fsk_config and g.has_space():
                    g.attach(session)
                    return
            # bound the number of compiled batched programs per stream:
            # a client whose config matches no group beyond the cap runs
            # standalone instead of spawning another mostly-empty step
            max_groups = int(os.environ.get("SDRM_MAX_GROUPS", "8"))
            if len(self.groups) >= max_groups:
                session.to_standalone()
                return
            group = BatchedRxGroup(
                session.fsk_config,
                session.config.buffer_size,
                blocking=self.device.lossless_rx,
                queue_capacity=session.config.queue_size,
            )
            group.attach(session)
            self.groups.append(group)

    async def _run(self):
        try:
            while True:
                buf = await self.device.read_stream()
                if buf is None:
                    break
                for session in list(self.sessions):
                    if session.mode == "fast":
                        if session.rx_dump is not None:
                            session.rx_dump.write(
                                np.asarray(buf, np.complex64).tobytes()
                            )
                    else:
                        await session.put(buf)
                for group in list(self.groups):
                    await group.feed(buf)
        except asyncio.CancelledError:
            pass
        except Exception:
            log.exception("[%d] sdr stream failed", self.id)
        finally:
            # stream ended: poison-pill every attached session (:49-53);
            # fast-mode lanes are notified too (finished + writers closed)
            # so nothing keeps emitting into a dead stream
            for group in list(self.groups):
                await group.close()
            for session in list(self.sessions):
                if session.mode == "fast":
                    session.finish_fast()
                else:
                    await session.queue.interrupt()

    async def remove_session(self, session: RxSession) -> bool:
        """Detach; returns True when the stream itself was torn down."""
        if session in self.sessions:
            self.sessions.remove(session)
        if session.group is not None:
            group = session.group
            group.detach(session)
            if not group.lanes and group in self.groups:
                self.groups.remove(group)
                await group.close()
        if not self.sessions:
            # stop the reader task before the graceful-shutdown drain so the
            # two never contend for the same stream reader
            if self.task:
                self.task.cancel()
                try:
                    await self.task
                except asyncio.CancelledError:
                    pass
            await self.device.stop_rx()
            await self.device.close()
            return True
        return False


class TxSession:
    """Per-client modulation state (tcp_worker TX-side analog)."""

    def __init__(
        self,
        client_id: int,
        req: wire.TxRequest,
        config: ServerConfig,
        device: SdrDevice | None,
    ):
        from sdrmodem.dsp.gfsk_mod import GfskModConfig
        from sdrmodem.dsp.nco_host import HostNco

        self.id = client_id
        self.req = req
        self.config = config
        self.device = device
        self.mod = StreamingGfskMod(
            GfskModConfig.from_radio(
                req.tx_sampling_freq, req.mod_baud_rate, req.fsk_settings.mod_fsk_deviation
            )
        )
        self.doppler: Doppler | None = None
        self.nco: HostNco | None = None
        if req.doppler is not None:
            start = req.file_settings.start_time_seconds if req.file_settings else 0
            self.doppler = doppler_from_settings(
                req.doppler, req.tx_sampling_freq, req.tx_center_freq, req.tx_offset, start
            )
        elif req.tx_offset != 0:
            self.nco = HostNco(req.tx_sampling_freq)
        self.tx_dump = (
            open(f"{config.base_path}/tx.mod2sdr.{client_id}.cf32", "wb")
            if req.tx_dump_file
            else None
        )

    async def handle_tx_data(self, data: bytes) -> int:
        """Modulate + shift + dump + transmit one TxData payload in
        buffer_size batches.  Returns a ResponseDetails error or 0."""
        for start in range(0, len(data), self.config.buffer_size):
            batch = data[start : start + self.config.buffer_size]
            iq = await asyncio.to_thread(self.mod.process, batch)
            if self.doppler is not None:
                iq = await asyncio.to_thread(self.doppler.process_tx, iq)
            elif self.nco is not None:
                iq = self.nco.mix(self.req.tx_offset, iq)
            if self.tx_dump is not None:
                self.tx_dump.write(np.asarray(iq, np.complex64).tobytes())
                # full disk ignored: keep transmitting (tcp_server.c:214-221)
            if self.device is not None:
                try:
                    await self.device.write_stream(iq)
                except Exception:
                    log.exception("[%d] unable to transmit request fully", self.id)
                    return wire.ResponseDetails.INTERNAL_ERROR
        return 0

    async def close(self):
        if self.tx_dump:
            self.tx_dump.close()
        if self.device is not None:
            await self.device.close()
