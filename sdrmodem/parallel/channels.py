"""Channel-parallel batched demodulation over a device mesh.

The reference runs one dsp_worker thread per RX client
(src/dsp_worker.c:44-106); here channels are a leading batch axis of the
ragged-block pipeline, vmapped on-chip and sharded across a
``jax.sharding.Mesh`` axis with ``shard_map``.

Every per-channel state leaf is sharded along the same axis, so the step
needs NO collectives at all: channel parallelism is embarrassingly
parallel, exactly like the reference's independent threads.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sdrmodem.dsp.fsk_demod import FskDemodConfig
from sdrmodem.dsp.pipeline import DemodPipeline


class ShardedChannelDemod:
    """N-channel demodulator sharded over a mesh axis."""

    def __init__(
        self,
        config: FskDemodConfig,
        block_size: int,
        channels: int,
        mesh: Mesh,
        axis: str = "channel",
        *,
        exact: bool = False,
    ):
        if channels % mesh.shape[axis] != 0:
            raise ValueError("channels must divide evenly over the mesh axis")
        self.pipe = DemodPipeline(config, block_size, exact=exact)
        self.channels = channels
        self.mesh = mesh
        self.axis = axis
        self.block = block_size

        batched = jax.vmap(self.pipe._step_impl)
        state_spec = jax.tree.map(lambda _: P(axis), self._state_structure())
        self._step = jax.jit(
            jax.shard_map(
                batched,
                mesh=mesh,
                in_specs=(state_spec, P(axis, None, None), P(axis)),
                out_specs=(state_spec, P(axis, None), P(axis)),
                check_vma=False,
            )
        )

    def _state_structure(self):
        return self.pipe.init_state()

    def init_state(self):
        state = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (self.channels,) + a.shape),
            self.pipe.init_state(),
        )
        sharding = jax.tree.map(
            lambda _: NamedSharding(self.mesh, P(self.axis)), state
        )
        return jax.tree.map(jax.device_put, state, sharding)

    def place_input(self, iq: np.ndarray) -> jnp.ndarray:
        """(C, N) complex64 -> sharded (C, 2, N) float32 pairs."""
        x = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)
        return jax.device_put(
            jnp.asarray(x), NamedSharding(self.mesh, P(self.axis, None, None))
        )

    def step(self, state, x_pairs, n_valid=None):
        """One block step for all channels.  x_pairs: (C, 2, B)."""
        if n_valid is None:
            n_valid = jnp.full((self.channels,), self.block, jnp.int32)
        return self._step(state, x_pairs, n_valid)


class ShardedChannelDemodFull:
    """Full-block fast path sharded over a mesh ``channel`` axis.

    Each shard runs the batched time-major step (banded-matmul FIRs +
    the selected clock) on its local slice of channels.  Channel
    parallelism needs NO collectives (the reference's independent
    per-client dsp_worker threads), so scaling is linear by construction;
    state leaves are channel-last and shard along their last axis.
    """

    def __init__(
        self,
        config: FskDemodConfig,
        block_size: int,
        channels: int,
        mesh: Mesh,
        axis: str = "channel",
        *,
        clock_backend: str | None = None,
        use_atan_lut="free",  # the server's fast-mode default (session.py)
    ):
        n_shards = mesh.shape[axis]
        if channels % n_shards != 0:
            raise ValueError("channels must divide evenly over the mesh axis")
        self.local = channels // n_shards
        if self.local % 128 != 0 and channels > 128:
            raise ValueError("per-shard channel count should be a multiple of 128")
        self.pipe = DemodPipeline(
            config, block_size, exact=False, use_atan_lut=use_atan_lut
        )
        self.channels = channels
        self.mesh = mesh
        self.axis = axis
        self.block = block_size

        local_step = self.pipe.make_batched_step_full(clock_backend)
        # channel-last state leaves shard on their LAST axis; the (C, 2, B)
        # input and (C, K) outputs on their first
        state_spec = jax.tree.map(
            lambda a: P(*((None,) * (a.ndim - 1)), axis),
            self.pipe.init_full_state(self.local),
        )
        self._step = jax.jit(
            jax.shard_map(
                local_step,
                mesh=mesh,
                in_specs=(state_spec, P(axis, None, None)),
                out_specs=(state_spec, P(axis, None, None), P(axis, None)),
                check_vma=False,
            )
        )

    def init_state(self):
        state = self.pipe.init_full_state(self.local)
        # replicate the per-shard state across shards by tiling the channel
        # (last) axis to the GLOBAL channel count, then shard it
        def expand(a):
            reps = self.channels // self.local
            tiled = jnp.tile(a, (1,) * (a.ndim - 1) + (reps,))
            return jax.device_put(
                tiled,
                NamedSharding(
                    self.mesh, P(*((None,) * (a.ndim - 1)), self.axis)
                ),
            )

        return jax.tree.map(expand, state)

    def place_input(self, iq: np.ndarray) -> jnp.ndarray:
        """(C, N) complex64 -> sharded (C, 2, N) float32 pairs."""
        x = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)
        return jax.device_put(
            jnp.asarray(x), NamedSharding(self.mesh, P(self.axis, None, None))
        )

    def step(self, state, x_pairs):
        """One full-block step for all channels.  x_pairs: (C, 2, B)."""
        return self._step(state, x_pairs)
