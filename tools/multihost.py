#!/usr/bin/env python3
"""Multi-process execution harness (SURVEY §2.5): run the pipelined
time-sharded demod across two OS processes joined with
``jax.distributed``, and prove the cross-process output equals the
single-process output.

The reference fans multiple hosts' IQ in over TCP (src/sdr/
sdr_server_client.c, src/tcp_server.c); this build's analog is a
multi-process JAX mesh.  The harness is a CPU-only tool — exactly like
the test suite fakes hardware with mocks (SURVEY §4) — that runs the REAL
jax.distributed machinery on the CPU backend: 2 processes x 4 virtual
devices = one 8-device mesh spanning two processes, with the same
shard_map program, ppermute halo/state hops crossing the process
boundary, and jax.make_array_from_callback/process_allgather at the
host edges (parallel/time_shard._put/_fetch).

Usage:
  python3 tools/multihost.py                 # orchestrate + compare + write MULTIHOST.json
  python3 tools/multihost.py --rank R --port P --procs N   # (internal) worker
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
DEV_PER_PROC = 4


def _streams(n_streams: int, n: int):
    import numpy as np

    iq = np.fromfile(
        REPO / "tests" / "fixtures" / "lucky7.expected.cf32", dtype=np.complex64
    )
    rng = np.random.default_rng(42)
    return np.stack(
        [
            iq[s * 777 : s * 777 + n]
            + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            for s in range(n_streams)
        ]
    ).astype(np.complex64)


def _run_pipeline(tag: str):
    import numpy as np

    import jax
    from jax.sharding import Mesh

    from sdrmodem.dsp.fsk_demod import FskDemodConfig
    from sdrmodem.parallel.time_shard import demod_pipelined

    cfg = FskDemodConfig(48000, 4800, 5000, 2, 2000, True)
    devices = jax.devices()
    n_dev = len(devices)
    mesh = Mesh(np.array(devices), axis_names=("time",))
    n_streams, n = 2 * n_dev, n_dev * 4096  # k = 2 lane packing
    streams = _streams(n_streams, n)
    t0 = time.time()
    outs = demod_pipelined(streams, cfg, mesh, clock_backend="scan")
    dt = time.time() - t0
    print(
        f"[{tag}] procs={jax.process_count()} devices={n_dev} "
        f"streams={n_streams} block={n // n_dev} seconds={dt:.1f}",
        flush=True,
    )
    return outs, dict(
        processes=jax.process_count(),
        devices=n_dev,
        streams=n_streams,
        samples_per_stream=n,
        seconds=round(dt, 2),
    )


def worker(rank: int, port: int, procs: int, outdir: str):
    import jax

    jax.config.update("jax_platforms", "cpu")  # a CPU-only tool
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=procs,
        process_id=rank,
    )
    import numpy as np

    assert jax.process_count() == procs
    assert len(jax.devices()) == procs * DEV_PER_PROC
    outs, meta = _run_pipeline(f"rank{rank}")
    if rank == 0:
        np.savez(
            pathlib.Path(outdir) / "multihost_out.npz",
            **{f"s{i}": o for i, o in enumerate(outs)},
            meta=json.dumps(meta),
        )
    jax.distributed.shutdown()


def orchestrate():
    import socket

    import numpy as np

    with socket.socket() as s:  # free coordinator port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    outdir = "/tmp/sdrm_multihost"
    pathlib.Path(outdir).mkdir(exist_ok=True)
    env_base = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={DEV_PER_PROC}",
        "PYTHONPATH": f"{REPO}:{os.environ.get('PYTHONPATH', '')}",
    }
    procs = []
    for rank in range(2):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    __file__,
                    "--rank",
                    str(rank),
                    "--port",
                    str(port),
                    "--procs",
                    "2",
                    "--outdir",
                    outdir,
                ],
                env=env_base,
            )
        )
    codes = [p.wait(timeout=1200) for p in procs]
    assert codes == [0, 0], f"worker exit codes {codes}"

    cross = np.load(pathlib.Path(outdir) / "multihost_out.npz")
    meta = json.loads(str(cross["meta"]))

    # single-process reference on an identical 8-device (1-process) mesh
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={2 * DEV_PER_PROC}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    ref_outs, ref_meta = _run_pipeline("single")

    n_streams = meta["streams"]
    max_lsb, mismatched = 0, 0
    for i in range(n_streams):
        a, b = cross[f"s{i}"], np.asarray(ref_outs[i])
        assert len(a) == len(b), f"stream {i}: {len(a)} vs {len(b)} symbols"
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        max_lsb = max(max_lsb, int(d.max()))
        mismatched += int((d != 0).sum())
    total = sum(len(cross[f"s{i}"]) for i in range(n_streams))
    report = {
        "ok": max_lsb <= 2,
        "mechanism": "jax.distributed, 2 processes x 4 cpu devices, one "
        "8-device mesh; shard_map ppermute halo/clock-state hops cross "
        "the process boundary",
        "cross_process": meta,
        "single_process": ref_meta,
        "symbols_compared": total,
        "max_lsb_diff_vs_single_process": max_lsb,
        "mismatched_symbols": mismatched,
    }
    text = json.dumps(report, indent=2)
    print(text)
    (REPO / "MULTIHOST.json").write_text(text + "\n")
    assert report["ok"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--outdir", default="/tmp/sdrm_multihost")
    args = ap.parse_args()
    if args.rank is None:
        orchestrate()
    else:
        worker(args.rank, args.port, args.procs, args.outdir)


if __name__ == "__main__":
    main()
