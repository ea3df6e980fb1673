"""Stream-state checkpoint / resume.

The reference has no checkpointing; its nearest analogs are dump files for
offline replay and file_settings.start_time_seconds for Doppler-correct
replay (SURVEY.md §5).  This build makes streams properly resumable: a
demodulator's entire carried state (FIR histories, quadrature-demod
sample, M&M {omega, mu, last, tail}) is a pytree of arrays, so a snapshot
is one npz file.  Restoring it and continuing produces the identical
symbol stream the uninterrupted run would have produced.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

import jax


def save_state(state, path: str | pathlib.Path, meta: dict | None = None) -> None:
    """Snapshot any pytree-of-arrays state (e.g. DemodState) to ``path``."""
    leaves, treedef = jax.tree.flatten(state)
    arrays = {f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    )
    np.savez(path, **arrays)


def load_state(template, path: str | pathlib.Path):
    """Restore a snapshot into the structure of ``template`` (same pipeline
    configuration).  Returns (state, meta)."""
    data = np.load(path)
    leaves, treedef = jax.tree.flatten(template)
    n = len(leaves)
    restored = []
    for i in range(n):
        arr = data[f"leaf_{i}"]
        want = np.asarray(leaves[i])
        if arr.shape != want.shape or arr.dtype != want.dtype:
            raise ValueError(
                f"snapshot leaf {i} mismatch: {arr.shape}/{arr.dtype} vs "
                f"{want.shape}/{want.dtype} — different pipeline configuration?"
            )
        restored.append(arr)
    meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data else {}
    return jax.tree.unflatten(treedef, restored), meta
