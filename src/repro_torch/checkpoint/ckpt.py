"""Engine snapshots on disk: ``<path>.npz`` (every array, no pickles) plus
``<path>.meta.json`` (tables, registry, slots, pending queue, counters),
published atomically. The training-state half of the JAX package's module
(``save``, ``restore``, ``latest_step``) comes with the training slice."""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from repro_torch.core.spill import EngineSnapshot


def save_snapshot(path: str | Path, snap: EngineSnapshot) -> Path:
    """Write an ``EngineSnapshot`` to ``<path>.npz`` + ``<path>.meta.json``;
    the npz is written under a temporary name and renamed into place. The
    host spill arena is not written: it is a RAM cache whose misses fall
    back to recompute, so a restore in another process starts with an
    empty one and loses only warm-up time."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays, meta = snap.to_host_payload()
    tmp = path.parent / f".tmp-{path.name}.npz"
    np.savez(tmp, **arrays)
    path.with_suffix(path.suffix + ".meta.json").write_text(json.dumps(meta))
    out = path.with_suffix(path.suffix + ".npz")
    os.replace(tmp, out)
    return out


def load_snapshot(path: str | Path) -> EngineSnapshot:
    """An ``EngineSnapshot`` written by ``save_snapshot``. The digests are
    checked in ``DecodeEngine.restore``, not here: a snapshot corrupted on
    disk restores with its bad pages dropped and their streams re-queued,
    never with poisoned KV."""
    path = Path(path)
    with np.load(path.with_suffix(path.suffix + ".npz")) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(
        path.with_suffix(path.suffix + ".meta.json").read_text())
    return EngineSnapshot.from_host_payload(arrays, meta)
