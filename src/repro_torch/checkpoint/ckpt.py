"""Checkpoints on disk, in the JAX package's formats.

Trees (``save``, ``latest_step``, ``restore``): one ``checkpoint-<step>.npz``
per step holding every leaf under its ``/``-joined path (dict keys, list
indices; bf16 stored as f32, which is lossless) plus
``checkpoint-<step>.meta.json``, published atomically; a checkpoint written
by either package restores in the other. The JAX package's ``shardings``
argument of ``restore`` (a cross-mesh restore) waits for the mesh code: here
each leaf lands on its ``tree_like`` leaf's device.

Engine snapshots (``save_snapshot``, ``load_snapshot``): ``<path>.npz``
(every array, no pickles) plus ``<path>.meta.json`` (tables, registry,
slots, pending queue, counters), published atomically."""
from __future__ import annotations

import json
import os
import re
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.core.spill import EngineSnapshot
from repro_torch.models.common import tree_paths


def _to_host(t) -> np.ndarray:
    """A leaf as a numpy array; bf16 (no portable npy type) as f32."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def save(ckpt_dir: str | Path, step: int, tree, *, blocking: bool = True
         ) -> Optional[threading.Thread]:
    """Write checkpoint-<step>.npz (+ .meta.json). The leaves come to the
    host here; with ``blocking=False`` the disk write runs on a thread,
    which is returned (join it before reading the checkpoint)."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    host = {k: _to_host(v) for k, v in tree_paths(tree)}
    meta = {"step": step, "time": time.time(), "keys": sorted(host),
            "nbytes": int(sum(a.nbytes for a in host.values()))}

    def _write():
        tmp = ckpt_dir / f".tmp-{step}.npz"
        np.savez(tmp, **host)
        (ckpt_dir / f"checkpoint-{step}.meta.json").write_text(
            json.dumps(meta))
        os.replace(tmp, ckpt_dir / f"checkpoint-{step}.npz")

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """The largest step with a published checkpoint, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(m.group(1)) for f in ckpt_dir.iterdir()
             if (m := re.match(r"checkpoint-(\d+)\.npz$", f.name))]
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, tree_like, *, step: Optional[int] = None):
    """(tree, step): the checkpoint at ``step`` (default the latest) in the
    structure of ``tree_like``, each leaf a tensor on its ``tree_like``
    leaf's device and in its dtype. Raises ``FileNotFoundError`` without a
    checkpoint and ``KeyError`` where one lacks a leaf of ``tree_like``."""
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    with np.load(ckpt_dir / f"checkpoint-{step}.npz") as data:
        flat = dict(tree_paths(tree_like))
        missing = [k for k in flat if k not in data.files]
        if missing:
            raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
        arrays = {k: data[k] for k in flat}

    def build(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, prefix + (str(i),))
                              for i, v in enumerate(tree))
        if tree is None:
            return None
        return torch.from_numpy(arrays["/".join(prefix)]).to(
            device=tree.device, dtype=tree.dtype)
    return build(tree_like), step


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
