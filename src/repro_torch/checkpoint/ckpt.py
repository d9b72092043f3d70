"""Checkpoints on disk, in the JAX package's formats.

Trees (``save``, ``latest_step``, ``restore``): one ``checkpoint-<step>.npz``
per step holding every leaf under its ``/``-joined path (dict keys, list
indices; bf16 stored as f32, which is lossless) plus
``checkpoint-<step>.meta.json``, published atomically; a checkpoint written
by either package restores in the other, with or without a mesh. A DTensor
leaf is saved whole (gathered on every rank, written by rank 0 only).
``restore(..., shardings=...)`` is the cross-mesh restore: each rank reads
only its own slice of each leaf, straight from the npz member, and builds a
DTensor on the CURRENT mesh, whatever the mesh that saved it.

Engine snapshots (``save_snapshot``, ``load_snapshot``): ``<path>.npz``
(every array, no pickles) plus ``<path>.meta.json`` (tables, registry,
slots, pending queue, counters), published atomically."""
from __future__ import annotations

import json
import math
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


def _writer() -> bool:
    """False on every rank but 0 of a running process group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(t) -> np.ndarray:
    """A leaf as a numpy array; bf16 (no portable npy type) as f32; a
    DTensor whole (a collective: every rank calls it)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def save(ckpt_dir: str | Path, step: int, tree, *, blocking: bool = True
         ) -> Optional[threading.Thread]:
    """Write checkpoint-<step>.npz (+ .meta.json). The leaves come to the
    host here; with ``blocking=False`` the disk write runs on a thread,
    which is returned (join it before reading the checkpoint). In a
    process group every rank calls it and rank 0 alone writes (the others
    return None)."""
    ckpt_dir = Path(ckpt_dir)
    host = {k: _to_host(v) for k, v in tree_paths(tree)}
    if not _writer():
        return None
    ckpt_dir.mkdir(parents=True, exist_ok=True)
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


def _member(path: Path, key: str) -> np.ndarray:
    """The array ``key`` of an npz, memory-mapped where ``np.savez`` stored
    it (uncompressed), so that slicing it reads only the slice's pages."""
    import zipfile
    with zipfile.ZipFile(path) as z:
        info = z.getinfo(key + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            with z.open(info) as f:
                return np.lib.format.read_array(f)
        with z.open(info) as f:
            version = np.lib.format.read_magic(f)
            if version not in ((1, 0), (2, 0)):
                return np.lib.format.read_array(z.open(info))
            shape, fortran, dtype = (
                np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)(f)
            header = f.tell()
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)
        name_len = int.from_bytes(local[26:28], "little")
        extra_len = int.from_bytes(local[28:30], "little")
    offset = info.header_offset + 30 + name_len + extra_len + header
    if math.prod(shape) == 0:
        return np.zeros(shape, dtype)
    return np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=shape,
                     order="F" if fortran else "C")


def restore(ckpt_dir: str | Path, tree_like, *, step: Optional[int] = None,
            shardings=None):
    """(tree, step): the checkpoint at ``step`` (default the latest) in the
    structure of ``tree_like``, each leaf in its ``tree_like`` leaf's dtype,
    on its device. ``shardings``: a matching tree of ``(mesh, placements)``
    on the CURRENT mesh (``Trainer.state_shardings``; None where a leaf
    stays a plain tensor): such a leaf becomes a DTensor of which this rank
    reads only its local slice (``sharding.rules.local_slices``). Raises
    ``FileNotFoundError`` without a checkpoint and ``KeyError`` where one
    lacks a leaf of ``tree_like``."""
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = ckpt_dir / f"checkpoint-{step}.npz"
    with np.load(path) as data:
        flat = dict(tree_paths(tree_like))
        missing = [k for k in flat if k not in data.files]
        if missing:
            raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
    sh = {} if shardings is None else _sharding_paths(tree_like, shardings)

    def leaf(key, like):
        arr = _member(path, key)
        if sh.get(key) is None:
            return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                      dtype=like.dtype)
        from repro_torch.sharding.rules import from_local, local_slices
        mesh, placements = sh[key]
        local = np.array(arr[local_slices(arr.shape, mesh, placements)])
        dev = like.device if like.device.type != "meta" else \
            mesh.device_type
        t = torch.from_numpy(local).to(device=dev, dtype=like.dtype)
        return from_local(t, mesh, placements, arr.shape)

    def build(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
        if hasattr(tree, "_fields"):         # a NamedTuple (AdamWState)
            return type(tree)(*(build(v, prefix + (f".{k}",))
                                for k, v in zip(tree._fields, tree)))
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, prefix + (str(i),))
                              for i, v in enumerate(tree))
        if tree is None:
            return None
        return leaf("/".join(prefix), tree)
    return build(tree_like), step


def _sharding_paths(tree_like, shardings) -> dict:
    """{leaf path: (mesh, placements) or None} of a shardings tree that
    matches ``tree_like`` (its NamedTuples may hold None for a leaf, as
    the JAX trainer's ``AdamWState(None, ...)``)."""
    out = {}

    def walk(tree, sh, prefix):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], None if sh is None else sh[k],
                     prefix + (str(k),))
        elif hasattr(tree, "_fields"):
            for i, (k, v) in enumerate(zip(tree._fields, tree)):
                walk(v, None if sh is None else sh[i], prefix + (f".{k}",))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, None if sh is None else sh[i], prefix + (str(i),))
        elif tree is not None:
            out["/".join(prefix)] = sh
    walk(tree_like, shardings, ())
    return out


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
