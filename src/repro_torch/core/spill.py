"""Durable serving state: the host-RAM KV spill tier and engine snapshots.

Without this module every recovery path of the serving plane destroys
state: a preempted stream frees its pages and pays a full re-prefill
(re-quantizing its K/V), a shared prefix dies with its last sharer, and an
engine rebuild drops every live stream. Two host-side containers make
those paths stateful, as in the JAX package:

  * ``HostSpillArena`` — a byte-budgeted LRU store of spilled int8 KV pages
    in host RAM. Two entry kinds share the budget:

      - *stream* entries (keyed ``("stream", rid)``): a preemption victim's
        pages, per-page scales, running slot scales, drift trackers, last
        token and the state of its slot's ``torch.Generator``, copied to
        the host at preemption. A resume copies them back into freshly
        allocated pages: no re-prefill, no re-quantization, the same tokens
        and the same sampling stream as a run that was never preempted.
      - *prefix* entries (keyed ``("prefix", chained digest)``): a
        registered prompt page whose last sharer released it (with its
        float sidecar, where it had one). A later join whose prompt chain
        reaches the digest restores the page instead of recomputing it and
        registers it again, so a shared system prompt survives an idle gap.

    Every entry carries a sha256 digest over its array bytes, checked at
    restore: a corrupted entry is dropped (``digest_failures``) and the
    engine recomputes, so the tier can never be more wrong than having no
    tier. Budget pressure evicts least-recently-used entries the same way.

  * ``EngineSnapshot`` — the full logical state of a paged ``DecodeEngine``
    between chunks: the used pages' contents with one sha256 digest per
    page, page tables, refcounts, the prefix registry, per-slot sampling,
    generator and deadline state, the pending queue, counters and the
    constructor configuration. ``DecodeEngine.restore`` rebuilds an engine
    from one, checking every page's digest first;
    ``checkpoint.ckpt.save_snapshot`` writes one to disk (npz + json).

Blobs are host numpy arrays. The float sidecars of prefix pages are bf16 in
the engine; they ride in a blob as their int16 bit patterns (numpy has no
bfloat16), so the digest covers the exact bits.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Any, Optional

import numpy as np


def _blob_bytes(blob) -> int:
    return sum(a.nbytes for d in blob for a in d.values())


def _blob_digest(blob) -> bytes:
    """sha256 over every array's bytes in deterministic (sub, key) order."""
    h = hashlib.sha256()
    for d in blob:
        for k in sorted(d):
            a = np.ascontiguousarray(d[k])
            h.update(k.encode())
            h.update(a.tobytes())
    return h.digest()


@dataclasses.dataclass
class SpillEntry:
    """One spilled unit: ``blob`` is a list (one dict per paged attention
    sublayer group) of named host arrays; ``meta`` carries the scalars a
    restore needs (page count, true length, last token, generator
    state)."""
    blob: list
    meta: dict
    digest: bytes
    nbytes: int

    def verify(self) -> bool:
        return _blob_digest(self.blob) == self.digest


class HostSpillArena:
    """Bounded LRU host-RAM arena for spilled KV state.

    ``put`` inserts (evicting least-recently-used entries until the budget
    holds; an entry larger than the whole budget is skipped, not stored),
    ``get`` returns an entry and marks it most recently used, ``pop``
    consumes one, ``peek`` looks without counting. Every entry is
    digest-stamped at insert; callers verify at restore and treat a
    mismatch as a miss. The arena stores named host arrays only, nothing
    device- or layout-specific, so it survives any engine teardown."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self._entries: "collections.OrderedDict[Any, SpillEntry]" = \
            collections.OrderedDict()
        self.bytes_in_use = 0
        self.spills = 0          # entries accepted
        self.skips = 0           # entries larger than the whole budget
        self.evictions = 0       # LRU evictions under budget pressure
        self.hits = 0            # get() found a live entry
        self.misses = 0          # get() found nothing (never stored/evicted)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def put(self, key, blob: list, meta: Optional[dict] = None) -> bool:
        """Insert (replacing any same-key entry); returns False when the
        entry alone exceeds the budget and was skipped."""
        nbytes = _blob_bytes(blob)
        if nbytes > self.budget_bytes:
            self.skips += 1
            self.pop(key)        # a stale smaller entry must not linger
            return False
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes_in_use -= old.nbytes
        while self._entries and self.bytes_in_use + nbytes > self.budget_bytes:
            _, ev = self._entries.popitem(last=False)
            self.bytes_in_use -= ev.nbytes
            self.evictions += 1
        self._entries[key] = SpillEntry(blob=blob, meta=dict(meta or {}),
                                        digest=_blob_digest(blob),
                                        nbytes=nbytes)
        self.bytes_in_use += nbytes
        self.spills += 1
        return True

    def peek(self, key) -> Optional[SpillEntry]:
        """Like ``get`` but counts nothing and leaves the LRU order alone:
        for sizing queries that are not themselves a restore."""
        return self._entries.get(key)

    def get(self, key) -> Optional[SpillEntry]:
        e = self._entries.get(key)
        if e is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return e

    def pop(self, key) -> Optional[SpillEntry]:
        e = self._entries.pop(key, None)
        if e is not None:
            self.bytes_in_use -= e.nbytes
        return e


# ---------------- engine snapshots ----------------

PAGE_KEYS = ("k", "v", "k_scale", "v_scale")
SLOT_KEYS = ("slot_k_scale", "slot_v_scale", "k_max", "v_max")


@dataclasses.dataclass
class EngineSnapshot:
    """Full logical state of a paged ``DecodeEngine`` between chunks.

    ``pages`` holds only the used (refcount > 0) pages' contents, stacked in
    ``used_pages`` order, one dict of host arrays per paged attention
    sublayer group; ``page_digests`` maps each used page id to the sha256
    over its content across groups, which ``DecodeEngine.restore``
    recomputes and compares before any stream can decode against the page.
    ``keys`` holds each slot's ``torch.Generator.get_state()`` bytes.
    Slots, pending entries and the rejected list are deep copies. ``spill``
    carries the host arena by reference (host RAM is what a device reset
    cannot touch) and is not written to disk. ``dense_state``: the
    fixed-size per-slot state (whisper's cross ``ck``/``cv``), one dict of
    float32 host arrays (or None) per pool sub, None on attention-only
    engines."""
    config: dict                       # DecodeEngine ctor kwargs to rebuild
    used_pages: np.ndarray             # (n_used,) arena page ids captured
    pages: list                        # per-sub {k,v,k_scale,v_scale} stacks
    page_digests: dict                 # page id -> sha256 bytes
    slot_state: list                   # per-sub {slot_k_scale,...,k_max,...}
    ptab: np.ndarray
    held: np.ndarray
    lens: np.ndarray
    page_refs: np.ndarray
    slot_adapters: np.ndarray
    tokens: np.ndarray                 # (num_slots,) last token per slot
    keys: np.ndarray                   # (num_slots, state bytes) uint8
    slots: list                        # deep-copied DecodeSlot | None
    pending: list                      # deep-copied _PendingJoin entries
    rejected: list                     # deep-copied terminal rejections
    registry: dict                     # chained digest -> page id
    page_key: dict                     # page id -> chained digest
    counters: dict                     # steps/admissions/... continue
    sched_tags: Optional[dict] = None  # BFQ virtual-time tags (loop-level)
    spill: Optional[HostSpillArena] = None
    dense_state: Optional[list] = None

    def page_digest(self, idx: int) -> bytes:
        """sha256 of captured page ``used_pages[idx]`` across sub groups."""
        h = hashlib.sha256()
        for sub in self.pages:
            for k in PAGE_KEYS:
                h.update(np.ascontiguousarray(sub[k][:, idx]).tobytes())
        return h.digest()

    # ---- disk round trip (checkpoint.ckpt.save_snapshot/load_snapshot) ----
    def to_host_payload(self):
        """(arrays, meta): flat named host arrays and a JSON-able meta dict.
        Only the spill arena is left out; everything a fresh process needs
        to rebuild the engine and its streams is here."""
        arrays = {
            "used_pages": np.asarray(self.used_pages, np.int32),
            "ptab": self.ptab, "held": self.held, "lens": self.lens,
            "page_refs": self.page_refs, "slot_adapters": self.slot_adapters,
            "tokens": self.tokens, "keys": self.keys,
        }
        for j, sub in enumerate(self.pages):
            for k, a in sub.items():
                arrays[f"page{j}/{k}"] = a
        for j, sub in enumerate(self.slot_state):
            for k, a in sub.items():
                arrays[f"slot{j}/{k}"] = a
        dense_keys = None
        if self.dense_state is not None:
            dense_keys = []
            for j, sub in enumerate(self.dense_state):
                dense_keys.append(sorted(sub) if sub else None)
                for k, a in (sub or {}).items():
                    arrays[f"dense{j}/{k}"] = a
        meta = {
            "config": _jsonable(self.config),
            "n_subs": len(self.pages),
            "page_digests": {str(p): d.hex()
                             for p, d in self.page_digests.items()},
            "registry": {k.hex(): int(p) for k, p in self.registry.items()},
            "page_key": {str(p): k.hex() for p, k in self.page_key.items()},
            "slots": [_slot_to_json(s) for s in self.slots],
            "pending": [_pending_to_json(p) for p in self.pending],
            "rejected": [_pending_to_json(p) for p in self.rejected],
            "counters": _jsonable(self.counters),
            "sched_tags": _jsonable(self.sched_tags),
            "dense_keys": dense_keys,
        }
        return arrays, meta

    @classmethod
    def from_host_payload(cls, arrays, meta) -> "EngineSnapshot":
        n = int(meta["n_subs"])
        pages = [{k: np.asarray(arrays[f"page{j}/{k}"]) for k in PAGE_KEYS}
                 for j in range(n)]
        slot_state = [{k: np.asarray(arrays[f"slot{j}/{k}"])
                       for k in SLOT_KEYS} for j in range(n)]
        config = dict(meta["config"])
        if config.get("prompt_buckets") is not None:
            config["prompt_buckets"] = tuple(config["prompt_buckets"])
        return cls(
            config=config,
            used_pages=np.asarray(arrays["used_pages"], np.int32),
            pages=pages,
            page_digests={int(p): bytes.fromhex(d)
                          for p, d in meta["page_digests"].items()},
            slot_state=slot_state,
            ptab=np.asarray(arrays["ptab"]),
            held=np.asarray(arrays["held"]),
            lens=np.asarray(arrays["lens"]),
            page_refs=np.asarray(arrays["page_refs"]),
            slot_adapters=np.asarray(arrays["slot_adapters"]),
            tokens=np.asarray(arrays["tokens"]),
            keys=np.asarray(arrays["keys"]),
            slots=[_slot_from_json(s) for s in meta["slots"]],
            pending=[_pending_from_json(p) for p in meta["pending"]],
            rejected=[_pending_from_json(p) for p in meta["rejected"]],
            registry={bytes.fromhex(k): int(p)
                      for k, p in meta["registry"].items()},
            page_key={int(p): bytes.fromhex(k)
                      for p, k in meta["page_key"].items()},
            counters=dict(meta["counters"]),
            sched_tags=meta.get("sched_tags"),
            dense_state=None if meta.get("dense_keys") is None else [
                None if keys is None else
                {k: np.asarray(arrays[f"dense{j}/{k}"]) for k in keys}
                for j, keys in enumerate(meta["dense_keys"])],
        )


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    return x


def _slot_to_json(s) -> Optional[dict]:
    if s is None:
        return None
    return {
        "rid": int(s.rid), "task_id": s.task_id,
        "adapter_slot": int(s.adapter_slot), "max_new": int(s.max_new),
        "eos_id": None if s.eos_id is None else int(s.eos_id),
        "tokens": [int(t) for t in s.tokens],
        "t_join": float(s.t_join), "t_first": float(s.t_first),
        "prompt_tokens": int(s.prompt_tokens), "done": bool(s.done),
        "prompt": None if s.prompt is None
        else [int(t) for t in np.asarray(s.prompt).reshape(-1)],
        "adapter_id": s.adapter_id, "deadline": float(s.deadline),
        "status": s.status,
        "enc_feats": None if s.enc_feats is None
        else np.asarray(s.enc_feats, np.float32).tolist(),
    }


def _slot_from_json(d):
    if d is None:
        return None
    from repro_torch.core.decode_engine import DecodeSlot
    return DecodeSlot(
        rid=d["rid"], task_id=d["task_id"], adapter_slot=d["adapter_slot"],
        max_new=d["max_new"], eos_id=d["eos_id"], tokens=list(d["tokens"]),
        t_join=d["t_join"], t_first=d["t_first"],
        prompt_tokens=d["prompt_tokens"], done=d["done"],
        prompt=None if d["prompt"] is None
        else np.asarray(d["prompt"], np.int32),
        adapter_id=d["adapter_id"], deadline=d["deadline"],
        status=d["status"],
        enc_feats=None if d.get("enc_feats") is None
        else np.asarray(d["enc_feats"], np.float32))


def _pending_to_json(p) -> dict:
    return {
        "task_id": p.task_id,
        "prompt": [int(t) for t in np.asarray(p.prompt).reshape(-1)],
        "adapter_id": p.adapter_id, "max_new_tokens": int(p.max_new_tokens),
        "rid": int(p.rid),
        "eos_id": None if p.eos_id is None else int(p.eos_id),
        "resume": _slot_to_json(p.resume), "deadline": float(p.deadline),
        "status": p.status,
        "enc_feats": None if p.enc_feats is None
        else np.asarray(p.enc_feats, np.float32).tolist(),
    }


def _pending_from_json(d):
    from repro_torch.core.decode_engine import _PendingJoin
    return _PendingJoin(
        task_id=d["task_id"], prompt=np.asarray(d["prompt"], np.int32),
        adapter_id=d["adapter_id"], max_new_tokens=d["max_new_tokens"],
        rid=d["rid"], eos_id=d["eos_id"], resume=_slot_from_json(d["resume"]),
        deadline=d["deadline"], status=d["status"],
        enc_feats=None if d.get("enc_feats") is None
        else np.asarray(d["enc_feats"], np.float32))
