"""Chaos-injection harness for the serving plane.

Deterministic fault injection against a live ``ServeLoop``: each
``ChaosEvent`` arms a fault at a fixed offset into ``ServeLoop.run``
(driven from the loop's ``on_tick`` hook, so injection lands between
scheduling decisions, never inside an executable) and optionally restores
it after a fixed duration. The schedule is a pure function of the trace
clock, so clean streams can be held token for token against a fault-free
run.

Faults and the isolation layer each one exercises:

  * ``NaNAdapterFault`` — poisons one task's LoRA adapter with NaNs in the
    FM's ``AdapterStore``: the tree is swapped and ``stacked()`` rewrites
    that slot of the stack in place (captured executables read the stack
    where it lies, so it must not be dropped). The engine's finite-logits
    flag quarantines only that task's streams.
  * ``RaisingHeadFault`` — swaps one task's head for one that raises
    ``InjectedFailure``; the executor fails only that task's rows
    (``head_failed``) after bounded retries; restore puts the head back.
  * ``PagePressureFault`` — steals a fraction of the paged arena's free
    pages (deferrals and preemptions through the memory gate); restore
    returns them. Only the free list shrinks, so viability holds.
  * ``StallFault`` — replaces ``step_chunk`` with a no-op: work stays
    queued with no progress, the signature the loop's watchdog fires on.
  * ``DeviceResetFault`` — kills the device arena mid-trace: snapshots the
    loop's state, SCRAMBLES the old engine's arena in place (int8 codes to
    77 / -77, page and slot scales and the device page table to zero, the
    cross state to a constant), then restores. The restored engine adopts
    exactly those storages (its captured executables bake them) and
    rewrites every element from the snapshot, so any read of dead state
    would show in the tokens. Every restored page is sha256-checked.
  * ``SpillCorruptionFault`` — flips bits in host spill entries; the
    engine's digest check turns each into a counted miss and a recompute.

``ChaosInjector`` is the scheduler: pass ``inj.on_tick`` to
``ServeLoop.run(on_tick=...)``, and call ``restore_all`` after the run so a
poisoned store cannot leak into a later run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cache_manager import dense_state_keys
from repro_torch.distributed.fault import InjectedFailure
from repro_torch.models.common import tree_map


class Fault:
    """One injectable fault: ``inject`` arms it against the loop's serving
    state, ``restore`` undoes it completely."""

    name = "fault"

    def inject(self, loop):       # pragma: no cover - interface
        raise NotImplementedError

    def restore(self, loop):
        pass


class NaNAdapterFault(Fault):
    def __init__(self, adapter_id: str):
        self.adapter_id = adapter_id
        self.name = f"nan_adapter:{adapter_id}"
        self._orig = None

    def inject(self, loop):
        store = loop.srv.fms[loop.fm_id].adapters
        if self.adapter_id not in store.ids:
            return
        i = store.ids.index(self.adapter_id)
        self._orig = store._trees[i]
        # a new tree object: stacked() sees the slot changed and rewrites
        # it in place (same shapes and storage: no new shape key)
        store._trees[i] = tree_map(
            lambda t: torch.full_like(t, float("nan")), self._orig)

    def restore(self, loop):
        if self._orig is None:
            return
        store = loop.srv.fms[loop.fm_id].adapters
        if self.adapter_id in store.ids:
            store._trees[store.ids.index(self.adapter_id)] = self._orig
        self._orig = None


class RaisingHeadFault(Fault):
    def __init__(self, task_id: str):
        self.task_id = task_id
        self.name = f"raising_head:{task_id}"
        self._orig = None

    def inject(self, loop):
        fm = loop.srv.fms[loop.fm_id]
        if self.task_id not in fm.heads:
            return
        self._orig = fm.heads[self.task_id]
        tid = self.task_id

        def raising_head(x):
            raise InjectedFailure(f"injected head crash for task {tid}")

        fm.heads[tid] = raising_head

    def restore(self, loop):
        if self._orig is None:
            return
        fm = loop.srv.fms[loop.fm_id]
        if self.task_id in fm.heads:
            fm.heads[self.task_id] = self._orig
        self._orig = None


class PagePressureFault(Fault):
    def __init__(self, frac: float = 0.5):
        self.frac = float(frac)
        self.name = f"page_pressure:{frac}"
        self._stolen: list[int] = []

    def inject(self, loop):
        eng = loop._engine()
        if eng is None or not eng.paged:
            return
        n = int(len(eng._free_pages) * self.frac)
        self._stolen = [eng._free_pages.pop() for _ in range(n)]

    def restore(self, loop):
        if not self._stolen:
            return
        eng = loop._engine()
        if eng is not None:
            eng._free_pages.extend(self._stolen)
        self._stolen = []


class StallFault(Fault):
    name = "stall"

    def __init__(self):
        self._orig = None

    def inject(self, loop):
        eng = loop._engine()
        if eng is None or self._orig is not None:
            return
        self._orig = eng.step_chunk
        eng.step_chunk = lambda: []     # work queued, zero progress

    def restore(self, loop):
        if self._orig is None:
            return
        eng = loop._engine()
        if eng is not None:
            eng.step_chunk = self._orig
        self._orig = None


def scramble_arena(eng):
    """What a device reset leaves behind, written IN PLACE into ``eng``'s
    tensors: int8 codes 77 / -77, page and slot scales zero, the device
    page table zero, the cross state a constant."""
    for sub in eng.pool:
        if "page_table" not in sub:
            continue
        sub["k"].fill_(77)
        sub["v"].fill_(-77)
        for k in ("k_scale", "v_scale", "slot_k_scale", "slot_v_scale"):
            sub[k].zero_()
        for k in dense_state_keys(sub):
            sub[k].fill_(7.0)
    eng._ptab_store.zero_()


class DeviceResetFault(Fault):
    """Simulated accelerator reset, the durability plane's headline fault.

    Inject = quiesce and snapshot the loop's serving state, scramble the
    OLD engine's arena in place (``scramble_arena``), drop the engine from
    the server and restore from the snapshot, reusing its executables. The
    restored engine adopts the scrambled storages and rewrites them, every
    page checked against its digest. No request is lost: live slots,
    pending and preempted entries and the scheduler's tags all ride the
    snapshot."""

    name = "device_reset"

    def __init__(self):
        self.resets = 0

    def inject(self, loop):
        eng = loop._engine()
        if eng is None or not eng.paged:
            return
        state = loop.snapshot_state()
        old = loop.srv.engines.pop(loop.fm_id)
        scramble_arena(old)
        loop.restore_state(state, reuse_jits_from=old)
        loop.stamp_reset()
        self.resets += 1


class SpillCorruptionFault(Fault):
    """Flip bits in a fraction of the host spill arena's entries (stream and
    prefix alike), in insertion order. The engine's digest check turns each
    corrupted entry into a counted miss and a recompute, never into wrong
    tokens."""

    def __init__(self, frac: float = 1.0):
        self.frac = float(frac)
        self.name = f"spill_corruption:{frac}"
        self.corrupted = 0

    def inject(self, loop):
        eng = loop._engine()
        spill = getattr(eng, "spill", None) if eng is not None else None
        if spill is None or not len(spill):
            return
        keys = list(spill._entries)
        for key in keys[:max(1, int(len(keys) * self.frac))]:
            d = spill._entries[key].blob[0]
            name = next(iter(d))
            # blob arrays can be non-contiguous slices, where an in-place
            # XOR through a reshape would hit a copy: corrupt a contiguous
            # copy and swap it in
            a = np.ascontiguousarray(d[name])
            a.view(np.uint8).reshape(-1)[::7] ^= 0xFF
            d[name] = a
            self.corrupted += 1


@dataclasses.dataclass
class ChaosEvent:
    """Arm ``fault`` ``at`` seconds into the run; restore it after
    ``duration`` seconds (None: it stays for the run, and ``restore_all``
    cleans it up afterwards)."""
    at: float
    fault: Fault
    duration: Optional[float] = None
    armed: bool = False
    restored: bool = False


class ChaosInjector:
    """Deterministic fault scheduler driven by ``ServeLoop.run``'s
    ``on_tick(loop, rel)`` hook. ``log`` records (rel, fault name, action)
    for every transition."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: e.at)
        self.log: list[tuple[float, str, str]] = []

    def on_tick(self, loop, rel: float):
        for ev in self.events:
            if not ev.armed and rel >= ev.at:
                ev.fault.inject(loop)
                ev.armed = True
                self.log.append((round(rel, 4), ev.fault.name, "inject"))
            if ev.armed and not ev.restored and ev.duration is not None \
                    and rel >= ev.at + ev.duration:
                ev.fault.restore(loop)
                ev.restored = True
                self.log.append((round(rel, 4), ev.fault.name, "restore"))

    def restore_all(self, loop):
        """Undo every still-armed fault (end-of-run cleanup)."""
        for ev in self.events:
            if ev.armed and not ev.restored:
                ev.fault.restore(loop)
                ev.restored = True
                self.log.append((-1.0, ev.fault.name, "restore_all"))
