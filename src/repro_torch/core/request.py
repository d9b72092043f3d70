"""Request/SLO/batch data model shared by the scheduler, executor & simulator."""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional

_ids = itertools.count()

# Terminal request statuses (the failure-semantics layer). "ok" is the only
# success; everything else is a terminal error the serving plane stamped:
#   deadline_shed      - shed BEFORE admission: predicted TTFT (page-gate cost
#                        model) could not meet the deadline, or the deferred
#                        admission expired in the engine's pending queue.
#   deadline_cancelled - cancelled MID-FLIGHT: the stream (live slot or
#                        preempted resume entry) ran past its deadline.
#   cancelled          - client cancel() unwound the request.
#   quarantined        - the stream produced non-finite logits (NaN/Inf
#                        adapter or activations) and was retired to protect
#                        co-batched streams.
#   head_failed        - the task's decoder head raised past the executor's
#                        bounded retries; only this task's requests fail.
#   rejected_stranded  - a deferred join whose shared-prefix discount was
#                        released could never fit again and its deadline
#                        passed (or the loop recovered a wedged engine).
#   watchdog_shed      - the loop watchdog shed queued work of the lowest-
#                        weight task to degrade gracefully under an engine
#                        stall.
# Durability note: surviving a device reset is NOT a status — a request that
# rides through ``ServeLoop.checkpoint_restart`` keeps whatever terminal
# status it ends with (usually "ok", token-for-token identical to a fault-
# free run) and counts the reset in ``resets_survived`` instead.
STATUS_OK = "ok"
FAILURE_STATUSES = ("deadline_shed", "deadline_cancelled", "cancelled",
                    "quarantined", "head_failed", "rejected_stranded",
                    "watchdog_shed")


@dataclasses.dataclass
class SLO:
    deadline_s: Optional[float] = None     # max acceptable latency (None = none)


# identity equality: queues remove a request by ``==``, and field equality
# would compare two same-task, same-arrival requests' array payloads
@dataclasses.dataclass(eq=False)
class Request:
    task_id: str
    arrival: float
    payload: Any = None                    # model input (real plane) or size hint
    tokens: float = 1.0                    # token-based FMs: work units (§4.2)
    # generative serving: > 0 routes the request through the continuous-
    # batching DecodeEngine (payload = prompt token ids); the budget counts
    # the prefill-produced first token
    max_new_tokens: int = 0
    slo: SLO = dataclasses.field(default_factory=SLO)
    rid: int = dataclasses.field(default_factory=lambda: next(_ids))
    # BFQ tags (assigned at enqueue)
    start_tag: float = 0.0
    finish_tag: float = 0.0
    v_at_arrival: float = 0.0
    # lifecycle timestamps
    dispatch_time: Optional[float] = None
    first_token_time: Optional[float] = None   # decode path: TTFT endpoint
    finish_time: Optional[float] = None
    result: Any = None
    # terminal status: STATUS_OK or one of FAILURE_STATUSES (module header);
    # error carries the human-readable cause for non-ok terminations
    status: str = STATUS_OK
    error: Optional[str] = None
    # engine restores this request lived through while in flight (stamped by
    # ServeLoop.checkpoint_restart; 0 for the overwhelming common case)
    resets_survived: int = 0

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK

    @property
    def latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival

    def deadline(self) -> float:
        if self.slo.deadline_s is None:
            return float("inf")
        return self.arrival + self.slo.deadline_s

    def met_deadline(self) -> bool:
        """Finished successfully within its deadline (goodput numerator)."""
        return (self.status == STATUS_OK and self.finish_time is not None
                and self.finish_time <= self.deadline())


@dataclasses.dataclass
class Batch:
    requests: list[Request]
    # requests grouped into adapter-compatible sub-batches (paper Fig. 5c):
    # list of (adapter_id | None, [requests])
    sub_batches: list[tuple[Optional[str], list[Request]]]

    @property
    def size(self) -> int:
        return len(self.requests)

    @property
    def tasks(self) -> set[str]:
        return {r.task_id for r in self.requests}

    @property
    def num_adapters(self) -> int:
        return sum(1 for a, _ in self.sub_batches if a is not None)
