"""Slot scheduler for the continuous-batching engine.

A copy of ``repro.serving.scheduler`` (numpy only): the port imports
nothing of the reference package.

Pure bookkeeping, no JAX: a FIFO queue of submitted requests plus a fixed
set of decode slots. The engine admits queued requests into free slots
*mid-stream* (between decode steps), so short requests finishing early
immediately free capacity for waiting ones — the property the old
fixed-batch drain loop lacked.

**Fair-share + priority admission (multi-tenant).** Requests may carry a
``tenant`` name and a ``priority``; when any queued request does, slot
admission switches from plain FIFO to a weighted fair-share pick:
the queued request minimizing ``(-(priority + priority_aging * wait),
served_tokens[tenant] - aging * wait, queue_index)``. ``served_tokens``
is each tenant's weight-normalized admitted-token account (deficit
round-robin), ``aging`` lets waiting requests of a backlogged tenant
overtake eventually, and ``priority_aging > 0`` lets even a lower-
priority request overtake once it has waited long enough — the
starvation-freedom knob that keeps a bursty high-priority tenant from
locking out a diurnal one. Tenant-less queues take the EXACT historical
FIFO path (bit-identical admission order).
"""
from __future__ import annotations

import enum
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"


@dataclass
class Request:
    """One generation request and its full lifecycle record."""

    uid: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: List[int] = field(default_factory=list)
    state: RequestState = RequestState.QUEUED
    finish_reason: Optional[str] = None   # "eos" | "length" | "truncated"
    slot: Optional[int] = None
    admitted_step: Optional[int] = None   # engine step at slot admission
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    tenant: Optional[str] = None          # fair-share account (None=FIFO)
    priority: int = 0                     # higher admits first
    submit_step: int = 0                  # engine step at submission

    @property
    def done(self) -> bool:
        return self.state is RequestState.FINISHED

    @property
    def truncated(self) -> bool:
        return self.finish_reason == "truncated"

    @property
    def ttft_s(self) -> Optional[float]:
        """Time-to-first-token (prefill emits the first token)."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


class SlotScheduler:
    """FIFO admission into a fixed number of decode slots, with weighted
    fair-share + priority + aging when requests carry tenants."""

    def __init__(self, num_slots: int, *, aging: float = 64.0,
                 priority_aging: float = 0.0,
                 weights: Optional[Dict[str, float]] = None):
        if num_slots < 1:
            raise ValueError("need at least one decode slot")
        if aging < 0 or priority_aging < 0:
            raise ValueError("aging knobs must be >= 0")
        self.num_slots = num_slots
        self.aging = float(aging)
        self.priority_aging = float(priority_aging)
        self.weights: Dict[str, float] = dict(weights or {})
        for name, w in self.weights.items():
            if w <= 0:
                raise ValueError(f"weight for {name!r} must be > 0")
        self.served_tokens: Dict[str, float] = {}
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * num_slots
        self._uid = 0

    # ------------------------------------------------------------- submit
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               tenant: Optional[str] = None, priority: int = 0,
               submit_step: int = 0) -> Request:
        self._uid += 1
        req = Request(self._uid, np.asarray(prompt, np.int32).ravel(),
                      max_new_tokens, eos_id=eos_id,
                      submit_time=time.perf_counter(),
                      tenant=tenant, priority=int(priority),
                      submit_step=int(submit_step))
        self.queue.append(req)
        return req

    # ---------------------------------------------------------- admission
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def _pick_fair(self, step: int) -> int:
        """Queue index of the fair-share winner at engine ``step``."""
        def key(item):
            idx, r = item
            wait = max(step - r.submit_step, 0)
            tenant = r.tenant or ""
            served = self.served_tokens.get(tenant, 0.0)
            return (-(r.priority + self.priority_aging * wait),
                    served - self.aging * wait,
                    idx)
        return min(enumerate(self.queue), key=key)[0]

    def admit_next(self, slot: int, step: int) -> Optional[Request]:
        """Admit one queued request into ``slot``; None if queue empty.

        Plain FIFO (oldest first) while no queued request carries a
        tenant — the historical, golden-pinned order. With tenants
        present, the fair-share pick applies and the winner's tenant is
        charged its weight-normalized token account.
        """
        if not self.queue:
            return None
        assert self.slots[slot] is None, f"slot {slot} is occupied"
        if all(r.tenant is None for r in self.queue):
            req = self.queue.popleft()
        else:
            idx = self._pick_fair(step)
            req = self.queue[idx]
            del self.queue[idx]
            tenant = req.tenant or ""
            w = self.weights.get(tenant, 1.0)
            cost = (req.prompt.size + req.max_new_tokens) / w
            self.served_tokens[tenant] = \
                self.served_tokens.get(tenant, 0.0) + cost
        req.state = RequestState.RUNNING
        req.slot = slot
        req.admitted_step = step
        self.slots[slot] = req
        return req

    def fairness_stats(self) -> Dict[str, float]:
        """Weight-normalized admitted-token accounts per tenant."""
        return dict(self.served_tokens)

    # ---------------------------------------------------------- lifecycle
    def finish(self, req: Request, reason: str) -> None:
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        req.finish_time = time.perf_counter()
        if req.slot is not None:
            self.slots[req.slot] = None

    def active(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)
