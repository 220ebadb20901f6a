"""The shared retry/straggler/timeout policy of every dispatch surface.

A copy of ``repro.dispatch.policy`` (numpy only): the port imports
nothing of the reference package.

:class:`DispatchPolicy` is the protocol; the canonical implementation is
:class:`repro.core.simulator.FaultProfile` (kept there so the event
simulator stays importable without this package's consumers). The
discrete-event simulator and the real multi-process gateway
(``repro.dist``) draw their fault decisions through the SAME functions
below, so "what counts as a cold start / straggler / transient failure,
and how retries back off" has exactly one definition:

* :func:`draw_temperature` — the container-temperature discipline:
  speculatively pre-warmed containers are consumed first (a prewarm hit
  masks the cold draw), then the reactive warm pool, then a cold draw.
  With a prewarm state present the cold stream draws once per invocation
  unconditionally (hint-independent draws — the determinism contract of
  the simulator's prewarm mode); without one, the historical
  draw-after-pool discipline is preserved bit-for-bit.
* :func:`draw_straggler` — tail-latency amplification.
* :func:`draw_failures` — the number of transiently failed attempts
  before the success, capped at ``max_retries`` (the last attempt always
  completes).
* ``policy.backoff_s(attempt)`` — exponential backoff between attempts:
  ``retry_backoff_s * 2**(attempt-1)``.

The draw ORDER (temperature, then straggler, then failures — each
consuming rng draws only when its knob is enabled) is part of the
contract: the simulator's golden-pinned fault streams replay exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, Tuple, runtime_checkable

import numpy as np


@runtime_checkable
class DispatchPolicy(Protocol):
    """Retry/straggler/timeout knobs any dispatch surface consumes.

    ``repro.core.simulator.FaultProfile`` is the canonical (frozen
    dataclass) implementation; transports may supply their own as long
    as the fields and ``backoff_s`` are present.
    """

    cold_start_prob: float
    warm_pool: int
    straggler_prob: float
    straggler_slowdown: float
    failure_prob: float
    max_retries: int
    retry_backoff_s: float
    concurrency_limit: int

    def backoff_s(self, attempt: int) -> float:
        """Seconds to wait before re-dispatching after failed attempt
        number ``attempt`` (1-based)."""
        ...


@dataclass
class WaveState:
    """Mutable per-wave temperature state one invocation wave threads
    through :func:`draw_temperature`: the reactive warm pool and the
    per-expert speculatively pre-warmed container counts."""

    warm_left: int
    pre_left: Optional[np.ndarray] = None   # (E,) prewarmed containers

    @classmethod
    def start(cls, policy: DispatchPolicy,
              prewarmed: Optional[np.ndarray]) -> "WaveState":
        return cls(warm_left=int(policy.warm_pool),
                   pre_left=(None if prewarmed is None
                             else np.asarray(prewarmed, np.int64).copy()))


def draw_temperature(policy: DispatchPolicy, rng: np.random.Generator,
                     state: WaveState, expert: int) -> Tuple[bool, bool]:
    """One invocation's container-temperature decision.

    Returns ``(cold, prewarm_hit)`` and mutates ``state``. The exact
    draw discipline of the event simulator (see module docstring); any
    change here shifts the golden-pinned fault streams.
    """
    cold = False
    pre_hit = False
    if state.pre_left is not None:
        draw = rng.random() if policy.cold_start_prob > 0.0 else 1.0
        if state.pre_left[expert] > 0:
            state.pre_left[expert] -= 1
            pre_hit = True
        elif state.warm_left > 0:
            state.warm_left -= 1
        elif draw < policy.cold_start_prob:
            cold = True
    elif policy.cold_start_prob > 0.0:
        if state.warm_left > 0:
            state.warm_left -= 1
        elif rng.random() < policy.cold_start_prob:
            cold = True
    return cold, pre_hit


def draw_straggler(policy: DispatchPolicy,
                   rng: np.random.Generator) -> bool:
    """Whether one invocation's successful attempt straggles."""
    return bool(policy.straggler_prob > 0.0
                and rng.random() < policy.straggler_prob)


def draw_failures(policy: DispatchPolicy,
                  rng: np.random.Generator) -> int:
    """Number of transiently FAILED attempts before the success.

    Attempt ``k`` (1-based) fails with ``failure_prob`` while
    ``k <= max_retries``; the attempt after the last allowed retry
    always completes — identical to the simulator's historical loop
    (``while attempts <= max_retries and rng.random() < failure_prob``).
    """
    n = 0
    if policy.failure_prob > 0.0:
        while n + 1 <= policy.max_retries \
                and rng.random() < policy.failure_prob:
            n += 1
    return n
