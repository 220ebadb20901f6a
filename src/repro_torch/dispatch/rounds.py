"""Dispatch-round segmentation of a served-token stream.

A copy of ``repro.dispatch.rounds``: the port imports nothing of the
reference package.

A serving engine that executes a :class:`~repro.plan.schema.DeploymentPlan`
groups its decode steps into scatter-gather *rounds* of the plan's chunk
schedule — once at least ``round_tokens`` tokens have been served since
the round opened, the round closes (the minibatch granularity of Eq. 6
applied to live traffic). :class:`RoundAccumulator` is that bookkeeping,
extracted from ``ServingEngine.run`` so any engine (or the process
gateway's live mode) segments identically.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class RoundAccumulator:
    """Tracks one open scatter-gather dispatch round.

    ``record_step()`` after each decode step; ``due(total_tokens)``
    checks whether the round reached its token budget; ``close(...)``
    emits the round info dict (``{"steps", "tokens"}``), fires the
    optional callback, and opens the next round. Disabled entirely when
    ``round_tokens`` is 0 (``due``/``pending`` stay False).
    """

    def __init__(self, round_tokens: int, *, start_tokens: int = 0,
                 on_round: Optional[Callable[[Any, Dict[str, int]], None]]
                 = None):
        self.round_tokens = int(round_tokens)
        self.start_tokens = int(start_tokens)
        self.steps = 0
        self.on_round = on_round

    @property
    def enabled(self) -> bool:
        return self.round_tokens > 0

    def record_step(self) -> None:
        self.steps += 1

    def due(self, total_tokens: int) -> bool:
        """True once the open round has served its token budget."""
        return (self.enabled
                and total_tokens - self.start_tokens >= self.round_tokens)

    def pending(self, total_tokens: int) -> bool:
        """True when a final PARTIAL round holds unclosed tokens."""
        return self.enabled and total_tokens > self.start_tokens

    def close(self, total_tokens: int, source: Any = None
              ) -> Dict[str, int]:
        """Close the open round: emit {"steps", "tokens"}, fire the
        callback with ``(source, info)``, and open the next round at the
        current token watermark."""
        info = {"steps": self.steps,
                "tokens": int(total_tokens - self.start_tokens)}
        if self.on_round is not None:
            self.on_round(source, info)
        self.start_tokens = int(total_tokens)
        self.steps = 0
        return info
