"""The chunk schedule as a first-class object.

A copy of ``repro.dispatch.chunks`` (numpy only): the port imports
nothing of the reference package.

A :class:`ChunkPlan` is the execution-side view of a
:class:`~repro.plan.schema.DeploymentPlan`'s pipeline chunk schedule:
per layer, the scatter-gather minibatch size β (Eq. 6) and the comm
method it applies to. It is derived through the plan's
``full_chunk_schedule()`` fallback — schedules shorter than the layer
count pad out to the global β — so every consumer (event simulator,
serving dispatch rounds, expert-parallel chunk loops, the process
gateway) agrees on the same per-layer chunking without re-deriving it.

Dependency-light on purpose (numpy + stdlib): importable from worker
processes and from ``repro.distributed`` without pulling in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class ChunkPlan:
    """Per-layer scatter-gather chunking derived from a deployment plan.

    ``schedule[e]`` is the minibatch size β the pipelined (method-1)
    scatter-gather of layer ``e`` uses; non-pipelined layers carry 1.
    """

    schedule: np.ndarray      # (L,) int — minibatch size per layer
    method: np.ndarray        # (L,) int in {1,2,3}

    def __post_init__(self):
        object.__setattr__(self, "schedule",
                           np.asarray(self.schedule, np.int64))
        object.__setattr__(self, "method",
                           np.asarray(self.method, np.int64))
        assert self.schedule.shape == self.method.shape, \
            (self.schedule.shape, self.method.shape)

    @classmethod
    def from_plan(cls, plan) -> "ChunkPlan":
        """The single derivation point: honors the plan's explicit
        schedule and the ``full_chunk_schedule()`` short-schedule
        fallback (global β for missing method-1 layers, 1 otherwise)."""
        return cls(schedule=plan.full_chunk_schedule(),
                   method=np.asarray(plan.method, np.int64).copy())

    # ------------------------------------------------------------ geometry
    @property
    def num_layers(self) -> int:
        return int(self.schedule.shape[0])

    def beta_for(self, layer: int) -> int:
        """Minibatch size of one layer's scatter-gather."""
        return int(self.schedule[layer])

    def round_tokens(self) -> int:
        """Token budget of one serving dispatch round: the largest
        minibatch size any layer pipelines (the granularity
        ``ServingBackend`` segments live decode traffic into)."""
        if self.schedule.size == 0:
            return 1
        return int(self.schedule.max())

    # --------------------------------------------------------- minibatches
    def minibatches(self, layer: int, r) -> np.ndarray:
        """(E,) minibatch count per expert replica for one layer.

        ``r`` is tokens-per-replica. Pipelined (method-1) layers run
        ``ceil(r / β)`` minibatches (the Fig. 8a schedule the simulator
        bills via Eq. 6); methods 2/3 move each replica's tokens in one
        shot. Experts with no routed tokens are never invoked (0).
        """
        r = np.asarray(r, float)
        beta = max(self.beta_for(layer), 1)
        if int(self.method[layer]) == 1:
            n = np.ceil(r / beta)
        else:
            n = np.ones_like(r)
        return np.where(r > 0, n, 0.0).astype(np.int64)

    def wave_minibatches(self, layer: int, r, g) -> int:
        """Total scatter-gather chunks one layer's invocation wave
        dispatches: per-replica minibatches summed over replicas."""
        g = np.asarray(g, float)
        return int((self.minibatches(layer, r) * g).sum())


def chunk_count(capacity: int, d_model: int, beta: int,
                max_chunk_bytes: Optional[int], model_size: int,
                e_local: int, itemsize: int = 2) -> int:
    """β for the expert-parallel capacity axis, raised if a chunk would
    exceed the payload-cap analogue ``max_chunk_bytes`` (the D^p ceiling
    of Eq. 12f applied to all_to_all message sizes), then rounded up
    until the chunks tile the capacity axis exactly.

    Moved verbatim from ``repro.distributed.moe_parallel`` so the
    shard_map β-chunk loops and the process gateway size their chunks
    through the same substrate.
    """
    beta = max(1, min(beta, capacity))
    if max_chunk_bytes:
        while beta < capacity:
            chunk_c = -(-capacity // beta)
            msg = model_size * e_local * chunk_c * d_model * itemsize
            if msg <= max_chunk_bytes:
                break
            beta *= 2
    while capacity % beta != 0:      # chunks must tile the capacity axis
        beta += 1
    return min(beta, capacity)
