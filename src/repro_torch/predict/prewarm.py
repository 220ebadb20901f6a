"""Speculative container pre-warming from predicted expert demand.

A copy of ``repro.predict.prewarm`` (numpy only): the port imports
nothing of the reference package.

The paper's serverless win (§III-B) is provisioning expert functions
BEFORE the scatter arrives. This module turns a demand forecast into the
concrete warm-up order the discrete-event simulator honors: per
(layer, expert), how many containers to speculatively warm — at most the
plan's replica count (warming more containers than the plan ever invokes
is a guaranteed misprediction).

A correct prediction converts a would-be cold start into a warm hit; a
misprediction leaves the container idle and bills its keep-alive
GB-seconds (``PlatformSpec.t_prewarm_keepalive_s`` at the function's
memory size) — the ``prewarm_hits`` / ``prewarm_misses`` /
``wasted_prewarm_gb_s`` breakdown of :class:`ExecutionReport`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass(frozen=True)
class PrewarmEvent:
    """Warm ``containers`` instances of one expert function ahead of a
    dispatch wave."""

    layer: int
    expert: int
    containers: int
    mem_mb: float = 0.0        # informational; billing uses the plan's

    def __post_init__(self):
        assert self.containers >= 0, self.containers


def prewarm_containers(plan, demand_pred: np.ndarray, *,
                       min_tokens: float = 0.5) -> np.ndarray:
    """(L, E) containers to warm: the plan's full replica set for every
    expert the forecast expects at least ``min_tokens`` routed tokens for,
    zero otherwise (an expert the plan invokes always invokes all its
    replicas in a wave)."""
    d = np.asarray(demand_pred, float)
    replicas = np.asarray(plan.replicas, np.int64)
    assert d.shape == replicas.shape, (d.shape, replicas.shape)
    return np.where(d >= min_tokens, replicas, 0).astype(np.int64)


def prewarm_oracle(plan, real_demand: np.ndarray) -> np.ndarray:
    """Perfect-foresight prewarmer: warms exactly the containers the real
    routing will invoke (the differential-test upper bound — zero misses,
    zero wasted GB-seconds)."""
    return prewarm_containers(plan, real_demand)


def prewarm_events(containers: np.ndarray,
                   mem_mb=None) -> List[PrewarmEvent]:
    """Expand a (L, E) container matrix into explicit events (non-zero
    cells only)."""
    containers = np.asarray(containers, np.int64)
    mem = np.zeros_like(containers, float) if mem_mb is None \
        else np.asarray(mem_mb, float)
    return [PrewarmEvent(layer=int(li), expert=int(e),
                         containers=int(containers[li, e]),
                         mem_mb=float(mem[li, e]))
            for li, e in zip(*np.nonzero(containers))]


def prewarm_matrix(events: Sequence[PrewarmEvent], num_layers: int,
                   num_experts: int) -> np.ndarray:
    """Collapse :class:`PrewarmEvent` s back into the (L, E) matrix the
    simulator consumes."""
    out = np.zeros((num_layers, num_experts), np.int64)
    for ev in events:
        assert 0 <= ev.layer < num_layers and 0 <= ev.expert < num_experts
        out[ev.layer, ev.expert] += int(ev.containers)
    return out
