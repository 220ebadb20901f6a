"""The deployment artifact exchanged between planners and backends.

A copy of ``repro.plan.schema`` (numpy only): the port imports
nothing of the reference package.

A :class:`DeploymentPlan` is the typed, versioned, JSON-serializable
record of everything the paper's optimizer decides for one MoE model
(§III-D Eq. 12): per-layer comm method, per-(layer, expert) memory sizes
and replication degrees, the pipeline chunk schedule (minibatch size beta
per layer, Eq. 6), and the demand estimate the plan was built for. It is
the single object handed from any :class:`repro.plan.planner.Planner` to
any :class:`repro.plan.backends.ExecutionBackend`, and the unit of
persistence: a plan serialized to JSON and reloaded must drive a backend
to bit-identical results.

This module is dependency-light on purpose (numpy + stdlib only) so both
``repro.core`` and ``repro.serving`` can import it without cycles.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

PLAN_VERSION = 1


def _as_int_array(a, ndim: int) -> np.ndarray:
    out = np.asarray(a, np.int64)
    assert out.ndim == ndim, (out.shape, ndim)
    return out


def _as_float_array(a, ndim: int) -> np.ndarray:
    out = np.asarray(a, np.float64)
    assert out.ndim == ndim, (out.shape, ndim)
    return out


@dataclass
class DeploymentPlan:
    """The deployed configuration of every MoE layer (paper Eq. 12).

    Field layout is the superset of the original ad-hoc
    ``DeploymentPolicy`` (which is now an alias of this class), plus the
    serialization/provenance fields ``version``, ``planner``,
    ``chunk_schedule`` and ``metadata``.
    """

    method: np.ndarray        # (L,) int in {1,2,3} — comm design per layer
    beta: int                 # global pipeline degree (method-1 layers)
    mem_mb: np.ndarray        # (L, E) function memory sizes
    replicas: np.ndarray      # (L, E) int replication degrees
    demand: np.ndarray        # (L, E) predicted token counts d_{e,i}
    layer_cost: np.ndarray    # (L,) planner's billed-cost estimate
    layer_latency: np.ndarray  # (L,)
    meets_slo: bool = True
    version: int = PLAN_VERSION
    planner: str = ""         # registry name of the producing planner
    # (L,) scatter-gather minibatch size per layer: beta for pipelined
    # (method-1) layers, 1 otherwise. Derived when not given.
    chunk_schedule: Optional[np.ndarray] = None
    metadata: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.method = _as_int_array(self.method, 1)
        self.mem_mb = _as_float_array(self.mem_mb, 2)
        self.replicas = _as_int_array(self.replicas, 2)
        self.demand = _as_float_array(self.demand, 2)
        self.layer_cost = _as_float_array(self.layer_cost, 1)
        self.layer_latency = _as_float_array(self.layer_latency, 1)
        self.beta = int(self.beta)
        if self.chunk_schedule is None:
            self.chunk_schedule = np.where(self.method == 1,
                                           max(self.beta, 1), 1)
        self.chunk_schedule = _as_int_array(self.chunk_schedule, 1)

    # ------------------------------------------------------------ geometry
    @property
    def num_layers(self) -> int:
        return int(self.method.shape[0])

    @property
    def num_experts(self) -> int:
        return int(self.mem_mb.shape[1])

    @property
    def total_cost(self) -> float:
        return float(self.layer_cost.sum())

    @property
    def total_latency(self) -> float:
        return float(self.layer_latency.sum())

    def full_chunk_schedule(self) -> np.ndarray:
        """(L,) chunk schedule with short schedules padded out.

        A schedule shorter than the layer count (hand-built plans,
        truncated JSON) falls back to the global ``beta`` for each
        missing pipelined (method-1) layer and 1 otherwise, instead of
        indexing past the end.
        """
        cs = self.chunk_schedule
        L = self.num_layers
        if cs.shape[0] >= L:
            return cs[:L]
        pad = np.where(self.method[cs.shape[0]:] == 1,
                       max(self.beta, 1), 1).astype(np.int64)
        return np.concatenate([cs, pad])

    def chunk_for_layer(self, layer: int) -> int:
        """Pipeline minibatch size the scatter-gather of ``layer`` uses."""
        return int(self.full_chunk_schedule()[layer])

    def function_placement(self, layer: int) -> List[List[str]]:
        """Expert -> serverless-function-name placement for one layer."""
        return [[f"moe-l{layer}-e{i}-r{g}"
                 for g in range(int(self.replicas[layer, i]))]
                for i in range(self.num_experts)]

    # ------------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": int(self.version),
            "planner": self.planner,
            "method": self.method.tolist(),
            "beta": int(self.beta),
            "mem_mb": self.mem_mb.tolist(),
            "replicas": self.replicas.tolist(),
            "demand": self.demand.tolist(),
            "layer_cost": self.layer_cost.tolist(),
            "layer_latency": self.layer_latency.tolist(),
            "meets_slo": bool(self.meets_slo),
            "chunk_schedule": self.chunk_schedule.tolist(),
            "metadata": self.metadata,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeploymentPlan":
        version = int(d.get("version", PLAN_VERSION))
        if version > PLAN_VERSION:
            raise ValueError(
                f"DeploymentPlan version {version} is newer than this "
                f"library's schema (v{PLAN_VERSION})")
        return cls(
            method=np.asarray(d["method"], np.int64),
            beta=int(d["beta"]),
            mem_mb=np.asarray(d["mem_mb"], np.float64),
            replicas=np.asarray(d["replicas"], np.int64),
            demand=np.asarray(d["demand"], np.float64),
            layer_cost=np.asarray(d["layer_cost"], np.float64),
            layer_latency=np.asarray(d["layer_latency"], np.float64),
            meets_slo=bool(d.get("meets_slo", True)),
            version=version,
            planner=d.get("planner", ""),
            chunk_schedule=(np.asarray(d["chunk_schedule"], np.int64)
                            if d.get("chunk_schedule") is not None else None),
            metadata=dict(d.get("metadata", {})),
        )

    def to_json(self, **json_kwargs) -> str:
        return json.dumps(self.to_dict(), **json_kwargs)

    @classmethod
    def from_json(cls, s: str) -> "DeploymentPlan":
        return cls.from_dict(json.loads(s))


@dataclass
class Workload:
    """What an :class:`ExecutionBackend` is asked to execute under a plan.

    ``batches`` are token-id arrays — 2-D (B, S) rectangles or 1-D ragged
    rows. A backend that cannot derive real routing itself (the
    simulator) consumes ``real_demand`` or a ``demand_fn`` instead.
    """

    batches: List[np.ndarray]
    real_demand: Optional[np.ndarray] = None   # (L, E) if known up front
    max_new_tokens: int = 0                    # serving backends only

    @property
    def num_tokens(self) -> int:
        return int(sum(np.asarray(b).size for b in self.batches))


@dataclass
class ExecutionReport:
    """Common result of executing a plan on any backend (Eq. 4 + feedback).

    The field set is the union of what Alg. 2 consumes as feedback
    (billed cost, memory overruns for case (i), payload violations for
    case (ii)), what the paper's figures report (latency, throughput),
    the discrete-event simulator's fault breakdown (cold starts,
    transient-failure retries, concurrency queueing, stragglers — all
    zero on an ideal platform), the predictive pre-warming breakdown
    (hits, misses, wasted keep-alive GB-seconds — all zero unless a
    prewarmer ran), and the expert-weight cache breakdown (residency
    hits, swaps, swap/keep-alive GB-seconds, packed experts — all zero
    unless a ``repro.expcache`` model was attached to the run), and the
    multi-tenant breakdown (``tenants``: per-tenant cost / latency /
    fault counters summing to the fleet totals — empty unless the run
    was given a tenant split).
    """

    billed_cost: float                 # total $ for all MoE layers
    latency_s: float                   # end-to-end inference time
    throughput_tps: float              # tokens / second
    layer_cost: np.ndarray             # (L,)
    layer_latency: np.ndarray          # (L,)
    mem_overrun: np.ndarray            # (L, E) bool — Alg. 2 case (i)
    payload_violation: np.ndarray      # (L, E) bool — Alg. 2 case (ii)
    real_demand: np.ndarray            # (L, E) routed counts executed
    min_mem_required_mb: np.ndarray    # (L, E) M^real
    backend: str = ""
    num_tokens: int = 0
    cold_starts: int = 0               # invocations that paid cold init
    cold_start_s: float = 0.0          # billed cold-init seconds
    retries: int = 0                   # transient-failure retry attempts
    retry_s: float = 0.0               # billed seconds burnt by failures
    queue_delay_s: float = 0.0         # concurrency-limit queueing (latency)
    stragglers: int = 0                # invocations that straggled
    prewarm_hits: int = 0              # invocations served by a prewarmed
    #                                    container (cold draw masked)
    prewarm_misses: int = 0            # prewarmed containers never consumed
    wasted_prewarm_gb_s: float = 0.0   # billed idle keep-alive of misses
    cache_hits: int = 0                # invocations served by a container
    #                                    already holding the expert weights
    cache_swaps: int = 0               # cold draws masked by a weight swap
    swap_gb_s: float = 0.0             # billed GB-seconds of those swaps
    packed_experts: int = 0            # experts co-resident in packed
    #                                    containers at end of run (gauge)
    cache_keepalive_gb_s: float = 0.0  # billed idle keep-alive of resident
    #                                    containers between windows
    # per-tenant accounting: tenant name -> plain-typed breakdown dict
    # (billed_cost / latency_s / cold_starts / ... summing to the fleet
    # totals). Empty unless the run was given a tenant split.
    tenants: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    extras: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        """Plain-type view (lists/floats/bools) — two reports are
        bit-identical iff their ``to_dict()`` results compare equal.

        The prewarm breakdown serializes as a ``"prewarm"`` sub-dict ONLY
        when a prewarmer actually ran (any of the three fields non-zero):
        prewarm-off reports keep the exact pre-prewarm wire schema, so the
        committed golden fixtures from before the feature remain valid
        bit-for-bit."""
        d = {
            "backend": self.backend,
            "billed_cost": float(self.billed_cost),
            "latency_s": float(self.latency_s),
            "throughput_tps": float(self.throughput_tps),
            "layer_cost": np.asarray(self.layer_cost, float).tolist(),
            "layer_latency": np.asarray(self.layer_latency, float).tolist(),
            "mem_overrun": np.asarray(self.mem_overrun, bool).tolist(),
            "payload_violation": np.asarray(self.payload_violation,
                                            bool).tolist(),
            "real_demand": np.asarray(self.real_demand, float).tolist(),
            "min_mem_required_mb": np.asarray(self.min_mem_required_mb,
                                              float).tolist(),
            "num_tokens": int(self.num_tokens),
            "cold_starts": int(self.cold_starts),
            "cold_start_s": float(self.cold_start_s),
            "retries": int(self.retries),
            "retry_s": float(self.retry_s),
            "queue_delay_s": float(self.queue_delay_s),
            "stragglers": int(self.stragglers),
        }
        if self.prewarm_hits or self.prewarm_misses \
                or self.wasted_prewarm_gb_s:
            d["prewarm"] = {
                "prewarm_hits": int(self.prewarm_hits),
                "prewarm_misses": int(self.prewarm_misses),
                "wasted_prewarm_gb_s": float(self.wasted_prewarm_gb_s),
            }
        # same contract for the expert-weight cache: the "cache" block
        # appears ONLY when a cache model actually ran, so cache-off
        # reports (and every pre-cache golden fixture) keep the exact
        # historical wire schema
        if self.cache_hits or self.cache_swaps or self.swap_gb_s \
                or self.packed_experts or self.cache_keepalive_gb_s:
            d["cache"] = {
                "cache_hits": int(self.cache_hits),
                "cache_swaps": int(self.cache_swaps),
                "swap_gb_s": float(self.swap_gb_s),
                "packed_experts": int(self.packed_experts),
                "cache_keepalive_gb_s": float(self.cache_keepalive_gb_s),
            }
        # and for multi-tenant accounting: the "tenants" block appears
        # ONLY when the run was given a tenant split, so tenant-less
        # reports (and every pre-tenancy golden fixture) keep the exact
        # historical wire schema
        if self.tenants:
            d["tenants"] = {name: dict(t)
                            for name, t in self.tenants.items()}
        return d

    def to_json(self, **json_kwargs) -> str:
        return json.dumps(self.to_dict(), **json_kwargs)


def plan_diff(old: DeploymentPlan, new: DeploymentPlan) -> Dict[str, Any]:
    """Structured diff between two plans (telemetry re-planning emits
    this so operators see WHAT a re-plan changed). Plain types only, so
    the diff can ride inside ``DeploymentPlan.metadata``."""
    if old.method.shape != new.method.shape \
            or old.mem_mb.shape != new.mem_mb.shape:
        raise ValueError("plans describe different model geometries")
    method_changes = [
        {"layer": int(e), "old": int(old.method[e]), "new": int(new.method[e])}
        for e in np.nonzero(old.method != new.method)[0]]
    rep_delta = new.replicas - old.replicas
    mem_delta = new.mem_mb - old.mem_mb
    return {
        "planner": {"old": old.planner, "new": new.planner},
        "method_changes": method_changes,
        "beta": {"old": int(old.beta), "new": int(new.beta)},
        "chunk_changes": int(np.sum(old.full_chunk_schedule()
                                    != new.full_chunk_schedule())),
        "replicas_changed": int(np.sum(rep_delta != 0)),
        "replicas_added": int(rep_delta[rep_delta > 0].sum()),
        "replicas_removed": int(-rep_delta[rep_delta < 0].sum()),
        "mem_changed": int(np.sum(mem_delta != 0)),
        "mem_mb_delta_total": float(mem_delta.sum()),
        "cost_delta": float(new.total_cost - old.total_cost),
        "latency_delta": float(new.total_latency - old.total_latency),
        "meets_slo": {"old": bool(old.meets_slo), "new": bool(new.meets_slo)},
    }
