"""Execution backends: where a :class:`DeploymentPlan` meets traffic.

A copy of ``repro.plan.backends`` (numpy only): the port imports
nothing of the reference package.

An :class:`ExecutionBackend` executes a plan against a workload and
returns the common :class:`~repro.plan.schema.ExecutionReport` the BO
loop (Alg. 2) and the paper's figures consume. Three implementations:

* :class:`SimulatorBackend` — wraps :class:`ServerlessSimulator`: bills
  the plan at the workload's REAL routed-token counts, flags memory
  overruns / payload violations. Deterministic at ``jitter=0``; an
  optional :class:`~repro.core.simulator.FaultProfile` injects cold
  starts, stragglers, transient failures, and concurrency queueing.
* :class:`ServingBackend` — drives the continuous-batching
  :class:`~repro.serving.engine.ServingEngine`: live requests are
  prefillled/decoded through the real JAX MoE model, decode steps are
  grouped into scatter-gather dispatch rounds by the plan's chunk
  schedule, and the measured routing is billed under the plan's
  per-layer comm methods — live traffic follows the planned comm design
  instead of an offline estimate.
* ``repro.dist.DistributedBackend`` (registered as ``"distributed"``,
  resolved lazily) — real multi-process execution of the plan's chunked
  scatter-gather over the :mod:`repro.dispatch` substrate, calibrated
  against the simulator's Eq. 3-11 closed forms.

Backends resolve by name through :func:`get_backend` (mirroring the
planner registry). The simulator/serving backends also consume :mod:`repro.traces` traffic:
``SimulatorBackend.execute_trace`` bills a plan window-by-window over a
demand :class:`~repro.traces.Trace` (drift, bursts), and
``ServingBackend.execute_requests`` serves a timed arrival schedule of
:class:`~repro.traces.TraceRequest` objects through the live engine.

Future backends (real AWS Lambda, a multi-host JAX mesh) implement the
same two-method surface and plug into the identical runtime seam.
"""
from __future__ import annotations

import time
from typing import (Callable, Dict, List, Optional, Protocol, Sequence,
                    runtime_checkable)

import numpy as np

from repro_torch.core.costmodel import ModelProfile, PlatformSpec
from repro_torch.core.deployment import apply_failure_feedback
from repro_torch.core.simulator import FaultProfile, ServerlessSimulator
from repro_torch.dispatch import ChunkPlan
from repro_torch.plan.schema import (DeploymentPlan, ExecutionReport, Workload,
                                     plan_diff)


@runtime_checkable
class ExecutionBackend(Protocol):
    """Anything that can execute a deployment plan on a workload."""

    name: str

    def execute(self, plan: DeploymentPlan,
                workload: Workload) -> ExecutionReport:
        ...


def _carried_prewarm(r: ExecutionReport) -> bool:
    """Whether a report's (conditional) prewarm block would serialize —
    the same any-field-nonzero predicate ``ExecutionReport.to_dict``
    uses to emit the ``"prewarm"`` sub-dict."""
    return bool(getattr(r, "prewarm_hits", 0)
                or getattr(r, "prewarm_misses", 0)
                or getattr(r, "wasted_prewarm_gb_s", 0.0))


def _carried_cache(r: ExecutionReport) -> bool:
    """Same predicate for the conditional ``"cache"`` block."""
    return bool(getattr(r, "cache_hits", 0)
                or getattr(r, "cache_swaps", 0)
                or getattr(r, "swap_gb_s", 0.0)
                or getattr(r, "packed_experts", 0)
                or getattr(r, "cache_keepalive_gb_s", 0.0))


_TENANT_SUM_INT = ("num_tokens", "cold_starts", "retries", "stragglers",
                   "prewarm_hits", "cache_hits", "cache_swaps")
_TENANT_SUM_FLOAT = ("billed_cost", "cold_start_s", "queue_delay_s")


def _merge_tenants(reports: List[ExecutionReport]) -> Dict[str, dict]:
    """Merge the conditional per-tenant blocks across window reports.

    Counters sum; per-window latencies are kept as ``latency_samples``
    (re-merging a merged report keeps the original samples) so the
    merged block can report the p99 each tenant's SLO is judged on.
    """
    names: List[str] = []
    for r in reports:
        for n in getattr(r, "tenants", {}) or {}:
            if n not in names:
                names.append(n)
    out: Dict[str, dict] = {}
    for n in names:
        acc: Dict[str, float] = {k: 0 for k in _TENANT_SUM_INT}
        acc.update({k: 0.0 for k in _TENANT_SUM_FLOAT})
        samples: List[float] = []
        for r in reports:
            t = (getattr(r, "tenants", {}) or {}).get(n)
            if not t:
                continue
            for k in _TENANT_SUM_INT:
                acc[k] = int(acc[k]) + int(t.get(k, 0))
            for k in _TENANT_SUM_FLOAT:
                acc[k] = float(acc[k]) + float(t.get(k, 0.0))
            samples.extend(t.get("latency_samples",
                                 [t.get("latency_s", 0.0)]))
        lat = float(sum(samples))
        acc["latency_s"] = lat
        acc["latency_samples"] = [float(s) for s in samples]
        acc["p99_latency_s"] = float(np.percentile(samples, 99.0)) \
            if samples else 0.0
        acc["max_latency_s"] = float(max(samples)) if samples else 0.0
        acc["throughput_tps"] = acc["num_tokens"] / max(lat, 1e-9)
        out[n] = acc
    return out


def _merge_reports(reports: List[ExecutionReport], *, backend: str,
                   wall_clock_s: Optional[float] = None
                   ) -> ExecutionReport:
    assert reports, "cannot merge zero reports"
    total_lat = float(sum(r.latency_s for r in reports))
    n_tok = int(sum(r.num_tokens for r in reports))
    # Throughput: the historical convention divides by the SUM of the
    # merged latencies — correct when the reports executed back-to-back
    # (sequential windows of one trace). When they ran CONCURRENTLY
    # (N tenants' fleets serving side by side), that sum overstates the
    # elapsed time and understates throughput; the multi-tenant path
    # passes the true elapsed wall clock instead. latency_s stays the
    # sum either way (it is the billed serial latency, not wall time).
    wall = total_lat if wall_clock_s is None else float(wall_clock_s)
    # the prewarm block is CONDITIONAL: a report only carries it when a
    # prewarmer actually ran. Merge over the carrying subset (reports
    # without the attributes — duck-typed or pre-prewarm-era objects —
    # contribute zeros instead of raising), and record the subset size so
    # a mixed prewarm-on/off merge stays distinguishable from all-on
    prewarm_batches = sum(1 for r in reports if _carried_prewarm(r))
    cache_batches = sum(1 for r in reports if _carried_cache(r))
    extras = {"num_batches": len(reports),
              "prewarm_batches": prewarm_batches,
              "cache_batches": cache_batches}
    if wall_clock_s is not None:
        extras["wall_clock_s"] = float(wall_clock_s)
    return ExecutionReport(
        billed_cost=float(sum(r.billed_cost for r in reports)),
        latency_s=total_lat,
        throughput_tps=n_tok / max(wall, 1e-9),
        layer_cost=np.sum([r.layer_cost for r in reports], axis=0),
        layer_latency=np.sum([r.layer_latency for r in reports], axis=0),
        mem_overrun=np.any([r.mem_overrun for r in reports], axis=0),
        payload_violation=np.any([r.payload_violation for r in reports],
                                 axis=0),
        real_demand=np.sum([r.real_demand for r in reports], axis=0),
        min_mem_required_mb=np.max([r.min_mem_required_mb for r in reports],
                                   axis=0),
        backend=backend, num_tokens=n_tok,
        cold_starts=int(sum(r.cold_starts for r in reports)),
        cold_start_s=float(sum(r.cold_start_s for r in reports)),
        retries=int(sum(r.retries for r in reports)),
        retry_s=float(sum(r.retry_s for r in reports)),
        queue_delay_s=float(sum(r.queue_delay_s for r in reports)),
        stragglers=int(sum(r.stragglers for r in reports)),
        prewarm_hits=int(sum(getattr(r, "prewarm_hits", 0)
                             for r in reports)),
        prewarm_misses=int(sum(getattr(r, "prewarm_misses", 0)
                               for r in reports)),
        wasted_prewarm_gb_s=float(sum(getattr(r, "wasted_prewarm_gb_s",
                                              0.0) for r in reports)),
        # the cache block merges the same way (getattr-defaults so
        # pre-cache-era / duck-typed reports contribute zeros). Counters
        # sum; packed_experts is a GAUGE (end-of-window residency), so
        # the merge keeps the maximum rather than a meaningless sum.
        cache_hits=int(sum(getattr(r, "cache_hits", 0)
                           for r in reports)),
        cache_swaps=int(sum(getattr(r, "cache_swaps", 0)
                            for r in reports)),
        swap_gb_s=float(sum(getattr(r, "swap_gb_s", 0.0)
                            for r in reports)),
        packed_experts=int(max(getattr(r, "packed_experts", 0)
                               for r in reports)),
        cache_keepalive_gb_s=float(sum(getattr(r, "cache_keepalive_gb_s",
                                               0.0) for r in reports)),
        # tenants is conditional like prewarm/cache: tenant-less merges
        # produce {} and serialize without the block
        tenants=_merge_tenants(reports),
        extras=extras,
    )


class SimulatorBackend:
    """Bills a plan at real routed counts via :class:`ServerlessSimulator`.

    ``demand_fn(tokens) -> (L, E)`` supplies ground-truth routing for a
    token batch (e.g. ``ServerlessMoERuntime.real_demand``); workloads
    that already carry ``real_demand`` don't need it.
    """

    name = "simulator"

    def __init__(self, profile: ModelProfile, platform: PlatformSpec, *,
                 jitter: float = 0.0, seed: int = 0,
                 faults: Optional[FaultProfile] = None,
                 demand_fn: Optional[Callable[[np.ndarray], np.ndarray]]
                 = None):
        self.profile = profile
        self.platform = platform
        self.jitter = jitter
        self.seed = seed
        self.faults = faults
        self.demand_fn = demand_fn

    def _make_sim(self) -> ServerlessSimulator:
        return ServerlessSimulator(self.profile, self.platform,
                                   jitter=self.jitter, seed=self.seed,
                                   faults=self.faults)

    def _batch_demand(self, workload: Workload,
                      batch: np.ndarray) -> np.ndarray:
        if workload.real_demand is not None:
            # workload-level ground truth: each batch carries its token
            # share, so per-batch overrun/payload feedback stays honest
            # for unequal batch sizes
            share = np.asarray(batch).size / max(workload.num_tokens, 1)
            return np.asarray(workload.real_demand, float) * share
        if self.demand_fn is None:
            raise ValueError(
                "SimulatorBackend needs workload.real_demand or a "
                "demand_fn to derive ground-truth routing")
        return self.demand_fn(batch)

    def execute_batches(self, plan: DeploymentPlan,
                        workload: Workload) -> List[ExecutionReport]:
        """One report per workload batch (a fresh simulator instance per
        call, jitter seeded once — matching one platform-noise draw per
        invocation wave)."""
        sim = self._make_sim()
        return [sim.run(plan, self._batch_demand(workload, b),
                        int(np.asarray(b).size))
                for b in workload.batches]

    def execute(self, plan: DeploymentPlan,
                workload: Workload) -> ExecutionReport:
        return _merge_reports(self.execute_batches(plan, workload),
                              backend=self.name)

    def execute_trace(self, plan: DeploymentPlan, trace, *,
                      predictor=None,
                      prewarm: Optional[str] = None,
                      cache=None) -> List[ExecutionReport]:
        """Bill one plan window-by-window over a :class:`repro.traces.Trace`
        (one fresh jitter/fault stream for the whole trace, one report per
        window — the granularity re-planning loops consume). ``predictor``
        / ``prewarm`` / ``cache`` thread through to
        :func:`run_plan_over_trace`."""
        return run_plan_over_trace(plan, trace, self._make_sim(),
                                   self.profile, self.platform,
                                   predictor=predictor,
                                   prewarm=prewarm,
                                   cache=cache)["reports"]


def _plan_fn_extra_kw(plan_fn, delta, planning_budget_s) -> dict:
    """Keyword arguments an incremental-aware ``plan_fn`` can consume.

    ``delta`` / ``budget_s`` are forwarded only when the callable's
    signature accepts them (directly or via ``**kwargs``), so plain
    ``demand -> plan`` callables keep working unmodified. Wrapped
    callables are sniffed through: ``functools.partial`` chains and
    ``__wrapped__`` decorators are unwrapped explicitly (not just via
    ``inspect.signature``'s own following, which a ``partial`` over a
    builtin or an unhinted C callable can defeat), ``VAR_KEYWORD``
    counts as accepting, and a keyword already PINNED by a partial
    (``partial(fn, delta=0.2)``) is never clobbered — the caller bound
    it on purpose; forwarding it again would raise ``TypeError`` on
    Python's duplicate-keyword rule or silently override the binding.
    """
    if delta is None and planning_budget_s is None:
        return {}
    import functools
    import inspect
    pinned: set = set()
    fn = plan_fn
    for _ in range(32):      # bounded unwrap: partial chains + decorators
        if isinstance(fn, functools.partial):
            pinned.update(fn.keywords)
            fn = fn.func
        elif hasattr(fn, "__wrapped__"):
            fn = fn.__wrapped__
        else:
            break
    params = None
    for candidate in (plan_fn, fn):
        try:
            params = inspect.signature(candidate).parameters
            break
        except (TypeError, ValueError):
            continue
    if params is None:
        return {}
    var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                 for p in params.values())

    def _accepts(name: str) -> bool:
        if name in pinned:
            return False
        if name in params:
            return params[name].kind not in (
                inspect.Parameter.POSITIONAL_ONLY,
                inspect.Parameter.VAR_POSITIONAL)
        return var_kw

    kw = {}
    if delta is not None and _accepts("delta"):
        kw["delta"] = delta
    if planning_budget_s is not None and _accepts("budget_s"):
        kw["budget_s"] = planning_budget_s
    return kw


def run_plan_over_trace(plan: DeploymentPlan, trace,
                        sim: ServerlessSimulator, profile: ModelProfile,
                        platform: PlatformSpec, *,
                        plan_fn: Optional[Callable[[np.ndarray],
                                                   DeploymentPlan]] = None,
                        alpha: float = 2.0,
                        predictor=None,
                        prewarm: Optional[str] = None,
                        cache=None,
                        delta: Optional[float] = None,
                        planning_budget_s: Optional[float] = None) -> dict:
    """Drive a deployment through a demand trace window-by-window.

    The single implementation of the trace-feedback loop, shared by
    ``SimulatorBackend.execute_trace``, ``ServerlessMoERuntime.run_trace``,
    and ``benchmarks/fault_scenarios.py``. Each window executes on ``sim``
    under the current plan; with a ``plan_fn`` (demand -> plan), the
    window's failure feedback (Alg. 2 cases i/ii via
    :func:`~repro.core.deployment.apply_failure_feedback`) bumps replicas
    and — when feedback fired — re-plans, keeping the feedback-boosted
    replicas as a floor. Without a ``plan_fn`` the initial plan is pinned
    (the static baseline).

    **Online prediction** (``predictor``, an
    :class:`~repro.predict.online.OnlinePredictor`): each window's
    observed routing streams into the predictor (``update_demand`` +
    ``advance``, so decay tracks drift), re-plans consume the predictor's
    FORECAST demand instead of the oracle's observed demand, and the
    realized per-window prediction errors are returned under
    ``"prediction_errors"`` — the real (not synthetic) error signal the
    BO feedback set L consumes.

    **Speculative pre-warming** (``prewarm``): ``"predicted"`` warms the
    plan's replicas for every expert the forecast expects traffic on
    (requires ``predictor``; the first window, with no forecast yet, runs
    unwarmed), ``"oracle"`` warms from the window's true demand (the
    perfect-foresight bound), ``None`` disables (bit-identical to the
    pre-prewarm loop). Hits/misses/wasted GB-seconds land in each
    window's report.

    **Expert-weight caching** (``cache``): a
    :class:`repro.expcache.ContainerCacheModel` (resident-weight state
    persists across the whole trace), or a policy name
    (``"lru"``/``"predictor"``) to build one from the initial plan. The
    predictor policy is fed each window's demand forecast before the
    window executes, so evictions/swap targets track predicted drift.
    ``None`` disables (bit-identical to the cache-less loop). When a
    re-plan changes replicas or memory, the cache fleet is re-sized to
    the new plan (:meth:`~repro.expcache.ContainerCacheModel.
    resize_to_plan`) while preserving resident-expert state — fleet
    bounds and byte capacity track the DEPLOYED plan, not the initial
    one.

    **Incremental re-planning** (``delta``, ``planning_budget_s``):
    with ``delta`` set, each feedback-triggered re-plan first computes
    per-layer drift (:func:`repro.plan.incremental.layer_drift`)
    between the serving plan's ``demand`` and the new re-plan demand.
    If ``delta > 0`` and NO layer drifts beyond it, the re-plan is
    skipped entirely (the feedback-adjusted replicas still apply).
    Otherwise ``plan_fn`` runs — and an incremental-aware planner
    (e.g. :class:`~repro.plan.incremental.IncrementalODSPlanner`, or
    any callable accepting ``delta=``/``budget_s=`` keywords) receives
    the threshold and the per-window planning budget so it can re-solve
    only shifted layers. ``delta=0`` forces a full re-solve on every
    feedback window — bit-identical to the historical loop — and
    ``delta=None`` (default) forwards nothing. Per-window planning
    wall-clock is always recorded under ``"planning_s"``.

    NOTE on ``replan_diff`` cost deltas: a plan's ``layer_cost`` is
    always the PLANNER'S estimate at plan time (as everywhere else in
    Alg. 2 — replica floors from feedback are never re-costed); the
    realized cost of a window lives in its ``ExecutionReport``.

    Returns ``{"reports", "plans", "final_plan", "replans",
    "prediction_errors", "planning_s", "replans_skipped"}``: one report
    per window, the plan that served each window, the plan left
    deployed, how many windows triggered a re-plan, one error dict per
    forecasted window, per-window planning seconds (0.0 where no
    planner ran), and how many feedback windows skipped re-planning on
    sub-``delta`` drift.
    """
    if prewarm not in (None, "predicted", "oracle"):
        raise ValueError(f"unknown prewarm mode {prewarm!r}")
    if prewarm == "predicted" and predictor is None:
        raise ValueError("prewarm='predicted' needs an online predictor")
    if isinstance(cache, str):
        raise NotImplementedError(
            f"cache={cache!r} needs repro.expcache, which is not ported yet "
            "(ROADMAP.md, Queue A item 1); pass a cache model object")
    if delta is not None and delta > 0:
        raise NotImplementedError(
            "delta > 0 needs plan/incremental.py (layer_drift), which is "
            "not ported yet (ROADMAP.md, Queue A item 1)")
    from repro_torch.predict import demand_error, prewarm_containers
    plan_kw = _plan_fn_extra_kw(plan_fn, delta, planning_budget_s) \
        if plan_fn is not None else {}
    reports: List[ExecutionReport] = []
    plans: List[DeploymentPlan] = []
    prediction_errors: List[dict] = []
    planning_s: List[float] = []
    replans = 0
    replans_skipped = 0
    cur = plan
    windows = list(trace.windows)
    for i, w in enumerate(windows):
        plans.append(cur)
        forecast = predictor.forecast_demand(w.num_tokens) \
            if predictor is not None else None
        pw = None
        if prewarm == "oracle":
            pw = prewarm_containers(cur, w.demand)
        elif prewarm == "predicted" and forecast is not None:
            pw = prewarm_containers(cur, forecast)
        if cache is not None:
            cache.update_forecast(forecast)
            rep = sim.run(cur, w.demand, int(w.num_tokens), prewarm=pw,
                          cache=cache)
        else:
            rep = sim.run(cur, w.demand, int(w.num_tokens), prewarm=pw)
        reports.append(rep)
        if predictor is not None:
            if forecast is not None:
                prediction_errors.append(
                    demand_error(forecast, rep.real_demand))
            predictor.update_demand(rep.real_demand, int(w.num_tokens))
            predictor.advance()
        if plan_fn is None:
            planning_s.append(0.0)
            continue
        adjusted, rho_case, _ = apply_failure_feedback(
            cur, rep.real_demand, profile, platform, alpha=alpha)
        if rho_case < 3:
            # cases (i)/(ii): the plan's sizing was wrong for what the
            # window actually routed — re-plan from the online
            # predictor's (post-update) forecast when one is running,
            # else from the oracle's observed demand
            replan_demand = rep.real_demand
            if predictor is not None:
                # the re-plan serves the UPCOMING window: scale the
                # forecast rates to the next window's token count (the
                # just-served w.num_tokens is already history after
                # advance()); the last window has no successor, so its
                # own count is the only scale left
                nxt = int(windows[i + 1].num_tokens) \
                    if i + 1 < len(windows) else int(w.num_tokens)
                f = predictor.forecast_demand(nxt)
                if f is not None:
                    replan_demand = f
            t_plan = time.perf_counter()
            fresh = plan_fn(replan_demand, **plan_kw)
            planning_s.append(time.perf_counter() - t_plan)
            fresh.replicas = np.maximum(fresh.replicas, adjusted.replicas)
            fresh.metadata["replan_diff"] = plan_diff(cur, fresh)
            cur = fresh
            replans += 1
            if cache is not None:
                # a re-plan changed replicas/memory: the cache fleet's
                # bounds and byte capacity must track the DEPLOYED plan
                cache.resize_to_plan(cur)
        else:
            planning_s.append(0.0)
            cur = adjusted
    return {"reports": reports, "plans": plans, "final_plan": cur,
            "replans": replans, "prediction_errors": prediction_errors,
            "planning_s": planning_s, "replans_skipped": replans_skipped}


class ServingBackend:
    """Executes a plan against LIVE traffic on a ``ServingEngine``.

    The workload's batches are submitted as requests (1-D rows = one
    ragged prompt each); the engine decodes them with continuous
    batching while expert telemetry records the routing every served
    token actually took. Decode steps are grouped into dispatch rounds
    of the plan's chunk schedule (the scatter-gather minibatch size of
    Eq. 6), and the measured (L, E) demand is billed under the plan's
    per-layer comm methods. The report's ``extras`` carry the serving
    half: wall-clock, TTFT, finish reasons, and the per-round token
    counts of the chunk schedule.
    """

    name = "serving"

    def __init__(self, engine, profile: ModelProfile,
                 platform: PlatformSpec, *, jitter: float = 0.0,
                 seed: int = 0, max_steps: int = 256):
        if getattr(engine, "telemetry", None) is None:
            raise ValueError(
                "ServingBackend needs an engine with expert telemetry "
                "(an MoE model and collect_telemetry=True)")
        self.engine = engine
        self.profile = profile
        self.platform = platform
        self.jitter = jitter
        self.seed = seed
        self.max_steps = max_steps
        self.last_requests: List = []    # Request objects of the last execute

    @staticmethod
    def _rows(workload: Workload):
        for batch in workload.batches:
            arr = np.asarray(batch)
            yield from (arr[None] if arr.ndim == 1 else arr)

    def execute(self, plan: DeploymentPlan,
                workload: Workload) -> ExecutionReport:
        reqs = [self.engine.submit(row,
                                   max_new_tokens=workload.max_new_tokens)
                for row in self._rows(workload)]
        return self._serve_and_bill(plan, reqs)

    def execute_requests(self, plan: DeploymentPlan,
                         requests: Sequence) -> ExecutionReport:
        """Serve a timed arrival schedule (:class:`repro.traces.TraceRequest`
        objects with ``arrival_step``/``prompt``/``max_new_tokens``) under
        the plan: requests are admitted by the engine as their arrival
        step comes due, so bursty/diurnal traces exercise mid-stream
        admission, and the measured routing is billed under the plan."""
        return self._serve_and_bill(plan, [], arrivals=list(requests))

    def _serve_and_bill(self, plan: DeploymentPlan, reqs: List, *,
                        arrivals: Optional[List] = None) -> ExecutionReport:
        eng, tel = self.engine, self.engine.telemetry
        base_demand = tel.demand_matrix()
        base_tokens = tel.total_tokens
        t0 = time.perf_counter()

        # --- serve, segmented into the plan's scatter-gather rounds ------
        chunk_tokens = ChunkPlan.from_plan(plan).round_tokens()
        rounds: List[dict] = []
        steps = 0

        def _count(engine, step):
            nonlocal steps
            steps = step

        finished = eng.run(max_steps=self.max_steps, on_step=_count,
                           round_tokens=chunk_tokens,
                           on_round=lambda engine, info: rounds.append(info),
                           arrivals=arrivals)
        reqs = reqs if reqs else finished
        self.last_requests = reqs
        wall_s = time.perf_counter() - t0

        # --- bill the measured routing under the plan's comm design ------
        measured = tel.demand_matrix() - base_demand
        n_tokens = tel.total_tokens - base_tokens
        sim = ServerlessSimulator(self.profile, self.platform,
                                  jitter=self.jitter, seed=self.seed)
        rep = sim.run(plan, measured, n_tokens)
        rep.backend = self.name
        ttfts = [r.ttft_s for r in reqs if r.ttft_s is not None]
        rep.extras = {
            "wall_s": wall_s,
            "decode_steps": steps,
            "requests": len(reqs),
            "finish_reasons": [r.finish_reason for r in reqs],
            "served_tps": n_tokens / max(wall_s, 1e-9),
            "mean_ttft_s": float(np.mean(ttfts)) if ttfts else None,
            "dispatch_rounds": rounds,
            "chunk_tokens": chunk_tokens,
        }
        return rep


# --------------------------------------------------------------- registry
# Mirrors the planner registry (repro.plan.planner): backends resolve by
# name so configs/CLIs say "simulator" | "serving" | "distributed" and the
# runtime seam stays string-driven.

_BACKENDS: Dict[str, Callable[..., ExecutionBackend]] = {}


def register_backend(name: str,
                     factory: Optional[Callable[..., ExecutionBackend]]
                     = None):
    """Register a backend factory; usable as a decorator."""
    def _register(f):
        _BACKENDS[name] = f
        return f
    return _register(factory) if factory is not None else _register


def get_backend(name: str, **kwargs) -> ExecutionBackend:
    if name not in _BACKENDS:
        raise KeyError(f"unknown backend {name!r}; "
                       f"available: {available_backends()}")
    return _BACKENDS[name](**kwargs)


def available_backends() -> tuple:
    return tuple(sorted(_BACKENDS))


def _distributed_backend(**kwargs) -> ExecutionBackend:
    raise NotImplementedError(
        "the distributed backend needs repro.dist, which is not ported yet "
        "(ROADMAP.md, Queue A item 1)")


register_backend("simulator", SimulatorBackend)
register_backend("serving", ServingBackend)
register_backend("distributed", _distributed_backend)
