"""Planner protocol + registry: one ``plan()`` signature for every

A copy of ``repro.plan.planner`` (numpy only): the port imports
nothing of the reference package.

deployment strategy in the paper.

Every planner maps ``(demand, profile, platform)`` to a
:class:`~repro.plan.schema.DeploymentPlan`:

* ``ods`` — the paper's Alg. 1: per-method exact solvers mixed across
  layers under the SLO (the runtime's default).
* ``fixed-1`` / ``fixed-2`` / ``fixed-3`` — one comm design forced on all
  layers (the per-method MIQCP subproblem solved exactly).
* ``lambdaml`` — max memory, no replicas, storage relay (§V-G baseline).
* ``random`` — random comm method per layer (§V-D baseline).
* ``bo`` — the full Alg. 2 loop: refine the KV table by Bayesian
  optimization (the eval function runs plans through an
  :class:`~repro.plan.backends.ExecutionBackend`), then plan from the
  refined predictor. Requires construction kwargs (``table``,
  ``eval_fn``); see :class:`BOPlanner`.
* ``ods-cached`` — wraps an inner planner (default ``ods``) and
  grid-searches the expert-weight cache dimensions (container weight
  capacity x packing degree) by simulated execution, stamping the best
  :class:`~repro.expcache.CacheConfig` into ``plan.metadata["cache"]``
  (resolved lazily from :mod:`repro.expcache.planner`).

New strategies register with :func:`register_planner` and become
available to the runtime, benchmarks, and examples by name.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Protocol, Sequence, \
    runtime_checkable

import numpy as np

from repro_torch.core import comm
from repro_torch.core.bo import BOOptimizer, BOResult
from repro_torch.core.costmodel import ModelProfile, PlatformSpec
from repro_torch.core.deployment import (MethodSolution, lambdaml_policy, ods,
                                         random_policy, solve_fixed_method)
from repro_torch.plan.schema import DeploymentPlan

INF = float("inf")


@runtime_checkable
class Planner(Protocol):
    """Anything that turns predicted demand into a deployment plan."""

    name: str

    def plan(self, demand: np.ndarray, profile: ModelProfile,
             platform: PlatformSpec, *, t_limit_s: float = INF,
             seed: int = 0) -> DeploymentPlan:
        ...


def _tag(plan: DeploymentPlan, name: str) -> DeploymentPlan:
    plan.planner = name
    return plan


class ODSPlanner:
    """Alg. 1: solve each fixed-method subproblem exactly, mix per layer."""

    name = "ods"

    def __init__(self, methods: Sequence[int] = comm.METHODS):
        self.methods = tuple(methods)

    def solutions(self, demand: np.ndarray, profile: ModelProfile,
                  platform: PlatformSpec) -> Dict[int, MethodSolution]:
        return {a: solve_fixed_method(a, demand, profile, platform)
                for a in self.methods}

    def plan(self, demand: np.ndarray, profile: ModelProfile,
             platform: PlatformSpec, *, t_limit_s: float = INF,
             seed: int = 0) -> DeploymentPlan:
        sols = self.solutions(demand, profile, platform)
        return _tag(ods(sols, demand, profile, platform,
                        t_limit_s=t_limit_s), self.name)


class FixedMethodPlanner:
    """One comm design for every layer (the per-method exact solver)."""

    def __init__(self, method: int):
        assert method in comm.METHODS, method
        self.method = method
        self.name = f"fixed-{method}"

    def plan(self, demand: np.ndarray, profile: ModelProfile,
             platform: PlatformSpec, *, t_limit_s: float = INF,
             seed: int = 0) -> DeploymentPlan:
        demand = np.asarray(demand, float)
        sol = solve_fixed_method(self.method, demand, profile, platform)
        L = demand.shape[0]
        overhead = (profile.t_head_s + profile.t_tail_s
                    + L * profile.t_nonmoe_s)
        total_lat = overhead + float(sol.layer_latency.sum())
        # infeasible layers keep their infinite cost: a fixed-method plan
        # that cannot satisfy (12c)/(12f) must not look cheap
        return _tag(DeploymentPlan(
            method=np.full(L, self.method, np.int64), beta=sol.beta,
            mem_mb=sol.mem_mb, replicas=sol.replicas, demand=demand,
            layer_cost=sol.layer_cost, layer_latency=sol.layer_latency,
            meets_slo=bool(total_lat <= t_limit_s
                           and sol.feasible.all())), self.name)


class LambdaMLPlanner:
    name = "lambdaml"

    def plan(self, demand, profile, platform, *, t_limit_s: float = INF,
             seed: int = 0) -> DeploymentPlan:
        return _tag(lambdaml_policy(demand, profile, platform), self.name)


class RandomPlanner:
    name = "random"

    def plan(self, demand, profile, platform, *, t_limit_s: float = INF,
             seed: int = 0) -> DeploymentPlan:
        return _tag(random_policy(demand, profile, platform, seed=seed),
                    self.name)


class BOPlanner:
    """Alg. 2 behind the ``Planner`` protocol.

    The BO loop's black box is supplied as ``eval_fn(table) ->
    EvalOutcome`` — built by the runtime from an ``ExecutionBackend`` so
    every trial's plan is executed (simulated) through the same seam as
    production plans. After BO converges, the best table's predictor
    re-estimates demand over ``tokens`` (when given) and the ``inner``
    planner produces the final plan.

    **Warm-starting (default on).** Repeated ``plan()`` calls on the
    same planner instance — the shape of a re-planning trace loop —
    automatically thread ``last_result`` into the next search via
    ``BOOptimizer.run(resume_from=...)``: the GP surrogate, epsilon
    schedule, and feedback set L all carry over, so a window's search
    refines the previous window's instead of restarting cold.
    ``warm_start=False`` restores the historical independent-run
    behavior. The first ``plan()`` call is identical either way.
    """

    name = "bo"

    def __init__(self, table=None, eval_fn=None, *, top_k: int = 1,
                 demand_mode: str = "expected",
                 tokens: Optional[np.ndarray] = None,
                 inner: Optional[Planner] = None,
                 warm_start: bool = True, **bo_kwargs):
        if table is None or eval_fn is None:
            raise ValueError(
                "BOPlanner needs a profiled KVTable and an eval_fn: "
                "get_planner('bo', table=..., eval_fn=...) — or use "
                "ServerlessMoERuntime.bo_planner(), which wires both to "
                "the simulator backend")
        self.table = table
        self.eval_fn = eval_fn
        self.top_k = top_k
        self.demand_mode = demand_mode
        self.tokens = tokens
        self.inner = inner or ODSPlanner()
        self.warm_start = warm_start
        self.bo_kwargs = dict(bo_kwargs)
        self.last_result: Optional[BOResult] = None
        self._plan_calls = 0

    def plan(self, demand: np.ndarray, profile: ModelProfile,
             platform: PlatformSpec, *, t_limit_s: float = INF,
             seed: int = 0) -> DeploymentPlan:
        from repro_torch.core.predictor import ExpertPredictor
        kw = dict(self.bo_kwargs)
        resume = self.last_result if self.warm_start else None
        # resumed searches get a fresh exploration stream per window
        # (same seed would replay the previous window's proposals);
        # the first call keeps the historical seed exactly
        kw.setdefault("seed", seed + (self._plan_calls
                                      if resume is not None else 0))
        res = BOOptimizer(self.table, self.eval_fn,
                          **kw).run(resume_from=resume)
        self.last_result = res
        self._plan_calls += 1
        if self.tokens is not None:
            pred = ExpertPredictor(res.best_table, top_k=self.top_k).fit()
            demand = pred.predict_demand(self.tokens, mode=self.demand_mode)
        plan = self.inner.plan(demand, profile, platform,
                               t_limit_s=t_limit_s, seed=seed)
        plan.metadata["bo"] = {"best_cost": res.best_cost,
                               "iterations": res.iterations,
                               "converged": res.converged,
                               "warm_started": resume is not None,
                               "seeded_trials": res.seeded_trials}
        return _tag(plan, self.name)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., Planner]] = {}


def register_planner(name: str, factory: Optional[Callable[..., Planner]]
                     = None):
    """Register a planner factory; usable as a decorator."""
    def _register(f):
        _REGISTRY[name] = f
        return f
    return _register(factory) if factory is not None else _register


def get_planner(name: str, **kwargs) -> Planner:
    if name not in _REGISTRY:
        raise KeyError(f"unknown planner {name!r}; "
                       f"available: {available_planners()}")
    return _REGISTRY[name](**kwargs)


def available_planners() -> tuple:
    return tuple(sorted(_REGISTRY))


def _not_ported(what: str, module: str):
    """Factory for a planner whose module the port does not have yet."""
    def factory(**kwargs) -> Planner:
        raise NotImplementedError(
            f"the {what} planner needs {module}, which is not ported yet "
            "(ROADMAP.md, Queue A item 1)")
    return factory


_cache_aware_planner = _not_ported("cache-aware", "repro.expcache")
_incremental_planner = _not_ported("incremental ODS", "plan/incremental.py")
_tenant_planner = _not_ported("multi-tenant", "plan/tenancy.py")


register_planner("ods", ODSPlanner)
for _m in comm.METHODS:
    register_planner(f"fixed-{_m}",
                     lambda method=_m, **kw: FixedMethodPlanner(method, **kw))
register_planner("lambdaml", LambdaMLPlanner)
register_planner("random", RandomPlanner)
register_planner("bo", BOPlanner)
register_planner("ods-cached", _cache_aware_planner)
register_planner("ods-incremental", _incremental_planner)
register_planner("ods-tenant", _tenant_planner)
