"""Unified planning/execution API: serializable plans, pluggable backends.

``DeploymentPlan`` (the versioned JSON artifact) flows from any
registered ``Planner`` into any ``ExecutionBackend``; both ends return
typed objects (``DeploymentPlan`` / ``ExecutionReport``) so planners,
backends, and the BO loop compose without knowing each other's
internals.

The exports of ``repro.plan`` that the port has: ``plan/incremental.py``
and ``plan/tenancy.py`` are not ported yet (ROADMAP.md, Queue A item 1).

Attribute access is lazy (PEP 562) so ``repro.core`` and
``repro.serving`` can each import the pieces they need without cycles.
"""
from typing import TYPE_CHECKING

__all__ = [
    "DeploymentPlan", "ExecutionReport", "Workload", "plan_diff",
    "PLAN_VERSION",
    "Planner", "ODSPlanner", "FixedMethodPlanner", "LambdaMLPlanner",
    "RandomPlanner", "BOPlanner",
    "register_planner", "get_planner", "available_planners",
    "ExecutionBackend", "SimulatorBackend", "ServingBackend",
    "register_backend", "get_backend", "available_backends",
    "run_plan_over_trace",
]

_LOCATIONS = {
    "run_plan_over_trace": "repro_torch.plan.backends",
    "DeploymentPlan": "repro_torch.plan.schema",
    "ExecutionReport": "repro_torch.plan.schema",
    "Workload": "repro_torch.plan.schema",
    "plan_diff": "repro_torch.plan.schema",
    "PLAN_VERSION": "repro_torch.plan.schema",
    "Planner": "repro_torch.plan.planner",
    "ODSPlanner": "repro_torch.plan.planner",
    "FixedMethodPlanner": "repro_torch.plan.planner",
    "LambdaMLPlanner": "repro_torch.plan.planner",
    "RandomPlanner": "repro_torch.plan.planner",
    "BOPlanner": "repro_torch.plan.planner",
    "register_planner": "repro_torch.plan.planner",
    "get_planner": "repro_torch.plan.planner",
    "available_planners": "repro_torch.plan.planner",
    "ExecutionBackend": "repro_torch.plan.backends",
    "SimulatorBackend": "repro_torch.plan.backends",
    "ServingBackend": "repro_torch.plan.backends",
    "register_backend": "repro_torch.plan.backends",
    "get_backend": "repro_torch.plan.backends",
    "available_backends": "repro_torch.plan.backends",
}

if TYPE_CHECKING:   # pragma: no cover — static-analysis-only eager imports
    from repro_torch.plan.backends import (ExecutionBackend,  # noqa: F401
                                           ServingBackend, SimulatorBackend,
                                           available_backends, get_backend,
                                           register_backend)
    from repro_torch.plan.planner import (BOPlanner, FixedMethodPlanner,  # noqa: F401
                                          LambdaMLPlanner, ODSPlanner, Planner,
                                          RandomPlanner, available_planners,
                                          get_planner, register_planner)
    from repro_torch.plan.schema import (PLAN_VERSION, DeploymentPlan,  # noqa: F401
                                         ExecutionReport, Workload, plan_diff)


def __getattr__(name: str):
    if name in _LOCATIONS:
        import importlib
        return getattr(importlib.import_module(_LOCATIONS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
