"""The paper's contribution: serverless MoE deployment optimization.

The exports of ``repro.core``, from the port's own copies of its modules
(numpy only): the port imports nothing of the reference package.

Pipeline: profile routing -> Bayesian expert-selection prediction (Eq. 1-2)
-> comm-design time models (Eq. 3-11) -> per-method deployment solver + ODS
(Alg. 1) -> BO with multi-dimensional epsilon-greedy search (Alg. 2), with
the serverless simulator standing in for AWS Lambda.

Planning and execution speak the ``repro.plan`` API: planners produce a
serializable ``DeploymentPlan``, execution backends return a common
``ExecutionReport`` — both re-exported here (lazily, since the plan
modules import this package's solvers). ``ServerlessMoERuntime``
(``repro_torch.core.runtime``) composes the stages around the port's
model and is not imported here, so this package stays numpy-only.
"""
from typing import TYPE_CHECKING

from repro_torch.core.bo import BOOptimizer, BOResult, EvalOutcome
from repro_torch.core.costmodel import CPUClusterSpec, ModelProfile, PlatformSpec
from repro_torch.core.deployment import (DeploymentPolicy, MethodSolution,
                                         apply_failure_feedback, lambdaml_policy,
                                         ods, random_policy, solve_fixed_method)
from repro_torch.core.predictor import ExpertPredictor
# the streaming predictor + prewarm helpers live in repro.predict; the
# two most-used names are re-exported here for convenience (submodule
# imports — the repro.predict package itself imports repro.core.features,
# so importing the predict PACKAGE here would be circular)
from repro_torch.predict.online import OnlinePredictor
from repro_torch.predict.prewarm import prewarm_containers
from repro_torch.core.simulator import (FaultProfile, InvocationEvent,
                                        ServerlessSimulator, SimResult,
                                        cpu_cluster_result)
from repro_torch.core.table import KVTable
# DeploymentPlan et al. come from the dependency-light schema module; the
# planner registry and backends are re-exported lazily below (they import
# repro.core themselves, so an eager import here would be circular).
from repro_torch.plan.schema import (DeploymentPlan, ExecutionReport, Workload,
                                     plan_diff)

__all__ = [
    # cost/platform models
    "CPUClusterSpec", "ModelProfile", "PlatformSpec",
    # profiling + prediction (batch + streaming; see repro.predict)
    "KVTable", "ExpertPredictor", "OnlinePredictor", "prewarm_containers",
    # deployment solvers (Alg. 1) + failure feedback (Alg. 2 lines 10-21)
    "MethodSolution", "DeploymentPolicy", "ods", "solve_fixed_method",
    "lambdaml_policy", "random_policy", "apply_failure_feedback",
    # simulation + BO (Alg. 2)
    "ServerlessSimulator", "SimResult", "cpu_cluster_result",
    "FaultProfile", "InvocationEvent",
    "BOOptimizer", "BOResult", "EvalOutcome",
    # plan API
    "DeploymentPlan", "ExecutionReport", "Workload", "plan_diff",
    "Planner", "get_planner", "register_planner", "available_planners",
    "ExecutionBackend", "SimulatorBackend",
]

# resolved through repro.plan's own lazy loader so the name->module map
# lives in exactly one place (repro/plan/__init__.py)
_PLAN_EXPORTS = frozenset({
    "Planner", "get_planner", "register_planner", "available_planners",
    "ExecutionBackend", "SimulatorBackend",
})

if TYPE_CHECKING:   # pragma: no cover — static-analysis-only eager imports
    from repro_torch.plan.backends import (ExecutionBackend,  # noqa: F401
                                           SimulatorBackend)
    from repro_torch.plan.planner import (Planner, available_planners,  # noqa: F401
                                          get_planner, register_planner)


def __getattr__(name: str):
    if name in _PLAN_EXPORTS:
        import importlib
        return getattr(importlib.import_module("repro_torch.plan"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(__all__) | set(globals()))
