"""Optimal MoE deployment (paper §III-D Eq. 12 + §IV-A Alg. 1).

A copy of ``repro.core.deployment`` (numpy only): the port imports
nothing of the reference package.

Given predicted per-expert token demand, the problem jointly chooses per-
expert memory size x, replica count y, per-layer comm method a and global
pipeline degree beta, minimizing total billed cost subject to memory
(12c), SLO (12d) and payload (12f) constraints.

The paper solves three MIQCPs (method fixed) with Gurobi. Gurobi is not
available offline; instead we exploit the problem's structure: with the
method and beta fixed, the cost objective is SEPARABLE per expert (the SLO
couples layers, which is exactly what ODS handles), so each expert's
(memory, replicas) pair can be optimized exactly by enumerating the
14 x G grid. This yields the true optimum of each per-method subproblem
(not an approximation), and ODS then mixes methods across layers under the
SLO exactly as Alg. 1 prescribes.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import comm
from repro_torch.core.costmodel import MB, ModelProfile, PlatformSpec
from repro_torch.plan.schema import DeploymentPlan

INF = float("inf")

# The deployment artifact is the serializable DeploymentPlan from
# repro.plan.schema; DeploymentPolicy remains as the historical alias.
DeploymentPolicy = DeploymentPlan


@dataclass
class MethodSolution:
    """Optimal deployment for one fixed comm method (all layers)."""

    method: int
    beta: int
    mem_mb: np.ndarray        # (L, E)
    replicas: np.ndarray      # (L, E) int
    layer_cost: np.ndarray    # (L,) c_{a,e}
    layer_latency: np.ndarray  # (L,) t^lat_{a,e}
    feasible: np.ndarray      # (L,) bool


def _per_expert_rep_time(method: int, r: np.ndarray, t_cal: np.ndarray,
                         beta: int, prof: ModelProfile,
                         spec: PlatformSpec) -> np.ndarray:
    """Vectorized per-replica time; r and t_cal broadcast together."""
    bs = spec.bw_storage_mb_s * MB
    bf = spec.bw_direct_mb_s * MB
    tdl = spec.t_storage_access_s
    t_h = comm.head_time(prof, spec)
    d_in, d_o = prof.token_in_bytes, prof.token_out_bytes
    if method == 1:
        n_mb = np.ceil(r / max(beta, 1))
        t_blk = tdl + np.maximum(beta * (d_in / bs + t_cal),
                                 beta * d_o / bs)
        return t_h + n_mb * t_blk + tdl + beta * d_o / bs
    if method == 2:
        return t_h + 2 * tdl + r * ((d_in + d_o) / bs + t_cal)
    if method == 3:
        return t_h + r * (d_o / bf + t_cal)
    raise ValueError(method)


def solve_fixed_method(
    method: int,
    demand: np.ndarray,                  # (L, E) predicted token counts
    prof: ModelProfile,
    spec: PlatformSpec,
    *,
    beta_candidates: Optional[Sequence[int]] = None,
) -> MethodSolution:
    """Exact per-expert optimum for a fixed comm method (+ beta search)."""
    demand = np.asarray(demand, float)
    L, E = demand.shape
    G = spec.max_replicas
    mems = np.asarray(spec.memory_options_mb, float)       # (M,)
    gs = np.arange(1, G + 1, dtype=float)                  # (G,)
    t_cal = comm.t_cal_per_token(prof.u_ref_s, mems, spec)  # (M,)

    if method != 1 or beta_candidates is None:
        betas = [1] if method != 1 else [1, 2, 4, 8, 16, 32, 64, 128, 256]
    else:
        betas = list(beta_candidates)

    r = demand[:, :, None] / gs[None, None, :]             # (L,E,G)
    mem_req = comm.memory_required_mb(r, prof)             # (L,E,G)
    fits = mem_req[..., None] <= mems                      # (L,E,G,M)
    if method == 3:
        fits &= (r * prof.token_in_bytes)[..., None] <= spec.payload_bytes

    best: Optional[MethodSolution] = None
    for beta in betas:
        t_rep = _per_expert_rep_time(
            method, r[..., None], t_cal[None, None, None, :], beta, prof,
            spec)                                          # (L,E,G,M)
        cost = (gs[None, None, :, None] * t_rep
                * (mems / 1024.0) * spec.price_per_gb_s)
        cost = np.where(fits & (demand[:, :, None, None] > 0), cost, INF)
        zero = demand <= 0
        flat = cost.reshape(L, E, G * len(mems))
        idx = np.argmin(flat, axis=-1)
        gi, mi = np.unravel_index(idx, (G, len(mems)))
        chosen_cost = np.take_along_axis(flat, idx[..., None], -1)[..., 0]
        chosen_cost = np.where(zero, 0.0, chosen_cost)     # (L, E)
        mem_mb = mems[mi]
        replicas = (gi + 1).astype(int)
        mem_mb = np.where(zero, mems[0], mem_mb)
        replicas = np.where(zero, 1, replicas)

        layer_cost = chosen_cost.sum(axis=-1)              # inf propagates
        layer_lat = np.empty(L)
        for e in range(L):
            times = comm.layer_times(method, demand[e] / replicas[e],
                                     replicas[e].astype(float), mem_mb[e],
                                     beta, prof, spec)
            layer_lat[e] = times.t_latency
        sol = MethodSolution(
            method=method, beta=beta, mem_mb=mem_mb, replicas=replicas,
            layer_cost=layer_cost, layer_latency=layer_lat,
            feasible=np.isfinite(layer_cost))
        if best is None or np.nansum(np.where(np.isfinite(layer_cost),
                                              layer_cost, 1e9)) < \
                np.nansum(np.where(np.isfinite(best.layer_cost),
                                   best.layer_cost, 1e9)):
            best = sol
    assert best is not None
    return best


def ods(
    solutions: Dict[int, MethodSolution],
    demand: np.ndarray,
    prof: ModelProfile,
    spec: PlatformSpec,
    *,
    t_limit_s: float,
) -> DeploymentPolicy:
    """Alg. 1: Optimal Deployment Selection.

    Mixes comm methods across layers: greedily take the per-layer cheapest
    method; while the end-to-end SLO (12d) is violated, knock out the
    (method, layer) pair with the highest latency and retry; fall back to
    the best single-method deployment after 2|E| iterations.
    """
    L = demand.shape[0]
    cost = np.stack([solutions[a].layer_cost for a in comm.METHODS])   # (3,L)
    lat = np.stack([solutions[a].layer_latency for a in comm.METHODS])
    cost = cost.copy()

    overhead = prof.t_head_s + prof.t_tail_s + L * prof.t_nonmoe_s

    for _ in range(2 * L + 1):
        if not np.isfinite(cost).any(axis=0).all():
            break                                  # some layer exhausted
        a_hat = np.argmin(cost, axis=0)            # (L,) 0-based
        tot_lat = overhead + lat[a_hat, np.arange(L)].sum()
        if tot_lat <= t_limit_s:
            return _mk_policy(a_hat, solutions, demand, cost, lat,
                              meets_slo=True)
        # line 10 (text): knock out the layer with the HIGHEST latency
        e_t = int(np.argmax(lat[a_hat, np.arange(L)]))
        cost[a_hat[e_t], e_t] = INF

    # lines 18-20: all layers forced to the single cheapest method
    totals = [np.where(np.isfinite(solutions[a].layer_cost),
                       solutions[a].layer_cost, 1e12).sum()
              for a in comm.METHODS]
    a_best = int(np.argmin(totals))
    a_hat = np.full(L, a_best, int)
    cost = np.stack([solutions[a].layer_cost for a in comm.METHODS])
    tot_lat = overhead + lat[a_hat, np.arange(L)].sum()
    return _mk_policy(a_hat, solutions, demand, cost, lat,
                      meets_slo=bool(tot_lat <= t_limit_s))


def _mk_policy(a_hat, solutions, demand, cost, lat, *, meets_slo):
    L, E = demand.shape
    mem = np.empty((L, E))
    rep = np.empty((L, E), int)
    c = np.empty(L)
    t = np.empty(L)
    beta = 1
    for e in range(L):
        sol = solutions[a_hat[e] + 1]
        mem[e] = sol.mem_mb[e]
        rep[e] = sol.replicas[e]
        c[e] = np.where(np.isfinite(cost[a_hat[e], e]),
                        cost[a_hat[e], e], 0.0)
        t[e] = lat[a_hat[e], e]
        if a_hat[e] + 1 == 1:
            beta = sol.beta
    return DeploymentPlan(
        method=a_hat + 1, beta=beta, mem_mb=mem, replicas=rep,
        demand=np.asarray(demand, float), layer_cost=c, layer_latency=t,
        meets_slo=meets_slo, planner="ods")


# ---------------------------------------------------------------------------
# Failure feedback (Alg. 2 lines 10-21)
# ---------------------------------------------------------------------------

def apply_failure_feedback(policy: DeploymentPolicy, real: np.ndarray,
                           prof: ModelProfile, spec: PlatformSpec,
                           alpha: float = 2.0
                           ) -> Tuple[DeploymentPolicy, int, np.ndarray]:
    """Adjust replica counts from real-vs-predicted routing error.

    Case (i): memory overrun -> multiply replicas until the per-replica
    working set fits the deployed memory. Case (ii): direct-transfer
    payload violation -> split until each replica's input fits the cap.
    Returns ``(policy', rho_case, problem_token_mask_layerwise)`` — the
    feedback Alg. 2's epsilon decay and limited range L consume.
    """
    rep = policy.replicas.copy().astype(int)
    L, E = real.shape
    rho_case = 3
    problem = np.zeros((L, E), bool)
    for e in range(L):
        g = np.maximum(rep[e], 1)
        r_pred = policy.demand[e] / g
        r_real = real[e] / g
        err = np.abs(r_pred - r_real) > alpha
        problem[e] = err
        m_real = comm.memory_required_mb(r_real, prof)
        over = (m_real > policy.mem_mb[e]) & (real[e] > 0)
        if over.any():                                   # case (i)
            n_new = np.ceil(m_real / np.maximum(policy.mem_mb[e], 1))
            rep[e] = np.where(over, np.minimum(
                rep[e] * n_new.astype(int), spec.max_replicas), rep[e])
            rho_case = min(rho_case, 1)
        if policy.method[e] == 3:                        # case (ii)
            bad = r_real * prof.token_in_bytes > spec.payload_bytes
            if bad.any():
                n_new = np.ceil(real[e] * prof.token_in_bytes
                                / spec.payload_bytes)
                rep[e] = np.where(bad, np.minimum(
                    n_new.astype(int), spec.max_replicas), rep[e])
                rho_case = min(rho_case, 2)
    return replace(policy, replicas=rep), rho_case, problem


# ---------------------------------------------------------------------------
# Baseline policies (paper §V-G)
# ---------------------------------------------------------------------------

def lambdaml_policy(demand: np.ndarray, prof: ModelProfile,
                    spec: PlatformSpec) -> DeploymentPolicy:
    """LambdaML: maximum memory everywhere, no replicas, storage relay."""
    L, E = demand.shape
    mem = np.full((L, E), float(spec.memory_options_mb[-1]))
    rep = np.ones((L, E), int)
    cost = np.empty(L)
    lat = np.empty(L)
    for e in range(L):
        times = comm.layer_times(2, demand[e], rep[e].astype(float), mem[e],
                                 1, prof, spec)
        cost[e] = comm.layer_billed_cost(times, mem[e], spec)
        lat[e] = times.t_latency
    return DeploymentPlan(method=np.full(L, 2), beta=1, mem_mb=mem,
                          replicas=rep, demand=np.asarray(demand, float),
                          layer_cost=cost, layer_latency=lat,
                          planner="lambdaml")


def random_policy(demand: np.ndarray, prof: ModelProfile,
                  spec: PlatformSpec, seed: int = 0) -> DeploymentPolicy:
    """Random comm method per layer, max memory, no replicas (§V-D)."""
    rng = np.random.default_rng(seed)
    L, E = demand.shape
    mem = np.full((L, E), float(spec.memory_options_mb[-1]))
    rep = np.ones((L, E), int)
    methods = rng.integers(1, 4, size=L)
    cost = np.empty(L)
    lat = np.empty(L)
    for e in range(L):
        times = comm.layer_times(int(methods[e]), demand[e],
                                 rep[e].astype(float), mem[e], 8, prof, spec)
        ok = times.feasible.all()
        if not ok:   # direct transfer infeasible -> fall back to storage
            methods[e] = 2
            times = comm.layer_times(2, demand[e], rep[e].astype(float),
                                     mem[e], 1, prof, spec)
        cost[e] = comm.layer_billed_cost(times, mem[e], spec)
        lat[e] = times.t_latency
    return DeploymentPlan(method=methods, beta=8, mem_mb=mem, replicas=rep,
                          demand=np.asarray(demand, float),
                          layer_cost=cost, layer_latency=lat,
                          planner="random")
