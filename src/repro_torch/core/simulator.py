"""Serverless execution simulator — the ground truth standing in for AWS

A copy of ``repro.core.simulator`` (numpy only): the port imports
nothing of the reference package.

Lambda (DESIGN.md §3).

Since PR 3 this is a deterministic DISCRETE-EVENT engine, not a
closed-form evaluator: every (layer, expert, replica) invocation is an
event with its own start time, container temperature, attempt history,
and completion time. A :class:`FaultProfile` injects the behaviors real
serverless MoE systems are dominated by (PAPERS.md: Remoe, FaaSMoE):

* **warm-container pool** — the first ``warm_pool`` invocations of a
  layer wave reuse warm containers; beyond the pool each invocation
  draws cold with probability ``cold_start_prob`` and pays the cold-
  minus-warm start delta (billed — Lambda bills init time);
* **stragglers** — with probability ``straggler_prob`` an invocation's
  successful attempt runs ``straggler_slowdown`` times longer (tail
  latency amplification);
* **transient failures** — each attempt fails with probability
  ``failure_prob``; a failed attempt bills its head phase and retries
  after exponential backoff (``retry_backoff_s * 2**attempt``), up to
  ``max_retries`` extra attempts (the last attempt always completes);
* **per-account concurrency limit** — at most ``concurrency_limit``
  invocations run at once; excess invocations queue (tracked as
  ``queue_delay_s``, latency-only — queueing is not billed).

Given a deployment plan (planned from PREDICTED expert demand) and the
REAL routing counts observed when the JAX MoE model processes a batch,
the simulator accounts:

* billed GB-seconds per expert function (Eq. 4 evaluated at real counts,
  including memory-overrun penalties: an overrun forces a re-invocation at
  the real working set, billed at the deploy-time memory but with extra
  round-trips — the failure feedback consumed by Alg. 2 case (i));
* payload violations under direct transfer (Alg. 2 case (ii));
* per-layer MoE-E2E latency and end-to-end throughput;
* the fault breakdown (cold starts, retries, queue delay, stragglers).

Results come back as the plan API's common ``ExecutionReport``
(``SimResult`` remains as the historical alias). Pipelined (method-1)
layers honor the plan's per-layer ``chunk_schedule`` when present; a
schedule shorter than the layer count falls back to the global ``beta``
for the missing layers.

Determinism and the ZERO-FAULT BIT-IDENTITY GUARANTEE: jitter and every
fault draw are seeded (independent streams, so enabling faults never
perturbs the jitter draws). With every :class:`FaultProfile` knob at
zero, the event engine contributes exactly-zero extras — billed time,
latency, and cost are numerically IDENTICAL (repr-equal floats) to the
pre-event closed-form simulator on the same seed, and with ``jitter=0``
results are exact.

**Predictive pre-warming** (``run(..., prewarm=...)``): a (L, E) matrix
of speculatively warmed containers per expert function (or a list of
:class:`repro.predict.prewarm.PrewarmEvent`). An invocation first
consumes its expert's pre-warmed containers (a *prewarm hit*: the cold
draw is masked), then the reactive ``warm_pool``, then draws cold.
Containers never consumed are *prewarm misses* and bill their idle
keep-alive (``PlatformSpec.t_prewarm_keepalive_s`` at the plan's memory
size) as ``wasted_prewarm_gb_s``. Two determinism contracts:

* ``prewarm=None`` (default) takes the exact historical code path —
  reports are bit-identical to the pre-prewarm engine (golden-pinned);
* with a prewarm MATRIX (even all-zero), the cold-start stream draws
  once per invocation regardless of pool state, so two runs differing
  only in their hint matrices see IDENTICAL cold draws — a hint can only
  mask a cold start, never create one (prewarm-on cold counts are
  provably <= prewarm-off-with-zero-matrix counts at the same seed).

**Expert-weight caching** (``run(..., cache=...)``): a
:class:`repro.expcache.ContainerCacheModel` replaces the binary
warm/cold container picture with a two-level weight hierarchy — an
invocation whose cold draw says "cold" but that finds an idle warm
container performs a cheap intra-container SWAP of its expert weights
(billed busy seconds, ``SwapCostModel``) instead of the cold boot;
containers already holding the weights are residency hits; idle
resident containers bill ``t_cache_keepalive_s`` GB-s per window and
retire after their idle budget; deploy-time packed containers (several
long-tail experts per container) bill one amortized boot when first
taken. The same two determinism contracts hold: ``cache=None`` is the
exact historical path (golden-pinned), and with a cache attached the
cold stream draws once per invocation unconditionally, so the cache can
only MASK cold starts, never create them.

**Multi-tenant accounting** (``run(..., tenants=...)``): a list of
``(name, demand)`` or ``(name, demand, num_tokens)`` entries whose
demands sum to ``real_demand``. Replicas of each (layer, expert) are
apportioned to tenants by largest-remainder on their demand shares
(:func:`replica_accounts`), the wave keys its concurrency heap by
account (tenant A's queue can never delay tenant B — the documented
per-account semantics), and a :class:`TenantAccounting` splits every
billed second exactly across tenants: shared closed-form time by demand
share, fault extras to the tenant whose invocation drew them, fleet-wide
keep-alive by token share. Per-tenant totals land in the report's
conditional ``"tenants"`` block (absent for tenant-less runs, so every
committed golden stays bit-identical); the fleet-level numbers are
unchanged by construction (tenant splits always sum to the totals).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import comm
from repro_torch.core.costmodel import MB, CPUClusterSpec, ModelProfile, PlatformSpec
from repro_torch.dispatch.chunks import ChunkPlan
from repro_torch.dispatch.policy import (WaveState, draw_failures, draw_straggler,
                                         draw_temperature)
from repro_torch.plan.schema import DeploymentPlan, ExecutionReport

# Historical name: the simulator's result IS the common execution report.
SimResult = ExecutionReport


@dataclass(frozen=True)
class FaultProfile:
    """Fault-injection knobs for the discrete-event simulator.

    All-zero defaults (the instance ``FaultProfile()``) model the ideal
    platform of the paper's cost analysis and are guaranteed to
    reproduce the closed-form results bit-identically.
    """

    cold_start_prob: float = 0.0   # P(cold) once the warm pool is drained
    warm_pool: int = 0             # pre-warmed containers per layer wave
    straggler_prob: float = 0.0    # P(an invocation straggles)
    straggler_slowdown: float = 4.0   # duration multiplier when straggling
    failure_prob: float = 0.0      # P(transient failure) per attempt
    max_retries: int = 3           # extra attempts after a failure
    retry_backoff_s: float = 0.05  # base backoff; doubles per attempt
    concurrency_limit: int = 0     # per-account concurrent invocations
    #                                (0 = unlimited)

    def __post_init__(self):
        assert 0.0 <= self.cold_start_prob <= 1.0
        assert 0.0 <= self.straggler_prob <= 1.0
        assert 0.0 <= self.failure_prob < 1.0
        assert self.straggler_slowdown >= 1.0
        assert self.warm_pool >= 0 and self.max_retries >= 0
        assert self.retry_backoff_s >= 0.0 and self.concurrency_limit >= 0

    @property
    def enabled(self) -> bool:
        """True when any knob can perturb the ideal-platform results."""
        return bool(self.cold_start_prob > 0.0 or self.straggler_prob > 0.0
                    or self.failure_prob > 0.0 or self.concurrency_limit > 0)

    def backoff_s(self, attempt: int) -> float:
        """Wait before re-dispatching after failed attempt ``attempt``
        (1-based): the base backoff, doubling per attempt. This makes
        ``FaultProfile`` a full :class:`repro.dispatch.DispatchPolicy` —
        the same object drives the event simulator and the real
        multi-process gateway."""
        return self.retry_backoff_s * (2.0 ** (attempt - 1))


@dataclass
class InvocationEvent:
    """One serverless function invocation inside a layer wave."""

    layer: int
    expert: int
    replica: int
    start_s: float          # dispatch time == time queued for a
    #                         concurrency slot (nominal dispatch is t=0)
    attempts: int           # 1 + transient-failure retries
    cold: bool
    straggled: bool
    extra_billed_s: float   # billed time beyond the fault-free duration
    end_s: float            # completion time within the wave
    prewarmed: bool = False  # served by a speculatively warmed container
    swapped: bool = False    # cold draw masked by an expert-weight swap
    account: int = 0         # tenant/account index (0 = single-account)


@dataclass
class _AccountTally:
    """One account's share of a wave's extras (multi-tenant attribution):
    only the invocations dispatched under this account accumulate here,
    so fault extras land on the tenant whose replica drew them."""

    extra_billed: np.ndarray        # (E,) billed seconds beyond g * t_rep
    cold_starts: int = 0
    cold_start_s: float = 0.0
    retries: int = 0
    stragglers: int = 0
    queue_delay_s: float = 0.0
    makespan: float = 0.0           # latest end time among own invocations
    prewarm_hits: int = 0
    cache_hits: int = 0
    cache_swaps: int = 0


@dataclass
class _WaveResult:
    """Aggregate of one layer's invocation wave (extras vs. fault-free)."""

    extra_billed: np.ndarray        # (E,) billed seconds beyond g * t_rep
    extra_latency: float            # makespan beyond max(t_rep)
    cold_starts: int = 0
    cold_start_s: float = 0.0
    retries: int = 0
    retry_s: float = 0.0
    queue_delay_s: float = 0.0
    stragglers: int = 0
    prewarm_hits: int = 0
    prewarm_leftover: Optional[np.ndarray] = None   # (E,) unconsumed hints
    cache_hits: int = 0
    cache_swaps: int = 0
    swap_s_by_expert: Optional[np.ndarray] = None   # (E,) billed swap s
    base_makespan: float = 0.0      # fault-free makespan max(t_rep)
    accounts: Optional[Dict[int, _AccountTally]] = None
    events: List[InvocationEvent] = field(default_factory=list)


def _run_layer_wave(layer: int, t_rep: np.ndarray, g: np.ndarray,
                    head_s: float, cold_extra_s: float,
                    faults: FaultProfile,
                    rng: np.random.Generator,
                    prewarmed: Optional[np.ndarray] = None,
                    cache_wave=None,
                    accounts: Optional[List[np.ndarray]] = None,
                    account_names: Optional[Sequence[str]] = None
                    ) -> _WaveResult:
    """Discrete-event simulation of one layer's invocation wave.

    Invocations dispatch in deterministic (expert, replica) order; a
    min-heap of running-invocation end times PER ACCOUNT models the
    per-account concurrency limit — one account's backlog never queues
    another's. Everything is accumulated as EXTRAS relative to the
    fault-free closed form (start at t=0, run for ``t_rep``), so a
    zero-knob profile contributes exact float zeros.

    ``accounts`` assigns each invocation to an account: per expert, a
    ``(g[expert],)`` int array of account indices (built by
    :func:`replica_accounts`). ``None`` is the single-account historical
    path — every invocation shares account 0 and one heap, bit-identical
    to the pre-tenancy engine. With accounts given, per-account extras
    are additionally tallied in ``_WaveResult.accounts`` (the global
    accumulators are untouched, so totals never shift).
    ``account_names`` maps account index -> tenant name so an attached
    cache can enforce per-tenant residency quotas.

    ``prewarmed`` (E,) counts speculatively warmed containers per expert:
    consumed before the reactive warm pool, each consumption a prewarm
    hit that masks the invocation's cold draw. With a prewarmed array
    present (even all-zero) the cold stream draws once per invocation
    unconditionally, so runs differing only in hints share the same
    draws; with ``prewarmed=None`` the historical draw-after-pool
    discipline is preserved bit-for-bit.

    ``cache_wave`` (:class:`repro.expcache.model.CacheWave`) replaces
    the temperature draw with the cache's access discipline: residency
    hits and weight swaps mask cold draws (same unconditional-draw
    contract); swap seconds bill like cold init — on the first attempt,
    exactly once.
    """
    E = t_rep.shape[0]
    res = _WaveResult(extra_billed=np.zeros(E), extra_latency=0.0)
    if cache_wave is not None:
        res.swap_s_by_expert = np.zeros(E)
    tallies: Optional[Dict[int, _AccountTally]] = \
        {} if accounts is not None else None
    # end times of running invocations, keyed by ACCOUNT: the
    # concurrency limit is per account (tenant), so one tenant's burst
    # cannot serialize another's traffic. The single-account path
    # (accounts=None) keys everything under 0 — one heap, the exact
    # historical push/pop order.
    busy: Dict[int, List[float]] = {}
    # fault DECISIONS come from the shared dispatch-policy draws (one
    # definition across this simulator and the repro.dist gateway); the
    # draw order per invocation — temperature, straggler, failures —
    # and every billing float below are the historical ones, so the
    # golden-pinned fault streams replay bit-for-bit
    state = WaveState.start(faults, prewarmed)
    makespan = 0.0
    base_makespan = 0.0
    limit = faults.concurrency_limit
    for expert in range(E):
        dur = float(t_rep[expert])
        if dur <= 0.0:
            continue                      # no tokens routed: never invoked
        base_makespan = max(base_makespan, dur)
        acct_row = accounts[expert] if accounts is not None else None
        for replica in range(int(g[expert])):
            acct = int(acct_row[replica]) \
                if acct_row is not None and replica < len(acct_row) else 0
            q = busy.setdefault(acct, [])
            start = 0.0
            if limit and len(q) >= limit:
                start = heapq.heappop(q)
            tenant = account_names[acct] if account_names is not None \
                else None
            swap_billed = 0.0
            swapped = False
            was_hit = False
            if cache_wave is not None:
                acc = cache_wave.access(expert, rng, state, tenant=tenant)
                cold, pre_hit = acc.cold, acc.pre_hit
                if acc.kind == "hit":
                    was_hit = True
                    res.cache_hits += 1
                elif acc.kind == "swap":
                    swapped = True
                    swap_billed = acc.swap_s
                    res.cache_swaps += 1
                    res.swap_s_by_expert[expert] += acc.swap_s
            else:
                cold, pre_hit = draw_temperature(faults, rng, state,
                                                 expert)
            if pre_hit:
                res.prewarm_hits += 1
            straggled = draw_straggler(faults, rng)
            # cold init is paid exactly once, on the very first attempt
            # (failed or not), and attributed to cold_start_s only —
            # retry_s carries just the head-phase re-runs, so the
            # breakdown sums reconcile with the extra billed seconds.
            # A weight swap bills the same way: once, on first attempt.
            cold_billed = (cold_extra_s if cold else 0.0) + swap_billed
            t = start
            extra_billed = 0.0
            n_fail = draw_failures(faults, rng)
            attempts = 1
            for k in range(1, n_fail + 1):
                # transient failure: detected after the head phase,
                # billed, then retried after exponential backoff
                fail_s = head_s + (cold_billed if k == 1 else 0.0)
                extra_billed += fail_s
                res.retries += 1
                res.retry_s += head_s
                t += fail_s + faults.backoff_s(k)
                attempts += 1
            final = dur
            if attempts == 1:
                # the successful attempt is the first: it pays cold init
                final += cold_billed
                extra_billed += cold_billed
            if straggled:
                slow = dur * (faults.straggler_slowdown - 1.0)
                final += slow
                extra_billed += slow
                res.stragglers += 1
            if cold:
                res.cold_starts += 1
                res.cold_start_s += cold_billed
            end = t + final
            if limit:
                heapq.heappush(q, end)
            res.extra_billed[expert] += extra_billed
            res.queue_delay_s += start
            makespan = max(makespan, end)
            if tallies is not None:
                tal = tallies.get(acct)
                if tal is None:
                    tal = tallies[acct] = _AccountTally(
                        extra_billed=np.zeros(E))
                tal.extra_billed[expert] += extra_billed
                tal.queue_delay_s += start
                tal.makespan = max(tal.makespan, end)
                tal.retries += attempts - 1
                if cold:
                    tal.cold_starts += 1
                    tal.cold_start_s += cold_billed
                if straggled:
                    tal.stragglers += 1
                if pre_hit:
                    tal.prewarm_hits += 1
                if was_hit:
                    tal.cache_hits += 1
                if swapped:
                    tal.cache_swaps += 1
            res.events.append(InvocationEvent(
                layer=layer, expert=expert, replica=replica, start_s=start,
                attempts=attempts, cold=cold, straggled=straggled,
                extra_billed_s=extra_billed, end_s=end,
                prewarmed=pre_hit, swapped=swapped, account=acct))
    res.extra_latency = makespan - base_makespan
    res.base_makespan = base_makespan
    res.prewarm_leftover = state.pre_left
    res.accounts = tallies
    return res


# ---------------------------------------------------------------------------
# Multi-tenant apportionment + attribution (shared with repro.dist)
# ---------------------------------------------------------------------------

def split_replicas(g: int, shares: np.ndarray) -> np.ndarray:
    """Largest-remainder apportionment of ``g`` replicas over accounts.

    ``shares`` (T,) sums to 1; the result (T,) sums to ``g``.
    Deterministic: remainder ties break toward the lower account index
    (stable argsort), so re-planning loops replay identically.
    """
    shares = np.asarray(shares, float)
    quota = g * shares
    base = np.floor(quota).astype(np.int64)
    rem = int(g - base.sum())
    if rem > 0:
        frac = quota - base
        order = np.argsort(-frac, kind="stable")
        base[order[:rem]] += 1
    return base


def replica_accounts(g_layer: np.ndarray,
                     demand_by_acct: np.ndarray) -> List[np.ndarray]:
    """Per-expert arrays of per-replica account indices for one layer.

    ``g_layer`` (E,) replica counts; ``demand_by_acct`` (T, E) each
    account's routed tokens. Replicas of expert ``i`` are apportioned to
    accounts proportionally to their demand share (largest remainder);
    the returned replica order groups by ascending account index, so
    dispatch order inside an expert stays deterministic.
    """
    T, E = demand_by_acct.shape
    out: List[np.ndarray] = []
    for i in range(E):
        gi = int(g_layer[i])
        tot = float(demand_by_acct[:, i].sum())
        if gi <= 0 or tot <= 0.0:
            out.append(np.zeros(gi, np.int64))
            continue
        counts = split_replicas(gi, demand_by_acct[:, i] / tot)
        out.append(np.repeat(np.arange(T), counts))
    return out


class TenantAccounting:
    """Splits one run's billed cost / latency / fault breakdown exactly
    across tenants.

    Attribution contract (conservation by construction — per layer the
    tenant costs sum to the fleet's ``layer_cost`` float-exactly up to
    summation order):

    * the SHARED closed-form seconds of each expert (base time plus
      overrun penalties, minus all accounts' wave extras) split by the
      tenants' demand shares of that expert (token share where an expert
      served no demand);
    * each account's WAVE EXTRAS (cold init, retries, straggle,
      swap seconds) bill to the tenant whose invocation drew them;
    * fleet-wide GB-seconds with no owning invocation (wasted prewarm
      keep-alive, cache keep-alive, seeded boots) split by token share;
    * latency: every tenant carries the layer's fault-free critical path
      (all tenants wait for the shared wave), plus the excess of its OWN
      account's makespan over it.
    """

    INT_KEYS = ("cold_starts", "retries", "stragglers", "prewarm_hits",
                "cache_hits", "cache_swaps")
    FLOAT_KEYS = ("cold_start_s", "queue_delay_s")

    def __init__(self, names: Sequence[str], demands: np.ndarray,
                 tokens: np.ndarray, overhead_s: float, price: float):
        self.names = list(names)
        self.demands = np.asarray(demands, float)      # (T, L, E)
        self.tokens = np.asarray(tokens, float)        # (T,)
        T = len(self.names)
        tot = float(self.tokens.sum())
        self.token_share = (self.tokens / tot if tot > 0.0
                            else np.full(T, 1.0 / T))
        self.price = float(price)
        self.cost = np.zeros(T)
        self.lat = np.full(T, float(overhead_s))
        self.counters = {k: np.zeros(T)
                         for k in self.INT_KEYS + self.FLOAT_KEYS}

    def layer_shares(self, layer: int) -> np.ndarray:
        """(T, E) fraction of each expert's time owed by each tenant."""
        d = self.demands[:, layer, :]
        tot = d.sum(axis=0)
        return np.where(tot > 0.0, d / np.maximum(tot, 1e-300),
                        self.token_share[:, None])

    def wave_tallies(self, wave: Optional[_WaveResult],
                     E: int) -> Tuple[np.ndarray, np.ndarray]:
        """Fold a wave's per-account tallies into the running counters;
        returns ``(extras (T, E), extra_latency (T,))``."""
        T = len(self.names)
        extras = np.zeros((T, E))
        extra_lat = np.zeros(T)
        if wave is not None and wave.accounts:
            for a, tal in wave.accounts.items():
                extras[a] = tal.extra_billed
                extra_lat[a] = max(tal.makespan - wave.base_makespan, 0.0)
                for k in self.INT_KEYS:
                    self.counters[k][a] += getattr(tal, k)
                self.counters["cold_start_s"][a] += tal.cold_start_s
                self.counters["queue_delay_s"][a] += tal.queue_delay_s
        return extras, extra_lat

    def add_layer(self, layer: int, *, t_total: np.ndarray,
                  extras_by_acct: np.ndarray, mem_mb: np.ndarray,
                  base_lat: float, extra_lat: np.ndarray,
                  shared_gb_s: float = 0.0) -> None:
        f = self.layer_shares(layer)
        shared = np.asarray(t_total, float) - extras_by_acct.sum(axis=0)
        gb_s = ((f * shared[None, :] + extras_by_acct)
                * np.asarray(mem_mb, float)[None, :] / 1024.0).sum(axis=1)
        self.cost += (gb_s + self.token_share * shared_gb_s) * self.price
        self.lat += float(base_lat) + extra_lat

    def finalize(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for t, name in enumerate(self.names):
            d = {"billed_cost": float(self.cost[t]),
                 "latency_s": float(self.lat[t]),
                 "num_tokens": int(self.tokens[t]),
                 "throughput_tps": float(self.tokens[t]
                                         / max(self.lat[t], 1e-9))}
            for k in self.INT_KEYS:
                d[k] = int(self.counters[k][t])
            for k in self.FLOAT_KEYS:
                d[k] = float(self.counters[k][t])
            out[name] = d
        return out


class ServerlessSimulator:
    def __init__(self, prof: ModelProfile, spec: PlatformSpec, *,
                 jitter: float = 0.0, seed: int = 0,
                 faults: Optional[FaultProfile] = None):
        self.prof = prof
        self.spec = spec
        self.jitter = jitter
        self.faults = faults if faults is not None else FaultProfile()
        self.rng = np.random.default_rng(seed)
        # independent stream: fault draws must never shift jitter draws
        self._fault_rng = np.random.default_rng([seed, 0xFA17])
        self.last_events: List[InvocationEvent] = []

    @staticmethod
    def _prewarm_matrix(prewarm, L: int, E: int) -> Optional[np.ndarray]:
        """Normalize a prewarm order to the (L, E) container matrix: pass
        through None, accept a matrix, or collapse PrewarmEvent-like
        objects (anything with layer/expert/containers attributes)."""
        if prewarm is None:
            return None
        if isinstance(prewarm, (list, tuple)):
            out = np.zeros((L, E), np.int64)
            for ev in prewarm:
                out[int(ev.layer), int(ev.expert)] += int(ev.containers)
            return out
        out = np.asarray(prewarm, np.int64)
        assert out.shape == (L, E), (out.shape, (L, E))
        assert (out >= 0).all(), "negative prewarm container counts"
        return out

    @staticmethod
    def _normalize_tenants(tenants, real_demand: np.ndarray,
                           num_tokens: int):
        """``tenants`` -> ``(names, demands (T, L, E), tokens (T,))``.

        Accepts a mapping ``name -> (L, E) demand`` or a sequence of
        ``(name, demand)`` / ``(name, demand, num_tokens)`` entries.
        Token counts default to the tenant's share of total demand.
        The per-tenant demands must sum to ``real_demand``."""
        if tenants is None:
            return None
        entries = list(tenants.items()) if isinstance(tenants, dict) \
            else [tuple(t) for t in tenants]
        if not entries:
            return None
        names: List[str] = []
        demands: List[np.ndarray] = []
        toks: List[Optional[float]] = []
        for ent in entries:
            name, d = str(ent[0]), np.asarray(ent[1], float)
            if d.shape != real_demand.shape:
                raise ValueError(
                    f"tenant {name!r} demand shape {d.shape} != "
                    f"{real_demand.shape}")
            names.append(name)
            demands.append(d)
            toks.append(float(ent[2]) if len(ent) > 2 else None)
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        stack = np.stack(demands)
        if not np.allclose(stack.sum(axis=0), real_demand,
                           rtol=1e-6, atol=1e-6):
            raise ValueError(
                "per-tenant demands must sum to real_demand")
        sums = stack.sum(axis=(1, 2))
        all_tok = max(float(sums.sum()), 1e-300)
        tokens = np.array([
            t if t is not None else num_tokens * sums[i] / all_tok
            for i, t in enumerate(toks)])
        return names, stack, tokens

    def run(self, plan: DeploymentPlan, real_demand: np.ndarray,
            num_tokens: int, *, prewarm=None,
            cache=None, tenants=None) -> ExecutionReport:
        """Execute ``plan`` against the observed routing counts.

        ``prewarm``: speculative container hints (see module docstring).
        ``cache``: a :class:`repro.expcache.ContainerCacheModel` whose
        resident-weight state PERSISTS across calls — pass the same
        object window after window to model a long-lived warm fleet.
        ``tenants``: per-tenant demand split (see module docstring);
        the report gains a ``"tenants"`` block whose per-tenant costs
        sum to the fleet totals. ``None`` (default) is the historical
        single-account path, bit-identical to committed goldens.
        """
        prof, spec, faults = self.prof, self.spec, self.faults
        real_demand = np.asarray(real_demand, float)
        L, E = real_demand.shape
        pw = self._prewarm_matrix(prewarm, L, E)
        tn = self._normalize_tenants(tenants, real_demand, num_tokens)
        acct = TenantAccounting(
            tn[0], tn[1], tn[2],
            prof.t_head_s + prof.t_tail_s + L * prof.t_nonmoe_s,
            spec.price_per_gb_s) if tn is not None else None
        # single source of truth for per-layer chunks: the shared
        # ChunkPlan (full_chunk_schedule() fallback included), the same
        # object the serving rounds and the process gateway consume
        chunks = ChunkPlan.from_plan(plan) \
            if hasattr(plan, "full_chunk_schedule") else None
        layer_cost = np.zeros(L)
        layer_lat = np.zeros(L)
        overrun = np.zeros((L, E), bool)
        payload_bad = np.zeros((L, E), bool)
        min_mem = np.zeros((L, E))
        head_s = comm.head_time(prof, spec)
        cold_extra_s = max(spec.t_cold_start_s - spec.t_warm_start_s, 0.0)
        self.last_events = []
        breakdown = dict(cold_starts=0, cold_start_s=0.0, retries=0,
                         retry_s=0.0, queue_delay_s=0.0, stragglers=0,
                         prewarm_hits=0, prewarm_misses=0,
                         wasted_prewarm_gb_s=0.0, cache_hits=0,
                         cache_swaps=0, swap_gb_s=0.0,
                         cache_keepalive_gb_s=0.0)

        for e in range(L):
            a = int(plan.method[e])
            beta = chunks.beta_for(e) if chunks is not None else plan.beta
            g = plan.replicas[e].astype(float)
            mem = plan.mem_mb[e]
            r_real = real_demand[e] / np.maximum(g, 1)
            min_mem[e] = comm.memory_required_mb(r_real, prof)
            overrun[e] = (min_mem[e] > mem) & (real_demand[e] > 0)
            if a == 3:
                payload_bad[e] = (r_real * prof.token_in_bytes
                                  > spec.payload_bytes)
            eff_a = a
            if payload_bad[e].any():
                # the platform rejects oversized payloads; execution falls
                # back to storage relay, paying both attempts' head time
                eff_a = 2
            times = comm.layer_times(eff_a, r_real, g, mem, beta,
                                     prof, spec)
            t_total = times.t_total.copy()
            t_lat = times.t_latency
            wasted_gb_s = 0.0
            cache_gb_s = 0.0
            if cache is not None:
                # deploy-time packed containers boot once, off the
                # critical path: one amortized cold boot per container,
                # billed at the container's memory, no latency impact
                for boot_mem in cache.take_pending_boots(e):
                    breakdown["cold_starts"] += 1
                    breakdown["cold_start_s"] += cold_extra_s
                    cache_gb_s += boot_mem / 1024.0 * cold_extra_s
            wave = None
            if faults.enabled or pw is not None or cache is not None:
                # --- discrete-event invocation wave: faults ride as
                # extras on top of the closed form. With every knob at
                # zero the wave would contribute exact float zeros (the
                # differential tests pin this with an inert-but-enabled
                # profile), so the ideal-platform hot path — every BO
                # trial — skips the per-invocation loop entirely. A
                # prewarm order forces the wave so hints are consumed
                # and scored even on an otherwise ideal platform. A
                # cache model forces it too: residency must be tracked
                # (and keep-alive billed) even with no fault knobs on.
                wave = _run_layer_wave(e, times.t_rep, g, head_s,
                                       cold_extra_s, faults,
                                       self._fault_rng,
                                       prewarmed=(pw[e] if pw is not None
                                                  else None),
                                       cache_wave=(cache.wave(e, faults)
                                                   if cache is not None
                                                   else None),
                                       accounts=(replica_accounts(
                                           plan.replicas[e], tn[1][:, e, :])
                                           if tn is not None else None),
                                       account_names=(tn[0]
                                                      if tn is not None
                                                      else None))
                t_total = t_total + wave.extra_billed
                t_lat += wave.extra_latency
                self.last_events.extend(wave.events)
                breakdown["cold_starts"] += wave.cold_starts
                breakdown["cold_start_s"] += wave.cold_start_s
                breakdown["retries"] += wave.retries
                breakdown["retry_s"] += wave.retry_s
                breakdown["queue_delay_s"] += wave.queue_delay_s
                breakdown["stragglers"] += wave.stragglers
                if pw is not None:
                    leftover = wave.prewarm_leftover
                    breakdown["prewarm_hits"] += wave.prewarm_hits
                    breakdown["prewarm_misses"] += int(leftover.sum())
                    # mispredicted containers idle warm for the keep-alive
                    # window at the deployed memory size: pure waste
                    wasted_gb_s = float((leftover * mem).sum()) / 1024.0 \
                        * spec.t_prewarm_keepalive_s
                    breakdown["wasted_prewarm_gb_s"] += wasted_gb_s
                if cache is not None:
                    breakdown["cache_hits"] += wave.cache_hits
                    breakdown["cache_swaps"] += wave.cache_swaps
                    # swap busy seconds already ride in t_total (billed
                    # below at the expert's memory); this mirrors them
                    # into the report breakdown
                    breakdown["swap_gb_s"] += float(
                        (wave.swap_s_by_expert * mem).sum()) / 1024.0
            if cache is not None:
                # resident containers that went the whole window unused
                # bill idle keep-alive at their memory size; long-idle
                # ones retire inside end_layer_window
                ka_gb_s = sum(cache.end_layer_window(e)) / 1024.0 \
                    * spec.t_cache_keepalive_s
                breakdown["cache_keepalive_gb_s"] += ka_gb_s
                cache_gb_s += ka_gb_s
            if overrun[e].any():
                # overrun functions crash + retry with spilled buffers:
                # extra head time and 2x storage traffic on retried experts
                retry = overrun[e]
                penalty = (comm.head_time(prof, spec)
                           + 2 * spec.t_storage_access_s
                           + r_real * (prof.token_in_bytes
                                       + prof.token_out_bytes)
                           / (spec.bw_storage_mb_s * MB))
                t_total = t_total + np.where(retry, g * penalty, 0.0)
                t_lat += float(np.max(np.where(retry, penalty, 0.0)))
            if payload_bad[e].any():
                t_lat += spec.t_warm_start_s       # rejected attempt
            jfac = None
            if self.jitter > 0:
                jfac = 1 + self.jitter * self.rng.standard_normal(E)
                t_total = t_total * jfac
                t_total = np.maximum(t_total, 0.0)
            layer_cost[e] = comm.layer_billed_cost(
                comm.LayerTimes(times.t_rep, t_total, t_lat, times.feasible),
                mem, spec) + wasted_gb_s * spec.price_per_gb_s \
                + cache_gb_s * spec.price_per_gb_s
            layer_lat[e] = t_lat
            if acct is not None:
                extras_a, extra_lat_a = acct.wave_tallies(wave, E)
                if jfac is not None:
                    # extras scale with the same platform-noise factor
                    # their expert's total did (clamped like t_total),
                    # so shared + extras still reconstructs t_total
                    extras_a = extras_a * np.maximum(jfac, 0.0)[None, :]
                acct.add_layer(
                    e, t_total=t_total, extras_by_acct=extras_a,
                    mem_mb=mem,
                    base_lat=t_lat - (wave.extra_latency
                                      if wave is not None else 0.0),
                    extra_lat=extra_lat_a,
                    shared_gb_s=wasted_gb_s + cache_gb_s)

        total_lat = (prof.t_head_s + prof.t_tail_s
                     + layer_lat.sum() + L * prof.t_nonmoe_s)
        return ExecutionReport(
            billed_cost=float(layer_cost.sum()),
            latency_s=float(total_lat),
            throughput_tps=num_tokens / max(total_lat, 1e-9),
            layer_cost=layer_cost,
            layer_latency=layer_lat,
            mem_overrun=overrun,
            payload_violation=payload_bad,
            real_demand=real_demand,
            min_mem_required_mb=min_mem,
            backend="simulator",
            num_tokens=int(num_tokens),
            cold_starts=int(breakdown["cold_starts"]),
            cold_start_s=float(breakdown["cold_start_s"]),
            retries=int(breakdown["retries"]),
            retry_s=float(breakdown["retry_s"]),
            queue_delay_s=float(breakdown["queue_delay_s"]),
            stragglers=int(breakdown["stragglers"]),
            prewarm_hits=int(breakdown["prewarm_hits"]),
            prewarm_misses=int(breakdown["prewarm_misses"]),
            wasted_prewarm_gb_s=float(breakdown["wasted_prewarm_gb_s"]),
            cache_hits=int(breakdown["cache_hits"]),
            cache_swaps=int(breakdown["cache_swaps"]),
            swap_gb_s=float(breakdown["swap_gb_s"]),
            packed_experts=(int(cache.packed_expert_count())
                            if cache is not None else 0),
            cache_keepalive_gb_s=float(breakdown["cache_keepalive_gb_s"]),
            tenants=(acct.finalize() if acct is not None else {}),
        )


def cpu_cluster_result(prof: ModelProfile, cluster: CPUClusterSpec,
                       real_demand: np.ndarray, num_tokens: int, *,
                       better_transformer: bool = False) -> ExecutionReport:
    """Paper baselines (5)/(6): the whole MoE model on a CPU cluster.

    All experts of a layer execute concurrently across cores; the cluster
    bills wall-clock at its hourly rate regardless of utilization.
    """
    real_demand = np.asarray(real_demand, float)
    L, E = real_demand.shape
    speed = cluster.speedup_vs_function
    if better_transformer:
        speed *= cluster.better_transformer_speedup
    per_layer = real_demand.max(axis=1) * prof.u_ref_s / speed \
        + prof.t_nonmoe_s
    total = float(per_layer.sum()) + prof.t_head_s + prof.t_tail_s
    cost = cluster.billed_cost(total)
    lc = cluster.billed_cost(per_layer.sum()) * per_layer / \
        max(per_layer.sum(), 1e-9)
    return ExecutionReport(
        billed_cost=cost, latency_s=total,
        throughput_tps=num_tokens / max(total, 1e-9),
        layer_cost=lc, layer_latency=per_layer,
        mem_overrun=np.zeros((L, E), bool),
        payload_violation=np.zeros((L, E), bool),
        real_demand=real_demand,
        min_mem_required_mb=np.zeros((L, E)),
        backend="cpu_cluster",
        num_tokens=int(num_tokens),
    )
