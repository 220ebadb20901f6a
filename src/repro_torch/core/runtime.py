"""End-to-end serverless-MoE runtime facade (DESIGN.md §3).

Counterpart of ``repro.core.runtime`` on the port's model and engine. A
thin composition of the plan API's stages around a real MoE model:

    corpus -> model.forward(capture=True) -> routing ground truth + token
    features -> KVTable profiling -> ExpertPredictor (Eq. 1-2) ->
    Planner.plan (registry: ODS / fixed-method / baselines, Alg. 1) ->
    DeploymentPlan -> ExecutionBackend.execute (simulator or live
    serving) -> ExecutionReport feedback -> BO (Alg. 2)

The runtime owns model/corpus/table state and wires the protocols
together; planning strategies live in ``repro_torch.plan.planner`` and
execution targets in ``repro_torch.plan.backends``.

The model runs on the CUDA device unless ``device`` names another one,
through the dense capacity executor (the fused router and the capacity
FFN kernel); capture forwards run eagerly under
``torch.inference_mode()``. The ModelProfile scales compute, parameter
and activation quantities to the FULL architecture dims, so billed costs
are realistic for the paper's models at any model size.

Not ported yet (ROADMAP.md, Queue A item 1), and raising
``NotImplementedError``: ``run_trace`` and ``replay_telemetry_trace``
(they need ``repro.traces``, ``plan/incremental.py`` and
``plan/tenancy.py``) and ``distributed_backend`` (``repro.dist``).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, get_arch, reduced_config
from repro_torch.core.bo import BOOptimizer, BOResult, EvalOutcome
from repro_torch.core.costmodel import (CPUClusterSpec, ModelProfile,
                                        PlatformSpec)
from repro_torch.core.deployment import apply_failure_feedback
from repro_torch.core.features import extract_features
from repro_torch.core.simulator import FaultProfile, cpu_cluster_result
from repro_torch.core.table import KVTable
from repro_torch.data.synthetic import SyntheticCorpus
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import Model
from repro_torch.models.moe import expert_ffn
from repro_torch.models.transformer import tree_index
from repro_torch.plan.backends import ServingBackend, SimulatorBackend
from repro_torch.plan.planner import BOPlanner, Planner, get_planner
from repro_torch.plan.schema import (DeploymentPlan, ExecutionReport,
                                     Workload, plan_diff)
from repro_torch.predict import (ExpertPredictor, OnlinePredictor,
                                 mispredicted_tokens)
from repro_torch.serving.engine import to_host

NOT_PORTED = "is not ported yet (ROADMAP.md, Queue A item 1)"
U_REF_RANGE_S = (1e-5, 1.0)   # the reference's clamp on u_ref_s


@dataclass
class RuntimeConfig:
    arch: str = "gpt2-moe"
    reduced: bool = True
    d_model_reduced: int = 128
    vocab_reduced: int = 2048
    seq_len: int = 128
    batch_size: int = 8
    profile_batches: int = 10           # >=100 samples per the paper
    learn_batches: int = 2              # J in Alg. 2
    eval_batches: int = 4
    slo_s: float = 600.0                # T^limit
    seed: int = 0
    jitter: float = 0.0
    demand_mode: str = "expected"       # "map" (Eq. 2) | "expected" (ours)
    planner: str = "ods"                # registry name (repro.plan.planner)
    backend: str = "simulator"          # registry name (repro.plan.backends)
    variant_experts: int = 0            # override expert count (Fig. 10)
    variant_top_k: int = 0              # override routing top-k (Fig. 10)


def full_dims(cfg: ModelConfig) -> Tuple[int, int]:
    m = cfg.moe
    assert m is not None
    return cfg.d_model, m.d_expert_ff


def build_profile(full_cfg: ModelConfig, u_ref_s: float) -> ModelProfile:
    """ModelProfile at FULL architecture dims (fp32 on-wire/resident)."""
    m = full_cfg.moe
    assert m is not None
    d, ff = full_dims(full_cfg)
    n_mats = 3 if full_cfg.activation == "swiglu" else 2
    expert_bytes = n_mats * d * ff * 4.0
    tok_bytes = d * 4.0
    # non-MoE per-layer params: attention + norms at full dims
    hd = full_cfg.resolved_head_dim
    attn_bytes = (d * full_cfg.num_heads * hd * 2
                  + d * full_cfg.num_kv_heads * hd * 2) * 4.0
    n_moe = sum(1 for s in full_cfg.pattern
                for _ in range(1) if s.ffn == "moe") * full_cfg.num_blocks
    return ModelProfile(
        num_moe_layers=n_moe,
        experts_per_layer=m.num_experts,
        expert_param_bytes=expert_bytes,
        token_in_bytes=tok_bytes,
        token_out_bytes=tok_bytes,
        u_ref_s=u_ref_s,
        intermediate_bytes=64 * (d + ff) * 4.0,   # a 64-token working set
        nonmoe_param_bytes=attn_bytes,
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_u_ref(model: Model, params, cfg: ModelConfig,
                  full_cfg: ModelConfig) -> float:
    """Time the real expert FFN (the capacity FFN kernel on the card) per
    token on (E, 64, d) buffers, scaled by the FLOP ratio to the full
    architecture. The device is synchronised after each timed call."""
    moe_p = tree_index(params["blocks"]["pos0"], 0)["moe"]
    E = moe_p["router"].shape[-1]
    d = cfg.d_model
    C = 64
    buf = torch.ones((E, C, d), dtype=moe_p["router"].dtype,
                     device=model.device)
    with torch.inference_mode():
        expert_ffn(moe_p, buf, cfg.activation)
        _sync(model.device)
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            expert_ffn(moe_p, buf, cfg.activation)
            _sync(model.device)
        per_token = (time.perf_counter() - t0) / reps / (E * C)
    d_f, ff_f = full_dims(full_cfg)
    m_r = cfg.moe
    assert m_r is not None
    scale = (d_f * ff_f) / max(d * m_r.d_expert_ff, 1)
    return per_token * scale


def calibrate_u_ref(model: Model, params, cfg: ModelConfig,
                    full_cfg: ModelConfig) -> float:
    """:func:`measure_u_ref` clamped to the reference's range of seconds
    per token (a Lambda vCPU is taken to be about one core of the
    reference's dev box)."""
    return float(np.clip(measure_u_ref(model, params, cfg, full_cfg),
                         *U_REF_RANGE_S))


class ServerlessMoERuntime:
    """Owns the model, corpus, table, and evaluation plumbing."""

    def __init__(self, rc: RuntimeConfig,
                 spec: Optional[PlatformSpec] = None, *,
                 device: DeviceLike = None):
        self.rc = rc
        self.device = resolve_device(device)
        self.spec = spec or PlatformSpec()
        full_cfg = get_arch(rc.arch)
        if full_cfg.moe is None:
            raise ValueError(
                f"{rc.arch} has no MoE layers; the paper's technique is "
                "inapplicable (DESIGN.md §6)")
        if rc.variant_experts or rc.variant_top_k:
            m = full_cfg.moe
            m = dataclasses.replace(
                m,
                num_experts=rc.variant_experts or m.num_experts,
                top_k=rc.variant_top_k or m.top_k)
            full_cfg = dataclasses.replace(full_cfg, moe=m)
        self.full_cfg = full_cfg
        if rc.reduced:
            cfg = reduced_config(full_cfg, num_blocks=full_cfg.num_blocks,
                                 d_model=rc.d_model_reduced,
                                 vocab=rc.vocab_reduced,
                                 max_experts=full_cfg.moe.num_experts)
            cfg = dataclasses.replace(cfg, max_seq_len=max(rc.seq_len + 1,
                                                           cfg.max_seq_len))
        else:
            cfg = full_cfg
        self.cfg = cfg
        self.model = Model(cfg, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(rc.seed)
        self.params = self.model.init_params(gen)
        # Random-init routers are near-uniform and random-init residual
        # streams lose token identity with depth; trained MoE models keep
        # routing confident and token/position-keyed (paper Fig. 3). Emulate
        # trained routing statistics: sharpen routers, damp block outputs so
        # the residual stays embedding-dominated. Documented in
        # EXPERIMENTS.md §Repro (setup deviations).
        self.params = self._emulate_trained_routing(
            self.params, sharpen=12.0, residual_damp=0.05)
        self.corpus = SyntheticCorpus(cfg.vocab_size, rc.seq_len,
                                      rc.batch_size, seed=rc.seed)
        m = cfg.moe
        assert m is not None
        self.top_k = m.top_k
        self.num_layers = cfg.num_layers
        self.num_experts = m.num_experts
        self.demand_mode = rc.demand_mode
        self.u_ref_measured_s = measure_u_ref(self.model, self.params, cfg,
                                              full_cfg)
        u_ref = float(np.clip(self.u_ref_measured_s, *U_REF_RANGE_S))
        self.profile = build_profile(full_cfg, u_ref)
        self.table = KVTable(self.num_layers, self.num_experts,
                             cfg.vocab_size)
        self.planner: Planner = get_planner(rc.planner)
        self.last_plan: Optional[DeploymentPlan] = None
        self._profiled = False
        # keyed by the batch's exact bytes (collision-free, hash-seed
        # independent); demand matrices are tiny and kept forever, full
        # token-level records are bounded LRU-style
        self._demand_cache: Dict[tuple, np.ndarray] = {}
        self._records_cache: Dict[tuple, List] = {}
        self._records_cache_max = 32

    @staticmethod
    def _emulate_trained_routing(params, sharpen: float,
                                 residual_damp: float):
        damped = ("wo", "w_down", "w_out", "out_proj")

        def walk(tree):
            if isinstance(tree, dict):
                out = {}
                for k, v in tree.items():
                    if isinstance(v, dict):
                        out[k] = walk(v)
                    elif k == "router":
                        out[k] = v * sharpen
                    elif k in damped:
                        out[k] = v * residual_damp
                    else:
                        out[k] = v
                return out
            return tree
        return walk(params)

    # ------------------------------------------------------------- profiling
    def run_capture(self, tokens: np.ndarray):
        """One capture forward through the dense executor; the stacked
        per-block captures as numpy."""
        with torch.inference_mode():
            toks = torch.as_tensor(np.asarray(tokens), device=self.device)
            aux = self.model.forward(self.params, toks, capture=True)[1]
            return to_host(aux["captures"])

    def batch_records(self, tokens: np.ndarray) -> List:
        """Ground-truth per-token routing records (``LayerRecords``) for a
        batch, cached by content — one capture forward per distinct batch
        serves both demand accounting and prediction-error scoring. The
        cache is bounded (records are the heavy artifact; oldest entries
        are evicted), while the derived demand matrices stay cached for
        good in ``real_demand``."""
        tokens = np.asarray(tokens)
        key = (tokens.shape, tokens.dtype.str, tokens.tobytes())
        if key not in self._records_cache:
            caps = self.run_capture(tokens)
            if len(self._records_cache) >= self._records_cache_max:
                self._records_cache.pop(next(iter(self._records_cache)))
            self._records_cache[key] = extract_features(
                tokens, caps, len(self.cfg.pattern))
        return self._records_cache[key]

    def real_demand(self, tokens: np.ndarray) -> np.ndarray:
        """(L, E) ground-truth routed token counts for a batch."""
        tokens = np.asarray(tokens)
        key = (tokens.shape, tokens.dtype.str, tokens.tobytes())
        if key not in self._demand_cache:
            d = np.zeros((self.num_layers, self.num_experts))
            for r in self.batch_records(tokens):
                np.add.at(d[r.layer], r.experts.ravel(), 1.0)
            self._demand_cache[key] = d
        return self._demand_cache[key]

    def mispredicted_tokens(self, pred, tokens: np.ndarray) -> np.ndarray:
        """Token IDs whose REALIZED routing the predictor's top-k missed —
        the real per-batch prediction errors Alg. 2 line 12 appends to
        BO's feedback-limited exploration range L (historically the whole
        batch's token set was used as a synthetic stand-in)."""
        return mispredicted_tokens(pred, self.batch_records(tokens))

    def profile_table(self) -> KVTable:
        """Paper §III-B: profile token-to-expert mappings on the corpus."""
        if self._profiled:
            return self.table
        for batch in self.corpus.batches(self.rc.profile_batches):
            toks = batch["tokens"]
            self.table.observe_tokens(toks)
            caps = self.run_capture(toks)
            recs = extract_features(toks, caps, len(self.cfg.pattern))
            self.table.add_records(recs)
        self._profiled = True
        return self.table

    # ------------------------------------------------------------ batches
    def learn_batches(self) -> List[np.ndarray]:
        start = self.rc.profile_batches
        return [b["tokens"] for b in
                self.corpus.batches(self.rc.learn_batches, start=start)]

    def eval_batches(self) -> List[np.ndarray]:
        start = self.rc.profile_batches + self.rc.learn_batches
        return [b["tokens"] for b in
                self.corpus.batches(self.rc.eval_batches, start=start)]

    # ----------------------------------------------------------- deployment
    def _plan(self, demand_pred: np.ndarray) -> DeploymentPlan:
        """Planner invocation WITHOUT recording: internal sweeps (BO
        trials, baseline evaluations) must not clobber ``last_plan``,
        which tracks the plan actually handed out for deployment."""
        return self.planner.plan(demand_pred, self.profile, self.spec,
                                 t_limit_s=self.rc.slo_s, seed=self.rc.seed)

    def plan(self, demand_pred: np.ndarray) -> DeploymentPlan:
        """Run the configured planner; remembers the plan for diffing."""
        p = self._plan(demand_pred)
        self.last_plan = p
        return p

    # ------------------------------------------------------------- backends
    def simulator_backend(self, *, seed: Optional[int] = None,
                          jitter: Optional[float] = None,
                          faults: Optional[FaultProfile] = None
                          ) -> SimulatorBackend:
        """Simulator execution backend bound to this runtime's ground-truth
        routing (``real_demand``); ``faults`` turns on the discrete-event
        engine's fault injection."""
        return SimulatorBackend(
            self.profile, self.spec,
            jitter=self.rc.jitter if jitter is None else jitter,
            seed=self.rc.seed if seed is None else seed,
            faults=faults,
            demand_fn=self.real_demand)

    def serving_backend(self, engine, **kw) -> ServingBackend:
        """Live-serving execution backend around a ``ServingEngine`` that
        runs this runtime's model."""
        kw.setdefault("jitter", self.rc.jitter)
        kw.setdefault("seed", self.rc.seed)
        return ServingBackend(engine, self.profile, self.spec, **kw)

    def distributed_backend(self, **kw):
        """The multi-process backend (``repro.dist``): not ported yet."""
        raise NotImplementedError(f"distributed_backend: repro.dist "
                                  f"{NOT_PORTED}")

    def make_backend(self, name: Optional[str] = None, **kw):
        """Resolve an execution backend by registry name
        (``"simulator"`` | ``"serving"`` | ``"distributed"``), defaulting
        to ``RuntimeConfig.backend``. Runtime-bound defaults (profile,
        platform, seed, ground-truth routing) are filled in; the serving
        backend additionally needs ``engine=...``."""
        name = name or self.rc.backend
        if name == "simulator":
            return self.simulator_backend(**kw)
        if name == "serving":
            return self.serving_backend(kw.pop("engine"), **kw)
        if name == "distributed":
            return self.distributed_backend(**kw)
        from repro_torch.plan.backends import get_backend
        return get_backend(name, **kw)

    def online_predictor(self, *, decay: float = 1.0, mode: str = "full",
                         top_k: Optional[int] = None) -> OnlinePredictor:
        """A streaming :class:`~repro.predict.online.OnlinePredictor`
        warm-started from the offline-profiled table (§III-B done online:
        the serving engine's speculative dispatch stage and the trace
        loop keep updating it from live traffic)."""
        self.profile_table()
        pred = OnlinePredictor(self.num_layers, self.num_experts,
                               self.cfg.vocab_size, mode=mode,
                               top_k=top_k or self.top_k, decay=decay)
        pred.ingest_table(self.table)
        return pred

    # -------------------------------------------------- live serving feedback
    def ingest_telemetry(self, telemetry) -> KVTable:
        """Fold live serving observations (``ServingEngine.telemetry``) into
        the profiling table so the predictor learns from real traffic."""
        self.table.ingest_telemetry(telemetry)
        return self.table

    def plan_from_telemetry(self, telemetry, *,
                            mode: str = "measured") -> DeploymentPlan:
        """Re-plan deployment from live serving traffic (closes the paper's
        profile -> predict -> plan loop online).

        ``mode="measured"`` plans directly on the telemetry's observed
        (L, E) routed-token counts; ``mode="predicted"`` first ingests the
        observations into the KV table and plans on the refreshed
        predictor's demand estimate over the served token stream. The
        returned plan carries a structured diff against the previous plan
        (``plan.metadata["replan_diff"]``) when one exists.
        """
        prev = self.last_plan
        if mode == "measured":
            self.ingest_telemetry(telemetry)
            plan = self.plan(telemetry.demand_matrix())
        elif mode == "predicted":
            self.ingest_telemetry(telemetry)
            pred = ExpertPredictor(self.table, top_k=self.top_k).fit()
            demand = pred.predict_demand(telemetry.served_token_stream(),
                                         mode=self.demand_mode)
            plan = self.plan(demand)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        if prev is not None:
            plan.metadata["replan_diff"] = plan_diff(prev, plan)
        return plan

    def feedback_replication(self, policy: DeploymentPlan,
                             real: np.ndarray,
                             alpha: float = 2.0
                             ) -> Tuple[DeploymentPlan, int, np.ndarray]:
        """Alg. 2 lines 10-21: adjust replicas from real-vs-predicted error.

        Returns (policy', rho_case, problem_token_mask_layerwise).
        Delegates to :func:`repro.core.deployment.apply_failure_feedback`
        (usable without a runtime)."""
        return apply_failure_feedback(policy, real, self.profile, self.spec,
                                      alpha=alpha)

    # ------------------------------------------------------------- traces
    def run_trace(self, trace, **kw) -> Dict[str, Any]:
        """Drive a deployment through a demand trace (``repro.traces``):
        not ported yet."""
        raise NotImplementedError(f"run_trace: repro.traces, "
                                  f"plan/incremental.py and plan/tenancy.py "
                                  f"{NOT_PORTED}")

    def replay_telemetry_trace(self, telemetry, **kw) -> Dict[str, Any]:
        """Replay live-serving telemetry as a demand trace: not ported
        yet."""
        raise NotImplementedError(f"replay_telemetry_trace: repro.traces "
                                  f"{NOT_PORTED}")

    # ------------------------------------------------------------ evaluation
    def simulate(self, plan: DeploymentPlan, batches: List[np.ndarray]
                 ) -> List[ExecutionReport]:
        # fresh platform noise per invocation (like real AWS) when jitter>0
        self._sim_calls = getattr(self, "_sim_calls", 0) + 1
        backend = self.simulator_backend(
            seed=self.rc.seed + 1000 * self._sim_calls)
        return backend.execute_batches(plan, Workload(batches=list(batches)))

    def make_eval_fn(self) -> Callable[[KVTable], EvalOutcome]:
        """The BO black box (one Alg. 2 trial body): predict -> plan via
        the Planner protocol -> execute via the simulator backend."""
        batches = self.learn_batches()

        def eval_fn(table: KVTable) -> EvalOutcome:
            pred = ExpertPredictor(table, top_k=self.top_k).fit()
            all_tokens = np.concatenate([b.ravel() for b in batches])
            demand_pred = pred.predict_demand(all_tokens,
                                              mode=self.demand_mode)
            policy = self._plan(demand_pred)
            costs = []
            rho_case = 3
            problems: List[np.ndarray] = []
            reals = []
            for b in batches:
                real = self.real_demand(b)
                reals.append(real)
                policy_j, case_j, problem = self.feedback_replication(
                    policy, real)
                rho_case = min(rho_case, case_j)
                sim = self.simulate(policy_j, [b])[0]
                if sim.mem_overrun.any():
                    rho_case = 1
                elif sim.payload_violation.any():
                    rho_case = min(rho_case, 2)
                costs.append(sim.billed_cost)
                if problem.any():
                    # Alg. 2 line 12: token IDs whose realized routing the
                    # predictor actually missed (real prediction errors,
                    # not the whole batch as a synthetic stand-in)
                    problems.append(self.mispredicted_tokens(pred, b))
            return EvalOutcome(
                cost=float(np.mean(costs)),
                rho_case=rho_case,
                problem_token_ids=(np.concatenate(problems)
                                   if problems else np.zeros(0, np.int64)),
                demand_pred=demand_pred,
                demand_real=np.sum(reals, axis=0),
            )

        return eval_fn

    def run_bo(self, **bo_kwargs) -> BOResult:
        self.profile_table()
        opt = BOOptimizer(self.table, self.make_eval_fn(), **bo_kwargs)
        return opt.run()

    def bo_planner(self, **bo_kwargs) -> BOPlanner:
        """Alg. 2 as a registry-compatible ``Planner``: BO-refine the
        profiled table (each trial planned and executed through the
        protocols), then plan from the refined predictor over the learn
        stream."""
        self.profile_table()
        tokens = np.concatenate([b.ravel() for b in self.learn_batches()])
        return BOPlanner(self.table, self.make_eval_fn(),
                         top_k=self.top_k, demand_mode=self.demand_mode,
                         tokens=tokens, **bo_kwargs)

    def plan_bo(self, **bo_kwargs) -> DeploymentPlan:
        """One-call BO deployment: returns the post-BO DeploymentPlan."""
        planner = self.bo_planner(**bo_kwargs)
        plan = planner.plan(np.zeros((self.num_layers, self.num_experts)),
                            self.profile, self.spec,
                            t_limit_s=self.rc.slo_s, seed=self.rc.seed)
        self.last_plan = plan
        return plan

    # ----------------------------------------------- paper Fig. 14 baselines
    def evaluate_all(self, *, bo_table: Optional[KVTable] = None
                     ) -> Dict[str, Dict[str, float]]:
        self.profile_table()
        batches = self.eval_batches()
        all_tokens = np.concatenate([b.ravel() for b in batches])
        real_total = np.sum([self.real_demand(b) for b in batches], axis=0)
        cluster = CPUClusterSpec()

        def summarize(sims: List[ExecutionReport]) -> Dict[str, float]:
            return {
                "billed_cost": float(np.sum([s.billed_cost for s in sims])),
                "throughput_tps": float(np.mean([s.throughput_tps
                                                 for s in sims])),
                "latency_s": float(np.sum([s.latency_s for s in sims])),
            }

        out: Dict[str, Dict[str, float]] = {}

        def run_policy(name: str, demand: np.ndarray, policy=None):
            policy = policy or self._plan(demand)
            sims = []
            for b in batches:
                p_j, _, _ = self.feedback_replication(policy,
                                                      self.real_demand(b))
                sims.extend(self.simulate(p_j, [b]))
            out[name] = summarize(sims)

        # (1) ours: BO-optimized predicted distribution
        table = bo_table or self.table
        pred = ExpertPredictor(table, top_k=self.top_k).fit()
        run_policy("serverless_bo",
                   pred.predict_demand(all_tokens, mode=self.demand_mode))
        # (2) oracle: real expert selection distribution
        run_policy("serverless_real", real_total)
        # (3) predicted without BO
        pred0 = ExpertPredictor(self.table, top_k=self.top_k).fit()
        run_policy("serverless_no_bo",
                   pred0.predict_demand(all_tokens, mode=self.demand_mode))
        # (3b) Lina-style token-ID-only prediction
        lina = ExpertPredictor(self.table, mode="lina",
                               top_k=self.top_k).fit()
        run_policy("serverless_lina",
                   lina.predict_demand(all_tokens, mode=self.demand_mode))
        # (4) LambdaML: max memory, no prediction, no replicas
        out["lambdaml"] = summarize(self.simulate(
            get_planner("lambdaml").plan(real_total, self.profile,
                                         self.spec), batches))
        # random deployment (Fig. 12)
        out["random_policy"] = summarize(self.simulate(
            get_planner("random").plan(real_total, self.profile, self.spec,
                                       seed=self.rc.seed), batches))
        # (5)/(6) CPU cluster
        n_tok = int(sum(b.size for b in batches))
        cpu = cpu_cluster_result(self.profile, cluster, real_total, n_tok)
        out["cpu_cluster"] = {"billed_cost": cpu.billed_cost,
                              "throughput_tps": cpu.throughput_tps,
                              "latency_s": cpu.latency_s}
        bt = cpu_cluster_result(self.profile, cluster, real_total, n_tok,
                                better_transformer=True)
        out["cpu_better_transformer"] = {"billed_cost": bt.billed_cost,
                                         "throughput_tps": bt.throughput_tps,
                                         "latency_s": bt.latency_s}
        return out
