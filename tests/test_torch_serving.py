"""The port's ``ServingEngine`` against ``repro.serving.ServingEngine``,
and the guard tests of the port's rules.

One request stream (ragged prompts, more requests than slots, so requests
are admitted mid-stream) through both engines on the same weights:
outputs, finish reasons and ``demand_matrix()`` are identical. The
reference's ``ServingBackend`` drives both engines unchanged and bills the
same GB-seconds.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.costmodel import ModelProfile, PlatformSpec
from repro.core.deployment import solve_fixed_method
from repro.plan.backends import ServingBackend
from repro.plan.schema import DeploymentPlan, Workload
from repro.serving import ServingEngine as JaxEngine
from repro_torch.serving import ServingEngine

from test_torch_harness import CPU, model_pair

SRC = str(Path(__file__).resolve().parents[1] / "src")


def prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def serve(engine, stream, max_new=5, **run_kw):
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in stream]
    engine.run(**run_kw)
    return reqs


def assert_same_service(ra, rb, ea, eb):
    assert [r.output for r in ra] == [r.output for r in rb]
    assert [r.finish_reason for r in ra] == [r.finish_reason for r in rb]
    if ea.telemetry is not None:
        np.testing.assert_array_equal(ea.telemetry.demand_matrix(),
                                      eb.telemetry.demand_matrix())
        np.testing.assert_array_equal(ea.telemetry.dropped_matrix(),
                                      eb.telemetry.dropped_matrix())
        assert ea.telemetry.total_tokens == eb.telemetry.total_tokens


# each arch, kernel path and telemetry setting twice, in four runs
@pytest.mark.parametrize("name,kernels,telemetry", [
    ("gpt2-moe", "fused", True), ("gpt2-moe", "reference", False),
    ("qwen2-moe-a2.7b", "fused", False),
    ("qwen2-moe-a2.7b", "reference", True)])
def test_engine_matches_reference_engine(name, kernels, telemetry):
    _, jm, pj, cfg, tm, pt = model_pair(name)
    stream = prompts(cfg.vocab_size, [5, 9, 3, 12, 7])
    kw = dict(max_len=32, batch_size=2, collect_telemetry=telemetry,
              kernels=kernels)
    je = JaxEngine(jm, pj, **kw)
    te = ServingEngine(tm, pt, device=CPU, **kw)
    rj, rt = serve(je, stream), serve(te, stream)
    assert all(r.finish_reason == "length" for r in rt)
    assert_same_service(rt, rj, te, je)
    if telemetry:
        tel = te.telemetry
        assert (tel.demand_matrix().sum()
                == tel.total_tokens * cfg.moe.top_k * cfg.num_layers)


def test_truncation_and_dead_slots_match_reference():
    """Requests that run into ``max_len`` finish ``"truncated"``; their
    slot then decodes dead at ``pos == max_len`` (a dropped write in the
    reference, a masked one here) without disturbing live slots."""
    _, jm, pj, cfg, tm, pt = model_pair("gpt2-moe")
    stream = prompts(cfg.vocab_size, [14, 4, 9], seed=1)
    kw = dict(max_len=18, batch_size=2)
    je = JaxEngine(jm, pj, **kw)
    te = ServingEngine(tm, pt, device=CPU, **kw)
    rj, rt = serve(je, stream, max_new=9), serve(te, stream, max_new=9)
    assert "truncated" in [r.finish_reason for r in rt]
    assert_same_service(rt, rj, te, je)


def test_step_budget_and_prefix_cache_match_reference():
    """Budget exhaustion (truncated, still-queued requests) and the prompt
    prefix cache (exact hits and extended prefixes) behave as in the
    reference."""
    _, jm, pj, cfg, tm, pt = model_pair("qwen2-moe-a2.7b")
    base = prompts(cfg.vocab_size, [6], seed=2)[0]
    stream = [base, base, np.concatenate([base, base[:3]]), base[:4]]
    kw = dict(max_len=32, batch_size=1, prefix_cache_size=4,
              collect_telemetry=False)
    je = JaxEngine(jm, pj, **kw)
    te = ServingEngine(tm, pt, device=CPU, **kw)
    rj, rt = serve(je, stream), serve(te, stream)
    assert_same_service(rt, rj, te, je)
    assert te.prefix_cache.stats() == je.prefix_cache.stats()
    assert te.prefix_cache.stats()["prefix_hits"] >= 1
    je2 = JaxEngine(jm, pj, max_len=32, batch_size=2)
    te2 = ServingEngine(tm, pt, device=CPU, max_len=32, batch_size=2)
    rj2 = serve(je2, stream, max_steps=3)
    rt2 = serve(te2, stream, max_steps=3)
    assert_same_service(rt2, rj2, te2, je2)
    assert te2.pending == je2.pending > 0


def test_serving_backend_bills_both_engines_alike():
    """The reference's ServingBackend drives the port's engine unchanged
    (it calls only submit, run and telemetry): same finish reasons and the
    same billed GB-seconds as over the reference engine."""
    _, jm, pj, cfg, tm, pt = model_pair("gpt2-moe")
    L, E = cfg.num_layers, cfg.moe.num_experts
    prof = ModelProfile(num_moe_layers=L, experts_per_layer=E,
                        expert_param_bytes=2e6, token_in_bytes=1024.0,
                        token_out_bytes=1024.0, u_ref_s=2e-4,
                        intermediate_bytes=1e6, nonmoe_param_bytes=4e6)
    spec = PlatformSpec()
    demand = np.full((L, E), 20.0)
    sol = solve_fixed_method(1, demand, prof, spec)
    plan = DeploymentPlan(method=np.full(L, 1, np.int64), beta=2,
                          mem_mb=sol.mem_mb, replicas=sol.replicas,
                          demand=demand, layer_cost=sol.layer_cost,
                          layer_latency=sol.layer_latency)
    work = Workload(batches=prompts(cfg.vocab_size, [6, 8, 5], seed=4),
                    max_new_tokens=4)
    reps = []
    for eng in (JaxEngine(jm, pj, max_len=32, batch_size=2),
                ServingEngine(tm, pt, max_len=32, batch_size=2, device=CPU)):
        rep = ServingBackend(eng, prof, spec).execute(plan, work)
        reps.append((rep, eng))
    (rj, ej), (rt, et) = reps
    assert rt.billed_cost == rj.billed_cost
    np.testing.assert_array_equal(rt.real_demand, rj.real_demand)
    assert rt.extras["finish_reasons"] == rj.extras["finish_reasons"]
    assert rt.extras["dispatch_rounds"] == rj.extras["dispatch_rounds"]


def test_engine_rejects_pallas_kernels_naming_fused():
    _, _, _, _, tm, pt = model_pair("gpt2-moe")
    with pytest.raises(ValueError, match="fused"):
        ServingEngine(tm, pt, device=CPU, kernels="pallas")


def test_engine_without_device_raises_without_cuda(monkeypatch):
    _, _, _, _, tm, pt = model_pair("gpt2-moe")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tm, pt)


NO_JAX_SCRIPT = """
import sys
import numpy as np, torch
import repro_torch
from repro_torch import Model, ServingEngine, get_arch, reduced_config
cfg = reduced_config(get_arch("gpt2-moe"), d_model=64, vocab=128)
model = Model(cfg, device="cpu", moe_executor="grouped")
params = model.init_params(torch.Generator().manual_seed(0))
eng = ServingEngine(model, params, max_len=16, batch_size=2, device="cpu")
for n in (3, 5, 4):
    eng.submit(np.arange(n) % cfg.vocab_size, max_new_tokens=3)
done = eng.run()
assert [r.finish_reason for r in done] == ["length"] * 3
import repro_torch.core.runtime, repro_torch.plan, repro_torch.predict
from repro_torch.core.runtime import RuntimeConfig, ServerlessMoERuntime
rt = ServerlessMoERuntime(RuntimeConfig(
    arch="gpt2-moe", batch_size=2, seq_len=8, profile_batches=1,
    d_model_reduced=32, vocab_reduced=128), device="cpu")
assert len(rt.profile_table().counts) > 0
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "repro" or m.startswith("repro.")]
print("LEAKED", bad)
"""


def test_port_imports_neither_jax_nor_repro():
    """``import repro_torch``, a tiny CPU serving run, the runtime, plan and
    predict packages and one CPU runtime ``profile_table()`` leave ``jax``
    and every ``repro`` module out of ``sys.modules``."""
    out = subprocess.run([sys.executable, "-c", NO_JAX_SCRIPT],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
