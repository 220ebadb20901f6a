"""The port's ``ServerlessMoERuntime`` against ``repro.core.runtime``.

Reduced gpt2-moe and qwen2-moe-a2.7b runtimes on both sides, the port's
on the CPU. The port's ``params`` are set to the reference's (after the
trained-routing emulation, through ``params_from_numpy``) and its
``u_ref_s`` to the reference's (a wall-clock number, measured anew on
each side). From there every stage of the loop is bit-equal: corpus
batches, real demand, the KV table, the predictor's demand, the ODS
plan's JSON (ODS and BO plans carry no timing metadata, so the whole
JSON compares), the simulator's billed report, BO's iterations and best
cost, and ``plan_from_telemetry`` on one telemetry object fed to both.
"""
import copy
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.core.runtime import ServerlessMoERuntime as JaxRuntime
from repro.plan.schema import Workload as JaxWorkload
from repro.predict import ExpertPredictor as JaxPredictor
from repro_torch.core.runtime import (RuntimeConfig, ServerlessMoERuntime,
                                      U_REF_RANGE_S)
from repro_torch.params import params_from_numpy
from repro_torch.plan import get_backend, get_planner
from repro_torch.plan.schema import Workload
from repro_torch.predict import ExpertPredictor
from repro_torch.serving import ServingEngine

from test_torch_harness import CPU, PORT_ARCHS, params_to_numpy

SMALL = dict(batch_size=2, seq_len=16, profile_batches=2, learn_batches=1,
             eval_batches=1)


@functools.lru_cache(maxsize=None)
def runtime_pair(arch: str):
    """(reference runtime, port runtime) on the same weights and u_ref_s."""
    rj = JaxRuntime(JaxRuntimeConfig(arch=arch, **SMALL))
    rt = ServerlessMoERuntime(RuntimeConfig(arch=arch, **SMALL), device=CPU)
    rt.params = params_from_numpy(jax.tree.map(np.asarray, rj.params),
                                  device=CPU)
    rt.profile = dataclasses.replace(rt.profile,
                                     u_ref_s=rj.profile.u_ref_s)
    return rj, rt


def all_batches(rt):
    n = rt.rc.profile_batches + rt.rc.learn_batches + rt.rc.eval_batches
    return [b["tokens"] for b in rt.corpus.batches(n)]


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_runtime_setup_matches_reference(arch):
    """Same corpus, configuration and profile; the port's own weights go
    through the same trained-routing emulation as the reference's."""
    rj, rt = runtime_pair(arch)
    for bj, bt in zip(all_batches(rj), all_batches(rt)):
        np.testing.assert_array_equal(bt, bj)
    assert dataclasses.asdict(rt.cfg) == dataclasses.asdict(rj.cfg)
    assert dataclasses.asdict(rt.profile) == dataclasses.asdict(rj.profile)
    raw = rj.model.init_params(jax.random.PRNGKey(0))
    want = JaxRuntime._emulate_trained_routing(raw, 12.0, 0.05)
    got = ServerlessMoERuntime._emulate_trained_routing(
        params_from_numpy(jax.tree.map(np.asarray, raw), device=CPU),
        12.0, 0.05)
    assert jax.tree.map(np.asarray, want).keys() == got.keys()
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = params_to_numpy(got)
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_profiling_and_prediction_match_reference(arch):
    """Capture forwards through the dense executor give the reference's
    routing: real demand, KV-table counts and the predictor's demand."""
    rj, rt = runtime_pair(arch)
    for b in rt.learn_batches() + rt.eval_batches():
        dt = rt.real_demand(b)
        np.testing.assert_array_equal(dt, rj.real_demand(b))
        assert dt.sum() == b.size * rt.top_k * rt.num_layers
    tj, tt = rj.profile_table(), rt.profile_table()
    assert tt.counts == tj.counts
    np.testing.assert_array_equal(tt.demand_matrix(), tj.demand_matrix())
    tokens = np.concatenate([b.ravel() for b in rt.learn_batches()])
    pt = ExpertPredictor(tt, top_k=rt.top_k).fit()
    pj = JaxPredictor(tj, top_k=rj.top_k).fit()
    np.testing.assert_array_equal(
        pt.predict_demand(tokens, mode=rt.demand_mode),
        pj.predict_demand(tokens, mode=rj.demand_mode))


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_ods_plan_and_simulator_bill_match_reference(arch):
    rj, rt = runtime_pair(arch)
    rj.profile_table()
    rt.profile_table()
    tokens = np.concatenate([b.ravel() for b in rt.learn_batches()])
    demand = ExpertPredictor(rt.table, top_k=rt.top_k).fit().predict_demand(
        tokens, mode=rt.demand_mode)
    plan_t, plan_j = rt.plan(demand), rj.plan(demand)
    assert plan_t.to_json() == plan_j.to_json()
    batches = rt.eval_batches()
    rep_t = rt.simulator_backend().execute(plan_t, Workload(batches))
    rep_j = rj.simulator_backend().execute(plan_j, JaxWorkload(batches))
    assert rep_t.to_dict() == rep_j.to_dict()
    assert np.isfinite(rep_t.billed_cost) and rep_t.billed_cost > 0


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_bo_plan_matches_reference(arch):
    """Alg. 2 over the simulator backend: same iterations, best cost and
    plan."""
    rj, rt = runtime_pair(arch)
    plan_t = rt.plan_bo(Q=10, max_iters=2, seed=0)
    plan_j = rj.plan_bo(Q=10, max_iters=2, seed=0)
    assert plan_t.metadata["bo"]["iterations"] == 2
    assert plan_t.metadata["bo"] == plan_j.metadata["bo"]
    assert plan_t.to_json() == plan_j.to_json()


def test_replan_from_shared_telemetry_matches_reference():
    """The port's engine serves under the BO plan (billed by the port's
    serving backend); its telemetry then re-plans both runtimes alike."""
    rj, rt = runtime_pair("gpt2-moe")
    plan = rt.plan_bo(Q=10, max_iters=2, seed=0)
    rj.plan_bo(Q=10, max_iters=2, seed=0)
    eng = ServingEngine(rt.model, rt.params, max_len=32, batch_size=2,
                        predictor=rt.online_predictor(decay=0.98),
                        device=CPU)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, rt.cfg.vocab_size, n) for n in (6, 9, 4)]
    rep = rt.serving_backend(eng).execute(
        plan, Workload(batches=prompts, max_new_tokens=4))
    assert rep.extras["finish_reasons"] == ["length"] * 3
    assert np.isfinite(rep.billed_cost) and rep.billed_cost > 0
    tel = eng.telemetry
    assert (tel.demand_matrix().sum()
            == tel.total_tokens * rt.top_k * rt.num_layers)
    # ingesting flushes the telemetry's pending records: each side gets
    # its own copy of the one object
    new_j = rj.plan_from_telemetry(copy.deepcopy(tel))
    new_t = rt.plan_from_telemetry(tel)
    assert "replan_diff" in new_t.metadata
    assert new_t.to_json() == new_j.to_json()
    assert rt.table.counts == rj.table.counts


def test_calibration_clamps_the_measured_u_ref():
    _, rt = runtime_pair("gpt2-moe")
    assert rt.u_ref_measured_s > 0
    fresh = ServerlessMoERuntime(RuntimeConfig(arch="gpt2-moe", **SMALL),
                                 device=CPU)
    lo, hi = U_REF_RANGE_S
    assert fresh.profile.u_ref_s == min(max(fresh.u_ref_measured_s, lo), hi)


def test_waiting_methods_raise_not_implemented(monkeypatch):
    _, rt = runtime_pair("gpt2-moe")
    waiting = [lambda: rt.run_trace(None),
               lambda: rt.replay_telemetry_trace(None),
               rt.distributed_backend,
               lambda: rt.make_backend("distributed"),
               lambda: get_backend("distributed")]
    waiting += [functools.partial(get_planner, name)
                for name in ("ods-cached", "ods-incremental", "ods-tenant")]
    for call in waiting:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServerlessMoERuntime(RuntimeConfig(arch="gpt2-moe", **SMALL))
