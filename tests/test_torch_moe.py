"""The port's MoE layer against the reference's ``repro.models.moe``.

Same block-0 weights on both sides (reduced gpt2-moe: GELU, top-1;
reduced qwen2-moe: SwiGLU, top-2, shared expert), inputs from
``numpy.random.default_rng``. Integer plans and the ``RoutingSummary``
are bit-equal; ``y`` agrees within 1e-5 in float32.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.traces import zipf_routing
from repro_torch.kernels.router_topk.ref import stable_ranks
from repro_torch.models import moe as tmoe

from test_torch_harness import PORT_ARCHS, block0_moe, model_pair, np_, t_


def skewed(name, mode, seed=0):
    """(jax params, port params, x numpy) with the router biased toward a
    Zipf(1.2) popularity, or rigged so every pair lands on the top-k
    LAST experts ("all-to-one")."""
    mj, mt = block0_moe(name)
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.normal(size=(2, 24, mt["router"].shape[0]))
         ).astype(np.float32)
    w = np_(mt["router"]).copy()
    E = w.shape[-1]
    if mode == "zipf":
        zipf = (1.0 / np.arange(1, E + 1)) ** 1.2
        w += 4.0 * np.log(rng.permutation(zipf / zipf.max()) + 1e-9)[None]
    elif mode == "all-to-one":
        x[..., 0] = rng.uniform(0.5, 1.5, size=x.shape[:-1])
        w[0, :] = -10.0
        w[0, E - 1], w[0, E - 2] = 2.0, 1.0
    mj = dict(mj, router=jnp.asarray(w))
    mt = dict(mt, router=t_(w))
    return mj, mt, x


def assert_summary_equal(sj, st):
    for f in jmoe.RoutingSummary._fields:
        np.testing.assert_array_equal(np_(getattr(st, f)),
                                      np.asarray(getattr(sj, f)),
                                      err_msg=f)


@pytest.mark.parametrize("mode", ["zipf", "all-to-one"])
@pytest.mark.parametrize("router_impl", ["fused", "reference"])
@pytest.mark.parametrize("executor", ["dense", "grouped", "oracle"])
@pytest.mark.parametrize("name", PORT_ARCHS)
def test_moe_forward_matches_reference(name, executor, router_impl, mode):
    cfg_j, _, _, cfg_t, _, _ = model_pair(name)
    mj, mt, x = skewed(name, mode)
    yj, auxj = jmoe.moe_forward(mj, cfg_j, jnp.asarray(x), executor=executor,
                                router_impl=router_impl, capture=True)
    yt, auxt = tmoe.moe_forward(mt, cfg_t, t_(x), executor=executor,
                                router_impl=router_impl, capture=True)
    assert_summary_equal(auxj["routing"], auxt["routing"])
    for key in ("topk_idx", "expert_counts"):
        np.testing.assert_array_equal(np_(auxt[key]), np.asarray(auxj[key]))
    np.testing.assert_allclose(np_(auxt["topk_weight"]),
                               np.asarray(auxj["topk_weight"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(yt), np.asarray(yj), rtol=1e-5, atol=1e-5)
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(auxt[key]), float(auxj[key]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", PORT_ARCHS)
def test_fused_and_pallas_routing_agree_with_port(name):
    """The port's fused router (plain version on the CPU) against the
    reference's Pallas route: integers bit-equal, losses within 1e-5."""
    mj, mt, x = skewed(name, "zipf")
    cfg_j, _, _, cfg_t, _, _ = model_pair(name)
    xf = x.reshape(-1, x.shape[-1])
    rj = jmoe.route_fused_pallas(mj["router"], jnp.asarray(xf), cfg_j.moe,
                                 valid_experts=cfg_j.moe.num_experts)
    rt = tmoe.route_fused(mt["router"], t_(xf), cfg_t.moe,
                          valid_experts=cfg_t.moe.num_experts)
    for f in ("topk_idx", "pos_in_e", "expert_counts"):
        np.testing.assert_array_equal(np_(getattr(rt, f)),
                                      np.asarray(getattr(rj, f)))
    for f in ("topk_weight", "lb_loss", "z_loss"):
        np.testing.assert_allclose(np_(getattr(rt, f)),
                                   np.asarray(getattr(rj, f)),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("E,k,alpha", [(4, 1, 1.2), (8, 2, 2.0), (60, 4, 0.8),
                                       (16, 4, 0.0)])
def test_dispatch_plans_bit_equal_on_zipf_routing(E, k, alpha):
    """Every plan builder, fed Zipf-skewed routes, gives the reference's
    integers; the fused and separate-pass builders agree."""
    n = 37
    idx = zipf_routing(n, E, k, alpha=alpha, seed=3)
    idx_t = t_(idx)
    pos_t, counts_t = stable_ranks(idx_t, E)
    fr_t = tmoe.FusedRouting(idx_t, torch.ones(n, k), pos_t, counts_t,
                             torch.zeros(()), torch.zeros(()))
    C = jmoe.capacity_for(n, jmoe.MoEConfig(E, k, 8), E)
    assert C == tmoe.capacity_for(n, tmoe.MoEConfig(E, k, 8), E)
    for tp, jp in ((tmoe.build_dispatch(idx_t, E, C),
                    jmoe.build_dispatch(jnp.asarray(idx), E, C)),
                   (tmoe.dispatch_plan_from_fused(fr_t, E, C),
                    jmoe.build_dispatch(jnp.asarray(idx), E, C))):
        for f in ("slot_of_pair", "kept", "expert_counts"):
            np.testing.assert_array_equal(np_(getattr(tp, f)),
                                          np.asarray(getattr(jp, f)))
    gj = jmoe.build_grouped_dispatch(jnp.asarray(idx), E)
    gj16 = jmoe.build_grouped_dispatch(jnp.asarray(idx), E, block_rows=16,
                                       row_multiple=2)
    for gt, gj in ((tmoe.build_grouped_dispatch(idx_t, E), gj),
                   (tmoe.grouped_dispatch_from_fused(fr_t, E), gj),
                   (tmoe.build_grouped_dispatch(idx_t, E, block_rows=16,
                                                row_multiple=2), gj16)):
        for f in ("row_of_pair", "tile_expert", "group_offsets",
                  "expert_counts"):
            np.testing.assert_array_equal(np_(getattr(gt, f)),
                                          np.asarray(getattr(gj, f)),
                                          err_msg=f)
        assert gt.num_rows == gj.num_rows


@pytest.mark.parametrize("n,k,E,cf", [(8, 1, 4, 1.0), (24, 2, 8, 1.25),
                                      (37, 4, 60, 1.1), (5, 2, 3, 0.3)])
def test_capacity_for_is_exact(n, k, E, cf):
    mj = jmoe.MoEConfig(E, k, 8, capacity_factor=cf)
    mt = tmoe.MoEConfig(E, k, 8, capacity_factor=cf)
    assert tmoe.capacity_for(n, mt, E) == jmoe.capacity_for(n, mj, E)


def test_dense_drops_match_reference_under_skew():
    """Capacity drops (the dense executor's tax) equal the reference's."""
    name = "qwen2-moe-a2.7b"
    cfg_j, _, _, cfg_t, _, _ = model_pair(name)
    cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(
        cfg_j.moe, capacity_factor=0.5))
    cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(
        cfg_t.moe, capacity_factor=0.5))
    mj, mt, x = skewed(name, "zipf", seed=5)
    yj, auxj = jmoe.moe_forward(mj, cfg_j, jnp.asarray(x), executor="dense")
    yt, auxt = tmoe.moe_forward(mt, cfg_t, t_(x), executor="dense")
    assert np_(auxt["routing"].dropped).sum() > 0
    assert_summary_equal(auxj["routing"], auxt["routing"])
    np.testing.assert_allclose(np_(yt), np.asarray(yj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["zipf", "all-to-one"])
def test_executors_agree_with_oracle_including_shared_expert(mode):
    """Port copy of the executor-equivalence contract: dense (recombined
    over its kept pairs, PLUS the shared-expert term ``moe_forward`` adds)
    and grouped equal the oracle executor."""
    name = "qwen2-moe-a2.7b"
    _, _, _, cfg, _, _ = model_pair(name)
    _, mt, x = skewed(name, mode, seed=2)
    xt = t_(x)
    yo, auxo = tmoe.moe_forward(mt, cfg, xt, executor="oracle")
    yg, _ = tmoe.moe_forward(mt, cfg, xt, executor="grouped")
    np.testing.assert_allclose(np_(yg), np_(yo), rtol=1e-5, atol=1e-5)
    yd, auxd = tmoe.moe_forward(mt, cfg, xt, executor="dense")
    xf = xt.reshape(-1, xt.shape[-1])
    r = tmoe.route(mt["router"], xf, cfg.moe,
                   valid_experts=cfg.moe.num_experts)
    sel = torch.take_along_dim(
        tmoe._all_experts_out(mt, cfg.activation, xf).movedim(0, 1),
        r.topk_idx.long()[..., None], dim=1)
    w = torch.where(auxd["routing"].drop_mask, 0.0, r.topk_weight)
    y_manual = torch.einsum("nkd,nk->nd", sel, w)
    y_manual = y_manual + tmoe.mlp_forward(mt["shared"], xf, cfg.activation)
    np.testing.assert_allclose(np_(yd).reshape(y_manual.shape),
                               np_(y_manual), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(np_(auxd["expert_counts"]),
                                  np_(auxo["expert_counts"]))


def test_unknown_router_impl_names_the_fused_kernel():
    name = "gpt2-moe"
    _, _, _, cfg, _, _ = model_pair(name)
    _, mt = block0_moe(name)
    with pytest.raises(ValueError, match="fused"):
        tmoe.moe_forward(mt, cfg, torch.zeros(1, 2, cfg.d_model),
                         router_impl="pallas")
