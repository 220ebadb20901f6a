"""The port's capacity FFN (B4) and gating-only router (B5) against the
reference, and the port ``Model``'s dense executor against the
reference's.

On the CPU each wrapper runs its plain PyTorch version. B4's is held
against the Pallas kernel (``expert_ffn_pallas``, ``interpret=True``) and
the model layer's ``repro.models.moe.expert_ffn`` in float32 within 1e-5;
B5's against ``router_topk_pallas`` with indices equal and weights within
1e-5. The whole model through the dense executor agrees with the
reference's within 1e-4 on the logits (the bound of
``tests/test_torch_model.py``), with the routing summary's integer
fields equal. Inputs come from ``numpy.random.default_rng``; the input
builders are shared with the kernel-vs-plain tests on the card
(``tests/test_torch_gpu.py``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.expert_ffn.ops import expert_ffn_pallas
from repro.kernels.router_topk.ops import router_topk_pallas
from repro.models import Model as JaxModel
from repro.models import moe as jmoe
from repro_torch.kernels.expert_ffn.ops import capacity_ffn
from repro_torch.kernels.router_topk.ops import router_topk
from repro_torch.models import Model

from test_torch_gpu import (CAPACITY_CASES, ROUTER_CASES, capacity_inputs,
                            router_inputs)
from test_torch_harness import CPU, PORT_ARCHS, model_pair, np_, t_

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------- B4 kernel

@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("E,C,D,F,label", CAPACITY_CASES,
                         ids=[c[-1] for c in CAPACITY_CASES])
def test_capacity_plain_matches_pallas_and_model_layer(E, C, D, F, label,
                                                       activation):
    buf, wg, wu, wd = capacity_inputs(E, C, D, F, zero=label == "zero")
    swiglu = activation == "swiglu"
    want = expert_ffn_pallas(jnp.asarray(buf), jnp.asarray(wg),
                             jnp.asarray(wu) if swiglu else None,
                             jnp.asarray(wd), activation=activation,
                             interpret=True)
    params = ({"w_gate": wg, "w_up": wu, "w_down": wd} if swiglu
              else {"w_in": wg, "w_out": wd})
    want_layer = jmoe.expert_ffn({k: jnp.asarray(v) for k, v in
                                  params.items()}, jnp.asarray(buf),
                                 activation)
    got = capacity_ffn(t_(buf), t_(wg), t_(wu) if swiglu else None, t_(wd),
                       activation=activation)
    assert got.dtype == torch.float32 and got.shape == (E, C, D)
    for w in (want, want_layer):
        np.testing.assert_allclose(np_(got), np.asarray(w), **TOL)
    empty = ~buf.any(-1)
    assert not np_(got)[empty].any()            # FFN(0) is exactly 0


# ------------------------------------------------------------- B5 kernel

B5_CASES = ROUTER_CASES + [
    # the reference's padded-row regression: N not a multiple of block_n
    (100, 48, 40, 8, None, "random", 64),
    (64, 16, 64, 4, 60, "random", 64),           # valid_experts < E
]


@pytest.mark.parametrize("N,D,E,k,ve,case,block_n", B5_CASES)
def test_gating_router_plain_matches_pallas(N, D, E, k, ve, case, block_n):
    x, w = router_inputs(N, D, E, case=case)
    wv, wi = router_topk_pallas(jnp.asarray(x), jnp.asarray(w), k=k,
                                valid_experts=ve, block_n=block_n,
                                interpret=True)
    vals, idx = router_topk(t_(x), t_(w), k=k, valid_experts=ve)
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    np.testing.assert_array_equal(np_(idx), np.asarray(wi))
    np.testing.assert_allclose(np_(vals), np.asarray(wv), **TOL)
    np.testing.assert_allclose(np_(vals).sum(-1), 1.0, rtol=1e-5)
    if ve is not None:
        assert (np_(idx) < ve).all()
    if case == "tie":
        assert (np_(idx)[:, :2] == [1, 2]).all()


def test_new_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="swiglu takes w_up"):
        capacity_ffn(torch.zeros(2, 4, 8), torch.zeros(2, 8, 6), None,
                     torch.zeros(2, 6, 8), activation="swiglu")
    with pytest.raises(ValueError):
        capacity_ffn(torch.zeros(2, 4, 8).to("meta"), torch.zeros(2, 8, 6),
                     None, torch.zeros(2, 6, 8), activation="gelu")
    with pytest.raises(ValueError):
        router_topk(torch.zeros(4, 8).to("meta"), torch.zeros(8, 4), k=1)


# ------------------------------------------------- the dense executor

def dense_pair(name: str, capacity_factor):
    """Both models on the same weights with the dense executor; a
    ``capacity_factor`` below 1 makes some expert overflow, so the batch
    drops pairs."""
    cfg_j, _, pj, cfg_t, _, pt = model_pair(name)
    if capacity_factor is not None:
        cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(
            cfg_j.moe, capacity_factor=capacity_factor))
        cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(
            cfg_t.moe, capacity_factor=capacity_factor))
    jm = JaxModel(cfg_j, moe_executor="dense")
    tm = Model(cfg_t, device=CPU, moe_executor="dense")
    return cfg_t, jm, pj, tm, pt


@pytest.mark.parametrize("capacity_factor", [None, 0.5],
                         ids=["config", "drops"])
@pytest.mark.parametrize("name", PORT_ARCHS)
def test_dense_model_matches_reference(name, capacity_factor):
    cfg, jm, pj, tm, pt = dense_pair(name, capacity_factor)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    lj, auxj, _ = jm.forward(pj, jnp.asarray(toks), capture=True)
    with torch.inference_mode():
        lt, auxt, _ = tm.forward(pt, torch.as_tensor(toks), capture=True)
    np.testing.assert_allclose(np_(lt), np.asarray(lj), **LOGIT_TOL)
    sj = auxj["captures"]["pos0"]["routing"]
    st = auxt["captures"]["pos0"]["routing"]
    for f in ("expert_counts", "kept_counts", "dropped", "drop_mask",
              "group_offsets", "capacity"):
        np.testing.assert_array_equal(np_(getattr(st, f)),
                                      np.asarray(getattr(sj, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(np_(auxt["captures"]["pos0"]["topk_idx"]),
                                  np.asarray(
                                      auxj["captures"]["pos0"]["topk_idx"]))
    if capacity_factor is not None:
        assert int(np_(st.dropped).sum()) > 0
