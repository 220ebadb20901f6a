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

from test_torch_gpu import (CAPACITY_CASES, CAPACITY_PATH_CASES,
                            ROUTER_CASES, capacity_inputs, router_inputs)
from test_torch_harness import CPU, PORT_ARCHS, model_pair, np_, t_

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------- B4 kernel

# the GPU tests' element-wise staging case joins the parity cases (the
# split-K calibration shape is too large for interpret mode)
PARITY_CASES = CAPACITY_CASES + [c for c in CAPACITY_PATH_CASES
                                 if c[-1] == "unaligned-rows"]


@pytest.mark.parametrize("activation", ["gelu", "swiglu"])
@pytest.mark.parametrize("E,C,D,F,label", PARITY_CASES,
                         ids=[c[-1] for c in PARITY_CASES])
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


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: what ``cvt.rna.tf32.f32`` gives the tensor cores."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tensor_core_product(a: torch.Tensor, b: torch.Tensor,
                        arithmetic: str) -> torch.Tensor:
    """a @ b as the capacity FFN kernel (``csrc/expert_ffn.cu``) feeds the
    tensor cores in float32: ``3xtf32`` splits each operand into a TF32
    high part and a TF32 residual and sums a_lo b_hi + a_hi b_lo + a_hi
    b_hi in float32 (lo lo dropped); ``1xtf32`` is a single TF32 product.
    TF32 x TF32 is exact in float32, so float32 products emulate them."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    if arithmetic == "1xtf32":
        return a_hi @ b_hi
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


@pytest.mark.parametrize("arithmetic,meets_tolerance",
                         [("3xtf32", True), ("1xtf32", False)])
def test_float32_tensor_core_arithmetic_meets_the_kernel_tolerance(
        arithmetic, meets_tolerance):
    """The float32 design of B4 on the tensor cores: at gpt2-moe's width
    (C 64, D 768, F 3072, GELU) 3xTF32 stays within the kernel-vs-plain
    float32 tolerance (3e-5) of a float64 reference, and a single TF32
    product does not, which is why the kernel pays for three."""
    buf, wg, _, wd = capacity_inputs(1, 64, 768, 3072)
    x, g, d = (torch.from_numpy(a[0]) for a in (buf, wg, wd))
    h = torch.nn.functional.gelu(tensor_core_product(x, g, arithmetic),
                                 approximate="tanh")
    got = tensor_core_product(h, d, arithmetic)
    h64 = torch.nn.functional.gelu(x.double() @ g.double(),
                                   approximate="tanh")
    want = h64 @ d.double()
    within = np.allclose(got.numpy(), want.numpy(), rtol=3e-5, atol=3e-5)
    assert within == meets_tolerance, float((got.double() - want).abs().max())


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
