"""The port's ``Model`` against ``repro.models.Model`` end to end.

Reduced gpt2-moe and qwen2-moe-a2.7b with the same weights: prefill
logits and captures, then decode steps teacher-forced on the reference's
greedy tokens. Logits agree within 1e-4; greedy tokens are equal
wherever the reference's top-2 logit gap is above 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import PORT_ARCHS, model_pair, np_

STEPS = 6
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def assert_greedy_equal(lt, lj):
    """argmax equal where the reference's top-2 gap exceeds 1e-3."""
    top2 = np.sort(lj, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-3
    np.testing.assert_array_equal(lt.argmax(-1)[clear], lj.argmax(-1)[clear])


@pytest.mark.parametrize("kernels", ["fused", "reference"])
@pytest.mark.parametrize("name", PORT_ARCHS)
def test_prefill_and_decode_match_reference(name, kernels):
    cfg_j, jm, pj, cfg_t, tm, pt = model_pair(name)
    rng = np.random.default_rng(0)
    B, S, max_len = 2, 10, 24
    toks = rng.integers(0, cfg_t.vocab_size, size=(B, S)).astype(np.int32)
    lj, cj, auxj = jm.prefill(pj, jnp.asarray(toks), capture=True,
                              moe_executor="grouped",
                              moe_router_impl=kernels)
    lt, ct, auxt = tm.prefill(pt, torch.as_tensor(toks), capture=True,
                              moe_executor="grouped",
                              moe_router_impl=kernels)
    np.testing.assert_allclose(np_(lt), np.asarray(lj), **LOGIT_TOL)
    capj, capt = auxj["captures"]["pos0"], auxt["captures"]["pos0"]
    for key in ("topk_idx", "attn_argmax", "expert_counts"):
        np.testing.assert_array_equal(np_(capt[key]), np.asarray(capj[key]))
    np.testing.assert_array_equal(np_(capt["routing"].group_offsets),
                                  np.asarray(capj["routing"].group_offsets))
    np.testing.assert_allclose(float(auxt["lb_loss"]),
                               float(auxj["lb_loss"]), rtol=1e-5)

    cj = jm.prepare_decode_cache(cj, max_len)
    ct = tm.prepare_decode_cache(ct, max_len)
    tok_j = np.asarray(lj)[:, -1].argmax(-1)
    assert_greedy_equal(np_(lt)[:, -1], np.asarray(lj)[:, -1])
    pos = np.full(B, S, np.int32)
    backend = "kernel" if kernels == "fused" else "torch"
    kw_j = dict(moe_executor="grouped", moe_router_impl=kernels)
    for step in range(STEPS):
        kv_len = int(pos.max()) + 1 if kernels == "fused" else None
        lj, cj = jm.decode_step(pj, jnp.asarray(tok_j[:, None]), cj,
                                jnp.asarray(pos), kv_len=kv_len, **kw_j)
        lt, ct = tm.decode_step(pt, torch.as_tensor(tok_j[:, None]), ct,
                                torch.as_tensor(pos), kv_len=kv_len,
                                attn_backend=backend, **kw_j)
        np.testing.assert_allclose(np_(lt), np.asarray(lj), **LOGIT_TOL)
        assert_greedy_equal(np_(lt)[:, -1], np.asarray(lj)[:, -1])
        tok_j = np.asarray(lj)[:, -1].argmax(-1)
        pos += 1
    np.testing.assert_allclose(np_(ct["pos0"]["attn"]["k"]),
                               np.asarray(cj["pos0"]["attn"]["k"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", PORT_ARCHS)
def test_decode_consistency_with_full_forward(name):
    """Port analogue of the reference's decode-consistency test: prefill
    then per-token decode (capture on and off) reproduces the full-sequence
    forward's logits."""
    _, _, _, cfg, tm, pt = model_pair(name)
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 12)))
    full, _, _ = tm.forward(pt, toks)
    logits, cache = tm.prefill(pt, toks[:, :8])
    cache = tm.prepare_decode_cache(cache, 16)
    for t in range(8, 12):
        capture = t % 2 == 0
        out = tm.decode_step(pt, toks[:, t:t + 1], cache, torch.tensor([t]),
                             capture=capture, kv_len=t + 1,
                             attn_backend="kernel")
        step, cache = out[:2]
        np.testing.assert_allclose(np_(step[:, 0]), np_(full[:, t]),
                                   rtol=1e-4, atol=1e-4)
        if capture:
            assert out[2]["pos0"]["topk_idx"].shape == (
                cfg.num_blocks, 1, 1, cfg.moe.top_k)


def test_model_without_device_raises_without_cuda(monkeypatch):
    """No device and no GPU: the entry point raises, it does not quietly
    run on the CPU."""
    from repro_torch.models import Model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, cfg, _, _ = model_pair("gpt2-moe")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)


def test_unported_mixers_raise():
    import dataclasses
    from repro_torch.config import LayerSpec
    from repro_torch.models import Model
    _, _, _, cfg, _, _ = model_pair("gpt2-moe")
    bad = dataclasses.replace(cfg, pattern=(LayerSpec("swa", "moe"),),
                              sliding_window=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(bad, device="cpu")
