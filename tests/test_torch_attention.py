"""The port's attention against ``repro.models.attention``.

Block-0 attention weights of the reduced models on both sides. The
decode step runs per-slot positions, the ragged ``kv_len`` slice, the
attention-ID capture and a dead slot at ``pos == max_len`` (whose cache
write the reference drops), on both the dense path and the flash-decode
wrapper (its plain version on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.models import attention as tattn

from test_torch_harness import PORT_ARCHS, model_pair, np_, t_


def attn_params(name):
    cfg_j, _, pj, cfg_t, _, pt = model_pair(name)
    aj = jax.tree.map(lambda a: a[0], pj["blocks"]["pos0"]["attn"])
    at = {k: v[0] for k, v in pt["blocks"]["pos0"]["attn"].items()}
    rope = cfg_t.rope_theta if cfg_t.pos_embed == "rope" else 0.0
    return cfg_j, aj, cfg_t, at, rope


@pytest.mark.parametrize("name", PORT_ARCHS)
@pytest.mark.parametrize("flash", [False, True])
def test_attention_forward_matches_reference(name, flash):
    """Prefill attention: output, rope'd cache and (dense) attention IDs;
    ``flash`` forces the blocked online-softmax path."""
    cfg_j, aj, cfg_t, at, rope = attn_params(name)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 24, cfg_t.d_model)).astype(np.float32)
    thr = 4 if flash else 2048
    capture = not flash
    yj, cj, amj = jattn.attention_forward(
        aj, cfg_j, jnp.asarray(x), positions=jnp.arange(24),
        rope_theta=rope, capture=capture, flash_threshold=thr)
    yt, ct, amt = tattn.attention_forward(
        at, cfg_t, t_(x), positions=torch.arange(24), rope_theta=rope,
        capture=capture, flash_threshold=thr)
    np.testing.assert_allclose(np_(yt), np.asarray(yj), rtol=1e-5, atol=1e-5)
    for key in ("k", "v"):
        np.testing.assert_allclose(np_(ct[key]), np.asarray(cj[key]),
                                   rtol=1e-5, atol=1e-5)
    if capture:
        np.testing.assert_array_equal(np_(amt), np.asarray(amj))
    else:
        assert amt is None and amj is None


@pytest.mark.parametrize("name", PORT_ARCHS)
@pytest.mark.parametrize("backend,capture", [("torch", True),
                                             ("torch", False),
                                             ("kernel", False)])
def test_decode_step_per_slot_matches_reference(name, backend, capture):
    cfg_j, aj, cfg_t, at, rope = attn_params(name)
    B, T = 4, 32
    rng = np.random.default_rng(1)
    nkv, hd = cfg_t.num_kv_heads, cfg_t.resolved_head_dim
    k0 = rng.normal(size=(B, T, nkv, hd)).astype(np.float32)
    v0 = rng.normal(size=(B, T, nkv, hd)).astype(np.float32)
    x = rng.normal(size=(B, 1, cfg_t.d_model)).astype(np.float32)
    # slot 3 is dead at pos == max_len: its write must be dropped
    pos = np.asarray([3, 11, 0, T], np.int32)
    kv_len = 16
    yj, cj, amj = jattn.attention_decode_step(
        aj, cfg_j, jnp.asarray(x), {"k": jnp.asarray(k0),
                                    "v": jnp.asarray(v0)},
        pos=jnp.asarray(pos), rope_theta=rope, capture=capture,
        kv_len=kv_len)
    cache_t = {"k": t_(k0), "v": t_(v0)}
    yt, ct, amt = tattn.attention_decode_step(
        at, cfg_t, t_(x), cache_t, pos=t_(pos), rope_theta=rope,
        capture=capture, kv_len=kv_len, backend=backend)
    assert ct is cache_t                     # written in place
    for key in ("k", "v"):
        np.testing.assert_allclose(np_(ct[key]), np.asarray(cj[key]),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np_(ct["k"])[3], k0[3])  # dead slot kept
    live = pos < kv_len          # rows whose valid prefix fits the slice
    np.testing.assert_allclose(np_(yt)[live], np.asarray(yj)[live],
                               rtol=1e-5, atol=1e-5)
    if capture:
        np.testing.assert_array_equal(np_(amt)[live], np.asarray(amj)[live])
    else:
        assert amt is None


@pytest.mark.parametrize("name", PORT_ARCHS)
def test_decode_step_scalar_pos_and_full_cache(name):
    """Whole-batch scalar position, no ``kv_len`` hint (the reference
    path of the engine and the prefix-cache extension)."""
    cfg_j, aj, cfg_t, at, rope = attn_params(name)
    B, T = 2, 20
    rng = np.random.default_rng(2)
    nkv, hd = cfg_t.num_kv_heads, cfg_t.resolved_head_dim
    k0 = rng.normal(size=(B, T, nkv, hd)).astype(np.float32)
    v0 = rng.normal(size=(B, T, nkv, hd)).astype(np.float32)
    x = rng.normal(size=(B, 1, cfg_t.d_model)).astype(np.float32)
    yj, cj, _ = jattn.attention_decode_step(
        aj, cfg_j, jnp.asarray(x), {"k": jnp.asarray(k0),
                                    "v": jnp.asarray(v0)},
        pos=7, rope_theta=rope)
    yt, ct, _ = tattn.attention_decode_step(
        at, cfg_t, t_(x), {"k": t_(k0), "v": t_(v0)}, pos=7,
        rope_theta=rope)
    np.testing.assert_allclose(np_(yt), np.asarray(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np_(ct["k"]), np.asarray(cj["k"]),
                               rtol=1e-5, atol=1e-5)


def test_init_cache_layout():
    _, _, cfg_t, _, _ = attn_params("gpt2-moe")
    c = tattn.init_cache(cfg_t, 3, 17)
    jc = jattn.init_cache(model_pair("gpt2-moe")[0], 3, 17)
    assert tuple(c["k"].shape) == jc["k"].shape
    assert not c["k"].any()
