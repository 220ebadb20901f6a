"""Pre-norm residual blocks: attention mixer + dense or MoE feed-forward.

Counterpart of ``repro.models.blocks`` for the ``attn`` mixer. The other
mixers (sliding-window, Mamba2, mLSTM, sLSTM, shared attention) and
cross-attention are queued in ROADMAP.md (Queue A) and raise here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import LayerSpec, ModelConfig
from repro_torch.models.attention import (attention_decode_step,
                                          attention_forward, init_attention,
                                          init_cache)
from repro_torch.models.common import Params, apply_norm, init_norm
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.moe import init_moe, moe_forward


def check_spec(spec: LayerSpec) -> None:
    if spec.mixer != "attn":
        raise NotImplementedError(
            f"mixer {spec.mixer!r} is not ported yet (ROADMAP.md, Queue A: "
            "the SSM, xLSTM, encoder-decoder and vision paths)")


def init_block(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               lead: Tuple[int, ...] = ()) -> Params:
    check_spec(spec)
    p: Params = {"norm1": init_norm(cfg.norm, cfg.d_model, lead, gen.device),
                 "attn": init_attention(gen, cfg, lead)}
    if spec.ffn == "dense":
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, lead, gen.device)
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, lead)
    elif spec.ffn == "moe":
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, lead, gen.device)
        p["moe"] = init_moe(gen, cfg, lead)
    return p


def init_block_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     seq_len: int, *, dtype=torch.float32, device=None,
                     lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    check_spec(spec)
    return {"attn": init_cache(cfg, batch, seq_len, dtype=dtype,
                               device=device, lead=lead)}


def _ffn(params: Params, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor,
         cap: Dict[str, Any], *, capture: bool, moe_executor: str,
         moe_router_impl: str) -> torch.Tensor:
    if spec.ffn == "dense":
        h = apply_norm(cfg.norm, params["norm2"], x)
        return x + mlp_forward(params["mlp"], h, cfg.activation)
    if spec.ffn == "moe":
        h = apply_norm(cfg.norm, params["norm2"], x)
        y, aux = moe_forward(params["moe"], cfg, h, capture=capture,
                             executor=moe_executor,
                             router_impl=moe_router_impl)
        cap["lb_loss"] = aux["lb_loss"]
        cap["z_loss"] = aux["z_loss"]
        cap["expert_counts"] = aux["expert_counts"]
        if capture:
            cap["topk_idx"] = aux["topk_idx"]
            cap["topk_weight"] = aux["topk_weight"]
            cap["routing"] = aux["routing"]
        return x + y
    return x


def block_forward(params: Params, cfg: ModelConfig, spec: LayerSpec,
                  x: torch.Tensor, *, positions: torch.Tensor,
                  capture: bool = False, return_cache: bool = False,
                  moe_executor: str = "dense",
                  moe_router_impl: str = "fused"
                  ) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, Any]]:
    """Returns (x, cache, captured); ``captured`` may hold attn_argmax /
    topk_idx / topk_weight / expert_counts / routing."""
    check_spec(spec)
    cache: Dict[str, Any] = {}
    cap: Dict[str, Any] = {}
    h = apply_norm(cfg.norm, params["norm1"], x)
    rope = cfg.rope_theta if cfg.pos_embed == "rope" else 0.0
    y, kv, argmax = attention_forward(params["attn"], cfg, h,
                                      positions=positions, causal=cfg.causal,
                                      rope_theta=rope, capture=capture)
    if return_cache:
        cache["attn"] = kv
    if capture and argmax is not None:
        cap["attn_argmax"] = argmax
    x = _ffn(params, cfg, spec, x + y, cap, capture=capture,
             moe_executor=moe_executor, moe_router_impl=moe_router_impl)
    return x, cache, cap


def block_decode_step(params: Params, cfg: ModelConfig, spec: LayerSpec,
                      x: torch.Tensor, cache: Dict[str, Any], *, pos,
                      capture: bool = False, moe_executor: str = "dense",
                      moe_router_impl: str = "fused",
                      dense_threshold: int = 4096,
                      kv_len: Optional[int] = None,
                      attn_backend: str = "torch"
                      ) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, Any]]:
    """One-token step; the block's KV cache is updated in place. Returns
    (x, cache, captured) with captures shaped (B, 1, ...)."""
    check_spec(spec)
    cap: Dict[str, Any] = {}
    h = apply_norm(cfg.norm, params["norm1"], x)
    rope = cfg.rope_theta if cfg.pos_embed == "rope" else 0.0
    y, _, argmax = attention_decode_step(
        params["attn"], cfg, h, cache["attn"], pos=pos, rope_theta=rope,
        capture=capture, dense_threshold=dense_threshold, kv_len=kv_len,
        backend=attn_backend)
    if capture and argmax is not None:
        cap["attn_argmax"] = argmax
    x = _ffn(params, cfg, spec, x + y, cap, capture=capture,
             moe_executor=moe_executor, moe_router_impl=moe_router_impl)
    if not capture:    # decode keeps only the routing captures
        cap.clear()
    else:
        for key in ("lb_loss", "z_loss", "expert_counts"):
            cap.pop(key, None)
    return x, cache, cap
