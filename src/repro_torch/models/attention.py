"""Grouped-query causal self-attention with a slot-batched KV cache.

Counterpart of ``repro.models.attention`` for full (non-windowed,
non-cross) attention. Shapes: x (B, S, d); caches (B, T, n_kv, hd); GQA
is computed grouped (q as (B, n_kv, G, S, hd)).

Paths:

* dense -- materializes the scores; prefill up to ``flash_threshold`` and
  every capture (the paper's attention-ID feature needs the probs).
* flash -- blocked online softmax in plain torch (the reference's
  ``_flash_attend``) for long sequences.
* kernel -- one-token decode through the flash-decode kernel
  (``repro_torch.kernels.decode_attention``), ``backend="kernel"``.

The decode step writes the new K/V row into the cache IN PLACE (the
reference returns a new cache); rows whose slot is past the cache
(a dead slot at ``pos == max_len``) keep their old contents, which is
what the reference's ``mode="drop"`` write does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.models.common import (Params, apply_norm, apply_rope,
                                       dense_init, init_norm,
                                       rope_frequencies)

NEG_INF = -1e9
ATTN_BACKENDS = ("torch", "kernel")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   lead: Tuple[int, ...] = ()) -> Params:
    nh, nkv, hd, d = (cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim, cfg.d_model)
    p: Params = {
        "wq": dense_init(gen, lead + (d, nh * hd)),
        "wk": dense_init(gen, lead + (d, nkv * hd)),
        "wv": dense_init(gen, lead + (d, nkv * hd)),
        "wo": dense_init(gen, lead + (nh * hd, d)),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_norm("rmsnorm", hd, lead, gen.device)
        p["k_norm"] = init_norm("rmsnorm", hd, lead, gen.device)
    return p


# ---------------------------------------------------------------------------
# Dense attention (short sequences / capture path)
# ---------------------------------------------------------------------------

def _dense_attend(q, k, v, mask, *, capture: bool = False):
    """q: (B,N,G,S,D); k,v: (B,N,T,D); mask additive, broadcastable to
    the (B,N,G,S,T) scores."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bngsd,bntd->bngst", q.float(), k.float()) * scale
    probs = torch.softmax(scores + mask, dim=-1)
    out = torch.einsum("bngst,bntd->bngsd", probs, v.float())
    attn_argmax = None
    if capture:
        # paper §III-B: per query token, the key position with the highest
        # summed softmax score across all heads -> attention ID
        attn_argmax = probs.sum(dim=(1, 2)).argmax(-1)   # (B, S)
    return out, attn_argmax


# ---------------------------------------------------------------------------
# Flash attention (blocked online softmax, plain torch)
# ---------------------------------------------------------------------------

def _flash_attend(q, k, v, *, causal: bool, q_offset: int,
                  kv_valid_len=None, q_chunk: int = 512,
                  kv_chunk: int = 1024):
    """Blocked attention. q: (B,N,G,S,D); k,v: (B,N,T,D).

    ``q_offset``: absolute position of q[..., 0, :]. ``kv_valid_len``:
    number of valid cache slots, an int or a (B,) tensor. Causal and
    validity masks are applied, not skipped (the reference's schedule).
    """
    B, N, G, S, D = q.shape
    T = k.shape[2]
    scale = D ** -0.5
    dev = q.device
    valid_t = T if kv_valid_len is None else kv_valid_len
    per_row = torch.is_tensor(valid_t) and valid_t.dim() == 1
    out = torch.empty((B, N, G, S, D), dtype=torch.float32, device=dev)
    for q0 in range(0, S, q_chunk):
        qblk = q[:, :, :, q0:q0 + q_chunk].float()
        cq = qblk.shape[3]
        qpos = q_offset + q0 + torch.arange(cq, device=dev)
        m = torch.full((B, N, G, cq), NEG_INF, device=dev)
        l = torch.zeros((B, N, G, cq), device=dev)
        acc = torch.zeros((B, N, G, cq, D), device=dev)
        for k0 in range(0, T, kv_chunk):
            kblk = k[:, :, k0:k0 + kv_chunk].float()
            vblk = v[:, :, k0:k0 + kv_chunk].float()
            kpos = k0 + torch.arange(kblk.shape[2], device=dev)
            s = torch.einsum("bngsd,bntd->bngst", qblk, kblk) * scale
            if per_row:
                msk = (kpos[None, :] < valid_t[:, None])[:, None, None, None]
            else:
                msk = (kpos < valid_t)[None, :]
            if causal:
                msk = msk & (kpos[None, :] <= qpos[:, None])
            s = torch.where(msk, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.max(-1).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bngst,bntd->bngsd", p, vblk)
            m = m_new
        out[:, :, :, q0:q0 + cq] = acc / l.clamp_min(1e-30)[..., None]
    return out, None


# ---------------------------------------------------------------------------
# Public forward
# ---------------------------------------------------------------------------

def _project_q(params: Params, x: torch.Tensor, nh: int, hd: int):
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, nh, hd)
    if "q_norm" in params:
        q = apply_norm("rmsnorm", params["q_norm"], q)
    return q


def _project_kv(params: Params, x: torch.Tensor, nkv: int, hd: int):
    B, S, _ = x.shape
    k = (x @ params["wk"]).reshape(B, S, nkv, hd)
    v = (x @ params["wv"]).reshape(B, S, nkv, hd)
    if "k_norm" in params:
        k = apply_norm("rmsnorm", params["k_norm"], k)
    return k, v


def attention_forward(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                      positions: torch.Tensor, causal: bool = True,
                      rope_theta: float = 0.0, capture: bool = False,
                      flash_threshold: int = 2048
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                 Optional[torch.Tensor]]:
    """Full-sequence self-attention. Returns (y, cache_kv, attn_argmax);
    ``cache_kv`` holds the rope'd K/V that seed decoding."""
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B, S, _ = x.shape
    q = _project_q(params, x, nh, hd)
    k, v = _project_kv(params, x, nkv, hd)
    if rope_theta > 0:
        inv = rope_frequencies(hd, rope_theta, x.device)
        q = apply_rope(q, positions, inv)
        k = apply_rope(k, positions, inv)
    g = nh // nkv
    qg = q.reshape(B, S, nkv, g, hd).movedim(1, 3)      # (B,N,G,S,D)
    kt, vt = k.movedim(1, 2), v.movedim(1, 2)           # (B,N,T,D)

    if capture or S * S <= flash_threshold * flash_threshold:
        mask = torch.zeros((S, S), device=x.device)
        if causal:
            kpos = torch.arange(S, device=x.device)
            mask = torch.where(kpos[None, :] <= positions[:, None], mask,
                               torch.full_like(mask, NEG_INF))
        out, attn_argmax = _dense_attend(qg, kt, vt, mask, capture=capture)
    else:
        out, attn_argmax = _flash_attend(qg, kt, vt, causal=causal,
                                         q_offset=int(positions[0]))
    y = out.movedim(3, 1).reshape(B, S, nh * hd).to(x.dtype)
    return y @ params["wo"], {"k": k, "v": v}, attn_argmax


def attention_decode_step(params: Params, cfg: ModelConfig,
                          x: torch.Tensor,
                          cache: Dict[str, torch.Tensor], *,
                          pos: Union[int, torch.Tensor],
                          rope_theta: float = 0.0, capture: bool = False,
                          dense_threshold: int = 4096,
                          kv_len: Optional[int] = None,
                          backend: str = "torch"
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                     Optional[torch.Tensor]]:
    """One-token decode against a KV cache, written in place.

    x (B, 1, d); cache k/v (B, T, n_kv, hd). ``pos`` is an int (the whole
    batch at one position; the write clamps to the last slot like the
    reference's ``dynamic_update_slice``) or a (B,) tensor of per-slot
    positions (the serving path). ``kv_len`` promises every row's
    ``pos + 1 <= kv_len``; attention then reads ``cache[:, :kv_len]``.
    ``backend="kernel"`` runs the flash-decode kernel unless ``capture``
    needs the probabilities (then the dense path runs, as in the
    reference). Returns (y, cache, attn_argmax or None).
    """
    if backend not in ATTN_BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; expected "
                         f"one of {ATTN_BACKENDS}")
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B = x.shape[0]
    T = cache["k"].shape[1]
    g = nh // nkv
    per_slot = torch.is_tensor(pos) and pos.dim() == 1
    if per_slot:
        pos = pos.to(device=x.device, dtype=torch.long)
        rope_pos = pos[:, None]
    else:
        pos = int(pos)
        rope_pos = torch.tensor([pos], device=x.device)

    q = _project_q(params, x, nh, hd)
    knew, vnew = _project_kv(params, x, nkv, hd)
    if rope_theta > 0:
        inv = rope_frequencies(hd, rope_theta, x.device)
        q = apply_rope(q, rope_pos, inv)
        knew = apply_rope(knew, rope_pos, inv)
    k, v = cache["k"], cache["v"]
    if per_slot:
        rows = torch.arange(B, device=x.device)
        live = ((pos >= 0) & (pos < T))[:, None, None]
        slot = pos.clamp(0, T - 1)
        for buf, new in ((k, knew), (v, vnew)):
            buf[rows, slot] = torch.where(live, new[:, 0].to(buf.dtype),
                                          buf[rows, slot])
        valid = (pos + 1).to(torch.int32)
    else:
        slot = min(max(pos, 0), T - 1)
        k[:, slot] = knew[:, 0].to(k.dtype)
        v[:, slot] = vnew[:, 0].to(v.dtype)
        valid = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)

    k_att, v_att, T_att = k, v, T
    if kv_len is not None and kv_len < T:
        k_att, v_att, T_att = k[:, :kv_len], v[:, :kv_len], kv_len

    attn_argmax = None
    if backend == "kernel" and not capture:
        out = decode_attention(q.reshape(B, nkv, g, hd), k_att, v_att,
                               valid)[:, :, :, None, :]
    else:
        qg = q.reshape(B, 1, nkv, g, hd).movedim(1, 3)
        kt, vt = k_att.movedim(1, 2), v_att.movedim(1, 2)
        if T_att <= dense_threshold:
            tpos = torch.arange(T_att, device=x.device)
            mask = torch.where(tpos[None, :] < valid[:, None], 0.0, NEG_INF)
            out, attn_argmax = _dense_attend(
                qg, kt, vt, mask[:, None, None, None, :], capture=capture)
        else:
            out, _ = _flash_attend(qg, kt, vt, causal=False, q_offset=0,
                                   kv_valid_len=valid)
    y = out.movedim(3, 1).reshape(B, 1, nh * hd).to(x.dtype)
    return y @ params["wo"], cache, attn_argmax


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               dtype=torch.float32, device=None,
               lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    shape = lead + (batch, seq_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
