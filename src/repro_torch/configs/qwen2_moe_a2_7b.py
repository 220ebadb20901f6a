"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B] 24L, d_model=2048, 16 heads (kv=16),
per-expert d_ff=1408, vocab=151936, 60 routed experts top-4, 4 shared
experts (always on, computed as one MLP of 4 x 1408), RoPE theta 1e6.
"""
from repro_torch.config import LayerSpec, MoEConfig, ModelConfig, register_arch


@register_arch("qwen2-moe-a2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        arch_type="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=151936,
        pattern=(LayerSpec("attn", "moe"),),
        moe=MoEConfig(
            num_experts=60,
            top_k=4,
            d_expert_ff=1408,
            num_shared_experts=4,
            d_shared_ff=1408,
            dispatch="expert_parallel",
        ),
        rope_theta=1_000_000.0,
        max_seq_len=32_768,
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
        supports_long_context=False,
        notes="experts padded 60->64 for the 16-way model axis (DESIGN.md §7). "
              "Full attention -> long_500k skipped.",
    )
