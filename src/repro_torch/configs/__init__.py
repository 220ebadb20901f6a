"""Architecture registry of the port: the configurations it serves."""
from repro_torch.configs import paper_gpt2_moe, qwen2_moe_a2_7b  # noqa: F401
