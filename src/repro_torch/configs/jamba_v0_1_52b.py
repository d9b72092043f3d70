"""jamba-v0.1-52b — Mamba+attn 1:7 interleave, MoE 16e top-2 every other layer
[arXiv:2403.19887; hf]."""
from repro_torch.configs.base import ModelConfig, register, ATTN, MAMBA

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    # 1 attention layer per 8 (attn:mamba = 1:7), attention at position 4 of each block
    block_pattern=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA),
    source="arXiv:2403.19887; hf",
))
