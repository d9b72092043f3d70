"""grok-1-314b — 8 experts, top-2 [hf:xai-org/grok-1; unverified]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    experts_per_token=2,
    source="hf:xai-org/grok-1; unverified",
))
