"""minitron-8b — pruned nemotron, 256k vocab [arXiv:2407.14679; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    source="arXiv:2407.14679; hf",
))
