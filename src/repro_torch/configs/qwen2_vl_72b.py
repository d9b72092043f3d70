"""qwen2-vl-72b — VLM backbone, M-RoPE, vision frontend stubbed [arXiv:2409.12191; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),     # t/h/w sections over head_dim/2 = 64
    frontend_stub="vision_patches",  # input_specs() supplies precomputed patch embeddings
    source="arXiv:2409.12191; hf",
))
