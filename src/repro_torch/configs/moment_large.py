"""moment-large — the paper's own primary backbone (MOMENT, a T5-large-style
time-series encoder used as a representation FM) [arXiv:2402.03885 via paper §7].

Representation-based: the backbone is a feature extractor with fixed input/output
shape; tasks attach encoders/decoder heads. No decode shapes exist for it.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="moment-large",
    family="representation",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=0,                 # patch-embedded time series, no token vocab
    is_representation=True,
    frontend_stub="ts_patches",   # input_specs() supplies precomputed patch embeddings
    source="paper §7 / arXiv:2402.03885",
))
